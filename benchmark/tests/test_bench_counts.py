"""The frozen roofline and mfu counts against hand counts."""
from __future__ import annotations

import json

import pytest

from bench_tiny import BENCH
from harness import counts, specs


def _spec(name):
    return specs.from_config(json.loads(
        (BENCH / "configs" / f"{name}.json").read_text()))


DEIT = _spec("deit_small_p2vit_w4a8")
SWIN = _spec("swin_tiny_p2vit_w4a8")


def test_k6_at_deit_s_b64():
    ops, nbytes = counts.k6_work(DEIT, 64)
    rows = 64 * 197
    assert ops == 12 * (2 * rows * 384 * (1152 + 384 + 2 * 1536)
                        + 4 * rows * 197 * 384)
    assert ops == pytest.approx(581e9, rel=1e-3)
    # packed int8 weights + float32 vectors + codes in and out
    assert nbytes == 21_233_664 + 608_544 + 2 * rows * 384
    assert nbytes == pytest.approx(31.5e6, rel=2e-3)
    assert counts.k6_bound_s(DEIT, 64) == pytest.approx(ops / 1979e12)


def test_k2_at_deit_s_b64():
    ops, nbytes = counts.k2_work(64 * 197, 384, 1536, 384)
    assert ops == pytest.approx(29.7e9, rel=2e-3)
    assert nbytes == 10_879_492
    assert counts.bound_s(ops, nbytes) == pytest.approx(ops / 1979e12)


def test_k2_calls_of_a_forward():
    assert counts.k2_calls(DEIT, 2) == [(394, 384, 1536, 384)] * 12
    calls = counts.k2_calls(SWIN, 1)
    assert len(calls) == 12
    assert calls[0] == (3136, 96, 384, 96)
    assert calls[-1] == (49, 768, 3072, 768)


def test_forward_ops():
    # DeiT-S: patch 196 x 768 x 384; a block 197 x 384 x (1152 + 384 +
    # 2 x 1536) + 2 x 197^2 x 384; head 384 x 1000; two a multiply-add
    block = 197 * 384 * (1152 + 384 + 3072) + 2 * 197 * 197 * 384
    macs = 196 * 768 * 384 + 12 * block + 384 * 1000
    assert counts.forward_ops(DEIT) == 2 * macs
    assert counts.forward_ops(DEIT) == pytest.approx(9.2e9, rel=0.01)
    assert counts.forward_ops(SWIN) == pytest.approx(9.0e9, rel=0.02)
    assert counts.forward_ops(SWIN, 50) == 50 * counts.forward_ops(SWIN)

"""The port's layer-restore sweep (``analysis.restore``) against the JAX
package's, on the CPU: the reference-format lines and the calls with a
fake ``validate_fn``, ``k_layer_combinations``, and the default fake-quant
validation of a calibrated TINY ViT (64 wide, 2 blocks; JAX's params and
calibration batch carried across) over a fake ImageFolder of 8 images.
"""
import types

import pytest

from diffvit_tpu import engine as jax_engine
from diffvit_tpu.analysis import restore as jrestore
from diffvit_tpu.config import QuantConfig as JaxQuantConfig
from diffvit_tpu.data import imagenet as jimagenet

from diffvit_tpu_torch import QuantConfig, engine
from diffvit_tpu_torch.analysis import restore
from diffvit_tpu_torch.data import imagenet
from diffvit_tpu_torch.data.synthetic import make_fake_imagefolder

from test_torch_calibrate import (J_TINY, N_SLOTS, TINY,  # noqa: F401
                                  one_torch_thread, tiny)


def _without_time(path):
    return [ln.rsplit(" Time ", 1)[0] for ln in open(path)]


def _fake_validate(calls):
    def validate(bc):
        calls.append(bc)
        return 100.0 * sum(bc) / (8 * len(bc)), float(bc.count(8))
    return validate


def test_sweep_lines_and_calls_match_jax(tmp_path):
    """A fake validate_fn: the same calls (tuples of bits), results and
    log lines, and the file's lines equal JAX's apart from ``Time``."""
    combos = [(0,), (3, 7), (9,)]
    runs = {}
    for name, mod, spec in (("jax", jrestore, J_TINY),
                            ("port", restore, TINY)):
        calls, logs = [], []
        path = tmp_path / f"{name}.txt"
        path.write_text("earlier line\n")
        res = mod.run_restore_sweep(
            types.SimpleNamespace(spec=spec), None, combos,
            out_path=str(path), validate_fn=_fake_validate(calls),
            log=logs.append)
        runs[name] = (calls, res, [ln.rsplit(" Time ", 1)[0]
                                   for ln in logs], _without_time(path))
    assert runs["port"] == runs["jax"]
    calls, res, _, lines = runs["port"]
    assert calls[0] == (4,) * N_SLOTS and calls[2][3] == calls[2][7] == 8
    assert lines[:3] == [
        "earlier line\n",
        "Restore Index: nothing remains int4, Prec@1 50.000 Prec@5 0.000",
        "Restore Index: [0], Prec@1 55.000 Prec@5 1.000"]
    assert [r[0] for r in res] == [(), (0,), (3, 7), (9,)]
    assert restore.restore_line((1, 2), 1.0, 2.0, 0.5) == \
        jrestore.restore_line((1, 2), 1.0, 2.0, 0.5)
    assert restore.int4_baseline_line(1.0, 2.0, 0.5) == \
        jrestore.int4_baseline_line(1.0, 2.0, 0.5)


@pytest.mark.parametrize("k,slots,limit", [(1, 50, None), (2, 10, 7),
                                           (3, 6, None), (1, 10, 0)])
def test_k_layer_combinations_match_jax(k, slots, limit):
    assert restore.k_layer_combinations(k, slots, limit) == \
        jrestore.k_layer_combinations(k, slots, limit)


def test_fake_quant_sweep_matches_jax(tiny, tmp_path):
    """The default validate_fn (fake-quant ``validate``) on TINY
    calibrated by each package on the same batch: Prec@1 and Prec@5 of
    the baseline and of the first two one-index restores equal JAX's.
    Measured: equal, Prec@1 25.0 and Prec@5 50.0 for all three (random
    weights on 8 images of 4 classes)."""
    params_j, params, xs = tiny
    root = tmp_path / "val"
    make_fake_imagefolder(str(root), num_classes=4, per_class=2)
    combos = restore.k_layer_combinations(1, N_SLOTS, limit=2)
    jq = jax_engine.QuantizedViT(J_TINY, JaxQuantConfig(), params=params_j)
    jq.calibrate(xs[0])
    jloader = jimagenet.DataLoader(jimagenet.ImageFolder(
        str(root), jimagenet.build_transform()), 4, num_workers=2)
    want = jrestore.run_restore_sweep(jq, jloader, combos,
                                      log=lambda *_: None)
    q = engine.QuantizedViT(TINY, QuantConfig(), params=params,
                            device="cpu")
    q.calibrate(xs[0])
    loader = imagenet.DataLoader(imagenet.ImageFolder(
        str(root), imagenet.build_transform()), 4, num_workers=2)
    got = restore.run_restore_sweep(q, loader, combos, log=lambda *_: None)
    assert got == want and len(got) == 3

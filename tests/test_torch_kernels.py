"""The port's two kernel modules vs the JAX Pallas kernels, on the CPU.

The JAX kernels run in interpret mode, as the JAX suite runs them here;
the port runs its plain PyTorch versions (what a CPU tensor gets).  The
CUDA kernels themselves are held against the plain versions in
tests/test_torch_cuda.py, which needs a card."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffvit_tpu.ops.pallas.attention import \
    fused_qkv_attention_v2 as jax_attention
from diffvit_tpu.ops.pallas.mlp import fused_int_mlp as jax_mlp

from diffvit_tpu_torch.models.convert import attn_constants
from diffvit_tpu_torch.models.vit import ViTSpec
from diffvit_tpu_torch.ops.kernels import build
from diffvit_tpu_torch.ops.kernels.attention import (
    fused_int_attention, fused_qkv_attention_v2)
from diffvit_tpu_torch.ops.kernels.mlp import fused_int_mlp
from diffvit_tpu_torch.testing import random_int_model

TINY = ViTSpec("test_tiny", embed_dim=64, depth=2, num_heads=2,
               num_classes=10)
N, NPAD = 197, 200


def _agree(got, want, exact):
    """The kernel-test tolerance: >= 99.9% of int8 codes equal and
    max |diff| <= 1; ``exact`` asserts equality where it holds."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if exact:
        np.testing.assert_array_equal(got, want)
    assert np.mean(got == want) >= 0.999, np.mean(got == want)
    assert np.abs(got - want).max() <= 1


@pytest.fixture(scope="module")
def block0():
    ip = random_int_model(TINY, seed=3)
    ib = ip["blocks"][0]
    scalars, _ = attn_constants(ib, TINY, 0)
    rng = np.random.default_rng(7)
    x = np.clip(np.round(rng.standard_normal((2, NPAD, 64)) * 30),
                -128, 127).astype(np.int8)
    x[:, N:] = 0  # the JAX caller zero-pads the token rows
    return ib, scalars, x


def _attn_args(ib, scalars, x, to):
    q = ib["qkv"]
    return (to(x), to(q["w_int"]), to(q["mult"]), to(q["b"]), to(scalars))


@pytest.mark.parametrize("lis_fast", [False, True])
def test_qkv_attention_plain_matches_pallas(block0, lis_fast):
    ib, scalars, x = block0
    kw = dict(num_heads=2, head_dim=32, n_real=N, bits=4, lis=True,
              lis_fast=lis_fast)
    want = np.asarray(jax_attention(*_attn_args(ib, scalars, x, jnp.asarray),
                                    interpret=True, **kw))
    got = fused_qkv_attention_v2(*_attn_args(ib, scalars, x, torch.tensor),
                                 **kw)
    assert got.shape == (2, 2, NPAD, 32) and got.dtype == torch.int8
    # real query rows; on this input every code agrees
    _agree(got.numpy()[:, :, :N], want[:, :, :N], exact=True)


def _mlp_args(ib, x, to):
    f1, f2 = ib["fc1"], ib["fc2"]
    return (to(x), to(f1["w_int"]), to(f2["w_int"]), to(f1["mult"]),
            to(f1["b"]), to(f2["mult"]), to(f2["b"]),
            to(ib["mlp.qact2"]["scale"]), to(ib["mlp.qact1"]["scale"]))


@pytest.mark.parametrize("emit_codes", [True, False])
def test_int_mlp_plain_matches_pallas(block0, emit_codes):
    ib, _, x = block0
    rows = x[:, :N].reshape(-1, 64)  # 394 rows; the Pallas kernel pads to 512
    padded = np.zeros((512, 64), np.int8)
    padded[:len(rows)] = rows
    want = np.asarray(jax_mlp(*_mlp_args(ib, padded, jnp.asarray),
                              emit_codes=emit_codes, interpret=True))
    got = fused_int_mlp(*_mlp_args(ib, rows, torch.tensor),
                        emit_codes=emit_codes).numpy()
    assert got.shape == (len(rows), 64)
    out_scale = ib["mlp.qact2"]["scale"]
    codes = got if emit_codes else np.round(got / out_scale)
    want_codes = want[:len(rows)] if emit_codes \
        else np.round(want[:len(rows)] / out_scale)
    _agree(codes, want_codes, exact=True)


def test_wrappers_refuse_other_devices(block0):
    ib, scalars, x = block0
    meta = lambda a: torch.tensor(np.asarray(a)).to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="meta"):
        fused_qkv_attention_v2(*_attn_args(ib, scalars, x, meta), num_heads=2,
                               head_dim=32, n_real=N)
    with pytest.raises(ValueError, match="meta"):
        fused_int_mlp(*_mlp_args(ib, x[0], meta), emit_codes=True)
    qkv5 = meta(np.zeros((1, 3, 2, N, 32), np.int8))
    with pytest.raises(ValueError, match="meta"):
        fused_int_attention(qkv5, meta(scalars[:3]), num_heads=2, n_real=N)


def test_wrapper_contract_raises(block0):
    ib, scalars, x = block0
    args = _attn_args(ib, scalars, x, torch.tensor)
    # the float softmax (lis=False) takes any bits; the LIS at most 4
    out = fused_qkv_attention_v2(*args, num_heads=2, head_dim=32, n_real=N,
                                 bits=8, lis=False)
    assert out.shape == (2, 2, NPAD, 32) and out.dtype == torch.int8
    with pytest.raises(NotImplementedError, match="bits"):
        fused_qkv_attention_v2(*args, num_heads=2, head_dim=32, n_real=N,
                               bits=8)


def test_build_names_nvcc_when_missing(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(build, "library_path", lambda: tmp_path / "lib.so")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()


def test_random_model_spec_shapes():
    spec = dataclasses.replace(TINY, depth=3)
    ip = random_int_model(spec, seed=0)
    assert len(ip["blocks"]) == 3 and ip["sym_acts"] is True
    assert len(ip["bit_config"]) == 4 * 3 + 2
    assert ip["blocks"][0]["qkv"]["w_int"].shape == (64, 192)
    assert ip["blocks"][0]["qkv"]["w_int"].min() >= -8
    assert ip["blocks"][0]["qkv"]["w_int"].max() <= 7

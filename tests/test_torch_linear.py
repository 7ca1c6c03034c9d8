"""The port's K3 (``fused_int_linear``) vs the JAX Pallas kernel in
interpret mode, on the CPU, where the port runs the plain PyTorch
version; and the CPU-side contract of this slice's new wrappers.

The fq and codes modes are exact.  The raw mode equals the plain float32
arithmetic ``acc * mult + bias`` bit for bit, and the interpret-mode
kernel within that expression's two roundings: the interpret run is
jitted, and XLA contracts the multiply-add into one fma, where the port
rounds twice (as the forward's ``int_matmul(x, w) * mult + b`` and the
CUDA kernel, built with ``-fmad=false``, do)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffvit_tpu.ops.pallas.linear import fused_int_linear as jax_linear

from diffvit_tpu_torch.models.swin import SwinSpec
from diffvit_tpu_torch.models.vit import ViTSpec
from diffvit_tpu_torch.ops.kernels import attention, linear, mlp
from diffvit_tpu_torch.ops.kernels.linear import (fused_int_linear,
                                                  fused_int_linear_plain)
from diffvit_tpu_torch.testing import (alt_kernel_cases, linear_site_cases,
                                       random_int_model,
                                       random_swin_int_model)

from test_torch_calibrate import one_torch_thread  # noqa: F401


def _case(rows, k, n, seed=0):
    """The JAX suite's inputs (tests/test_fused_linear.py) at (rows, k, n)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-128, 128, (rows, k)).astype(np.int8),
            rng.integers(-8, 8, (k, n)).astype(np.int8),
            rng.uniform(0.001, 0.01, (n,)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def assert_raw(got, want, product, bias):
    """The raw mode: ``got`` is the float32 ``product + bias`` with the
    product rounded first, bit for bit; the fma-contracted ``want`` rounds
    once, so the two differ by at most the product's rounding (half an ulp
    of the product) and the sum's (one ulp of the result)."""
    np.testing.assert_array_equal(got, product + bias)
    bound = np.spacing(np.abs(product)) / 2 + np.spacing(np.abs(want))
    assert (np.abs(got - want) <= bound).all()


def _modes(out_scale):
    return {"raw": {}, "fq": dict(out_scale=out_scale),
            "codes": dict(out_scale=out_scale, emit_codes=True)}


def _check(arrays, mode, bf16_dot, block_rows=256):
    rows = arrays[0].shape[0]
    out_scale = np.float32(0.05)
    kw = _modes(out_scale)[mode]
    pad = -rows % block_rows
    xj = np.pad(arrays[0], ((0, pad), (0, 0)))
    want = np.asarray(jax_linear(
        jnp.asarray(xj), *map(jnp.asarray, arrays[1:]),
        **{k: jnp.asarray(v) if k == "out_scale" else v
           for k, v in kw.items()},
        block_rows=block_rows, sub=block_rows, bf16_dot=bf16_dot,
        interpret=True))[:rows]
    t = tuple(torch.tensor(a) for a in arrays)
    tkw = {k: torch.tensor(v) if k == "out_scale" else v
           for k, v in kw.items()}
    got = fused_int_linear(*t, **tkw, bf16_dot=bf16_dot).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if mode == "raw":
        acc = arrays[0].astype(np.int64) @ arrays[1].astype(np.int64)
        assert_raw(got, want, acc.astype(np.float32) * arrays[2], arrays[3])
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bf16_dot", [True, False])
@pytest.mark.parametrize("mode", ["raw", "fq", "codes"])
def test_fused_int_linear_plain_matches_pallas(mode, bf16_dot):
    """The JAX suite's grid: modes x bf16_dot at (256, 96) @ (96, 160)."""
    _check(_case(256, 96, 160), mode, bf16_dot)


@pytest.mark.parametrize("mode", ["raw", "fq", "codes"])
def test_fused_int_linear_tail_shape(mode):
    """K = 48 (Swin's patch) and N = 1000 (the ViT head), 200 rows (the
    Pallas kernel pads them to 256; the port takes any R)."""
    _check(_case(200, 48, 1000, seed=1), mode, bf16_dot=True)


@pytest.mark.parametrize("model", ["vit", "swin"])
def test_linear_site_cases_cover_the_named_sites(model):
    """``testing.linear_site_cases``: the shapes chip_smoke.py drives K3
    at, here at small widths; every site runs in every mode."""
    if model == "vit":
        spec = ViTSpec("t", embed_dim=64, depth=1, num_heads=2,
                       num_classes=10)
        cases = linear_site_cases(spec, random_int_model(spec, seed=0), 1,
                                  "cpu")
        shapes = {"patch": (196, 768, 64), "qkv": (197, 64, 192),
                  "proj": (197, 64, 64), "fc1": (197, 64, 256),
                  "head": (1, 64, 10)}
    else:
        spec = SwinSpec("s", embed_dim=32, depths=(2, 1), num_heads=(2, 4),
                        img_size=56, num_classes=10)
        cases = linear_site_cases(spec, random_swin_int_model(spec), 1,
                                  "cpu")
        shapes = {"patch": (196, 48, 32), "qkv": (196, 32, 96)}
    assert {k: (a[0].shape[0], *a[1].shape) for k, (a, _) in cases.items()} \
        == shapes
    for args, out_scale in cases.values():
        for kw in _modes(out_scale).values():
            out = fused_int_linear(*args, **kw)
            want = fused_int_linear_plain(*args, **kw)
            torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_new_wrappers_refuse_other_devices():
    """K3, K7a, K7b and K8's four entries take the CPU (plain) or CUDA
    (kernel) and raise for any other device, with no launch counted."""
    spec = ViTSpec("t16", embed_dim=32, depth=1, num_heads=2, num_classes=10)
    cases = alt_kernel_cases(spec, random_int_model(spec, seed=3), 2, "meta")
    counters = {name: getattr(attention, name) for name in (
        "fused_qkv_attention", "fused_qkv_attention_v3",
        "fused_qkv_attention_v4", "fused_qkv_attention_v5",
        "fused_attention_block")}
    counters["fused_int_mlp_block"] = mlp.fused_int_mlp_block
    before = {name: fn.launches for name, fn in counters.items()}
    for name, (args, kw) in cases.items():
        with pytest.raises(ValueError, match="meta"):
            counters[name](*args, **kw)
    x = torch.zeros((4, 48), dtype=torch.int8, device="meta")
    w = torch.zeros((48, 96), dtype=torch.int8, device="meta")
    v = torch.zeros(96, device="meta")
    with pytest.raises(ValueError, match="meta"):
        linear.fused_int_linear(x, w, v, v, out_scale=v, emit_codes=True)
    assert {name: fn.launches for name, fn in counters.items()} == before
    assert linear.fused_int_linear.launches == 0


def test_new_wrappers_keep_the_jax_contracts():
    """The LIS takes at most 4 bits; K8's v1 weights share one layout."""
    spec = ViTSpec("t16", embed_dim=32, depth=1, num_heads=2, num_classes=10)
    cases = alt_kernel_cases(spec, random_int_model(spec, seed=3), 2, "cpu")
    for name in ("fused_qkv_attention", "fused_qkv_attention_v3",
                 "fused_attention_block"):
        args, kw = cases[name]
        with pytest.raises(NotImplementedError, match="bits"):
            getattr(attention, name)(*args, **kw, bits=8)
    args, kw = cases["fused_qkv_attention"]
    out = attention.fused_qkv_attention(*args, **dict(kw, lis=False), bits=8)
    assert out.shape == (2, 2, 197, 16) and out.dtype == torch.int8

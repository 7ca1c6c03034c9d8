"""The LIS with the 128-bit row sum: a softmax scale whose integer
exponentials can overflow the int64 row sum (``lis_sum_fits`` fails: below
about 2^-10.9 over ViT's 197 keys, 2^-11 over a 49-key window), served down
to the reference's own bound, 2^-17.

The wide sum is held to an exact Python-int sum of the same exponentials,
rounded once to nearest even, over random rows.  The forwards are held to
JAX's ``forward_q_int(use_pallas=True, pallas_interpret=True)``, whose
Pallas LIS takes a float32 row sum in XLA's order, by the JAX suite's rule
between two integer paths (tests/test_pallas_attention.py::
_assert_paths_agree: > 99.5% of logits equal, atol 0.05, equal argmax)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffvit_tpu.config import QuantConfig
from diffvit_tpu.models import swin as jswin, swin_int as jswin_int
from diffvit_tpu.models import vit, vit_int as jax_vit_int
from diffvit_tpu.ops.pallas import attention as jax_attention
from diffvit_tpu.ops.pallas import mlp as jax_mlp

from diffvit_tpu_torch.models import swin, swin_int, vit_int
from diffvit_tpu_torch.models.convert import (int_model_from_numpy,
                                              swin_int_model_from_numpy)
from diffvit_tpu_torch.models.vit import ViTSpec
from diffvit_tpu_torch.ops.kernels.attention import (lis_body_plain,
                                                     lis_sum_fits)
from diffvit_tpu_torch.ops.lis import int_exp, wide_row_sum
from diffvit_tpu_torch.testing import random_int_model, random_swin_int_model

from test_torch_calibrate import one_torch_thread  # noqa: F401

TINY = vit.ViTSpec("test_tiny", embed_dim=64, depth=2, num_heads=2,
                   num_classes=10)
TINY_T = ViTSpec("test_tiny", embed_dim=64, depth=2, num_heads=2,
                 num_classes=10)
SWIN_KW = dict(embed_dim=32, depths=(2, 1), num_heads=(2, 4), img_size=56,
               num_classes=10)
SWIN_J = jswin.SwinSpec("swin_test2", **SWIN_KW)
SWIN_T = swin.SwinSpec("swin_test2", **SWIN_KW)
CFG = QuantConfig()


def _assert_paths_agree(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.mean(got == ref) > 0.995, np.mean(got == ref)
    np.testing.assert_allclose(got, ref, atol=0.05)
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


def _round_f32(t: int) -> np.float32:
    """The Python int t >= 0 rounded once to float32, nearest even."""
    f = np.float32(float(t))  # within an ulp of the answer
    cands = [np.nextafter(f, np.float32(0)), f,
             np.nextafter(f, np.float32(np.inf))]
    best = min(abs(int(c) - t) for c in cands)
    near = [c for c in cands if abs(int(c) - t) == best]
    if len(near) == 1:
        return near[0]
    return next(c for c in near if not c.view(np.int32) & 1)


def _rows(rng, n_rows, n_keys, lo_exp, hi_exp):
    """Integer float32 exponentials 2^k * m (m a 24-bit mantissa), k in
    [lo_exp, hi_exp), zeros in some rows, as the LIS gives them."""
    m = rng.integers(2**23, 2**24, (n_rows, n_keys)).astype(np.float64)
    k = rng.integers(lo_exp, hi_exp, (n_rows, n_keys)) - 23
    e = np.ldexp(m, k).astype(np.float32)
    e[rng.random((n_rows, n_keys)) < 0.1] = 0.0
    return np.floor(e)


@pytest.mark.parametrize("n_keys,lo_exp,hi_exp", [
    (197, 55, 68), (256, 60, 68), (49, 40, 68), (197, 0, 40), (7, 62, 64)])
def test_wide_row_sum_is_the_exact_sum_rounded_once(n_keys, lo_exp, hi_exp):
    """Exact, tolerance 0: every row's float32 equals its Python-int sum
    rounded once to nearest even, at totals below and above 2^63."""
    rng = np.random.default_rng(n_keys + hi_exp)
    e = _rows(rng, 64, n_keys, lo_exp, hi_exp)
    got = wide_row_sum(torch.tensor(e)).numpy()[:, 0]
    want = np.asarray([_round_f32(sum(int(v) for v in row)) for row in e])
    np.testing.assert_array_equal(got, want)


def test_wide_row_sum_rounds_ties_and_sticky_bits():
    """Exact at the rounding boundaries of a total above 2^63: halfway cases
    go to the even neighbour, and a bit far below the halfway point (which
    the sticky bit keeps) lifts them to the upper one."""
    base = 2**66 + 2**42  # halfway between two float32 neighbours
    for t in (base, base + 2**43, base + 1, base + 2**20, base - 1):
        # t as float32 pieces of 24 bits each, all exact
        parts = [float((t >> k & (2**24 - 1)) << k) for k in (0, 24, 48)]
        e = torch.tensor([parts], dtype=torch.float32)
        assert sum(int(v) for v in e[0].tolist()) == t
        assert wide_row_sum(e).item() == _round_f32(t), hex(t)


def test_wide_sum_equals_the_int64_sum_where_that_fits():
    """Exact: at a scale inside lis_sum_fits the two sums, and the LIS
    weights, are equal; below it the wide sum is what an int64 sum cannot
    hold."""
    rng = np.random.default_rng(3)
    a = torch.tensor(rng.integers(-128, 128, (4, 16, 197)).astype(np.float32))
    col_ok = torch.arange(197) < 190
    for s, fits in ((2.0**-10, True), (2.0**-12, False)):
        scale = torch.tensor(s, dtype=torch.float32)
        assert lis_sum_fits(s, 197) == fits
        e = int_exp(a - a.amax(-1, keepdim=True), scale)
        exact = [sum(int(v) for v in row) for row in e.reshape(-1, 197)]
        assert (max(exact) < 2**63) == fits
        if fits:
            np.testing.assert_array_equal(
                wide_row_sum(e).numpy(),
                e.to(torch.int64).sum(-1, keepdim=True).to(torch.float32)
                .numpy())
            np.testing.assert_array_equal(
                lis_body_plain(a, scale, 4, col_ok, wide=True).numpy(),
                lis_body_plain(a, scale, 4, col_ok).numpy())
    with pytest.raises(ValueError, match="slow form"):
        lis_body_plain(a, scale, 4, col_ok, fast=True, wide=True)


@pytest.fixture(scope="module")
def vit_model():
    """TINY with block 1's softmax scale at 2^-12: its int64 row sum would
    overflow over 197 keys."""
    ip = random_int_model(TINY_T, seed=1)
    ip["blocks"][1]["attn.qact_attn1"]["scale"] = np.float32(2.0**-12)
    x = np.random.default_rng(5).standard_normal(
        (2, 3, 224, 224)).astype(np.float32)
    want = np.asarray(jax_vit_int.forward_q_int(
        ip, TINY, CFG, jnp.asarray(x), use_pallas=True,
        pallas_interpret=True))
    return ip, x, want


def test_vit_serves_a_softmax_scale_below_the_int64_sum(vit_model):
    """K1's plain version with the 128-bit sum against JAX (the
    _assert_paths_agree rule), and the resident forward (K6's plain
    version, every layer wide) bit-equal to it."""
    ip_np, x, want = vit_model
    ip = int_model_from_numpy(ip_np, TINY_T, "cpu")
    assert [ib["lis_wide"] for ib in ip["blocks"]] == [False, True]
    got = vit_int.forward_q_int(ip, TINY_T, CFG, torch.tensor(x)).numpy()
    assert np.isfinite(got).all() and not np.array_equal(got[0], got[1])
    _assert_paths_agree(got, want)
    served = vit_int.forward_q_int_serve(ip, TINY_T, CFG, torch.tensor(x))
    np.testing.assert_array_equal(served.numpy(), got)


def test_vit_k5_path_serves_a_softmax_scale_below_the_int64_sum(vit_model):
    """The FQ-ViT route (SmoothQuant off: the qkv GEMM, then K5 with the
    128-bit sum) against JAX's, by _assert_paths_agree."""
    ip_np, x, _ = vit_model
    cfg = QuantConfig(smoothquant=False)
    ip = random_int_model(TINY_T, cfg, seed=1)
    ip["blocks"][1]["attn.qact_attn1"]["scale"] = np.float32(2.0**-12)
    want = np.asarray(jax_vit_int.forward_q_int(
        ip, TINY, cfg, jnp.asarray(x), use_pallas=True,
        pallas_interpret=True))
    got = vit_int.forward_q_int(int_model_from_numpy(ip, TINY_T, "cpu", cfg),
                                TINY_T, cfg, torch.tensor(x)).numpy()
    _assert_paths_agree(got, want)


def _swin_case(x_seed):
    """A shifted window block with s_a2 = 2^-13 (its int64 row sum would
    overflow over 49 keys), an input, and JAX's interpret-mode logits."""
    ip_np = random_swin_int_model(SWIN_T, seed=0)
    ip_np["qp"]["layers.0.blocks.1.attn.qact2.scale"] = np.float32(2.0**-13)
    assert not lis_sum_fits(2.0**-13, 49)
    x = np.random.default_rng(x_seed).standard_normal(
        (2, 3, 56, 56)).astype(np.float32)
    want = np.asarray(jswin_int.forward_q_int(
        ip_np, SWIN_J, CFG, jnp.asarray(x), use_pallas=True,
        pallas_interpret=True))
    ip = swin_int_model_from_numpy(ip_np, SWIN_T, "cpu", CFG)
    assert ip["layers"][0]["blocks"][1]["lis_wide"]
    assert not ip["layers"][0]["blocks"][0]["lis_wide"]
    return ip, x, want


@pytest.mark.parametrize("attn_v2", [False, True], ids=["K4", "K4b"])
def test_swin_serves_a_softmax_scale_below_the_int64_sum(attn_v2):
    """K4 / K4b's plain versions with the 128-bit sum against JAX, by
    _assert_paths_agree (measured: 20 of 20 logits equal)."""
    ip, x, want = _swin_case(1)
    got = swin_int.forward_q_int(ip, SWIN_T, CFG, torch.tensor(x),
                                 attn_v2=attn_v2).numpy()
    assert np.isfinite(got).all()
    _assert_paths_agree(got, want)


def _to_jnp(a):
    return None if a is None else jnp.asarray(a.numpy())


def test_swin_wide_forward_differs_from_jax_only_inside_the_kernels():
    """On another input one logit of 20 differs by one act_out step (2^-4),
    as it does with a float32 row sum in the port too: the known noise of
    tests/test_torch_swin.py::
    test_random_forward_differs_from_jax_only_inside_the_kernels, held by
    its rule.  With the interpret-mode Pallas K4 and K2 swapped into the
    port's forward, every logit equals JAX's; on the model's own operands
    the plain K4 (with the 128-bit sum) equals the Pallas one on >= 99.9%
    of codes and K2 is within 1; the plain forward is within one act_out
    step, with equal argmax."""
    ip, x, want = _swin_case(2)
    plain = swin_int.forward_q_int(ip, SWIN_T, CFG, torch.tensor(x)).numpy()
    plain_k4, plain_k2 = swin_int.fused_swin_attention, swin_int.fused_int_mlp
    equal = {"k4": [], "k2": []}

    def pallas_k4(qkv, bias_q, mask_div, scalars, *, lis_wide, **kw):
        n, npad = qkv.shape[3], -(-qkv.shape[3] // 8) * 8
        square = ((0, 0), (0, npad - n), (0, npad - n))
        y = jax_attention.fused_swin_attention(
            jnp.pad(_to_jnp(qkv.contiguous()),
                    ((0, 0),) * 3 + ((0, npad - n), (0, 0))),
            jnp.pad(_to_jnp(bias_q), square),
            None if mask_div is None else jnp.pad(_to_jnp(mask_div), square),
            _to_jnp(scalars), interpret=True, **kw)
        y = torch.tensor(np.asarray(y[:, :, :n]))
        ref = plain_k4(qkv, bias_q, mask_div, scalars, lis_wide=lis_wide,
                       **kw)
        equal["k4"].append(float((y == ref).float().mean()))
        return y

    def pallas_k2(x_i8, *args, emit_codes):
        rows = x_i8.shape[0]
        y = jax_mlp.fused_int_mlp(
            jnp.pad(_to_jnp(x_i8), ((0, -rows % 512), (0, 0))),
            *map(_to_jnp, args), block_rows=512, emit_codes=emit_codes,
            interpret=True)
        y = torch.tensor(np.asarray(y[:rows]))
        ref = plain_k2(x_i8, *args, emit_codes=emit_codes)
        assert int((y.int() - ref.int()).abs().max()) <= 1
        equal["k2"].append(float((y == ref).float().mean()))
        return y

    swin_int.fused_swin_attention, swin_int.fused_int_mlp = \
        pallas_k4, pallas_k2
    try:
        swapped = swin_int.forward_q_int(ip, SWIN_T, CFG,
                                         torch.tensor(x)).numpy()
    finally:
        swin_int.fused_swin_attention, swin_int.fused_int_mlp = \
            plain_k4, plain_k2
    np.testing.assert_array_equal(swapped, want)
    assert len(equal["k4"]) == len(equal["k2"]) == sum(SWIN_T.depths)
    assert min(equal["k4"] + equal["k2"]) >= 0.999, equal
    assert np.mean(plain == want) >= 0.9
    np.testing.assert_allclose(plain, want, atol=0.0625)
    np.testing.assert_array_equal(plain.argmax(1), want.argmax(1))


def test_a_scale_below_the_reference_bound_is_refused():
    """Below 2^-17 the reference's own LIS leaves its range: ViT and Swin
    raise ValueError naming the bound; 2^-17 itself is served."""
    ip = random_int_model(TINY_T, seed=1)
    ip["blocks"][0]["attn.qact_attn1"]["scale"] = np.float32(2.0**-18)
    with pytest.raises(ValueError, match=r"block 0: .*below 2\^-17"):
        int_model_from_numpy(ip, TINY_T, "cpu")
    ip["blocks"][0]["attn.qact_attn1"]["scale"] = np.float32(2.0**-17)
    assert int_model_from_numpy(ip, TINY_T, "cpu")["blocks"][0]["lis_wide"]
    ips = random_swin_int_model(SWIN_T, seed=0)
    ips["qp"]["layers.1.blocks.0.attn.qact2.scale"] = np.float32(2.0**-18)
    with pytest.raises(ValueError, match=r"layers.1.blocks.0: .*2\^-17"):
        swin_int_model_from_numpy(ips, SWIN_T, "cpu", CFG)

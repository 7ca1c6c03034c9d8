"""The port's K8 (``fused_qkv_attention`` v1, ``_v3``, ``_v4``, ``_v5``),
K7a (``fused_attention_block``) and K7b (``fused_int_mlp_block``) vs the
JAX Pallas kernels in interpret mode, on the CPU, where the port runs the
plain PyTorch versions; then the slice as a whole on the calibrated TINY
int-model: the per-head relayout, and K8 v1, K7a, K7b and K3 fed from
block 0 of a real forward.

Tolerances: the LIS paths and K7a are exact (integer GEMMs, the exact
LIS, IEEE divisions); the float softmax is within 1 code on fewer than 2%
of codes (K5's rule; bfloat16 weights and float32 sums in the reference);
K7b takes the JAX suite's own rule, more than 99% equal and atol 1.5 *
max(s4) (its LN sums float32 terms past 2^24, and XLA contracts a*b + c
into an fma); K3's raw mode equals the forward's own expression and is
within its two roundings of the fma-contracted reference, its fq and
codes modes exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffvit_tpu.config import QuantConfig as JaxQuantConfig
from diffvit_tpu.models import vit, vit_int as jax_vit_int
from diffvit_tpu.ops.pallas import attention as jax_attention
from diffvit_tpu.ops.pallas.linear import fused_int_linear as jax_linear
from diffvit_tpu.ops.pallas.mlp import fused_int_mlp_block as jax_mlp_block

from diffvit_tpu_torch import QuantConfig
from diffvit_tpu_torch.models import vit_int
from diffvit_tpu_torch.models.convert import (attn_block_operands,
                                              int_model_from_numpy,
                                              mlp_block_operands,
                                              qkv_head_blocks)
from diffvit_tpu_torch.models.vit import ViTSpec
from diffvit_tpu_torch.ops.kernels import attention
from diffvit_tpu_torch.ops.kernels.linear import fused_int_linear
from diffvit_tpu_torch.ops.kernels.mlp import fused_int_mlp_block
from diffvit_tpu_torch.ops.quant import int_matmul
from diffvit_tpu_torch.testing import (alt_kernel_cases, int8_codes,
                                       random_int_model)
from test_torch_linear import assert_raw

# 2 heads of 16, Npad 24 with 20 real rows (the small K8/K7a case)
SMALL = ViTSpec("t16", embed_dim=32, depth=1, num_heads=2, num_classes=10)
B, NPAD, N_REAL = 2, 24, 20
V345 = ("fused_qkv_attention_v3", "fused_qkv_attention_v4",
        "fused_qkv_attention_v5")


def _np(t):
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    return None if t is None else jnp.asarray(
        t.numpy() if isinstance(t, torch.Tensor) else t)


def _assert_codes(got, want, lis):
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    diff = np.abs(got - want)
    if lis:
        np.testing.assert_array_equal(got, want)
    assert diff.max() <= 1 and np.mean(diff > 0) < 0.02, \
        (diff.max(), np.mean(diff > 0))


@pytest.fixture(scope="module")
def small():
    """K8/K7a/K7b arguments at block 0 of a random SMALL int-model."""
    ip = random_int_model(SMALL, seed=3)
    return {lis: alt_kernel_cases(SMALL, ip, B, "cpu", npad=NPAD, lis=lis,
                                  seed=1) for lis in (True, False)}


def _small_n_real(args, kw):
    """SMALL's cases are cut at N_REAL keys (its seq_len is 197)."""
    x = args[0].clone()
    x[:, N_REAL:] = 0
    return (x, *args[1:]), dict(kw, n_real=N_REAL)


@pytest.mark.parametrize("lis", [True, False], ids=["lis", "softmax"])
@pytest.mark.parametrize("name", ("fused_qkv_attention",) + V345)
def test_qkv_attention_variants_match_pallas(small, name, lis):
    args, kw = _small_n_real(*small[lis][name])
    want = getattr(jax_attention, name)(*map(_np, args), **kw,
                                        interpret=True)
    got = getattr(attention, name)(*args, **kw)
    assert got.shape == (B, SMALL.num_heads, NPAD, SMALL.head_dim)
    _assert_codes(got.numpy()[:, :, :N_REAL],
                  np.asarray(want)[:, :, :N_REAL], lis)


def test_v5_refuses_an_odd_batch(small):
    """The Pallas v5's grid is B // 2: for an odd B it leaves the last
    image unwritten.  The port raises instead, on both devices' paths."""
    args, kw = _small_n_real(*small[True]["fused_qkv_attention_v5"])
    odd = (args[0][:1], *args[1:])
    with pytest.raises(ValueError, match="even batch"):
        attention.fused_qkv_attention_v5(*odd, **kw)
    meta = tuple(a.to("meta") for a in odd)
    with pytest.raises(ValueError, match="even batch"):
        attention.fused_qkv_attention_v5(*meta, **kw)


def test_v4_group_changes_nothing(small):
    args, kw = _small_n_real(*small[True]["fused_qkv_attention_v4"])
    base = attention.fused_qkv_attention_v4(*args, **kw)
    for group in (1, 2, 8):
        torch.testing.assert_close(
            attention.fused_qkv_attention_v4(*args, **kw, group=group), base,
            rtol=0, atol=0)


@pytest.mark.parametrize("lis", [True, False], ids=["lis", "softmax"])
def test_attention_block_matches_pallas(small, lis):
    """K7a: exact on the real rows (integer GEMMs, the exact LIS, IEEE
    divisions in both); for the float softmax the qact2 codes of the
    output within one step on fewer than 2%."""
    args, kw = _small_n_real(*small[lis]["fused_attention_block"])
    want = np.asarray(jax_attention.fused_attention_block(
        *map(_np, args), **kw, interpret=True))[:, :N_REAL]
    got = attention.fused_attention_block(*args, **kw).numpy()[:, :N_REAL]
    s2 = args[8][3].numpy()
    if lis:
        np.testing.assert_array_equal(got, want)
    _assert_codes(np.round(got / s2), np.round(want / s2), lis)


def _jax_mlp_block(y, h, ops, block_rows=512):
    """The interpret-mode Pallas K7b on rows zero-padded to block_rows."""
    rows = y.shape[0]
    pad = -rows % block_rows
    yp, hp = (np.pad(t.numpy(), ((0, pad), (0, 0))) for t in (y, h))
    j = {k: _np(v) for k, v in ops.items()}
    pos = [j.pop(k) for k in ("w1", "w2", "mult1", "bias1", "mult2",
                              "bias2", "mlp_out_scale", "s_q1")]
    return np.asarray(jax_mlp_block(jnp.asarray(yp), jnp.asarray(hp), *pos,
                                    **j, block_rows=block_rows,
                                    interpret=True))[:rows]


def _assert_mlp_block(got, want, s4):
    """The JAX suite's rule for K7b (tests/test_pallas_attention.py)."""
    assert np.mean(got == want) > 0.99, np.mean(got == want)
    np.testing.assert_allclose(got, want, atol=float(np.max(s4)) * 1.5)


@pytest.mark.parametrize("rescale", [True, False],
                         ids=["ln_rescale", "no_rescale"])
def test_mlp_block_matches_pallas(small, rescale):
    (y, h), ops = small[True]["fused_int_mlp_block"]
    # 394 rows (2 x 197); the Pallas kernel pads them to 512
    if not rescale:
        ops = dict(ops, ln_rescale=None)
    got = fused_int_mlp_block(y, h, **ops).numpy()
    want = _jax_mlp_block(y, h, ops)
    assert got.shape == (394, SMALL.embed_dim)
    _assert_mlp_block(got, want, ops["s4_vec"].numpy())


# ---- the slice on the calibrated TINY int-model ----

TINY = vit.ViTSpec("test_tiny", embed_dim=64, depth=2, num_heads=2,
                   num_classes=10)
PTINY = ViTSpec("test_tiny", embed_dim=64, depth=2, num_heads=2,
                num_classes=10)
N, TNPAD = 197, 200


@pytest.fixture(scope="module")
def tiny():
    """TINY calibrated by JAX (default QuantConfig), baked int4, as JAX's
    ``prepare_int`` gives it and converted for the port; and the inputs of
    block 0 of a port forward of two images: the LN1 codes x (padded to
    200 rows), the residual h (qact1 codes times their scale), the proj
    output y of K1 and the proj GEMM."""
    cfg_j = JaxQuantConfig()
    params = vit.init_params(TINY, jax.random.PRNGKey(0))
    pixels = np.random.default_rng(0).standard_normal(
        (2, 3, 224, 224)).astype(np.float32)
    qp, _ = vit.calibrate(params, TINY, cfg_j, jnp.asarray(pixels))
    ip_np = jax.device_get(jax_vit_int.prepare_int(
        params, qp, TINY, cfg_j, (4,) * vit.num_bit_slots(TINY)))
    cfg = QuantConfig.from_dict(cfg_j.to_dict())
    ip = int_model_from_numpy(ip_np, PTINY, "cpu", cfg)
    ib = ip["blocks"][0]
    h = vit_int._embed_front(ip, PTINY, cfg, torch.tensor(pixels))
    in_scale = ip["qact1"]["scale"]
    hc = vit_int._codes(h, in_scale, cfg.bit_a)
    x = vit_int._ln_int8(None, ib["norm1"], in_scale, ib["qkv"]["in_scale"],
                         PTINY.ln_eps, x_codes=hc)
    o = attention.fused_qkv_attention_v2(
        x, ib["qkv"]["w_int"], ib["qkv"]["mult"], ib["qkv"]["b"],
        ib["attn_scalars"], num_heads=2, head_dim=32, n_real=N,
        lis_fast=ib["lis_fast"])
    y = vit_int._int_linear(o.permute(0, 2, 1, 3).reshape(2, N, -1),
                            ib["proj"])
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, TNPAD - N))  # noqa
    return dict(ip_np=ip_np, ip=ip, x=pad(x), h=pad(hc.to(torch.float32)
                                                  * in_scale), y=y)


def test_head_blocks_equal_jax_relayout(tiny):
    """``convert.qkv_head_blocks`` equals the per-head arrays JAX's
    ``prepare_int`` bakes, array for array, in every block."""
    for ib_np, ib in zip(tiny["ip_np"]["blocks"], tiny["ip"]["blocks"]):
        got = qkv_head_blocks(ib, PTINY)
        for k in ("wq_h", "wk_h", "wv_h", "mult_h", "bias_h"):
            want = np.asarray(ib_np["qkv"][k])
            assert got[k].numpy().dtype == want.dtype
            np.testing.assert_array_equal(got[k].numpy(), want)


@pytest.mark.parametrize("lis", [True, False], ids=["lis", "softmax"])
def test_tiny_block0_k8_and_k7a_match_pallas(tiny, lis):
    """K8 v1 on block 0's LN1 codes, and K7a on them with the residual,
    against the interpret-mode Pallas kernels on the same arrays; the v1
    per-head weights are JAX's own ``wq_h``, ``wk_h``, ``wv_h``."""
    ib_np, ib = tiny["ip_np"]["blocks"][0], tiny["ip"]["blocks"][0]
    qn = ib_np["qkv"]
    ab = attn_block_operands(ib, PTINY)
    heads_j = [jnp.asarray(qn[k]) for k in ("wq_h", "wk_h", "wv_h",
                                            "mult_h", "bias_h")]
    x = tiny["x"]
    want = jax_attention.fused_qkv_attention(
        _np(x), *heads_j, _np(ab["scalars"]), n_real=N, lis=lis,
        interpret=True)
    got = attention.fused_qkv_attention(
        x, ab["wq"], ab["wk"], ab["wv"], ab["mult"], ab["bias"],
        ab["scalars"], n_real=N, lis=lis)
    _assert_codes(got.numpy()[:, :, :N], np.asarray(want)[:, :, :N], lis)

    want = np.asarray(jax_attention.fused_attention_block(
        _np(x), _np(tiny["h"]), *heads_j[:3], _np(ab["wp"]), *heads_j[3:],
        _np(ab["pvec"]), _np(ab["scalars"]), n_real=N, lis=lis,
        interpret=True))[:, :N]
    got = attention.fused_attention_block(x, tiny["h"], **ab, n_real=N,
                                          lis=lis).numpy()[:, :N]
    s2 = ab["pvec"][3].numpy()
    if lis:
        np.testing.assert_array_equal(got, want)
    _assert_codes(np.round(got / s2), np.round(want / s2), lis)


def test_tiny_block0_k7b_matches_pallas(tiny):
    """K7b on block 0's proj output and residual (its norm2 rescale and
    PTF grids are the calibrated model's)."""
    ops = mlp_block_operands(tiny["ip"]["blocks"][0])
    y = tiny["y"].reshape(-1, PTINY.embed_dim)
    h = tiny["h"][:, :N].reshape(-1, PTINY.embed_dim)
    got = fused_int_mlp_block(y, h, **ops).numpy()
    _assert_mlp_block(got, _jax_mlp_block(y, h, ops),
                      ops["s4_vec"].numpy())


@pytest.mark.parametrize("site", ["patch", "proj", "head"])
def test_tiny_linear_sites_match_pallas(tiny, site):
    """K3 at TINY's patch, proj and head sites, every mode, against the
    interpret-mode Pallas kernel; the raw mode equals the port forward's
    own ``int_matmul(x, w) * mult + b`` bit for bit."""
    ip = tiny["ip"]
    s = {"patch": ip["patch"], "proj": ip["blocks"][0]["proj"],
         "head": ip["head"]}[site]
    rows = {"patch": 2 * 196, "proj": 2 * N, "head": 2}[site]
    out_scale = {"patch": ip["patch.qact"]["scale"],
                 "proj": ip["blocks"][0]["attn.qact3"]["scale"],
                 "head": ip["act_out"]["scale"]}[site]
    x = torch.tensor(int8_codes((rows, s["w_int"].shape[0]), 4))
    args = (x, s["w_int"], s["mult"], s["b"])
    pad = -rows % 256
    xj = jnp.asarray(np.pad(x.numpy(), ((0, pad), (0, 0))))
    jargs = (xj, *map(_np, args[1:]))
    for kw in ({}, dict(out_scale=out_scale),
               dict(out_scale=out_scale, emit_codes=True)):
        got = fused_int_linear(*args, **kw).numpy()
        want = np.asarray(jax_linear(
            *jargs, **{k: _np(v) if k == "out_scale" else v
                       for k, v in kw.items()},
            block_rows=256, sub=256, interpret=True))[:rows]
        if kw:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_array_equal(got, vit_int._int_linear(
                x, s).numpy())
            product = (int_matmul(x, s["w_int"]).to(torch.float32)
                       * s["mult"]).numpy()
            assert_raw(got, want, product, s["b"].numpy())

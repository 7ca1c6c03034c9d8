"""The port's quantization ops vs the JAX package's, on the CPU: the same
seeded numpy inputs go through both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffvit_tpu.ops import int_layernorm as jax_iln
from diffvit_tpu.ops import quant as jax_quant
from diffvit_tpu.ops.bit_types import BIT_TYPE_DICT
from diffvit_tpu.ops.pallas.attention import _lis_body
from diffvit_tpu.ops.pallas.mlp import _gelu_poly
from diffvit_tpu.models import vit_int as jax_vit_int

from diffvit_tpu_torch.models import vit_int
from diffvit_tpu_torch.ops import quant
from diffvit_tpu_torch.ops.int_layernorm import get_mn
from diffvit_tpu_torch.ops.kernels.attention import (lis_body_plain,
                                                     lis_tail_plain)
from diffvit_tpu_torch.ops.kernels.mlp import gelu_poly


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("zp", [0.0, 3.0])
def test_quantize_fake_quant_match_jax(zp):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 48)) * 3).astype(np.float32)
    scale = (2.0 ** rng.integers(-6, -2, 48) * 1.37).astype(np.float32)
    bt = BIT_TYPE_DICT["int8"]
    z = np.float32(zp)
    np.testing.assert_array_equal(
        quant.quantize(_t(x), _t(scale), _t(z), bt).numpy(),
        np.asarray(jax_quant.quantize(x, scale, z, bt)))
    np.testing.assert_array_equal(
        quant.fake_quant(_t(x), _t(scale), _t(z), bt).numpy(),
        np.asarray(jax_quant.fake_quant(x, scale, z, bt)))
    q = np.asarray(jax_quant.quantize(x, scale, z, bt))
    np.testing.assert_array_equal(
        quant.dequantize(_t(q), _t(scale), _t(z)).numpy(),
        np.asarray(jax_quant.dequantize(q, scale, z)))


def test_get_mn_matches_jax():
    rng = np.random.default_rng(1)
    x = np.concatenate([2.0 ** rng.uniform(-12, 12, 20000),
                        2.0 ** np.arange(-12, 12)]).astype(np.float32)
    m, n = get_mn(_t(x))
    jm, jn = jax_iln.get_mn(jnp.asarray(x))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))


def test_pow2_and_int_matmul_exact():
    n = torch.arange(-126, 128, dtype=torch.float32)
    np.testing.assert_array_equal(quant.pow2(n).numpy(),
                                  2.0 ** np.arange(-126, 128, dtype=np.float64))
    rng = np.random.default_rng(2)
    a = rng.integers(-128, 128, (3, 5, 2048)).astype(np.int8)
    b = rng.integers(-128, 128, (2048, 7)).astype(np.int8)
    got = quant.int_matmul(_t(a), _t(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


@pytest.mark.parametrize("rescale", [False, True])
def test_ln_int8_matches_jax(rescale):
    """Integer LayerNorm on residual codes at DeiT-S width.  The port sums
    the integer rows exactly; the reference sums float32 (sum_x2 passes
    2^24 here), so a code may differ by one on a rare row."""
    rng = np.random.default_rng(3)
    c = 384
    codes = np.clip(np.round(rng.standard_normal((8, 197, c)) * 40),
                    -128, 127).astype(np.int8)
    in_scale = (0.0176 * 2.0 ** rng.integers(0, 3, c)).astype(np.float32)
    out_scale = (0.031 * 2.0 ** rng.integers(0, 2, c)).astype(np.float32)
    ln = {"w": (1 + 0.2 * rng.standard_normal(c)).astype(np.float32),
          "b": (0.1 * rng.standard_normal(c)).astype(np.float32)}
    rs = (2.0 ** rng.integers(-1, 2, c)).astype(np.float32) if rescale \
        else None
    want = np.asarray(jax_vit_int._ln_int8(
        None, {k: jnp.asarray(v) for k, v in ln.items()},
        jnp.asarray(in_scale), jnp.asarray(out_scale), 1e-6,
        rescale=None if rs is None else jnp.asarray(rs),
        x_codes=jnp.asarray(codes))).astype(np.int32)
    got = vit_int._ln_int8(
        None, {k: _t(v) for k, v in ln.items()}, _t(in_scale),
        _t(out_scale), 1e-6, rescale=None if rs is None else _t(rs),
        x_codes=_t(codes)).numpy().astype(np.int32)
    assert np.mean(got == want) >= 0.999, np.mean(got == want)
    assert np.abs(got - want).max() <= 1


def test_gelu_poly_matches_jax_bitwise():
    x = np.linspace(-8.0, 8.0, 400001).astype(np.float32)
    np.testing.assert_array_equal(gelu_poly(_t(x)).numpy(),
                                  np.asarray(_gelu_poly(jnp.asarray(x))))


def _tail_exact(m):
    """f64 ground truth of the reference's log2 quantization (layers.py:
    367-376) for bits=4, as the integer weight 2^15 * 2^-rounds."""
    m = np.asarray(m, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        rounds = np.floor(np.log2(2.0 * m / 3.0)) + 1.0
    sat = rounds >= 16
    w = np.where(sat, 0.0, np.exp2(15.0 - np.minimum(rounds, 15.0)))
    return w.astype(np.int64)


def test_lis_tail_every_m_matches_exact_chain():
    """Every m below 2^18 (through the bits=4 saturation boundary at
    m = 3*2^14), the power-of-two neighbourhoods and masked columns."""
    ks = np.arange(2, 24)
    base = 3.0 * 2.0 ** (ks - 2)
    m = np.concatenate([np.arange(1, 1 << 18), base - 2, base - 1, base,
                        base + 1, base + 2])
    m = m[m >= 1].astype(np.float32)
    got = lis_tail_plain(_t(m), torch.ones(len(m))).numpy()
    np.testing.assert_array_equal(got, _tail_exact(m))
    inf = lis_tail_plain(torch.tensor([5.0, 1e30]), torch.tensor([0.0, 1.0]))
    np.testing.assert_array_equal(inf.numpy(), [0, 0])


@pytest.mark.parametrize("fast", [False, True])
def test_lis_body_matches_jax(fast):
    """Whole LIS on integer scores with masked pad columns.  The port sums
    the integer exponentials exactly and builds 2^k exactly; XLA's CPU exp2
    is an ulp off for some k, so a weight may differ on a rare element."""
    rng = np.random.default_rng(4)
    npad, n_real = 200, 197
    a = np.clip(np.round(rng.standard_normal((4, 3, npad, npad)) * 30),
                -128, 127).astype(np.float32)
    col_ok = np.arange(npad) < n_real
    s_a = np.float32(2.0**-4)
    want = np.asarray(_lis_body(jnp.asarray(a), jnp.asarray(s_a), 4,
                                jnp.asarray(col_ok), fast=fast),
                      np.float32) * 2.0**15
    got = lis_body_plain(_t(a), _t(s_a), 4, _t(col_ok), fast=fast).numpy()
    assert np.mean(got == want) >= 0.999, np.mean(got == want)
    assert (got[..., n_real:] == 0).all()
    with pytest.raises(NotImplementedError):
        lis_body_plain(_t(a), _t(s_a), 8, _t(col_ok))

"""The port's calibration ops vs the JAX package's, on the CPU: round_ln,
log2 quantization, lp_loss, the float Log-Int-Softmax and the integer
LayerNorm with a SmoothQuant channel scale.  The same seeded numpy inputs
go through both.

Where the reference's value depends on an approximate transcendental the
port keeps the exact one and the test says how far the reference is from
it (ROADMAP, "How the reference holds the port"):

* ``floor(log2 x)`` / ``ceil(log2 x)`` come from exponent bits; XLA's
  float32 ``log2`` rounds an x one ulp away from a power of two onto the
  integer;
* the LIS weights are exact powers of two; XLA's ``exp2`` on the CPU gives
  some of them a few ulps off (the codes are the same);
* the LIS row sum is exact; the reference's float32 sum depends on its
  order (within a few ulps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffvit_tpu.ops import int_layernorm as jax_iln
from diffvit_tpu.ops import lis as jax_lis
from diffvit_tpu.ops import quant as jax_quant
from diffvit_tpu.ops.bit_types import BIT_TYPE_DICT as JAX_BITS

from diffvit_tpu_torch.ops import int_layernorm as iln
from diffvit_tpu_torch.ops import lis, quant
from diffvit_tpu_torch.ops.bit_types import BIT_TYPE_DICT

from test_torch_calibrate import one_torch_thread  # noqa: F401


def _t(a):
    return torch.tensor(np.asarray(a))


def _powers(lo, hi):
    return np.ldexp(np.float32(1), np.arange(lo, hi)).astype(np.float32)


@pytest.mark.parametrize("mode", ["floor", "round", "ceil"])
def test_round_ln_matches_jax_and_is_exact(mode):
    """Bit-equal to JAX's round_ln on scales spread over 2^-40..2^10, and
    exact (float64 log2 of the float32 value) at and one ulp around every
    power of two there, where XLA's float32 log2 is not."""
    rng = np.random.default_rng(0)
    x = (2.0 ** rng.uniform(-40, 10, 200_000)).astype(np.float32)
    m = None if mode == "round" else mode
    got = quant.round_ln(_t(x), m).numpy()
    want = np.asarray(jax.jit(lambda v: jax_quant.round_ln(v, m))(x))
    np.testing.assert_array_equal(got, want)

    p = _powers(-40, 10)
    edge = np.concatenate([p, np.nextafter(p, np.float32(0)),
                           np.nextafter(p, np.float32(np.inf))])
    e = np.log2(edge.astype(np.float64))
    exact = {"floor": np.floor(e), "ceil": np.ceil(e)}.get(mode)
    if exact is None:  # nearest power of two, measured linearly
        f = np.floor(e)
        exact = f + ((edge - 2.0**f) > (2.0 ** (f + 1) - edge))
    np.testing.assert_array_equal(quant.round_ln(_t(edge), m).numpy(), exact)


def test_xla_log2_departs_one_ulp_below_a_power_of_two():
    """The departure, measured: JAX's floor(log2 x) of the float32 just
    below 2^k is k for most k (float32 log2 rounds onto the integer);
    the port's is k - 1."""
    below = np.nextafter(_powers(-30, 1), np.float32(0))
    jax_floor = np.asarray(jax.jit(lambda v: jax_quant.round_ln(
        v, "floor"))(below))
    port = quant.round_ln(_t(below), "floor").numpy()
    np.testing.assert_array_equal(port, np.arange(-30, 1) - 1)
    assert np.mean(jax_floor != port) > 0.5


def test_exp2_and_floor_log2_exact():
    y = np.arange(-126, 128, dtype=np.float32)
    np.testing.assert_array_equal(quant.exp2(_t(y)).numpy(),
                                  2.0 ** y.astype(np.float64))
    half = quant.exp2(_t(np.float32([0.5, -np.inf, np.inf]))).numpy()
    np.testing.assert_allclose(half, [np.sqrt(2.0), 0.0, np.inf])
    x = np.float32([2.0**-149, 3e-40, 1.0, 0.75, 0.0, np.inf])
    np.testing.assert_array_equal(quant.floor_log2(_t(x)).numpy(),
                                  [-149, -132, 0, -1, -np.inf, np.inf])


def test_log2_quant_and_dequant_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, 197, 197)).astype(np.float32) * 4
    x = np.asarray(jax.nn.softmax(logits, axis=-1))
    x = np.concatenate([x.reshape(-1), np.float32([0.0, 1.0, 2.0**-300])])
    for name in ("uint4", "uint8", "uint3"):
        codes, mask = quant.log2_quant(_t(x), BIT_TYPE_DICT[name])
        jc, jm = jax_quant.log2_quant(jnp.asarray(x), JAX_BITS[name])
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(
            quant.log2_dequant(codes, mask).numpy(),
            np.asarray(jax_quant.log2_dequant(jc, jm)))


@pytest.mark.parametrize("reduction", ["none", "all"])
def test_lp_loss_matches_jax(reduction):
    rng = np.random.default_rng(2)
    a, b = (rng.standard_normal((2, 8, 16)).astype(np.float32)
            for _ in range(2))
    np.testing.assert_allclose(
        quant.lp_loss(_t(a), _t(b), 2.0, reduction).numpy(),
        np.asarray(jax_quant.lp_loss(a, b, 2.0, reduction)), rtol=1e-6)


def test_log_round_matches_jax_and_the_folded_tail():
    """log_round (the reference's nearest-power exponent) bit-equal to
    JAX's, and equal to the fold the LIS tail takes, floor(log2(4m/3)),
    for every integer m of the non-saturated uint4 range."""
    m = np.arange(1, 49152, dtype=np.float32)
    got = lis.log_round(_t(m)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_lis.log_round(m)))
    np.testing.assert_array_equal(got, np.floor(np.log2(4.0 * m / 3.0)))


def _code(w):
    """2^-code weights -> codes (16 for a saturated 0)."""
    w = np.asarray(w, np.float64)
    return np.where(w > 0, np.round(-np.log2(np.where(w > 0, w, 1.0))), 16)


@pytest.mark.parametrize("log2_scale", [-10, -8, -6, -4])
@pytest.mark.parametrize("grid", ["raw", "fake_quant"])
def test_int_softmax_and_log_int_softmax_match_jax(log2_scale, grid):
    """Raw logits (calibration's) and logits on the scale's grid
    (forward_q's).  exp_int bit-equal; exp_sum the exact row sum, JAX's
    float32 sum within a few ulps; the LIS codes bit-equal, the port's
    weights exact powers of two, JAX's within 4 ulps of them."""
    rng = np.random.default_rng(3)
    s = np.float32(2.0**log2_scale)
    a = (rng.standard_normal((2, 2, 197, 197))
         * 0.05 * 2 ** (log2_scale + 10)).astype(np.float32)
    if grid == "fake_quant":
        a = (np.clip(np.round(a / s), -128, 127) * s).astype(np.float32)
    exp_int, exp_sum = lis.int_softmax(_t(a), _t(s))
    j_int, j_sum = jax_lis.int_softmax(jnp.asarray(a), s)
    np.testing.assert_array_equal(exp_int.numpy(), np.asarray(j_int))
    exact = exp_int.numpy().astype(np.int64).sum(-1, keepdims=True)
    np.testing.assert_array_equal(exp_sum.numpy(), exact.astype(np.float32))
    np.testing.assert_allclose(np.asarray(j_sum), exp_sum.numpy(),
                               rtol=5e-7)

    bt = BIT_TYPE_DICT["uint4"]
    got = lis.log_int_softmax(_t(a), _t(s), bt).numpy()
    want = np.asarray(jax_lis.log_int_softmax(jnp.asarray(a), s,
                                              JAX_BITS["uint4"]))
    np.testing.assert_array_equal(_code(got), _code(want))
    pos = got > 0
    assert np.all(np.frexp(got[pos])[0] == 0.5)
    np.testing.assert_allclose(want, got, rtol=4 * 2.0**-23, atol=0)


def test_log_int_softmax_from_int_matches_jax():
    rng = np.random.default_rng(4)
    s = np.float32(2.0**-7)
    a = np.clip(np.round(rng.standard_normal((3, 197, 197)) * 40), -128,
                127).astype(np.float32)
    bt = BIT_TYPE_DICT["uint4"]
    got = lis.log_int_softmax_from_int(_t(a), _t(s), bt).numpy()
    want = np.asarray(jax_lis.log_int_softmax_from_int(
        jnp.asarray(a), s, JAX_BITS["uint4"]))
    np.testing.assert_array_equal(_code(got), _code(want))
    np.testing.assert_allclose(want, got, rtol=4 * 2.0**-23, atol=0)


def test_lis_row_sum_leaves_int64_below_the_scale_limit():
    """Below lis_sum_fits the int64 sum would wrap: the row sum is then a
    float64 sum rounded once, within an ulp of the exact one (Python
    integers)."""
    s = np.float32(2.0**-12)
    assert not lis.lis_sum_fits(float(s), 197)
    x = np.zeros((2, 197), np.float32)
    x[1, ::3] = -1.0
    exp_int, exp_sum = lis.int_softmax_from_int(_t(x), _t(s))
    ints = exp_int.numpy().astype(np.float64)
    exact = [sum(int(v) for v in row) for row in ints]
    assert exact[0] >= 2**63  # the row an int64 sum would wrap
    np.testing.assert_allclose(exp_sum.numpy()[:, 0],
                               np.float32(exact), rtol=2.0**-23)
    assert np.isfinite(lis.log_int_softmax_from_int(
        _t(x), _t(s), BIT_TYPE_DICT["uint4"]).numpy()).all()


def test_int_layernorm_out_scale_channel_matches_jax():
    """forward_q's integer LayerNorm with a SmoothQuant channel scale folded
    into its output grid; without one the callers' values are unchanged."""
    rng = np.random.default_rng(5)
    c = 64
    in_s = (2.0 ** rng.integers(-6, -3, c)).astype(np.float32)
    x = (np.round(rng.standard_normal((2, 197, c)) * 2 / in_s)
         * in_s).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    out_s = np.float32(2.0**-5)
    ch = (2.0 ** rng.integers(-1, 2, c)).astype(np.float32)
    for kw in ({"out_scale_channel": ch}, {}):
        got = iln.int_layernorm(_t(x), _t(w), _t(b), _t(in_s), _t(out_s),
                                **{k: _t(v) for k, v in kw.items()}).numpy()
        want = np.asarray(jax_iln.int_layernorm(x, w, b, in_s, out_s, **kw))
        np.testing.assert_array_equal(got, want)

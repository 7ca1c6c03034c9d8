"""The port's straight-through (STE) ops against the JAX package's, on the
CPU, with seeded numpy inputs handed to both (``jax.grad`` on one side,
``torch.autograd`` on the other):

* ``ste_round`` / ``ste_floor`` and ``fake_quant(ste=True)``: the same
  values as without STE, bit for bit, and the gradient bit-equal to
  JAX's, including at codes on the bounds, where ``jnp.clip`` passes half
  of it (``clip_ties``);
* ``get_mn(ste=True)`` and the integer LayerNorm (``int_layernorm(ste=
  True)``): the exact value (int64 sums, exponent bits) bit for bit, the
  gradient that of JAX's float formula, cosine >= 1 - 1e-6 and every
  element within 1e-4 of the largest (measured: within 3e-6);
* the LIS (``_int_exp``, ``int_softmax``, ``_lis_tail``,
  ``log_int_softmax`` with ``ste=True``): the exact value bit for bit,
  with the int64 row sum and with the 128-bit one (a 2^-12 scale), and the
  gradient of JAX's float formula taken in float64 (``jax.enable_x64``),
  cosine >= 1 - 1e-6 and at least 99.5% of the elements within 1e-4 of
  the largest: where the inverse exp_sum / exp_int lies within a rounding
  of a half, the float32 primal rounds it otherwise than the float64 one,
  the weight's code moves by one and its gradient by up to 2x (measured:
  99.999% at a 2^-5 scale, 99.87% at 2^-12, where a row's inverses all lie
  near 197 and far more of them near a half).  JAX's own float32 gradient is held
  too where it is well conditioned (a 2^-5 scale: cosine >= 1 - 1e-4;
  measured 1 - 2e-6); at 2^-12 every exponential of a row is within 2^-0.2
  of the others and JAX's float32 gradient is noise (cosine 0.008 against
  its own float64 one, which the port's float32 one equals);
* ``calib.optim.Adam`` bit-equal to ``optax.adam`` under ``jax.jit`` over
  30 steps of gradients across seven decades.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffvit_tpu.ops import int_layernorm as jln
from diffvit_tpu.ops import lis as jlis
from diffvit_tpu.ops import quant as jq
from diffvit_tpu.ops.bit_types import BIT_TYPE_DICT as JBITS

from diffvit_tpu_torch.calib.optim import Adam
from diffvit_tpu_torch.ops import int_layernorm as tln
from diffvit_tpu_torch.ops import lis as tlis
from diffvit_tpu_torch.ops import quant as tq
from diffvit_tpu_torch.ops.bit_types import BIT_TYPE_DICT as TBITS

from test_torch_calibrate import one_torch_thread  # noqa: F401

COS_MIN = 1 - 1e-6  # the float formulas' gradients, JAX against the port
ELEM_TOL = 1e-4  # of the largest element


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _grad_close(want, got, cos_min=COS_MIN, share=1.0):
    """Cosine >= ``cos_min``, and at least ``share`` of the elements within
    ELEM_TOL of the largest."""
    want = np.asarray(want, np.float64).ravel()
    got = got.detach().numpy().astype(np.float64).ravel()
    cos = want @ got / (np.linalg.norm(want) * np.linalg.norm(got))
    assert cos >= cos_min, cos
    close = np.abs(want - got) <= ELEM_TOL * np.abs(want).max()
    assert np.mean(close) >= share, np.mean(close)


def _jax_grad64(f, *args):
    """``jax.grad(f)`` of float64 copies of ``args`` (all of them), with
    JAX's 64-bit mode on for the call."""
    with jax.enable_x64(True):
        out = jax.grad(f, argnums=tuple(range(len(args))))(
            *[jnp.asarray(np.asarray(a, np.float64)) for a in args])
        return [np.asarray(o) for o in out]


def test_ste_round_and_floor_are_exact_with_identity_gradient():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(1000) * 300,
                        np.arange(-8, 8) + 0.5]).astype(np.float32)
    for ste, ref, jfn in ((tq.ste_round, torch.round, jq.ste_round),
                          (tq.ste_floor, torch.floor, jq.ste_floor)):
        t = _t(x, True)
        y = ste(t)
        assert torch.equal(y, ref(_t(x)))
        np.testing.assert_array_equal(y.detach().numpy(),
                                      np.asarray(jfn(jnp.asarray(x))))
        y.sum().backward()
        assert torch.equal(t.grad, torch.ones_like(t))
    assert tq.round_fn(False) is torch.round and \
        tq.floor_fn(True) is tq.ste_floor


@pytest.mark.parametrize("bits,zp", [("int4", 0.0), ("int8", 0.0),
                                     ("uint8", 3.0)])
def test_fake_quant_ste_matches_jax_at_the_bounds(bits, zp):
    """Codes that round onto a bound are common (a weight's largest one):
    there JAX's clip passes half the gradient, torch.clamp all of it."""
    bt, jbt = TBITS[bits], JBITS[bits]
    rng = np.random.default_rng(1)
    s = (2.0 ** rng.integers(-6, -2, (16, 1))).astype(np.float32)
    codes = np.concatenate([rng.uniform(bt.lower_bound - 3,
                                        bt.upper_bound + 3, (16, 60)),
                            np.tile([bt.lower_bound, bt.upper_bound,
                                     bt.lower_bound - 0.3,
                                     bt.upper_bound + 0.4], (16, 1))], 1)
    x = ((codes - zp) * s).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jg = jax.grad(lambda v: (jq.fake_quant(v, s, zp, jbt, True)
                             * g).sum())(jnp.asarray(x))
    t = _t(x, True)
    y = tq.fake_quant(t, _t(s), zp, bt, ste=True)
    assert torch.equal(y.detach(), tq.fake_quant(_t(x), _t(s), zp, bt))
    (y * _t(g)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))
    assert set(np.unique(t.grad.numpy() / g)) >= {0.0, 0.5, 1.0}


def test_get_mn_ste_matches_jax():
    rng = np.random.default_rng(2)
    a = np.concatenate([rng.uniform(1e-3, 40, 500),
                        [2.0 ** -1, 255.5 / 128, 1.0, 255 / 128]]
                       ).astype(np.float32)
    jm = jax.grad(lambda v: jln.get_mn(v, True)[0].sum())(jnp.asarray(a))
    t = _t(a, True)
    m, n = tln.get_mn(t, ste=True)
    m0, n0 = tln.get_mn(_t(a))
    assert torch.equal(m.detach(), m0) and torch.equal(n, n0)
    m.sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jm))


LN_CASES = {
    "ptf": dict(ptf=True, channel=True),
    "ptf_no_channel": dict(ptf=True, channel=False),
    "scalar": dict(ptf=False, channel=True),
}


@pytest.mark.parametrize("case", list(LN_CASES))
def test_int_layernorm_ste_is_exact_with_jax_gradient(case):
    ptf, channel = LN_CASES[case]["ptf"], LN_CASES[case]["channel"]
    rng = np.random.default_rng(3)
    c = 64
    in_s = (2.0 ** -4 * 2.0 ** rng.integers(0, 3, c) if ptf
            else np.float32(2.0 ** -4)).astype(np.float32)
    x = (rng.integers(-128, 128, (4, 10, c)) * in_s).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    out_s = np.float32(2.0 ** -4)
    ch = (2.0 ** rng.integers(-1, 2, c)).astype(np.float32) if channel \
        else None
    g = rng.standard_normal(x.shape).astype(np.float32)

    def jf(x_, w_, b_):
        return (jln.int_layernorm(x_, w_, b_, in_s, out_s,
                                  out_scale_channel=ch, ste=True) * g).sum()

    jgrads = jax.grad(jf, argnums=(0, 1, 2))(x, w, b)
    args = [_t(v, True) for v in (x, w, b)]
    kw = dict(out_scale_channel=None if ch is None else _t(ch))
    y = tln.int_layernorm(*args, _t(in_s), _t(out_s), ste=True, **kw)
    y0 = tln.int_layernorm(_t(x), _t(w), _t(b), _t(in_s), _t(out_s), **kw)
    assert torch.equal(y.detach(), y0)
    (y * _t(g)).sum().backward()
    for want, got in zip(jgrads, args):
        _grad_close(want, got.grad)


def _scores(rng, scale, shape=(2, 2, 197, 197)):
    return (rng.integers(-300, 60, shape) * scale).astype(np.float32)


@pytest.mark.parametrize("scale", [2.0 ** -5, 2.0 ** -12],
                         ids=["int64_sum", "wide_sum"])
def test_log_int_softmax_ste_is_exact_with_jax_gradient(scale):
    """2^-12 over 197 keys fails ``lis_sum_fits``: the exact path takes
    the 128-bit row sum."""
    s = np.float32(scale)
    assert tlis.lis_sum_fits(float(s), 197) == (scale > 2.0 ** -10)
    rng = np.random.default_rng(4)
    a = _scores(rng, s)
    g = rng.standard_normal(a.shape).astype(np.float32)

    def jf(v, g_):
        return (jlis.log_int_softmax(v, v.dtype.type(s), JBITS["uint4"],
                                     True) * g_).sum()

    t = _t(a, True)
    y = tlis.log_int_softmax(t, _t(s), TBITS["uint4"], ste=True)
    assert torch.equal(y.detach(), tlis.log_int_softmax(_t(a), _t(s),
                                                         TBITS["uint4"]))
    (y * _t(g)).sum().backward()
    _grad_close(_jax_grad64(jf, a, g)[0], t.grad, share=0.995)
    if tlis.lis_sum_fits(float(s), 197):
        _grad_close(jax.grad(jf)(jnp.asarray(a), g), t.grad, 1 - 1e-4, 0.995)


def test_int_exp_int_softmax_and_tail_ste_match_jax():
    s = np.float32(2.0 ** -5)
    rng = np.random.default_rng(5)
    a = _scores(rng, s, (3, 50))
    x_int = a / s - (a / s).max(-1, keepdims=True)
    g = rng.standard_normal(a.shape).astype(np.float32)

    jg = jax.grad(lambda v: (jlis._int_exp(v, s, ste=True)[0] * g).sum())(
        jnp.asarray(x_int))
    t = _t(x_int, True)
    e = tlis._int_exp(t, _t(s), ste=True)[0]
    assert torch.equal(e.detach(), tlis._int_exp(_t(x_int), _t(s))[0])
    (e * _t(g)).sum().backward()
    _grad_close(jg, t.grad)

    def jsm(v):
        ei, es = jlis.int_softmax(v, s, ste=True)
        return (ei * g).sum() + es.sum()

    jg = jax.grad(jsm)(jnp.asarray(a))
    t = _t(a, True)
    ei, es = tlis.int_softmax(t, _t(s), ste=True)
    ei0, es0 = tlis.int_softmax(_t(a), _t(s))
    assert torch.equal(ei.detach(), ei0) and torch.equal(es.detach(), es0)
    ((ei * _t(g)).sum() + es.sum()).backward()
    _grad_close(jg, t.grad)

    ei0 = ei0.numpy()
    es0 = es0.numpy()
    jg_e, jg_s = jax.grad(
        lambda e_, s_: (jlis._lis_tail(e_, s_, JBITS["uint4"], True)
                        * g).sum(), argnums=(0, 1))(ei0, es0)
    te, ts = _t(ei0, True), _t(es0, True)
    y = tlis._lis_tail(te, ts, TBITS["uint4"], ste=True)
    assert torch.equal(y.detach(), tlis._lis_tail(_t(ei0), _t(es0),
                                                  TBITS["uint4"]))
    (y * _t(g)).sum().backward()
    _grad_close(jg_e, te.grad)
    _grad_close(jg_s, ts.grad)


def test_adam_is_optax_adam_bit_for_bit():
    rng = np.random.default_rng(6)
    p0 = rng.standard_normal(20000).astype(np.float32)
    grads = [(rng.standard_normal(20000) * 10.0 ** rng.integers(-6, 2))
             .astype(np.float32) for _ in range(30)]
    for lr in (1e-2, 1e-5):
        opt = optax.adam(lr)

        @jax.jit
        def update(p, st, g, opt=opt):
            u, st = opt.update(g, st, p)
            return optax.apply_updates(p, u), st

        p, st = jnp.asarray(p0), opt.init(jnp.asarray(p0))
        tp = torch.tensor(p0)
        adam = Adam(tp, lr, len(grads))
        for g in grads:
            p, st = update(p, st, jnp.asarray(g))
            adam.step(torch.tensor(g))
            np.testing.assert_array_equal(tp.numpy(), np.asarray(p))

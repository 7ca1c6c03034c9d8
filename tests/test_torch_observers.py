"""The port's calibration observers (diffvit_tpu_torch/calib/observers.py)
vs the JAX package's, on the CPU: the same seeded numpy tensors go
through both.  The PoT scales (minmax, weights and activations, with the
attention replay and the asymmetric path) and PTF's channel masks are
bit-equal; the plain scales of ema, PTF, percentile and OMSE too, and the
running statistics of every observer (XLA contracts the EMA update and
OMSE's shrink into fused multiply-adds, which the port's float64 steps
round as one)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffvit_tpu.calib import observers as jax_obs
from diffvit_tpu.ops.bit_types import BIT_TYPE_DICT as JAX_BITS

from diffvit_tpu_torch.calib import observers as obs
from diffvit_tpu_torch.ops.bit_types import BIT_TYPE_DICT

from test_torch_calibrate import one_torch_thread  # noqa: F401

WEIGHT_BITS = ("uint3", "uint4", "int4", "int8")


def _t(a):
    return torch.tensor(np.asarray(a))


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _act(seed, shape=(4, 50, 96), outliers=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if outliers:  # a few heavy channels, as LN outputs have
        x[..., :5] *= 12.0
    return x


@pytest.mark.parametrize("bit", WEIGHT_BITS)
@pytest.mark.parametrize("channel_wise", [True, False])
def test_minmax_weight_pot_search_bit_equal(bit, channel_wise):
    rng = np.random.default_rng(0)
    w = (0.02 * rng.standard_normal((96, 64))).astype(np.float32)
    w[3] *= 5.0
    x = _act(1, (2, 40, 64))
    got = obs.minmax_weight_qparams(_t(w), _t(x), BIT_TYPE_DICT[bit],
                                    channel_wise)
    want = jax_obs.minmax_weight_qparams(jnp.asarray(w), jnp.asarray(x),
                                         JAX_BITS[bit], channel_wise)
    assert got[0].shape == ((96,) if channel_wise else ())
    for g, j in zip(got, want):
        _equal(g, j)
    assert np.all(np.frexp(got[0].numpy())[0] == 0.5)  # powers of two


@pytest.mark.parametrize("bit", ["int8", "uint8"])
def test_minmax_act_pot_search_bit_equal(bit):
    x = _act(2)
    got = obs.minmax_act_qparams(_t(x), BIT_TYPE_DICT[bit])
    want = jax_obs.minmax_act_qparams(jnp.asarray(x), JAX_BITS[bit])
    for g, j in zip(got, want):
        _equal(g, j)
    stats = (np.float32(30.0), np.float32(-2.0))
    got = obs.minmax_act_qparams(_t(x), BIT_TYPE_DICT[bit],
                                 stats=tuple(map(_t, stats)))
    want = jax_obs.minmax_act_qparams(jnp.asarray(x), JAX_BITS[bit],
                                      stats=tuple(map(jnp.asarray, stats)))
    _equal(got[0], want[0])


def test_minmax_act_attention_replay_bit_equal():
    """The candidate scored through qkv -> softmax -> @v (make_attn_replay)."""
    num_heads, dim = 2, 32
    x = _act(3, (2, 20, 3 * dim), outliers=False) * 3
    got = obs.minmax_act_qparams(
        _t(x), BIT_TYPE_DICT["int8"],
        attn_replay=obs.make_attn_replay(num_heads, dim, (dim // 2)**-0.5))
    want = jax_obs.minmax_act_qparams(
        jnp.asarray(x), JAX_BITS["int8"],
        attn_replay=jax_obs.make_attn_replay(num_heads, dim,
                                             (dim // 2)**-0.5))
    for g, j in zip(got, want):
        _equal(g, j)


def test_minmax_act_asymmetric_bit_equal():
    x = _act(4) + 3.0
    got = obs.minmax_act_qparams_asymmetric(_t(x), BIT_TYPE_DICT["uint8"])
    want = jax_obs.minmax_act_qparams_asymmetric(jnp.asarray(x),
                                                 JAX_BITS["uint8"])
    for g, j in zip(got, want):
        _equal(g, j)
    assert float(got[1]) != 0.0


@pytest.mark.parametrize("with_stats", [False, True])
def test_ptf_masks_and_scales_bit_equal(with_stats):
    x = _act(5)
    bt, jbt = BIT_TYPE_DICT["int8"], JAX_BITS["int8"]
    stats = None
    if with_stats:
        flat = x.reshape(-1, x.shape[-1])
        stats = (flat.max(0) * 1.5, flat.min(0) * 1.5)
    got = obs.ptf_act_qparams(
        _t(x), bt, stats=None if stats is None else tuple(map(_t, stats)))
    want = jax_obs.ptf_act_qparams(
        jnp.asarray(x), jbt,
        stats=None if stats is None else tuple(map(jnp.asarray, stats)))
    _equal(got[0], want[0])
    _equal(got[1], want[1])
    masks = got[0].numpy() / got[0].numpy().min()
    assert set(np.unique(masks)) <= {1.0, 2.0, 4.0, 8.0}
    assert len(np.unique(masks)) > 1


def test_ema_bit_equal():
    x = _act(6)
    got = obs.ema_act_qparams(_t(x), BIT_TYPE_DICT["int8"])
    want = jax_obs.ema_act_qparams(jnp.asarray(x), JAX_BITS["int8"])
    for g, j in zip(got, want):
        _equal(g, j)


@pytest.mark.parametrize("shape", [(4, 50, 96), (3, 197, 197)])
def test_percentile_matches_jax(shape):
    x = _act(7, shape)
    got = obs.percentile_act_qparams(_t(x), BIT_TYPE_DICT["int8"])
    want = jax_obs.percentile_act_qparams(jnp.asarray(x), JAX_BITS["int8"])
    for g, j in zip(got, want):
        _equal(g, j)


def test_percentile_takes_more_than_2_24_elements():
    """torch.quantile refuses a tensor of more than 2^24 elements (DeiT-S's
    mlp.qact1 at b = 56 has more); the observer's order statistics do not.
    Held against numpy's sort with the reference's float32 weights."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal(2**24 + 3).astype(np.float32)
    q = 0.99999
    got = obs._quantile(_t(x), q).numpy()
    srt = np.sort(x)
    pos = np.float32(q) * (np.float32(x.size) - np.float32(1))
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    hw = np.float32(pos - np.float32(lo))
    want = np.float64(srt[lo]) * np.float64(np.float32(1) - hw) \
        + np.float64(srt[hi]) * np.float64(hw)
    np.testing.assert_array_equal(got, np.float32(want))


@pytest.mark.parametrize("bit", ["int8", "uint4"])
def test_omse_matches_jax(bit):
    x = _act(9)
    got = obs.omse_act_qparams(_t(x), BIT_TYPE_DICT[bit])
    want = jax_obs.omse_act_qparams(jnp.asarray(x), JAX_BITS[bit])
    for g, j in zip(got, want):
        _equal(g, j)
    # the search shrank the range (the first step is the plain minmax)
    flat = x.reshape(-1)
    full = (flat.max() - flat.min()) / np.float32(BIT_TYPE_DICT[bit].range
                                                  - 1)
    assert float(got[0]) < full


@pytest.mark.parametrize("observer", ["minmax", "omse", "ema", "percentile",
                                      "ptf"])
def test_act_stats_update_and_dispatch_match_jax(observer):
    """Two batches of running state, then the scale from it."""
    xs = [_act(10 + i) * (1 + i) for i in range(3)]
    state = jstate = None
    for x in xs[:2]:
        state = obs.act_stats_update(observer, state, _t(x))
        jstate = jax_obs.act_stats_update(observer, jstate, jnp.asarray(x))
    for g, j in zip(state, jstate):
        _equal(g, j)
    got = obs.act_qparams(observer, _t(xs[2]), BIT_TYPE_DICT["int8"],
                          stats=tuple(map(_t, map(np.asarray, jstate))))
    want = jax_obs.act_qparams(observer, jnp.asarray(xs[2]),
                               JAX_BITS["int8"], stats=jstate)
    for g, j in zip(got, want):
        _equal(g, j)

"""The port's recovery passes on the Swin against the JAX package's, on the
CPU, at the TINY Swin (32 wide, depths (2, 1), heads (2, 4), 56 px, 10
classes; block 1 shifted): JAX's params carried across by
``params_from_numpy``, the port's calibration of a seeded batch of 4
carried to JAX (JAX calibrates Swin eagerly, ~35 s for TINY;
tests/test_torch_swin_calibrate.py holds the port's Swin qparams to
JAX's).  JAX's passes call ``swin.forward_q`` eagerly; here it runs under
``jax.jit`` as JAX's engine runs it (``_jit_forward_q``), the taps
returned from the traced function.

* ``forward_q(ste=True)`` bit-equal to ``ste=False`` (uniform 4 and 8, PTF
  off, a {4, 8, -1} config);
* the STE gradient of a logits MSE against ``jax.grad`` leaf by leaf, by
  tests/test_torch_recovery.py's rule (cosine >= 0.999, relative norm
  difference <= 2e-2 against JAX in float32 and float64; measured >=
  0.9998), each block's rel_bias_table against the float64 one only: it
  is reached only through the LIS's gradient with respect to the scores,
  where JAX's float32 gradient is noise (cosine -0.16 against its own
  float64 one, which the port's matches at 0.9998); every leaf class of
  JAX's test_qat.py nonzero;
* ``taps`` / ``w_in_taps`` of both forwards: JAX's names and order, at
  least 99.5% of the values within 1e-4 of the largest (an activation
  code one step apart shifts what follows it; measured 99.9%);
* ``adaround_swin`` at 20 steps: the report's keys in JAX's order, its
  mses within rtol 1e-5, the learned codes equal to JAX's in at least
  99.9% of the weights (measured 100%), every site improving, the weights
  re-rounding bit for bit;
* ``bias_correct``: the biases within 1e-3 of the largest (measured
  3e-4: a shift is a difference of two means, the port's in float64,
  JAX's float32 sums in XLA's order), the report
  within rtol 1e-3 (before; measured 1.3e-4) and 1e-7 absolute (after);
* ``qat_distill`` at the CLI's learning rate, 1e-5: the first loss
  within rtol 1e-6 of JAX's, the trajectory over 3 steps within rtol 0.1
  (measured 2.4e-2) and falling.  Adam's first steps move every weight by
  about the learning rate whatever its gradient's size, so the tables'
  noisy float32 gradients in JAX (above) move them otherwise than the
  port's, and codes flip; JAX in float64 departs from the port by 3.5%
  after 5 steps too, from its own float32 run by 8%.  ``remat`` raises
  ``NotImplementedError`` for Swin.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffvit_tpu.calib import adaround as jad
from diffvit_tpu.calib import biascorr as jbc
from diffvit_tpu.calib import qat as jqat
from diffvit_tpu.config import QuantConfig as JaxQuantConfig
from diffvit_tpu.models import swin as jswin

from diffvit_tpu_torch import QuantConfig
from diffvit_tpu_torch.calib import adaround, biascorr, qat
from diffvit_tpu_torch.models import swin, vit
from diffvit_tpu_torch.ops.bit_types import BIT_TYPE_DICT
from diffvit_tpu_torch.ops.quant import fake_quant

from test_torch_calibrate import one_torch_thread  # noqa: F401
from test_torch_recovery import (_leaf_items, _with_grad,
                                 assert_grads_match, jax_grads)

TINY_KW = dict(embed_dim=32, depths=(2, 1), num_heads=(2, 4), img_size=56,
               num_classes=10)
J_TINY = jswin.SwinSpec("swin_test3", **TINY_KW)
TINY = swin.SwinSpec("swin_test3", **TINY_KW)
N = swin.num_bit_slots(TINY)
MIXED = (8,) + (4, 8, -1, 4) + (-1, 4, 8, 8) + (-1,) + (8, 4, 4, 8) + (4,)


@functools.lru_cache(maxsize=None)
def _jitted(spec, cfg, bc, ste, names):
    """``jswin.forward_q`` under ``jax.jit`` returning its logits, taps and
    w_in_taps; ``names`` (a list) receives the tap names while it traces."""
    def run(params, qp, x):
        taps, w = [], []
        y = jswin._eager_forward_q(params, qp, spec, cfg, x, bc, taps=taps,
                                   w_in_taps=w, ste=ste)
        names[:] = [[n for n, _ in taps], [n for n, _ in w]]
        return y, [a for _, a in taps], [a for _, a in w]
    return jax.jit(run)


class _Names(list):
    __hash__ = object.__hash__


@pytest.fixture
def jit_swin(monkeypatch):
    """``jswin.forward_q`` jitted for JAX's passes (their lists filled from
    the traced function's outputs)."""
    monkeypatch.setattr(jswin, "_eager_forward_q", jswin.forward_q,
                        raising=False)
    names = {}

    def forward_q(params, qp, spec, cfg, x, bit=None, taps=None,
                  w_in_taps=None, ste=False):
        bc = jswin.normalize_bit_config(spec, bit if bit is not None
                                        else cfg.bit_w.bits)
        key = (spec, cfg, bc, ste)
        nm = names.setdefault(key, _Names())
        y, t, w = _jitted(*key, nm)(params, qp, x)
        if taps is not None:
            taps.extend(zip(nm[0], t))
        if w_in_taps is not None:
            w_in_taps.extend(zip(nm[1], w))
        return y

    monkeypatch.setattr(jswin, "forward_q", forward_q)


@pytest.fixture(scope="module")
def tiny():
    params_j = jswin.init_swin_params(J_TINY, jax.random.PRNGKey(0))
    params = vit.params_from_numpy(jax.device_get(params_j), "cpu")
    x = np.random.default_rng(1).standard_normal(
        (4, 3, 56, 56)).astype(np.float32)
    qp, _ = swin.calibrate(params, TINY, QuantConfig(), torch.tensor(x))
    qp_j = {k: jnp.asarray(v.numpy()) for k, v in qp.items()}
    return params_j, params, qp_j, qp, x


@pytest.mark.parametrize("case", ["int4", "int8", "ptf_off", "mixed"])
def test_swin_forward_q_ste_is_bit_equal(tiny, case):
    _, params, _, qp, x = tiny
    cfg = QuantConfig(ptf=case != "ptf_off")
    if case == "ptf_off":
        qp, _ = swin.calibrate(params, TINY, cfg, torch.tensor(x[:2]))
    bits = dict(int4=4, int8=8, ptf_off=None, mixed=MIXED)[case]
    xt = torch.tensor(x)
    y = swin.forward_q(params, qp, TINY, cfg, xt, bits)
    assert torch.equal(swin.forward_q(params, qp, TINY, cfg, xt, bits,
                                      ste=True), y)


def test_swin_ste_gradients_match_jax(tiny):
    params_j, params, qp_j, qp, x = tiny

    def jloss(p, qp_, x_):
        return jnp.mean(jswin.forward_q(p, qp_, J_TINY, JaxQuantConfig(), x_,
                                        4, ste=True) ** 2)

    want32, want64 = jax_grads(jloss, params_j, qp_j, x)
    p = _with_none(params)
    y = swin.forward_q(p, vit.autograd_safe(qp), TINY, QuantConfig(),
                       torch.tensor(x), 4, ste=True)
    (y.to(torch.float64) ** 2).mean().backward()
    got = {k: t.grad for k, t in _leaf_items(p)}
    assert_grads_match(got, want32, want64, ("rel_bias_table",))
    for k in ("patch_embed.proj.w", "layers.0.blocks.0.qkv.w",
              "layers.0.blocks.0.fc2.w", "layers.0.blocks.0.rel_bias_table",
              "layers.0.downsample.reduction.w", "head.w"):
        assert float(got[k].norm()) > 0, k


def _with_none(tree):
    """``_with_grad`` keeping None leaves."""
    if isinstance(tree, dict):
        return {k: _with_none(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_none(v) for v in tree]
    return None if tree is None else _with_grad(tree)


@pytest.mark.parametrize("forward", ["forward_fp", "forward_q"])
def test_swin_taps_match_jax(tiny, forward, jit_swin):
    params_j, params, qp_j, qp, x = tiny
    jtaps, jw, taps, w = [], [], [], []
    if forward == "forward_fp":
        names = []

        def run(p):
            t_, w_ = [], []
            jswin.forward_fp(p, J_TINY, jnp.asarray(x), taps=t_,
                             w_in_taps=w_)
            names.extend([[n for n, _ in t_], [n for n, _ in w_]])
            return [a for _, a in t_], [a for _, a in w_]

        ta, wa = jax.jit(run)(params_j)
        jtaps, jw = list(zip(names[0], ta)), list(zip(names[1], wa))
        swin.forward_fp(params, TINY, torch.tensor(x), taps=taps,
                        w_in_taps=w)
    else:
        jswin.forward_q(params_j, qp_j, J_TINY, JaxQuantConfig(),
                        jnp.asarray(x), MIXED, taps=jtaps, w_in_taps=jw)
        swin.forward_q(params, qp, TINY, QuantConfig(), torch.tensor(x),
                       MIXED, taps=taps, w_in_taps=w)
    for want, got in ((jtaps, taps), (jw, w)):
        assert [n for n, _ in got] == [n for n, _ in want]
        for (n, a), (_, t) in zip(want, got):
            a = np.asarray(a)
            close = np.abs(t.numpy() - a) <= 1e-4 * np.abs(a).max()
            assert np.mean(close) >= 0.995, (n, np.mean(close))


def test_adaround_swin_matches_jax(tiny, jit_swin):
    params_j, params, qp_j, qp, x = tiny
    jnew, jrep = jad.adaround_swin(params_j, qp_j, J_TINY, JaxQuantConfig(),
                                   jnp.asarray(x), 4, steps=20, max_rows=256)
    new, rep = adaround.adaround_swin(params, qp, TINY, QuantConfig(),
                                      torch.tensor(x), 4, steps=20,
                                      max_rows=256)
    assert list(rep) == list(jrep) and len(rep) == N
    for name, (before, after) in rep.items():
        np.testing.assert_allclose((before, after), jrep[name], rtol=1e-5)
        assert after <= before * 1.001, (name, before, after)
    jnew = jax.device_get(jnew)
    equal = total = 0
    bt = BIT_TYPE_DICT["int4"]
    for name, ppath, spre, _ in adaround._swin_sites(TINY, (4,) * N):
        a, w = np.asarray(adaround._get(jnew, ppath)), \
            adaround._get(new, ppath)
        equal, total = equal + int((a == w.numpy()).sum()), total + a.size
        s = qp[f"{spre}.int4.scale"]
        assert torch.equal(fake_quant(w, s[:, None] if s.dim() else s, 0.0,
                                      bt), w), name
    assert equal / total >= 0.999, equal / total


def test_swin_bias_correct_matches_jax(tiny, jit_swin):
    params_j, params, qp_j, qp, x = tiny
    jnew, jrep = jbc.bias_correct(params_j, qp_j, J_TINY, JaxQuantConfig(),
                                  jnp.asarray(x), 4)
    new, rep = biascorr.bias_correct(params, qp, TINY, QuantConfig(),
                                     torch.tensor(x), 4)
    assert list(rep) == list(jrep)
    for name, (before, after) in rep.items():
        np.testing.assert_allclose(before, jrep[name][0], rtol=1e-3)
        assert abs(after - jrep[name][1]) <= 1e-7 and after <= before
    jnew = jax.device_get(jnew)
    for _, bpath in biascorr._swin_bias_sites(TINY):
        a, b = np.asarray(adaround._get(jnew, bpath)), \
            adaround._get(new, bpath).numpy()
        assert np.abs(a - b).max() <= 1e-3 * np.abs(a).max(), bpath


def test_swin_qat_follows_jax(tiny, jit_swin):
    params_j, params, qp_j, qp, x = tiny
    _, jlosses = jqat.qat_distill(params_j, qp_j, J_TINY, JaxQuantConfig(),
                                  [jnp.asarray(x)], 4, steps=3, lr=1e-5)
    new, losses = qat.qat_distill(params, qp, TINY, QuantConfig(),
                                  [torch.tensor(x)], 4, steps=3, lr=1e-5)
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-6)
    np.testing.assert_allclose(losses, jlosses, rtol=0.1)
    assert losses[-1] < losses[0]
    assert new["layers"][0]["downsample"]["reduction"]["b"] is None
    with pytest.raises(NotImplementedError, match="remat"):
        qat.qat_distill(params, qp, TINY, QuantConfig(), [torch.tensor(x)],
                        4, steps=1, remat=True)

"""The port's recovery passes on the ViT against the JAX package's, on the
CPU, at the TINY spec (64 wide, 2 blocks, 10 classes): JAX's params
carried across by ``params_from_numpy``, JAX's default calibration of a
seeded numpy batch of 4 handed to both as the same qparams.

* ``forward_q(ste=True)`` bit-equal to ``ste=False`` (P2-ViT int4 and
  int8, FQ-ViT int8, PTF off, -1 slots; the port's own calibrations);
* the STE gradient of a logits MSE against ``jax.grad`` leaf by leaf, in
  float32 and in float64 (``jax.enable_x64``): cosine >= 0.999 and
  relative norm difference <= 2e-2 against both (measured >= 0.9995 and
  <= 1.1e-2: an activation code a step apart moves a leaf's norm), except each block's
  norm1.w and qkv.w, held against the float64 one only (against the
  float32 one they measure cosine 0.993): their gradient is the q/k one
  through the LIS, 1% of the v one, where JAX's float32 gradient departs
  from its own float64 one (tests/test_torch_recovery_ops.py), which the
  port's float32 one follows; with ``ste=False`` the gradient is zero;
* ``taps`` / ``w_in_taps`` of both forwards: JAX's names in JAX's order,
  the values within rtol 1e-4 of the largest;
* ``remat``: the loss and every gradient bit for bit; with taps it raises
  before any is appended;
* AdaRound: ``_optimize_site`` on the same inputs (the codes after 1, 3
  and 25 steps equal JAX's in at least 99.9% of the weights, measured
  100%; the mses within rtol 1e-5), ``adaround_vit`` at 50 steps (the
  report's keys in JAX's order, its mses within rtol 1e-5, every weight's
  learned code equal to JAX's in at least 99.9%, measured 100%; every
  site improves; -1 slots skipped; the weights re-round bit for bit, and
  the bake's weight codes are the learned ones);
* QAT: ``qat_distill`` on a list of two batches (cycled) follows JAX's
  loss trajectory over 4 steps within rtol 1e-4; the teacher runs once a
  batch;
* bias correction: the biases within 1e-5 of the largest, the report
  within rtol 1e-4 (before) and 1e-7 absolute (after); after AdaRound,
  given the original float params;
* the engine: ``_recon_input``, and each pass replacing ``params``,
  keeping ``fp_params`` and dropping every bake, so that ``prepare_int``
  equals a fresh bake of the new params;
* the slice: calibrate, AdaRound, bias correction, bake, integer forward,
  in both packages (JAX's Pallas kernels in interpret mode), held by
  ``_assert_paths_agree``; then JAX's learned params through the port's
  bias correction and bake, held against JAX's chain the same way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffvit_tpu.calib import adaround as jad
from diffvit_tpu.calib import biascorr as jbc
from diffvit_tpu.calib import qat as jqat
from diffvit_tpu.config import QuantConfig as JaxQuantConfig
from diffvit_tpu.models import vit as jvit
from diffvit_tpu.models import vit_int as jvit_int
from diffvit_tpu.ops.bit_types import BIT_TYPE_DICT as JBITS

from diffvit_tpu_torch import QuantConfig, engine
from diffvit_tpu_torch.calib import adaround, biascorr, qat
from diffvit_tpu_torch.models import vit, vit_int
from diffvit_tpu_torch.ops.bit_types import BIT_TYPE_DICT
from diffvit_tpu_torch.ops.quant import fake_quant

from test_torch_calibrate import (J_TINY, TINY, _assert_paths_agree,
                                  _qp_torch, one_torch_thread)  # noqa: F401

N = vit.num_bit_slots(TINY)
BC = (4,) * N
MIXED = (8,) + (4, -1, 8, 4) + (-1, 8, 4, 8) + (4,)


@pytest.fixture(scope="module")
def tiny():
    """TINY's params in both packages, JAX's calibration of a batch of 4
    (as JAX and as torch qparams) and the batch."""
    params_j = jvit.init_params(J_TINY, jax.random.PRNGKey(0))
    params = vit.params_from_numpy(jax.device_get(params_j), "cpu")
    x = np.random.default_rng(1).standard_normal(
        (4, 3, 224, 224)).astype(np.float32)
    qp_j, _ = jvit.calibrate(params_j, J_TINY, JaxQuantConfig(),
                             jnp.asarray(x))
    return params_j, params, qp_j, _qp_torch(qp_j), x


def _leaf_items(tree, prefix=""):
    """(path, tensor) of every leaf, in the pytree's key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_items(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_items(v, f"{prefix}{i}.")
    elif tree is not None:
        yield prefix[:-1], tree


def _with_grad(tree):
    return {k: _with_grad(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else [_with_grad(v) for v in tree] \
        if isinstance(tree, list) else tree.clone().requires_grad_(True)


STE_CASES = {
    "p2vit_int4": ({}, None),
    "p2vit_int8": ({}, (8,) * N),
    "fqvit_int8": (dict(smoothquant=False, bit_w=BIT_TYPE_DICT["int8"]),
                   None),
    "ptf_off": (dict(ptf=False), None),
    "minus_one": ({}, MIXED),
}


@pytest.mark.parametrize("case", list(STE_CASES))
def test_forward_q_ste_is_bit_equal(tiny, case):
    _, params, _, _, x = tiny
    kw, bits = STE_CASES[case]
    cfg = QuantConfig(**kw)
    qp, _ = vit.calibrate(params, TINY, cfg, torch.tensor(x[:2]))
    xt = torch.tensor(x)
    y = vit.forward_q(params, qp, TINY, cfg, xt, bits)
    assert torch.equal(vit.forward_q(params, qp, TINY, cfg, xt, bits,
                                     ste=True), y)


def jax_grads(loss, params_j, qp_j, x):
    """``jax.grad(loss)(params, qp, x)`` under ``jax.jit``, in float32 and
    (``jax.enable_x64``) in float64, as {leaf path: array} each."""
    out = []
    for dt in (np.float32, np.float64):
        with jax.enable_x64(dt == np.float64):
            cast = lambda t: jax.tree.map(  # noqa: E731
                lambda a: jnp.asarray(np.asarray(a).astype(dt)), t)
            g = jax.jit(jax.grad(loss))(cast(jax.device_get(params_j)),
                                        cast(qp_j), cast(x))
            out.append(dict(_leaf_items(jax.device_get(g))))
    return out


def assert_grads_match(got, want32, want64, lis_path):
    """Every leaf's gradient against JAX's float64 one, cosine >= 0.999 and
    relative norm difference <= 2e-2; and against its float32 one the same
    way but for the leaves ``lis_path`` names (reached only through the
    LIS's gradient with respect to the scores, where JAX's float32 one is
    noise)."""
    assert list(got) == list(want32) == list(want64)
    for k, g in got.items():
        g = g.numpy().astype(np.float64).ravel()
        for want in ((want64,) if k.endswith(lis_path) else
                     (want32, want64)):
            w = np.asarray(want[k], np.float64).ravel()
            cos = w @ g / (np.linalg.norm(w) * np.linalg.norm(g))
            rel = abs(np.linalg.norm(g) / np.linalg.norm(w) - 1)
            assert cos >= 0.999 and rel <= 2e-2, (k, cos, rel)


def test_ste_gradients_match_jax(tiny):
    params_j, params, qp_j, qp, x = tiny
    cfg = QuantConfig()

    def jloss(p, qp_, x_):
        return jnp.mean(jvit.forward_q(p, qp_, J_TINY, JaxQuantConfig(), x_,
                                       BC, ste=True) ** 2)

    want32, want64 = jax_grads(jloss, params_j, qp_j, x)
    p = _with_grad(params)
    y = vit.forward_q(p, vit.autograd_safe(qp), TINY, cfg, torch.tensor(x),
                      BC, ste=True)
    (y.to(torch.float64) ** 2).mean().backward()
    got = {k: t.grad for k, t in _leaf_items(p)}
    assert_grads_match(got, want32, want64, ("norm1.w", "qkv.w"))
    for k in ("patch_embed.w", "blocks.0.qkv.w", "blocks.1.fc2.w", "head.w",
              "blocks.0.norm1.w", "cls_token", "pos_embed"):
        assert float(got[k].norm()) > 0, k

    p0 = _with_grad(params)
    y = vit.forward_q(p0, vit.autograd_safe(qp), TINY, cfg, torch.tensor(x),
                      BC)
    (y ** 2).mean().backward()
    assert p0["blocks"][0]["qkv"]["w"].grad is None or \
        float(p0["blocks"][0]["qkv"]["w"].grad.norm()) == 0.0


def _jax_taps(forward, params_j):
    """The (name, array) lists ``taps`` and ``w_in_taps`` of a JAX forward
    ``forward(params, taps, w_in_taps)``, run under ``jax.jit`` (the names
    recorded while it traces)."""
    names = []

    def run(p):
        t, w = [], []
        forward(p, t, w)
        names.extend([[n for n, _ in t], [n for n, _ in w]])
        return [a for _, a in t], [a for _, a in w]

    arrays = jax.device_get(jax.jit(run)(params_j))
    return [list(zip(n, a)) for n, a in zip(names, arrays)]


@pytest.mark.parametrize("forward", ["forward_fp", "forward_q"])
def test_taps_match_jax(tiny, forward):
    params_j, params, qp_j, qp, x = tiny
    taps, w = [], []
    if forward == "forward_fp":
        jtaps, jw = _jax_taps(lambda p, t, w_: jvit.forward_fp(
            p, J_TINY, jnp.asarray(x), taps=t, w_in_taps=w_), params_j)
        vit.forward_fp(params, TINY, torch.tensor(x), taps=taps, w_in_taps=w)
    else:
        jtaps, jw = _jax_taps(lambda p, t, w_: jvit.forward_q(
            p, qp_j, J_TINY, JaxQuantConfig(), jnp.asarray(x), MIXED,
            taps=t, w_in_taps=w_), params_j)
        vit.forward_q(params, qp, TINY, QuantConfig(), torch.tensor(x),
                      MIXED, taps=taps, w_in_taps=w)
    for want, got in ((jtaps, taps), (jw, w)):
        assert [n for n, _ in got] == [n for n, _ in want]
        for (n, a), (_, t) in zip(want, got):
            a = np.asarray(a)
            np.testing.assert_allclose(t.numpy(), a, rtol=0,
                                       atol=1e-4 * np.abs(a).max(),
                                       err_msg=n)


def test_remat_is_bit_identical_and_refuses_taps(tiny):
    _, params, _, qp, x = tiny
    cfg, qp = QuantConfig(), vit.autograd_safe(qp)
    grads = []
    for remat in (False, True):
        p = _with_grad(params)
        y = vit.forward_q(p, qp, TINY, cfg, torch.tensor(x), BC, ste=True,
                          remat=remat)
        loss = (y.to(torch.float64) ** 2).mean()
        loss.backward()
        grads.append((loss.detach(), [t.grad for _, t in _leaf_items(p)]))
    assert torch.equal(grads[0][0], grads[1][0])
    for a, b in zip(grads[0][1], grads[1][1]):
        assert torch.equal(a, b)
    taps, w_in = [], []
    for kw in (dict(taps=taps), dict(w_in_taps=w_in)):
        with pytest.raises(ValueError, match="remat"):
            vit.forward_q(params, qp, TINY, cfg, torch.tensor(x), remat=True,
                          **kw)
    assert taps == [] and w_in == []


def _site_inputs(seed=7, rows=300, k=64, n=32):
    rng = np.random.default_rng(seed)
    xf = rng.standard_normal((rows, k)).astype(np.float32)
    xq = (np.round(xf * 16) / 16).astype(np.float32)
    w = (0.1 * rng.standard_normal((n, k))).astype(np.float32)
    s = (2.0 ** rng.integers(-6, -4, (n, 1))).astype(np.float32)
    s_b = np.broadcast_to(s, w.shape).astype(np.float32)
    return xq, xf, w, np.floor(w / s_b).astype(np.float32), s_b


@pytest.mark.parametrize("steps", [1, 3, 25])
def test_optimize_site_matches_jax(steps):
    xq, xf, w, floor, s_b = _site_inputs()
    bt = JBITS["int4"]
    args = (float(bt.lower_bound), float(bt.upper_bound), steps, 1e-2, 0.01,
            20.0, 2.0, int(round(steps * 0.2)))
    jw, jm0, jm1 = jad._optimize_site(*(jnp.asarray(a) for a in
                                        (xq, xf, w, floor, s_b)), *args)
    tw, m0, m1 = adaround._optimize_site(
        *(torch.tensor(a) for a in (xq, xf, w, floor, s_b)), *args)
    jcodes = np.asarray(jw) / s_b
    codes = tw.numpy() / s_b
    assert np.mean(codes == jcodes) >= 0.999, np.mean(codes == jcodes)
    np.testing.assert_allclose(float(m0), float(jm0), rtol=1e-5)
    np.testing.assert_allclose(float(m1), float(jm1), rtol=1e-5)


@pytest.fixture(scope="module")
def rounded(tiny):
    """AdaRound of TINY at 50 steps, 512 rows, in both packages."""
    params_j, params, qp_j, qp, x = tiny
    jnew, jrep = jad.adaround_vit(params_j, qp_j, J_TINY, JaxQuantConfig(),
                                  jnp.asarray(x), BC, steps=50, max_rows=512)
    new, rep = adaround.adaround_vit(params, qp, TINY, QuantConfig(),
                                     torch.tensor(x), BC, steps=50,
                                     max_rows=512)
    return jax.device_get(jnew), jrep, new, rep


def _weight_sites(spec, bits):
    return [(name, ppath, spre, smooth, b) for name, ppath, spre, smooth, b
            in adaround._vit_sites(spec, bits)]


def test_adaround_vit_matches_jax(tiny, rounded):
    _, params, _, qp, _ = tiny
    jnew, jrep, new, rep = rounded
    assert list(rep) == list(jrep)
    for name, (before, after) in rep.items():
        np.testing.assert_allclose((before, after), jrep[name], rtol=1e-5)
        assert after <= before * 1.001, (name, before, after)
    equal = total = 0
    for _, ppath, _, _, _ in _weight_sites(TINY, BC):
        a, b = np.asarray(adaround._get(jnew, ppath)), \
            adaround._get(new, ppath).numpy()
        equal, total = equal + int((a == b).sum()), total + a.size
    assert equal / total >= 0.999, equal / total
    # untouched leaves stay the same tensors
    assert new["blocks"][0]["qkv"]["b"] is params["blocks"][0]["qkv"]["b"]


def test_adaround_weights_reround_and_reach_the_bake(tiny, rounded):
    _, params, _, qp, _ = tiny
    _, _, new, _ = rounded
    cfg = QuantConfig()
    bt = BIT_TYPE_DICT["int4"]
    for name, ppath, spre, smooth, _ in _weight_sites(TINY, BC):
        w = adaround._get(new, ppath)
        if smooth:
            ch = qp[f"{spre}.sq.channel_scale"][0]
            s = qp[f"{spre}.w.int4.scale"][0]
            wq = fake_quant(w * ch, s[:, None], 0.0, bt)
            assert torch.equal(wq / ch, w), name
        else:
            s = qp[f"{spre}.int4.scale"]
            assert torch.equal(fake_quant(w, s[:, None], 0.0, bt), w), name
    ip = vit_int.prepare_int(new, qp, TINY, cfg)
    ch = qp["blocks.0.attn.qkv.sq.channel_scale"][0]
    s = qp["blocks.0.attn.qkv.w.int4.scale"][0]
    learned = (new["blocks"][0]["qkv"]["w"] * ch / s[:, None]).numpy()
    # the bake holds (K, Cout) int8 codes
    np.testing.assert_array_equal(ip["blocks"][0]["qkv"]["w_int"].T,
                                  learned)
    s2 = qp["blocks.1.mlp.fc2.w.int4.scale"]
    learned = (new["blocks"][1]["fc2"]["w"] / s2[:, None]).numpy()
    np.testing.assert_array_equal(ip["blocks"][1]["fc2"]["w_int"].T,
                                  learned)


def test_adaround_skips_minus_one_slots(tiny):
    params_j, params, qp_j, qp, x = tiny
    new, rep = adaround.adaround_vit(params, qp, TINY, QuantConfig(),
                                     torch.tensor(x[:2]), MIXED, steps=5,
                                     max_rows=256)
    assert list(rep) == [name for name, *_, bit
                         in jad._vit_sites(J_TINY, MIXED) if bit != -1]
    assert "blocks.0.attn.proj" not in rep and "blocks.1.attn.qkv" not in rep
    assert new["blocks"][0]["proj"]["w"] is params["blocks"][0]["proj"]["w"]


def test_qat_follows_jax_and_cycles_batches(tiny, monkeypatch):
    params_j, params, qp_j, qp, x = tiny
    batches = [x[:2], x[2:]]
    _, jlosses = jqat.qat_distill(params_j, qp_j, J_TINY, JaxQuantConfig(),
                                  [jnp.asarray(b) for b in batches], BC,
                                  steps=4, lr=1e-4)
    calls = []
    fp = vit.forward_fp
    monkeypatch.setattr(vit, "forward_fp",
                        lambda *a, **k: calls.append(1) or fp(*a, **k))
    new, losses = qat.qat_distill(params, qp, TINY, QuantConfig(),
                                  [torch.tensor(b) for b in batches], BC,
                                  steps=4, lr=1e-4)
    assert len(calls) == 2 and len(losses) == 4
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[0] != losses[1]  # the second batch
    assert not torch.equal(new["head"]["w"], params["head"]["w"])
    with pytest.raises(NotImplementedError, match="remat"):
        from diffvit_tpu_torch.models.swin import SwinSpec
        qat.qat_distill(params, qp, SwinSpec("s", 32, (1, 1), (2, 2)), None,
                        [torch.tensor(x)], steps=1, remat=True)


def test_bias_correct_matches_jax(tiny):
    params_j, params, qp_j, qp, x = tiny
    jnew, jrep = jbc.bias_correct(params_j, qp_j, J_TINY, JaxQuantConfig(),
                                  jnp.asarray(x), BC)
    new, rep = biascorr.bias_correct(params, qp, TINY, QuantConfig(),
                                     torch.tensor(x), BC)
    assert list(rep) == list(jrep)
    for name, (before, after) in rep.items():
        np.testing.assert_allclose(before, jrep[name][0], rtol=1e-4)
        assert abs(after - jrep[name][1]) <= 1e-7 and after <= before
    jnew = jax.device_get(jnew)
    for _, bpath in biascorr._vit_bias_sites(TINY):
        a, b = np.asarray(adaround._get(jnew, bpath)), \
            adaround._get(new, bpath).numpy()
        assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max(), bpath
    assert new["blocks"][0]["qkv"]["w"] is params["blocks"][0]["qkv"]["w"]


@pytest.fixture(scope="module")
def chain(tiny, rounded):
    """JAX's chain: AdaRound (``rounded``), bias correction toward the
    original float params, the bake, and its integer forward (Pallas in
    interpret mode) on two other images."""
    params_j, _, qp_j, _, x = tiny
    jnew = rounded[0]
    jboth, _ = jbc.bias_correct(jnew, qp_j, J_TINY, JaxQuantConfig(),
                                jnp.asarray(x), BC, fp_params=params_j)
    xv = np.random.default_rng(2).standard_normal(
        (2, 3, 224, 224)).astype(np.float32)
    ref = np.asarray(jvit_int.forward_q_int(
        jvit_int.prepare_int(jboth, qp_j, J_TINY, JaxQuantConfig()),
        J_TINY, JaxQuantConfig(), jnp.asarray(xv), use_pallas=True,
        pallas_interpret=True))
    return jax.device_get(jboth), xv, ref


def test_bias_correct_composes_with_adaround(tiny, rounded, chain):
    _, params, _, qp, x = tiny
    new = rounded[2]
    jboth = chain[0]
    both, _ = biascorr.bias_correct(new, qp, TINY, QuantConfig(),
                                    torch.tensor(x), BC, fp_params=params)
    fp = vit.forward_fp(params, TINY, torch.tensor(x))

    def err(p):
        y = vit.forward_q(p, qp, TINY, QuantConfig(), torch.tensor(x), BC)
        return float((y - fp).norm() / fp.norm())

    assert err(both) < err(new)
    for _, bpath in biascorr._vit_bias_sites(TINY):
        a = np.asarray(adaround._get(jboth, bpath))
        b = adaround._get(both, bpath).numpy()
        assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max(), bpath


def _port_model(params, qp):
    q = engine.QuantizedViT(TINY, QuantConfig(), params=params, device="cpu")
    q.qparams = qp
    return q


def test_recon_input_caps_and_concatenates(tiny):
    _, params, _, _, x = tiny
    q = _port_model(params, None)
    b0, b1 = x[:2], x[2:]
    assert torch.equal(q._recon_input(b0, 1), torch.tensor(b0))
    assert torch.equal(q._recon_input([b0, b1], 256), torch.tensor(x))
    got = q._recon_input([b0, b1], 3)
    assert torch.equal(got, torch.tensor(np.concatenate([b0[:2], b1[:1]])))
    assert q._recon_input([b0, b1], None).shape[0] == 4
    with pytest.raises(RuntimeError, match="calibrate"):
        q.adaround(b0)


@pytest.mark.parametrize("pass_", ["adaround", "qat", "bias_correct"])
def test_engine_pass_replaces_params_and_drops_bakes(tiny, pass_):
    _, params, _, qp, x = tiny
    q = _port_model(params, qp)
    old = q.prepare_int()
    q.forward_bits_int(x[:1], (4,) * N)
    assert q._int_models and q._int_bits is not None
    kw = dict(adaround=dict(steps=3, max_rows=256), qat=dict(steps=2),
              bias_correct={})[pass_]
    fp = q.fp_params
    out = getattr(q, pass_)([x[:2], x[2:]], **kw)
    assert isinstance(out, (dict, list)) and len(out) > 0
    assert q.fp_params is fp and q.params is not fp
    assert not q._int_models and q._int_bits is None
    served = q.prepare_int()
    assert served is not old
    fresh = engine.IntModel(vit_int.prepare_int(q.params, qp, TINY,
                                                QuantConfig()),
                            TINY, QuantConfig(), "cpu")
    xs = x[:2]
    assert torch.equal(served(xs), fresh(xs))


def test_slice_against_jax(tiny, rounded, chain):
    """Calibrate -> AdaRound -> bias correction -> bake -> integer forward
    in the port (its own calibration) against JAX's chain; then JAX's
    learned params through the port's bias correction and bake."""
    params_j, params, _, qp, x = tiny
    jnew = rounded[0]
    _, xv, ref = chain
    q = engine.QuantizedViT(TINY, QuantConfig(), params=params, device="cpu")
    q.calibrate(x)
    q.adaround(x, steps=50, max_rows=512)
    learned = [adaround._get(q.params, ppath).numpy()
               for _, ppath, *_ in _weight_sites(TINY, BC)]
    jlearned = [np.asarray(adaround._get(jnew, ppath))
                for _, ppath, *_ in _weight_sites(TINY, BC)]
    equal = sum(int((a == b).sum()) for a, b in zip(learned, jlearned))
    assert equal / sum(a.size for a in learned) >= 0.99
    q.bias_correct(x)
    _assert_paths_agree(q.prepare_int()(xv).numpy(), ref)

    q2 = engine.QuantizedViT(TINY, QuantConfig(), params=params, device="cpu")
    q2.qparams, q2.params = qp, vit.params_from_numpy(jnew, "cpu")
    q2.bias_correct(x)
    _assert_paths_agree(q2.prepare_int()(xv).numpy(), ref)

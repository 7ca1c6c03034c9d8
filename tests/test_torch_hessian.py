"""The port's Hessian sensitivity (``analysis.hessian``) against the JAX
package's, on the CPU, at the TINY ViT (64 wide, 2 blocks) and the TINY
Swin (32 wide, depths (2, 1), 56 px) with JAX's params carried across and
seeded numpy batches through both.

The two packages draw their probes from different generators, so the
tests hand the port the probes JAX draws from its keys (its
``_chunked_keys`` split and ``jax.random.rademacher``), through the
port's ``probes`` hook.  Tolerances: an HVP within 1e-4 of ``max|Hv|`` on
every entry; a ``v . Hv`` and a trace within 1e-4 of ``sum |v * Hv|``
(``v . Hv`` can cancel); the normalized sensitivity within 1e-4
(measured: about 1e-6 relative everywhere, the port's float products in
float64 against JAX's float32).  JAX's estimators run at ``max_iter`` 3
on a few target weights: JAX compiles one HVP per weight and batch.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffvit_tpu.analysis import hessian as jh
from diffvit_tpu.models import swin as jswin
from diffvit_tpu.models import vit as jvit

from diffvit_tpu_torch.analysis import hessian
from diffvit_tpu_torch.models import swin, vit

from test_torch_calibrate import one_torch_thread  # noqa: F401

VIT_KW = dict(embed_dim=64, depth=2, num_heads=2, num_classes=10)
SWIN_KW = dict(embed_dim=32, depths=(2, 1), num_heads=(2, 4), img_size=56,
               num_classes=10)
SPECS = {"vit": (jvit.ViTSpec("t", **VIT_KW), vit.ViTSpec("t", **VIT_KW)),
         "swin": (jswin.SwinSpec("s", **SWIN_KW),
                  swin.SwinSpec("s", **SWIN_KW))}
FC1 = {"vit": "blocks.1.mlp.fc1.weight",
       "swin": "layers.0.blocks.1.mlp.fc1.weight"}
NAMES = ["blocks.0.attn.qkv.weight", "blocks.1.mlp.fc1.weight",
         "head.weight"]
RTOL = 1e-4


@pytest.fixture(scope="module")
def models():
    """Per family: (JAX spec, port spec, JAX params, port params, two
    (inputs, targets) batches of 2)."""
    out = {}
    rng = np.random.default_rng(0)
    for fam, (jspec, spec) in SPECS.items():
        if fam == "vit":
            pj = jvit.init_params(jspec, jax.random.PRNGKey(0))
        else:
            pj = jswin.init_swin_params(jspec, jax.random.PRNGKey(0))
        size = spec.img_size
        batches = [(rng.standard_normal((2, 3, size, size))
                    .astype(np.float32), rng.integers(0, 10, 2))
                   for _ in range(2)]
        out[fam] = (jspec, spec, pj,
                    vit.params_from_numpy(jax.device_get(pj), "cpu"),
                    batches)
    return out


def _rademacher(key, shape):
    return np.asarray(jax.random.rademacher(key, shape, dtype=jnp.float32))


def _leaf_probes(key, shape, n):
    """The ``n`` probes JAX's ``hutchinson_trace`` draws from ``key``
    (n <= its chunk of 15)."""
    _, subs = jh._chunked_keys(key, n)
    return [_rademacher(s, shape) for s in subs]


def _joint_probes(key, shapes, n):
    """The ``n`` joint samples of JAX's ``hessian_traces_joint`` from
    ``key``: a dict per sample, one probe per weight."""
    _, subs = jh._chunked_keys(key, n)
    return [dict(zip(shapes, (_rademacher(k, s) for k, s in zip(
        jax.random.split(sub, len(shapes)), shapes.values()))))
        for sub in subs]


def test_target_names_match_jax():
    for jspec, spec in list(SPECS.values()) + [
            (jvit.VIT_SPECS["deit_small"], vit.VIT_SPECS["deit_small"]),
            (jswin.SWIN_SPECS["swin_tiny"], swin.SWIN_SPECS["swin_tiny"])]:
        names = hessian.hessian_target_names(spec)
        assert names == jh.hessian_target_names(jspec)
        flops = (swin if isinstance(spec, swin.SwinSpec) else vit) \
            .flops_list(spec)
        assert len(names) == len(flops) - 1


@pytest.mark.parametrize("fam,leaf", [("vit", "head"), ("vit", "fc1"),
                                      ("swin", "head"), ("swin", "fc1")])
def test_block_hvp_matches_jax(models, fam, leaf):
    jspec, spec, pj, pt, batches = models[fam]
    x, y = batches[0]
    name = "head.weight" if leaf == "head" else FC1[fam]
    w = jh._get_leaf(pj, name)
    v = _rademacher(jax.random.PRNGKey(3), w.shape)
    want = np.asarray(jh.make_block_hvp(pj, jspec, jnp.asarray(x),
                                        jnp.asarray(y), name)(w, v))
    got = hessian.make_block_hvp(pt, spec, x, y, name)(
        torch.tensor(v)).numpy()
    assert got.shape == w.shape and np.abs(want).max() > 0
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
    assert abs(np.sum(got * v) - np.sum(want * v)) <= \
        RTOL * np.sum(np.abs(want * v))


@pytest.mark.parametrize("fam", ["vit", "swin"])
def test_joint_hvp_matches_jax(models, fam):
    """The HVP over the head and one fc1 jointly, per leaf."""
    jspec, spec, pj, pt, batches = models[fam]
    x, y = batches[1]
    names = ["head.weight", FC1[fam]]
    ws0, hvp = jh._multi_leaf_fns(pj, jspec, jnp.asarray(x), jnp.asarray(y),
                                  names)
    vs = _joint_probes(jax.random.PRNGKey(4),
                       {n: ws0[n].shape for n in names}, 1)[0]
    want = jax.device_get(hvp(ws0, vs))
    grads = hessian.BatchGrads(pt, spec, x, y, names)
    got = grads.joint_hvp({n: torch.tensor(v) for n, v in vs.items()})
    for n in names:
        g, w = got[n].numpy(), np.asarray(want[n])
        assert np.abs(g - w).max() <= RTOL * np.abs(w).max(), n
        assert abs(np.sum(g * vs[n]) - np.sum(w * vs[n])) <= \
            RTOL * np.sum(np.abs(w * vs[n])), n


def test_hutchinson_trace_stops_with_jax(models):
    """With JAX's probes, the same stop sample (here before max_iter, at
    tol 0.5) and the same trace."""
    tol = 0.5
    jspec, spec, pj, pt, batches = models["vit"]
    x, y = batches[0]
    name, key = FC1["vit"], jax.random.PRNGKey(5)
    w = jh._get_leaf(pj, name)
    hvp_j = jh.make_block_hvp(pj, jspec, jnp.asarray(x), jnp.asarray(y),
                              name)
    want, n_want = jh.hutchinson_trace(hvp_j, w, key, max_iter=3, tol=tol)
    probes = _leaf_probes(key, w.shape, 3)
    hvp = hessian.make_block_hvp(pt, spec, x, y, name)
    got, n_got = hessian.hutchinson_trace(
        hvp, torch.tensor(np.asarray(w)),
        lambda k, like: torch.tensor(probes[k]), max_iter=3, tol=tol)
    assert n_got == n_want < 3
    scale = np.mean([np.sum(np.abs(v * np.asarray(hvp_j(w, v))))
                     for v in probes])
    assert abs(got - want) <= RTOL * scale


def _jax_sensitivity_probes(key, pj, names, batches, joint, max_iter):
    """``probes(batch, name, sample, like)`` handing the port every probe
    JAX's ``hessian_sensitivity`` draws from ``key``."""
    table = {}
    shapes = {n: jh._get_leaf(pj, n).shape for n in names}
    for bi in range(len(batches)):
        key, sub = jax.random.split(key)
        if joint:
            for k, vs in enumerate(_joint_probes(sub, shapes, max_iter)):
                table.update({(bi, n, k): v for n, v in vs.items()})
            continue
        for n in names:
            sub, leaf_key = jax.random.split(sub)
            for k, v in enumerate(_leaf_probes(leaf_key, shapes[n],
                                               max_iter)):
                table[(bi, n, k)] = v
    return lambda bi, n, k, like: torch.tensor(table[(bi, n, k)])


@pytest.mark.parametrize("joint", [False, True], ids=["per-leaf", "joint"])
def test_hessian_sensitivity_matches_jax(models, monkeypatch, joint):
    """Three target weights, max_iter 3, tol 0.2 (so that some traces stop
    early), one batch per leaf (JAX compiles an HVP per weight and batch)
    and two joint: per-batch |trace|, min-max normalized, the mean over
    batches."""
    jspec, spec, pj, pt, batches = models["vit"]
    batches = batches if joint else batches[:1]
    key = jax.random.PRNGKey(6)
    fn = "hessian_traces_joint" if joint else "hessian_traces"
    monkeypatch.setattr(jh, fn, functools.partial(getattr(jh, fn),
                                                  names=NAMES))
    want = jh.hessian_sensitivity(pj, jspec, batches, key, max_iter=3,
                                  tol=0.2, log=lambda *_: None, joint=joint)
    got = hessian.hessian_sensitivity(
        pt, spec, batches, max_iter=3, tol=0.2, log=lambda *_: None,
        joint=joint, names=NAMES,
        probes=_jax_sensitivity_probes(key, pj, NAMES, batches, joint, 3))
    assert len(got) == len(NAMES)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL)
    assert min(got) == 0 and max(got) <= 1


def test_generator_probes_are_seeded_and_take_inference_params(models):
    """The default probes are ±1 from the ``torch.Generator``: the same
    seed, the same sensitivity; params made under inference mode (as the
    engine makes tensors) give the same values."""
    _, spec, _, pt, batches = models["swin"]
    names = ["head.weight", FC1["swin"], "layers.0.downsample."
             "reduction.weight"]

    def run(params, seed):
        return hessian.hessian_sensitivity(
            params, spec, batches[:1], torch.Generator().manual_seed(seed),
            max_iter=3, log=lambda *_: None, joint=True, names=names)

    with torch.inference_mode():
        frozen = vit.params_from_numpy(pt, "cpu")
        frozen = {**frozen, "head": {k: v.clone() for k, v in
                                     frozen["head"].items()}}
    assert frozen["head"]["w"].is_inference()
    first = run(pt, 1)
    assert run(frozen, 1) == first and run(pt, 2) != first
    v = hessian.rademacher(pt["head"]["w"], torch.Generator().manual_seed(0))
    assert v.dtype == torch.float32 and set(v.unique().tolist()) == {-1, 1}

"""The port's DDV Hessian (``analysis.ddv_hessian``) against the JAX
package's, on the CPU, at the TINY ViT (64 wide, 2 blocks, 74 module taps
at DeiT-S are 14 here) with JAX's params carried across and seeded numpy
inputs.  The target model's params are the reference's with every element
scaled by 1 + 0.02 N(0, 1) (as a quantized model departs from its float
one), so that the DDV loss is not at its minimum and every term of its
Hessian counts.  The port's probes are JAX's own (``_leaf_probes`` of
``tests/test_torch_hessian.py``, one split of the key a weight, as JAX's
``DDVHessian.trace`` draws them).

The port takes the Grams and the loss in float64 and the forward's
products in float64 rounded once; its traces are held against JAX's in
float64 (``jax.enable_x64``).  JAX's float32 traces are noise at 1e-4:
they depart from its own float64 ones by up to 2.7e-4 relative on these
weights (each Gram entry a float32 sum of 50,176 products).
"""
import types

import jax
import numpy as np
import pytest
import torch

from diffvit_tpu.analysis import ddv_hessian as jdh
from diffvit_tpu.models import swin as jswin
from diffvit_tpu.models import vit as jvit

from diffvit_tpu_torch import QuantConfig, engine
from diffvit_tpu_torch.analysis import ddv_hessian, hessian
from diffvit_tpu_torch.models import swin, vit

from test_torch_calibrate import one_torch_thread  # noqa: F401
from test_torch_hessian import _leaf_probes

VIT_KW = dict(embed_dim=64, depth=2, num_heads=2, num_classes=10)
JSPEC, SPEC = jvit.ViTSpec("t", **VIT_KW), vit.ViTSpec("t", **VIT_KW)
PROBED = ["blocks.0.attn.qkv.weight", "blocks.0.mlp.fc2.weight",
          "blocks.1.mlp.fc1.weight"]


@pytest.fixture(scope="module")
def models():
    """JAX's (reference, target) models, the port's, and the clean and
    adversarial inputs (a batch of 3)."""
    ref = jax.device_get(jvit.init_params(JSPEC, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    tgt = jax.tree.map(lambda a: (a * (1 + 0.02 * rng.standard_normal(
        a.shape))).astype(np.float32), ref)
    x = rng.standard_normal((3, 3, 224, 224)).astype(np.float32)
    adv = (x + rng.uniform(-0.06, 0.06, x.shape)).astype(np.float32)
    jax_models = [types.SimpleNamespace(params=p, spec=JSPEC)
                  for p in (ref, tgt)]
    port_models = [engine.QuantizedViT(SPEC, QuantConfig(), params=p,
                                       device="cpu") for p in (ref, tgt)]
    return jax_models, port_models, x, adv


@pytest.mark.parametrize("layer", [0, 2, 10, 13, None])
def test_param_names_match_jax(models, capsys, layer):
    """The probed weights and the warning (the patch tap, 0, names no
    target weight) as JAX's; params_up_to's substring rule on DeiT-S."""
    (jref, jtgt), (ref, tgt), x, adv = models
    want = jdh.DDVHessian(jref, jtgt, (x, None), adv, layer_indices=layer)
    want_out = capsys.readouterr().out
    got = ddv_hessian.DDVHessian(ref, tgt, (x, None), adv,
                                 layer_indices=layer)
    assert capsys.readouterr().out == want_out
    assert got.param_names == want.param_names
    assert got.tap_names == list(want.tap_names)
    assert ("Warning: Target layer patch_embed.proj not found in model\n"
            == want_out) == (layer == 0)
    deit = hessian.hessian_target_names(vit.VIT_SPECS["deit_small"])
    for sel in ("blocks.1.attn", "blocks.4.mlp.fc2", "head", "nothing"):
        assert ddv_hessian.params_up_to(deit, sel) == \
            jdh.params_up_to(deit, sel)
    assert len(ddv_hessian.params_up_to(deit, "blocks.1.attn")) == 5
    capsys.readouterr()


def test_reference_ddvs_match_jax(models):
    """Every tap's Gram (clean x adversarial) within 1e-6 of its largest
    entry against the Gram of JAX's taps taken in float64, as the port
    takes it, and within 1e-5 against JAX's own float32 Gram.  Measured:
    1.9e-7 and 6.6e-6 (JAX sums up to 50,176 float32 products a
    entry)."""
    (jref, jtgt), (ref, tgt), x, adv = models
    want = jdh.DDVHessian(jref, jtgt, (x, None), adv)
    got = ddv_hessian.DDVHessian(ref, tgt, (x, None), adv)
    acts, _ = jdh._taps_for_layer(jref.params, JSPEC, x)
    adv_acts, _ = jdh._taps_for_layer(jref.params, JSPEC, adv)
    assert len(got.ref_ddvs) == 6 * SPEC.depth + 2 == len(want.ref_ddvs)
    for g, w, a, b in zip(got.ref_ddvs, want.ref_ddvs, acts, adv_acts):
        a, b = (np.asarray(t, np.float64).reshape(3, -1) for t in (a, b))
        w64, w = a @ b.T, np.asarray(w, np.float64)
        assert g.dtype == torch.float64 and g.shape == w.shape == (3, 3)
        assert np.abs(g.numpy() - w64).max() <= 1e-6 * np.abs(w64).max()
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_trace_matches_jax_on_its_probes(models, monkeypatch):
    """Tap 10 (blocks.1.mlp, so 7 weights), three of its weights at
    max_iter 3 and tol 0.2 (so that some stop early), on JAX's probes
    against JAX in float64: the same number of samples for each weight,
    and each trace within 1e-4 of the mean sum |v * Hv| of its probes.
    Measured: within 4.7e-8 of it (1.2e-6 relative or closer to JAX's
    float64 traces)."""
    (jref, jtgt), (ref, tgt), x, adv = models
    layer, max_iter, tol = 10, 3, 0.2
    names = PROBED
    samples = {"jax": [], "port": []}

    def recording(fn, who):
        def run(*args, **kw):
            out = fn(*args, **kw)
            samples[who].append(out[1])
            return out
        return run

    monkeypatch.setattr(jdh, "hutchinson_trace",
                        recording(jdh.hutchinson_trace, "jax"))
    monkeypatch.setattr(hessian, "hutchinson_trace",
                        recording(hessian.hutchinson_trace, "port"))
    with jax.enable_x64(True):
        f64 = [types.SimpleNamespace(params=jax.tree.map(
            lambda a: np.asarray(a, np.float64), m.params), spec=JSPEC)
            for m in (jref, jtgt)]
        want = jdh.DDVHessian(*f64, (x.astype(np.float64), None),
                              adv.astype(np.float64), layer_indices=layer,
                              max_iter=max_iter, tol=tol)
        key = jax.random.PRNGKey(5)
        want_names, want_t = want.trace(key=key, param_names=names)
        table = {}
        for n in names:
            key, sub = jax.random.split(key)
            table[n] = _leaf_probes(sub, jdh._get_leaf(
                jtgt.params, n).shape, max_iter)
    got = ddv_hessian.DDVHessian(ref, tgt, (x, None), adv,
                                 layer_indices=layer, max_iter=max_iter,
                                 tol=tol)
    assert got.param_names == list(want.param_names)
    got_names, got_t = got.trace(
        param_names=names,
        probes=lambda n, s, like: torch.tensor(table[n][s]))
    assert got_names == list(want_names) == names
    assert samples["port"] == samples["jax"] and len(samples["jax"]) == 3
    assert min(samples["jax"]) < max_iter
    grads = hessian.BatchGrads(got.q_params, SPEC, None, None, names,
                               loss_fn=got.loss)
    for n, g, w, s in zip(names, got_t, want_t, samples["port"]):
        scale = np.mean([float(torch.sum(torch.abs(
            torch.tensor(v) * grads.hvp(n, torch.tensor(v)))))
            for v in table[n][:s]])
        assert scale > 0 and abs(g - w) <= 1e-4 * scale, (n, g, w, scale)


def test_default_probes_are_seeded(models):
    """Without ``probes`` the Rademacher probes come from the generator
    (None: seeded with 0)."""
    _, (ref, tgt), x, adv = models
    d = ddv_hessian.DDVHessian(ref, tgt, (x, None), (adv, None),
                               layer_indices=2, max_iter=2)
    run = lambda s: d.trace(torch.Generator().manual_seed(s))[1]  # noqa
    assert run(0) == d.trace()[1] == run(0) != run(1)
    assert all(np.isfinite(run(0)))
    # the patch tap (0) names no target weight: every weight is probed,
    # none reaches the loss, and each trace is 0 (JAX's jvp of a constant
    # gradient), after one sample
    patch = ddv_hessian.DDVHessian(ref, tgt, (x, None), adv,
                                   layer_indices=0, max_iter=3)
    names, traces = patch.trace(param_names=PROBED)
    assert names == PROBED and traces == [0.0] * 3


def test_swin_is_refused_as_jax_fails():
    """JAX's DDVHessian runs the ViT float forward on a Swin's params and
    fails there with KeyError 'w'; the port raises ValueError first."""
    kw = dict(embed_dim=32, depths=(2, 1), num_heads=(2, 4), img_size=56,
              num_classes=10)
    jspec, spec = jswin.SwinSpec("s", **kw), swin.SwinSpec("s", **kw)
    pj = jax.device_get(jswin.init_swin_params(jspec, jax.random.PRNGKey(0)))
    x = np.random.default_rng(0).standard_normal((2, 3, 56, 56)).astype(
        np.float32)
    jm = types.SimpleNamespace(params=pj, spec=jspec)
    with pytest.raises(KeyError, match="'w'"):
        jdh.DDVHessian(jm, jm, (x, None), x + 0.1, layer_indices=3)
    m = engine.QuantizedViT(spec, QuantConfig(), params=pj, device="cpu")
    with pytest.raises(ValueError, match="Swin"):
        ddv_hessian.DDVHessian(m, m, (x, None), x + 0.1, layer_indices=3)

"""The port's activation harvesting, CKA, PGD, DDV and CKA drivers
(``diffvit_tpu_torch/analysis/{activations,cka,pgd,ddv,cka_drivers}.py``)
against the JAX package's, on the CPU, at the TINY ViT (64 wide, 2
blocks) and the TINY Swin (32 wide, depths (2, 1), 56 px): JAX's params
carried across by ``params_from_numpy``, each calibrated once by the port
on a seeded Gaussian batch and the same qparams handed to JAX's engine.

* ``get_activations``: JAX's order (6 * depth + 2 float taps, 4 * depth
  + 2 conv and linear sites; Swin's folded to (B, -1), with the
  reductions) and shapes in both modes, ``layer_indices``' infos; the
  float values within 1e-5 of each tap's largest (measured <= 8.5e-7),
  the fake-quant ones bit-equal in >= 99% of the elements (measured 100%
  for ViT and Swin; a code that differed would move what follows);
  ``normalize_act`` within 1e-6 of JAX's;
* ``MinibatchCKA`` (one model, across models) and ``MinibatchAdvCKA``:
  the heatmaps within 1e-5 of JAX's float32 ones, absolute (the entries
  lie in [-1, 1]; the port takes the Grams in float64 and rounds once;
  measured <= 1.2e-7), the diagonal 1 within 1e-6;
* PGD (``AttackPGD``, float) and the pseudo-label PGD
  (``gen_profiling_adv_inputs``) from JAX's own uniform start (injected):
  >= 99% of the elements equal JAX's after 3 steps (measured 100% and
  99.9993%; ``sign(g)`` flips only where the gradient is at the noise
  level), and every iterate held exactly inside the ball and [min, max]
  (or [0, 1]); the fake-quant attack's gradient is exactly 0, as JAX's
  (the rounding without the STE), so it returns the clamped start,
  bit-equal to JAX's; a Swin's per-slot bit config reaches the attacked
  forward;
* ``AttackPGD.get_seed_inputs``: the batch JAX's loader gives from the
  same train folder;
* ``compute_ddv`` within 1e-5 of JAX's (measured <= 1.8e-7),
  ``ddv_similarities`` of a model with itself 100%;
* the drivers: ``compute_cka_internal``'s heatmap within 1e-5 of JAX's
  (measured 1.1e-6; the head's row is NaN in both: its unbiased HSIC on
  4 images is negative), ``compute_cka_with_adversarial``'s (a float
  model1 against the fake-quant model2, two batches, two PGD steps from
  JAX's starts) within 1e-4 (measured 2.6e-5, from one PGD element of
  602,112 that takes the other sign), and both drivers' pickles where
  JAX puts them.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffvit_tpu.analysis import activations as jact
from diffvit_tpu.analysis import cka as jcka
from diffvit_tpu.analysis import cka_drivers as jdrv
from diffvit_tpu.analysis import ddv as jddv
from diffvit_tpu.analysis import pgd as jpgd
from diffvit_tpu.config import QuantConfig as JaxQuantConfig
from diffvit_tpu.engine import QuantizedViT as JaxQuantizedViT
from diffvit_tpu.models import swin as jswin
from diffvit_tpu.models import vit as jvit

from diffvit_tpu_torch import QuantConfig, engine
from diffvit_tpu_torch.analysis import activations, cka, cka_drivers, ddv, pgd
from diffvit_tpu_torch.models import swin, vit

from test_torch_calibrate import one_torch_thread  # noqa: F401

VIT_KW = dict(embed_dim=64, depth=2, num_heads=2, num_classes=10)
SWIN_KW = dict(embed_dim=32, depths=(2, 1), num_heads=(2, 4), img_size=56,
               num_classes=10)
FAMILIES = {
    "vit": (jvit.ViTSpec("test_tiny", **VIT_KW),
            vit.ViTSpec("test_tiny", **VIT_KW), jvit.init_params),
    "swin": (jswin.SwinSpec("swin_test", **SWIN_KW),
             swin.SwinSpec("swin_test", **SWIN_KW), jswin.init_swin_params),
}


def _images(spec, n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, spec.img_size, spec.img_size)).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    """{family: (JAX engine, port engine)}: the same params, the port's
    calibration of a batch of 4 in both."""
    out = {}
    for name, (js, ts, init) in FAMILIES.items():
        pj = init(js, jax.random.PRNGKey(0))
        tq = engine.QuantizedViT(ts, QuantConfig(), device="cpu",
                                 params=jax.device_get(pj))
        tq.calibrate(_images(ts, 4, 1))
        jq = JaxQuantizedViT(js, JaxQuantConfig(), params=pj)
        jq.qparams = {k: jnp.asarray(v.numpy())
                      for k, v in tq.qparams.items()}
        out[name] = (jq, tq)
    return out


MODES = {"vit-float": ("vit", None), "vit-quant": ("vit", "bits"),
         "swin-float": ("swin", None), "swin-quant": ("swin", 4)}


@pytest.mark.parametrize("mode", list(MODES))
def test_get_activations_match_jax(models, mode):
    name, bits = MODES[mode]
    jq, tq = models[name]
    if bits == "bits":
        bits = (4,) * vit.num_bit_slots(tq.spec)
    quant = bits is not None
    x = _images(tq.spec, 3, 2)
    want = jax.jit(lambda v: jact.get_activations(jq, v, bits, quant=quant))(
        jnp.asarray(x))  # jitted: JAX's eager Swin forward takes ~17 s
    got = activations.get_activations(tq, x, bits, quant=quant)
    order = jact._order_for_swin(jq.spec) if name == "swin" else \
        jact._order_for(jq.spec, module_taps=bits is None)
    if name == "vit":
        assert len(order) == (4 if quant else 6) * tq.spec.depth + 2
    assert len(got) == len(want) == len(order)
    for i in (0, 1, len(order) - 1):
        one, info = activations.get_activations(tq, x, bits, quant=quant,
                                                layer_indices=i)
        assert info == [{"relative_index": i, "name": order[i]}]
        assert torch.equal(one[0], got[i])
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        if quant:  # a code that differs would move what follows
            assert np.mean(g == w) >= 0.99
        else:
            np.testing.assert_allclose(g, w, atol=1e-5 * np.abs(w).max())
    norm = activations.get_activations(tq, x, bits, quant=quant,
                                       normalize_act=True)
    for n, g, w in zip(norm, got, want):
        assert torch.equal(n, activations.normalize_activations(g))
        np.testing.assert_allclose(
            n.numpy(), np.asarray(jact.normalize_activations(w)), atol=1e-6)


def _acts(rng, n_layers, n, dims):
    return [rng.standard_normal((n, d)).astype(np.float32) * (i + 1)
            for i, d in zip(range(n_layers), dims)]


def test_cka_heatmaps_match_jax():
    rng = np.random.default_rng(3)
    dims = (16, 40, 8, 24)
    batches = [(_acts(rng, 4, 8, dims), _acts(rng, 3, 8, dims[1:]))
               for _ in range(3)]
    t = lambda a: [torch.tensor(v) for v in a]  # noqa: E731
    j = lambda a: [jnp.asarray(v) for v in a]  # noqa: E731
    one, jone = cka.MinibatchCKA(4), jcka.MinibatchCKA(4)
    across = cka.MinibatchCKA(4, 3, across_models=True)
    jacross = jcka.MinibatchCKA(4, 3, across_models=True)
    adv, jadv = cka.MinibatchAdvCKA(4, 3), jcka.MinibatchAdvCKA(4, 3)
    for a1, a2 in batches:
        one.update_state(t(a1))
        jone.update_state(j(a1))
        across.update_state_across_models(t(a1), t(a2))
        jacross.update_state_across_models(j(a1), j(a2))
        a1_adv = [v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
                  for v in a1]
        a2_adv = [v * 1.01 for v in a2]
        adv.update_state(t(a1), t(a1_adv), t(a2), t(a2_adv))
        jadv.update_state(j(a1), j(a1_adv), j(a2), j(a2_adv))
    for got, want in ((one, jone), (across, jacross), (adv, jadv)):
        r = got.result().numpy()
        assert r.dtype == np.float32
        np.testing.assert_allclose(r, np.asarray(want.result()), atol=1e-5)
    np.testing.assert_allclose(np.diag(one.result().numpy()), 1.0,
                               atol=1e-6)
    same = cka.MinibatchAdvCKA(4)
    a1, _ = batches[0]
    a1_adv = [v * 0.9 for v in a1]
    same.update_state(t(a1), t(a1_adv), t(a1), t(a1_adv))
    np.testing.assert_allclose(np.diag(same.result().numpy()), 1.0,
                               atol=1e-6)


def _held(iterates, inputs, eps, lo, hi):
    """Every iterate inside the ball and [lo, hi], exactly (the bounds
    computed in float32 as the attack computes them)."""
    for x in iterates:
        assert bool((x >= inputs - eps).all() and (x <= inputs + eps).all())
        assert bool((x >= lo).all() and (x <= hi).all())


def _recording(fwd, seen):
    def run(x):
        seen.append(x.detach().clone())
        return fwd(x)
    return run


def test_pgd_matches_jax_from_the_same_start(models):
    jq, tq = models["vit"]
    x = _images(tq.spec, 2, 3)
    y = np.array([1, 2])
    eps = 0.06
    noise = np.asarray(jax.random.uniform(jax.random.PRNGKey(5), x.shape,
                                          minval=-eps, maxval=eps))
    want = np.asarray(jpgd.make_pgd(
        lambda v: jq._forward_fn(False, None)(jq.params, None, v),
        eps, 0.01, 3)(jnp.asarray(x), jnp.asarray(y),
                      jax.random.PRNGKey(5)))
    seen = []
    gen = pgd.make_pgd(_recording(tq.forward_fn(False), seen), eps, 0.01, 3)
    got = gen(torch.tensor(x), y, init_noise=noise)
    assert np.mean(got.numpy() == want) >= 0.99
    xt = torch.tensor(x)
    _held(seen[1:] + [got], xt, eps, xt.min(), xt.max())
    assert len(seen) == 3 and float((got - xt).abs().max()) > 1e-4
    # AttackPGD draws its start from a generator, the same for a seed
    atk = pgd.AttackPGD(tq, eps, 0.01, 2, quant=False)
    a = atk.gen_adv_inputs(x, y, generator=torch.Generator().manual_seed(1))
    b = atk.gen_adv_inputs(x, y, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)


def test_pseudo_label_pgd_matches_jax(models):
    jq, tq = models["vit"]
    x = np.random.default_rng(4).random((2, 3, 224, 224)).astype(np.float32)
    eps = 0.3
    noise = np.random.default_rng(5).uniform(-eps, eps, x.shape).astype(
        np.float32)
    want = np.asarray(jpgd.gen_profiling_adv_inputs(
        jq, x, num_steps=3, init_noise=noise))
    got = pgd.gen_profiling_adv_inputs(tq, x, num_steps=3, init_noise=noise)
    assert np.mean(got.numpy() == want) >= 0.99
    xt = torch.tensor(x)
    _held([got], xt, eps, 0.0, 1.0)
    seen = []
    fwd = tq.forward_fn(False)
    with torch.no_grad():
        clean = fwd(xt).double()
    target = ((clean.mean(0) - clean) * 1000.0).float()
    attack = pgd.make_pseudo_label_pgd(_recording(fwd, seen), eps, 0.01, 3)
    assert torch.equal(attack(xt, target, init_noise=noise), got)
    _held(seen[1:], xt, eps, 0.0, 1.0)


def test_quant_attack_has_zero_gradient(models):
    """The fake-quant forward rounds without the STE: its input gradient
    is exactly 0, sign(0) = 0, and the attack returns the clamped start,
    bit-equal to JAX's."""
    jq, tq = models["vit"]
    x = _images(tq.spec, 2, 6)
    y = np.array([3, 4])
    leaf = torch.tensor(x, requires_grad=True)
    tq.forward_fn(True)(leaf).sum().backward()
    assert leaf.grad is None or float(leaf.grad.abs().max()) == 0.0
    want = np.asarray(jpgd.AttackPGD(jq, num_steps=2).gen_adv_inputs(
        x, y, jax.random.PRNGKey(7)))
    noise = np.asarray(jax.random.uniform(jax.random.PRNGKey(7), x.shape,
                                          minval=-0.06, maxval=0.06))
    got = pgd.AttackPGD(tq, num_steps=2).gen_adv_inputs(x, y,
                                                        init_noise=noise)
    np.testing.assert_array_equal(got.numpy(), want)
    xt = torch.tensor(x)
    start = torch.clamp(xt + torch.tensor(noise), xt.min(), xt.max())
    assert torch.equal(got, start)


def test_swin_per_slot_bits_reach_the_attacked_forward(models):
    """tests/test_analysis.py's regression, in the port: the attacked
    forward sees a Swin's mixed per-slot bits, and the uniform tuple is
    the uniform int."""
    _, tq = models["swin"]
    x = torch.tensor(_images(tq.spec, 2, 8))
    n = swin.num_bit_slots(tq.spec)
    mixed = tuple(8 if i % 2 == 0 else 4 for i in range(n))
    with torch.no_grad():
        l_mixed = pgd._engine_forward(tq, True, mixed)(x)
        l_uni8 = pgd._engine_forward(tq, True, 8)(x)
        l_tuple = pgd._engine_forward(tq, True, [8] * n)(x)
    assert not torch.allclose(l_mixed, l_uni8)
    assert torch.equal(l_tuple, l_uni8)
    assert pgd._hashable_bits([8, 4]) == (8, 4) and pgd._hashable_bits(8) == 8


def test_seed_inputs_match_jax(models, tmp_path):
    """get_seed_inputs: a shuffled batch of the train ImageFolder, the
    images and labels JAX's loader gives for the same folder; rand=True
    Gaussian noise with zero labels."""
    import argparse

    from diffvit_tpu_torch.data.synthetic import make_fake_imagefolder

    jq, tq = models["vit"]
    make_fake_imagefolder(str(tmp_path / "train"), num_classes=3,
                          per_class=2, size=(80, 60), seed=2)
    args = argparse.Namespace(model="deit_tiny", data=str(tmp_path),
                              num_workers=2)
    got = pgd.AttackPGD(tq, num_steps=1).get_seed_inputs(4, args)
    want = jpgd.AttackPGD(jq, num_steps=1).get_seed_inputs(4, args)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    x, y = pgd.AttackPGD(tq, num_steps=1).get_seed_inputs(2, rand=True)
    assert x.shape == (2, 3, 224, 224) and x.dtype == np.float32
    assert not y.any()


@pytest.mark.parametrize("quant", [False, True], ids=["float", "quant"])
def test_ddv_matches_jax(models, quant):
    jq, tq = models["vit"]
    x = _images(tq.spec, 3, 9)
    adv = x + 0.05
    want = jddv.compute_ddv(jq, jnp.asarray(x), jnp.asarray(adv), quant=quant)
    got = ddv.compute_ddv(tq, x, adv, quant=quant)
    assert list(got) == list(want) == ddv.ddv_tap_names(tq.spec)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5)
    sims = ddv.ddv_similarities(got, got, log=lambda *_: None)
    assert all(abs(v - 100.0) < 1e-3 for v in sims.values())
    other = jddv.ddv_similarities(want, got, log=lambda *_: None)
    assert all(abs(v - 100.0) < 1e-3 for v in other.values())


def test_drivers_write_the_reference_pickles(models, tmp_path):
    jq, tq = models["vit"]
    rng = np.random.default_rng(10)
    batches = [(rng.standard_normal((4, 3, 224, 224)).astype(np.float32),
                rng.integers(0, 10, 4)) for _ in range(2)]
    out = str(tmp_path / "internal")
    got = cka_drivers.compute_cka_internal(
        tq, lambda: iter(batches), cka_iter=1, cka_batch_iter=1,
        result_name=out, log=lambda *_: None)
    want = jdrv.compute_cka_internal(
        jq, lambda: iter(batches), cka_iter=1, cka_batch_iter=1,
        result_name=str(tmp_path / "jax_internal"), log=lambda *_: None)
    np.testing.assert_allclose(got, want, atol=1e-5)
    with open(os.path.join(out, "_heatmap.pkl"), "rb") as f:
        np.testing.assert_array_equal(pickle.load(f), got)
    n = len(got)
    assert got.shape == (n, n) == (6 * tq.spec.depth + 2,) * 2

    adv_out = str(tmp_path / "adv_run")
    bits = (4,) * vit.num_bit_slots(tq.spec)
    heat = cka_drivers.compute_cka_with_adversarial(
        tq, tq, lambda: iter(batches[:1]), model1_bit_config=bits,
        model2_bit_config=bits, cka_iter=1, cka_batch_iter=0, pgd_steps=1,
        result_name=adv_out, log=lambda *_: None)
    with open(os.path.join(adv_out, "adv_run_heatmap.pkl"), "rb") as f:
        np.testing.assert_array_equal(pickle.load(f), heat)
    m = 4 * tq.spec.depth + 2
    assert heat.shape == (m, m)
    # the head's unbiased HSIC on 4 images is negative: its row is NaN,
    # as it is in JAX's internal heatmap above
    diag = np.diag(heat)
    assert np.isfinite(heat[:-1, :-1]).all() and np.isnan(diag[-1])
    np.testing.assert_allclose(diag[:-1], 1.0, atol=1e-6)


def test_adversarial_driver_matches_jax(models, tmp_path, monkeypatch):
    """compute_cka_with_adversarial against JAX's driver: a float model1
    (uncalibrated, so PGD moves the inputs) against the fake-quant model2,
    two batches, two PGD steps, each batch's start JAX's own
    (``jax.random.split`` of the key once a batch, as JAX's driver draws
    it, injected through ``pgd._uniform_start``).  One of the 602,112
    adversarial elements of the first batch takes the other sign (its
    gradient is at the noise level) and moves the float activations of
    that batch by up to 2.2e-4 of their largest and 0.13% of the
    fake-quant codes: the heatmaps are within 1e-4 (measured 2.6e-5), and
    >= 95% of their entries within 1e-5 (measured 134 of 140)."""
    jq, tq = models["vit"]
    t1 = engine.QuantizedViT(tq.spec, QuantConfig(), device="cpu",
                             params=jax.device_get(jq.params))
    j1 = JaxQuantizedViT(jq.spec, JaxQuantConfig(), params=jq.params)
    key, starts = [jax.random.PRNGKey(0)], []

    def jax_start(inputs, epsilon, generator):
        key[0], sub = jax.random.split(key[0])
        starts.append(jax.random.uniform(sub, tuple(inputs.shape),
                                         minval=-epsilon, maxval=epsilon))
        return torch.tensor(np.asarray(starts[-1]))

    monkeypatch.setattr(pgd, "_uniform_start", jax_start)
    rng = np.random.default_rng(11)
    batches = [(rng.standard_normal((4, 3, 224, 224)).astype(np.float32),
                rng.integers(0, 10, 4)) for _ in range(2)]
    bits = (4,) * vit.num_bit_slots(tq.spec)
    kw = dict(model2_bit_config=bits, cka_iter=1, cka_batch_iter=1,
              pgd_steps=2, log=lambda *_: None)
    got = cka_drivers.compute_cka_with_adversarial(
        t1, tq, lambda: iter(batches), result_name=str(tmp_path / "t"), **kw)
    want = jdrv.compute_cka_with_adversarial(
        j1, jq, lambda: iter(batches), result_name=str(tmp_path / "j"), **kw)
    assert len(starts) == len(batches)
    assert got.shape == want.shape == (6 * tq.spec.depth + 2,
                                       4 * tq.spec.depth + 2)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = np.isnan(want) | (np.abs(got - want) <= 1e-5)
    assert np.mean(ok) >= 0.95

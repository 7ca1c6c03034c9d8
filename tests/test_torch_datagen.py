"""The port's PSAQ data generation (``diffvit_tpu_torch/analysis/
datagen.py``) and its eager Adam against the JAX package's, on the CPU, at
the TINY ViT (64 wide, 2 blocks, 224 px) and the TINY Swin (32 wide,
depths (2, 1), 56 px; block 1 shifts), JAX's params carried across by
``params_from_numpy``:

* ``calib.optim.Adam(..., eager=True)`` bit for bit against
  ``optax.adam`` run eagerly (``opt.update`` and ``optax.apply_updates``
  outside any jit, as ``generate_data`` runs them), with datagen's b1, b2
  and cosine schedule and with optax's defaults;
* ``_cosine_lr``: of the 500 float32 rates of an epoch, all but one equal
  JAX's, and that one (iteration 363) is two ulps off (XLA's float32
  ``cos`` on the CPU is an ulp off the correctly rounded value at two
  arguments; one of them survives the rounding of the rate);
* the clip (``_clip_bounds``) bit for bit against ``_clip_imagenet``;
  ``_ctx_hooks``' names and heads;
* ``attention_entropy`` (ViT and Swin contexts), ``total_variation``,
  ``gaussian_kde`` and ``differential_entropy``: values within rtol 1e-5
  of JAX's float32 ones (measured <= 3.4e-7), gradients within 1e-6 of
  the largest of JAX's float64 ones (``jax.enable_x64``; measured <=
  1.7e-7): the port takes them in float64, and JAX's float32 gradient of
  the entropy is noise where the maximum of ``x_plot`` ties (the diagonal
  cosines, all about 1);
* the whole loss (``psaq_loss``) at the first step: its value within rtol 1e-5 of JAX's
  float32 one (measured 3.5e-6 ViT, 5.5e-7 Swin) and the input gradient
  against JAX's float64 one, the largest difference over the largest
  value <= 2e-6 ViT and 5e-5 Swin (measured 2.5e-7 and 4.0e-6);
* ``generate_data`` on JAX's own draws (injected): Adam's first step is
  ``lr * sign(g)`` up to an ulp of the ratio, so the images after one
  step are bit-equal in >= 80% of the pixels (measured 83.9% ViT, 88.8%
  Swin) and a sign flipped (|diff| > 1e-3) in <= 0.1% (measured 0.024%
  and 0); a flipped pixel changes its neighbours' gradients, so after two
  epochs of two steps (the jitter range and Adam restarting) <= 7% of the
  pixels are more than 1e-3 apart (measured 1.4% ViT, 4.8% Swin) and the
  median difference is <= 2e-5 (measured 1.2e-5 and 1.1e-5);
* the draws from a seed, ``prior_params`` taking the place of ``params``,
  and the clip bounds held at every step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffvit_tpu.analysis import datagen as jdg
from diffvit_tpu.models import swin as jswin
from diffvit_tpu.models import vit as jvit

from diffvit_tpu_torch.analysis import datagen
from diffvit_tpu_torch.calib.optim import Adam
from diffvit_tpu_torch.models import swin, vit

from test_torch_calibrate import one_torch_thread  # noqa: F401

VIT_KW = dict(embed_dim=64, depth=2, num_heads=2, num_classes=10)
SWIN_KW = dict(embed_dim=32, depths=(2, 1), num_heads=(2, 4), img_size=56,
               num_classes=10)
MODELS = {
    "vit": (jvit.ViTSpec("test_tiny", **VIT_KW),
            vit.ViTSpec("test_tiny", **VIT_KW), jvit.init_params,
            jvit.forward_fp),
    "swin": (jswin.SwinSpec("swin_test", **SWIN_KW),
             swin.SwinSpec("swin_test", **SWIN_KW), jswin.init_swin_params,
             jswin.forward_fp),
}
B = 2


@pytest.fixture(scope="module")
def models():
    """{family: (JAX spec, port spec, JAX params, port params)}."""
    out = {}
    for name, (js, ts, init, _) in MODELS.items():
        pj = init(js, jax.random.PRNGKey(0))
        out[name] = (js, ts, pj,
                     vit.params_from_numpy(jax.device_get(pj), "cpu"))
    return out


def _jax_draws(spec, seed=0):
    """generate_data's draws as JAX makes them (datagen.py:124-132)."""
    key = jax.random.PRNGKey(seed)
    k_img, k_label, k_var, _ = jax.random.split(key, 4)
    img = jax.random.normal(k_img, (B, 3, spec.img_size, spec.img_size))
    pred = jax.random.randint(k_label, (B,), 0, spec.num_classes)
    var = float(jax.random.uniform(k_var, (), minval=2500.0, maxval=3000.0))
    return np.asarray(img), np.asarray(pred), var


@pytest.mark.parametrize("kw", [dict(b1=0.5, b2=0.9, base=0.25),
                                dict(b1=0.9, b2=0.999, base=1e-3)],
                         ids=["datagen", "defaults"])
def test_adam_eager_is_optax_eager_bit_for_bit(kw):
    rng = np.random.default_rng(6)
    p0 = rng.standard_normal(20000).astype(np.float32)
    steps = 40
    grads = [(rng.standard_normal(20000) * 10.0 ** rng.integers(-6, 2))
             .astype(np.float32) for _ in range(steps)]
    sched = jdg._cosine_lr(kw["base"], 100, steps)
    opt = optax.adam(lambda it: sched(it), b1=kw["b1"], b2=kw["b2"],
                     eps=1e-8)
    p, st = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = torch.tensor(p0)
    adam = Adam(tp, lambda i: np.asarray(sched(jnp.int32(i))), steps,
                b1=kw["b1"], b2=kw["b2"], eager=True)
    for g in grads:
        u, st = opt.update(jnp.asarray(g), st)
        p = optax.apply_updates(p, u)
        adam.step(torch.tensor(g))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(p))


@pytest.mark.parametrize("base", [0.20, 0.25])
def test_cosine_lr_matches_jax_but_one_rate(base):
    want = np.array([np.asarray(jdg._cosine_lr(base, 100, 500)(
        jnp.int32(t))) for t in range(500)])
    lr = datagen._cosine_lr(base, 100, 500)
    got = np.array([lr(t) for t in range(500)])
    assert got.dtype == want.dtype == np.float32
    differ = np.nonzero(got != want)[0]
    assert len(differ) == 1, differ
    # and there by two ulps (iteration 363: 0.0348166 against 0.0348166
    # at base 0.20)
    assert np.abs(got.view(np.int32) - want.view(np.int32)).max() == 2


def test_clip_and_hooks_match_jax():
    x = np.random.default_rng(0).standard_normal(
        (2, 3, 8, 8)).astype(np.float32) * 3
    np.testing.assert_array_equal(
        torch.clamp(torch.tensor(x), *datagen._clip_bounds("cpu")).numpy(),
        np.asarray(jdg._clip_imagenet(jnp.asarray(x))))
    for js, ts, *_ in MODELS.values():
        assert datagen._ctx_hooks(ts) == jdg._ctx_hooks(js)


def _jax_value_and_grads(fn, args):
    """fn(*args) and its gradient with respect to each arg, from JAX in
    float32 and (``jax.enable_x64``) in float64."""
    out = {}
    for dt in (np.float32, np.float64):
        with jax.enable_x64(dt == np.float64):
            a = [jnp.asarray(np.asarray(x, dt)) for x in args]
            v, g = jax.jit(jax.value_and_grad(
                fn, argnums=tuple(range(len(a)))))(*a)
            out[dt] = (float(v), [np.asarray(t, np.float64) for t in g])
    return out


def _assert_value_and_grads(want, got, grads, rtol_value=1e-5,
                            rtol_grad=1e-6):
    np.testing.assert_allclose(float(got), want[np.float32][0],
                               rtol=rtol_value)
    for g, w in zip(grads, want[np.float64][1]):
        g = g.numpy().astype(np.float64)
        assert np.abs(g - w).max() <= rtol_grad * np.abs(w).max(), \
            np.abs(g - w).max() / np.abs(w).max()


PIECES = {
    # name: (JAX fn, port fn, argument shapes)
    "entropy_vit": (lambda c: jdg.attention_entropy(c, 2, B),
                    lambda c: datagen.attention_entropy(c, 2, B),
                    [(B, 197, 64)]),
    "entropy_swin": (lambda c: jdg.attention_entropy(c, 2, B),
                     lambda c: datagen.attention_entropy(c, 2, B),
                     [(B * 16, 49, 32)]),
    "total_variation": (jdg.total_variation, datagen.total_variation,
                        [(B, 3, 20, 24)]),
    "gaussian_kde": (lambda t, x: jdg.gaussian_kde(t, x).sum(),
                     lambda t, x: datagen.gaussian_kde(t, x).sum(),
                     [(B, 300), (B, 10)]),
    "differential_entropy": (
        lambda p, x: jdg.differential_entropy(p, jnp.sort(x, -1)),
        lambda p, x: datagen.differential_entropy(p, torch.sort(x, -1)[0]),
        [(B, 10), (B, 10)]),
}


@pytest.mark.parametrize("piece", list(PIECES))
def test_loss_pieces_match_jax(piece):
    jfn, tfn, shapes = PIECES[piece]
    rng = np.random.default_rng(len(piece))
    args = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if piece == "gaussian_kde":
        args = [a * 0.02 for a in args]
    if piece == "differential_entropy":
        args[0] = np.abs(args[0]) * 5
    want = _jax_value_and_grads(jfn, args)
    t = [torch.tensor(a, requires_grad=True) for a in args]
    v = tfn(*t)
    v.backward()
    _assert_value_and_grads(want, v.detach(), [a.grad for a in t])


def _jax_loss(name, pj, pred, var_pred):
    js, _, _, jfwd = MODELS[name]
    hooks = jdg._ctx_hooks(js)

    def loss_fn(img):  # datagen.py:139-158 at offset 0, no flip
        taps = []
        logits = jfwd(pj, js, img, taps=taps)
        tapd = dict(taps)
        logp = jax.nn.log_softmax(logits)
        loss_oh = -jnp.mean(jnp.take_along_axis(logp, pred[:, None], 1))
        loss_tv = jnp.abs(jdg.total_variation(img) - var_pred)
        ent = sum(jdg.attention_entropy(tapd[n], nh, B) for n, nh in hooks)
        return ent + loss_oh + 0.05 * loss_tv

    return loss_fn


@pytest.mark.parametrize("name,grad_rtol", [("vit", 2e-6), ("swin", 5e-5)])
def test_loss_and_input_gradient_match_jax(models, name, grad_rtol):
    js, ts, pj, pt = models[name]
    img, pred, var = _jax_draws(js)
    want = {}
    for dt in (np.float32, np.float64):
        with jax.enable_x64(dt == np.float64):
            p = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, dt)),
                             jax.device_get(pj))
            v, g = jax.jit(jax.value_and_grad(_jax_loss(
                name, p, jnp.asarray(pred), var)))(jnp.asarray(img, dt))
            want[dt] = (float(v), [np.asarray(g, np.float64)])
    x = torch.tensor(img, requires_grad=True)
    loss = datagen.psaq_loss(pt, ts, x, torch.tensor(pred, dtype=torch.int64),
                             var, B)
    loss.backward()
    _assert_value_and_grads(want, loss.detach(), [x.grad],
                            rtol_grad=grad_rtol)


# (iters_per_epoch, epochs): min share of bit-equal pixels, max share
# more than 1e-3 apart, max median |diff|
FOLLOW = {(1, 1): (0.80, 1e-3, 0.0), (2, 2): (0.0, 0.07, 2e-5)}


@pytest.mark.parametrize("name", ["vit", "swin"])
@pytest.mark.parametrize("steps", list(FOLLOW), ids=["1x1", "2x2"])
def test_generate_data_follows_jax(models, name, steps):
    js, ts, pj, pt = models[name]
    iters, epochs = steps
    want = np.asarray(jdg.generate_data(pj, js, batch_size=B, seed=0,
                                        iters_per_epoch=iters,
                                        epochs=epochs))
    got = datagen.generate_data(pt, ts, batch_size=B, seed=0,
                                iters_per_epoch=iters, epochs=epochs,
                                draws=_jax_draws(js)).numpy()
    assert got.shape == want.shape == (B, 3, ts.img_size, ts.img_size)
    d = np.abs(got - want)
    equal, apart, median = FOLLOW[steps]
    assert np.mean(d == 0) >= equal
    assert np.mean(d > 1e-3) <= apart
    assert np.median(d) <= median


def test_draws_prior_and_clip(models):
    js, ts, pj, pt = models["vit"]
    img, pred, var = datagen._draws(ts, 3, seed=4)
    img2, pred2, var2 = datagen._draws(ts, 3, seed=4)
    assert torch.equal(img, img2) and torch.equal(pred, pred2) and var == var2
    assert img.shape == (3, 3, 224, 224) and 2500 <= var <= 3000
    assert int(pred.min()) >= 0 and int(pred.max()) < ts.num_classes
    other = vit.init_params(ts, torch.Generator().manual_seed(9), "cpu")
    kw = dict(batch_size=B, seed=1, iters_per_epoch=1, epochs=1)
    with_prior = datagen.generate_data(pt, ts, prior_params=other, **kw)
    assert torch.equal(with_prior, datagen.generate_data(other, ts, **kw))
    lo, hi = datagen._clip_bounds("cpu")
    assert bool(((with_prior >= lo) & (with_prior <= hi)).all())
    assert not torch.equal(with_prior, datagen.generate_data(pt, ts, **kw))

"""The port's Hessian spectrum (``analysis.hessian.top_eigenvalues``,
``eigenvalue_density`` and their helpers ``power_iteration``, ``lanczos``)
against the JAX package's, on the CPU, at the TINY ViT (64 wide, 2
blocks) with JAX's params carried across and seeded numpy batches.

The port draws its start vectors from a ``torch.Generator``; the tests
hand it JAX's own (its ``split`` per eigenvalue or Lanczos vector, then
one key a weight, ``jax.random.normal`` / ``rademacher``) through the
``starts`` and ``probes`` hooks.  The port takes the dot products in
float64 and its vector updates in float64 rounded once; JAX in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffvit_tpu.analysis import hessian as jh
from diffvit_tpu.models import vit as jvit

from diffvit_tpu_torch.analysis import hessian
from diffvit_tpu_torch.models import vit

from test_torch_calibrate import one_torch_thread  # noqa: F401

VIT_KW = dict(embed_dim=64, depth=2, num_heads=2, num_classes=10)
JSPEC, SPEC = jvit.ViTSpec("t", **VIT_KW), vit.ViTSpec("t", **VIT_KW)
NAMES = {"one": ["blocks.1.mlp.fc1.weight"],
         "two": ["blocks.0.attn.qkv.weight", "head.weight"]}


@pytest.fixture(scope="module")
def model():
    """(JAX params, port params, inputs, targets): a batch of 4."""
    pj = jvit.init_params(JSPEC, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 3, 224, 224)).astype(np.float32)
    y = rng.integers(0, 10, 4)
    return pj, vit.params_from_numpy(jax.device_get(pj), "cpu"), x, y


def _jax_draws(key, pj, names, n, draw):
    """JAX's start vectors: for each of ``n``, ``key, sub = split(key)``,
    one key a weight from ``split(sub, len(names))``."""
    table = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        ks = jax.random.split(sub, len(names))
        table.append({nm: np.asarray(draw(k, jh._get_leaf(pj, nm).shape))
                      for nm, k in zip(names, ks)})
    return lambda i, name, like: torch.tensor(table[i][name])


def _counting(monkeypatch):
    """Counts of the HVPs each package takes."""
    counts = {"jax": 0, "port": 0}
    multi = jh._multi_leaf_fns

    def jax_fns(*args):
        ws0, hvp = multi(*args)

        def counted(ws, vs):
            counts["jax"] += 1
            return hvp(ws, vs)
        return ws0, counted

    joint = hessian.BatchGrads.joint_hvp

    def port_hvp(self, vs):
        counts["port"] += 1
        return joint(self, vs)

    monkeypatch.setattr(jh, "_multi_leaf_fns", jax_fns)
    monkeypatch.setattr(hessian.BatchGrads, "joint_hvp", port_hvp)
    return counts


@pytest.mark.parametrize("which,top_n", [("one", 1), ("two", 2)])
def test_top_eigenvalues_match_jax(model, monkeypatch, which, top_n):
    """From JAX's start vectors at max_iter 5 (tol 1e-3): the eigenvalues
    within rtol 1e-4, the same number of HVPs, every eigenvector at cosine
    >= 0.9999 to JAX's.  Measured: eigenvalues within 2.5e-7 relative
    (the one-weight case's top eigenvalue is negative, -4.03: power
    iteration finds the largest in magnitude), cosines within 3.4e-14
    of 1."""
    pj, pt, x, y = model
    names, key = NAMES[which], jax.random.PRNGKey(11)
    counts = _counting(monkeypatch)
    want, want_v = jh.top_eigenvalues(pj, JSPEC, x, y, key, top_n=top_n,
                                      max_iter=5, names=names)
    got, got_v = hessian.top_eigenvalues(
        pt, SPEC, x, y, top_n=top_n, max_iter=5, names=names,
        starts=_jax_draws(key, pj, names, top_n, jax.random.normal))
    assert counts["port"] == counts["jax"] and counts["jax"] >= top_n * 2
    assert isinstance(got, list) and all(isinstance(e, float) for e in got)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for gv, wv in zip(got_v, want_v):
        assert list(gv) == names
        a = np.concatenate([gv[n].numpy().ravel() for n in names])
        b = np.concatenate([np.asarray(wv[n]).ravel() for n in names])
        cos = a.astype(np.float64) @ b / np.linalg.norm(a) / np.linalg.norm(b)
        assert cos >= 0.9999, cos


def _capture_tridiagonal(monkeypatch):
    """The Lanczos tridiagonals JAX hands ``np.linalg.eigh``."""
    seen = []
    eigh = np.linalg.eigh

    def capture(t):
        seen.append(np.array(t))
        return eigh(t)

    monkeypatch.setattr(np.linalg, "eigh", capture)
    return seen


def test_eigenvalue_density_matches_jax(model, monkeypatch):
    """From JAX's Rademacher start vectors at iters 5, over two weights:
    the alphas and betas within 1e-4 relative, the Ritz values within
    1e-4 of the largest, the weights summing to 1 within 1e-6.  Measured:
    alphas within 2.4e-6 relative, betas 1.6e-7, Ritz values 1.2e-7 of
    the largest, weights summing to 1 within 1.1e-16 and 7.0e-8 from
    JAX's."""
    pj, pt, x, y = model
    names, key = NAMES["two"], jax.random.PRNGKey(12)
    seen = _capture_tridiagonal(monkeypatch)
    want_e, want_w = jh.eigenvalue_density(pj, JSPEC, x, y, key, iters=5,
                                           names=names)
    monkeypatch.undo()
    (t,) = seen
    got_ab = []
    ritz = hessian.tridiagonal_ritz

    def capture_ab(alphas, betas):
        got_ab.append((alphas, betas))
        return ritz(alphas, betas)

    monkeypatch.setattr(hessian, "tridiagonal_ritz", capture_ab)
    got_e, got_w = hessian.eigenvalue_density(
        pt, SPEC, x, y, iters=5, names=names,
        probes=_jax_draws(key, pj, names, 1, lambda k, s: jnp.sign(
            jax.random.rademacher(k, s, dtype=jnp.float32))))
    (alphas, betas), = got_ab
    assert len(alphas) == 5 and len(betas) == 4
    np.testing.assert_allclose(alphas, np.diag(t), rtol=1e-4)
    np.testing.assert_allclose(betas, np.diag(t, 1), rtol=1e-4)
    top = np.abs(want_e[0]).max()
    assert np.abs(np.subtract(got_e[0], want_e[0])).max() <= 1e-4 * top
    assert abs(sum(got_w[0]) - 1) <= 1e-6
    np.testing.assert_allclose(got_w[0], want_w[0], atol=1e-4)


def _known_spd(dtype=torch.float64):
    """A 24 x 24 symmetric positive-definite matrix with eigenvalues
    0.01 .. 0.25 (evenly spaced), its hvp over a one-leaf dict, and
    eigh's eigenvalues."""
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.standard_normal((24, 24)))
    a = q @ np.diag(np.linspace(0.01, 0.25, 24)) @ q.T
    a = (a + a.T) / 2
    at = torch.tensor(a, dtype=dtype)
    return a, (lambda v: {"x": at @ v["x"]}), np.linalg.eigvalsh(a)


def _normalize_np(v):
    return v / (np.sqrt(v @ v) + 1e-6)


def _lanczos_np(a, v0, iters):
    """JAX's loop (``hessian.py:320-341``) in float64 numpy."""
    vs, alphas, betas, w_prev = [_normalize_np(v0)], [], [], None
    for i in range(iters):
        hv = a @ vs[-1]
        alphas.append(hv @ vs[-1])
        w = hv - alphas[-1] * vs[-1]
        if w_prev is not None:
            w = w - betas[-1] * w_prev
        beta = np.sqrt(w @ w)
        if beta < 1e-8 or i == iters - 1:
            break
        betas.append(beta)
        w_prev = vs[-1]
        vs.append(w / beta)
    return alphas, betas


def test_helpers_on_a_known_matrix():
    """Lanczos at iters 24 and power iteration (top 2, tol 1e-14) on a
    known SPD matrix, in float64.  Against JAX's loops transcribed into
    float64 numpy: the alphas and betas within 1e-8 relative (measured
    1.3e-10: without reorthogonalization the last steps amplify the
    roundings, and the port forms each Lanczos vector in one rounding).  Against
    eigh: the Lanczos extremes within 1e-7 and the power eigenvalues
    within 1e-6.  JAX's ``_normalize`` divides by ``|v| + 1e-6``: the
    start vector's norm is 1 - 1e-6 and each power step's 1/(1 + 1e-6),
    which biases each Rayleigh quotient by 2e-6 of the eigenvalue (the
    spectrum's scale, 0.25 at most, keeps that under 1e-6) and the Lanczos
    extremes by up to 3e-8 here.  Measured: Lanczos 2.9e-8 and 6.8e-9 off
    eigh's, power iteration 5.0e-7 and 4.8e-7 below (with the quirk's
    1e-6 set to 0 all are within 3e-14)."""
    a, hvp, ev = _known_spd()
    v0 = np.sign(np.random.default_rng(8).standard_normal(24))
    alphas, betas = hessian.lanczos(hvp, {"x": torch.tensor(v0)}, 24)
    want_a, want_b = _lanczos_np(a, v0, 24)
    assert len(alphas) == 24 and len(betas) == 23
    np.testing.assert_allclose(alphas, want_a, rtol=1e-8)
    np.testing.assert_allclose(betas, want_b, rtol=1e-8)
    ritz, weights = hessian.tridiagonal_ritz(alphas, betas)
    assert abs(ritz[0] - ev[0]) <= 1e-7 and abs(ritz[-1] - ev[-1]) <= 1e-7
    assert abs(sum(weights) - 1) <= 1e-12

    starts = [np.random.default_rng(i).standard_normal(24) for i in (0, 1)]
    eigs, vecs, steps = hessian.power_iteration(
        hvp, lambda i: {"x": torch.tensor(starts[i])}, top_n=2,
        max_iter=2000, tol=1e-14)
    assert steps[0] < 2000 and steps[1] < 2000
    assert abs(eigs[0] - ev[-1]) <= 1e-6 and abs(eigs[1] - ev[-2]) <= 1e-6
    top, v = np.linalg.eigh(a)[1][:, -1], vecs[0]["x"].numpy()
    assert abs(v @ top) / np.linalg.norm(v) >= 1 - 1e-9  # 1 - 1.2e-12
    assert vecs[0]["x"].dtype == torch.float64


def test_default_draws_are_seeded(model):
    """Without hooks the starts come from the generator: the same seed,
    the same values."""
    _, pt, x, y = model
    names = NAMES["one"]
    run = lambda s: hessian.top_eigenvalues(  # noqa: E731
        pt, SPEC, x, y, torch.Generator().manual_seed(s), max_iter=2,
        names=names)[0]
    assert run(3) == run(3) != run(4)
    dens = lambda s: hessian.eigenvalue_density(  # noqa: E731
        pt, SPEC, x, y, torch.Generator().manual_seed(s), iters=3,
        names=names)
    assert dens(3) == dens(3)
    assert hessian.top_eigenvalues(pt, SPEC, x, y, max_iter=2,
                                   names=names)[0] == run(0)

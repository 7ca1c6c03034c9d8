"""The port's ModelDiff input search (``analysis.modeldiff``) against the
JAX package's, on the CPU: the diversity metric against scipy's
``cdist``, the blackbox hill climb on a fixed numpy linear forward and on
the TINY ViT's float forward (64 wide, 2 blocks; JAX's params carried
across, the second model's scaled by 1 + 0.02 N(0, 1)), and the whitebox
search on a deterministic candidate generator.  Both packages draw the
mutations from ``np.random.default_rng(seed)`` in the same order.
"""
import jax
import numpy as np
import pytest
import torch

from diffvit_tpu.analysis import modeldiff as jmd
from diffvit_tpu.models import vit as jvit

from diffvit_tpu_torch.analysis import modeldiff
from diffvit_tpu_torch.models import vit

from test_torch_calibrate import one_torch_thread  # noqa: F401

VIT_KW = dict(embed_dim=64, depth=2, num_heads=2, num_classes=10)
JSPEC, SPEC = jvit.ViTSpec("t", **VIT_KW), vit.ViTSpec("t", **VIT_KW)


def test_output_diversity_matches_scipy():
    """float32 outputs (numpy and a tensor) and float64 ones: within
    1e-12 relative of scipy's value.  Measured: 7.8e-16 at most."""
    rng = np.random.default_rng(0)
    for out in (rng.standard_normal((8, 1000)).astype(np.float32),
                rng.standard_normal((5, 10)) * 30):
        want = jmd.metrics_output_diversity(out)
        for got in (modeldiff.metrics_output_diversity(out),
                    modeldiff.metrics_output_diversity(torch.tensor(out))):
            assert isinstance(got, float)
            assert abs(got / want - 1) <= 1e-12
        a, b = out, rng.standard_normal(out.shape)
        assert abs(modeldiff._score(a, a * 1.5, b, b * 2)
                   / jmd._score(a, a * 1.5, b, b * 2) - 1) <= 1e-12


def _logs():
    lines = []
    return lines, lines.append


def test_blackbox_on_a_linear_forward_is_bit_equal():
    """One fixed numpy float32 linear map as the forward of both packages
    (the port hands it a CPU tensor; it returns numpy): the same accepted
    mutations and the final inputs bit for bit, over 60 iterations."""
    rng = np.random.default_rng(1)
    w1 = rng.standard_normal((48, 7)).astype(np.float32)
    w2 = (w1 + 0.3 * rng.standard_normal(w1.shape)).astype(np.float32)
    seeds = rng.standard_normal((4, 3, 4, 4)).astype(np.float32)

    def np_fwd(w):
        return lambda x: np.asarray(x, np.float32).reshape(len(x), -1) @ w

    want_log, wlog = _logs()
    want = jmd.gen_profiling_inputs_blackbox(
        np_fwd(w1), np_fwd(w2), seeds, max_iterations=60, seed=3, log=wlog)
    got_log, glog = _logs()
    got = modeldiff.gen_profiling_inputs_blackbox(
        np_fwd(w1), np_fwd(w2), seeds, max_iterations=60, seed=3, log=glog)
    assert got_log == want_log and len(want_log) > 5
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, seeds)


def test_blackbox_on_the_tiny_float_forward_matches_jax():
    """The TINY float forward of each package (JAX jitted, float32; the
    port's products in float64 rounded once), 10 iterations on 2 images:
    the same accepted mutations, and the final inputs equal.  Measured:
    all 10 iterations accept a mutation in both, and the inputs are
    equal."""
    pj = jax.device_get(jvit.init_params(JSPEC, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    pj2 = jax.tree.map(lambda a: (a * (1 + 0.02 * rng.standard_normal(
        a.shape))).astype(np.float32), pj)
    seeds = rng.standard_normal((2, 3, 224, 224)).astype(np.float32)
    jf = [jax.jit(lambda x, p=p: jvit.forward_fp(p, JSPEC, x))
          for p in (pj, pj2)]
    pt = [vit.params_from_numpy(p, "cpu") for p in (pj, pj2)]

    def port_fwd(p):
        def fwd(x):
            with torch.no_grad():
                return vit.forward_fp(p, SPEC, x)
        return fwd

    want_log, wlog = _logs()
    want = jmd.gen_profiling_inputs_blackbox(
        lambda x: np.asarray(jf[0](x)), lambda x: np.asarray(jf[1](x)),
        seeds, max_iterations=10, seed=4, log=wlog)
    got_log, glog = _logs()
    got = modeldiff.gen_profiling_inputs_blackbox(
        port_fwd(pt[0]), port_fwd(pt[1]), seeds, max_iterations=10, seed=4,
        log=glog)
    assert [ln.split(":")[0] for ln in got_log] == \
        [ln.split(":")[0] for ln in want_log]
    assert len(want_log) >= 3
    np.testing.assert_array_equal(got.numpy(), want)


def test_whitebox_keeps_the_best_or_none():
    """A deterministic candidate generator (a scaled copy a call, the
    scale from a list): the same best batch as JAX's, and None when no
    candidate beats the seed inputs."""
    rng = np.random.default_rng(5)
    w1 = rng.standard_normal((12, 6)).astype(np.float32)
    w2 = rng.standard_normal((12, 6)).astype(np.float32)
    seeds = rng.standard_normal((3, 12)).astype(np.float32)

    def gen(scales, as_tensor):
        it = iter(scales)

        def adv(x, labels):
            assert list(labels) == [0, 1, 2]
            return x * next(it)
        return adv

    fwd_np = [lambda x, w=w: np.asarray(x) @ w for w in (w1, w2)]
    fwd_t = [lambda x, w=w: x @ torch.tensor(w) for w in (w1, w2)]
    scales = [1.5, 0.5, 3.0, 2.0]
    want = jmd.gen_profiling_inputs_whitebox(
        *fwd_np, gen(scales, False), seeds, [0, 1, 2], max_iterations=4)
    got = modeldiff.gen_profiling_inputs_whitebox(
        *fwd_t, gen(scales, True), seeds, [0, 1, 2], max_iterations=4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, seeds * 3.0)
    # no candidate moves away from the seed outputs: every score is 0
    none = [jmd.gen_profiling_inputs_whitebox(
        *fwd_np, gen([1.0] * 3, False), seeds, [0, 1, 2], max_iterations=3),
        modeldiff.gen_profiling_inputs_whitebox(
        *fwd_t, gen([1.0] * 3, True), seeds, [0, 1, 2], max_iterations=3)]
    assert none == [None, None]


@pytest.mark.parametrize("device", ["cpu"])
def test_inputs_stay_on_the_forwards_device(device):
    """Numpy seeds go to ``device``; tensors stay where they are."""
    seen = []

    def fwd(x):
        seen.append(x.device.type)
        return x.reshape(len(x), -1)[:, :3] * 2

    out = modeldiff.gen_profiling_inputs_blackbox(
        fwd, fwd, np.ones((2, 2, 2), np.float32), max_iterations=2,
        device=device)
    assert out.device.type == device and set(seen) == {device}

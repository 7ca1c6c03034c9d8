"""The port's integer forward vs the JAX integer forward, on the CPU.

JAX calibrates the TINY spec of tests/test_int_path.py and bakes it with
``prepare_int``; ``int_model_from_numpy`` carries the baked model over.
JAX runs its codes path with the Pallas kernels in interpret mode; the port
runs its plain kernel versions.  The rule is the JAX suite's own between
two integer paths (tests/test_pallas_attention.py::_assert_paths_agree):
more than 99.5% of logits exactly equal, atol 0.05, equal argmax."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffvit_tpu.config import QuantConfig
from diffvit_tpu.data.imagenet import input_code_lut
from diffvit_tpu.models import vit, vit_int as jax_vit_int

from diffvit_tpu_torch.models import vit_int
from diffvit_tpu_torch.models.convert import int_model_from_numpy
from diffvit_tpu_torch.models.vit import ViTSpec
from diffvit_tpu_torch.testing import random_int_model

TINY = vit.ViTSpec("test_tiny", embed_dim=64, depth=2, num_heads=2,
                   num_classes=10)
TINY_T = ViTSpec("test_tiny", embed_dim=64, depth=2, num_heads=2,
                 num_classes=10)
CFG = QuantConfig()


def _assert_paths_agree(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.mean(got == ref) > 0.995, np.mean(got == ref)
    np.testing.assert_allclose(got, ref, atol=0.05)
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 224, 224)).astype(np.float32)
    pixels = rng.integers(0, 256, (2, 3, 224, 224), dtype=np.uint8)
    return x, pixels


def _codes(ip, pixels):
    lut = input_code_lut(np.asarray(ip["qact_input"]["scale"]),
                         np.asarray(ip["qact_input"]["zp"]))
    return np.stack([lut[c][pixels[:, c]] for c in range(3)], 1)


def _both(ip_np, x):
    want = jax_vit_int.forward_q_int(ip_np, TINY, CFG, jnp.asarray(x),
                                     use_pallas=True, pallas_interpret=True)
    ip = int_model_from_numpy(ip_np, TINY_T, "cpu")
    got = vit_int.forward_q_int(ip, TINY_T, CFG, torch.tensor(x))
    return got.numpy(), np.asarray(want)


@pytest.fixture(scope="module")
def calibrated(inputs):
    params = vit.init_params(TINY, jax.random.PRNGKey(0))
    qp, _ = vit.calibrate(params, TINY, CFG, jnp.asarray(inputs[0]))
    return params, qp


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("wire", ["codes", "f32"])
def test_calibrated_forward_matches_jax(calibrated, inputs, bits, wire):
    params, qp = calibrated
    ip_np = jax.device_get(jax_vit_int.prepare_int(
        params, qp, TINY, CFG, (bits,) * vit.num_bit_slots(TINY)))
    x = _codes(ip_np, inputs[1]) if wire == "codes" else inputs[0]
    got, want = _both(ip_np, x)
    assert got.shape == (2, 10) and np.isfinite(got).all()
    _assert_paths_agree(got, want)


@pytest.mark.parametrize("wire", ["codes", "f32"])
def test_random_model_forward_matches_jax(inputs, wire):
    ip_np = random_int_model(TINY_T, CFG, seed=1)
    x = _codes(ip_np, inputs[1]) if wire == "codes" else inputs[0]
    got, want = _both(ip_np, x)
    _assert_paths_agree(got, want)
    assert not np.array_equal(got[0], got[1])


"""The port's hybrid CNN-backbone patch embedding
(``diffvit_tpu_torch/models/hybrid.py``) against the JAX package's
(``diffvit_tpu/models/hybrid.py``), on the CPU: the same backbone, a
strided patchify and a channel mix written in both frameworks from the
same numpy weights, gives the same feature shape, and ``hybrid_embed``
the same tokens within atol 1e-5, also for a backbone that returns a list
of features (the last is used) and for the parameters JAX initialized,
carried across by ``hybrid_params_from_numpy``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffvit_tpu.models import hybrid as jax_hybrid

from diffvit_tpu_torch.models import hybrid

from test_torch_calibrate import one_torch_thread  # noqa: F401

MIX = np.random.default_rng(0).standard_normal((24, 3 * 16 * 16)).astype(
    np.float32) / 16  # a 16 x 16 stride-16 patchify to 24 channels


def _patches(x):
    b, c, h, w = x.shape
    return x.reshape(b, c, h // 16, 16, w // 16, 16), (b, h // 16, w // 16,
                                                       c * 256)


def jax_backbone(x):
    p, shape = _patches(x)
    p = jnp.transpose(p, (0, 2, 4, 1, 3, 5)).reshape(shape)
    return jnp.transpose(p @ jnp.asarray(MIX).T, (0, 3, 1, 2))


def torch_backbone(x):
    p, shape = _patches(x)
    p = p.permute(0, 2, 4, 1, 3, 5).reshape(shape)
    return (p @ torch.tensor(MIX, device=x.device).T).permute(0, 3, 1, 2)


def jax_backbone_multi(x):
    f = jax_backbone(x)
    return [f[:, :, ::2, ::2], f]


def torch_backbone_multi(x):
    f = torch_backbone(x)
    return (f[:, :, ::2, ::2], f)


def torch_backbone_host_only(x):
    """A backbone that reads a value on the host: no meta tensor takes it,
    so the shape probe runs one image of zeros."""
    assert float(x.abs().sum()) >= 0.0
    return torch_backbone(x)


@pytest.mark.parametrize("img_size", [224, 96])
def test_infer_feature_shape_equals_jax(img_size):
    want = jax_hybrid.infer_feature_shape(jax_backbone, img_size=img_size)
    assert want == ((img_size // 16,) * 2, 24)
    for fn in (torch_backbone, torch_backbone_multi,
               torch_backbone_host_only):
        assert hybrid.infer_feature_shape(fn, img_size=img_size,
                                          device="cpu") == want


def test_init_hybrid_params():
    p = hybrid.init_hybrid_params(torch.Generator().manual_seed(0),
                                  torch_backbone, embed_dim=32, device="cpu")
    assert p["num_patches"] == 196
    assert p["w"].shape == (32, 24) and p["b"].shape == (32,)
    assert float(p["w"].abs().max()) <= 0.04 and not p["b"].any()
    again = hybrid.init_hybrid_params(torch.Generator().manual_seed(0),
                                      torch_backbone, embed_dim=32,
                                      device="cpu")
    torch.testing.assert_close(p["w"], again["w"], rtol=0, atol=0)


@pytest.mark.parametrize("multi", [False, True], ids=["map", "list"])
def test_hybrid_embed_equals_jax(multi):
    """JAX's parameters through hybrid_params_from_numpy: the tokens
    within atol 1e-5."""
    jfn, tfn = (jax_backbone_multi, torch_backbone_multi) if multi else \
        (jax_backbone, torch_backbone)
    jp = jax_hybrid.init_hybrid_params(jax.random.PRNGKey(1), jfn,
                                       embed_dim=32)
    jp["b"] = jnp.linspace(-0.1, 0.1, 32)
    x = np.random.default_rng(2).standard_normal((2, 3, 224, 224)).astype(
        np.float32)
    want = np.asarray(jax_hybrid.hybrid_embed(jp, jfn, jnp.asarray(x)))
    p = hybrid.hybrid_params_from_numpy(jax.device_get(jp), "cpu")
    assert p["num_patches"] == jp["num_patches"] == 196
    got = hybrid.hybrid_embed(p, tfn, torch.tensor(x))
    assert got.shape == (2, 196, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # a list backbone: its last feature, the map's tokens
    if multi:
        torch.testing.assert_close(
            got, hybrid.hybrid_embed(p, torch_backbone, torch.tensor(x)),
            rtol=0, atol=0)

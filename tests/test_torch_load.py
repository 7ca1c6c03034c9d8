"""The port's checkpoint loading against the JAX package's, on the CPU: a
DeiT state dict saved with ``torch.save`` from random params, an AugReg
Flax ``.npz`` (with a position-embedding grid to resize), and
``resize_pos_embed`` load to the same float32 values (tolerance 0) in both
packages; ``registry.build_params`` and ``QuantizedViT(checkpoint=)`` take
them, from a path or from ``DIFFVIT_CKPT_DIR``."""
import jax
import numpy as np
import pytest
import torch

from diffvit_tpu.models import load as jload
from diffvit_tpu.models import vit as jvit

from diffvit_tpu_torch import engine
from diffvit_tpu_torch.models import load, registry
from diffvit_tpu_torch.models.vit import VIT_SPECS, ViTSpec

from test_torch_calibrate import one_torch_thread  # noqa: F401

TINY_KW = dict(embed_dim=64, depth=2, num_heads=2, num_classes=10)
TINY = ViTSpec("test_tiny", **TINY_KW)
TINY_J = jvit.ViTSpec("test_tiny", **TINY_KW)


def _assert_trees_equal(got, want):
    """Port tree (float32 tensors) == JAX tree (float32 arrays), exactly."""
    flat, _ = jax.tree_util.tree_flatten(want)
    mine = jax.tree_util.tree_leaves(got, is_leaf=lambda t: isinstance(
        t, torch.Tensor))
    assert len(mine) == len(flat)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda _: 0, got,
                               is_leaf=lambda t: isinstance(t, torch.Tensor))
    ) == jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda _: 0,
                                                            want))
    for a, b in zip(mine, flat):
        assert a.dtype == torch.float32 and b.dtype == np.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _state_dict(spec, seed=0):
    """A DeiT hub-style state dict of random float32 tensors (with a key
    the converter does not read, as a hub file has)."""
    g = torch.Generator().manual_seed(seed)
    c, hid, ps = spec.embed_dim, spec.hidden_dim, spec.patch_size
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    sd = {"cls_token": r(1, 1, c), "pos_embed": r(1, spec.seq_len, c),
          "patch_embed.proj.weight": r(c, 3, ps, ps),
          "patch_embed.proj.bias": r(c), "norm.weight": r(c),
          "norm.bias": r(c), "head.weight": r(spec.num_classes, c),
          "head.bias": r(spec.num_classes), "unused.buffer": r(3)}
    for i in range(spec.depth):
        p = f"blocks.{i}."
        for name, shape in (("norm1", (c,)), ("norm2", (c,)),
                            ("attn.qkv", (3 * c, c)), ("attn.proj", (c, c)),
                            ("mlp.fc1", (hid, c)), ("mlp.fc2", (c, hid))):
            sd[p + name + ".weight"] = r(*shape)
            sd[p + name + ".bias"] = r(shape[0])
    return sd


@pytest.mark.parametrize("wrapped", [False, True], ids=["bare", "model"])
def test_torch_checkpoint_loads_as_jax(tmp_path, wrapped):
    sd = _state_dict(TINY)
    path = tmp_path / "deit.pth"
    torch.save({"model": sd, "epoch": 3} if wrapped else sd, path)
    got = load.load_vit_torch_checkpoint(str(path), TINY)
    _assert_trees_equal(got, jload.load_vit_torch_checkpoint(str(path),
                                                             TINY_J))
    assert got["patch_embed"]["w"].shape == (64, 768)
    assert torch.equal(got["blocks"][1]["fc2"]["w"],
                       sd["blocks.1.mlp.fc2.weight"])


def _npz_arrays(spec, grid, seed=1):
    """An AugReg-layout .npz of random float32 arrays whose position
    embedding has a ``grid`` x ``grid`` patch grid."""
    rng = np.random.default_rng(seed)
    c, hid, ps, h = (spec.embed_dim, spec.hidden_dim, spec.patch_size,
                     spec.num_heads)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    a = {"embedding/kernel": r(ps, ps, 3, c), "embedding/bias": r(c),
         "cls": r(1, 1, c),
         "Transformer/posembed_input/pos_embedding": r(1, 1 + grid**2, c),
         "Transformer/encoder_norm/scale": r(c),
         "Transformer/encoder_norm/bias": r(c),
         "head/kernel": r(c, spec.num_classes),
         "head/bias": r(spec.num_classes)}
    for i in range(spec.depth):
        p = f"Transformer/encoderblock_{i}/"
        at = p + "MultiHeadDotProductAttention_1/"
        for n in ("query", "key", "value"):
            a[at + n + "/kernel"] = r(c, h, c // h)
            a[at + n + "/bias"] = r(h, c // h)
        a[at + "out/kernel"] = r(h, c // h, c)
        a[at + "out/bias"] = r(c)
        for ln in ("LayerNorm_0", "LayerNorm_2"):
            a[p + ln + "/scale"], a[p + ln + "/bias"] = r(c), r(c)
        a[p + "MlpBlock_3/Dense_0/kernel"] = r(c, hid)
        a[p + "MlpBlock_3/Dense_0/bias"] = r(hid)
        a[p + "MlpBlock_3/Dense_1/kernel"] = r(hid, c)
        a[p + "MlpBlock_3/Dense_1/bias"] = r(c)
    return a


@pytest.mark.parametrize("grid", [14, 7], ids=["same-grid", "resized"])
def test_npz_checkpoint_loads_as_jax(tmp_path, grid):
    path = tmp_path / "vit.npz"
    np.savez(path, **_npz_arrays(TINY, grid))
    got = load.load_vit_npz(str(path), TINY)
    _assert_trees_equal(got, jload.load_vit_npz(str(path), TINY_J))
    assert got["pos_embed"].shape == (1, TINY.seq_len, 64)
    assert got["blocks"][0]["qkv"]["w"].shape == (192, 64)


def test_resize_pos_embed_equals_jax_and_torch_bicubic():
    """Equal to JAX's, exactly; within 1e-5 of torch's own bicubic
    ``F.interpolate`` (align_corners=False), up- and down-sampling, square
    and not."""
    pos = np.random.default_rng(4).standard_normal((1, 1 + 49, 8)) \
        .astype(np.float32)
    for seq, gs in ((1 + 14 * 14, None), (1 + 4 * 4, None),
                    (1 + 6 * 9, (6, 9))):
        got = load.resize_pos_embed(pos, seq, gs_new=gs)
        np.testing.assert_array_equal(
            got, jload.resize_pos_embed(pos, seq, gs_new=gs))
        grid = torch.tensor(pos[0, 1:]).reshape(1, 7, 7, 8).permute(0, 3, 1, 2)
        out = torch.nn.functional.interpolate(
            grid.double(), size=gs or (int((seq - 1) ** 0.5),) * 2,
            mode="bicubic", align_corners=False)
        np.testing.assert_allclose(
            got[0, 1:], out.permute(0, 2, 3, 1).reshape(seq - 1, 8).numpy(),
            atol=1e-5)
        np.testing.assert_array_equal(got[:, :1], pos[:, :1])


def test_build_params_and_quantized_vit_take_a_checkpoint(tmp_path,
                                                          monkeypatch):
    """build_params loads a .pth by path or from DIFFVIT_CKPT_DIR onto the
    device, equal to the file; QuantizedViT(checkpoint=) carries it; a
    DeiT checkpoint under a Swin name goes to the Swin converter, which
    finds no Swin key and raises (tests/test_torch_swin_calibrate.py loads
    a Swin one)."""
    monkeypatch.setitem(VIT_SPECS, "deit_test", TINY)
    sd = _state_dict(TINY, seed=5)
    torch.save({"model": sd}, tmp_path / "deit_test.pth")
    spec, p = registry.build_params("deit_test",
                                    str(tmp_path / "deit_test.pth"),
                                    device="cpu")
    assert spec is TINY
    assert torch.equal(p["blocks"][0]["qkv"]["w"], sd["blocks.0.attn.qkv.weight"])
    monkeypatch.setenv("DIFFVIT_CKPT_DIR", str(tmp_path))
    _, p_env = registry.build_params("deit_test", device="cpu")
    assert torch.equal(p_env["head"]["w"], sd["head.weight"])
    q = engine.QuantizedViT("deit_test", device="cpu")
    assert torch.equal(q.params["norm"]["b"], sd["norm.bias"])
    monkeypatch.delenv("DIFFVIT_CKPT_DIR")
    q = engine.QuantizedViT("deit_test", device="cpu",
                            checkpoint=str(tmp_path / "deit_test.pth"))
    assert torch.equal(q.params["cls_token"], sd["cls_token"])
    with pytest.raises(KeyError, match="patch_embed.norm.weight"):
        registry.build_params("swin_tiny", str(tmp_path / "deit_test.pth"),
                              device="cpu")

"""Checkpoint conversion (counterpart of ``diffvit_tpu/models/load.py`` and
of ``diffvit_tpu/models/swin.py``'s converters): torch state dicts and
AugReg Flax ``.npz`` files into the port's ViT/DeiT float parameter
pytree, and Swin torch state dicts into the Swin one, as float32 CPU
tensors in the reference's layout (``vit.params_from_numpy`` moves them to
a device).

The key mapping is the reference's: the DeiT and Swin hub checkpoints
(a Swin dict's ``relative_position_index`` and ``attn_mask`` buffers are
recomputed, not read) and the Google-Brain Flax mapping for
vit_base/large.
Loaders take local paths; nothing is downloaded.  The bicubic resize of
the position embeddings runs in float64 numpy, the JAX package's own
arithmetic, so both give the same values."""
from __future__ import annotations

import numpy as np
import torch

from .swin import SwinSpec
from .vit import ViTSpec


def _t(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32)
    return torch.tensor(np.asarray(a, np.float32))


def convert_vit_torch_state_dict(sd, spec: ViTSpec) -> dict:
    """A DeiT/ViT torch state dict (the ``model`` entry of a hub file) ->
    the float parameter pytree.  The patch conv (C, 3, ps, ps) is flattened
    to (C, 3 * ps * ps), ``patchify``'s (Cin, kh, kw) order."""
    c = spec.embed_dim

    def g(k):
        return _t(sd[k])

    def lin(prefix):
        return {"w": g(prefix + ".weight"), "b": g(prefix + ".bias")}

    params = {
        "cls_token": g("cls_token"),
        "pos_embed": g("pos_embed"),
        "patch_embed": {"w": g("patch_embed.proj.weight").reshape(c, -1),
                        "b": g("patch_embed.proj.bias")},
        "blocks": [],
        "norm": lin("norm"),
        "head": lin("head"),
    }
    for i in range(spec.depth):
        p = f"blocks.{i}."
        params["blocks"].append({
            "norm1": lin(p + "norm1"), "qkv": lin(p + "attn.qkv"),
            "proj": lin(p + "attn.proj"), "norm2": lin(p + "norm2"),
            "fc1": lin(p + "mlp.fc1"), "fc2": lin(p + "mlp.fc2"),
        })
    return params


def load_vit_torch_checkpoint(path, spec: ViTSpec) -> dict:
    """A torch ``.pth`` file (a state dict, or a dict holding one under
    ``model``) -> the float parameter pytree.  ``weights_only=False``, as the
    reference loads it: load only files you trust."""
    return convert_vit_torch_state_dict(_torch_state_dict(path), spec)


def _torch_state_dict(path):
    """The state dict of a torch ``.pth`` file (a state dict, or a dict
    holding one under ``model``).  ``weights_only=False``, as the reference
    loads it: load only files you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt


def convert_swin_torch_state_dict(sd, spec: SwinSpec) -> dict:
    """A Swin torch state dict (the reference's module tree) -> the float
    parameter pytree of ``swin.init_swin_params``.  The patch conv
    (C, 3, ps, ps) is flattened to (C, 3 * ps * ps), ``swin_patchify``'s
    order; the reductions have no bias."""
    def g(k):
        return _t(sd[k])

    def lin(prefix, bias=True):
        return {"w": g(prefix + ".weight"),
                "b": g(prefix + ".bias") if bias else None}

    params = {
        "patch_embed": {
            "proj": {"w": g("patch_embed.proj.weight").reshape(
                spec.embed_dim, -1), "b": g("patch_embed.proj.bias")},
            "norm": lin("patch_embed.norm") if spec.patch_norm else None,
        },
        "layers": [],
        "norm": lin("norm"),
        "head": lin("head"),
    }
    for s in range(spec.num_layers):
        stage = {"blocks": [], "downsample": None}
        for bi in range(spec.depths[s]):
            p = f"layers.{s}.blocks.{bi}"
            stage["blocks"].append({
                "norm1": lin(p + ".norm1"),
                "qkv": lin(p + ".attn.qkv"),
                "proj": lin(p + ".attn.proj"),
                "rel_bias_table": g(p + ".attn.relative_position_bias_table"),
                "norm2": lin(p + ".norm2"),
                "fc1": lin(p + ".mlp.fc1"),
                "fc2": lin(p + ".mlp.fc2"),
            })
        if s < spec.num_layers - 1:
            stage["downsample"] = {
                "norm": lin(f"layers.{s}.downsample.norm"),
                "reduction": lin(f"layers.{s}.downsample.reduction",
                                 bias=False),
            }
        params["layers"].append(stage)
    return params


def load_swin_torch_checkpoint(path, spec: SwinSpec) -> dict:
    """A Swin torch ``.pth`` file -> the float parameter pytree."""
    return convert_swin_torch_state_dict(_torch_state_dict(path), spec)


def _cubic_weights(frac, a=-0.75):
    """torch's bicubic convolution weights (cubic_convolution1/2, a=-0.75)."""
    def w1(x):
        return ((a + 2) * x - (a + 3)) * x * x + 1

    def w2(x):
        return ((a * x - 5 * a) * x + 8 * a) * x - 4 * a

    return np.stack([w2(frac + 1), w1(frac), w1(1 - frac), w2(2 - frac)],
                    axis=-1)


def _torch_bicubic_resize_1d(x, out_size, axis):
    """Separable torch-style bicubic (align_corners=False, half-pixel
    centers, border-clamped taps) along ``axis``."""
    x = np.moveaxis(x, axis, 0)
    in_size = x.shape[0]
    scale = in_size / out_size
    coords = (np.arange(out_size) + 0.5) * scale - 0.5
    i0 = np.floor(coords).astype(int)
    frac = coords - i0
    w = _cubic_weights(frac)  # (out, 4)
    idx = np.clip(i0[:, None] + np.arange(-1, 3)[None, :], 0, in_size - 1)
    out = np.einsum("ot,ot...->o...", w, x[idx])
    return np.moveaxis(out, 0, axis)


def resize_pos_embed(posemb, seq_len_new, num_tokens=1, gs_new=None):
    """Grid resize of ViT position embeddings for a new resolution: the
    class tokens split off, the grid bicubically interpolated (torch
    ``F.interpolate`` semantics: a=-0.75, half-pixel, align_corners=False)
    in float64, and the two joined again.  numpy in, numpy out."""
    posemb = np.asarray(posemb)
    tok, grid = posemb[:, :num_tokens], posemb[0, num_tokens:]
    gs_old = int(np.sqrt(len(grid)))
    if gs_new is None:
        gs_new = [int(np.sqrt(seq_len_new - num_tokens))] * 2
    grid = grid.reshape(gs_old, gs_old, -1).astype(np.float64)
    grid = _torch_bicubic_resize_1d(grid, gs_new[0], axis=0)
    grid = _torch_bicubic_resize_1d(grid, gs_new[1], axis=1)
    grid = grid.reshape(1, gs_new[0] * gs_new[1], -1)
    return np.concatenate([tok, grid.astype(posemb.dtype)], axis=1)


def convert_vit_npz(npz, spec: ViTSpec) -> dict:
    """An AugReg Flax ``.npz`` -> the float parameter pytree: the conv
    kernel (ps, ps, 3, C) -> (C, 3 * ps * ps); the per-head q/k/v kernels
    joined into one (3C, C) qkv matrix; Flax Dense kernels, (in, out),
    transposed into torch's (out, in); the position embeddings resized
    where their grid differs from the spec's."""
    c = spec.embed_dim

    def g(k):
        return np.asarray(npz[k])

    kern = g("embedding/kernel").transpose(3, 2, 0, 1).reshape(c, -1)
    pos = g("Transformer/posembed_input/pos_embedding")
    if pos.shape[1] != spec.seq_len:
        pos = resize_pos_embed(pos, spec.seq_len)
    params = {
        "cls_token": _t(g("cls")),
        "pos_embed": _t(pos),
        "patch_embed": {"w": _t(kern), "b": _t(g("embedding/bias"))},
        "blocks": [],
        "norm": {"w": _t(g("Transformer/encoder_norm/scale")),
                 "b": _t(g("Transformer/encoder_norm/bias"))},
        "head": {"w": _t(g("head/kernel").T), "b": _t(g("head/bias"))},
    }
    for i in range(spec.depth):
        p = f"Transformer/encoderblock_{i}/"
        at = p + "MultiHeadDotProductAttention_1/"

        def qkv_w(name):
            # (C, heads, head_dim) -> (C, C) -> torch layout (C_out, C_in)
            return g(at + name + "/kernel").reshape(c, c).T

        def qkv_b(name):
            return g(at + name + "/bias").reshape(c)

        names = ("query", "key", "value")
        params["blocks"].append({
            "norm1": {"w": _t(g(p + "LayerNorm_0/scale")),
                      "b": _t(g(p + "LayerNorm_0/bias"))},
            "qkv": {"w": _t(np.concatenate([qkv_w(n) for n in names])),
                    "b": _t(np.concatenate([qkv_b(n) for n in names]))},
            "proj": {"w": _t(g(at + "out/kernel").reshape(c, c).T),
                     "b": _t(g(at + "out/bias"))},
            "norm2": {"w": _t(g(p + "LayerNorm_2/scale")),
                      "b": _t(g(p + "LayerNorm_2/bias"))},
            "fc1": {"w": _t(g(p + "MlpBlock_3/Dense_0/kernel").T),
                    "b": _t(g(p + "MlpBlock_3/Dense_0/bias"))},
            "fc2": {"w": _t(g(p + "MlpBlock_3/Dense_1/kernel").T),
                    "b": _t(g(p + "MlpBlock_3/Dense_1/bias"))},
        })
    return params


def load_vit_npz(path, spec: ViTSpec) -> dict:
    with np.load(path) as npz:
        return convert_vit_npz(npz, spec)

"""Hybrid CNN-backbone patch embedding (the port's copy of
``diffvit_tpu/models/hybrid.py``): run a CNN backbone, take its last
feature map, project it to the embedding width with a 1x1 convolution and
flatten it to (B, N, C) tokens.

As upstream, no ViT spec wires it in.  The backbone is any callable
``x (B, 3, H, W) -> feature (B, Cf, Hf, Wf)``, or a list or tuple of
features of which the last is used."""
from __future__ import annotations

import numpy as np
import torch

from .vit import params_from_numpy


def _last_feature(f):
    return f[-1] if isinstance(f, (list, tuple)) else f


def infer_feature_shape(backbone_fn, img_size=224, in_chans=3,
                        device="cuda"):
    """((Hf, Wf), Cf) of the backbone's last feature map: the backbone
    run on a meta tensor (shapes only, no arithmetic) where it takes one,
    else on one image of zeros on ``device`` under ``no_grad``, as the
    reference probes it."""
    shape = (1, in_chans, img_size, img_size)
    try:
        o = _last_feature(backbone_fn(torch.zeros(shape, device="meta")))
    except (NotImplementedError, RuntimeError):
        # an op without a meta kernel, or parameters on a real device
        with torch.no_grad():
            o = _last_feature(backbone_fn(torch.zeros(shape, device=device)))
    return tuple(o.shape[-2:]), o.shape[1]


def init_hybrid_params(generator: torch.Generator, backbone_fn, embed_dim,
                       img_size=224, in_chans=3, device="cuda"):
    """The 1x1 projection's parameters: weights (embed_dim, Cf) from a
    normal of std 0.02 truncated at +-2 std, drawn on the CPU from
    ``generator`` as ``vit.init_params`` draws, zero bias; and
    ``num_patches`` = Hf * Wf."""
    (fh, fw), cf = infer_feature_shape(backbone_fn, img_size, in_chans,
                                       device)
    w = torch.nn.init.trunc_normal_(torch.empty(embed_dim, cf), 0.0, 1.0,
                                    -2.0, 2.0, generator=generator)
    return {"w": (0.02 * w).to(device),
            "b": torch.zeros(embed_dim, device=device),
            "num_patches": fh * fw}


def hybrid_params_from_numpy(params, device="cuda"):
    """The JAX package's hybrid parameters (``w``, ``b`` as numpy arrays,
    ``num_patches``) as the port's: float32 tensors on ``device``."""
    out = params_from_numpy({"w": params["w"], "b": params["b"]}, device)
    out["num_patches"] = int(np.asarray(params["num_patches"]))
    return out


def hybrid_embed(params, backbone_fn, x):
    """backbone -> last feature -> 1x1 projection -> (B, N, embed_dim)
    tokens.  The 1x1 convolution over an NCHW map is a channel matmul over
    the flattened positions."""
    f = _last_feature(backbone_fn(x))
    b, cf, fh, fw = f.shape
    tokens = f.reshape(b, cf, fh * fw).transpose(1, 2)  # (B, N, Cf)
    return torch.matmul(tokens, params["w"].T) + params["b"]

"""Activation harvesting for CKA and DDV (the port's counterpart of
``diffvit_tpu/analysis/activations.py``): the forwards' ``taps``, selected
and ordered as the reference's forward hooks report them.

* ``bit_config is None``: per block [attn (the qkv output), attn.qkv,
  attn.proj, mlp (the fc1 output), mlp.fc1, mlp.fc2] between the patch
  conv and the head (the attn/qkv and mlp/fc1 rows are the same tensors,
  as in the reference): 6 * depth + 2 taps;
* a bit config: the conv and linear sites only, the patch conv, [qkv,
  proj, fc1, fc2] a block, the head: 4 * depth + 2 taps;
* Swin, either way: the patch conv, per stage [qkv, proj, fc1, fc2] a
  block and then the stage's reduction, the head; each tap folded to (B,
  -1) (its windows into the features).
"""
from __future__ import annotations

import torch

from ..models import swin as swin_mod
from ..models import vit as vit_mod


def normalize_activations(act):
    """Per-sample L2 normalization of ``act`` flattened to (B, -1), in
    float64 rounded once."""
    act = act.reshape(act.shape[0], -1).to(torch.float64)
    norm = torch.linalg.vector_norm(act, dim=1, keepdim=True) + 1e-8
    return (act / norm).to(torch.float32)


def _order_for(spec, module_taps: bool):
    order = ["patch_embed.proj"]
    for i in range(spec.depth):
        p = f"blocks.{i}"
        if module_taps:
            order += [f"{p}.attn", f"{p}.attn.qkv", f"{p}.attn.proj",
                      f"{p}.mlp", f"{p}.mlp.fc1", f"{p}.mlp.fc2"]
        else:
            order += [f"{p}.attn.qkv", f"{p}.attn.proj",
                      f"{p}.mlp.fc1", f"{p}.mlp.fc2"]
    order.append("head")
    return order


def _order_for_swin(spec):
    """The Swin conv/linear sites in the reference's module registration
    order."""
    order = ["patch_embed.proj"]
    for s, depth in enumerate(spec.depths):
        for b in range(depth):
            p = f"layers.{s}.blocks.{b}"
            order += [f"{p}.attn.qkv", f"{p}.attn.proj",
                      f"{p}.mlp.fc1", f"{p}.mlp.fc2"]
        if s < spec.num_layers - 1:
            order.append(f"layers.{s}.downsample.reduction")
    order.append("head")
    return order


def get_activations(model, images, bit_config=None, quant=None,
                    normalize_act=False, layer_indices=None):
    """Run ``model`` (an ``engine.QuantizedViT``) on ``images`` and return
    the ordered list of activations on its device.  ``quant`` defaults to
    whether the model is calibrated.  A Swin's fake-quant forward takes the
    uniform bit ``bit_config`` (an int), or ``bit_config[0]`` of a
    sequence, as the JAX package does.  ``layer_indices``: one relative
    index; then returns ([act], [info])."""
    if quant is None:
        quant = model.qparams is not None
    taps: list = []
    with torch.inference_mode():
        x = model._prep(images)
        if model.is_swin:
            if quant:
                bit = int(bit_config) if isinstance(bit_config, (int, float)) \
                    else (int(bit_config[0]) if bit_config is not None
                          else model.cfg.bit_w.bits)
                swin_mod.forward_q(model.params, model.qparams, model.spec,
                                   model.cfg, x, bit=bit, taps=taps)
            else:
                swin_mod.forward_fp(model.params, model.spec, x, taps=taps)
        elif quant:
            vit_mod.forward_q(model.params, model.qparams, model.spec,
                              model.cfg, x, bit_config, taps=taps)
        else:
            vit_mod.forward_fp(model.params, model.spec, x, taps=taps)
    tap_dict = dict(taps)
    if model.is_swin:
        order = _order_for_swin(model.spec)
        acts = [tap_dict[name].reshape(x.shape[0], -1) for name in order]
    else:
        order = _order_for(model.spec, module_taps=bit_config is None)
        acts = [tap_dict[name] for name in order]
    infos = [{"relative_index": i, "name": name}
             for i, name in enumerate(order)]
    if layer_indices is not None:
        acts = [acts[layer_indices]]
        infos = [infos[layer_indices]]
    if normalize_act:
        acts = [normalize_activations(a) for a in acts]
    if layer_indices is None:
        return acts
    return acts, infos

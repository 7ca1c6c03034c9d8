"""ModelDiff-style DDV (decision-distance vector) similarity (the port's
counterpart of ``diffvit_tpu/analysis/ddv.py``): at each named activation
point, the per-sample cosine of the clean and the adversarial activation,
normalized per layer (the DDV), and the cross-model similarity report, the
cosine of two models' DDVs in %.  The forwards run on the model's device;
the DDVs are numpy, as in JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import vit as vit_mod


def ddv_tap_names(spec):
    """The named hook points, as the forwards' taps: the patch conv,
    [qkv, proj, fc1, fc2] a block, the head."""
    names = ["patch_embed.proj"]
    for i in range(spec.depth):
        p = f"blocks.{i}"
        names += [f"{p}.attn.qkv", f"{p}.attn.proj",
                  f"{p}.mlp.fc1", f"{p}.mlp.fc2"]
    names.append("head")
    return names


def _acts(model, images, quant):
    taps: list = []
    with torch.inference_mode():
        x = model._prep(images)
        if quant:
            out = vit_mod.forward_q(model.params, model.qparams, model.spec,
                                    model.cfg, x, None, taps=taps)
        else:
            out = vit_mod.forward_fp(model.params, model.spec, x, taps=taps)
    d = {k: v.cpu().numpy() for k, v in taps}
    d["__logits__"] = out.cpu().numpy()
    return d


def compute_ddv(model, normal_inputs, adv_inputs, quant=None):
    """{site: DDV}: the per-sample cosine of the clean and the adversarial
    activation, L2-normalized over the samples (``quant`` defaults to
    whether the model is calibrated)."""
    if quant is None:
        quant = model.qparams is not None
    normal = _acts(model, normal_inputs, quant)
    adv = _acts(model, adv_inputs, quant)
    out = {}
    for key in ddv_tap_names(model.spec):
        a = normal[key].reshape(len(normal[key]), -1)
        b = adv[key].reshape(len(adv[key]), -1)
        a = a / (np.linalg.norm(a, axis=1, keepdims=True))
        b = b / (np.linalg.norm(b, axis=1, keepdims=True))
        ddv = np.sum(a * b, axis=1)
        norm = np.linalg.norm(ddv)
        out[key] = ddv / norm if norm != 0 else ddv
    return out


def ddv_similarities(source_ddv, target_ddv, log=print):
    """Per-layer similarity % between two models' DDVs."""
    sims = {}
    for key in source_ddv:
        a = source_ddv[key] / np.linalg.norm(source_ddv[key])
        b = target_ddv[key] / np.linalg.norm(target_ddv[key])
        sims[key] = float(np.dot(a, b) * 100)
        log(f"{key} layer similarity: {sims[key]:.2f}%")
    return sims

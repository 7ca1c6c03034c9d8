"""Distillation QAT (counterpart of ``diffvit_tpu/calib/qat.py``): the latent
float weights of the fake-quant forward are fine-tuned toward the float
teacher's logits.

Every rounding of the quantized forward has a straight-through mode
(``forward_q(ste=True)``: the same values, the identity's gradient; the
integer LayerNorm and the LIS keep their exact values and take the
gradient of the reference's float formula), so the whole model trains end
to end, without labels: the CLI's Gaussian calibration batch will do.  The
teacher's logits are computed once a batch; the batches are cycled over
the steps; Adam in optax's order (``calib/optim.py``) updates every float
leaf of the params, held as views of one flat tensor so that an update is
a few launches.  The result is a latent pytree that ``forward_q``,
``prepare_int`` and the bias correction take unchanged.
"""
from __future__ import annotations

import torch

from ..config import QuantConfig
from ..models import swin, vit
from .optim import Adam

F32, F64 = torch.float32, torch.float64


def _leaves(tree, out):
    """The tensors of ``tree`` in order (None skipped)."""
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif tree is not None:
        out.append(tree)
    return out


def _rebuild(tree, it):
    """``tree`` with each tensor replaced by the next of ``it``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, it) for v in tree]
    return None if tree is None else next(it)


def _views(flat, like):
    """The params ``like`` as views of the flat tensor ``flat``."""
    leaves = _leaves(like, [])
    parts = flat.split([t.numel() for t in leaves])
    return _rebuild(like, iter(p.view(t.shape)
                               for p, t in zip(parts, leaves)))


def qat_distill(params, qp, spec, cfg: QuantConfig, batches,
                bit_config=None, *, steps=200, lr=1e-5, fp_params=None,
                remat=False):
    """Distill ``forward_q(params)`` toward ``forward_fp(fp_params)`` by the
    MSE of the logits.  ``batches``: one float32 batch or a list (cycled
    over the steps), on the params' device.  Returns ``(new_params,
    losses)``, the per-step loss trajectory read from the device once at
    the end.  ViT/DeiT and Swin; ``remat=True`` (the ViT family only)
    recomputes each block in the backward pass, the same trajectory."""
    mod = swin if isinstance(spec, swin.SwinSpec) else vit
    if remat and mod is swin:
        raise NotImplementedError(
            "remat is wired for the ViT family body (Swin blocks are "
            "windowed)")
    if fp_params is None:
        fp_params = params
    if mod is swin:
        bit_config = swin.normalize_bit_config(
            spec, bit_config if bit_config is not None else cfg.bit_w.bits)
    else:
        if bit_config is None:
            bit_config = (cfg.bit_w.bits,) * vit.num_bit_slots(spec)
        bit_config = tuple(int(b) for b in bit_config)
    if not isinstance(batches, (list, tuple)):
        batches = [batches]
    kw = {"remat": True} if remat else {}

    with torch.no_grad():
        targets = [mod.forward_fp(fp_params, spec, b) for b in batches]
    qp = vit.autograd_safe(qp)
    flat = torch.cat([t.detach().reshape(-1).to(F32)
                      for t in _leaves(params, [])]).requires_grad_(True)
    adam = Adam(flat, lr, steps)
    losses = []
    for i in range(steps):
        j = i % len(batches)
        y = mod.forward_q(_views(flat, params), qp, spec, cfg, batches[j],
                          bit_config, ste=True, **kw)
        d = (y - targets[j]).to(F64)
        loss = (d * d).mean().to(F32)
        adam.step(torch.autograd.grad(loss, flat)[0])
        losses.append(loss.detach())
    new = _views(flat.detach().clone(), params)
    return new, torch.stack(losses).cpu().tolist() if losses else []

"""Model registry (counterpart of ``diffvit_tpu/models/registry.py``):
names to specs, and random float parameters from a seed.

Loading a checkpoint is not ported yet (ROADMAP Queue 1, item 4: model
loading), nor are Swin's float parameters (the same item): both raise
``NotImplementedError``, so a checkpoint that was asked for is never
replaced by random weights."""
from __future__ import annotations

import os

import torch

from .swin import SWIN_SPECS
from .vit import VIT_SPECS, init_params

_NOT_YET = "ROADMAP Queue 1, item 4 (Swin float forward, calibration and " \
           "baking; model loading)"


def family(name: str) -> str:
    return name.split("_")[0]


def get_spec(name: str):
    if name in VIT_SPECS:
        return VIT_SPECS[name]
    if name in SWIN_SPECS:
        return SWIN_SPECS[name]
    raise KeyError(name)


def _env_checkpoint(name: str):
    """The reference's fallback: ``{name}.pth`` or ``.npz`` in the
    directory named by ``DIFFVIT_CKPT_DIR``, if there is one."""
    ckpt_dir = os.environ.get("DIFFVIT_CKPT_DIR", "")
    for ext in (".pth", ".npz"):
        cand = os.path.join(ckpt_dir, name + ext)
        if ckpt_dir and os.path.exists(cand):
            return cand
    return None


def build_params(name: str, checkpoint: str | None = None, seed: int = 0,
                 device="cuda"):
    """(spec, params) for ``name``: the float parameters drawn from
    ``seed`` (``vit.init_params``) on ``device``.  A checkpoint (given, or
    found where the reference looks for one) and the Swin family raise
    ``NotImplementedError``: their loaders are not ported yet."""
    spec = get_spec(name)
    checkpoint = checkpoint or _env_checkpoint(name)
    if checkpoint is not None:
        raise NotImplementedError(
            f"{name}: loading the checkpoint {checkpoint!r} is not ported "
            f"yet ({_NOT_YET})")
    if name in SWIN_SPECS:
        raise NotImplementedError(
            f"{name}: Swin float parameters are not ported yet ({_NOT_YET})")
    return spec, init_params(spec, torch.Generator().manual_seed(seed),
                             device)

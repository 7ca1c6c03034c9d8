"""Model registry (counterpart of ``diffvit_tpu/models/registry.py``):
names to specs, the per-family preprocessing constants, and the float
parameters of a ViT/DeiT from a checkpoint or from a seed.

Swin's float parameters and its checkpoint converters are not ported yet
(ROADMAP Queue 1, item 4): both raise ``NotImplementedError``, so a
checkpoint that was asked for is never replaced by random weights."""
from __future__ import annotations

import dataclasses
import os

import torch

from .load import load_vit_npz, load_vit_torch_checkpoint
from .swin import SWIN_SPECS
from .vit import VIT_SPECS, init_params, params_from_numpy

_NOT_YET = "ROADMAP Queue 1, item 4 (Swin float forward, calibration and " \
           "baking; Swin model loading)"


@dataclasses.dataclass(frozen=True)
class Preprocessing:
    mean: tuple
    std: tuple
    crop_pct: float
    input_size: int = 224


PREPROCESSING = {
    "deit": Preprocessing((0.485, 0.456, 0.406), (0.229, 0.224, 0.225), 0.875),
    "vit": Preprocessing((0.5, 0.5, 0.5), (0.5, 0.5, 0.5), 0.9),
    "swin": Preprocessing((0.485, 0.456, 0.406), (0.229, 0.224, 0.225), 0.9),
}

MODEL_NAMES = (
    "deit_tiny", "deit_small", "deit_base", "vit_base", "vit_large",
    "swin_tiny", "swin_small", "swin_base",
)


def family(name: str) -> str:
    return name.split("_")[0]


def preprocessing_for(name: str) -> Preprocessing:
    return PREPROCESSING[family(name)]


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
    """(spec, params) for ``name`` on ``device``: loaded from
    ``checkpoint`` (a torch ``.pth`` or a Flax ``.npz``; else
    ``DIFFVIT_CKPT_DIR``'s ``{name}.pth`` / ``{name}.npz``), or drawn from
    ``seed`` (``vit.init_params``).  The Swin family raises
    ``NotImplementedError`` either way."""
    spec = get_spec(name)
    checkpoint = checkpoint or _env_checkpoint(name)
    if name in SWIN_SPECS:
        what = f"the checkpoint {checkpoint!r}" if checkpoint else \
            "random float parameters"
        raise NotImplementedError(
            f"{name}: Swin loading of {what} is not ported yet ({_NOT_YET})")
    if checkpoint is not None:
        load = load_vit_npz if str(checkpoint).endswith(".npz") \
            else load_vit_torch_checkpoint
        return spec, params_from_numpy(load(checkpoint, spec), device)
    return spec, init_params(spec, torch.Generator().manual_seed(seed),
                             device)

"""Swin Transformer specs, window geometry and token reshuffles
(counterpart of ``diffvit_tpu/models/swin.py:44-149, 203-309, 402-560``).

Only what the integer forward needs: the float forward, calibration and
weight loading are not ported.  ``relative_position_index`` and
``shift_attn_mask`` are numpy, as in the reference; the reshuffles take
torch tensors."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SwinSpec:
    name: str
    embed_dim: int
    depths: tuple
    num_heads: tuple
    window: int = 7
    patch_size: int = 4
    img_size: int = 224
    mlp_ratio: int = 4
    num_classes: int = 1000
    input_quant: bool = True
    patch_norm: bool = True
    ln_eps: float = 1e-5

    @property
    def num_layers(self):
        return len(self.depths)

    @property
    def num_features(self):
        return int(self.embed_dim * 2 ** (self.num_layers - 1))

    @property
    def patch_grid(self):
        g = self.img_size // self.patch_size
        return (g, g)

    def stage_dim(self, s):
        return int(self.embed_dim * 2**s)

    def stage_resolution(self, s):
        g = self.patch_grid[0]
        return (g // 2**s, g // 2**s)


SWIN_SPECS = {
    "swin_tiny": SwinSpec("swin_tiny", 96, (2, 2, 6, 2), (3, 6, 12, 24)),
    "swin_small": SwinSpec("swin_small", 96, (2, 2, 18, 2), (3, 6, 12, 24)),
    "swin_base": SwinSpec("swin_base", 128, (2, 2, 18, 2), (4, 8, 16, 32)),
}


def num_bit_slots(spec: SwinSpec) -> int:
    """Patch conv + 4 per block + one reduction per stage but the last +
    head: the length of the Swin bit_config."""
    return 1 + 4 * sum(spec.depths) + (spec.num_layers - 1) + 1


def normalize_bit_config(spec: SwinSpec, bit):
    """An int (uniform) or a per-slot sequence -> the bit_config tuple."""
    n = num_bit_slots(spec)
    if bit is None or isinstance(bit, (int, np.integer)):
        return tuple([int(bit)] * n) if bit is not None else None
    bc = tuple(int(v) for v in bit)
    if len(bc) != n:
        raise ValueError(f"Swin bit_config needs {n} entries, got {len(bc)}")
    return bc


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int):
    """(B*nW, ws*ws, C) -> (B, H, W, C)."""
    c = windows.shape[-1]
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) int index into the (2ws-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def shift_attn_mask(resolution, ws: int, shift: int):
    """(nW, ws*ws, ws*ws) float32 0/-100 mask of the shifted windows, or
    None without a shift."""
    if shift == 0:
        return None
    h, w = resolution
    img = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    mw = img.reshape(1, h // ws, ws, w // ws, ws, 1)
    mw = mw.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    mask = mw[:, None, :] - mw[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def block_geometry(spec: SwinSpec, stage: int, blk: int):
    """(resolution, window, shift, mask) of a block; the window shrinks to
    the resolution, and stops shifting, where the resolution is no larger
    than the window."""
    res = spec.stage_resolution(stage)
    ws = spec.window
    shift = 0 if blk % 2 == 0 else ws // 2
    if min(res) <= ws:
        shift = 0
        ws = min(res)
    return res, ws, shift, shift_attn_mask(res, ws, shift)


def swin_patchify(x: torch.Tensor, spec: SwinSpec) -> torch.Tensor:
    """NCHW -> (B, grid*grid, 3*ps*ps) in the Conv2d weight's (Cin, kh, kw)
    order."""
    b = x.shape[0]
    g, p = spec.patch_grid[0], spec.patch_size
    x = x.reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, g * g, 3 * p * p)


def _windows(x: torch.Tensor, res, ws: int, shift: int) -> torch.Tensor:
    """(B, H*W, C) tokens -> (B*nW, ws*ws, C) windows, cyclically shifted
    by ``-shift`` first."""
    b, _, c = x.shape
    h, w = res
    x = x.reshape(b, h, w, c)
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    return window_partition(x, ws)


def _unwindows(xw: torch.Tensor, res, ws: int, shift: int, b: int):
    """Inverse of :func:`_windows`: (B*nW, ws*ws, C) -> (B, H*W, C)."""
    h, w = res
    c = xw.shape[-1]
    x = window_reverse(xw.reshape(-1, ws, ws, c), ws, h, w)
    if shift > 0:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    return x.reshape(b, h * w, c)


def _merge_patches(x: torch.Tensor, res) -> torch.Tensor:
    """2x2 patch concat: (B, H*W, C) -> (B, H/2*W/2, 4C)."""
    b, _, c = x.shape
    h, w = res
    x = x.reshape(b, h, w, c)
    parts = (x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
             x[:, 1::2, 1::2])
    return torch.cat(parts, -1).reshape(b, -1, 4 * c)

"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper takes its kernel for a CUDA tensor and its plain version for a
CPU tensor, raises for any other device, and counts the kernel launches in
an integer attribute (``fused_qkv_attention_v2.launches``,
``fused_int_attention.launches``, ``fused_int_mlp.launches``, ...).

    attention.py  K1 fused_qkv_attention_v2, K5 fused_int_attention, K7a
                  fused_attention_block, K8 fused_qkv_attention (v1) and
                  fused_qkv_attention_v3 / _v4 / _v5
    mlp.py        K2 fused_int_mlp, K7b fused_int_mlp_block
    linear.py     K3 fused_int_linear
    swin_attention.py  K4 fused_swin_attention, K4b fused_swin_attention_v2
    serve.py      K6 resident_codes (the whole ViT encoder)"""
from __future__ import annotations

import torch


def require(cond: bool, what: str) -> None:
    """Raise ``ValueError`` for an argument a kernel does not take."""
    if not cond:
        raise ValueError(what)


def route(*tensors: torch.Tensor) -> str:
    """'cpu' (plain version) or 'cuda' (kernel) for the tensors' common
    device; raises for any other device or a mix."""
    devices = {t.device for t in tensors}
    require(len(devices) == 1, f"tensors on several devices: {devices}")
    kind = tensors[0].device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {kind!r}")
    return kind


def check_for_kernel(t: torch.Tensor, name: str, dtype: torch.dtype,
                     ndim: int) -> None:
    require(t.dtype == dtype, f"{name}: expected {dtype}, got {t.dtype}")
    require(t.dim() == ndim, f"{name}: expected {ndim} dims, got {t.dim()}")
    require(t.is_contiguous(), f"{name}: must be contiguous")
    require(t.data_ptr() % 16 == 0, f"{name}: must be 16-byte aligned")

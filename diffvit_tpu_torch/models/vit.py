"""ViT/DeiT model specs and the patchify reshuffle
(counterpart of ``diffvit_tpu/models/vit.py:64-176``)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ViTSpec:
    name: str
    embed_dim: int
    depth: int
    num_heads: int
    patch_size: int = 16
    img_size: int = 224
    mlp_ratio: int = 4
    num_classes: int = 1000
    input_quant: bool = True
    ln_eps: float = 1e-6
    drop_path_rate: float = 0.0

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def attn_scale(self) -> float:
        return self.head_dim ** -0.5

    @property
    def hidden_dim(self) -> int:
        return self.embed_dim * self.mlp_ratio


VIT_SPECS = {
    "deit_tiny": ViTSpec("deit_tiny", 192, 12, 3),
    "deit_small": ViTSpec("deit_small", 384, 12, 6),
    "deit_base": ViTSpec("deit_base", 768, 12, 12),
    "vit_base": ViTSpec("vit_base", 768, 12, 12),
    "vit_large": ViTSpec("vit_large", 1024, 24, 16, input_quant=False),
}


def num_bit_slots(spec: ViTSpec) -> int:
    return 4 * spec.depth + 2


def patchify(x: torch.Tensor, spec: ViTSpec) -> torch.Tensor:
    """NCHW image -> (B, num_patches, 3*ps*ps) patches flattened in
    (Cin, kh, kw) order, so the patch conv is exactly patches @ W.T + b."""
    b = x.shape[0]
    g, p = spec.img_size // spec.patch_size, spec.patch_size
    x = x.reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, g * g, 3 * p * p)

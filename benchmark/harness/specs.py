"""The shapes of a configuration file (``benchmark/configs/<name>.json``)
as plain values, for the benchmark's generator, reference and counts.

Nothing here imports the program: the harness hands the same numbers to
the program's own spec types only where it builds the artifact
(``harness.drive``)."""
from __future__ import annotations

import dataclasses

BITS = {"int4": (4, True), "int8": (8, True), "uint4": (4, False),
        "uint8": (8, False), "uint3": (3, False)}


def bounds(name: str) -> tuple[int, int]:
    """(lower, upper) code of a bit type named as in the configuration."""
    bits, signed = BITS[name]
    if signed:
        return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return 0, 2**bits - 1


@dataclasses.dataclass(frozen=True)
class Quant:
    """The configuration's quantization settings (the program's
    ``QuantConfig.to_dict()`` form)."""
    fields: tuple

    def __getitem__(self, k):
        return dict(self.fields)[k]

    @property
    def w_bits(self) -> int:
        return BITS[self["bit_w"]][0]

    @property
    def a_bounds(self) -> tuple[int, int]:
        return bounds(self["bit_a"])

    @property
    def s_bits(self) -> int:
        """The softmax's bits: the 4-bit LIS, else 8 (the program's
        ``QuantConfig.bit_s``)."""
        return 4 if self["lis"] else 8

    def as_dict(self) -> dict:
        return {k: list(v) if isinstance(v, tuple) else v
                for k, v in self.fields}


def _quant(d: dict) -> Quant:
    return Quant(tuple((k, tuple(v) if isinstance(v, list) else v)
                       for k, v in d.items()))


@dataclasses.dataclass(frozen=True)
class ViT:
    name: str
    embed_dim: int
    depth: int
    num_heads: int
    patch_size: int
    img_size: int
    mlp_ratio: int
    num_classes: int
    input_quant: bool
    ln_eps: float
    quant: Quant

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

    def program_fields(self) -> dict:
        """The fields of the program's ``ViTSpec``."""
        return dict(name=self.name, embed_dim=self.embed_dim,
                    depth=self.depth, num_heads=self.num_heads,
                    patch_size=self.patch_size, img_size=self.img_size,
                    mlp_ratio=self.mlp_ratio, num_classes=self.num_classes,
                    input_quant=self.input_quant, ln_eps=self.ln_eps)


@dataclasses.dataclass(frozen=True)
class Swin:
    name: str
    embed_dim: int
    depths: tuple
    num_heads: tuple
    window: int
    patch_size: int
    img_size: int
    mlp_ratio: int
    num_classes: int
    input_quant: bool
    patch_norm: bool
    ln_eps: float
    quant: Quant

    @property
    def num_layers(self) -> int:
        return len(self.depths)

    @property
    def num_features(self) -> int:
        return self.embed_dim * 2 ** (self.num_layers - 1)

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    def stage_dim(self, s: int) -> int:
        return self.embed_dim * 2**s

    def stage_resolution(self, s: int) -> int:
        return self.grid // 2**s

    def block_window(self, s: int, blk: int) -> tuple[int, int]:
        """(window, shift) of a block: the window shrinks to the
        resolution, and stops shifting, where the resolution is no larger
        than the window."""
        res, ws = self.stage_resolution(s), self.window
        shift = 0 if blk % 2 == 0 else ws // 2
        if res <= ws:
            return res, 0
        return ws, shift

    def program_fields(self) -> dict:
        """The fields of the program's ``SwinSpec``."""
        return dict(name=self.name, embed_dim=self.embed_dim,
                    depths=tuple(self.depths),
                    num_heads=tuple(self.num_heads), window=self.window,
                    patch_size=self.patch_size, img_size=self.img_size,
                    mlp_ratio=self.mlp_ratio, num_classes=self.num_classes,
                    input_quant=self.input_quant,
                    patch_norm=self.patch_norm, ln_eps=self.ln_eps)


def from_config(cfg: dict) -> ViT | Swin:
    """The spec of a configuration file's contents."""
    q = _quant(cfg["quant"])
    if cfg["family"] == "vit":
        return ViT(cfg["name"], cfg["embed_dim"], cfg["depth"],
                   cfg["num_heads"], cfg["patch_size"], cfg["img_size"],
                   cfg["mlp_ratio"], cfg["num_classes"], cfg["input_quant"],
                   float(cfg["ln_eps"]), q)
    if cfg["family"] == "swin":
        return Swin(cfg["name"], cfg["embed_dim"], tuple(cfg["depths"]),
                    tuple(cfg["num_heads"]), cfg["window"],
                    cfg["patch_size"], cfg["img_size"], cfg["mlp_ratio"],
                    cfg["num_classes"], cfg["input_quant"],
                    cfg["patch_norm"], float(cfg["ln_eps"]), q)
    raise ValueError(f"unknown family {cfg['family']!r}")

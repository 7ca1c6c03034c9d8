"""Central quantization configuration (the port's copy of
``diffvit_tpu/config.py``: the same fields, defaults, ``to_dict`` and
``from_dict``, so an artifact's config reads the same in either package).

W defaults to int4 channel-wise with the minmax(+PoT) observer; A to int8
layer-wise; ``lis`` enables Log-Int-Softmax with uint4 log2 quantization;
``ptf`` enables integer LayerNorm with the PTF channel-wise observer on LN
inputs; ``smoothquant`` the SmoothQuant channel factors (off: FQ-ViT).
"""
from __future__ import annotations

import dataclasses

from .ops.bit_types import BIT_TYPE_DICT, BitType


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    ptf: bool = True
    lis: bool = True
    quant_method: str = "minmax"  # observer for plain activation sites

    bit_w: BitType = BIT_TYPE_DICT["int4"]
    bit_a: BitType = BIT_TYPE_DICT["int8"]

    observer_w: str = "minmax"
    calibration_mode_w: str = "channel_wise"
    calibration_mode_a: str = "layer_wise"

    # SmoothQuant search pools
    alpha_pool: tuple = (0.35,)
    mlp_alpha_pool: tuple = (0.5,)
    bit_pool: tuple = (4, 8)

    smoothquant: bool = True

    def __eq__(self, other):
        """Field by field, bit types by name: a config compares equal to
        the JAX package's QuantConfig of the same fields too."""
        if type(other).__name__ != "QuantConfig" \
                or not hasattr(other, "to_dict"):
            return NotImplemented
        return self.to_dict() == other.to_dict()

    def to_dict(self) -> dict:
        """JSON-able form (BitTypes by registry name) — the config half of
        the int-model artifact (engine.save_int_model)."""
        d = dataclasses.asdict(self)
        d["bit_w"] = self.bit_w.name
        d["bit_a"] = self.bit_a.name
        d["alpha_pool"] = list(self.alpha_pool)
        d["mlp_alpha_pool"] = list(self.mlp_alpha_pool)
        d["bit_pool"] = list(self.bit_pool)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "QuantConfig":
        d = dict(d)
        d["bit_w"] = BIT_TYPE_DICT[d["bit_w"]]
        d["bit_a"] = BIT_TYPE_DICT[d["bit_a"]]
        for k in ("alpha_pool", "mlp_alpha_pool", "bit_pool"):
            d[k] = tuple(d[k])
        return cls(**d)

    @property
    def observer_a(self) -> str:
        return self.quant_method

    @property
    def int_softmax(self) -> bool:
        return self.lis

    @property
    def bit_s(self) -> BitType:
        return BIT_TYPE_DICT["uint4"] if self.lis else BIT_TYPE_DICT["uint8"]

    @property
    def int_norm(self) -> bool:
        return self.ptf

    @property
    def observer_a_ln(self) -> str:
        return "ptf" if self.ptf else self.quant_method

    @property
    def calibration_mode_a_ln(self) -> str:
        return "channel_wise" if self.ptf else self.calibration_mode_a

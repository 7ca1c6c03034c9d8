"""Integer bit-type registry (the port's copy of
``diffvit_tpu/ops/bit_types.py``).  A ``BitType`` is a frozen, hashable
value object.

Active set (matching the reference): uint3, uint4, int4, int8, uint8.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BitType:
    bits: int
    signed: bool
    name: str

    @property
    def upper_bound(self) -> int:
        if not self.signed:
            return 2**self.bits - 1
        return 2 ** (self.bits - 1) - 1

    @property
    def lower_bound(self) -> int:
        if not self.signed:
            return 0
        return -(2 ** (self.bits - 1))

    @property
    def range(self) -> int:
        return 2**self.bits


BIT_TYPE_LIST = (
    BitType(3, False, "uint3"),
    BitType(4, False, "uint4"),
    BitType(4, True, "int4"),
    BitType(8, True, "int8"),
    BitType(8, False, "uint8"),
)

BIT_TYPE_DICT = {bt.name: bt for bt in BIT_TYPE_LIST}

# Bit types swept during weight calibration: every type but uint8; int8 is
# calibrated layer-wise, the rest channel-wise.
CALIB_WEIGHT_BIT_TYPES = tuple(bt for bt in BIT_TYPE_LIST
                               if bt.name != "uint8")

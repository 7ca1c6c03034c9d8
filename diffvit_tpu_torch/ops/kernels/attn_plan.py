"""The plan of the tensor-core attention core (``csrc/attention_mma.cuh``)
that K1, K5, K7a and K8 (``attention.py``) and K4/K4b
(``swin_attention.py``) launch, and the layout it keeps its operands in.

* :func:`attention_plan` chooses, for the qkv-attention core, how many
  query tiles of 16 rows a block takes (one warp each), from the batch:
  a block stages its (image, head)'s keys and values once, so fewer,
  fuller blocks stage less, while at b = 1 the 6 (image, head) pairs of
  DeiT-S need their 13 tiles spread over as many blocks as there are to
  keep the SMs busy.
* :func:`swin_attention_plan` chooses how many windows of one head a
  Swin block takes: the head's bias tile is staged once a block, each
  window's keys and values beside it.
* :func:`key_slot` is the order of the keys in the staged V^T rows, and
  :func:`weight_planes` the two u8 planes of a LIS weight, the layout and
  the split that attn@v runs on the tensor cores; the CPU tests hold their
  arithmetic against the plain versions.

The shared-memory sizes here are the kernels' own (``KvGeom``,
``soft_bytes``, ``core_smem``, ``swin_smem``), which refuse a plan that
gives them less.  All of it is plain Python, so the CPU tests reach it;
the kernels run only on the card."""
from __future__ import annotations

import dataclasses
import functools

import torch

from . import require
from .gemm import H100_SMS, SMEM_LIMIT, round_up

SWIN_MAX_WARPS = 8    # warps a Swin block (kSwinWarps)
QKV_MAX_WARPS = 7     # warps a qkv block: three blocks an SM (kQkvWarps)
MIN_WARPS = 4         # warps a qkv block stages its keys and values with
ROWS = 16             # query rows a warp: mma.sync's m16
QKV_MAX_KEYS = 256    # keys a row the qkv core holds (attention.py's MAX_KEYS)
SWIN_MAX_KEYS = 64    # keys a row the Swin core holds
MAX_WINDOWS = 4       # windows of one head a Swin LIS block takes at most
EXP_BYTES = 3088      # the LIS exponential table a block (amma::kExpBytes)
CODE_BYTES = 4096     # a warp's packed int8 scores, qkv core (kCodeBytes)
SWIN_SCORE_BYTES = 4096  # a warp's float scores, Swin core (kScoreBytes)


def key_slot(j: int) -> int:
    """The column of key ``j`` in the staged V^T rows
    (``amma::key_slot``): inside each block of 32 keys, lane t of a quad
    holds keys 2t, 2t+1, 8+2t, 9+2t of each half of the block in its score
    accumulators, and the A fragment of attn@v takes them as its k indices
    4t .. 4t+3."""
    return (j & ~15) + 4 * ((j & 7) >> 1) + 2 * ((j >> 3) & 1) + (j & 1)


def weight_planes(w: torch.Tensor):
    """The two u8 planes (hi, lo) of LIS weights ``w`` = 2^(15 - code) or
    0 (int32): hi = w >> 8, lo = w & 255, each at most 128, so that
    ``256 * (hi @ v) + lo @ v`` is ``w @ v``."""
    return (w >> 8).to(torch.uint8), (w & 255).to(torch.uint8)


def kv_bytes(n_real: int, d: int, lis: bool = True) -> int:
    """Shared memory of one (image or window, head)'s keys and values
    (``amma::KvGeom``): K as keys_pad rows of DP + 16 bytes, V^T as DP rows
    of keys_pad + 16 bytes, and for the float softmax V's own keys_pad rows
    of DP bytes; keys_pad is n_real rounded up to 32, DP is d rounded up to
    32 or 64."""
    keys_pad, dp = round_up(n_real, 32), 32 if d <= 32 else 64
    return keys_pad * (dp + 16) + dp * (keys_pad + 16) \
        + (0 if lis else keys_pad * dp)


def soft_bytes(max_keys: int, value_bytes: int) -> int:
    """A warp's float-softmax buffers (``amma::soft_bytes``): 16 rows of
    ``max_keys`` scores and one row of float weights."""
    return ROWS * max_keys * value_bytes + max_keys * 4


def core_smem(n_real: int, d: int, lis: bool, warps: int) -> int:
    """Dynamic shared memory of the qkv-attention core: the exponential
    table, the keys and values, and each warp's packed scores (the LIS) or
    float-softmax buffers (int8 scores)."""
    return EXP_BYTES + kv_bytes(n_real, d, lis) + warps * (
        CODE_BYTES if lis else soft_bytes(QKV_MAX_KEYS, 1))


def swin_smem(npad: int, n_real: int, d: int, lis: bool, warps: int,
              windows: int) -> int:
    """Dynamic shared memory of the Swin core: the exponential table, the
    head's (npad, npad) float32 bias tile, each window's keys and values,
    and each warp's scores (the LIS) or float-softmax buffers."""
    return EXP_BYTES + round_up(npad * npad * 4, 16) \
        + windows * kv_bytes(n_real, d, lis) + warps * (
            SWIN_SCORE_BYTES if lis else soft_bytes(SWIN_MAX_KEYS, 4))


@dataclasses.dataclass(frozen=True)
class AttnPlan:
    """``split`` blocks an (image, head), each ``tiles`` query tiles of 16
    rows on ``warps`` warps (one tile a warp; the warps past ``tiles``
    only stage), ``smem`` bytes of dynamic shared memory, ``grid`` blocks
    in all."""
    warps: int
    tiles: int
    split: int
    smem: int
    grid: int

    def launch_args(self) -> tuple[int, ...]:
        """The numbers the C entries take, in their order."""
        return (self.warps, self.tiles, self.split, self.smem)


@functools.lru_cache(maxsize=4096)
def attention_plan(batch: int, heads: int, npad: int, d: int, n_real: int,
                   lis: bool = True, sms: int = H100_SMS) -> AttnPlan:
    """The qkv-attention core's blocks for ``batch`` images of ``heads``
    heads of ``npad`` query rows, head width ``d`` and ``n_real`` keys.

    A block takes one (image, head) and up to ``QKV_MAX_WARPS`` consecutive
    query tiles, one a warp, on at least ``MIN_WARPS`` warps: the staging
    of its keys and values, done by all of them, is most of a one-tile
    block's time.  The blocks an (image, head) are as few as fill ``sms``
    SMs with at least one block each (DeiT-S at b = 64: 384 pairs, 2 blocks
    of 7 tiles each; at b = 8: 48 pairs, 3 blocks of 5), and at b = 1 as
    many as there are tiles (6 pairs of 13 tiles: 78 blocks of one warp,
    every tile its own block, four warps of which one computes)."""
    require(batch > 0 and heads > 0 and npad > 0,
            f"empty attention: batch {batch}, heads {heads}, npad {npad}")
    require(0 < n_real <= min(npad, QKV_MAX_KEYS),
            f"n_real={n_real}: the core takes 1..min(npad, {QKV_MAX_KEYS})")
    require(d <= 64 and d % 4 == 0,
            f"head_dim={d}: the core takes multiples of 4 up to 64")
    q_tiles = -(-npad // ROWS)
    pairs = batch * heads
    tiles = -(-q_tiles // -(-q_tiles // QKV_MAX_WARPS))  # even runs of <= 7
    while tiles > 1 and pairs * -(-q_tiles // tiles) < sms:
        tiles -= 1
    split = -(-q_tiles // tiles)
    if -(-q_tiles // -(-q_tiles // split)) == split:
        tiles = -(-q_tiles // split)  # the same blocks, tiles spread evenly
    warps = max(tiles, MIN_WARPS)  # warps past the tiles only stage
    smem = core_smem(n_real, d, lis, warps)
    return AttnPlan(warps=warps, tiles=tiles, split=split, smem=smem,
                    grid=pairs * split)


@dataclasses.dataclass(frozen=True)
class SwinPlan:
    """Blocks of ``windows`` windows of one head (the last may take fewer)
    on ``warps`` warps, ``smem`` bytes of dynamic shared memory, ``grid``
    blocks in all."""
    warps: int
    windows: int
    smem: int
    grid: int

    def launch_args(self) -> tuple[int, ...]:
        return (self.warps, self.windows, self.smem)


@functools.lru_cache(maxsize=4096)
def swin_attention_plan(windows: int, heads: int, npad: int, d: int,
                        n_real: int, lis: bool = True,
                        sms: int = H100_SMS) -> SwinPlan:
    """The Swin core's blocks for ``windows`` windows of ``heads`` heads.

    A block takes up to ``MAX_WINDOWS`` consecutive windows of one head,
    as many as keep two blocks an SM in the grid (Swin-T stage 0 at b = 64:
    12,288 window-heads, 4 windows a block, 3,072 blocks; at b = 1 one
    window a block), and fewer where the shared memory would not hold
    them; a warp takes one (window, query tile) at a time.  The float
    softmax takes one window a block: its rows are SIMT chains that want
    more blocks an SM more than the bias tile wants sharing (the LIS runs
    as fast at one window a block as at four)."""
    require(windows > 0 and heads > 0 and npad > 0,
            f"empty attention: {windows} windows, {heads} heads, npad {npad}")
    require(0 < n_real <= min(npad, SWIN_MAX_KEYS),
            f"n_real={n_real}: the core takes 1..min(npad, {SWIN_MAX_KEYS})")
    require(d <= 64 and d % 4 == 0,
            f"head_dim={d}: the core takes multiples of 4 up to 64")
    q_tiles = -(-npad // ROWS)
    cap = MAX_WINDOWS if lis else 1
    wpb = max(1, min(cap, windows, windows * heads // (2 * sms)))
    while True:
        warps = min(SWIN_MAX_WARPS, wpb * q_tiles)
        smem = swin_smem(npad, n_real, d, lis, warps, wpb)
        if smem <= SMEM_LIMIT or wpb == 1:
            break
        wpb -= 1
    require(smem <= SMEM_LIMIT,
            f"npad={npad}: the bias tile and one window's keys take {smem} "
            f"bytes of shared memory, more than {SMEM_LIMIT}")
    return SwinPlan(warps=warps, windows=wpb, smem=smem,
                    grid=-(-windows // wpb) * heads)

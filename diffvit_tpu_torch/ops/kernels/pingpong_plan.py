"""The plans of probe P1's three kernels (``csrc/probes/pingpong.cu``):
the producer (the per-head qkv GEMM and the scores), the consumer (K1's
core on loaded scores) and paired, the two as warp roles of one
persistent launch.

* :func:`producer_plan`: blocks of 384 threads (warpgroup 0 issues TMA,
  warpgroups 1 and 2 run ``wgmma``, the epilogue and the scores), one an
  SM, walking the (image, head) items; the ring's stages and the shared
  memory (the ring, its epilogue staging, the head's q | k | v rows).
* :func:`consumer_plan`: K1's attention plan (``attn_plan.attention_plan``:
  query tiles a block, blocks an (image, head), warps), with the shared
  memory of a core that stages V^T and no keys.
* :func:`paired_plan`: blocks of 896 threads, one an SM, in three roles
  (:class:`Role`), each with ``setmaxnreg``'s registers a thread: the TMA
  warpgroup, the two ``wgmma`` warpgroups and four consumer warpgroups, and
  the two item lists each block walks (:meth:`PairedPlan.producer_list`,
  :meth:`PairedPlan.consumer_list`).

The byte counts are the kernel's own (``head_pitch``, ``producer_smem``,
``consumer_smem``), which refuse a plan that gives them less.  All of it
is plain Python, so the CPU tests reach it; the kernels run only on the
card."""
from __future__ import annotations

import dataclasses
import functools

from . import require
from .attn_plan import CODE_BYTES, EXP_BYTES, attention_plan
from .gemm import H100_SMS, SMEM_LIMIT, round_up, smem_bytes

BM, BN = 128, 64            # the producer's GEMM tile (kBM, kBN)
PRODUCER_THREADS = 384      # a TMA warpgroup and two wgmma warpgroups
CONSUMER_MAX_WARPS = 7      # a consumer block at most (kConsumerWarps)
PAIRED_ATTN_WARPS = 16      # paired's consumer warps (kAttnThreads / 32)
REGISTERS = 65_536          # the register file of an SM
STAGES = (4, 3, 2)          # the ring's stages, the most that fit first
MAX_KEYS = 256


@dataclasses.dataclass(frozen=True)
class Role:
    """``warps`` warps that ``setmaxnreg`` gives ``registers`` registers a
    thread."""
    name: str
    warps: int
    registers: int


# setmaxnreg's moves (pingpong.cu's kTmaRegs, kMmaRegs; kPaired*Regs: the
# consumer warps keep the launch's 72)
PRODUCER_ROLES = (Role("tma", 4, 40), Role("mma", 8, 232))
PAIRED_ROLES = (Role("tma", 4, 24), Role("mma", 8, 96),
                Role("attention", PAIRED_ATTN_WARPS, 72))


def launch_registers(threads: int) -> int:
    """Registers a thread at launch for one block of ``threads`` threads an
    SM: the register file shared out in whole multiples of 8."""
    return REGISTERS // threads // 8 * 8


def head_pitch(d: int) -> int:
    """Bytes between rows of the producer's head buffer (q | k | v, 3D
    bytes), rounded up to an odd multiple of 16 (conflict-free fragment
    loads)."""
    ld = round_up(3 * d, 16)
    return ld if (ld // 16) % 2 else ld + 16


def head_bytes(npad: int, d: int) -> int:
    """The head buffer: Npad rows rounded up to 16, and 64 bytes of slack
    for the last rows' key fragments."""
    return round_up(npad, 16) * head_pitch(d) + 64


def producer_smem(npad: int, d: int, stages: int) -> int:
    """The producer's dynamic shared memory: the GEMM ring with its
    epilogue staging (``gemm.smem_bytes``), then the head buffer."""
    return smem_bytes(BM, BN, stages) + head_bytes(npad, d)


def consumer_smem(n_real: int, d: int, warps: int) -> int:
    """A consumer's: the exponential table, V^T (DP rows of keys_pad + 16
    bytes) and each warp's packed scores."""
    dp = 32 if d <= 32 else 64
    return EXP_BYTES + dp * (round_up(n_real, 32) + 16) + warps * CODE_BYTES


def _check(batch, heads, npad, d, n_real):
    require(batch > 0 and heads > 0,
            f"empty probe: batch {batch}, heads {heads}")
    require(0 < n_real <= npad <= MAX_KEYS,
            f"n_real={n_real}, Npad={npad}: the kernels take "
            f"n_real <= Npad <= {MAX_KEYS}")
    require(0 < d <= 64 and d % 4 == 0,
            f"head_dim={d}: the kernels take multiples of 4 up to 64")


@dataclasses.dataclass(frozen=True)
class ProducerPlan:
    """A persistent grid of ``grid`` blocks over ``items`` (image, head)
    items, a ring of ``stages`` stages, ``smem`` bytes of dynamic shared
    memory."""
    stages: int
    smem: int
    grid: int
    items: int
    threads: int = PRODUCER_THREADS
    roles: tuple = PRODUCER_ROLES

    def launch_args(self) -> tuple[int, ...]:
        return (self.stages, self.smem, self.grid)


@functools.lru_cache(maxsize=1024)
def producer_plan(batch: int, heads: int, npad: int, d: int,
                  sms: int = H100_SMS) -> ProducerPlan:
    """One block an SM (the ring, its staging and the head buffer take
    most of the shared memory), as many stages as fit up to 4."""
    _check(batch, heads, npad, d, npad)
    stages = next(s for s in STAGES
                  if producer_smem(npad, d, s) <= SMEM_LIMIT)
    items = batch * heads
    return ProducerPlan(stages=stages, smem=producer_smem(npad, d, stages),
                        grid=min(items, sms), items=items)


@dataclasses.dataclass(frozen=True)
class ConsumerPlan:
    """K1's core plan on loaded scores: ``split`` blocks an (image, head)
    of ``tiles`` query tiles of 16 rows on ``warps`` warps, ``smem`` bytes,
    one block an item, ``grid`` = ``items`` blocks."""
    warps: int
    tiles: int
    split: int
    smem: int
    grid: int

    @property
    def items(self) -> int:
        return self.grid

    def launch_args(self) -> tuple[int, ...]:
        return (self.warps, self.tiles, self.split, self.smem)


@functools.lru_cache(maxsize=1024)
def consumer_plan(batch: int, heads: int, npad: int, d: int, n_real: int,
                  sms: int = H100_SMS) -> ConsumerPlan:
    """K1's tiles, split and warps for these shapes
    (``attn_plan.attention_plan``), with the shared memory of a core that
    keeps V^T and no keys."""
    _check(batch, heads, npad, d, n_real)
    ap = attention_plan(batch, heads, npad, d, n_real, True, sms)
    return ConsumerPlan(warps=ap.warps, tiles=ap.tiles, split=ap.split,
                        smem=consumer_smem(n_real, d, ap.warps),
                        grid=ap.grid)


@dataclasses.dataclass(frozen=True)
class PairedPlan:
    """One block an SM of ``threads`` threads in ``roles``; the producer's
    ring of ``stages`` stages and head buffer in the first
    ``attn_offset`` bytes of the ``smem`` bytes, the consumer's table,
    V^T and scratch after them; ``grid`` persistent blocks over
    ``producer_items`` (image, head) items and ``consumer_items`` items
    of ``consumer``'s tiles and split (its ``smem`` the consumer's part,
    its ``grid`` the item count)."""
    stages: int
    smem: int
    attn_offset: int
    grid: int
    producer_items: int
    consumer: ConsumerPlan
    threads: int = PRODUCER_THREADS + 32 * PAIRED_ATTN_WARPS
    roles: tuple = PAIRED_ROLES

    @property
    def consumer_items(self) -> int:
        return self.consumer.items

    def producer_list(self, block: int) -> range:
        """The producer items block ``block`` takes, in order."""
        return range(block, self.producer_items, self.grid)

    def consumer_list(self, block: int) -> range:
        """The consumer items block ``block`` takes, in order."""
        return range(block, self.consumer_items, self.grid)

    def launch_args(self) -> tuple[int, ...]:
        return (self.stages, self.smem, self.grid, self.consumer.tiles,
                self.consumer.split)


def paired_consumer_split(batch: int, heads: int, npad: int,
                          sms: int = H100_SMS) -> tuple[int, int]:
    """(tiles, split) of paired's consumer items: attention_plan's rule on
    PAIRED_ATTN_WARPS warps, one query tile a warp: as many tiles an item
    as leave every SM an item, spread evenly (DeiT-S at B = 128: one item
    of 13 tiles an (image, head); at B = 1: 78 items of one)."""
    q_tiles = -(-npad // 16)
    pairs = batch * heads
    tiles = -(-q_tiles // -(-q_tiles // PAIRED_ATTN_WARPS))
    while tiles > 1 and pairs * -(-q_tiles // tiles) < sms:
        tiles -= 1
    split = -(-q_tiles // tiles)
    return -(-q_tiles // split), split


@functools.lru_cache(maxsize=1024)
def paired_plan(batch: int, heads: int, npad: int, d: int, n_real: int,
                sms: int = H100_SMS) -> PairedPlan:
    """The producer's and the consumer's roles in one block an SM: the
    consumer's items are (image, head, run of up to 16 query tiles), on 16
    warps (:func:`paired_consumer_split`); the ring takes as many stages
    (up to 4) as the shared memory leaves; the grid is the SMs, or fewer
    where neither role has as many items."""
    _check(batch, heads, npad, d, n_real)
    tiles, split = paired_consumer_split(batch, heads, npad, sms)
    attn = consumer_smem(n_real, d, PAIRED_ATTN_WARPS)
    cons = ConsumerPlan(warps=PAIRED_ATTN_WARPS, tiles=tiles, split=split,
                        smem=attn, grid=batch * heads * split)
    fits = [s for s in STAGES
            if producer_smem(npad, d, s) + attn <= SMEM_LIMIT]
    require(fits, f"Npad={npad}, D={d}: the paired roles take more than "
            f"{SMEM_LIMIT} bytes of shared memory")
    stages = fits[0]
    offset = producer_smem(npad, d, stages)
    items = batch * heads
    return PairedPlan(stages=stages, smem=offset + attn, attn_offset=offset,
                      grid=min(sms, max(items, cons.items)),
                      producer_items=items, consumer=cons)

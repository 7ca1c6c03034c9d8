"""The plans of probes P2 (``csrc/probes/overlap.cu``) and P3
(``csrc/probes/overlap_mlp.cu``): the tile, the ring's stages, the shared
memory, the persistent grid and ``setmaxnreg``'s register split of each
kernel, which the C entries take.

* :func:`overlap_plan`: P2's bf16 ``wgmma`` kernel, 128 x 64 output tiles
  (the two consumer warpgroups 64 rows each), 64 K a stage, two blocks an
  SM.
* :func:`mlp_plans`: P3's fc1 and fc2 plans by mode.  ``dot``, ``input``
  and ``nogelu`` run K2's kernel with K2's plan (``gemm.gemm_plan``);
  ``pipelined`` a 128 x 64 tile shared as K2 shares it, one block an SM
  with a ring deep enough for two tiles' stages; ``staged`` 64 x 64 tiles
  that the consumer warpgroups take in turn (ping-pong), two blocks an SM
  as K2.
  fc2 is K2's in every mode.

:meth:`TilePlan.regions` says which output rows and columns each consumer
warpgroup of a block writes, as the kernel walks them.  A stage of either
probe is 128 bytes of K, so the shared memory is ``gemm.smem_bytes``'s
(the ring, its barriers and the epilogue's staging).  All of it is plain
Python, so the CPU tests reach it; the kernels run only on the card."""
from __future__ import annotations

import dataclasses
import functools

from . import require
from .gemm import (BK, H100_SMS, MAX_STAGES, SMEM_LIMIT, gemm_plan, round_up,
                   smem_bytes)
from .pingpong_plan import Role, launch_registers

THREADS = 384            # a producer warpgroup, two consumer warpgroups
SM_SMEM = 233_472        # shared memory of an SM (228 KB)
BLOCK_RESERVED = 1024    # the shared memory the card keeps a block
# setmaxnreg's registers a thread by blocks an SM (wg::kProducerRegs,
# wg::kConsumerRegs): what __launch_bounds__(384, B) leaves, moved from the
# producer warpgroup to the consumers
ROLES = {1: (Role("tma", 4, 40), Role("mma", 8, 232)),
         2: (Role("tma", 4, 24), Role("mma", 8, 104))}

# P2
P2_BM, P2_BN = 128, 64
P2_K_STAGE = BK // 2     # bf16 K a stage: one 128-byte swizzle row
BLOCKS = 2               # P2's blocks an SM (overlap.cu's kBlocks): K2's
P2_STAGES = 3            # the most stages that fit two blocks

# P3
MLP_MODES = ("dot", "input", "nogelu", "pipelined", "staged")
OWN_TILES = {"pipelined": (128, 64), "staged": (64, 64)}
# pipelined: one block an SM (its two accumulator sets and the GELU
# epilogue spill at two blocks' 104 registers), whose 7 stages hold two
# tiles' up to K = 384 (past 7 stages' K the kernel releases a tile's
# stages as its products retire); staged: K2's two blocks an SM and 4
# stages, so that it differs from dot in the schedule alone
OWN_BLOCKS = {"pipelined": 1, "staged": 2}


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Output tiles of ``bm`` x ``bn`` over an (m, n) output, ``blocks``
    blocks an SM, ``stages`` ring stages, ``smem`` bytes of dynamic shared
    memory, a persistent grid of ``grid`` blocks over ``tiles`` tiles (n
    fastest).  ``pingpong``: each consumer warpgroup takes whole tiles in
    turn; otherwise the two share each tile (64 rows each at bm = 128, half
    the columns each at bm = 64)."""
    m: int
    n: int
    bm: int
    bn: int
    blocks: int
    stages: int
    smem: int
    grid: int
    tiles: int
    pingpong: bool = False
    threads: int = THREADS

    @property
    def roles(self) -> tuple:
        return ROLES[self.blocks]

    def launch_args(self) -> tuple[int, ...]:
        """The numbers the C entries take, in their order."""
        return (self.bm, self.bn, self.blocks, self.stages, self.smem,
                self.grid)

    def tiles_of(self, block: int, consumer: int) -> range:
        """The tiles consumer warpgroup ``consumer`` of block ``block``
        works on, in order."""
        if self.pingpong:
            return range(block + consumer * self.grid, self.tiles,
                         2 * self.grid)
        return range(block, self.tiles, self.grid)

    def regions(self, block: int, consumer: int):
        """(row0, col0, rows, cols) of each output region the consumer
        writes, in the padded extent of whole tiles (the kernel masks what
        lies past m and n)."""
        tiles_n = -(-self.n // self.bn)
        out = []
        for tile in self.tiles_of(block, consumer):
            m0, n0 = tile // tiles_n * self.bm, tile % tiles_n * self.bn
            if self.pingpong:
                out.append((m0, n0, self.bm, self.bn))
            elif self.bm == 128:
                out.append((m0 + 64 * consumer, n0, 64, self.bn))
            else:  # bm = 64: half the columns each (gemm_tiles)
                half = self.bn // 2
                out.append((m0, n0 + half * consumer, self.bm, half))
        return out


def fits(plan: TilePlan) -> bool:
    """Whether ``plan.blocks`` blocks of ``plan.smem`` bytes fit an SM's
    shared memory, each within a block's limit."""
    return plan.smem <= SMEM_LIMIT and \
        plan.blocks * (plan.smem + BLOCK_RESERVED) <= SM_SMEM


def _tile_plan(m, n, bm, bn, blocks, stages, sms, pingpong=False):
    tiles = -(-m // bm) * -(-n // bn)
    return TilePlan(m=m, n=n, bm=bm, bn=bn, blocks=blocks, stages=stages,
                    smem=smem_bytes(bm, bn, stages),
                    grid=min(tiles, blocks * sms), tiles=tiles,
                    pingpong=pingpong)


@functools.lru_cache(maxsize=1024)
def overlap_plan(m: int, n: int, k: int, sms: int = H100_SMS) -> TilePlan:
    """P2's plan for y = a (m, k) @ b (k, n): 128 x 64 tiles, two blocks an
    SM as K2 (104 registers a consumer thread hold the 32 accumulators and
    32 elements of v or of the chain) and the most stages that fit.
    Refuses what the kernel does not take: m and n multiples of 64, k of
    32."""
    require(m > 0 and n > 0 and m % 64 == 0 and n % 64 == 0 and k >= 0
            and k % 32 == 0,
            f"M={m} and N={n} must be positive multiples of 64, K={k} a "
            "multiple of 32")
    return _tile_plan(m, n, P2_BM, P2_BN, BLOCKS, P2_STAGES, sms)


def _own_plan(rows, n, mode, sms, blocks):
    """pipelined's or staged's fc1 plan: ``blocks`` blocks an SM and the
    most stages that fit them."""
    bm, bn = OWN_TILES[mode]
    stages = max(s for s in range(2, MAX_STAGES + 1) if fits(_tile_plan(
        rows, n, bm, bn, blocks, s, sms)))
    return _tile_plan(rows, n, bm, bn, blocks, stages, sms,
                      pingpong=mode == "staged")


@functools.lru_cache(maxsize=1024)
def mlp_plans(rows: int, cin: int, hid: int, mode: str,
              sms: int = H100_SMS, blocks: int | None = None
              ) -> tuple[TilePlan, TilePlan]:
    """P3's (fc1, fc2) plans for ``rows`` rows, Cin -> Hid -> Cin, in mode
    ``mode``; fc1 reads K = Cin and fc2 K = Hid, each rounded up to 16
    bytes (``gemm.kmajor``).  ``blocks`` (1 or 2) sets pipelined's or
    staged's fc1 blocks an SM in place of OWN_BLOCKS[mode] (a sweep's
    choice).  Refuses what the kernels do not take: rows > 0, Cin and Hid
    multiples of 32, Hid >= Cin, a known mode."""
    require(mode in MLP_MODES, f"unknown mode {mode!r}")
    require(blocks is None or (mode in OWN_TILES and blocks in (1, 2)),
            f"blocks={blocks} is for pipelined and staged, 1 or 2")
    require(rows > 0 and cin > 0 and hid > 0 and cin % 32 == 0
            and hid % 32 == 0 and hid >= cin,
            f"rows={rows} must be positive, Cin={cin} and Hid={hid} "
            "multiples of 32 with Hid >= Cin")
    cin_p, hid_p = round_up(cin, 16), round_up(hid, 16)

    def k2(m, n, k):
        p = gemm_plan(m, n, k, sms)
        return TilePlan(m=m, n=n, bm=p.bm, bn=p.bn, blocks=p.blocks,
                        stages=p.stages, smem=p.smem, grid=p.grid,
                        tiles=p.tiles)

    fc1 = _own_plan(rows, hid, mode, sms, blocks or OWN_BLOCKS[mode]) \
        if mode in OWN_TILES else k2(rows, hid, cin_p)
    return fc1, k2(rows, cin, hid_p)


def register_split_ok(plan: TilePlan) -> bool:
    """setmaxnreg's rules for the plan's roles: multiples of 8 within
    24-256, and the roles' registers within what the launch gives
    ``plan.blocks`` blocks of ``plan.threads`` threads."""
    launch = launch_registers(plan.threads * plan.blocks)
    return all(r.registers % 8 == 0 and 24 <= r.registers <= 256
               for r in plan.roles) and \
        sum(32 * r.warps * r.registers for r in plan.roles) \
        <= launch * plan.threads and \
        sum(r.warps for r in plan.roles) * 32 == plan.threads

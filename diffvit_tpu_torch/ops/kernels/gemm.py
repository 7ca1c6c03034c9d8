"""The Python side of the Hopper int8 GEMM mainloop (``csrc/wgmma_gemm.cuh``)
that K2 (``mlp.fused_int_mlp``) and K3 (``linear.fused_int_linear``) run on.

* :func:`kmajor` keeps one K-major ``(N, Kp)`` int8 copy of each ``(K, N)``
  weight: ``wgmma`` takes int8 operands only K-major, and TMA wants every
  row stride a multiple of 16 bytes, so Kp rounds K up to 16 with zero
  columns.  The copy is made once per weight tensor (and again after an
  in-place write to it), as ``models/convert.py`` computes its other
  per-block constants once; ``kmajor.copies`` counts the copies made.
* :func:`pad_k` pads an activation's K with zero columns to the same Kp;
  zeros add nothing to an integer sum, so the product is unchanged.
* :func:`tma_operand_error` is TMA's rule for an operand (a 16-byte
  aligned base, 16-byte multiple row strides), as a plain function of the
  pointer and the strides.
* :func:`gemm_plan` chooses the tile, the stage count, the shared memory
  and the grid from the shape; the C entries take its numbers.
* :func:`per_weight` keeps what a wrapper derives from its per-channel
  arguments (the epilogue vectors), on the same terms as :func:`kmajor`,
  so that a call on a model's constants launches no small kernels for
  them.

All of it is plain Python and PyTorch, so the CPU tests reach it; the
kernel itself runs only on the card."""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref

import torch

from . import require
from .build import check

BK = 128                # K bytes a stage: one 128-byte swizzle row
MAX_STAGES = 8          # the kernel's barrier slots (wg::kMaxStages)
STAGES = 4              # the ring at one block an SM
SMEM_LIMIT = 232_448    # bytes of shared memory a block can use (H100)
H100_SMS = 132
TMA_ALIGN = 16          # TMA: base and row strides in multiples of 16 bytes


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


STAGING_PITCH = 128 + 16  # bytes a row of a consumer's epilogue staging tile


def smem_bytes(bm: int, bn: int, stages: int) -> int:
    """Dynamic shared memory of a plan (``wg::smem_bytes``): 1024 bytes of
    alignment slack, the A and W stages, the barriers and the two
    consumers' two 64-row epilogue staging buffers each."""
    return 1024 + stages * (bm + bn) * BK + 2 * MAX_STAGES * 8 \
        + 4 * 64 * STAGING_PITCH


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """A tile of ``bm`` x ``bn`` outputs, ``blocks`` blocks an SM,
    ``stages`` shared-memory stages of ``bk`` K bytes, ``smem`` bytes of
    dynamic shared memory, and a persistent grid of ``grid`` blocks over
    ``tiles`` output tiles."""
    bm: int
    bn: int
    blocks: int
    bk: int
    stages: int
    smem: int
    grid: int
    tiles: int

    def launch_args(self) -> tuple[int, ...]:
        """The numbers the C entries take, in their order."""
        return (self.bm, self.bn, self.blocks, self.stages, self.smem,
                self.grid)


@functools.lru_cache(maxsize=4096)
def gemm_plan(m: int, n: int, k: int, sms: int = H100_SMS) -> GemmPlan:
    """The tile for C[m, n] = A[m, k] @ W[k, n] on a card of ``sms`` SMs.

    Past 256 rows: 128 x 64 tiles, two blocks an SM, 3 stages.  Two blocks
    give the epilogue 16 consumer warps an SM to hide its latency, and one
    block's epilogue overlaps the other's products; on an H100 this beat
    one block of 128 x 128 or 128 x 64 tiles at every b = 64 site of K2
    and K3 (PERF.md; ``scripts/port_gemm.py``).  The 80 registers a thread
    that two blocks leave hold a consumer's 32 accumulators of a 64-wide
    tile, and 3 stages keep each block within half the shared memory.

    Up to 256 rows (the b = 1 sites, where a 128-row tile leaves most SMs
    idle): 64-row tiles, one block an SM, ``STAGES`` stages; BN = 128 where
    that still gives every SM a tile, else 64.  One block a tile at most."""
    require(m > 0 and n > 0 and k > 0, f"empty GEMM {m} x {k} x {n}")
    if m > 256:
        bm, bn, blocks, stages = 128, 64, 2, 3
    else:
        bm, blocks, stages = 64, 1, STAGES
        bn = 128 if n > 64 and -(-n // 128) * -(-m // 64) >= sms else 64
    tiles = -(-m // bm) * -(-n // bn)
    return GemmPlan(bm=bm, bn=bn, blocks=blocks, bk=BK, stages=stages,
                    smem=smem_bytes(bm, bn, stages),
                    grid=min(tiles, blocks * sms), tiles=tiles)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SM count of the card ``device``."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _sm_count(index)


def device_plan(m: int, n: int, k: int, device: torch.device) -> GemmPlan:
    """:func:`gemm_plan` for the SM count of the card ``device``."""
    return gemm_plan(m, n, k, sm_count(device))


def gemm_footprint(entry, plan: GemmPlan, *lead: int) -> dict:
    """{"registers", "smem_bytes", "blocks_per_sm"} of the kernel for
    ``plan``'s tile from a C entry ``entry(*lead, bm, bn, blocks, smem,
    &registers, &smem_bytes, &blocks_per_sm)`` (``cudaFuncGetAttributes``
    and the occupancy API).  Needs a card."""
    out = [ctypes.c_int() for _ in range(3)]
    check(entry(*lead, plan.bm, plan.bn, plan.blocks, plan.smem,
                *map(ctypes.byref, out)), entry.__name__)
    return dict(zip(("registers", "smem_bytes", "blocks_per_sm"),
                    (o.value for o in out)))


def tma_operand_error(ptr: int, row_strides_bytes) -> str | None:
    """Why TMA cannot read an operand at address ``ptr`` whose rows are
    ``row_strides_bytes`` apart (every stride but the innermost), or None
    where it can."""
    if ptr % TMA_ALIGN:
        return f"base address {ptr:#x} is not {TMA_ALIGN}-byte aligned"
    bad = [s for s in row_strides_bytes if s % TMA_ALIGN]
    if bad:
        return f"row stride {bad[0]} bytes is not a multiple of {TMA_ALIGN}"
    return None


def require_tma_operand(t: torch.Tensor, name: str) -> None:
    """Raise ``ValueError`` where TMA cannot read the 2-D tensor ``t``."""
    err = tma_operand_error(t.data_ptr(), [t.stride(0) * t.element_size()])
    require(err is None, f"{name}: {err}")


def pad_k(x: torch.Tensor, kp: int) -> torch.Tensor:
    """``x`` (R, K) with zero columns up to ``kp``; ``x`` itself where K is
    already ``kp``."""
    k = x.shape[1]
    if k == kp:
        return x
    out = torch.zeros((x.shape[0], kp), dtype=x.dtype, device=x.device)
    out[:, :k] = x
    return out


def _version(t):
    return None if t.is_inference() else t._version


class _PerTensor:
    """Values kept per live tensor: a dict keyed by ``id(t)``, each entry
    holding a weak reference to ``t`` that drops the entry when ``t`` is
    freed (so a later tensor that reuses the id never finds it)."""

    def __init__(self):
        self._d = {}

    def get(self, t):
        hit = self._d.get(id(t))
        return hit[1] if hit is not None and hit[0]() is t else None

    def put(self, t, value):
        key = id(t)
        d = self._d
        d[key] = (weakref.ref(t, lambda _, key=key: d.pop(key, None)), value)


_KMAJOR = _PerTensor()


def kmajor(w: torch.Tensor) -> torch.Tensor:
    """The contiguous (N, Kp) copy of the (K, N) weight ``w``, K zero-padded
    to a multiple of 16.  Made once per weight tensor and kept while ``w``
    lives; made anew after an in-place write to ``w`` (its ``_version``
    moved).  An inference tensor tracks no version: its copy is kept as
    made."""
    version = _version(w)
    hit = _KMAJOR.get(w)
    if hit is not None and hit[0] == version:
        return hit[1]
    k, n = w.shape
    out = torch.zeros((n, round_up(k, TMA_ALIGN)), dtype=w.dtype,
                      device=w.device)
    out[:, :k] = w.t()
    _KMAJOR.put(w, (version, out))
    kmajor.copies += 1
    return out


kmajor.copies = 0


_PER_WEIGHT = _PerTensor()


def per_weight(make, *parts):
    """``make()``, kept for these ``parts`` (tensors, compared by identity
    and version, and plain values, by equality) while the first tensor
    among them lives; made anew when any of them differs or was written in
    place.  ``make`` returns new tensors, none of the parts itself.
    ``per_weight.misses`` counts the values made."""
    key = next(p for p in parts if isinstance(p, torch.Tensor))
    state = tuple(_version(p) if isinstance(p, torch.Tensor) else p
                  for p in parts)
    # the entry holds the other tensors, never the key (nor may the value:
    # make() returns new tensors), so that it dies with the key
    others = tuple(None if p is key else p for p in parts)
    hit = _PER_WEIGHT.get(key)
    if hit is not None and hit[1] == state and all(
            (b is key) if a is None else (a is b)
            for a, b in zip(hit[0], parts)
            if isinstance(b, torch.Tensor)):
        return hit[2]
    value = make()
    _PER_WEIGHT.put(key, (others, state, value))
    per_weight.misses += 1
    return value


per_weight.misses = 0

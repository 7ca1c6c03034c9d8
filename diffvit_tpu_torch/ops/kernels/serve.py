"""The resident whole-encoder serving kernel, K6 (counterpart of
``diffvit_tpu/ops/pallas/serve.py``: ``prepare_resident``,
``resident_codes``, ``_serve_kernel`` and ``_ln_emit``).

Every encoder block of a ViT runs in one launch, on the int8 codes of the
residual stream; per block, op for op the integer codes path of
``models/vit_int._block_int``:

    int LN1 -> qkv GEMM + qact1 requant -> per-head scores -> LIS (or the
    float softmax) -> attn@v -> qact2 -> proj (int32 over the heads) ->
    qact3 / residual / qact2 fences -> int LN2 (norm2 rescale quirk) ->
    fc1 -> poly GELU -> qact1 -> fc2 -> qact2 codes -> residual / qact4

The one difference from the codes path is the LayerNorm's std floor of
``_ln_emit`` (``serve.py:100``): a row whose codes are all equal (std 0)
gets finite codes here, NaN there.  Real rows of random or calibrated
inputs have no such row, so there the codes equal the codes path's.

``prepare_resident`` stacks the per-layer weights and constants of a
converted int-model (``models/convert.int_model_from_numpy``) on its
device, in the JAX package's layout.  The float32 constants are computed
on the host in numpy, in the reference's order (CUDA torch takes ``1 / t``
and a division by a Python number through a reciprocal).

The CUDA kernel is ``csrc/resident.cu``; :func:`resident_codes_plain` is
its exact specification, built from the port's plain pieces
(:func:`~.attention.attention_core_plain`, ``ops/int_layernorm.ln_codes``,
:func:`~.mlp.gelu_poly`, ``int_matmul``).  The kernel runs its GEMM steps
on ``wgmma_gemm.cuh``'s mainloop and its attention on
``attention_mma.cuh``'s core; what it needs from the Python side is here
and plain: :func:`resident_plan` (blocks an SM, ring stages, shared
memory, grid, the attention split), :func:`resident_kmajor` (the K-major
weight stacks its
TMA maps read), :func:`scratch_layout`, and :func:`step_times`, which
turns the kernel's barrier stamps (:func:`resident_step_ms`) into time by
step kind.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..int_layernorm import ln_codes
from ..quant import int_matmul
from . import check_for_kernel, require, route
from .attention import MAX_KEYS, attention_core_plain, lis_code
from .attn_plan import (CODE_BYTES, EXP_BYTES, attention_plan, kv_bytes,
                        soft_bytes)
from .build import check, load_library
from .gemm import (BK, H100_SMS, MAX_STAGES, SMEM_LIMIT, per_weight,
                   sm_count, smem_bytes, tma_operand_error)
from .mlp import gelu_poly

# vec slots (per layer, C-wide float32; serve.py:59-75)
(V_IN_SCALE, V_LN1_MASK, V_LN1_W, V_LN1_B, V_LN1_OUT, V_PROJ_MULT, V_PROJ_B,
 V_S3, V_SBLK2, V_LN2_MASK, V_LN2_W, V_LN2_B, V_LN2_OUT, V_LN2_RESCALE,
 V_S4) = range(15)
# scal slots (per layer, float32; serve.py:77-84)
S_SA, S_C1, S_S1_OVER_S2, S_M1_INV, S_LN1_MIN, S_LN2_MIN = range(6)
STD_FLOOR = float(np.float32(1e-37))  # _ln_emit's floor, as float32
# prepare_resident's tensors, in the C entry's order (the four weights go
# to the kernel as their K-major stacks, resident_kmajor)
PACKED = ("wqkv", "wproj", "w1", "w2", "mb", "vec", "vhid", "vout", "scal")
WEIGHTS = PACKED[:4]

THREADS = 288          # K6's block: two consumer warpgroups and a producer warp
WARPS = THREADS // 32  # the LN steps' warps a block, the attention's
DP = 64                # the attention's head width, zero-padded
TILE = 64              # every GEMM step's output tile: TILE x TILE
BARRIER_BYTES = 2 * MAX_STAGES * 8  # the GEMM ring's barriers (wg::kBarrierBytes)
SM_SMEM = 233_472      # shared memory of an H100 SM (228 KB)
BLOCK_RESERVED = 1024  # of which the card keeps this much for each block
# the seven steps of an encoder block, in the kernel's order; a grid barrier
# follows each
STEPS = ("ln1", "qkv", "attention", "proj", "ln2", "fc1", "fc2")
GEMM_STEPS = ("qkv", "proj", "fc1", "fc2")
# what step_times reports: the LN steps together, block 0's barrier waits
STEP_KINDS = ("ln", "qkv", "attention", "proj", "fc1", "fc2", "barrier_wait")

f32 = np.float32
I8, F32 = torch.int8, torch.float32


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def prepare_resident(ip, spec, cfg) -> dict:
    """The stacked per-layer tensors the resident kernel reads, on the
    int-model's device: ``wqkv`` (depth, C, 3C), ``wproj`` (depth, H, D, C),
    ``w1`` (depth, C, hid), ``w2`` (depth, hid, C) int8; ``mb`` (depth, 2,
    3C) [mult/s1, bias/s1], ``vec`` (depth, 15, C), ``vhid`` (depth, 2, hid)
    [fc1 mult, bias], ``vout`` (depth, 4, C) [fc2 mult, bias, s_m2, 1/s_m2],
    ``scal`` (depth, 6) float32; ``lis_fast``, the fast-LIS gate of every
    layer.  Needs the full codes path: every site integer, int_norm and
    smoothquant on, symmetric int8 activations."""
    if not (cfg.int_norm and cfg.smoothquant):
        raise ValueError("resident serving needs int_norm + smoothquant")
    if not ip.get("sym_acts", False):
        raise ValueError("resident serving needs symmetric activations "
                         "(sym_acts) to carry the int8-codes stream")
    if cfg.bit_a.bits != 8 or cfg.bit_a.signed is not True:
        # every requant fence of the kernel clips to [-128, 127]
        raise ValueError("resident serving assumes int8 activations "
                         f"(cfg.bit_a is {cfg.bit_a.name})")
    for i, ib in enumerate(ip["blocks"]):
        for site in ("qkv", "proj", "fc1", "fc2"):
            if ib[site]["fp"]:
                raise ValueError(
                    f"resident serving supports all-integer blocks only; "
                    f"blocks[{i}].{site} is fp (bit -1)")
    c, heads, hd = spec.embed_dim, spec.num_heads, spec.head_dim
    dev = ip["qact1"]["scale"].device

    def bc(a, n=c):
        return np.broadcast_to(_np(a).astype(f32), (n,))

    def sc(a):
        return _np(a).astype(f32).reshape(())

    mb, vec, vhid, vout, scal = [], [], [], [], []
    for i, ib in enumerate(ip["blocks"]):
        qs, ps, f1, f2 = ib["qkv"], ib["proj"], ib["fc1"], ib["fc2"]
        hid = f1["w_int"].shape[1]
        in_scale = bc(ip["qact1"]["scale"] if i == 0
                      else ip["blocks"][i - 1]["qact4"]["scale"])
        s1 = sc(ib["attn.qact1"]["scale"])
        s_a = sc(ib["attn.qact_attn1"]["scale"])
        s2 = sc(ib["attn.qact2"]["scale"])
        s_blk2 = bc(ib["qact2"]["scale"])
        ln1_min, ln2_min = in_scale.min(), s_blk2.min()
        s1_inv = f32(1.0) / s1
        mb.append([bc(qs["mult"], 3 * c) * s1_inv,
                   bc(qs["b"], 3 * c) * s1_inv])
        vec.append([
            in_scale, np.round(in_scale / ln1_min),
            bc(ib["norm1"]["w"]), bc(ib["norm1"]["b"]), bc(qs["in_scale"]),
            bc(ps["mult"]), bc(ps["b"]), bc(ib["attn.qact3"]["scale"]),
            s_blk2, np.round(s_blk2 / ln2_min),
            bc(ib["norm2"]["w"]), bc(ib["norm2"]["b"]),
            bc(f1.get("ln_out_scale", f1["in_scale"])),
            bc(f1["ln_rescale"]) if "ln_rescale" in f1 else np.ones(c, f32),
            bc(ib["qact4"]["scale"])])
        vhid.append([bc(f1["mult"], hid), bc(f1["b"], hid)])
        s_m2 = bc(ib["mlp.qact2"]["scale"])
        vout.append([bc(f2["mult"]), bc(f2["b"]), s_m2, f32(1.0) / s_m2])
        scal.append([s_a, s1 * s1 * f32(spec.attn_scale) / s_a, s1 / s2,
                     f32(1.0) / sc(ib["mlp.qact1"]["scale"]), ln1_min,
                     ln2_min])

    def stack_w(key, shape=None):
        ws = [ib[key]["w_int"] for ib in ip["blocks"]]
        if shape is not None:
            ws = [w.reshape(shape) for w in ws]
        return torch.stack(ws).contiguous()

    def stack_f(rows):
        return torch.tensor(np.asarray(rows, f32), device=dev)

    return {
        "wqkv": stack_w("qkv"), "wproj": stack_w("proj", (heads, hd, c)),
        "w1": stack_w("fc1"), "w2": stack_w("fc2"),
        "mb": stack_f(mb), "vec": stack_f(vec), "vhid": stack_f(vhid),
        "vout": stack_f(vout), "scal": stack_f(scal),
        "lis_fast": all(bool(ib["lis_fast"]) for ib in ip["blocks"]),
    }


def _ln_emit(codes, mask, s_min, w, b, out_scale, rescale=None):
    """``_ln_emit`` (``serve.py:87``): the integer LN of the float32 codes
    with the std floor, the optional rescale, clipped to int8 values."""
    y = ln_codes(codes * mask, s_min, w, b, out_scale, std_floor=STD_FLOOR)
    if rescale is not None:
        y = torch.round(y * rescale)
    return torch.clamp(y, -128, 127)


def resident_codes_plain(packed, x_codes, *, n_real, bits=4, lis=True,
                         nelems, lis_wide=False):
    """Plain PyTorch version of :func:`resident_codes` (``_serve_kernel``,
    ``serve.py:113``, op for op)."""
    if lis and bits > 4:
        raise NotImplementedError("resident_codes: LIS supports bits <= 4 "
                                  "only")
    rows, c = x_codes.shape
    npad = rows // nelems
    _, heads, hd, _ = packed["wproj"].shape

    def clip(y):
        return torch.clamp(y, -128, 127)

    codes = x_codes.to(F32)
    for i in range(packed["wqkv"].shape[0]):
        v, s = packed["vec"][i], packed["scal"][i]
        mb, vh, vo = packed["mb"][i], packed["vhid"][i], packed["vout"][i]
        x1 = _ln_emit(codes, v[V_LN1_MASK], s[S_LN1_MIN], v[V_LN1_W],
                      v[V_LN1_B], v[V_LN1_OUT]).to(I8)
        qkv = clip(torch.round(int_matmul(x1, packed["wqkv"][i]).to(F32)
                               * mb[0] + mb[1])).to(I8)
        t = qkv.reshape(nelems, npad, 3, heads, hd).permute(2, 0, 3, 1, 4)
        o = attention_core_plain(t[0], t[1], t[2], s[S_C1], s[S_SA],
                                 s[S_S1_OVER_S2], n_real=n_real, bits=bits,
                                 lis=lis, lis_fast=packed["lis_fast"],
                                 lis_wide=lis_wide)
        # the per-head proj sums are int32, exact: one (H, D) contraction
        o = o.permute(0, 2, 1, 3).reshape(rows, c)
        y = int_matmul(o, packed["wproj"][i].reshape(c, c)).to(F32) \
            * v[V_PROJ_MULT] + v[V_PROJ_B]
        yq3 = clip(torch.round(y / v[V_S3]))                      # qact3
        hs = codes * v[V_IN_SCALE] + yq3 * v[V_S3]                # residual
        hc2 = clip(torch.round(hs / v[V_SBLK2]))                  # qact2
        x2 = _ln_emit(hc2, v[V_LN2_MASK], s[S_LN2_MIN], v[V_LN2_W],
                      v[V_LN2_B], v[V_LN2_OUT], v[V_LN2_RESCALE]).to(I8)
        mid = int_matmul(x2, packed["w1"][i]).to(F32) * vh[0] + vh[1]
        gq = clip(torch.round(gelu_poly(mid) * s[S_M1_INV])).to(I8)
        y2 = int_matmul(gq, packed["w2"][i]).to(F32) * vo[0] + vo[1]
        y2c = clip(torch.round(y2 * vo[3]))                       # mlp.qact2
        hs2 = hc2 * v[V_SBLK2] + y2c * vo[2]                      # residual
        codes = clip(torch.round(hs2 / v[V_S4]))                  # qact4
    return codes.to(I8)


@dataclasses.dataclass(frozen=True)
class EncoderShape:
    """The widths :func:`resident_plan` reads, under ``ViTSpec``'s names
    (a ``ViTSpec`` serves as well): ``seq_len`` is the real tokens an
    image, the attention's keys."""
    embed_dim: int
    num_heads: int
    hidden_dim: int
    seq_len: int

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


def attn_smem(n_real: int, lis: bool) -> int:
    """The attention step's dynamic shared memory (``resident.cu``'s
    attn_smem), past the ring's barriers: the exponential table, one
    (image, head)'s keys and values at DP = 64, and each of the WARPS
    warps' packed scores (the LIS) or float-softmax buffers."""
    return BARRIER_BYTES + EXP_BYTES + kv_bytes(n_real, DP, lis) + WARPS * (
        CODE_BYTES if lis else soft_bytes(MAX_KEYS, 1))


@dataclasses.dataclass(frozen=True)
class ResidentPlan:
    """K6's launch: ``threads`` a block; GEMM steps of TILE x TILE tiles on
    a ring of ``stages``; ``smem`` = max(``gemm_smem``, ``attn_smem``)
    bytes of dynamic shared memory; ``blocks`` an SM and ``grid`` blocks;
    attention items of ``attn_tiles`` query tiles, ``attn_split`` an
    (image, head); and each step's work ``items`` (an LN item: WARPS rows;
    a GEMM item: a tile; an attention item) with the ``rounds`` a block
    loops for them."""
    threads: int
    stages: int
    gemm_smem: int
    attn_smem: int
    smem: int
    blocks: int
    grid: int
    attn_tiles: int
    attn_split: int
    items: tuple
    rounds: tuple

    def launch_args(self) -> tuple[int, ...]:
        """The numbers the C entry takes, in its order."""
        return (self.stages, self.smem, self.blocks, self.grid,
                self.attn_tiles, self.attn_split)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def resident_plan(nelems: int, npad: int, spec, lis: bool = True,
                  sms: int = H100_SMS) -> ResidentPlan:
    """K6's plan for ``nelems`` images of ``npad`` rows of the encoder
    ``spec`` (``embed_dim``, ``num_heads``, ``hidden_dim``; ``seq_len``
    real tokens) on a card of ``sms`` SMs.

    Up to 256 rows (b = 1) one block an SM, past 256 rows two (the
    kernel's two-block instance, 112 registers a thread), each with its
    share of the SM's shared memory; the ring's stages as many as that
    holds, up to MAX_STAGES.  The grid is as many blocks as the largest
    step has items, at most blocks x SMs.  The attention items are
    ``attn_plan.attention_plan``'s blocks for the same batch.  C and
    hidden must be multiples of TILE, so that no tile crosses a layer of a
    weight stack.  Raises ``ValueError`` for a shape the kernel does not
    take or a plan that does not fit."""
    c, heads, hid = spec.embed_dim, spec.num_heads, spec.hidden_dim
    d, n_real = spec.head_dim, spec.seq_len
    require(nelems > 0 and npad > 0, f"empty batch: {nelems} x {npad}")
    require(heads * d == c, f"{heads} heads of {d} do not make C={c}")
    require(c % TILE == 0 and hid % TILE == 0,
            f"C={c} and hidden={hid} must be multiples of {TILE}")
    ap = attention_plan(nelems, heads, npad, d, n_real, lis, sms)
    rows = nelems * npad
    blocks = 1 if rows <= 256 else 2
    budget = SMEM_LIMIT if blocks == 1 else SM_SMEM // 2 - BLOCK_RESERVED
    stages = min(MAX_STAGES, (budget - smem_bytes(TILE, TILE, 0))
                 // (2 * TILE * BK))
    gemm = smem_bytes(TILE, TILE, stages)
    attn = attn_smem(n_real, lis)
    smem = max(gemm, attn)
    require(stages >= 2 and smem <= budget,
            f"K6 needs {smem} bytes of shared memory a block, more than "
            f"{budget} at {blocks} blocks an SM")
    m_tiles = _cdiv(rows, TILE)
    tiles = [m_tiles * n // TILE for n in (3 * c, c, hid, c)]
    ln = _cdiv(rows, WARPS)
    items = (ln, tiles[0], nelems * heads * ap.split, tiles[1], ln, tiles[2],
             tiles[3])  # in STEPS' order
    grid = min(blocks * sms, max(items))
    return ResidentPlan(threads=THREADS, stages=stages, gemm_smem=gemm,
                        attn_smem=attn, smem=smem, blocks=blocks, grid=grid,
                        attn_tiles=ap.tiles, attn_split=ap.split, items=items,
                        rounds=tuple(_cdiv(i, grid) for i in items))


def device_resident_plan(nelems, npad, spec, lis, device) -> ResidentPlan:
    """:func:`resident_plan` for the SM count of the card ``device``."""
    return resident_plan(nelems, npad, spec, lis, sm_count(device))


def scratch_layout(rows: int, c: int, hid: int) -> dict:
    """name -> (byte offset, row bytes) of K6's scratch, in
    ``resident.cu``'s order: act (rows, C), hc2 (rows, C), qkv (rows, 3C),
    hidden (rows, hid); ``rows * (5C + hid)`` bytes in all.  The kernel
    reads act and hidden through TMA (TMA_SCRATCH)."""
    return {"act": (0, c), "hc2": (rows * c, c), "qkv": (2 * rows * c, 3 * c),
            "hidden": (5 * rows * c, hid)}


TMA_SCRATCH = ("act", "hidden")


def _kmajor_stacks(packed) -> dict:
    depth, heads, hd, c = packed["wproj"].shape
    wproj = packed["wproj"].reshape(depth, heads * hd, c)
    return {k: w.transpose(1, 2).contiguous() for k, w in (
        ("wqkv", packed["wqkv"]), ("wproj", wproj), ("w1", packed["w1"]),
        ("w2", packed["w2"]))}


def resident_kmajor(packed) -> dict:
    """The K-major weight stacks that K6's TMA maps read: wqkv (depth, 3C,
    C), wproj (depth, C, H*D) (K in the head-major order of the attention
    output, as ``resident_codes_plain`` reshapes it), w1 (depth, hid, C),
    w2 (depth, C, hid); layer l of each is ``gemm.kmajor`` of the layer's
    (K, N) weight.  Made once per packed model and kept while its weights
    live (``gemm.per_weight``)."""
    return per_weight(lambda: _kmajor_stacks(packed),
                      *(packed[k] for k in WEIGHTS))


def _tma_checks(km, scratch, rows, c, hid):
    """TMA's rule on the operands K6 reads through its maps."""
    for k, w in km.items():
        err = tma_operand_error(w.data_ptr(), [w.stride(1)])
        require(err is None, f"{k}: {err}")
    base = scratch.data_ptr()
    for name in TMA_SCRATCH:
        off, row = scratch_layout(rows, c, hid)[name]
        err = tma_operand_error(base + off, [row])
        require(err is None, f"scratch {name}: {err}")


def resident_codes(packed, x_codes, *, n_real, bits=4, lis=True, nelems,
                   lis_wide=False):
    """Every encoder block in one launch.  x_codes: (nelems * npad, C) int8
    on the qact1 grid, ``nelems`` images of ``npad`` rows each; rows at or
    past ``n_real`` of an image are padding (computed, never used as keys).
    ``packed``: :func:`prepare_resident`'s tensors.  ``lis_wide``: every
    layer's LIS row sum is 128-bit, as a layer whose scale fails
    ``lis_sum_fits`` needs (it equals the int64 sum where that one fits).
    Returns (nelems * npad, C) int8 codes on the last block's qact4 grid.

    A CUDA tensor runs ``csrc/resident.cu``; a CPU tensor runs
    :func:`resident_codes_plain`."""
    if route(x_codes, *(packed[k] for k in PACKED)) == "cpu":
        return resident_codes_plain(packed, x_codes, n_real=n_real,
                                    bits=bits, lis=lis, nelems=nelems,
                                    lis_wide=lis_wide)
    if lis and bits > 4:
        raise NotImplementedError("resident_codes: LIS supports bits <= 4 "
                                  "only")
    out = _launch(packed, x_codes, n_real=n_real, lis=lis, nelems=nelems,
                  lis_wide=lis_wide)
    resident_codes.launches += 1
    return out


resident_codes.launches = 0


def _launch(packed, x_codes, *, n_real, lis, nelems, stamps=None,
            plan=None, lis_wide=False):
    """One K6 launch on the card (``plan``: the device's resident_plan
    unless given); ``stamps``: None, or a zeroed (1 + 14 * depth,) int64
    card tensor for the barrier stamps."""
    rows, c = x_codes.shape
    depth, heads, hd, _ = packed["wproj"].shape
    hid = packed["w1"].shape[2]
    check_for_kernel(x_codes, "x_codes", I8, 2)
    for k, dt in (("wqkv", I8), ("wproj", I8), ("w1", I8), ("w2", I8)):
        check_for_kernel(packed[k], k, dt, 3 if k != "wproj" else 4)
    for k in ("mb", "vec", "vhid", "vout"):
        check_for_kernel(packed[k], k, F32, 3)
    check_for_kernel(packed["scal"], "scal", F32, 2)
    require(nelems > 0 and rows % nelems == 0,
            f"{rows} rows do not split into {nelems} images")
    npad = rows // nelems
    require(packed["wqkv"].shape == (depth, c, 3 * c)
            and heads * hd == c and packed["w2"].shape == (depth, hid, c)
            and packed["vec"].shape == (depth, 15, c)
            and packed["scal"].shape == (depth, 6),
            f"packed tensors do not match x_codes {tuple(x_codes.shape)}")
    require(0 < n_real <= min(npad, MAX_KEYS),
            f"n_real={n_real}: the kernel takes 1..min(npad, {MAX_KEYS}) keys")
    require(hd <= 64 and hd % 4 == 0,
            f"head_dim={hd}: the kernel takes multiples of 4 up to 64")
    dev = x_codes.device
    if plan is None:
        plan = device_resident_plan(nelems, npad,
                                    EncoderShape(c, heads, hid, n_real), lis,
                                    dev)
    km = resident_kmajor(packed)
    scratch = torch.empty(rows * (5 * c + hid), dtype=I8, device=dev)
    _tma_checks(km, scratch, rows, c, hid)
    barrier = torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.empty_like(x_codes)
    err = load_library().dvt_resident_codes(
        x_codes.data_ptr(), out.data_ptr(),
        *(km[k].data_ptr() for k in WEIGHTS),
        *(packed[k].data_ptr() for k in PACKED[4:]),
        scratch.data_ptr(), barrier.data_ptr(),
        None if stamps is None else stamps.data_ptr(), depth, nelems, npad,
        n_real, c, hid, heads, hd, lis_code(lis, lis_wide),
        int(packed["lis_fast"]),
        *plan.launch_args(), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "resident_codes")
    return out


def step_times(stamps, depth: int) -> dict:
    """Block 0's milliseconds by step kind (STEP_KINDS: the two LN steps
    together, then each GEMM step and the attention, then its waits in the
    grid barriers) and the launch's ``total``, from the kernel's
    %globaltimer stamps: [start, then (arrival, departure) at each of the
    7 * depth barriers].  A step's time is block 0's from its departure
    from the last barrier to its arrival at the next; the kinds and the
    waits sum to the total."""
    require(len(stamps) == 1 + 2 * len(STEPS) * depth,
            f"{len(stamps)} stamps for depth {depth}")
    out = dict.fromkeys(STEP_KINDS, 0.0)
    last = stamps[0]
    for k in range(len(STEPS) * depth):
        arrive, leave = stamps[1 + 2 * k], stamps[2 + 2 * k]
        kind = STEPS[k % len(STEPS)]
        out["ln" if kind.startswith("ln") else kind] += (arrive - last) / 1e6
        out["barrier_wait"] += (leave - arrive) / 1e6
        last = leave
    out["total"] = (last - stamps[0]) / 1e6
    return out


def resident_step_ms(packed, x_codes, *, n_real, lis=True, nelems) -> dict:
    """One K6 launch on the card with its barrier stamps on (a last grid
    barrier closes the last step): :func:`step_times` of it.  Not on the
    served path, which passes no stamps; counted as a launch."""
    depth = packed["wqkv"].shape[0]
    stamps = torch.zeros(1 + 2 * len(STEPS) * depth, dtype=torch.int64,
                         device=x_codes.device)
    _launch(packed, x_codes, n_real=n_real, lis=lis, nelems=nelems,
            stamps=stamps)
    resident_codes.launches += 1
    return step_times(stamps.cpu().tolist(), depth)


def resident_footprint(nelems, npad, spec, device, lis=True) -> dict:
    """K6's registers, local memory (spills) a thread, shared memory a
    block and blocks an SM at the plan's shared memory for ``nelems``
    images of ``spec`` on ``device`` (``cudaFuncGetAttributes`` and the
    occupancy API), with the plan's tiles and grid.  Needs a card."""
    plan = device_resident_plan(nelems, npad, spec, lis, device)
    out = [ctypes.c_int() for _ in range(4)]
    check(load_library().dvt_resident_footprint(
        plan.blocks, plan.smem, *map(ctypes.byref, out)),
        "resident_footprint")
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "blocks_per_sm"), (o.value for o in out)),
                plan_smem=plan.smem, plan_blocks=plan.blocks,
                stages=plan.stages, grid=plan.grid)

"""The arithmetic of the tensor-core attention core (``csrc/attention_mma.cuh``,
K1/K5/K7a/K8 and K4/K4b) and its plan (``ops/kernels/attn_plan.py``), on
the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold it there); what can be held here is its design:

* a model of the kernel's register and shared-memory layouts, written
  from the CUDA source index for index (the staging of K and of V^T in
  ``key_slot`` order with byte permutes, the m16n8k32 fragments as PTX
  defines them, the packing of the codes and of the LIS shifts, the two
  u8 planes of attn@v; the probes' variants: P5's linear rule on one s8
  plane, P1's consumer on scores loaded from memory), whose output must
  equal the plain version and agree with the JAX Pallas kernel in
  interpret mode;
* the hi/lo split of the LIS weights with the permuted key order against
  ``weighted_values``;
* the quad form of the LIS (four lanes' partial maxima and int64 sums)
  against ``lis_body_plain``;
* the plans' shared memory and grids, and the K-major weight copies the
  qkv GEMM reads."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffvit_tpu.ops.pallas.attention import \
    fused_int_attention as jax_int_attention

from diffvit_tpu_torch.models.convert import int_attn_scalars
from diffvit_tpu_torch.models.vit import ViTSpec
from diffvit_tpu_torch.ops.kernels import attention, gemm
from diffvit_tpu_torch.ops.kernels.attention import (
    attention_core_plain, heads_to_all, lis_body_plain, lis_tail_plain,
    weighted_values)
from diffvit_tpu_torch.ops.kernels.attn_plan import (
    CODE_BYTES, EXP_BYTES, LIS_MAX_KEYS, MAX_WINDOWS, MIN_WARPS, QKV_MAX_KEYS,
    QKV_MAX_WARPS, ROWS, SWIN_MAX_KEYS, SWIN_MAX_WARPS, attention_plan,
    key_slot, kv_bytes, swin_attention_plan, weight_planes)
from diffvit_tpu_torch.ops.kernels.gemm import SMEM_LIMIT
from diffvit_tpu_torch.ops.quant import pow2
from diffvit_tpu_torch.probes import attn_overlap, pingpong
from diffvit_tpu_torch.testing import random_int_model

from test_torch_calibrate import one_torch_thread  # noqa: F401

TINY = ViTSpec("test_tiny", embed_dim=64, depth=2, num_heads=2,
               num_classes=10)
LIS_ZERO = 16  # lis.cuh's kLisZero: the shift of a zero weight


# ---- a model of the kernel, index for index ----

def _word(row: np.ndarray, col: int) -> int:
    """The little-endian 32-bit word of int8 bytes row[col:col + 4]."""
    return int(row[col:col + 4].astype(np.uint8).view("<u4")[0])


def _byte(x: int, i: int, signed: bool) -> int:
    b = (x >> (8 * i)) & 0xFF
    return b - 256 if signed and b > 127 else b


def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm(x, y, s) for selectors 0..7."""
    return _prmt(x, y, s & 0x7777)


def _prmt(x: int, y: int, s: int) -> int:
    """PTX prmt.b32 in its default mode: selector nibble k picks byte
    (nibble & 7) of {y, x}, or, with the nibble's bit 3 set, that byte's
    sign replicated."""
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
        [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = 0
    for k in range(4):
        n = (s >> (4 * k)) & 0xF
        v = b[n & 7]
        out |= ((0xFF if v & 0x80 else 0) if n & 8 else v) << (8 * k)
    return out


def _plane_selectors(shift: int, slot: int) -> int:
    """plane_selectors: the lo and hi nibbles of one key's weight."""
    lo = shift if shift < 8 else 8
    hi = shift - 8 if 8 <= shift < 16 else 8
    return lo << (4 * slot) | hi << (16 + 4 * slot)


def _mma(acc, a, b, a_signed):
    """mma.sync.m16n8k32.row.col.s32.{s8,u8}.s8.s32 on the fragments of
    the 32 lanes, as the PTX ISA lays them out: a[lane] 4 registers (row
    g for 0 and 2, g + 8 for 1 and 3; k 4t.. for 0 and 1, 16 + 4t.. for 2
    and 3), b[lane] 2 registers (n = g; k 4t.., 16 + 4t..), acc[lane] 4
    accumulators (row g, g, g + 8, g + 8; n 2t, 2t + 1)."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(4):
            for bb in range(4):
                A[g + 8 * (i & 1), 4 * t + bb + 16 * (i >> 1)] = \
                    _byte(a[lane][i], bb, a_signed)
        for i in range(2):
            for bb in range(4):
                B[4 * t + bb + 16 * i, g] = _byte(b[lane][i], bb, True)
    D = A @ B
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(4):
            acc[lane][i] += int(D[g + 8 * (i >> 1), 2 * t + (i & 1)])


def _stage_kv(k_rows, v_rows, n_real, d):
    """stage_kv: K words (keys_pad, DP/4 + 4) and V^T words (DP,
    keys_pad/4 + 4), built by the CUDA loops' own index arithmetic."""
    keys_pad, dp = -(-n_real // 32) * 32, 32 if d <= 32 else 64
    kw, vw, dw, words = dp // 4 + 4, (keys_pad + 16) // 4, dp // 4, d // 4
    k = np.zeros((keys_pad, kw), np.int64)
    vt = np.zeros((dp, vw), np.int64)
    for idx in range(keys_pad * dw):
        j, w = idx // dw, idx % dw
        k[j, w] = _word(k_rows[j], 4 * w) if j < n_real and w < words else 0
    quartets = keys_pad // 4
    for idx in range(quartets * dw):
        qd, w = idx % quartets, idx // quartets
        j0 = (qd & ~7) * 4 + (qd >> 2 & 1) * 16 + (qd & 3) * 2
        x = [_word(v_rows[j], 4 * w) if j < n_real and w < words else 0
             for j in (j0 + (i & 1) + 8 * (i >> 1) for i in range(4))]
        lo01, hi01 = _byte_perm(x[0], x[1], 0x5140), \
            _byte_perm(x[0], x[1], 0x7362)
        lo23, hi23 = _byte_perm(x[2], x[3], 0x5140), \
            _byte_perm(x[2], x[3], 0x7362)
        col = key_slot(j0) // 4
        assert col == qd
        vt[4 * w + 0, col] = _byte_perm(lo01, lo23, 0x5410)
        vt[4 * w + 1, col] = _byte_perm(lo01, lo23, 0x7632)
        vt[4 * w + 2, col] = _byte_perm(hi01, hi23, 0x5410)
        vt[4 * w + 3, col] = _byte_perm(hi01, hi23, 0x7632)
    return k, vt, keys_pad, dp


def _loaded_codes(scores, q0, rows, n_real, nkb):
    """LoadedScores.load4: the codes of slot u = 4p + 2 half + e of row r
    (key 16p + 8 half + 2t + e of query row q0 + g + 8r) read from the
    (npad, npad) int8 ``scores``; 0 past n_real and past the tile's rows."""
    codes = np.zeros((32, 2, 2 * nkb * 4), np.int64)  # [lane][r][u]
    for p in range(2 * nkb):
        if 16 * p >= n_real:
            continue
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for r in range(2):
                if g + 8 * r >= rows:
                    continue
                for half in range(2):
                    for e in range(2):
                        key = 16 * p + 8 * half + 2 * t + e
                        if key < n_real:
                            codes[lane, r, 4 * p + 2 * half + e] = \
                                scores[q0 + g + 8 * r, key]
    return codes


def _model_core(q, k_rows, v_rows, c1, s_a, out_scale, n_real, lis_fast,
                rule="lis", scores=None):
    """attend_rows with K1's chain and the LIS, for every 16-row tile of
    one (image, head): q, k_rows, v_rows (npad, d) int8.  The LIS values
    themselves come from lis_body_plain on the rows' codes (the quad form
    is held on its own below); what is modelled is where each score, code,
    shift and weight lives.  ``rule`` "linear": probe P5's weight rule, the
    packed codes as they stand as the s8 A fragments of attn@v, the int32
    sum times 2^-7.  ``scores`` (npad, npad) int8: probe P1's consumer, the
    codes loaded (LoadedScores) where the score mma would compute them."""
    npad, d = q.shape
    k, vt, keys_pad, dp = _stage_kv(k_rows, v_rows, n_real, d)
    nkb, kc_n = keys_pad // 32, dp // 32
    out = np.zeros((npad, d), np.int8)
    for q0 in range(0, npad, 16):
        rows = min(16, npad - q0)
        if scores is not None:
            codes = _loaded_codes(scores, q0, rows, n_real, nkb)
        else:
            codes = _mma_codes(q, k, q0, rows, c1, n_real, d, nkb, kc_n)
        if rule == "linear":
            _linear_attn_v(codes, vt, out, q0, rows, d, nkb, out_scale)
            continue
        # the LIS shifts of each (row, key), from the plain LIS on the codes
        a = torch.zeros((16, keys_pad))
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for r in range(2):
                for u in range(codes.shape[2]):
                    key = 8 * (u >> 1) + 2 * t + (u & 1)
                    a[g + 8 * r, key] = float(codes[lane, r, u])
        col_ok = torch.arange(keys_pad) < n_real
        w = lis_body_plain(a, torch.tensor(np.float32(s_a)), 4, col_ok,
                           fast=lis_fast)
        shift = torch.where(w > 0, torch.log2(w.clamp(min=1).double())
                            .round().to(torch.int64), LIS_ZERO)
        sh = np.zeros((32, 2, nkb * 2), np.int64)  # plane selectors
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for r in range(2):
                for u in range(8 * nkb):
                    key = 8 * (u >> 1) + 2 * t + (u & 1)
                    sh[lane, r, u >> 2] |= _plane_selectors(
                        int(shift[g + 8 * r, key]), u & 3)

        def planes(sel):  # weight_planes
            return (_prmt(0x08040201, 0x80402010, sel >> 16),
                    _prmt(0x08040201, 0x80402010, sel & 0xFFFF))

        for nt in range(-(-d // 8)):
            hi = [[0] * 4 for _ in range(32)]
            lo = [[0] * 4 for _ in range(32)]
            for kb in range(nkb):
                ph, pl = [], []
                for lane in range(32):
                    p = [planes(int(sh[lane, 0, 2 * kb])),
                         planes(int(sh[lane, 1, 2 * kb])),
                         planes(int(sh[lane, 0, 2 * kb + 1])),
                         planes(int(sh[lane, 1, 2 * kb + 1]))]
                    ph.append([x[0] for x in p])
                    pl.append([x[1] for x in p])
                b = [[int(vt[8 * nt + (lane >> 2), 8 * kb + (lane & 3)]),
                      int(vt[8 * nt + (lane >> 2), 8 * kb + 4 + (lane & 3)])]
                     for lane in range(32)]
                _mma(hi, ph, b, False)
                _mma(lo, pl, b, False)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for r in range(2):
                    row = g + 8 * r
                    for e in range(2):
                        col = 8 * nt + 2 * t + e
                        if row < rows and col < d:
                            acc = hi[lane][2 * r + e] * 256 + lo[lane][2 * r + e]
                            assert abs(acc) < 2**31
                            o = np.float32(acc) * np.float32(2.0**-15)
                            out[q0 + row, col] = np.clip(
                                np.round(o * np.float32(out_scale)),
                                -128, 127)
    return out


def _mma_codes(q, k, q0, rows, c1, n_real, d, nkb, kc_n):
    """The score step: the query fragments, mma.sync against the staged K
    words, K1's chain; codes packed 4 a register: reg u // 4, byte u % 4
    of slot u = 2j + e (key 8j + 2t + e)."""
    qa = [[[0] * 4 for _ in range(kc_n)] for _ in range(32)]
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for kc in range(kc_n):
            for i in range(4):
                row, col = g + 8 * (i & 1), 32 * kc + 16 * (i >> 1) + 4 * t
                qa[lane][kc][i] = _word(q[q0 + row], col) \
                    if row < rows and col < d else 0
    codes = np.zeros((32, 2, 2 * nkb * 4), np.int64)  # [lane][r][u]
    for j in range(4 * nkb):
        if 8 * j >= n_real:
            continue
        acc = [[0] * 4 for _ in range(32)]
        for kc in range(kc_n):
            b = [[int(k[8 * j + (lane >> 2), 8 * kc + (lane & 3)]),
                  int(k[8 * j + (lane >> 2), 8 * kc + 4 + (lane & 3)])]
                 for lane in range(32)]
            _mma(acc, [qa[lane][kc] for lane in range(32)], b, True)
        for lane in range(32):
            for i in range(4):
                s = np.float32(acc[lane][i]) * np.float32(c1)
                codes[lane, i >> 1, 2 * j + (i & 1)] = \
                    np.clip(np.round(s), -128, 127)
    return codes


def _linear_attn_v(codes, vt, out, q0, rows, d, nkb, out_scale):
    """attn@v of the linear rule: A = the packed code words of slots
    4p .. 4p + 3 (rows g, g + 8; words 2kb, 2kb + 1 of each), one s8
    plane on mma.sync s8 x s8; the sum times 2^-7, requantized."""
    def word(lane, r, p):
        return sum((int(codes[lane, r, 4 * p + i]) & 0xFF) << (8 * i)
                   for i in range(4))

    for nt in range(-(-d // 8)):
        acc = [[0] * 4 for _ in range(32)]
        for kb in range(nkb):
            a = [[word(lane, 0, 2 * kb), word(lane, 1, 2 * kb),
                  word(lane, 0, 2 * kb + 1), word(lane, 1, 2 * kb + 1)]
                 for lane in range(32)]
            b = [[int(vt[8 * nt + (lane >> 2), 8 * kb + (lane & 3)]),
                  int(vt[8 * nt + (lane >> 2), 8 * kb + 4 + (lane & 3)])]
                 for lane in range(32)]
            _mma(acc, a, b, True)
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for r in range(2):
                for e in range(2):
                    row, col = g + 8 * r, 8 * nt + 2 * t + e
                    if row < rows and col < d:
                        assert abs(acc[lane][2 * r + e]) < 2**22
                        o = np.float32(acc[lane][2 * r + e]) \
                            * np.float32(2.0**-7)
                        out[q0 + row, col] = np.clip(
                            np.round(o * np.float32(out_scale)), -128, 127)


@pytest.mark.parametrize("npad,n_real,d,lis_fast", [
    (40, 33, 32, False), (24, 24, 16, True), (70, 64, 64, False),
    (20, 7, 16, False), (30, 25, 12, False)])
def test_model_of_the_mma_core_equals_the_plain_core(npad, n_real, d,
                                                     lis_fast):
    """The kernel's layouts, modelled index for index, give the plain
    version's codes exactly: rows past npad and keys past n_real, a
    ragged last tile, D = 16 (zero-padded to 32), 64 and 12 (whose last n
    tile of attn@v holds 4 columns past D, which are not stored)."""
    rng = np.random.default_rng(npad + d)
    q, k, v = (np.clip(np.round(rng.standard_normal((npad, d)) * 14),
                       -128, 127).astype(np.int8) for _ in range(3))
    c1, s_a, out_scale = 0.011, 0.09, 1.7
    got = _model_core(q, k, v, c1, s_a, out_scale, n_real, lis_fast)
    f32 = lambda x: torch.tensor(np.float32(x))  # noqa: E731
    want = attention_core_plain(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), f32(c1), f32(s_a),
                                f32(out_scale), n_real=n_real,
                                lis_fast=lis_fast)
    np.testing.assert_array_equal(got, want.numpy())
    assert len(np.unique(got)) > 8


def test_model_of_the_mma_core_agrees_with_pallas():
    """The model on K5's inputs against the JAX Pallas K5 in interpret
    mode, by the kernel rule (>= 99.9% of codes equal, within 1): the
    reference sums the LIS row in float32, the port exactly."""
    h, d, n_real = TINY.num_heads, TINY.head_dim, 33
    rng = np.random.default_rng(9)
    qkv = np.zeros((1, 3, h, 128, d), np.int8)
    qkv[:, :, :, :n_real] = np.clip(np.round(
        rng.standard_normal((1, 3, h, n_real, d)) * 12), -128, 127)
    scalars = np.asarray(int_attn_scalars(
        random_int_model(TINY, seed=2)["blocks"][0], TINY), np.float32)
    want = np.asarray(jax_int_attention(
        jnp.asarray(qkv), jnp.asarray(scalars), num_heads=h, n_real=n_real,
        bits=4, lis=True, interpret=True))[0, :, :n_real]
    got = np.stack([_model_core(qkv[0, 0, hh, :n_real],
                                qkv[0, 1, hh, :n_real],
                                qkv[0, 2, hh, :n_real], scalars[0],
                                scalars[2], scalars[1], n_real, False)
                    for hh in range(h)])
    diff = np.abs(got.astype(np.int32) - want)
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999


@pytest.mark.parametrize("npad,d", [(24, 16), (40, 32), (70, 64), (200, 64)])
def test_model_of_the_linear_rule_equals_p5_plain(npad, d):
    """Probe P5's weight rule in the core (Weight::kLinear), modelled index
    for index: the packed codes of every one of the Npad keys are the s8 A
    fragments of attn@v as they stand (one plane, no LIS), and the int32
    sum times 2^-7 gives qkv_attention_nv_plain's codes, head by head."""
    rng = np.random.default_rng(npad + d)
    heads, cin = 2, 64
    x = torch.tensor(rng.integers(-128, 128, (1, npad, cin)),
                     dtype=torch.int8)
    w = torch.tensor(rng.integers(-8, 8, (cin, 3 * heads * d)),
                     dtype=torch.int8)
    mult = torch.full((3 * heads * d,), 2.0**-12)
    bias = torch.tensor(rng.standard_normal(3 * heads * d) * 0.01,
                        dtype=torch.float32)
    scal = torch.tensor([2.0**-4, 0.01, 24.0, 0.5])
    want = attn_overlap.qkv_attention_nv_plain(
        x, w, mult, bias, scal, num_heads=heads, head_dim=d)[0]
    mb = attention.fold_requant(mult, bias, scal[2], w.shape[1])
    qkv = attention.qkv_projection_plain(x, w, mb)[0].numpy()
    for h in range(heads):
        q, k, v = (qkv[:, (slot * heads + h) * d:(slot * heads + h + 1) * d]
                   for slot in range(3))
        got = _model_core(q, k, v, float(scal[1]), float(scal[0]),
                          float(scal[3]), npad, False, rule="linear")
        np.testing.assert_array_equal(got, want[h].numpy())
        assert len(np.unique(got)) > 8


@pytest.mark.parametrize("npad,n_real,d", [(24, 21, 16), (45, 33, 64),
                                           (70, 64, 32), (200, 197, 64)])
def test_model_of_loaded_scores_equals_p1_consumer_plain(npad, n_real, d):
    """Probe P1's consumer in the core (LoadedChain): LoadedScores.load4's
    index arithmetic puts the int8 scores read from memory into the slots
    the score mma fills (a ragged last tile, keys past n_real read as 0),
    then K1's fast LIS and attn@v give consumer_plain's codes; no query or
    key is read."""
    rng = np.random.default_rng(npad + n_real)
    scores = rng.integers(-128, 128, (npad, npad)).astype(np.int8)
    v = rng.integers(-128, 128, (npad, d)).astype(np.int8)
    scal = torch.tensor([2.0**-4, 0.05, 24.0, 1.3])
    want = pingpong.consumer_plain(torch.tensor(scores)[None, None],
                                   torch.tensor(v)[None, None], scal,
                                   n_real=n_real)[0, 0]
    unread = np.full((npad, d), 127, np.int8)  # q and k: never read
    got = _model_core(unread, unread, v, 0.0, float(scal[0]), float(scal[3]),
                      n_real, True, scores=scores)
    np.testing.assert_array_equal(got, want.numpy())
    assert len(np.unique(got)) > 8


# ---- attn@v: the hi/lo planes in key_slot order ----

def _lis_like_weights(rng, rows, keys, n_real):
    """int32 weights 2^(15 - code) or 0, with 0, 1 and 2^15 in every row,
    0 past n_real."""
    w = 2 ** rng.integers(0, 16, (rows, keys))
    w[rng.random((rows, keys)) < 0.2] = 0
    w[:, 0] = 2**15
    if n_real > 1:
        w[:, 1] = 1
    if n_real > 2:
        w[:, 2] = 0
    w[:, n_real:] = 0
    return torch.tensor(w, dtype=torch.int32)


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("n_real", [1, 49, 197, 256])
def test_weight_planes_in_key_slot_order_equal_weighted_values(d, n_real):
    rng = np.random.default_rng(n_real * d)
    keys = -(-n_real // 32) * 32
    w = _lis_like_weights(rng, 16, keys, n_real)
    v = torch.tensor(rng.integers(-128, 128, (keys, d)), dtype=torch.int8)
    v[n_real:] = 0
    slots = torch.tensor([key_slot(j) for j in range(keys)])
    assert sorted(slots.tolist()) == list(range(keys))
    # the kernel's operands: P with its keys at their slots, V^T likewise
    perm_w = torch.zeros_like(w)
    perm_w[:, slots] = w
    vt = torch.zeros((d, keys), dtype=torch.int64)
    vt[:, slots] = v.t().to(torch.int64)
    hi, lo = weight_planes(perm_w)
    assert int(hi.max()) <= 128 and int(lo.max()) <= 128
    acc_hi = hi.to(torch.int64) @ vt.t()
    acc_lo = lo.to(torch.int64) @ vt.t()
    assert int(acc_hi.abs().max()) <= 2**22
    got = 256 * acc_hi + acc_lo
    np.testing.assert_array_equal(got.numpy(),
                                  weighted_values(w, v).numpy())


# ---- the long rows (attend_rows_long: past 256 keys) ----

def _model_long(q, k_rows, v_rows, c1, s_a, out_scale, n_real, lis_fast,
                q0):
    """attend_rows_long with K1's chain for the 16-row query tile at row
    ``q0`` of one (image, head): no packed scores, but the score mma and
    the chain again on each of three passes over the staged keys: each
    lane's maxima of its keys 8j + 2t + e and their quad reduction, each
    lane's exact int64 partial sums of the integer exponentials and
    theirs, then block by block of 32 keys the plane selectors of the four
    A-fragment words (from lis_tail_plain's weight on the whole row's
    sum) and attn@v over every n tile: P_hi V on a fresh accumulator,
    P_lo V added on the running one, then 256 times the first added."""
    npad, d = q.shape
    k, vt, keys_pad, dp = _stage_kv(k_rows, v_rows, n_real, d)
    kc_n, rows = dp // 32, min(16, npad - q0)
    key_tiles = -(-n_real // 8)
    qa = [[[(_word(q[q0 + g + 8 * (i & 1)], 32 * kc + 16 * (i >> 1) + 4 * t)
             if g + 8 * (i & 1) < rows and 32 * kc + 16 * (i >> 1) + 4 * t
             < d else 0) for i in range(4)] for kc in range(kc_n)]
          for g, t in ((lane >> 2, lane & 3) for lane in range(32))]

    def scores(j):  # [lane][i]: row g + 8 (i >> 1), key 8j + 2t + (i & 1)
        acc = [[0] * 4 for _ in range(32)]
        for kc in range(kc_n):
            b = [[int(k[8 * j + (lane >> 2), 8 * kc + (lane & 3)]),
                  int(k[8 * j + (lane >> 2), 8 * kc + 4 + (lane & 3)])]
                 for lane in range(32)]
            _mma(acc, [qa[lane][kc] for lane in range(32)], b, True)
        return [[float(np.clip(np.round(np.float32(a) * np.float32(c1)),
                               -128, 127)) for a in row] for row in acc]

    def keys(j, lane):
        return [8 * j + 2 * (lane & 3) + (i & 1) for i in range(4)]

    s = torch.tensor(np.float32(s_a))
    # 1. the row max: each lane's, then the quad's
    part = np.full((32, 2), -np.inf, np.float32)
    for j in range(key_tiles):
        v = scores(j)
        for lane in range(32):
            for i, key in enumerate(keys(j, lane)):
                if key < n_real:
                    part[lane, i >> 1] = max(part[lane, i >> 1], v[lane][i])
    row_max = np.stack([part[4 * (lane >> 2):4 * (lane >> 2) + 4].max(0)
                        for lane in range(32)])
    # 2. the exact row sum: each lane's int64 sum, then the quad's
    sums = np.zeros((32, 2), np.int64)
    for j in range(key_tiles):
        v = scores(j)
        for lane in range(32):
            for i, key in enumerate(keys(j, lane)):
                if key < n_real:
                    e = _lis_exp_plain(torch.tensor(np.float32(v[lane][i])),
                                       torch.tensor(row_max[lane, i >> 1]),
                                       s, lis_fast)
                    sums[lane, i >> 1] += int(e)
    exp_sum = np.stack([sums[4 * (lane >> 2):4 * (lane >> 2) + 4].sum(0)
                        for lane in range(32)]).astype(np.float32)
    # 3. block by block: the selectors, then attn@v over every n tile
    acc = [[[0] * 4 for _ in range(32)] for _ in range(-(-d // 8))]
    for kb in range(keys_pad // 32):
        sel = [[0] * 4 for _ in range(32)]
        for qq in range(4):
            j = 4 * kb + qq
            v = scores(j) if j < key_tiles else [[0.0] * 4] * 32
            for lane in range(32):
                for i, key in enumerate(keys(j, lane)):
                    shift = LIS_ZERO
                    if key < n_real:
                        e = _lis_exp_plain(
                            torch.tensor(np.float32(v[lane][i])),
                            torch.tensor(row_max[lane, i >> 1]), s, lis_fast)
                        w = int(lis_tail_plain(
                            torch.tensor(exp_sum[lane, i >> 1]), e))
                        if w:
                            shift = w.bit_length() - 1
                    sel[lane][2 * (qq >> 1) + (i >> 1)] |= _plane_selectors(
                        shift, 2 * (qq & 1) + (i & 1))
        ph = [[_prmt(0x08040201, 0x80402010, x >> 16) for x in sl]
              for sl in sel]
        pl = [[_prmt(0x08040201, 0x80402010, x & 0xFFFF) for x in sl]
              for sl in sel]
        for nt in range(len(acc)):
            b = [[int(vt[8 * nt + (lane >> 2), 8 * kb + (lane & 3)]),
                  int(vt[8 * nt + (lane >> 2), 8 * kb + 4 + (lane & 3)])]
                 for lane in range(32)]
            hi = [[0] * 4 for _ in range(32)]
            _mma(hi, ph, b, False)
            _mma(acc[nt], pl, b, False)
            for lane in range(32):
                for i in range(4):
                    acc[nt][lane][i] += 256 * hi[lane][i]
    out = np.zeros((rows, d), np.int8)
    for nt in range(len(acc)):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for r in range(2):
                for e in range(2):
                    row, col = g + 8 * r, 8 * nt + 2 * t + e
                    if row < rows and col < d:
                        assert abs(acc[nt][lane][2 * r + e]) < 2**24
                        o = np.float32(acc[nt][lane][2 * r + e]) \
                            * np.float32(2.0**-15)
                        out[row, col] = np.clip(
                            np.round(o * np.float32(out_scale)), -128, 127)
    return out


@pytest.mark.parametrize("npad,n_real,d,lis_fast", [
    (264, 257, 64, False), (300, 300, 64, True), (577, 577, 32, True)])
def test_model_of_the_long_rows_equals_the_plain_core(npad, n_real, d,
                                                      lis_fast):
    """attend_rows_long, modelled pass for pass, gives the plain version's
    codes at the first and the last query tile: one key past 256 with
    query rows past n_real, a ragged last block of keys, ViT-L's 577 keys
    (D = 32 here: the model is slow)."""
    rng = np.random.default_rng(npad + d)
    q, k, v = (np.clip(np.round(rng.standard_normal((npad, d)) * 14),
                       -128, 127).astype(np.int8) for _ in range(3))
    c1, s_a, out_scale = 0.011, 0.09, 1.7
    f32 = lambda x: torch.tensor(np.float32(x))  # noqa: E731
    want = attention_core_plain(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), f32(c1), f32(s_a),
                                f32(out_scale), n_real=n_real,
                                lis_fast=lis_fast).numpy()
    codes = set()
    for q0 in (0, (npad - 1) // 16 * 16):
        got = _model_long(q, k, v, c1, s_a, out_scale, n_real, lis_fast, q0)
        np.testing.assert_array_equal(got, want[q0:q0 + 16])
        codes |= set(got.ravel().tolist())
    assert len(codes) > 8


# ---- the quad form of the LIS ----

def _lis_exp_plain(a, row_max, scale, fast):
    """lis.cuh's lis_exp in the float32 steps of lis_body_plain."""
    const = lambda v: torch.full_like(scale, v)  # noqa: E731
    from diffvit_tpu_torch.ops.kernels.attention import _B, _C, _X0
    x0 = torch.floor(const(_X0) / scale)
    x = torch.maximum(a - row_max, 32.0 * x0)
    q = torch.floor(x / x0)
    r = x - x0 * q
    poly = r * (r + torch.floor(const(_B) / scale)) \
        + torch.floor(const(_C) / (scale * scale))
    e = poly * pow2(32.0 - q)
    return e if fast else torch.clamp(torch.floor(e), min=0.0)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("n_real,keys", [(197, 256), (256, 256), (49, 64),
                                         (5, 32)])
@pytest.mark.parametrize("scale", [2.0**-10, 0.0123, 0.6])
def test_quad_lis_equals_lis_body_plain(fast, n_real, keys, scale):
    """Lane t of a quad holds keys 8j + 2t + e of its rows: the row max of
    four lanes' maxima and the exact sum of four lanes' int64 partial sums
    give lis_body_plain's weights."""
    rng = np.random.default_rng(n_real + keys)
    a = torch.tensor(np.clip(np.round(rng.standard_normal((16, keys)) * 40),
                             -128, 127), dtype=torch.float32)
    s = torch.tensor(np.float32(scale))
    col_ok = torch.arange(keys) < n_real
    key = torch.arange(keys)
    lane = (key % 8) // 2  # t of key 8j + 2t + e
    maxima = torch.stack([torch.where(col_ok & (lane == t), a, -torch.inf)
                          .amax(-1) for t in range(4)], -1)
    row_max = maxima.amax(-1, keepdim=True)
    e = torch.where(col_ok, _lis_exp_plain(a, row_max, s, fast), 0.0)
    parts = torch.stack([torch.where(lane == t, e, 0.0).to(torch.int64)
                         .sum(-1) for t in range(4)], -1)
    exp_sum = parts.sum(-1, keepdim=True).to(torch.float32)
    got = lis_tail_plain(exp_sum, e)
    want = lis_body_plain(a, s, 4, col_ok, fast=fast)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---- the plans ----

@pytest.mark.parametrize("d", range(4, 65, 4))
@pytest.mark.parametrize("lis", [True, False])
def test_attention_plan_fits_every_accepted_shape(d, lis):
    """Shared memory within the H100's 232,448 bytes, MIN_WARPS to
    QKV_MAX_WARPS warps, every query tile covered, for every npad <= 256
    and n_real the wrappers accept, at b = 1, 3, 8 and 64; the grid fills
    132 SMs where the (image, head, tile) items allow it."""
    for npad in range(1, 257):
        for n_real in {1, (npad + 1) // 2, npad}:
            for batch, heads in ((1, 6), (3, 2), (8, 6), (64, 6)):
                p = attention_plan(batch, heads, npad, d, n_real, lis)
                q_tiles = -(-npad // ROWS)
                assert p.smem <= SMEM_LIMIT
                assert 1 <= p.tiles <= p.warps <= QKV_MAX_WARPS
                assert p.warps == max(p.tiles, MIN_WARPS)
                assert p.split * p.tiles >= q_tiles > (p.split - 1) * p.tiles
                assert p.grid == batch * heads * p.split
                assert p.grid >= min(132, batch * heads * q_tiles)
                assert p.smem >= kv_bytes(n_real, d, lis)


def test_attention_plan_at_deit_small():
    """DeiT-S (6 heads, 197 rows of 64): at b = 1 every one of the 78
    (head, tile) items is a block; at b = 8 and 64 the grid holds at least
    one block an SM with several tiles a block."""
    p1 = attention_plan(1, 6, 197, 64, 197)
    assert (p1.grid, p1.tiles, p1.warps) == (78, 1, MIN_WARPS)
    for b in (8, 64):
        p = attention_plan(b, 6, 197, 64, 197)
        assert p.grid >= 132 and p.warps >= 5
    p = attention_plan(64, 6, 197, 64, 197)
    assert p.smem == EXP_BYTES + kv_bytes(197, 64) + p.warps * CODE_BYTES


@pytest.mark.parametrize("lis", [True, False])
def test_swin_attention_plan_fits(lis):
    """Swin-T's stages at b = 1, 8 and 64 (49 keys, npad 56, D = 32) and
    the tiny Swin's D = 16: within shared memory, at most MAX_WINDOWS
    windows and 8 warps a block, and at least two blocks an SM where the window-heads
    allow it; up to 64 keys and an npad of 120."""
    for b in (1, 8, 64):
        for nw, heads in ((64, 3), (16, 6), (4, 12), (1, 24)):
            for d in (16, 32):
                p = swin_attention_plan(b * nw, heads, 56, d, 49, lis)
                assert p.smem <= SMEM_LIMIT and 1 <= p.warps <= SWIN_MAX_WARPS
                assert 1 <= p.windows <= (min(MAX_WINDOWS, b * nw) if lis
                                          else 1)
                assert p.grid == -(-b * nw // p.windows) * heads
                assert p.grid >= min(264, b * nw * heads // 8)
    assert swin_attention_plan(64 * 64, 3, 56, 32, 49).windows == MAX_WINDOWS
    for npad in (49, 64, 120):
        p = swin_attention_plan(4096, 3, npad, 64, min(npad, SWIN_MAX_KEYS),
                                lis)
        assert p.smem <= SMEM_LIMIT


def test_plans_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="float softmax"):
        attention_plan(1, 6, 300, 64, QKV_MAX_KEYS + 1, lis=False)
    with pytest.raises(ValueError, match="the LIS"):
        attention_plan(1, 6, 800, 64, LIS_MAX_KEYS + 1)
    with pytest.raises(ValueError):
        attention_plan(1, 6, 197, 66, 197)
    with pytest.raises(ValueError):
        swin_attention_plan(64, 3, 70, 32, SWIN_MAX_KEYS + 1)


# ---- the K-major weights of the qkv GEMM ----

def test_kmajor_copies_of_the_qkv_weights_are_kept_per_weight():
    """K1's (Cin, 3C) weight and v1's three (H, Cin, D) weights reach the
    wgmma mainloop as one K-major (3C, Kp) copy each, equal to the
    transposed (Cin, 3C) weight and made once per weight version."""
    rng = np.random.default_rng(3)
    h, cin, d = 2, 40, 16
    w_all = torch.tensor(rng.integers(-8, 8, (cin, 3 * h * d)),
                         dtype=torch.int8)
    wq, wk, wv = (torch.tensor(rng.integers(-8, 8, (h, cin, d)),
                               dtype=torch.int8) for _ in range(3))
    x = torch.zeros((1, 4, cin), dtype=torch.int8)
    for make, dense in (
            (lambda: gemm.kmajor(w_all), w_all),
            (lambda: attention._heads_kmajor(x, wq, wk, wv),
             heads_to_all(wq, wk, wv))):
        first = make()
        assert first.shape == (3 * h * d, 48)
        np.testing.assert_array_equal(first[:, :cin].numpy(),
                                      dense.t().numpy())
        assert not first[:, cin:].any()
        copies = gemm.kmajor.copies
        assert make() is first and gemm.kmajor.copies == copies
    wq.add_(1)  # an in-place write: a new copy, of the new weight
    again = attention._heads_kmajor(x, wq, wk, wv)
    np.testing.assert_array_equal(again[:, :cin].numpy(),
                                  heads_to_all(wq, wk, wv).t().numpy())


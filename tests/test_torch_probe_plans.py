"""The plans of the probes P1, P2, P3 and P5 on the CPU: P1's three
kernels (``ops/kernels/pingpong_plan.py``: the producer, the consumer and
paired's warp roles, item lists, shared memory and register split), the
head-major K-major weight its producer reads, and the K1 plans P5's two
launches take (``probes/attn_overlap.launch_plans``); P2's and P3's plans
(``ops/kernels/overlap_plan.py``: every output tile once, shared memory,
register split, what they refuse), P2's chain sizing and its SASS count.
The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase ``probes``)."""
import dataclasses

import numpy as np
import pytest
import torch

from diffvit_tpu_torch.ops.kernels import gemm
from diffvit_tpu_torch.ops.kernels import overlap_plan as oplan
from diffvit_tpu_torch.ops.kernels import pingpong_plan as plans
from diffvit_tpu_torch.ops.kernels.attn_plan import (CODE_BYTES, EXP_BYTES,
                                                     attention_plan)
from diffvit_tpu_torch.ops.kernels.gemm import SMEM_LIMIT, gemm_plan
from diffvit_tpu_torch.probes import attn_overlap, overlap, pingpong

from test_torch_calibrate import one_torch_thread  # noqa: F401

# (batch, heads, npad, d, n_real): the legs' DeiT-S geometry at B = 1, 8
# and 128, the card tests' small ones, and the widest the kernels take
SHAPES = [(1, 6, 200, 64, 197), (8, 6, 200, 64, 197), (128, 6, 200, 64, 197),
          (2, 2, 24, 16, 21), (3, 6, 45, 64, 33), (1, 1, 256, 64, 256),
          (5, 3, 256, 4, 1), (4, 12, 197, 32, 197)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("sms", [132, 7])
def test_paired_assigns_every_item_once(shape, sms):
    """Block i of paired walks producer items i, i + grid, ... and
    consumer items likewise: together the blocks take every (image, head)
    item and every (image, head, run of tiles) item exactly once, and no
    block is left with neither; a run is at most one tile a consumer warp,
    the runs cover every query tile, and there are items for every SM
    where the tiles allow; the standalone consumer's runs (K1's plan)
    cover every tile too."""
    b, h, npad, d, n_real = shape
    p = plans.paired_plan(b, h, npad, d, n_real, sms)
    prod = [i for blk in range(p.grid) for i in p.producer_list(blk)]
    cons = [i for blk in range(p.grid) for i in p.consumer_list(blk)]
    assert sorted(prod) == list(range(b * h))
    assert sorted(cons) == list(range(p.consumer_items))
    assert all(p.producer_list(blk) or p.consumer_list(blk)
               for blk in range(p.grid))
    assert p.grid == min(sms, max(b * h, p.consumer_items))
    q_tiles = -(-npad // 16)
    for c in (p.consumer, plans.consumer_plan(b, h, npad, d, n_real, sms)):
        assert c.items == b * h * c.split
        assert c.split * c.tiles >= q_tiles > (c.split - 1) * c.tiles
        assert c.tiles <= c.warps
    assert p.consumer.warps == plans.PAIRED_ATTN_WARPS == 16
    assert p.consumer_items >= min(sms, b * h * q_tiles)
    prod_plan = plans.producer_plan(b, h, npad, d, sms)
    assert prod_plan.items == b * h and prod_plan.grid == min(b * h, sms)


@pytest.mark.parametrize("d", range(4, 65, 4))
def test_plans_fit_the_shared_memory(d):
    """Every plan within the H100's 232,448 bytes of shared memory a block,
    for every Npad the kernels take: the producer and paired with the most
    ring stages (of 4, 3, 2) that fit, and the parts laid out as the kernel
    lays them (the ring and its staging, the head buffer, then the
    consumer's table, V^T and 16 warps' scores)."""
    for npad in range(1, 257, 5):
        for n_real in {1, (npad + 1) // 2, npad}:
            prod = plans.producer_plan(8, 6, npad, d)
            cons = plans.consumer_plan(8, 6, npad, d, n_real)
            pair = plans.paired_plan(8, 6, npad, d, n_real)
            for p in (prod, cons, pair):
                assert p.smem <= SMEM_LIMIT
            assert prod.smem == gemm.smem_bytes(plans.BM, plans.BN,
                                                prod.stages) \
                + plans.head_bytes(npad, d)
            assert pair.attn_offset == plans.producer_smem(npad, d,
                                                           pair.stages)
            assert pair.smem - pair.attn_offset == plans.consumer_smem(
                n_real, d, plans.PAIRED_ATTN_WARPS)
            if pair.stages < 4:
                assert plans.producer_smem(npad, d, pair.stages + 1) \
                    + pair.smem - pair.attn_offset > SMEM_LIMIT
            assert pair.attn_offset % 16 == 0 and pair.smem % 16 == 0


def test_consumer_and_head_buffer_layouts():
    """The consumer keeps V^T (DP rows of keys_pad + 16 bytes) and no keys;
    the head buffer's rows are an odd multiple of 16 bytes (conflict-free
    fragment loads) holding q | k | v, with 64 bytes of slack."""
    assert plans.consumer_smem(197, 64, 7) == \
        EXP_BYTES + 64 * (224 + 16) + 7 * CODE_BYTES
    assert plans.consumer_smem(21, 16, 4) == \
        EXP_BYTES + 32 * (32 + 16) + 4 * CODE_BYTES
    for d in range(4, 65, 4):
        ld = plans.head_pitch(d)
        assert ld >= 3 * d and ld % 16 == 0 and (ld // 16) % 2 == 1
        assert ld - 3 * d < 32
        assert plans.head_bytes(200, d) == 208 * ld + 64
    assert plans.head_pitch(64) == 208


@pytest.mark.parametrize("roles,threads", [
    (plans.PRODUCER_ROLES, plans.PRODUCER_THREADS),
    (plans.PAIRED_ROLES, 896)], ids=["producer", "paired"])
def test_register_split_obeys_setmaxnreg(roles, threads):
    """setmaxnreg's counts are multiples of 8 in [24, 256], each role a
    whole number of warpgroups; the moves fit the registers the launch
    allocates (one block an SM), which fit the SM's 64 K; the first role
    (the TMA warpgroup) gives registers up, the second (wgmma) takes them."""
    assert sum(r.warps for r in roles) * 32 == threads
    for r in roles:
        assert r.registers % 8 == 0 and 24 <= r.registers <= 256
        assert r.warps % 4 == 0
    at_launch = plans.launch_registers(threads)
    assert at_launch * threads <= plans.REGISTERS == 65_536
    assert sum(32 * r.warps * r.registers for r in roles) \
        <= at_launch * threads
    assert roles[0].registers <= at_launch <= roles[1].registers
    assert (plans.launch_registers(384), plans.launch_registers(896)) == \
        (168, 72)
    # paired's consumer warps keep the launch's 72 (K1's core, unbounded,
    # takes 67-75)
    assert [r.registers for r in plans.PAIRED_ROLES] == [24, 96, 72]
    assert plans.PAIRED_ROLES[-1].registers <= plans.launch_registers(896)


def test_plans_refuse_what_the_kernels_do_not_take():
    for bad in ((1, 6, 257, 64, 200), (1, 6, 200, 66, 197),
                (1, 6, 200, 64, 201), (0, 6, 200, 64, 197),
                (1, 6, 200, 30, 197)):
        with pytest.raises(ValueError):
            plans.paired_plan(*bad)
        with pytest.raises(ValueError):
            plans.consumer_plan(*bad)


def test_head_major_weight_orders_rows_by_head():
    """The producer's weight: (H * 3D, Kp) with row (h, slot, d) the
    (Cin, 3C) weight's column (slot, h, d), K zero-padded to 16, made once
    per weight and again after an in-place write."""
    rng = np.random.default_rng(5)
    h, d, cin = 3, 8, 40
    w = torch.tensor(rng.integers(-8, 8, (cin, 3 * h * d)), dtype=torch.int8)
    wk = pingpong.head_major_weight(w, h, d)
    assert wk.shape == (3 * h * d, 48) and wk.is_contiguous()
    assert not wk[:, cin:].any()
    for hh in range(h):
        for slot in range(3):
            for dd in range(d):
                assert torch.equal(wk[(hh * 3 + slot) * d + dd, :cin],
                                   w[:, (slot * h + hh) * d + dd])
    assert pingpong.head_major_weight(w, h, d) is wk
    w.add_(1)
    again = pingpong.head_major_weight(w, h, d)
    assert again is not wk and torch.equal(
        again[:, :cin], w.view(cin, 3, h, d).permute(2, 1, 3, 0)
        .reshape(-1, cin))


@pytest.mark.parametrize("batch", [1, 8, 256])
def test_p5_takes_k1_plans(batch):
    """P5's two launches take K1's plans for its shapes: the qkv GEMM's
    (B*Npad, Kp) x 3C plan, and the core's over all Npad keys (n_real =
    Npad, the linear rule masks none), with the LIS's shared memory; at
    B = 1 the core spreads over every (head, tile), at 8 and 256 it fills
    the SMs."""
    gp, ap = attn_overlap.launch_plans(batch, attn_overlap.NP,
                                       attn_overlap.C, attn_overlap.H,
                                       attn_overlap.D, 132)
    npad, h, d = attn_overlap.NP, attn_overlap.H, attn_overlap.D
    assert gp == gemm_plan(batch * npad, 3 * h * d, 384, 132)
    assert ap == attention_plan(batch, h, npad, d, npad, True, 132)
    assert gp.smem <= SMEM_LIMIT and ap.smem <= SMEM_LIMIT
    q_tiles = -(-npad // 16)
    assert ap.split * ap.tiles >= q_tiles
    assert ap.grid == batch * h * ap.split >= min(132, batch * h * q_tiles)
    assert (gp.bm, gp.blocks) == ((64, 1) if batch == 1 else (128, 2))
    if batch == 1:
        assert (ap.grid, ap.tiles) == (78, 1)


def _covered_once(plan, m, n):
    """Every 64-row x 32-column cell of the padded output (whole tiles)
    written by exactly one consumer warpgroup of one block."""
    rows, cols = gemm.round_up(m, plan.bm), gemm.round_up(n, plan.bn)
    count = np.zeros((rows // 64, cols // 32), np.int32)
    for block in range(plan.grid):
        for consumer in (0, 1):
            for r0, c0, h, w in plan.regions(block, consumer):
                count[r0 // 64:(r0 + h) // 64, c0 // 32:(c0 + w) // 32] += 1
    return bool((count == 1).all())


# P2's (M, N, K): the legs' 32768 x 512 x 512, the card tests' ragged rows
# (64: a tile's second consumer past M; 192), a ragged K and K = 0
P2_SHAPES = [(32768, 512, 512), (64, 512, 512), (192, 512, 512),
             (128, 64, 32), (192, 192, 96), (64, 64, 0)]


@pytest.mark.parametrize("shape", P2_SHAPES, ids=str)
@pytest.mark.parametrize("sms", [132, 7])
def test_overlap_plan_assigns_every_tile_once(shape, sms):
    """P2's plan: 128 x 64 tiles, the consumers 64 rows each, a persistent
    grid that gives every block a tile and walks each tile once."""
    m, n, k = shape
    p = oplan.overlap_plan(m, n, k, sms)
    assert (p.bm, p.bn) == (128, 64) and not p.pingpong
    assert p.tiles == -(-m // 128) * (n // 64)
    assert p.grid == min(p.tiles, p.blocks * sms)
    assert all(p.tiles_of(b, 0) for b in range(p.grid))
    assert _covered_once(p, m, n)


@pytest.mark.parametrize("sms", [132, 7])
def test_overlap_plan_fits_and_splits_registers(sms):
    """P2's plan: K2's two blocks an SM with the most stages that fit two
    in an SM's shared memory (the served GEMM's layout, 64 K of bf16 a
    128-byte stage), and setmaxnreg's split (24 and 104 registers) in
    multiples of 8 within 24-256 that the launch's registers cover."""
    p = oplan.overlap_plan(32768, 512, 512, sms)
    assert p.smem == gemm.smem_bytes(128, 64, p.stages) and oplan.fits(p)
    more = dataclasses.replace(p, stages=p.stages + 1,
                               smem=gemm.smem_bytes(128, 64, p.stages + 1))
    assert not oplan.fits(more)
    assert oplan.register_split_ok(p) and p.blocks == oplan.BLOCKS == 2
    assert [r.registers for r in p.roles] == [24, 104]
    assert oplan.P2_K_STAGE * 2 == gemm.BK


@pytest.mark.parametrize("bad", [(0, 512, 512), (96, 512, 512),
                                 (128, 96, 512), (128, 512, 48),
                                 (128, 512, -32)], ids=str)
def test_overlap_plan_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        oplan.overlap_plan(*bad)


# P3's (rows, Cin, Hid): the legs' 50,688 rows, the chip's 197 and 1,000,
# and the card tests' ragged ones
P3_SHAPES = [(50688, 384, 1536), (197, 384, 1536), (1000, 384, 1536),
             (130, 32, 96), (257, 64, 64), (200, 128, 256),
             (257, 1024, 4096), (1000, 928, 928)]


@pytest.mark.parametrize("shape", P3_SHAPES, ids=str)
@pytest.mark.parametrize("mode", oplan.MLP_MODES)
@pytest.mark.parametrize("sms", [132, 7])
def test_mlp_plans_assign_every_tile_once(shape, mode, sms):
    """P3's fc1 and fc2 plans in each mode: every output cell of fc1
    (rows x Hid) and fc2 (rows x Cin) written once; dot, input and nogelu
    and every fc2 take K2's plan; pipelined shares 128 x 64 tiles, staged
    gives each consumer whole 64 x 64 tiles in turn."""
    rows, cin, hid = shape
    fc1, fc2 = oplan.mlp_plans(rows, cin, hid, mode, sms)
    k2 = gemm.gemm_plan(rows, cin, gemm.round_up(hid, 16), sms)
    assert fc2.launch_args() == k2.launch_args() and not fc2.pingpong
    if mode in oplan.OWN_TILES:
        assert (fc1.bm, fc1.bn) == oplan.OWN_TILES[mode]
        assert fc1.blocks == oplan.OWN_BLOCKS[mode]
        assert fc1.pingpong == (mode == "staged")
    else:
        assert fc1.launch_args() == gemm.gemm_plan(
            rows, hid, gemm.round_up(cin, 16), sms).launch_args()
    for p, n in ((fc1, hid), (fc2, cin)):
        assert p.grid == min(p.tiles, p.blocks * sms)
        assert _covered_once(p, rows, n)


@pytest.mark.parametrize("mode", oplan.MLP_MODES)
def test_mlp_plans_fit_and_split_registers(mode):
    """Each mode's fc1 plan fits its blocks in an SM's shared memory with
    setmaxnreg's split within the launch's registers; pipelined at one
    block holds two tiles' K stages at DeiT-S's Cin = 384 (3 stages a
    tile), staged runs at dot's blocks an SM."""
    fc1, fc2 = oplan.mlp_plans(50688, 384, 1536, mode)
    for p in (fc1, fc2):
        assert oplan.fits(p) and oplan.register_split_ok(p)
        assert p.smem == gemm.smem_bytes(p.bm, p.bn, p.stages)
    dot = oplan.mlp_plans(50688, 384, 1536, "dot")[0]
    if mode == "pipelined":
        assert fc1.blocks == 1 and fc1.stages >= 2 * 3
    if mode == "staged":
        assert fc1.blocks == dot.blocks == 2


def _pipelined_ring_runs(k_tiles, stages, tiles, early=True):
    """A model of pipelined's ring (overlap_mlp.cu, fc1_pipelined_kernel):
    one producer filling positions in order, each once both consumers have
    released the position a ring before it, and two consumers that each,
    tile after tile, wait for the tile's positions in order and release
    them when the tile's products are waited for; with ``early``, from the
    ring's depth on a consumer first releases all but its last issued
    stage (wgmma.wait_group 1).  Whether every position is consumed."""
    total = k_tiles * tiles
    filled, released = 0, [[0] * total for _ in range(2)]
    state = [dict(tile=0, kt=0, held_from=0) for _ in range(2)]
    moved = True
    while moved:
        moved = False
        while filled < total and (filled < stages or all(
                r[filled - stages] for r in released)):
            filled, moved = filled + 1, True
        for c, st in enumerate(state):
            while st["tile"] < tiles:
                base, kt = st["tile"] * k_tiles, st["kt"]
                if kt == k_tiles:  # finish: wait_group 0, release the rest
                    for q in range(st["held_from"], base + k_tiles):
                        released[c][q] = 1
                    st.update(tile=st["tile"] + 1, kt=0,
                              held_from=base + k_tiles)
                    moved = True
                    continue
                if early and kt >= stages:
                    for q in range(st["held_from"], base + kt - 1):
                        released[c][q] = 1
                    st["held_from"] = max(st["held_from"], base + kt - 1)
                if base + kt >= filled:
                    break  # waits for the stage to fill
                st["kt"], moved = kt + 1, True
    return all(st["tile"] == tiles for st in state)


@pytest.mark.parametrize("k_tiles", [1, 3, 7, 8, 16])
@pytest.mark.parametrize("stages", [2, 7])
def test_pipelined_ring_runs_at_any_k(k_tiles, stages):
    """pipelined's ring at any K: a tile of more K stages than the ring
    (Cin 928 and up at the plan's 7) runs because the consumer releases
    its retired stages from the ring's depth on; without that release the
    producer would wait on a stage that only the tile itself frees."""
    assert _pipelined_ring_runs(k_tiles, stages, tiles=3)
    assert _pipelined_ring_runs(k_tiles, stages, 3, early=False) \
        == (k_tiles <= stages)


def _staged_ring_stale_waits(k_tiles, stages, tiles, turns=True):
    """A model of staged's ring (fc1_staged_kernel): the block's tiles in
    order, tile i to consumer i % 2, each stage released by its one
    consumer after its products; a consumer skips the other's positions.
    A consumer waits on position p's full barrier with parity (p //
    stages) % 2 and passes when the barrier's phase parity differs, as
    mbarrier.try_wait.parity does.  The consumers run as far as they can
    before the producer fills each position (the worst order); with
    ``turns`` a consumer starts a tile only once the other has finished
    its previous one.  Returns the waits that passed on a stage not yet
    filled for them (stale), and whether every tile finished."""
    total = k_tiles * tiles
    done_phases = [0] * stages        # completed phases of each full barrier
    released = [False] * total
    mainloop_done = [False] * tiles
    at = [dict(tile=c, kt=0) for c in (0, 1)]
    stale, filled = [], 0
    while True:
        moved = True
        while moved:
            moved = False
            for c, st in enumerate(at):
                while st["tile"] < tiles:
                    i = st["tile"]
                    if st["kt"] == 0 and turns and i > 0 \
                            and not mainloop_done[i - 1]:
                        break
                    p = i * k_tiles + st["kt"]
                    n = done_phases[p % stages]
                    if n % 2 == (p // stages) % 2:
                        break  # the wait blocks
                    if n != p // stages + 1:
                        stale.append(p)
                    released[p], moved = True, True
                    st["kt"] += 1
                    if st["kt"] == k_tiles:
                        mainloop_done[i] = True
                        st.update(tile=i + 2, kt=0)
        if filled == total or not (filled < stages
                                   or released[filled - stages]):
            break
        done_phases[filled % stages] += 1
        filled += 1
    return stale, all(st["tile"] >= tiles for st in at)


@pytest.mark.parametrize("k_tiles", [1, 3, 4, 8, 16])
@pytest.mark.parametrize("stages", [2, 4])
def test_staged_ring_takes_turns_at_any_k(k_tiles, stages):
    """staged's ring at any K: with the consumers' mainloops in turn no
    wait passes on a stage before its fill, and every tile finishes;
    without the turns, a tile of as many K stages as the ring or more
    (Cin past 384 at the plan's 4) lets the consumer that skips it read
    a stage a ring early."""
    stale, finished = _staged_ring_stale_waits(k_tiles, stages, tiles=5)
    assert stale == [] and finished
    stale, _ = _staged_ring_stale_waits(k_tiles, stages, 5, turns=False)
    assert (stale == []) == (k_tiles < stages)


@pytest.mark.parametrize("cin", [928, 1024])
def test_mlp_plans_take_k_past_the_pipelined_ring(cin):
    """P3's plans accept Cin past what pipelined's ring holds for a tile
    (ceil(Cin / 128) > stages), as the wrapper does; the kernel releases
    stages as they retire there."""
    fc1, _ = oplan.mlp_plans(1000, cin, 4 * cin, "pipelined")
    assert -(-cin // gemm.BK) > fc1.stages and oplan.fits(fc1)


@pytest.mark.parametrize("bad", [(0, 384, 1536, "dot"), (64, 48, 1536, "dot"),
                                 (64, 384, 1544, "dot"), (64, 384, 352, "dot"),
                                 (64, 384, 1536, "sideways")], ids=str)
def test_mlp_plans_refuse_what_the_kernels_do_not_take(bad):
    with pytest.raises(ValueError):
        oplan.mlp_plans(*bad)


@pytest.mark.parametrize("mode", oplan.MLP_MODES)
@pytest.mark.parametrize("blocks", [None, 1, 2])
def test_mlp_plans_take_a_sweeps_blocks(mode, blocks):
    """``blocks`` sets pipelined's and staged's fc1 blocks an SM (a sweep's
    choice, with the most stages that fit them) and nothing else; the
    other modes refuse it."""
    if blocks is not None and mode not in oplan.OWN_TILES:
        with pytest.raises(ValueError):
            oplan.mlp_plans(50688, 384, 1536, mode, blocks=blocks)
        return
    fc1, fc2 = oplan.mlp_plans(50688, 384, 1536, mode, blocks=blocks)
    chosen = oplan.mlp_plans(50688, 384, 1536, mode)
    assert fc2 == chosen[1]
    if mode in oplan.OWN_TILES:
        assert fc1.blocks == (blocks or oplan.OWN_BLOCKS[mode])
        assert oplan.fits(fc1) and oplan.register_split_ok(fc1)
        assert not oplan.fits(dataclasses.replace(
            fc1, smem=gemm.smem_bytes(fc1.bm, fc1.bn, fc1.stages + 1))) \
            or fc1.stages == gemm.MAX_STAGES
    else:
        assert fc1 == chosen[0]


def _rounds(dot, floor, slope, jitter=(0.0, 0.001, -0.001, 0.0005, 0.0)):
    lo, hi = overlap.SIZING
    return [{"dot_only": dot + j, f"vpu_only_{lo}": floor + slope * lo + j,
             f"vpu_only_{hi}": floor + slope * hi + j} for j in jitter]


def test_size_chain_meets_dot_only_on_the_line():
    """P2's sizing: the line through vpu_only at the two lengths gives the
    floor and the slope, and the chain length where it meets dot_only;
    the spread of each is over the rounds."""
    fit, iters, reason = overlap.size_chain(_rounds(0.30, 0.08, 0.011))
    assert fit["floor_ms"]["median"] == pytest.approx(0.08)
    assert fit["slope_ms"]["median"] == pytest.approx(0.011)
    assert iters == round((0.30 - 0.08) / 0.011) == 20 and reason is None
    assert fit["floor_ms"]["min"] <= 0.08 <= fit["floor_ms"]["max"]


def test_size_chain_is_inconclusive_at_the_floor():
    """dot_only within its spread of the floor measured the bytes: the
    reason says so, and the chain is at least one step."""
    fit, iters, reason = overlap.size_chain(_rounds(0.0805, 0.08, 0.011))
    assert reason is not None and "bytes" in reason and iters == 1


def test_size_chain_is_inconclusive_where_the_chain_is_short_of_the_floor():
    """dot_only clear of the floor, but by less than the floor itself: the
    sized chain's work (slope x iters) is a small share of the bytes every
    mode moves, so the ratios measure the bytes; the reason says so."""
    fit, iters, reason = overlap.size_chain(_rounds(0.1047, 0.0849, 0.0111))
    assert iters == 2 and reason is not None and "bytes" in reason
    assert "2 steps" in reason and "floor" in reason
    _, _, clear = overlap.size_chain(_rounds(0.30, 0.08, 0.011))
    assert clear is None


SASS = """
        /*0000*/                   MOV R1, c[0x0][0x28] ;   /* 0x00000a0000017a02 */
        /*0010*/                   MUFU.RCP R0, R0 ;         /* 0x0000000000007308 */
        /*0020*/                   FMUL R2, R0, 0.25 ;       /* 0x3e80000000027820 */
        /*0030*/                   MUFU.EX2 R3, R2 ;         /* 0x0000000200037308 */
        /*0040*/                   MUFU.EX2 R4, R2 ;         /* 0x0000000200047308 */
        /*0050*/                   FFMA R5, R3, R4, R2 ;     /* 0x0000000403057223 */
        /*0060*/                   MUFU.RCP R6, R5 ;         /* 0x0000000500067308 */
        /*0070*/                   MUFU.RCP R7, R5 ;         /* 0x0000000500077308 */
        /*0080*/                   FSETP.GE.AND P0, PT, R5, 0.6, PT ;
        /*0090*/                   LOP3.LUT R8, R5, 0x80000000, RZ, 0xc0, !PT ;
        /*00a0*/               @P1 BRA 0x30 ;            /* 0xfffffffc00e00947 */
.L_x_3:
        /*00b0*/                   FADD R9, R9, 1 ;          /* 0x3f80000009097421 */
        /*00c0*/              @!P2 BRA `(.L_x_3) ;
        /*00d0*/                   BRA 0x0 ;                 /* 0xffffff0000007947 */
        /*00e0*/                   EXIT ;
"""


def test_sass_loops_and_the_chain_count():
    """The SASS reader: backward branches to an address (as cuobjdump
    prints them) or to a label open a loop; the chain's count takes the
    innermost loop with at least ``steps`` special-function instructions
    and divides each unit's instructions by the steps."""
    loops = overlap.sass_loops(SASS)
    assert [len(lp["opcodes"]) for lp in loops] == [8, 2, 14]
    assert loops[2]["branches"] == 2
    got = overlap.count_chain(SASS, steps=2)
    assert got["loop_instructions"] == 8 and got["loop_branches"] == 0
    assert (got["sfu"], got["fp32"], got["other"]) == (2.0, 1.0, 1.0)
    assert got["mufu"] == ["MUFU.EX2", "MUFU.RCP"]
    with pytest.raises(ValueError):
        overlap.count_chain(SASS, steps=8)

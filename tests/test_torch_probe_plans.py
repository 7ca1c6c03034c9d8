"""The plans of the probes P1 and P5 on the CPU: P1's three kernels
(``ops/kernels/pingpong_plan.py``: the producer, the consumer and paired's
warp roles, item lists, shared memory and register split), the head-major
K-major weight its producer reads, and the K1 plans P5's two launches take
(``probes/attn_overlap.launch_plans``).  The kernels themselves run only on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase
``probes``)."""
import numpy as np
import pytest
import torch

from diffvit_tpu_torch.ops.kernels import gemm
from diffvit_tpu_torch.ops.kernels import pingpong_plan as plans
from diffvit_tpu_torch.ops.kernels.attn_plan import (CODE_BYTES, EXP_BYTES,
                                                     attention_plan)
from diffvit_tpu_torch.ops.kernels.gemm import SMEM_LIMIT, gemm_plan
from diffvit_tpu_torch.probes import attn_overlap, pingpong

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

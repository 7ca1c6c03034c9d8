"""The plain-Python side of the resident encoder K6 (``ops/kernels/serve.py``),
on the CPU: ``resident_plan``'s invariants, the K-major weight stacks its
TMA maps read, TMA's rule on its scratch, the barrier stamps' decoding,
and ``prepare_resident`` against the JAX package's.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``);
what it takes from Python is held here at TINY and DeiT-S widths, which
take seconds."""
import dataclasses

import numpy as np
import pytest
import torch

from diffvit_tpu.config import QuantConfig as JaxQuantConfig
from diffvit_tpu.models import vit as jax_vit
from diffvit_tpu.ops.pallas.serve import prepare_resident as jax_prepare

from diffvit_tpu_torch import QuantConfig
from diffvit_tpu_torch.models.convert import int_model_from_numpy
from diffvit_tpu_torch.models.vit import VIT_SPECS, ViTSpec
from diffvit_tpu_torch.ops.kernels import serve
from diffvit_tpu_torch.ops.kernels.attn_plan import attention_plan
from diffvit_tpu_torch.ops.kernels.gemm import (MAX_STAGES, SMEM_LIMIT,
                                                kmajor, smem_bytes,
                                                tma_operand_error)
from diffvit_tpu_torch.ops.quant import int_matmul
from diffvit_tpu_torch.testing import random_int_model

TINY = ViTSpec("test_tiny", embed_dim=64, depth=2, num_heads=2,
               num_classes=10)
DEIT_S = VIT_SPECS["deit_small"]
SPECS = {"tiny": TINY, "deit_s": DEIT_S}


@pytest.mark.parametrize("lis", [True, False], ids=["lis", "softmax"])
@pytest.mark.parametrize("batch", [1, 8, 64])
@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_resident_plan_invariants(spec_name, batch, lis):
    """Every step's items fit the grid's loop; the attention items are
    attention_plan's blocks; the shared memory holds both the ring and the
    attention part and no more than a block may have (half an SM's, less
    the card's reserve, at the two blocks an SM that past 256 rows take);
    no GEMM tile of N crosses a layer of its weight stack."""
    spec = SPECS[spec_name]
    npad = spec.seq_len
    plan = serve.resident_plan(batch, npad, spec, lis)
    c, hid = spec.embed_dim, spec.hidden_dim
    assert plan.threads == 288
    assert plan.blocks == (2 if batch * npad > 256 else 1)
    assert len(plan.items) == len(plan.rounds) == len(serve.STEPS)
    for items, rounds in zip(plan.items, plan.rounds):
        assert items <= plan.grid * rounds
        assert rounds == 1 or items > plan.grid * (rounds - 1)
    assert plan.grid == min(plan.blocks * 132, max(plan.items))
    ap = attention_plan(batch, spec.num_heads, npad, spec.head_dim,
                        spec.seq_len, lis)
    assert (plan.attn_tiles, plan.attn_split) == (ap.tiles, ap.split)
    assert plan.attn_tiles * plan.attn_split >= -(-npad // 16)
    assert plan.attn_tiles <= serve.WARPS
    assert plan.items[serve.STEPS.index("attention")] == \
        batch * spec.num_heads * ap.split
    assert 2 <= plan.stages <= MAX_STAGES
    assert plan.gemm_smem == smem_bytes(serve.TILE, serve.TILE, plan.stages)
    assert plan.attn_smem == serve.attn_smem(spec.seq_len, lis)
    assert plan.smem == max(plan.gemm_smem, plan.attn_smem) <= SMEM_LIMIT
    assert SMEM_LIMIT <= 227 * 1024
    if plan.blocks == 2:
        assert 2 * (plan.smem + serve.BLOCK_RESERVED) <= serve.SM_SMEM
    m_tiles = -(-batch * npad // serve.TILE)
    for step, n in zip(serve.GEMM_STEPS, (3 * c, c, hid, c)):
        assert n % serve.TILE == 0, (step, n)  # no tile across a layer
        assert plan.items[serve.STEPS.index(step)] == \
            m_tiles * n // serve.TILE
    assert plan.launch_args() == (plan.stages, plan.smem, plan.blocks,
                                  plan.grid, plan.attn_tiles,
                                  plan.attn_split)


def test_resident_plan_at_deit_s():
    """DeiT-S at b = 1: one block an SM, 96 blocks (the fc1 step's tiles),
    8 stages, 78 attention items of one query tile; at b = 64, either
    softmax: two blocks an SM, 4 stages, 264 blocks.  An EncoderShape of
    the same widths plans the same."""
    p1 = serve.resident_plan(1, 197, DEIT_S)
    assert (p1.stages, p1.blocks, p1.grid) == (8, 1, 96)
    assert p1.items == (22, 72, 78, 24, 22, 96, 24)
    for lis in (False, True):
        p64 = serve.resident_plan(64, 197, DEIT_S, lis)
        assert (p64.stages, p64.blocks, p64.grid) == (4, 2, 264)
    shape = serve.EncoderShape(384, 6, 1536, 197)
    assert serve.resident_plan(64, 197, shape) == p64


@pytest.mark.parametrize("spec,match", [
    (dataclasses.replace(TINY, embed_dim=96, num_heads=3), "multiples of 64"),
    (dataclasses.replace(TINY, embed_dim=256, num_heads=2), "head_dim"),
    (dataclasses.replace(TINY, img_size=272), "n_real")])
def test_resident_plan_refuses_what_the_kernel_does_not_take(spec, match):
    """C or hidden off a multiple of 64 (a GEMM tile would cross a layer),
    a head wider than 64, more than 256 keys: ValueError."""
    with pytest.raises(ValueError, match=match):
        serve.resident_plan(1, spec.seq_len, spec)


def _packed(spec, seed=0):
    cfg = QuantConfig()
    ip = int_model_from_numpy(random_int_model(spec, cfg, seed=seed), spec,
                              "cpu", cfg)
    return serve.prepare_resident(ip, spec, cfg)


@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_kmajor_stacks_are_per_layer_kmajor(spec_name):
    """Layer l of each K-major stack is ``gemm.kmajor`` of the layer's
    (K, N) weight; wproj's K runs head-major (h * D + d), as
    ``resident_codes_plain`` reshapes (H, D, C) to (C, C), so the proj of
    the attention output's rows equals the plain version's product.  Made
    once per packed model."""
    spec = SPECS[spec_name]
    packed = _packed(spec)
    km = serve.resident_kmajor(packed)
    depth, c, hid = spec.depth, spec.embed_dim, spec.hidden_dim
    assert {k: tuple(v.shape) for k, v in km.items()} == {
        "wqkv": (depth, 3 * c, c), "wproj": (depth, c, c),
        "w1": (depth, hid, c), "w2": (depth, c, hid)}
    for layer in range(depth):
        for k in ("wqkv", "w1", "w2"):
            assert torch.equal(km[k][layer], kmajor(packed[k][layer])), k
        w = packed["wproj"][layer].reshape(c, c)
        assert torch.equal(km["wproj"][layer], kmajor(w))
        o = torch.tensor(np.random.default_rng(layer).integers(
            -128, 128, (5, c)), dtype=torch.int8)
        assert torch.equal(int_matmul(o, w),
                           o.to(torch.int32) @ km["wproj"][layer].to(
                               torch.int32).T)
    assert serve.resident_kmajor(packed) is km


@pytest.mark.parametrize("batch", [1, 8, 64])
@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_scratch_offsets_keep_tma_rule(spec_name, batch):
    """The act and hidden scratch that K6 reads through TMA start on
    16-byte boundaries of a 16-byte aligned buffer and have rows of a
    multiple of 16 bytes; the four parts tile the buffer without overlap.
    A width off 16 bytes breaks the rule, and the rule says so."""
    spec = SPECS[spec_name]
    rows, c, hid = batch * spec.seq_len, spec.embed_dim, spec.hidden_dim
    layout = serve.scratch_layout(rows, c, hid)
    end = 0
    for name in ("act", "hc2", "qkv", "hidden"):
        off, row = layout[name]
        assert off == end
        end = off + rows * row
    assert end == rows * (5 * c + hid)
    for name in serve.TMA_SCRATCH:
        off, row = layout[name]
        assert tma_operand_error(4096 + off, [row]) is None
    assert "row stride" in tma_operand_error(4096, [40])
    assert "aligned" in tma_operand_error(4096 + 8, [64])


def test_step_times_decode_the_barrier_stamps():
    """Block 0's stamps [start, (arrival, departure) x 7 * depth] give the
    steps' ms by kind (the two LN steps together) and the waits, which sum
    to the total; a buffer of the wrong length is refused."""
    depth = 2
    stamps, t = [1000], 1000
    busy = {"ln1": 10, "qkv": 20, "attention": 30, "proj": 40, "ln2": 50,
            "fc1": 60, "fc2": 70}
    for _ in range(depth):
        for step in serve.STEPS:
            t += 1000 * busy[step]
            stamps.append(t)
            t += 5000  # the wait
            stamps.append(t)
    ms = serve.step_times(stamps, depth)
    assert ms["ln"] == pytest.approx(depth * 60e-3)
    for k in ("qkv", "attention", "proj", "fc1", "fc2"):
        assert ms[k] == pytest.approx(depth * busy[k] * 1e-3)
    assert ms["barrier_wait"] == pytest.approx(depth * 7 * 5e-3)
    assert sum(ms[k] for k in serve.STEP_KINDS) == pytest.approx(ms["total"])
    with pytest.raises(ValueError, match="stamps"):
        serve.step_times(stamps[:-1], depth)


def test_prepare_resident_still_equals_jax():
    """The packed tensors the kernel reads (and the stacks are made from)
    equal the JAX package's array for array, on a random TINY int-model;
    the K-major stacks are kept beside them, not in them."""
    ip_np = random_int_model(TINY, QuantConfig(), seed=1)
    jspec = jax_vit.ViTSpec("test_tiny", embed_dim=64, depth=2, num_heads=2,
                            num_classes=10)
    packed_j = jax_prepare(ip_np, jspec, JaxQuantConfig())
    packed = _packed(TINY, seed=1)
    serve.resident_kmajor(packed)
    assert set(packed) == set(packed_j)
    for k, v in packed.items():
        if k == "lis_fast":
            assert v == packed_j[k]
        else:
            np.testing.assert_array_equal(v.numpy(), np.asarray(packed_j[k]))

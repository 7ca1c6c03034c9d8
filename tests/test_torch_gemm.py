"""The Python side of the Hopper GEMM mainloop that K2 and K3 run on
(``diffvit_tpu_torch/ops/kernels/gemm.py``), on the CPU.

The kernel itself (``csrc/wgmma_gemm.cuh``) runs only on the card, where
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold it; what reaches it
from here is plain Python: the tile plan, TMA's operand rule, the K-major
weight copies and the K padding.  The padded product is held against the
JAX Pallas kernels in interpret mode, exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffvit_tpu.ops.pallas.linear import fused_int_linear as jax_linear
from diffvit_tpu.ops.pallas.mlp import fused_int_mlp as jax_mlp

from diffvit_tpu_torch.ops.kernels import gemm
from diffvit_tpu_torch.ops.kernels.gemm import (gemm_plan, kmajor, pad_k,
                                                tma_operand_error)
from diffvit_tpu_torch.ops.kernels.mlp import gelu_poly
from diffvit_tpu_torch.ops.quant import int_matmul

from test_torch_calibrate import one_torch_thread  # noqa: F401

# (M, N, K) of the model sites: DeiT-S and Swin-T at b = 1 and 64 (qkv,
# proj, fc1, fc2, head, patch), P3's legs, and ragged test shapes
SHAPES = [(197, 1152, 384), (197, 384, 384), (197, 1536, 384),
          (197, 384, 1536), (1, 1000, 384), (196, 384, 768),
          (12608, 1152, 384), (12608, 384, 384), (12608, 1536, 384),
          (12608, 384, 1536), (64, 1000, 384), (12544, 384, 768),
          (200704, 288, 96), (200704, 384, 96), (200704, 96, 384),
          (50176, 3072, 768), (3136, 768, 3072), (50688, 1536, 384),
          (77, 37, 112), (200, 1000, 48), (3136, 96, 48), (257, 8, 16)]


# wgmma_gemm.cuh's dispatch_tile: (BM, BN, blocks an SM)
TILES = {(64, 64, 1), (64, 128, 1), (128, 64, 1), (128, 128, 1),
         (128, 64, 2)}


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_gemm_plan_invariants(m, n, k):
    """The plan fits the card and covers the product: shared memory within
    a block's 232,448 bytes, a 64-row tile at the b = 1 sites (M <= 256),
    BN a multiple of 8 up to 256, at least a 3-stage ring, a grid of one
    block an SM at most, whose blocks walk every tile."""
    for sms in (132, 114):
        p = gemm_plan(m, n, k, sms)
        assert p.smem == gemm.smem_bytes(p.bm, p.bn, p.stages) \
            <= gemm.SMEM_LIMIT
        assert p.bm == (64 if m <= 256 else 128)
        assert p.bn % 8 == 0 and 8 <= p.bn <= 256
        assert (p.bm, p.bn, p.blocks) in TILES  # the kernel's instances
        assert p.bk == 128 and 3 <= p.stages <= gemm.MAX_STAGES
        assert p.tiles == -(-m // p.bm) * -(-n // p.bn)
        assert p.tiles * p.bm * p.bn >= m * n
        assert 1 <= p.grid <= min(p.tiles, p.blocks * sms)
        assert p.smem * p.blocks <= gemm.SMEM_LIMIT
        assert p.launch_args() == (p.bm, p.bn, p.blocks, p.stages, p.smem,
                                   p.grid)


@pytest.mark.parametrize("k,n", [(48, 96), (100, 37), (384, 1000),
                                 (1536, 384)])
def test_tma_strides_of_padded_operands(k, n):
    """Every stride TMA reads is a multiple of 16 bytes: K-major weights
    and padded activations have Kp = K rounded up to 16."""
    rng = np.random.default_rng(k + n)
    w = torch.tensor(rng.integers(-8, 8, (k, n)).astype(np.int8))
    x = torch.tensor(rng.integers(-128, 128, (5, k)).astype(np.int8))
    wk, xp = kmajor(w), pad_k(x, -(-k // 16) * 16)
    for t in (wk, xp):
        assert t.is_contiguous() and t.shape[1] % 16 == 0
        assert tma_operand_error(t.data_ptr(), [t.stride(0)]) is None
    assert wk.shape[1] == xp.shape[1] == gemm.round_up(k, 16)
    assert (pad_k(x, x.shape[1]) is x)


def test_kmajor_is_the_zero_padded_transpose():
    w = torch.tensor(np.random.default_rng(0).integers(
        -128, 128, (100, 37)).astype(np.int8))
    wk = kmajor(w)
    assert wk.shape == (37, 112) and wk.dtype == torch.int8
    assert torch.equal(wk[:, :100], w.t())
    assert not wk[:, 100:].any()


def test_kmajor_copies_once_per_weight_and_again_after_a_write():
    rng = np.random.default_rng(1)
    w = torch.tensor(rng.integers(-8, 8, (64, 32)).astype(np.int8))
    other = torch.tensor(rng.integers(-8, 8, (64, 32)).astype(np.int8))
    before = kmajor.copies
    first = kmajor(w)
    assert kmajor(w) is first and kmajor.copies == before + 1
    kmajor(other)
    assert kmajor.copies == before + 2
    w[3, 5] = 7  # an in-place write moves the version: a new copy
    again = kmajor(w)
    assert kmajor.copies == before + 3 and again is not first
    assert int(again[5, 3]) == 7 and torch.equal(again[:, :64], w.t())
    assert kmajor(w) is again and kmajor.copies == before + 3


def test_kmajor_of_an_inference_tensor_is_kept():
    with torch.inference_mode():
        w = torch.ones((16, 8), dtype=torch.int8)
    before = kmajor.copies
    assert kmajor(w) is kmajor(w) and kmajor.copies == before + 1


@pytest.mark.parametrize("ptr,strides,ok", [
    (0x7f0000000000, [384], True), (0x7f0000000010, [16, 4096], True),
    (0x7f0000000008, [384], False), (0x7f0000000001, [384], False),
    (0x7f0000000000, [100], False), (0x7f0000000000, [384, 8], False)])
def test_tma_operand_rule(ptr, strides, ok):
    """A base off a 16-byte boundary or a row stride that is no multiple of
    16 bytes is refused, with the reason."""
    err = tma_operand_error(ptr, strides)
    assert (err is None) == ok
    if not ok:
        assert "16" in err


def test_require_tma_operand_refuses_a_view_one_byte_off():
    buf = torch.zeros(16 * 65, dtype=torch.int8)
    good = buf[:16 * 64].view(64, 16)
    gemm.require_tma_operand(good, "x")
    with pytest.raises(ValueError, match="aligned"):
        gemm.require_tma_operand(buf[1:1 + 16 * 64].view(64, 16), "x")


def _padded_product(x, w):
    """The kernel's product on the CPU: x with K padded to Kp times the
    K-major copy, as the card computes it."""
    wk = kmajor(w)
    return int_matmul(pad_k(x, wk.shape[1]), wk.t())


@pytest.mark.parametrize("rows,k,n", [(256, 48, 96), (256, 100, 37),
                                      (256, 384, 1000)])
@pytest.mark.parametrize("mode", ["fq", "codes"])
def test_padded_product_matches_pallas_linear(rows, k, n, mode):
    """K3's arithmetic on the padded product equals the JAX
    fused_int_linear in interpret mode at K = 48, K = 100 and N = 1000:
    the padded K adds nothing, and the quantized modes are exact."""
    rng = np.random.default_rng(rows + k + n)
    x = rng.integers(-128, 128, (rows, k)).astype(np.int8)
    w = rng.integers(-8, 8, (k, n)).astype(np.int8)
    mult = rng.uniform(0.001, 0.01, n).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    out_scale = np.float32(0.05)
    want = np.asarray(jax_linear(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(mult), jnp.asarray(bias),
        out_scale=jnp.asarray(out_scale), emit_codes=mode == "codes",
        block_rows=256, sub=256, interpret=True))
    acc = _padded_product(torch.tensor(x), torch.tensor(w))
    np.testing.assert_array_equal(
        acc.numpy(), x.astype(np.int64) @ w.astype(np.int64))
    y = acc.to(torch.float32) * torch.tensor(mult) + torch.tensor(bias)
    inv = torch.ones(1) / torch.tensor(out_scale)
    codes = torch.clamp(torch.round(y * inv), -128, 127)
    got = codes.to(torch.int8) if mode == "codes" \
        else codes * torch.tensor(out_scale)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cin,hid,cout", [(48, 192, 48), (100, 400, 100),
                                          (64, 256, 1000)])
def test_padded_products_match_pallas_mlp(cin, hid, cout):
    """K2's two GEMMs on padded operands (x's K and the hidden stride
    rounded up to 16, zero weight columns beside them) with its epilogues
    equal the JAX fused_int_mlp in interpret mode: the int8 codes, exactly,
    at Cin = 48, Cin = 100 and Cout = 1000."""
    rows = 512
    rng = np.random.default_rng(cin + hid + cout)
    x = np.clip(np.round(rng.standard_normal((rows, cin)) * 30), -128,
                127).astype(np.int8)
    w1 = rng.integers(-8, 8, (cin, hid)).astype(np.int8)
    w2 = rng.integers(-8, 8, (hid, cout)).astype(np.int8)
    mult1 = np.full(hid, 2.0 ** -10, np.float32)
    bias1 = rng.uniform(-0.5, 0.5, hid).astype(np.float32)
    mult2 = np.full(cout, 2.0 ** -9, np.float32)
    bias2 = rng.uniform(-0.5, 0.5, cout).astype(np.float32)
    out_scale = np.float32(2.0 ** -5)
    s_q1 = np.float32(2.0 ** -6)
    want = np.asarray(jax_mlp(*map(jnp.asarray, (
        x, w1, w2, mult1, bias1, mult2, bias2, out_scale, s_q1)),
        emit_codes=True, interpret=True))
    t = torch.tensor
    mid = _padded_product(t(x), t(w1)).to(torch.float32) * t(mult1) \
        + t(bias1)
    g = torch.clamp(torch.round(gelu_poly(mid) * (1.0 / t(s_q1))), -128, 127)
    hidden = g.to(torch.int8)
    assert pad_k(hidden, gemm.round_up(hid, 16)).shape[1] \
        == kmajor(t(w2)).shape[1]
    y = _padded_product(hidden, t(w2)).to(torch.float32) * t(mult2) \
        + t(bias2)
    got = torch.clamp(torch.round(y * (1.0 / t(out_scale))), -128, 127)
    np.testing.assert_array_equal(got.to(torch.int8).numpy(), want)

"""The CUDA kernels vs their plain PyTorch versions, on a CUDA card.

This file imports neither JAX nor the JAX package, so it runs where the
card is: ``python -m pytest --noconftest tests/test_torch_cuda.py``
(tests/conftest.py imports JAX).  Every test carries the ``cuda`` marker;
without a card each skips.  K1, K2 and K5 share their device code with
the resident kernel K6 (``csrc/wgmma_gemm.cuh``, ``attention_mma.cuh``,
``lis.cuh``, ``int_mlp.cuh``), and K3, K7a, K7b and K8 with them; their
tests here hold each exact against its plain version.  K2, K3, K7b, the
qkv GEMM of K1, K7a and K8 and K6's four GEMM steps run on the wgmma
mainloop (``csrc/wgmma_gemm.cuh``); the attention of K1, K5, K6, K7a, K8
and K4/K4b on the tensor-core core (``csrc/attention_mma.cuh``); K7a's
proj on ``int8_gemm.cuh``'s tile."""
import dataclasses

import numpy as np
import pytest
import torch

from diffvit_tpu_torch import QuantConfig, engine
from diffvit_tpu_torch.data.synthetic import gaussian_calibration
from diffvit_tpu_torch.models import swin_int, vit_int
from diffvit_tpu_torch.models.convert import (attn_constants,
                                              int_attn_scalars,
                                              int_model_from_numpy,
                                              swin_block_constants,
                                              swin_int_model_from_numpy)
from diffvit_tpu_torch.models.swin import SWIN_SPECS, SwinSpec
from diffvit_tpu_torch.models.vit import VIT_SPECS, ViTSpec, init_params
from diffvit_tpu_torch.ops.bit_types import BIT_TYPE_DICT
from diffvit_tpu_torch.ops.kernels.attention import (
    fused_int_attention, fused_int_attention_plain, fused_qkv_attention_v2,
    fused_qkv_attention_v2_plain)
from diffvit_tpu_torch.ops.kernels.mlp import (fused_int_mlp,
                                               fused_int_mlp_plain)
from diffvit_tpu_torch.ops.kernels.serve import (prepare_resident,
                                                 resident_codes,
                                                 resident_codes_plain)
from diffvit_tpu_torch.ops.kernels.swin_attention import (
    fused_swin_attention, fused_swin_attention_v2, swin_attention_plain)
from diffvit_tpu_torch.testing import random_int_model, random_swin_int_model

TINY = ViTSpec("test_tiny", embed_dim=64, depth=2, num_heads=2,
               num_classes=10)
SMALL = dataclasses.replace(VIT_SPECS["deit_small"], depth=1)
SMALL2 = dataclasses.replace(VIT_SPECS["deit_small"], depth=2)
DEIT_S = VIT_SPECS["deit_small"]  # full depth: 12 blocks

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _block(spec, seed=0):
    ib = random_int_model(spec, seed=seed)["blocks"][0]
    return ib, attn_constants(ib, spec, 0)[0]


def _codes(shape, seed):
    rng = np.random.default_rng(seed)
    return np.clip(np.round(rng.standard_normal(shape) * 30), -128,
                   127).astype(np.int8)


@pytest.mark.parametrize("spec,batch,npad,n_real,lis_fast", [
    (TINY, 2, 200, 197, False), (TINY, 2, 200, 197, True),
    (TINY, 3, 45, 33, True), (SMALL, 2, 197, 197, True),
    (SMALL, 1, 256, 256, False)])
def test_qkv_attention_kernel_matches_plain(cuda, spec, batch, npad, n_real,
                                            lis_fast):
    ib, scalars = _block(spec)
    dev = lambda a: torch.tensor(np.asarray(a), device=cuda)  # noqa: E731
    q = ib["qkv"]
    args = (dev(_codes((batch, npad, spec.embed_dim), 1)), dev(q["w_int"]),
            dev(q["mult"]), dev(q["b"]), dev(scalars))
    kw = dict(num_heads=spec.num_heads, head_dim=spec.head_dim,
              n_real=n_real, lis_fast=lis_fast)
    before = fused_qkv_attention_v2.launches
    got = fused_qkv_attention_v2(*args, **kw)
    torch.cuda.synchronize()
    assert fused_qkv_attention_v2.launches == before + 1
    want = fused_qkv_attention_v2_plain(*args, **kw)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def _assert_softmax_codes_close(got, want):
    """The float softmax's rule (the JAX suite's): within 1 code on fewer
    than 2% of codes."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and np.mean(diff > 0) < 0.02, \
        (diff.max(), np.mean(diff > 0))


@pytest.mark.parametrize("spec,batch,npad", [(TINY, 2, 200), (SMALL, 2, 197),
                                             (SMALL, 1, 256)])
def test_qkv_attention_float_softmax_kernel_matches_plain(cuda, spec, batch,
                                                          npad):
    """K1 with lis=False (the float softmax rounded to bfloat16)."""
    ib, scalars = _block(spec)
    dev = lambda a: torch.tensor(np.asarray(a), device=cuda)  # noqa: E731
    q = ib["qkv"]
    args = (dev(_codes((batch, npad, spec.embed_dim), 5)), dev(q["w_int"]),
            dev(q["mult"]), dev(q["b"]), dev(scalars))
    kw = dict(num_heads=spec.num_heads, head_dim=spec.head_dim, n_real=197,
              bits=8, lis=False)
    before = fused_qkv_attention_v2.launches
    got = fused_qkv_attention_v2(*args, **kw)
    torch.cuda.synchronize()
    assert fused_qkv_attention_v2.launches == before + 1
    want = fused_qkv_attention_v2_plain(*args, **kw)
    _assert_softmax_codes_close(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("lis", [True, False], ids=["lis", "softmax"])
@pytest.mark.parametrize("spec,batch,npad", [
    (TINY, 1, 197), (TINY, 3, 200), (SMALL2, 1, 197), (SMALL2, 3, 197),
    (SMALL2, 8, 197), (SMALL2, 64, 197), (DEIT_S, 1, 197)])
def test_resident_kernel_matches_plain(cuda, spec, batch, npad, lis):
    """K6 (every block in one cooperative launch) vs its plain version;
    rows past the 197 tokens of an image are zero padding.  Three launches
    on the same input, each held against the plain version: a step's TMA
    read of a scratch row that another block's generic store had not
    reached would show as a stray code now and then (DeiT-S width at b=64
    with two blocks of distinct weights, and the full 12 blocks at b=1)."""
    cfg = QuantConfig()
    ip = int_model_from_numpy(random_int_model(spec, cfg, seed=2), spec,
                              cuda, cfg)
    packed = prepare_resident(ip, spec, cfg)
    x = _codes((batch, npad, spec.embed_dim), 6)
    x[:, 197:] = 0
    x = torch.tensor(x.reshape(batch * npad, -1), device=cuda)
    kw = dict(n_real=197, bits=4, lis=lis, nelems=batch)
    want = resident_codes_plain(packed, x, **kw)

    def real(t):
        return t.reshape(batch, npad, -1)[:, :197].cpu().numpy()
    for _ in range(3):
        before = resident_codes.launches
        got = resident_codes(packed, x, **kw)
        torch.cuda.synchronize()
        assert resident_codes.launches == before + 1
        if lis:
            np.testing.assert_array_equal(real(got), real(want))
        else:
            _assert_softmax_codes_close(real(got), real(want))


def test_resident_step_times_leave_the_codes_alone(cuda):
    """K6 with its barrier stamps on (scripts/port_resident.py) gives the
    codes of the served launch, and block 0's step times: every kind
    positive but the waits, which with the steps sum to the total."""
    from diffvit_tpu_torch.ops.kernels.serve import (STEP_KINDS,
                                                     resident_step_ms)
    cfg = QuantConfig()
    ip = int_model_from_numpy(random_int_model(SMALL2, cfg, seed=2), SMALL2,
                              cuda, cfg)
    packed = prepare_resident(ip, SMALL2, cfg)
    x = torch.tensor(_codes((8 * 197, 384), 6), device=cuda)
    kw = dict(n_real=197, lis=True, nelems=8)
    want = resident_codes(packed, x, bits=4, **kw)
    ms = resident_step_ms(packed, x, **kw)
    assert set(ms) == set(STEP_KINDS) | {"total"}
    assert all(ms[k] > 0 for k in STEP_KINDS if k != "barrier_wait"), ms
    assert ms["barrier_wait"] >= 0
    assert abs(sum(ms[k] for k in STEP_KINDS) - ms["total"]) < 1e-3, ms
    np.testing.assert_array_equal(
        resident_codes(packed, x, bits=4, **kw).cpu().numpy(),
        want.cpu().numpy())


def test_resident_footprint(cuda):
    """K6 at DeiT-S b = 1, 8, 64, both softmaxes: no local memory (no
    spills), the plan's shared memory, at least the plan's one block an SM
    (the cooperative launch needs every block resident).  Printed with
    -s."""
    from diffvit_tpu_torch.ops.kernels.serve import (device_resident_plan,
                                                     resident_footprint)
    for lis in (True, False):
        for b in (1, 8, 64):
            f = resident_footprint(b, 197, DEIT_S, cuda, lis=lis)
            plan = device_resident_plan(b, 197, DEIT_S, lis, cuda)
            print("resident", b, lis, f)
            assert f["local_bytes"] == 0, f
            assert f["smem_bytes"] >= plan.smem, f
            assert f["blocks_per_sm"] >= plan.blocks, f


def test_resident_refuses_a_plan_the_card_cannot_hold(cuda):
    """A grid larger than the card holds at once, or more shared memory
    than a block may have, raises at launch instead of hanging or running
    short; nothing falls back."""
    from diffvit_tpu_torch.ops.kernels import serve
    cfg = QuantConfig()
    ip = int_model_from_numpy(random_int_model(TINY, cfg, seed=2), TINY,
                              cuda, cfg)
    packed = prepare_resident(ip, TINY, cfg)
    x = torch.tensor(_codes((2 * 197, 64), 6), device=cuda)
    plan = serve.device_resident_plan(
        2, 197, serve.EncoderShape(64, 2, 256, 197), True, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for bad in (dataclasses.replace(plan, grid=plan.blocks * sms + 1),
                dataclasses.replace(plan, smem=300_000),
                dataclasses.replace(plan, smem=plan.attn_smem - 16)):
        with pytest.raises(RuntimeError, match="resident_codes"):
            serve._launch(packed, x, n_real=197, lis=True, nelems=2,
                          plan=bad)


def test_resident_forward_on_card_equals_per_kernel(cuda):
    """IntModel(resident=True) on the card: one K6 launch per chunk of 2
    images and no K1 or K2; its logits equal the per-kernel forward's on
    the card, and agree with the resident forward on the CPU."""
    cfg = QuantConfig()
    ip_np = random_int_model(SMALL2, cfg, seed=4)
    x = np.random.default_rng(3).integers(-60, 60, (3, 3, 224, 224)) \
        .astype(np.int8)
    resident = engine.IntModel(ip_np, SMALL2, cfg, cuda, resident=True)
    per_kernel = engine.IntModel(ip_np, SMALL2, cfg, cuda)
    before = (resident_codes.launches, fused_qkv_attention_v2.launches,
              fused_int_mlp.launches)
    xt = torch.tensor(x, device=cuda)
    with torch.inference_mode():
        got = vit_int.forward_q_int_serve(resident.ip, SMALL2, cfg, xt,
                                          packed=resident.packed,
                                          microbatch=2)
    torch.cuda.synchronize()
    assert (resident_codes.launches, fused_qkv_attention_v2.launches,
            fused_int_mlp.launches) == (before[0] + 2, before[1], before[2])
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  per_kernel(x).cpu().numpy())
    cpu = engine.IntModel(ip_np, SMALL2, cfg, "cpu", resident=True)(x)
    _assert_paths_agree(got.cpu().numpy(), cpu.numpy())


def _mlp_case(model, rows, cuda):
    """K2's arguments for ``rows`` LN-like codes: a ViT spec's block 0, or
    Swin-T stage ``model`` ("swin0".."swin3": C = 96, 192, 384, 768),
    block 0, with the per-channel mults that the Swin forward folds."""
    dev = lambda a: torch.tensor(np.asarray(a), device=cuda)  # noqa: E731
    if isinstance(model, str):
        stage = int(model[-1])
        ip = random_swin_int_model(SWIN_SPECS["swin_tiny"], seed=0)
        ib, qp = ip["layers"][stage]["blocks"][0], ip["qp"]
        p = f"layers.{stage}.blocks.0"
        f1, f2 = ib["fc1"], ib["fc2"]
        c = f1["w_int"].shape[0]
        return (dev(_codes((rows, c), 2)), dev(f1["w_int"]),
                dev(f2["w_int"]), dev(qp[f"{p}.qact3.scale"] * f1["sw"]),
                dev(f1["b"]), dev(qp[f"{p}.mlp.qact1.scale"] * f2["sw"]),
                dev(f2["b"]), dev(qp[f"{p}.mlp.qact2.scale"]),
                dev(qp[f"{p}.mlp.qact1.scale"]))
    ib, _ = _block(model)
    f1, f2 = ib["fc1"], ib["fc2"]
    return (dev(_codes((rows, model.embed_dim), 2)), dev(f1["w_int"]),
            dev(f2["w_int"]), dev(f1["mult"]), dev(f1["b"]),
            dev(f2["mult"]), dev(f2["b"]), dev(ib["mlp.qact2"]["scale"]),
            dev(ib["mlp.qact1"]["scale"]))


@pytest.mark.parametrize("model,rows", [
    (TINY, 391), (SMALL, 197 * 2), (SMALL, 1), (SMALL, 197),
    (SMALL, 197 * 64), ("swin0", 3136), ("swin1", 784 * 2),
    ("swin2", 196 * 8), ("swin3", 49 * 64)],
    ids=["tiny", "deit_s_394", "deit_s_1", "deit_s_197", "deit_s_12608",
         "swin_c96", "swin_c192", "swin_c384", "swin_c768"])
@pytest.mark.parametrize("emit_codes", [True, False])
def test_int_mlp_kernel_matches_plain(cuda, model, rows, emit_codes):
    """K2 on the wgmma mainloop at DeiT-S rows 1, 197 and 12,608 and at
    every Swin-T width, codes and float32 out: one launch, bit for bit."""
    args = _mlp_case(model, rows, cuda)
    before = fused_int_mlp.launches
    got = fused_int_mlp(*args, emit_codes=emit_codes)
    torch.cuda.synchronize()
    assert fused_int_mlp.launches == before + 1
    want = fused_int_mlp_plain(*args, emit_codes=emit_codes)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("spec,batch,n_real", [
    (TINY, 2, 197), (TINY, 3, 33), (SMALL, 2, 197), (SMALL, 1, 256)])
def test_int_attention_kernel_matches_plain(cuda, spec, batch, n_real, lis):
    """K5 on the strided (B, 3, H, N, D) view of (B, N, 3C) qkv codes, as
    the forward hands it over, and on a contiguous copy."""
    h, d = spec.num_heads, spec.head_dim
    qkv = torch.tensor(_codes((batch, n_real, 3 * h * d), 4) // 3,
                       device=cuda)
    view = qkv.view(batch, n_real, 3, h, d).permute(0, 2, 3, 1, 4)
    scalars = torch.tensor(int_attn_scalars(_block(spec)[0], spec),
                           device=cuda)
    kw = dict(num_heads=h, n_real=n_real, lis=lis)
    before = fused_int_attention.launches
    got = fused_int_attention(view, scalars, **kw)
    got_c = fused_int_attention(view.contiguous(), scalars, **kw)
    torch.cuda.synchronize()
    assert fused_int_attention.launches == before + 2
    want = fused_int_attention_plain(view, scalars, **kw).cpu().numpy()
    for g in (got, got_c):
        diff = np.abs(g.cpu().numpy().astype(np.int32) - want)
        if lis:
            assert diff.max() == 0
        assert diff.max() <= 1 and np.mean(diff > 0) < 0.02


@pytest.mark.parametrize("cfg,bits", [
    (QuantConfig(), None),
    (QuantConfig(smoothquant=False, bit_w=BIT_TYPE_DICT["int8"]), None),
    (QuantConfig(ptf=False), None),
    (QuantConfig(ptf=False, lis=False, smoothquant=False,
                 bit_w=BIT_TYPE_DICT["int8"]), None),
    (QuantConfig(), (4, -1, 4, 4, 4, 4, -1, 4, -1, -1)),
    (QuantConfig(), "sym_acts"),
    (QuantConfig(lis=False), None)],
    ids=["default", "fqvit_int8", "ptf_off", "legacy", "float_sites",
         "asymmetric", "float_softmax"])
def test_forward_on_card_matches_cpu(cuda, cfg, bits):
    """A width whose reciprocal is inexact (1/96): CUDA torch divides by a
    Python number through its reciprocal, which the port must avoid.  Every
    branch of the forward: the codes path, K5 (SmoothQuant off, float LN,
    the legacy float softmax), float sites, the float32 stream."""
    spec = ViTSpec("w96", embed_dim=96, depth=2, num_heads=2, num_classes=10)
    ip_np = random_int_model(spec, cfg, seed=1,
                             bit_config=None if isinstance(bits, str)
                             else bits)
    if bits == "sym_acts":
        ip_np["sym_acts"] = False
    x = np.random.default_rng(3).integers(-60, 60, (2, 3, 224, 224)) \
        .astype(np.int8)
    out = {}
    for d in ("cpu", cuda):
        ip = int_model_from_numpy(ip_np, spec, d, cfg)
        out[str(d)] = vit_int.forward_q_int(ip, spec, cfg,
                                            torch.tensor(x, device=d)).cpu()
    _assert_paths_agree(out["cuda"].numpy(), out["cpu"].numpy())


def _assert_paths_agree(got, ref):
    """tests/test_pallas_attention.py::_assert_paths_agree."""
    assert np.mean(got == ref) > 0.995, np.mean(got == ref)
    np.testing.assert_allclose(got, ref, atol=0.05)
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_swin_attention_kernel_matches_plain(cuda, stage):
    """K4 (on a strided view of the natural qkv) and K4b vs the plain
    version at each Swin-T stage: 64/16/4/1 windows per image, 3/6/12/24
    heads, the shifted block (a mask in stages 0-2)."""
    spec = SWIN_SPECS["swin_tiny"]
    ip = random_swin_int_model(spec, seed=0)
    k = swin_block_constants(ip["layers"][stage]["blocks"][1], ip["qp"],
                             f"layers.{stage}.blocks.1", spec, stage, 1,
                             QuantConfig())
    assert (k["mask_div"] is not None) == (stage < 3)
    res = spec.stage_resolution(stage)[0]
    nw, heads = (res // 7) ** 2, spec.num_heads[stage]
    c = spec.stage_dim(stage)
    dev = lambda a: None if a is None else torch.tensor(  # noqa: E731
        np.asarray(a), device=cuda)
    qkv = dev(_codes((2 * nw, 49, 3 * c), stage))
    bias, mask, scal = dev(k["bias_q"]), dev(k["mask_div"]), \
        dev(k["attn_scalars"])
    kw = dict(num_heads=heads, n_real=49, n_windows=nw)
    view = qkv.view(2 * nw, 49, 3, heads, 32).permute(0, 2, 3, 1, 4)
    want = swin_attention_plain(view[:, 0], view[:, 1], view[:, 2], bias,
                                mask, scal, n_real=49, n_windows=nw)
    before = (fused_swin_attention.launches,
              fused_swin_attention_v2.launches)
    got = fused_swin_attention(view, bias, mask, scal, **kw)
    got_c = fused_swin_attention(view.contiguous(), bias, mask, scal, **kw)
    got2 = fused_swin_attention_v2(qkv, bias, mask, scal, head_dim=32, **kw)
    torch.cuda.synchronize()
    assert (fused_swin_attention.launches,
            fused_swin_attention_v2.launches) == (before[0] + 2,
                                                  before[1] + 1)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    np.testing.assert_array_equal(got_c.cpu().numpy(), want.cpu().numpy())
    np.testing.assert_array_equal(
        got2.cpu().numpy(),
        want.permute(0, 2, 1, 3).reshape(2 * nw, 49, c).cpu().numpy())


def test_swin_forward_on_card_matches_cpu(cuda):
    """Two stages of Swin-T's widths at a 112 input, both attention
    contracts: the card's logits vs the plain path on the CPU."""
    cfg = QuantConfig()
    spec = SwinSpec("swin_t2", embed_dim=96, depths=(2, 2), num_heads=(3, 6),
                    img_size=112, num_classes=10)
    ip_np = random_swin_int_model(spec, cfg, seed=1)
    x = np.random.default_rng(3).integers(-60, 60, (2, 3, 112, 112)) \
        .astype(np.int8)
    ref = swin_int.forward_q_int(swin_int_model_from_numpy(ip_np, spec, "cpu"),
                                 spec, cfg, torch.tensor(x)).numpy()
    ip = swin_int_model_from_numpy(ip_np, spec, cuda)
    for attn_v2 in (False, True):
        got = swin_int.forward_q_int(ip, spec, cfg, torch.tensor(x, device=cuda),
                                     attn_v2=attn_v2).cpu().numpy()
        _assert_paths_agree(got, ref)


def _swin_softmax_case(spec, stage, windows_of, cuda, wide=False):
    """K4/K4b arguments for ``lis=False`` at a stage's shifted block:
    ``windows_of`` images of qkv codes.  ``wide``: s_a1 = s_a2 = 0.5, so
    that the logits span +-64 under the mask's -100 and the rows hold
    weights down to the bfloat16 subnormals."""
    cfg = QuantConfig(lis=False)
    ip = random_swin_int_model(spec, cfg, seed=0)
    k = swin_block_constants(ip["layers"][stage]["blocks"][1], ip["qp"],
                             f"layers.{stage}.blocks.1", spec, stage, 1, cfg)
    if wide:
        k["attn_scalars"][1:4] = (0.5, 2.0, 0.5)
        k["mask_div"] = np.where(k["mask_div"] != 0, -200.0, 0.0) \
            .astype(np.float32)
    res = spec.stage_resolution(stage)[0]
    nw, heads = (res // 7) ** 2, spec.num_heads[stage]
    c = spec.stage_dim(stage)
    dev = lambda a: None if a is None else torch.tensor(  # noqa: E731
        np.asarray(a), device=cuda)
    qkv = dev(_codes((windows_of * nw, 49, 3 * c), stage + 3))
    consts = (dev(k["bias_q"]), dev(k["mask_div"]), dev(k["attn_scalars"]))
    return qkv, consts, dict(num_heads=heads, n_real=49, n_windows=nw,
                             bits=8, lis=False), c // heads


@pytest.mark.parametrize("spec_name,stage,wide", [
    ("swin_tiny", 0, False), ("swin_tiny", 1, False), ("swin_tiny", 2, False),
    ("swin_tiny", 3, False), ("swin_tiny", 0, True), ("tiny", 0, False),
    ("tiny", 0, True)])
def test_swin_attention_float_softmax_kernel_matches_plain(cuda, spec_name,
                                                           stage, wide):
    """K4 (on a strided view of the natural qkv, and on a contiguous copy)
    and K4b with ``lis=False`` vs the plain version, at Swin-T's stages and
    at the CPU tests' tiny Swin (2 heads of 16): >= 99.9% of codes equal
    and within 1 code (measured: all equal)."""
    spec = SWIN_SPECS["swin_tiny"] if spec_name == "swin_tiny" else SwinSpec(
        "swin_test2", embed_dim=32, depths=(2, 1), num_heads=(2, 4),
        img_size=56, num_classes=10)
    qkv, consts, kw, hd = _swin_softmax_case(spec, stage, 2, cuda, wide)
    bw, heads = qkv.shape[0], kw["num_heads"]
    view = qkv.view(bw, 49, 3, heads, hd).permute(0, 2, 3, 1, 4)
    want = swin_attention_plain(
        view[:, 0], view[:, 1], view[:, 2], *consts, n_real=49,
        n_windows=kw["n_windows"], lis=False).cpu().numpy()
    before = (fused_swin_attention.launches,
              fused_swin_attention_v2.launches)
    got = fused_swin_attention(view, *consts, **kw)
    got_c = fused_swin_attention(view.contiguous(), *consts, **kw)
    got2 = fused_swin_attention_v2(qkv, *consts, head_dim=hd, **kw)
    torch.cuda.synchronize()
    assert (fused_swin_attention.launches,
            fused_swin_attention_v2.launches) == (before[0] + 2,
                                                  before[1] + 1)
    got2 = got2.view(bw, 49, heads, hd).permute(0, 2, 1, 3)
    for g in (got, got_c, got2):
        diff = np.abs(g.cpu().numpy().astype(np.int32) - want)
        print(spec_name, stage, wide, "equal", float(np.mean(diff == 0)))
        assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999
    assert len(np.unique(want)) > 32


def _swin_branch_model(branch):
    """(spec, cfg, numpy int-model) of a two-stage Swin at Swin-T's widths
    and a 112 input, for one branch of the forward."""
    kw = dict(embed_dim=96, depths=(2, 2), num_heads=(3, 6), img_size=112,
              num_classes=10)
    spec = SwinSpec("swin_t2", input_quant=branch != "no_input_quant", **kw)
    cfg = {"float_ln": QuantConfig(ptf=False),
           "float_softmax": QuantConfig(lis=False)}.get(branch, QuantConfig())
    bc = None
    if branch == "mixed_bits":
        n = 1 + 4 * 4 + 1 + 1
        bc = [8, 4] * (n // 2) + [8] * (n % 2)
    ip = random_swin_int_model(spec, cfg, seed=1, bit_config=bc)
    if branch == "asymmetric":
        ip["sym_acts"] = False
        for k in ip["qp"]:
            if k.endswith(".qact2.zp") and ".attn." not in k:
                ip["qp"][k] = ip["qp"][k] + np.float32(3.0)
    return spec, cfg, ip


@pytest.mark.parametrize("branch", ["float_ln", "asymmetric", "float_softmax",
                                    "no_input_quant", "mixed_bits"])
def test_swin_branch_forward_on_card_matches_cpu(cuda, branch):
    """Every branch of the Swin forward beside the codes path, both
    attention contracts: the card's logits vs the plain path on the CPU,
    on float32 pixels, and through the engine on uint8 pixels."""
    spec, cfg, ip_np = _swin_branch_model(branch)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 112, 112)).astype(np.float32)
    ref = swin_int.forward_q_int(
        swin_int_model_from_numpy(ip_np, spec, "cpu", cfg), spec, cfg,
        torch.tensor(x)).numpy()
    ip = swin_int_model_from_numpy(ip_np, spec, cuda, cfg)
    for attn_v2 in (False, True):
        before = (fused_swin_attention.launches,
                  fused_swin_attention_v2.launches, fused_int_mlp.launches)
        got = swin_int.forward_q_int(ip, spec, cfg,
                                     torch.tensor(x, device=cuda),
                                     attn_v2=attn_v2).cpu().numpy()
        after = (fused_swin_attention.launches,
                 fused_swin_attention_v2.launches, fused_int_mlp.launches)
        assert tuple(a - b for a, b in zip(after, before)) == \
            ((0, 4, 4) if attn_v2 else (4, 0, 4))
        _assert_paths_agree(got, ref)
    pixels = rng.integers(0, 256, (2, 3, 112, 112), dtype=np.uint8)
    _assert_paths_agree(
        engine.IntModel(ip_np, spec, cfg, cuda)(pixels).cpu().numpy(),
        engine.IntModel(ip_np, spec, cfg, "cpu")(pixels).numpy())


# ---- K3, K7a, K7b and K8 (the kernels on no model path) ----

def _alt_pairs():
    from diffvit_tpu_torch.ops.kernels import attention, mlp
    names = ("fused_qkv_attention", "fused_qkv_attention_v3",
             "fused_qkv_attention_v4", "fused_qkv_attention_v5",
             "fused_attention_block")
    pairs = {n: (getattr(attention, n), getattr(attention, n + "_plain")
                 if n in ("fused_qkv_attention", "fused_attention_block")
                 else attention.fused_qkv_attention_v3_plain) for n in names}
    pairs["fused_int_mlp_block"] = (mlp.fused_int_mlp_block,
                                    mlp.fused_int_mlp_block_plain)
    return pairs


@pytest.mark.parametrize("lis", [True, False], ids=["lis", "softmax"])
@pytest.mark.parametrize("batch", [1, 3, 8])
def test_alt_kernels_match_plain(cuda, batch, lis):
    """K8 (v1, v3, v4, v5), K7a and K7b at DeiT-S width (one block, 200
    rows with 197 real) against their plain versions on the card; v5 takes
    an even batch only and raises for B = 1 and 3."""
    from diffvit_tpu_torch.testing import alt_kernel_cases
    cases = alt_kernel_cases(SMALL, random_int_model(SMALL, seed=0), batch,
                             cuda, npad=200, lis=lis, seed=batch)
    for name, (fn, plain) in _alt_pairs().items():
        args, kw = cases[name]
        if name == "fused_qkv_attention_v5" and batch % 2:
            with pytest.raises(ValueError, match="even batch"):
                fn(*args, **kw)
            continue
        if name == "fused_int_mlp_block" and not lis:
            continue  # no softmax in K7b: its rows run once, with the LIS
        before = fn.launches
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        assert fn.launches == before + 1, name
        want = plain(*args, **kw)
        if name == "fused_attention_block":
            s2 = args[8][3]
            got, want = torch.round(got / s2), torch.round(want / s2)
        elif name == "fused_int_mlp_block":
            s4 = kw["s4_vec"]
            got, want = torch.round(got / s4), torch.round(want / s4)
        g, w = got.cpu().numpy(), want.cpu().numpy()
        if lis:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            _assert_softmax_codes_close(g, w)


@pytest.mark.parametrize("batch", [1, 8, 64])
def test_mlp_block_kernel_matches_plain(cuda, batch):
    """K7b (its row pass, then fc1 and fc2 on the wgmma mainloop) at DeiT-S
    width against its plain version, on the qact4 grid; the GEMM kernels'
    footprint: setmaxnreg's register budget and the plan's blocks an
    SM."""
    from diffvit_tpu_torch.ops.kernels import gemm, mlp
    from diffvit_tpu_torch.testing import alt_kernel_cases
    args, kw = alt_kernel_cases(SMALL, random_int_model(SMALL, seed=0),
                                batch, cuda, npad=200, lis=True,
                                seed=batch)["fused_int_mlp_block"]
    before = mlp.fused_int_mlp_block.launches
    got = mlp.fused_int_mlp_block(*args, **kw)
    torch.cuda.synchronize()
    assert mlp.fused_int_mlp_block.launches == before + 1
    want = mlp.fused_int_mlp_block_plain(*args, **kw)
    s4 = kw["s4_vec"]
    np.testing.assert_array_equal(torch.round(got / s4).cpu().numpy(),
                                  torch.round(want / s4).cpu().numpy())
    rows, c = args[0].shape
    hid = kw["w1"].shape[1]
    f = mlp.mlp_block_footprint(rows, c, hid, cuda)
    for name, (n, k) in (("fc1", (hid, c)), ("fc2", (c, hid))):
        plan = gemm.device_plan(rows, n, k, cuda)
        assert f[name]["registers"] == {1: 168, 2: 80}[plan.blocks], f
        assert f[name]["blocks_per_sm"] == plan.blocks, f


def test_qkv_attention_v1_reads_strided_weights(cuda):
    """K8 v1 on per-head weights that are strided views of K1's (Cin, 3C)
    weight (the kernel reads one cached K-major copy of the three) gives
    the codes of the contiguous copies, and of the plain version."""
    from diffvit_tpu_torch.models.convert import qkv_head_blocks
    from diffvit_tpu_torch.ops.kernels.attention import (
        fused_qkv_attention, fused_qkv_attention_plain)
    spec = SMALL
    ib = int_model_from_numpy(random_int_model(spec, seed=1), spec,
                              cuda)["blocks"][0]
    hb = qkv_head_blocks(ib, spec)
    h, d, c = spec.num_heads, spec.head_dim, spec.embed_dim
    views = ib["qkv"]["w_int"].view(c, 3, h, d).permute(1, 2, 0, 3)
    assert not views[0].is_contiguous()
    x = torch.tensor(_codes((3, 200, c), 8), device=cuda)
    x[:, 197:] = 0
    rest = (hb["mult_h"], hb["bias_h"], ib["attn_scalars"])
    got = fused_qkv_attention(x, *views, *rest, n_real=197)
    dense = fused_qkv_attention(x, hb["wq_h"], hb["wk_h"], hb["wv_h"], *rest,
                                n_real=197)
    want = fused_qkv_attention_plain(x, *views, *rest, n_real=197)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), dense.cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("rows,k,n", [(200, 48, 1000), (3136, 48, 96),
                                      (3136, 96, 288), (197, 384, 1152),
                                      (1, 384, 1000), (77, 100, 37),
                                      (12608, 384, 1536), (64, 384, 1000)])
@pytest.mark.parametrize("mode", ["raw", "fq", "codes"])
def test_int_linear_kernel_matches_plain(cuda, rows, k, n, mode):
    """K3 at the tail shapes (K = 48, N = 1000, the 96/288-wide Swin
    outputs, a ragged K and N, which the wrapper pads to K = 112), a DeiT-S
    qkv site, DeiT-S fc1 at b = 64 and the head at b = 64, every mode, bit
    for bit; the raw mode equals the forward's int_matmul(x, w) * mult +
    b."""
    from diffvit_tpu_torch.ops.kernels.linear import (fused_int_linear,
                                                      fused_int_linear_plain)
    from diffvit_tpu_torch.ops.quant import int_matmul
    rng = np.random.default_rng(rows + k + n)
    dev = lambda a: torch.tensor(a, device=cuda)  # noqa: E731
    x = dev(_codes((rows, k), 9))
    w = dev(rng.integers(-8, 8, (k, n)).astype(np.int8))
    mult = dev(rng.uniform(0.001, 0.01, n).astype(np.float32))
    bias = dev(rng.standard_normal(n).astype(np.float32))
    kw = {"raw": {}, "fq": dict(out_scale=dev(np.float32(0.05))),
          "codes": dict(out_scale=dev(np.float32(0.05)),
                        emit_codes=True)}[mode]
    before = fused_int_linear.launches
    got = fused_int_linear(x, w, mult, bias, **kw)
    torch.cuda.synchronize()
    assert fused_int_linear.launches == before + 1
    want = fused_int_linear_plain(x, w, mult, bias, **kw)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    if mode == "raw":
        fwd = int_matmul(x, w).to(torch.float32) * mult + bias
        np.testing.assert_array_equal(got.cpu().numpy(), fwd.cpu().numpy())


def test_gemm_wrappers_refuse_an_operand_off_a_16_byte_boundary(cuda):
    """TMA reads x from its base: K2 and K3 raise ValueError for a
    contiguous x one byte off a 16-byte boundary, and launch nothing."""
    from diffvit_tpu_torch.ops.kernels.linear import fused_int_linear
    args = _mlp_case(SMALL, 197, cuda)
    buf = torch.zeros(197 * 384 + 16, dtype=torch.int8, device=cuda)
    x = buf[1:1 + 197 * 384].view(197, 384)
    assert x.is_contiguous() and x.data_ptr() % 16 == 1
    before = (fused_int_mlp.launches, fused_int_linear.launches)
    with pytest.raises(ValueError, match="aligned"):
        fused_int_mlp(x, *args[1:], emit_codes=True)
    with pytest.raises(ValueError, match="aligned"):
        fused_int_linear(x, args[1], args[3], args[4])
    assert (fused_int_mlp.launches, fused_int_linear.launches) == before


def test_gemm_kernels_report_their_footprint(cuda):
    """K2's two kernels and K3's report registers, shared memory and
    blocks an SM (cudaFuncGetAttributes and the occupancy API): the plan's
    blocks an SM and shared memory, and the register count that
    setmaxnreg's budget needs (168 a thread at one block an SM for 40 + 2 x
    232, 80 at two for 24 + 2 x 104)."""
    from diffvit_tpu_torch.ops.kernels import gemm, linear, mlp
    sites = {"fc1": mlp.footprint(12608, 384, 1536, 384, cuda)["fc1"],
             "fc2": mlp.footprint(12608, 384, 1536, 384, cuda)["fc2"],
             "fc2_b1": mlp.footprint(197, 384, 1536, 384, cuda)["fc2"],
             "head": linear.footprint(64, 1000, 384, cuda),
             "qkv": linear.footprint(12608, 1152, 384, cuda)}
    plans = {"fc1": (12608, 1536, 384), "fc2": (12608, 384, 1536),
             "fc2_b1": (197, 384, 1536), "head": (64, 1000, 384),
             "qkv": (12608, 1152, 384)}
    for name, f in sites.items():
        plan = gemm.device_plan(*plans[name], cuda)
        assert f["registers"] == {1: 168, 2: 80}[plan.blocks], (name, f)
        assert f["smem_bytes"] >= plan.smem, (name, f)
        assert f["blocks_per_sm"] == plan.blocks, (name, f)


# ---- the probes (diffvit_tpu_torch/probes, csrc/probes) ----

def _launched_once(fn, before):
    torch.cuda.synchronize()
    assert fn.launches == before + 1


@pytest.mark.parametrize("batch,npad", [(2, 24), (3, 200), (256, 200)])
def test_probe_linear_attention_matches_plain(cuda, batch, npad):
    """P5 (K1 with w = a * 2^-7) at the script's width, bit for bit, up to
    its B=256."""
    from diffvit_tpu_torch.probes import attn_overlap as p5
    x, *ops = p5.inputs(cuda, batch)
    x = x[:, :npad].contiguous()
    kw = dict(num_heads=p5.H, head_dim=p5.D)
    before = p5.qkv_attention_nv.launches
    got = p5.qkv_attention_nv(x, *ops, **kw)
    _launched_once(p5.qkv_attention_nv, before)
    want = p5.qkv_attention_nv_plain(x, *ops, **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("batch,npad,heads,d,n_real", [
    (2, 24, 2, 16, 21), (3, 45, 6, 64, 33), (128, 200, 6, 64, 197)])
def test_probe_pingpong_matches_plain(cuda, batch, npad, heads, d, n_real):
    """P1's producer and consumer against their plain versions bit for bit
    (the last case is the script's B=128 half-stream), and paired equal to
    the two halves."""
    from diffvit_tpu_torch.probes import pingpong as p1
    rng = np.random.default_rng(batch)
    dev = lambda a, dt: torch.tensor(a, dtype=dt, device=cuda)  # noqa: E731
    c = heads * d
    x = dev(rng.integers(-128, 128, (batch, npad, c)), torch.int8)
    w = dev(rng.integers(-8, 8, (c, 3 * c)), torch.int8)
    mb = dev(np.stack([np.full(3 * c, 2.0**-9 * 24),
                       rng.standard_normal(3 * c) * 0.24]), torch.float32)
    scores = dev(rng.integers(-128, 128, (batch, heads, npad, npad)),
                 torch.int8)
    v = dev(rng.integers(-128, 128, (batch, heads, npad, d)), torch.int8)
    scal = dev([2.0**-4, 0.05, 24.0, 1.3], torch.float32)
    hk = dict(num_heads=heads, head_dim=d)
    got_p = p1.producer(x, w, mb, scal, **hk)
    got_c = p1.consumer(scores, v, scal, n_real=n_real)
    before = p1.paired.launches
    pair = p1.paired(x, w, mb, scores, v, scal, n_real=n_real, **hk)
    _launched_once(p1.paired, before)
    assert torch.equal(got_p, p1.producer_plain(x, w, mb, scal, **hk))
    assert torch.equal(got_c, p1.consumer_plain(scores, v, scal,
                                                n_real=n_real))
    assert torch.equal(pair[0], got_p) and torch.equal(pair[1], got_c)


@pytest.mark.parametrize("rows,iters", [(128, 8), (64 * 512, 220)])
@pytest.mark.parametrize("mode", ["dot_only", "vpu_only", "dot_vpu_consume",
                                  "dot_vpu_in_join", "dot_vpu_in_split"])
def test_probe_overlap_matches_plain(cuda, rows, iters, mode):
    """P2's five modes within overlap.compare's tolerances (the dot's
    summation order; the tanh chain's roundings), at the script's 32768 x
    512 too."""
    from diffvit_tpu_torch.probes import overlap as p2
    a, b, v = p2.inputs(cuda, rows)
    fn = p2.KERNELS[mode]
    before = fn.launches
    got = fn(a, b, v, iters=iters)
    _launched_once(fn, before)
    want = p2.overlap_plain(a, b, v, mode, iters)
    share, max_err, ok = p2.compare(mode, a, b, got, want, iters)
    assert ok, (share, max_err)


@pytest.mark.parametrize("rows", [200, 99 * 512])
@pytest.mark.parametrize("mode", ["dot", "input", "nogelu", "pipelined",
                                  "staged"])
def test_probe_overlap_mlp_matches_plain(cuda, rows, mode):
    """P3's four modes bit for bit against their plain versions (the
    script's 50,688 rows too); pipelined and staged equal dot."""
    from diffvit_tpu_torch.probes import overlap_mlp as p3
    args = p3.inputs(cuda, rows)
    fn = p3.KERNELS[f"mlp_{mode}"]
    before = fn.launches
    got = fn(*args)
    _launched_once(fn, before)
    assert torch.equal(got, p3.overlap_mlp_plain(*args, mode))
    if mode in ("pipelined", "staged"):
        assert torch.equal(got, p3.mlp_dot(*args))


@pytest.mark.parametrize("rows,cin,hid", [(130, 32, 96), (257, 64, 64),
                                          (200, 128, 256)])
def test_probe_overlap_mlp_pipelined_short_and_ragged(cuda, rows, cin, hid):
    """P3's pipelined and staged modes (the double-buffered K loop) with
    one, two and four K steps a sub-block, and rows that leave the last
    block partly or wholly empty: equal to dot and to the plain version."""
    from diffvit_tpu_torch.probes import overlap_mlp as p3
    rng = np.random.default_rng(rows)
    dev = lambda a, dt: torch.tensor(a, dtype=dt, device=cuda)  # noqa: E731
    args = (dev(rng.integers(-30, 31, (rows, cin)), torch.int8),
            dev(rng.integers(-127, 128, (cin, hid)), torch.int8),
            dev(rng.integers(-127, 128, (hid, cin)), torch.int8),
            dev(np.outer([1e-3, 0.0], np.ones(hid)), torch.float32),
            dev(np.outer([1e-3, 0.0, 0.05, 20.0], np.ones(cin)),
                torch.float32),
            dev(rng.standard_normal((rows, hid)), torch.float32),
            dev([16.0], torch.float32))
    want = p3.overlap_mlp_plain(*args, "dot")
    assert torch.equal(p3.mlp_dot(*args), want)
    assert torch.equal(p3.mlp_pipelined(*args), want)
    assert torch.equal(p3.mlp_staged(*args), want)


def test_probe_footprints(cuda):
    """P3's fc1 kernels and P1's three kernels report their registers,
    shared memory and blocks an SM: pipelined, which holds two sub-blocks'
    accumulators, fits no more blocks than dot; paired carries at least the
    larger role's shared memory."""
    from diffvit_tpu_torch.probes import overlap_mlp as p3
    from diffvit_tpu_torch.probes import pingpong as p1
    fc1 = {m: p3.fc1_occupancy(m) for m in p3.MODES}
    roles = {r: p1.footprint(r) for r in ("producer", "consumer", "paired")}
    for f in (*fc1.values(), *roles.values()):
        assert f["registers"] > 0 and f["blocks_per_sm"] >= 1
    assert fc1["pipelined"]["blocks_per_sm"] <= fc1["dot"]["blocks_per_sm"]
    assert roles["paired"]["smem_bytes"] >= max(
        roles["producer"]["smem_bytes"], roles["consumer"]["smem_bytes"])


@pytest.mark.parametrize("shape", [(4,), (64, 3, 224, 224), (1176, 1024)])
def test_probe_tile_sum_matches_plain(cuda, shape):
    """P4 on a uint8 batch cast to float32 and on halves: exact."""
    from diffvit_tpu_torch.probes import ingest as p4
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.integers(0, 255, shape), dtype=torch.float32,
                     device=cuda)
    if shape == (1176, 1024):
        x = torch.full(shape, 0.5, device=cuda)
    before = p4.tile_sum.launches
    got = p4.tile_sum(x)
    _launched_once(p4.tile_sum, before)
    assert torch.equal(got, p4.tile_sum_plain(x))
    assert float(got[3, 7]) == float(np.float32(x.to(torch.float64).sum()
                                                .item()))


def test_probe_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from diffvit_tpu_torch.probes import ingest as p4
    from diffvit_tpu_torch.probes import overlap as p2
    a, b, v = p2.inputs(cuda, 128)
    with pytest.raises(ValueError):
        p2.dot_only(a[:100], b, v[:100])  # M not a multiple of 64
    with pytest.raises(ValueError):
        p4.tile_sum(torch.zeros(6, device=cuda))  # not a multiple of 4
    with pytest.raises(ValueError):
        p2.dot_only(a, b.cpu(), v)  # devices mixed
    from diffvit_tpu_torch.probes import overlap_mlp as p3
    x, w1, w2, v1, v2, g_src, scal = p3.inputs(cuda, 64)
    with pytest.raises(ValueError):  # Hid < Cin: no keep-alive columns
        p3.mlp_dot(x[:, :64].contiguous(), w1[:64, :32].contiguous(),
                   w2[:32, :64].contiguous(), v1[:, :32].contiguous(),
                   v2[:, :64].contiguous(), g_src[:, :32].contiguous(), scal)


# ---- the tensor-core attention core (csrc/attention_mma.cuh) ----

D16 = ViTSpec("test_d16", embed_dim=32, depth=1, num_heads=2, num_classes=10)
D64 = ViTSpec("test_d64", embed_dim=128, depth=1, num_heads=2,
              num_classes=10)


@pytest.mark.parametrize("lis", [True, False], ids=["lis", "softmax"])
@pytest.mark.parametrize("spec", [D16, TINY, D64], ids=["d16", "d32", "d64"])
@pytest.mark.parametrize("batch", [1, 3, 64])
@pytest.mark.parametrize("npad,n_real", [(256, 256), (150, 131)])
@pytest.mark.parametrize("kernel", ["k1", "k5"])
def test_attention_core_matches_plain_at_every_shape(cuda, kernel, npad,
                                                     n_real, batch, spec,
                                                     lis):
    """K1 and K5 against their plain versions at 256 keys and at an odd
    n_real below npad (a ragged last key block, query rows past n_real),
    b = 1, 3 and 64, D = 16, 32 and 64, both softmaxes: the LIS exact,
    the float softmax by its rule."""
    ib, scalars = _block(spec)
    dev = lambda a: torch.tensor(np.asarray(a), device=cuda)  # noqa: E731
    h, d = spec.num_heads, spec.head_dim
    opts = {} if lis else dict(bits=8, lis=False)
    if kernel == "k1":
        q = ib["qkv"]
        args = (dev(_codes((batch, npad, spec.embed_dim), 11)),
                dev(q["w_int"]), dev(q["mult"]), dev(q["b"]), dev(scalars))
        kw = dict(num_heads=h, head_dim=d, n_real=n_real, **opts)
        fn, plain = fused_qkv_attention_v2, fused_qkv_attention_v2_plain
    else:
        qkv = dev(_codes((batch, npad, 3 * h * d), 12) // 3)
        args = (qkv.view(batch, npad, 3, h, d).permute(0, 2, 3, 1, 4),
                dev(int_attn_scalars(ib, spec)))
        kw = dict(num_heads=h, n_real=n_real, **opts)
        fn, plain = fused_int_attention, fused_int_attention_plain
    before = fn.launches
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    got, want = got.cpu().numpy(), plain(*args, **kw).cpu().numpy()
    if lis:
        np.testing.assert_array_equal(got, want)
    else:
        _assert_softmax_codes_close(got, want)


@pytest.mark.parametrize("lis", [True, False], ids=["lis", "softmax"])
@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
@pytest.mark.parametrize("spec_name,stage", [
    ("tiny", 0), ("swin_tiny", 0), ("swin_tiny", 1), ("swin_tiny", 2),
    ("swin_tiny", 3)])
def test_swin_attention_core_matches_plain(cuda, spec_name, stage, masked,
                                           lis):
    """K4 and K4b against the plain version at the tiny Swin's D = 16
    stage and at Swin-T's four stages (D = 32), with the shift mask and
    without it (stage 3 has none), both softmaxes: the LIS exact, the
    float softmax >= 99.9% equal and within 1 code."""
    spec = SWIN_SPECS["swin_tiny"] if spec_name == "swin_tiny" else SwinSpec(
        "swin_test2", embed_dim=32, depths=(2, 1), num_heads=(2, 4),
        img_size=56, num_classes=10)
    cfg = QuantConfig(lis=lis)
    ip = random_swin_int_model(spec, cfg, seed=0)
    k = swin_block_constants(ip["layers"][stage]["blocks"][1], ip["qp"],
                             f"layers.{stage}.blocks.1", spec, stage, 1, cfg)
    res = spec.stage_resolution(stage)[0]
    nw, heads = (res // 7) ** 2, spec.num_heads[stage]
    c = spec.stage_dim(stage)
    hd = c // heads
    dev = lambda a: None if a is None else torch.tensor(  # noqa: E731
        np.asarray(a), device=cuda)
    mask = k["mask_div"] if masked else None
    qkv = dev(_codes((3 * nw, 49, 3 * c), stage + 20))
    consts = (dev(k["bias_q"]), dev(mask), dev(k["attn_scalars"]))
    kw = dict(num_heads=heads, n_real=49,
              n_windows=nw if mask is not None else 1,
              **({} if lis else dict(bits=8, lis=False)))
    view = qkv.view(3 * nw, 49, 3, heads, hd).permute(0, 2, 3, 1, 4)
    want = swin_attention_plain(view[:, 0], view[:, 1], view[:, 2], *consts,
                                n_real=49, n_windows=kw["n_windows"],
                                lis=lis).cpu().numpy()
    got = fused_swin_attention(view, *consts, **kw).cpu().numpy()
    got2 = fused_swin_attention_v2(qkv, *consts, head_dim=hd, **kw)
    got2 = got2.view(3 * nw, 49, heads, hd).permute(0, 2, 1, 3).cpu().numpy()
    for g in (got, got2):
        if lis:
            np.testing.assert_array_equal(g, want)
        else:
            diff = np.abs(g.astype(np.int32) - want)
            assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999


def test_attention_cores_report_their_footprint(cuda):
    """The tensor-core cores at the main paths' shapes (DeiT-S b = 1, 8,
    64; Swin-T's four stages at b = 64), both softmaxes: no local memory
    (no spills), the plan's shared memory, at least one block an SM at the
    plan's warps; the LIS instances at three blocks an SM (qkv, the
    plan's 7 warps at b = 64) or two or more (Swin).  The qkv
    GEMM on the wgmma mainloop at setmaxnreg's register budget.  Printed
    with -s."""
    from diffvit_tpu_torch.ops.kernels import attention, gemm, swin_attention
    from diffvit_tpu_torch.ops.kernels.attn_plan import (attention_plan,
                                                         swin_attention_plan)
    spec, swin = VIT_SPECS["deit_small"], SWIN_SPECS["swin_tiny"]
    for lis in (True, False):
        for b in (1, 8, 64):
            f = attention.core_footprint(b, 6, 197, 64, 197, cuda, lis=lis)
            plan = attention_plan(b, 6, 197, 64, 197, lis)
            print("qkv core", b, lis, f)
            assert f["local_bytes"] == 0, f
            assert f["smem_bytes"] >= plan.smem and f["blocks_per_sm"] >= 1
            if lis:
                assert f["registers"] <= 96, f
                assert f["blocks_per_sm"] >= min(3, 21 // plan.warps), f
        for stage in range(4):
            res = swin.stage_resolution(stage)[0]
            windows, heads = 64 * (res // 7) ** 2, swin.num_heads[stage]
            f = swin_attention.footprint(windows, heads, 56, 32, 49, cuda,
                                         lis=lis)
            plan = swin_attention_plan(windows, heads, 56, 32, 49, lis)
            print("swin core", stage, lis, f)
            assert f["local_bytes"] == 0, f
            assert f["smem_bytes"] >= plan.smem and f["blocks_per_sm"] >= 1
            if lis:
                assert f["blocks_per_sm"] >= 2, f
    for rows in (197, 64 * 197):
        f = attention.qkv_gemm_footprint(rows, 1152, 384, cuda)
        plan = gemm.device_plan(rows, 1152, 384, cuda)
        print("qkv gemm", rows, f)
        assert f["registers"] == {1: 168, 2: 80}[plan.blocks], f
        assert f["blocks_per_sm"] == plan.blocks, f


@pytest.mark.parametrize("spec,batch,fqvit", [
    (TINY, 2, False), (TINY, 2, True), (DEIT_S, 8, False)],
    ids=["tiny", "tiny_fqvit_int8", "deit_s"])
def test_calibrate_bake_serve_on_card_matches_cpu(cuda, spec, batch, fqvit):
    """QuantizedViT calibrates the same params on the same Gaussian batch
    on the card and on the CPU: at least 99.9% of the qparam elements
    equal; both bakes served through IntModel, the fake-quant forwards
    too, agree by _assert_paths_agree."""
    cfg = QuantConfig(smoothquant=False, bit_w=BIT_TYPE_DICT["int8"]) \
        if fqvit else QuantConfig()
    params = init_params(spec, torch.Generator().manual_seed(0), "cpu")
    x = gaussian_calibration(batch, seed=0)
    card = engine.QuantizedViT(spec, cfg, params=params, device=cuda)
    cpu = engine.QuantizedViT(spec, cfg, params=params, device="cpu")
    card.calibrate(x)
    cpu.calibrate(x)
    assert set(card.qparams) == set(cpu.qparams)
    total = sum(v.numel() for v in cpu.qparams.values())
    equal = sum(int((card.qparams[k].cpu() == v).sum())
                for k, v in cpu.qparams.items())
    assert equal / total >= 0.999, (equal, total)
    pixels = np.random.default_rng(1).integers(
        0, 256, (batch, 3, spec.img_size, spec.img_size), dtype=np.uint8)
    _assert_paths_agree(card.prepare_int()(pixels).cpu().numpy(),
                        cpu.prepare_int()(pixels).numpy())
    _assert_paths_agree(card(pixels).cpu().numpy(), cpu(pixels).numpy())

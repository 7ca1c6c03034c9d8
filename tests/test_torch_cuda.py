"""The CUDA kernels vs their plain PyTorch versions, on a CUDA card.

This file imports neither JAX nor the JAX package, so it runs where the
card is: ``python -m pytest --noconftest tests/test_torch_cuda.py``
(tests/conftest.py imports JAX).  Every test carries the ``cuda`` marker;
without a card each skips.  K1, K2 and K5 share their device code with
the resident kernel K6 (``csrc/wgmma_gemm.cuh``, ``attention_mma.cuh``,
``lis.cuh``, ``int_mlp.cuh``), and K3, K7a, K7b and K8 with them; their
tests here hold each exact against its plain version.  K2, K3, K7b, the
qkv GEMM of K1, K7a and K8 and K6's four GEMM steps run on the wgmma
mainloop (``csrc/wgmma_gemm.cuh``), K7a's proj too; the attention of K1,
K5, K6, K7a, K8 and K4/K4b on the tensor-core core
(``csrc/attention_mma.cuh``)."""
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
from diffvit_tpu_torch.models.swin import (SWIN_SPECS, SwinSpec,
                                           init_swin_params)
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
@pytest.mark.parametrize("batch", [1, 3, 8, 64])
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


D36 = ViTSpec("test_d36", embed_dim=36, depth=1, num_heads=3,
              num_classes=10)  # H * D = 36: attention rows padded to 48


@pytest.mark.parametrize("n_real", [197, 150])
@pytest.mark.parametrize("rule", ["lis", "lis_wide", "softmax"])
def test_attention_block_pads_its_attention_codes(cuda, rule, n_real):
    """K7a where H * D = 36 is not a multiple of 16 (its proj GEMM reads
    attention rows of 48 bytes, whose pad the core never writes), with the
    LIS, the 128-bit row sum and the float softmax, on 197 and 150 real
    keys of 200, against its plain version on the qact2 grid; the
    proj's K-major weight is made once."""
    from diffvit_tpu_torch.ops.kernels import attention, gemm
    from diffvit_tpu_torch.testing import alt_kernel_cases
    ip = _wide_vit(D36, QuantConfig()) if rule == "lis_wide" else \
        random_int_model(D36, seed=0)
    args, kw = alt_kernel_cases(D36, ip, 3, cuda, npad=200,
                                lis=rule != "softmax",
                                seed=n_real)["fused_attention_block"]
    x = args[0].clone()
    x[:, n_real:] = 0
    args = (x, *args[1:])
    kw = dict(kw, n_real=n_real, lis_wide=rule == "lis_wide")
    fn = attention.fused_attention_block
    before = fn.launches
    got = fn(*args, **kw)
    misses = gemm.per_weight.misses
    again = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert gemm.per_weight.misses == misses
    assert torch.equal(got, again)
    want = attention.fused_attention_block_plain(*args, **kw)
    s2 = args[8][3]
    g, w = (torch.round(t / s2).cpu().numpy() for t in (got, want))
    if rule == "softmax":
        _assert_softmax_codes_close(g, w)
    else:
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("spec,batch", [(SMALL, 1), (SMALL, 8),
                                        (SMALL, 64), (D36, 3)])
def test_attention_block_proj_footprint(cuda, spec, batch):
    """K7a's proj GEMM (the wgmma mainloop with the fences' epilogue) at
    Npad 200: setmaxnreg's register budget, the plan's blocks an SM and
    shared memory, and no spill."""
    from diffvit_tpu_torch.ops.kernels import attention, gemm
    c, rows = spec.embed_dim, batch * 200
    f = attention.proj_gemm_footprint(rows, c, c, cuda)
    plan = gemm.device_plan(rows, c, -(-c // 16) * 16, cuda)
    assert f["local_bytes"] == 0, f
    assert f["registers"] == {1: 168, 2: 80}[plan.blocks], f
    assert f["blocks_per_sm"] == plan.blocks, f
    assert f["smem_bytes"] >= plan.smem, f


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


@pytest.mark.parametrize("batch,npad", [(2, 24), (3, 200), (256, 200),
                                        (1, 200), (8, 200)])
def test_probe_linear_attention_matches_plain(cuda, batch, npad):
    """P5 (K1 with w = a * 2^-7) at the script's width, bit for bit, at
    B = 1 and 8 and up to its B=256."""
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
    (2, 24, 2, 16, 21), (3, 45, 6, 64, 33), (128, 200, 6, 64, 197),
    (1, 200, 6, 64, 197), (8, 200, 6, 64, 197), (2, 256, 2, 32, 256)])
def test_probe_pingpong_matches_plain(cuda, batch, npad, heads, d, n_real):
    """P1's producer and consumer against their plain versions bit for bit
    (the script's B=128 half-stream, and B = 1 and 8, whose persistent
    blocks get one item or none), and paired equal to the two halves."""
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


@pytest.mark.parametrize("rows,iters", [(128, 8), (64, 8), (192, 8),
                                        (64 * 512, 220)])
@pytest.mark.parametrize("mode", ["dot_only", "vpu_only", "dot_vpu_consume",
                                  "dot_vpu_in_join", "dot_vpu_in_split"])
def test_probe_overlap_matches_plain(cuda, rows, iters, mode):
    """P2's five modes within overlap.compare's tolerances (the dot's
    summation order; the tanh chain's roundings), at the script's 32768 x
    512 too, and at 64 and 192 rows (a 128-row tile's second consumer
    past M; a partly filled persistent grid)."""
    from diffvit_tpu_torch.probes import overlap as p2
    a, b, v = p2.inputs(cuda, rows)
    fn = p2.KERNELS[mode]
    before = fn.launches
    got = fn(a, b, v, iters=iters)
    _launched_once(fn, before)
    want = p2.overlap_plain(a, b, v, mode, iters)
    share, max_err, ok = p2.compare(mode, a, b, got, want, iters)
    assert ok, (share, max_err)


@pytest.mark.parametrize("shape", [(128, 64, 32), (192, 192, 96),
                                   (64, 64, 0), (192, 128, 0)], ids=str)
@pytest.mark.parametrize("mode", ["dot_only", "vpu_only", "dot_vpu_consume",
                                  "dot_vpu_in_join", "dot_vpu_in_split"])
def test_probe_overlap_ragged_shapes(cuda, shape, mode):
    """P2's five modes within overlap.compare's tolerances at (M, N, K)
    off the legs' geometry: K = 32 (one stage half zero filled by TMA), K
    = 96 and N = 192 (three column tiles), and K = 0 (no stage: y = 0,
    the chain still runs)."""
    from diffvit_tpu_torch.probes import overlap as p2
    m, n, k = shape
    a, b, v = p2.inputs(cuda, m, n, k)
    fn = p2.KERNELS[mode]
    before = fn.launches
    got = fn(a, b, v, iters=8)
    _launched_once(fn, before)
    want = p2.overlap_plain(a, b, v, mode, 8)
    share, max_err, ok = p2.compare(mode, a, b, got, want, 8)
    assert ok, (share, max_err)


@pytest.mark.parametrize("rows", [200, 197, 1000, 99 * 512])
@pytest.mark.parametrize("mode", ["dot", "input", "nogelu", "pipelined",
                                  "staged"])
def test_probe_overlap_mlp_matches_plain(cuda, rows, mode):
    """P3's five modes bit for bit against their plain versions (the
    script's 50,688 rows too, and 197 and 1,000: ragged tiles, partly
    filled persistent blocks); pipelined and staged equal dot."""
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
    """P3's pipelined mode (two accumulator sets) and staged mode
    (ping-pong consumers) with one 128-byte K stage a tile, partly zero
    filled (Cin 32, 64, 128), a ragged Hid (96) and rows that leave the
    last tile partly or a consumer's half wholly empty: equal to dot and
    to the plain version."""
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


@pytest.mark.parametrize("shape", [(257, 1024, 4096), (1000, 928, 928)],
                         ids=str)
@pytest.mark.parametrize("mode", ["dot", "input", "nogelu", "pipelined",
                                  "staged"])
def test_probe_overlap_mlp_deep_k(cuda, shape, mode):
    """P3's five modes bit for bit against their plain versions where fc1's
    K stages outnumber pipelined's ring (Cin 1024 and 928: 8 stages of 128
    bytes against 7), so that pipelined releases a tile's stages as its
    products retire; pipelined and staged equal dot."""
    from diffvit_tpu_torch.probes import overlap_mlp as p3
    args = p3.inputs(cuda, *shape)
    fn = p3.KERNELS[f"mlp_{mode}"]
    before = fn.launches
    got = fn(*args)
    _launched_once(fn, before)
    assert torch.equal(got, p3.overlap_mlp_plain(*args, mode))
    if mode in ("pipelined", "staged"):
        assert torch.equal(got, p3.mlp_dot(*args))


def test_probe_footprints(cuda):
    """P2's five kernels, P3's fc1 kernels and P1's three kernels report
    their registers, shared memory and blocks an SM, with no spill in P2
    or P3, each at its plan's blocks an SM and setmaxnreg's budget within
    its launch registers: pipelined, which holds two tiles' accumulators,
    fits no more blocks than dot; staged as many; paired carries at least
    the larger role's shared memory."""
    from diffvit_tpu_torch.probes import overlap as p2
    from diffvit_tpu_torch.probes import overlap_mlp as p3
    from diffvit_tpu_torch.probes import pingpong as p1
    fc1 = {m: p3.fc1_occupancy(m) for m in p3.MODES}
    p2f = {m: p2.footprint(m, dev=cuda) for m in p2.MODES}
    roles = {r: p1.footprint(r) for r in ("producer", "consumer", "paired")}
    for f in (*fc1.values(), *roles.values(), *p2f.values()):
        assert f["registers"] > 0 and f["blocks_per_sm"] >= 1
    for f in (*fc1.values(), *p2f.values()):
        budget = sum(32 * r["warps"] * r["registers"]
                     for r in f["roles"].values())
        assert f["local_bytes"] == 0 and f["registers"] * 384 >= budget, f
    assert fc1["pipelined"]["blocks_per_sm"] <= fc1["dot"]["blocks_per_sm"]
    assert fc1["staged"]["blocks_per_sm"] == fc1["dot"]["blocks_per_sm"]
    assert roles["paired"]["smem_bytes"] >= max(
        roles["producer"]["smem_bytes"], roles["consumer"]["smem_bytes"])


@pytest.mark.parametrize("batch", [1, 8, 128])
def test_probe_footprints_do_not_spill(cuda, batch):
    """P1's three kernels and P5's linear core at the legs' geometry: no
    spill to local memory, one block an SM for the producer and paired
    (a launch count that leaves setmaxnreg's moves their registers), at
    least as many consumer blocks an SM as K1's core holds."""
    from diffvit_tpu_torch.ops.kernels import attention
    from diffvit_tpu_torch.ops.kernels import pingpong_plan as plans
    from diffvit_tpu_torch.probes import attn_overlap as p5
    from diffvit_tpu_torch.probes import pingpong as p1
    roles = {r: p1.footprint(r, batch, cuda)
             for r in ("producer", "consumer", "paired")}
    core = p5.core_footprint(2 * batch, cuda)
    for f in (*roles.values(), core):
        assert f["local_bytes"] == 0 and f["blocks_per_sm"] >= 1, f
    for role, threads, split in (
            ("producer", 384, plans.PRODUCER_ROLES),
            ("paired", 896, plans.PAIRED_ROLES)):
        f = roles[role]
        assert f["blocks_per_sm"] == 1, f
        assert f["registers"] * threads >= sum(
            32 * r.warps * r.registers for r in split), f
    assert roles["consumer"]["blocks_per_sm"] >= 3, roles["consumer"]
    k1 = attention.core_footprint(2 * batch, 6, 200, 64, 197, cuda)
    assert core["registers"] <= 80 and k1["registers"] <= 80


def test_int_matmul_keeps_the_callers_tf32_setting(cuda):
    """int_matmul switches TF32 off for its own float32 products and gives
    the caller's setting back: set True before, True after, the product
    exact."""
    from diffvit_tpu_torch.ops.quant import int_matmul
    rng = np.random.default_rng(11)
    a = torch.tensor(rng.integers(-128, 128, (64, 2500)), dtype=torch.int8)
    b = torch.tensor(rng.integers(-128, 128, (2500, 48)), dtype=torch.int8)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = int_matmul(a.to(cuda), b.to(cuda))
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    want = torch.matmul(a.to(torch.int64), b.to(torch.int64))
    assert torch.equal(got.cpu().to(torch.int64), want)


@pytest.mark.parametrize("shape", [(4,), (16,), (8188,), (8196,),
                                   (7 * 8192,), (64, 3, 224, 224),
                                   (1176, 1024)])
def test_probe_tile_sum_matches_plain(cuda, shape):
    """P4 on a uint8 batch cast to float32 and on halves: exact, in one
    launch, also where a block's share is shorter than a ring stage (4,
    16, 8,188 elements), its last stage short (8,196) or the stages odd
    in number (7 x 8,192)."""
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


def test_probe_tile_sum_resets_its_ticket(cuda):
    """P4's last block resets the ticket its blocks draw: calls in a row at
    two sizes on the same scratch, then on a second stream (its own
    scratch), each exact, and the tickets 0 after each."""
    from diffvit_tpu_torch.probes import ingest as p4
    rng = np.random.default_rng(1)
    xs = [torch.tensor(rng.integers(0, 255, n), dtype=torch.float32,
                       device=cuda) for n in (8196, 9408 * 1024)]
    outs = [p4.tile_sum(x) for x in (xs[0], xs[1], xs[0], xs[1])]
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        outs += [p4.tile_sum(x) for x in (xs[1], xs[0])]
    side.synchronize()
    torch.cuda.synchronize()
    wants = [p4.tile_sum_plain(x) for x in xs]
    for got, i in zip(outs, (0, 1, 0, 1, 1, 0)):
        assert torch.equal(got, wants[i])
    streams = {key[1] for key in p4._SCRATCH}
    assert {side.cuda_stream,
            torch.cuda.current_stream(cuda).cuda_stream} <= streams
    assert all(int(ticket) == 0 for _, ticket in p4._SCRATCH.values())


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

D12 = ViTSpec("test_d12", embed_dim=24, depth=1, num_heads=2, num_classes=10)
D16 = ViTSpec("test_d16", embed_dim=32, depth=1, num_heads=2, num_classes=10)
D64 = ViTSpec("test_d64", embed_dim=128, depth=1, num_heads=2,
              num_classes=10)


@pytest.mark.parametrize("lis", [True, False], ids=["lis", "softmax"])
@pytest.mark.parametrize("spec", [D12, D16, TINY, D64],
                         ids=["d12", "d16", "d32", "d64"])
@pytest.mark.parametrize("batch", [1, 3, 64])
@pytest.mark.parametrize("npad,n_real", [(256, 256), (150, 131)])
@pytest.mark.parametrize("kernel", ["k1", "k5"])
def test_attention_core_matches_plain_at_every_shape(cuda, kernel, npad,
                                                     n_real, batch, spec,
                                                     lis):
    """K1 and K5 against their plain versions at 256 keys and at an odd
    n_real below npad (a ragged last key block, query rows past n_real),
    b = 1, 3 and 64, D = 12 (half an n tile of attn@v past D, not
    stored), 16, 32 and 64, both softmaxes: the LIS exact, the float
    softmax by its rule."""
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


@pytest.mark.parametrize("spec,batch", [
    (SwinSpec("swin_test", embed_dim=32, depths=(2, 1), num_heads=(2, 4),
              num_classes=10), 2),
    (SWIN_SPECS["swin_tiny"], 4)], ids=["tiny", "swin_t"])
def test_swin_calibrate_bake_serve_on_card_matches_cpu(cuda, spec, batch):
    """The same for a Swin: QuantizedViT calibrates the same params on the
    same Gaussian batch on the card and on the CPU (at least 99.9% of the
    qparam elements equal, global_distance equal); both bakes served
    through IntModel (K4 and K2 on the card), the fake-quant forwards too,
    agree by _assert_paths_agree, and the card's K4b route equals its K4
    route."""
    params = init_swin_params(spec, torch.Generator().manual_seed(0), "cpu")
    x = gaussian_calibration(batch, seed=0)
    card = engine.QuantizedViT(spec, QuantConfig(), params=params,
                               device=cuda)
    cpu = engine.QuantizedViT(spec, QuantConfig(), params=params,
                              device="cpu")
    card.calibrate(x)
    cpu.calibrate(x)
    assert set(card.qparams) == set(cpu.qparams)
    total = sum(v.numel() for v in cpu.qparams.values())
    equal = sum(int((card.qparams[k].cpu() == v).sum())
                for k, v in cpu.qparams.items())
    assert equal / total >= 0.999, (equal, total)
    np.testing.assert_array_equal(card.global_distance, cpu.global_distance)
    pixels = np.random.default_rng(1).integers(
        0, 256, (batch, 3, spec.img_size, spec.img_size), dtype=np.uint8)
    model = card.prepare_int()
    got = model(pixels)
    _assert_paths_agree(got.cpu().numpy(), cpu.prepare_int()(pixels).numpy())
    _assert_paths_agree(card(pixels).cpu().numpy(), cpu(pixels).numpy())
    xc = torch.tensor(model.encode(pixels), device=cuda)
    with torch.inference_mode():
        v2 = swin_int.forward_q_int(model.ip, spec, model.cfg, xc,
                                    attn_v2=True)
    assert torch.equal(v2, got)


# ---- the 128-bit LIS row sum (lis_wide) -----------------------------------

def _wide_vit(spec, cfg, s_a=2.0**-12):
    """A random int-model with every block's softmax scale at ``s_a``
    (2^-12: the int64 row sum over 197 keys could overflow)."""
    ip = random_int_model(spec, cfg, seed=0)
    for ib in ip["blocks"]:
        ib["attn.qact_attn1"]["scale"] = np.float32(s_a)
    return ip


@pytest.mark.parametrize("batch", [1, 3, 8, 64])
def test_lis_wide_vit_kernels_match_plain(cuda, batch):
    """K1, K5, K8 (v1, v3, v4, v5), K7a and K6 with the 128-bit row sum at
    DeiT-S width, s_a = 2^-12: each bit for bit against its plain
    version."""
    from diffvit_tpu_torch.ops.kernels.attention import lis_sum_fits
    from diffvit_tpu_torch.testing import alt_kernel_cases
    assert not lis_sum_fits(2.0**-12, 197)
    dev = lambda a: torch.tensor(np.asarray(a), device=cuda)  # noqa: E731
    ip = _wide_vit(SMALL2, QuantConfig())
    ib = ip["blocks"][0]
    q = ib["qkv"]
    x = dev(_codes((batch, 197, SMALL2.embed_dim), batch))
    k1 = ((x, dev(q["w_int"]), dev(q["mult"]), dev(q["b"]),
           dev(attn_constants(ib, SMALL2, 0)[0])),
          dict(num_heads=SMALL2.num_heads, head_dim=SMALL2.head_dim,
               n_real=197, lis_wide=True))
    qkv = dev(_codes((batch, 197, 3 * SMALL2.embed_dim), batch + 1) // 3)
    k5 = ((qkv.view(batch, 197, 3, SMALL2.num_heads, -1)
           .permute(0, 2, 3, 1, 4), dev(int_attn_scalars(ib, SMALL2))),
          dict(num_heads=SMALL2.num_heads, n_real=197, lis_wide=True))
    pairs = {"k1": ((fused_qkv_attention_v2, fused_qkv_attention_v2_plain),
                    k1),
             "k5": ((fused_int_attention, fused_int_attention_plain), k5)}
    cases = alt_kernel_cases(SMALL2, ip, batch, cuda, npad=200, seed=batch)
    for name, fns in _alt_pairs().items():
        if name != "fused_int_mlp_block" and (
                name != "fused_qkv_attention_v5" or batch % 2 == 0):
            args, kw = cases[name]
            pairs[name] = (fns, (args, dict(kw, lis_wide=True)))
    ipc = int_model_from_numpy(ip, SMALL2, cuda)
    assert all(b["lis_wide"] for b in ipc["blocks"])
    xr = x.reshape(batch * 197, -1)
    pairs["k6"] = ((resident_codes, resident_codes_plain),
                   ((prepare_resident(ipc, SMALL2, QuantConfig()), xr),
                    dict(n_real=197, bits=4, lis=True, nelems=batch,
                         lis_wide=True)))
    for name, ((fn, plain), (args, kw)) in pairs.items():
        before = fn.launches
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        assert fn.launches == before + 1, name
        want = plain(*args, **kw)
        if name == "fused_attention_block":
            s2 = args[8][3]
            got, want = torch.round(got / s2), torch.round(want / s2)
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy(),
                                      err_msg=name)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_lis_wide_swin_kernels_match_plain(cuda, stage):
    """K4 and K4b with the 128-bit row sum at each Swin-T stage, s_a2 =
    2^-13 over the 49-key windows (shifted block), bit for bit against the
    plain version."""
    spec = SWIN_SPECS["swin_tiny"]
    ip = random_swin_int_model(spec, seed=0)
    p = f"layers.{stage}.blocks.1"
    qp = dict(ip["qp"], **{f"{p}.attn.qact2.scale": np.float32(2.0**-13)})
    k = swin_block_constants(ip["layers"][stage]["blocks"][1], qp, p, spec,
                             stage, 1, QuantConfig())
    assert k["lis_wide"]
    res = spec.stage_resolution(stage)[0]
    nw, heads, c = (res // 7) ** 2, spec.num_heads[stage], \
        spec.stage_dim(stage)
    dev = lambda a: None if a is None else torch.tensor(  # noqa: E731
        np.asarray(a), device=cuda)
    qkv = dev(_codes((2 * nw, 49, 3 * c), stage))
    consts = (dev(k["bias_q"]), dev(k["mask_div"]), dev(k["attn_scalars"]))
    kw = dict(num_heads=heads, n_real=49, n_windows=nw, lis_wide=True)
    view = qkv.view(2 * nw, 49, 3, heads, 32).permute(0, 2, 3, 1, 4)
    want = swin_attention_plain(view[:, 0], view[:, 1], view[:, 2], *consts,
                                n_real=49, n_windows=nw, lis_wide=True)
    got = fused_swin_attention(view, *consts, **kw)
    got2 = fused_swin_attention_v2(qkv, *consts, head_dim=32, **kw)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    np.testing.assert_array_equal(
        got2.cpu().numpy(),
        want.permute(0, 2, 1, 3).reshape(2 * nw, 49, c).cpu().numpy())


# ---- the data pipeline and the CLI on the card ------------------------------

def test_device_prefetcher_on_card(cuda):
    """Pinned memory and a side stream: the batches arrive on the card in
    order and equal to the host's, at most ``depth`` ahead; an early
    break stops the feeder."""
    from diffvit_tpu_torch.data.imagenet import DevicePrefetcher
    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 256, (8, 3, 224, 224), dtype=np.uint8),
                np.arange(8, dtype=np.int32) + i) for i in range(6)]
    pf = DevicePrefetcher(batches, depth=2, device=cuda)
    for (x, y), (hx, hy) in zip(pf, batches):
        assert x.device.type == "cuda" and x.dtype == torch.uint8
        np.testing.assert_array_equal(x.cpu().numpy(), hx)
        np.testing.assert_array_equal(y, hy)
    for i, _ in enumerate(pf):
        if i == 1:
            break


def test_cli_on_card(cuda, tmp_path, monkeypatch, capsys):
    """A TINY DeiT through the CLI on the card: --quant --mode 1
    --int-path --save-int, then --load-int per kernel and --resident on
    the codes wire; the same report each time, K1 + K2 (or K6) launched;
    and IntModel(microbatch=3) bit-equal to the unchunked forward."""
    from diffvit_tpu_torch import cli
    from diffvit_tpu_torch.data.synthetic import make_fake_imagefolder
    monkeypatch.setitem(VIT_SPECS, "deit_test", TINY)
    make_fake_imagefolder(str(tmp_path / "val"), num_classes=3, per_class=3,
                          size=(80, 60))
    art = str(tmp_path / "tiny.npz")
    common = ["--val-batchsize", "4", "--num-workers", "2", "--wire", "u8"]
    before = fused_qkv_attention_v2.launches
    res = cli.main(["deit_test", str(tmp_path), "--quant", "--mode", "1",
                    "--calib-batchsize", "4", "--int-path", "--save-int",
                    art, *common])
    assert fused_qkv_attention_v2.launches == before + 3 * TINY.depth
    served = cli.main(["deit_test", str(tmp_path), "--load-int", art,
                       *common])
    before = resident_codes.launches
    resident = cli.main(["deit_test", str(tmp_path), "--load-int", art,
                         "--resident", *common])
    assert resident_codes.launches == before + 3
    assert res == served == resident
    assert "Saved int artifact" in capsys.readouterr().out
    x = np.random.default_rng(2).integers(0, 256, (7, 3, 224, 224),
                                          dtype=np.uint8)
    want = engine.load_int_model(art, cuda)(x).cpu().numpy()
    for resident_route in (False, True):
        got = engine.load_int_model(art, cuda, resident=resident_route,
                                    microbatch=3)(x).cpu().numpy()
        np.testing.assert_array_equal(got, want)


# ---- the recovery passes (AdaRound, QAT, bias correction) -----------------

@pytest.mark.parametrize("spec", [TINY, SMALL2], ids=["tiny", "deit_s_2"])
def test_ste_forward_on_card_equals_cpu(cuda, spec):
    """forward_q(ste=True) on the card: bit-equal to ste=False there, and
    the card's STE gradient of a logits MSE against the CPU's (cosine >=
    0.9999 a leaf) from the same calibration."""
    from diffvit_tpu_torch.models import vit
    params = init_params(spec, torch.Generator().manual_seed(0), "cpu")
    x = gaussian_calibration(4, seed=0)
    cpu = engine.QuantizedViT(spec, QuantConfig(), params=params,
                              device="cpu")
    cpu.calibrate(x)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        p = vit.params_from_numpy(params, dev)
        leaves = [t.requires_grad_(True) for t in (
            p["head"]["w"], p["blocks"][0]["fc1"]["w"],
            p["blocks"][0]["norm1"]["w"], p["pos_embed"])]
        qp = vit.autograd_safe({k: v.to(dev)
                                for k, v in cpu.qparams.items()})
        xt = torch.tensor(x, device=dev)
        y = vit.forward_q(p, qp, spec, QuantConfig(), xt, ste=True)
        with torch.no_grad():
            assert torch.equal(y, vit.forward_q(p, qp, spec, QuantConfig(),
                                                xt))
        loss = (y.to(torch.float64) ** 2).mean()
        grads[dev.type] = [g.cpu() for g in torch.autograd.grad(loss,
                                                                 leaves)]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        cos = float((a * b).sum() / (a.norm() * b.norm()))
        assert cos >= 0.9999, cos


@pytest.mark.parametrize("spec", [TINY, SMALL2], ids=["tiny", "deit_s_2"])
def test_recovery_passes_on_card_then_k1_k2(cuda, spec):
    """AdaRound and QAT on the card and on the CPU from the same
    calibration: the learned codes equal (at least 99.9%), the first QAT
    loss within rtol 1e-6 (Adam moves a weight by about lr whatever the
    size of its gradient, so a last-bit difference of a float64 backward
    can flip a code later on); bias correction from the CPU's QAT params
    on both, the biases within 1e-6; the card's bake equals a fresh bake
    of its params, is served through exactly depth K1 + depth K2 a
    forward, holds the params' codes, and agrees with the CPU's by
    _assert_paths_agree."""
    from diffvit_tpu_torch.models import vit
    params = init_params(spec, torch.Generator().manual_seed(0), "cpu")
    x = gaussian_calibration(4, seed=0)
    models = {}
    for dev in (cuda, torch.device("cpu")):
        q = engine.QuantizedViT(spec, QuantConfig(), params=params,
                                device=dev)
        q.calibrate(x)
        q.adaround(x, steps=20, max_rows=512)
        codes = q.params["blocks"][0]["fc1"]["w"].cpu().clone()
        losses = q.qat(x, steps=3, lr=1e-5)
        models[dev.type] = (q, codes, losses)
    (card, w_card, l_card), (cpu, w_cpu, l_cpu) = models["cuda"], \
        models["cpu"]
    assert float((w_card == w_cpu).float().mean()) >= 0.999
    np.testing.assert_allclose(l_card[0], l_cpu[0], rtol=1e-6)
    card.params = vit.params_from_numpy(cpu.params, cuda)
    card.bias_correct(x)
    cpu.bias_correct(x)
    b_card = card.params["blocks"][0]["qkv"]["b"].cpu()
    b_cpu = cpu.params["blocks"][0]["qkv"]["b"]
    assert float((b_card - b_cpu).abs().max()) <= 1e-6
    pixels = np.random.default_rng(1).integers(0, 256, (4, 3, 224, 224),
                                               dtype=np.uint8)
    model = card.prepare_int()
    k1, k2 = fused_qkv_attention_v2.launches, fused_int_mlp.launches
    got = model(pixels)
    torch.cuda.synchronize()
    assert fused_qkv_attention_v2.launches - k1 == spec.depth
    assert fused_int_mlp.launches - k2 == spec.depth
    fresh = engine.IntModel(vit_int.prepare_int(card.params, card.qparams,
                                                spec, QuantConfig()),
                            spec, QuantConfig(), cuda)
    assert torch.equal(fresh(pixels), got)
    qp = card.qparams
    ch = qp["blocks.0.mlp.fc1.sq.channel_scale"][0]
    s = qp["blocks.0.mlp.fc1.w.int4.scale"][0]
    codes = torch.clamp(torch.round(card.params["blocks"][0]["fc1"]["w"]
                                    * ch / s[:, None]), -8, 7)
    # the served (K, Cout) int8 codes are the params' codes
    assert torch.equal(model.ip["blocks"][0]["fc1"]["w_int"].to(
        torch.float32), codes.T)
    _assert_paths_agree(got.cpu().numpy(), cpu.prepare_int()(pixels).numpy())


@pytest.mark.parametrize("spec", [TINY, SMALL2], ids=["tiny", "deit_s_2"])
def test_generate_data_on_card_then_k1_k2(cuda, spec):
    """PSAQ generation on the card and on the CPU from the same params and
    draws: the first loss within rtol 1e-6 and, after two Adam steps, at
    least 99.9% of the pixels bit-equal and at most 0.01% 1e-3 apart (a
    first step is lr * sign(g); measured 100% bit-equal);
    the card's images calibrate a bake served through exactly depth K1 +
    depth K2 a forward; CKA heatmaps within 1e-5 and PGD's elements equal
    in at least 99%."""
    from diffvit_tpu_torch.analysis import activations, cka, datagen, pgd
    params = init_params(spec, torch.Generator().manual_seed(0), "cpu")
    img, pred, var = datagen._draws(spec, 4, seed=0)
    x = gaussian_calibration(8, seed=3)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        p = engine.QuantizedViT(spec, QuantConfig(), params=params,
                                device=dev)
        loss = float(datagen.psaq_loss(p.params, spec, img.to(dev),
                                       pred.to(dev), var, 4))
        two = datagen.generate_data(p.params, spec, batch_size=4, seed=0,
                                    iters_per_epoch=2, epochs=1)
        acc = cka.MinibatchCKA(6 * spec.depth + 2)
        acc.update_state(activations.get_activations(p, x))
        adv = pgd.AttackPGD(p, num_steps=3, quant=False).gen_adv_inputs(
            x[:4], [1, 2, 3, 4], generator=torch.Generator().manual_seed(0))
        runs.append((p, loss, two, acc.result().cpu().numpy(), adv.cpu()))
    (card, l_card, two_card, h_card, a_card), (_, l_cpu, two_cpu, h_cpu,
                                               a_cpu) = runs
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-6)
    d = (two_card.cpu() - two_cpu).abs()
    assert float((d == 0).float().mean()) >= 0.999
    assert float((d > 1e-3).float().mean()) <= 1e-4
    np.testing.assert_allclose(h_card, h_cpu, atol=1e-5)
    assert float((a_card == a_cpu).float().mean()) >= 0.99
    card.calibrate(two_card)
    model = card.prepare_int()
    k1, k2 = fused_qkv_attention_v2.launches, fused_int_mlp.launches
    got = model(np.random.default_rng(1).integers(0, 256, (4, 3, 224, 224),
                                                  dtype=np.uint8))
    torch.cuda.synchronize()
    assert fused_qkv_attention_v2.launches - k1 == spec.depth
    assert fused_int_mlp.launches - k2 == spec.depth
    assert bool(torch.isfinite(got).all())


# ---- the diff-analysis toolkit (DDV Hessian, spectrum, restore sweeps) ----

def test_ddv_hessian_on_card_equals_cpu(cuda):
    """The DDV-Hessian traces of TINY (tap 10, its 7 weights, 3 probes a
    trace) on the card and on the CPU from the same params and probes:
    within 1e-6 relative; the top eigenvalue the same way."""
    from diffvit_tpu_torch.analysis import ddv_hessian, hessian
    params = init_params(TINY, torch.Generator().manual_seed(0), "cpu")
    x = gaussian_calibration(3, seed=4)
    adv = x + np.random.default_rng(5).uniform(-0.06, 0.06, x.shape).astype(
        np.float32)
    probes = {}

    def draw(name, k, like):
        key = (name, k)
        if key not in probes:
            probes[key] = hessian.rademacher(
                like.cpu(), torch.Generator().manual_seed(len(probes)))
        return probes[key].to(like.device)

    out = []
    for dev in (cuda, torch.device("cpu")):
        m = engine.QuantizedViT(TINY, QuantConfig(), params=params,
                                device=dev)
        d = ddv_hessian.DDVHessian(m, m, (x, None), adv, layer_indices=10,
                                   max_iter=3)
        names, traces = d.trace(probes=draw)
        eig, _ = hessian.top_eigenvalues(
            m.params, TINY, x, [1, 2, 3], max_iter=4,
            names=["head.weight", "blocks.1.mlp.fc1.weight"],
            starts=lambda i, n, like: torch.randn(
                like.shape, generator=torch.Generator().manual_seed(i))
            .to(like.device))
        out.append((names, traces, eig))
    (n_card, t_card, e_card), (n_cpu, t_cpu, e_cpu) = out
    assert n_card == n_cpu and len(n_card) == 7
    np.testing.assert_allclose(t_card, t_cpu, rtol=1e-6)
    np.testing.assert_allclose(e_card, e_cpu, rtol=1e-6)


def test_int_restore_sweep_on_card_equals_cpu(cuda, tmp_path):
    """The restore sweep of a calibrated TINY on the integer path
    (``validate(use_int=True)``) over a fake ImageFolder of 8 images in
    batches of 4: exactly depth K1 + depth K2 a forward on the card, and
    the lines equal to the CPU's apart from ``Time``."""
    from diffvit_tpu_torch.analysis import restore
    from diffvit_tpu_torch.data import imagenet
    from diffvit_tpu_torch.data.synthetic import make_fake_imagefolder
    make_fake_imagefolder(str(tmp_path / "val"), num_classes=4, per_class=2)
    loader = imagenet.DataLoader(imagenet.ImageFolder(
        str(tmp_path / "val"), imagenet.build_transform()), 4,
        num_workers=2)
    params = init_params(TINY, torch.Generator().manual_seed(0), "cpu")
    calib = gaussian_calibration(4, seed=6)
    combos = restore.k_layer_combinations(1, limit=3)
    lines = []
    for dev in (cuda, torch.device("cpu")):
        q = engine.QuantizedViT(TINY, QuantConfig(), params=params,
                                device=dev)
        q.calibrate(calib)
        path = tmp_path / f"{dev.type}.txt"
        k1, k2 = fused_qkv_attention_v2.launches, fused_int_mlp.launches
        restore.run_restore_sweep(
            q, loader, combos, out_path=str(path), log=lambda *_: None,
            validate_fn=lambda bc, q=q: engine.validate(
                q, loader, bc, print_freq=0, log=lambda *_: None,
                use_int=True)[1:])
        if dev.type == "cuda":
            torch.cuda.synchronize()
            forwards = 4 * 2  # four configurations, two batches each
            assert fused_qkv_attention_v2.launches - k1 == \
                forwards * TINY.depth
            assert fused_int_mlp.launches - k2 == forwards * TINY.depth
        lines.append([ln.rsplit(" Time ", 1)[0] for ln in open(path)])
    assert lines[0] == lines[1] and len(lines[0]) == 4


@pytest.mark.parametrize("dims", [dict(dp=1, tp=2), dict(dp=1, pp=2)],
                         ids=["tp2", "pp2"])
def test_parallel_leg_on_card_world_2(cuda, dims):
    """Two ranks on the card (gloo through pinned host memory where they
    share it, NCCL where each has its own; ``parallel.comm.spawn``): the
    DeiT-S-wide int4 model at depth 2 under tp=2 (K1 on 3 of the 6 heads)
    or pp=2 (one block a stage, 4 microbatches), b = 8: every rank's
    logits equal the single-process card forward's bit for bit, its
    launches are exact, and every kernel call of rank 0's forward equals
    its plain version."""
    from diffvit_tpu_torch.parallel import comm, dryrun

    x = np.random.default_rng(3).integers(0, 256, (8, 3, 224, 224),
                                          dtype=np.uint8)
    models = {"m": ("int", random_int_model(SMALL2, QuantConfig(), 0),
                    SMALL2, QuantConfig())}
    legs = [dict(name="leg", kind="int", n=2, mesh=dims, model="m", x=x,
                 hold=True)]
    res = [r[0] for r in comm.spawn(dryrun.run_legs, 2, "cuda",
                                    args=(legs, models))]
    per = 2 if "tp" in dims else 4  # blocks a rank runs, times microbatches
    want = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    for r in res:
        assert r["equal"] and r["backend"] == want and r["bytes"] > 0
        assert r["launches"] == {"fused_qkv_attention_v2": per,
                                 "fused_int_attention": 0,
                                 "fused_int_mlp": per,
                                 "fused_swin_attention": 0}
    calls, equal, names = res[0]["held"]
    assert calls == equal == 2 * per
    assert names == ["fused_int_mlp", "fused_qkv_attention_v2"]

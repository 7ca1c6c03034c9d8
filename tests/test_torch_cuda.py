"""The CUDA kernels vs their plain PyTorch versions, on a CUDA card.

This file imports neither JAX nor the JAX package, so it runs where the
card is: ``python -m pytest --noconftest tests/test_torch_cuda.py``
(tests/conftest.py imports JAX).  Every test carries the ``cuda`` marker;
without a card each skips.  K1, K2 and K5 share their device code with
the resident kernel K6 (``csrc/attention_core.cuh``, ``int8_gemm.cuh``,
``int_mlp.cuh``), and K3, K7a, K7b and K8 with them; their tests here hold
each exact against its plain version."""
import dataclasses

import numpy as np
import pytest
import torch

from diffvit_tpu_torch import QuantConfig, engine
from diffvit_tpu_torch.models import swin_int, vit_int
from diffvit_tpu_torch.models.convert import (attn_constants,
                                              int_attn_scalars,
                                              int_model_from_numpy,
                                              swin_block_constants,
                                              swin_int_model_from_numpy)
from diffvit_tpu_torch.models.swin import SWIN_SPECS, SwinSpec
from diffvit_tpu_torch.models.vit import VIT_SPECS, ViTSpec
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
    (SMALL2, 8, 197)])
def test_resident_kernel_matches_plain(cuda, spec, batch, npad, lis):
    """K6 (every block in one cooperative launch) vs its plain version;
    rows past the 197 tokens of an image are zero padding."""
    cfg = QuantConfig()
    ip = int_model_from_numpy(random_int_model(spec, cfg, seed=2), spec,
                              cuda, cfg)
    packed = prepare_resident(ip, spec, cfg)
    x = _codes((batch, npad, spec.embed_dim), 6)
    x[:, 197:] = 0
    x = torch.tensor(x.reshape(batch * npad, -1), device=cuda)
    kw = dict(n_real=197, bits=4, lis=lis, nelems=batch)
    before = resident_codes.launches
    got = resident_codes(packed, x, **kw)
    torch.cuda.synchronize()
    assert resident_codes.launches == before + 1
    want = resident_codes_plain(packed, x, **kw)
    def real(t):
        return t.reshape(batch, npad, -1)[:, :197].cpu().numpy()
    if lis:
        np.testing.assert_array_equal(real(got), real(want))
    else:
        _assert_softmax_codes_close(real(got), real(want))


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


@pytest.mark.parametrize("spec,rows", [(TINY, 391), (SMALL, 197 * 2)])
@pytest.mark.parametrize("emit_codes", [True, False])
def test_int_mlp_kernel_matches_plain(cuda, spec, rows, emit_codes):
    ib, _ = _block(spec)
    dev = lambda a: torch.tensor(np.asarray(a), device=cuda)  # noqa: E731
    f1, f2 = ib["fc1"], ib["fc2"]
    args = (dev(_codes((rows, spec.embed_dim), 2)), dev(f1["w_int"]),
            dev(f2["w_int"]), dev(f1["mult"]), dev(f1["b"]),
            dev(f2["mult"]), dev(f2["b"]), dev(ib["mlp.qact2"]["scale"]),
            dev(ib["mlp.qact1"]["scale"]))
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


def test_qkv_attention_v1_reads_strided_weights(cuda):
    """K8 v1 on per-head weights that are strided views of K1's (Cin, 3C)
    weight (no copy) gives the codes of the contiguous copies, and of the
    plain version."""
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
                                      (1, 384, 1000), (77, 100, 37)])
@pytest.mark.parametrize("mode", ["raw", "fq", "codes"])
def test_int_linear_kernel_matches_plain(cuda, rows, k, n, mode):
    """K3 at the tail shapes (K = 48, N = 1000, the 96/288-wide Swin
    outputs, a ragged K and N) and a DeiT-S qkv site, every mode, bit for
    bit; the raw mode equals the forward's int_matmul(x, w) * mult + b."""
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

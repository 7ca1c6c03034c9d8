"""A ViT of more than 256 tokens on the CPU: attention past the 256 keys a
warp's packed scores hold, on both of ``IntModel``'s routes.

A tiny ViT of 290 tokens (68 px in patches of 4, width 64, two heads,
two blocks) with the quantization of ``benchmark/configs/
vit_large_384_p2vit_w4a8.json`` is baked by the benchmark's generator
(``benchmark/harness/models.py``) and served by ``IntModel`` per kernel
and resident: the logits equal the benchmark's plain reference
(``benchmark/harness/reference.py``, plain PyTorch) bit for bit, and its
control (one precision below) differs.  ``harness`` is imported with
``benchmark/`` on ``sys.path``, as ``benchmark/run.py`` puts it.  Also
held here: the one key limit and what it admits, K6's plan and the
forward's cut at ViT-L/16 at 384 px, and the ``attn_key_tiles`` counter
of ``dvt.encoder``.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``)."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import check, models, specs  # noqa: E402

from diffvit_tpu_torch import engine  # noqa: E402
from diffvit_tpu_torch.config import QuantConfig  # noqa: E402
from diffvit_tpu_torch.models import vit_int  # noqa: E402
from diffvit_tpu_torch.models.vit import ViTSpec  # noqa: E402
from diffvit_tpu_torch.ops.kernels import attn_plan, serve  # noqa: E402
from diffvit_tpu_torch.utils import tracing  # noqa: E402

VIT_L384 = json.loads((BENCH / "configs" / "vit_large_384_p2vit_w4a8.json")
                      .read_text())
# ViT-L@384's configuration at tiny widths and 290 tokens
LONG_VIT = dict(VIT_L384, name="long_vit", embed_dim=64, depth=2,
                num_heads=2, patch_size=4, img_size=68, num_classes=10)


def _model(config, seed, resident):
    spec = specs.from_config(config)
    rm, rp, _, _ = models.streams(seed)
    ip = models.int_model(spec, rm)
    model = engine.IntModel(ip, ViTSpec(**spec.program_fields()),
                            QuantConfig.from_dict(spec.quant.as_dict()),
                            "cpu", resident=resident)
    return spec, ip, model, rp


@pytest.mark.parametrize("seed", [0, 2**31 + 7])
@pytest.mark.parametrize("resident", [False, True],
                         ids=["kernels", "resident"])
def test_long_vit_equals_the_reference(resident, seed):
    """290 tokens: the per-kernel and the resident forwards give the plain
    reference's logits exactly; the reference's control does not."""
    torch.set_num_threads(2)
    spec, ip, model, rp = _model(LONG_VIT, seed, resident)
    assert spec.seq_len == 290 > attn_plan.QKV_MAX_KEYS
    codes = models.codes_pool(spec, ip, 3, rp)
    got = model(torch.from_numpy(codes)).float()
    want = check.reference_logits(spec, ip, codes, "cpu")
    assert torch.equal(got, want)
    ctrl = check.reference_logits(spec, ip, codes, "cpu", control=True)
    n = check.numbers(spec, ip, ctrl, want)
    assert n["gap_steps"] >= 1 and n["mismatch_pct"] >= 1


def test_the_key_limit_is_named_once():
    """One limit a softmax: 768 keys for the LIS, 256 for the float
    softmax; the plans admit up to it, refuse past it and say which."""
    assert attn_plan.max_keys(True) == attn_plan.LIS_MAX_KEYS == 768
    assert attn_plan.max_keys(False) == attn_plan.QKV_MAX_KEYS == 256
    shape = serve.EncoderShape(1024, 16, 4096, 577)
    for n in (257, 577, 768):
        attn_plan.attention_plan(1, 16, n, 64, n)
        serve.resident_plan(1, n, serve.EncoderShape(1024, 16, 4096, n))
    with pytest.raises(ValueError, match=r"768\) keys with the LIS"):
        attn_plan.attention_plan(1, 16, 769, 64, 769)
    with pytest.raises(ValueError,
                       match=r"256\) keys with the float softmax"):
        serve.resident_plan(1, 577, shape, lis=False)


@pytest.mark.parametrize("n_real,tiles", [(1, 1), (197, 1), (256, 1),
                                          (257, 3), (577, 3), (768, 3)])
def test_key_tiles(n_real, tiles):
    """The passes a row's scores make over its keys: 1 where the warp
    keeps them, 3 past 256 keys; a warp keeps 4,096 bytes of scores, or
    none past 256."""
    assert attn_plan.key_tiles(n_real) == tiles
    assert attn_plan.warp_bytes(n_real, True) == \
        (attn_plan.CODE_BYTES if tiles == 1 else 0)


@pytest.mark.parametrize("batch", [1, 16])
def test_resident_plan_at_vit_large_384(batch):
    """ViT-L/16 at 384 px: two blocks an SM (the rows pass 256), the
    attention step's shared memory the exponential table and the keys and
    values of 577 keys alone (no warp's scores), within the GEMM ring's;
    at 768 keys, the most the LIS takes, still two blocks an SM."""
    spec = specs.from_config(VIT_L384)
    pspec = ViTSpec(**spec.program_fields())
    plan = serve.resident_plan(batch, 577, pspec)
    assert plan.blocks == 2
    assert plan.attn_smem == serve.BARRIER_BYTES + attn_plan.EXP_BYTES \
        + attn_plan.kv_bytes(577, 64)
    assert plan.attn_smem <= plan.gemm_smem == plan.smem
    assert 2 * (plan.smem + serve.BLOCK_RESERVED) <= serve.SM_SMEM
    assert plan.attn_tiles * plan.attn_split >= -(-577 // 16)
    at_most = serve.attn_smem(attn_plan.LIS_MAX_KEYS, True)
    assert 2 * (at_most + serve.BLOCK_RESERVED) <= serve.SM_SMEM


def test_the_forward_cut_at_vit_large_384():
    """K6's cut keeps its byte cap: 5,317,632 scratch bytes an image at
    ViT-L@384's widths, 16 images a launch, a batch of 256 in 16."""
    spec = specs.from_config(VIT_L384)
    c, hid, n = spec.embed_dim, spec.hidden_dim, spec.seq_len
    assert n * (5 * c + hid) == 5_317_632
    assert vit_int.k6_launches(256, n, c, hid) == [16] * 16
    assert vit_int.k6_launches(17, n, c, hid) == [9, 8]


@pytest.mark.parametrize("config,tiles", [(LONG_VIT, 3),
                                          (dict(LONG_VIT, img_size=56), 1)],
                         ids=["290_keys", "197_keys"])
@pytest.mark.parametrize("resident", [False, True],
                         ids=["kernels", "resident"])
def test_encoder_span_counts_key_tiles(config, tiles, resident):
    """While a recording is on, each call's ``dvt.encoder`` span carries
    ``attn_key_tiles``: 3 past 256 keys, 1 at 197, on either route."""
    torch.set_num_threads(2)
    spec, ip, model, rp = _model(config, 1, resident)
    codes = torch.from_numpy(models.codes_pool(spec, ip, 2, rp))
    with tracing.recording() as rec:
        model(codes)
    enc, = rec.named("dvt.encoder")
    assert enc.counters["attn_key_tiles"] == tiles
    assert np.isfinite(model(codes).numpy()).all()

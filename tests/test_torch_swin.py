"""The port's Swin slice vs the JAX package, on the CPU.

The same seeded numpy inputs go through both.  JAX runs its forward with
the Pallas kernels in interpret mode (``forward_q_int(use_pallas=True,
pallas_interpret=True)``, as tests/test_swin.py runs it); the port runs the
plain versions of its kernels, which is what a CPU tensor gets.  Kernels
are held to exact equality where it holds (the float softmax to the JAX
suite's rule for that branch: within 1 code on fewer than 2% of codes),
the forward to the JAX suite's rule between two integer paths
(tests/test_pallas_attention.py::_assert_paths_agree: > 99.5% of logits
equal, atol 0.05, equal argmax).  Every branch of the forward is held: the
codes path, float LayerNorm (PTF off), the float32 stream (``sym_acts``
False), the float softmax (``lis=False``) through K4 and K4b,
``input_quant=False`` and a mixed {4, 8} bit config.  Where a random
model's logits differ from JAX's on some seeds, one test swaps the Pallas
kernels into the port's forward and shows that the kernels' inner
rounding is the only source."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffvit_tpu.config import QuantConfig
from diffvit_tpu.data import imagenet as jimagenet
from diffvit_tpu.data.imagenet import input_code_lut
from diffvit_tpu.engine import QuantizedViT
from diffvit_tpu.engine import load_int_model as jax_load_int_model
from diffvit_tpu.models import swin as jswin, swin_int as jswin_int
from diffvit_tpu.ops import int_layernorm as jax_iln
from diffvit_tpu.ops.pallas import attention as jax_attention
from diffvit_tpu.ops.pallas import mlp as jax_mlp
from diffvit_tpu.utils.serialize import save_pytree

from diffvit_tpu_torch import engine
from diffvit_tpu_torch.models import swin, swin_int
from diffvit_tpu_torch.models.convert import (swin_block_constants,
                                              swin_int_model_from_numpy)
from diffvit_tpu_torch.ops.int_layernorm import int_layernorm
from diffvit_tpu_torch.ops.kernels.attention import lis_sum_fits
from diffvit_tpu_torch.ops.kernels.swin_attention import (
    fused_swin_attention, fused_swin_attention_v2)
from diffvit_tpu_torch.testing import random_swin_int_model

from test_torch_calibrate import one_torch_thread  # noqa: F401

TINY_KW = dict(embed_dim=32, depths=(2, 1), num_heads=(2, 4), img_size=56,
               num_classes=10)
TINY_J = jswin.SwinSpec("swin_test2", **TINY_KW)
TINY = swin.SwinSpec("swin_test2", **TINY_KW)
CFG = QuantConfig()


def _t(a):
    return torch.tensor(np.asarray(a))


def _assert_paths_agree(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.mean(got == ref) > 0.995, np.mean(got == ref)
    np.testing.assert_allclose(got, ref, atol=0.05)
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


# ---- geometry -------------------------------------------------------------

def test_specs_and_bit_config_match_jax():
    for name, spec in swin.SWIN_SPECS.items():
        assert dataclasses.asdict(spec) == \
            dataclasses.asdict(jswin.SWIN_SPECS[name])
        assert swin.num_bit_slots(spec) == \
            jswin.num_bit_slots(jswin.SWIN_SPECS[name])
    n = swin.num_bit_slots(TINY)
    bc = [4, 8] * (n // 2) + [4] * (n % 2)
    for bit in (4, bc, None):
        assert swin.normalize_bit_config(TINY, bit) == \
            jswin.normalize_bit_config(TINY_J, bit)
    with pytest.raises(ValueError, match="entries"):
        swin.normalize_bit_config(TINY, bc[1:])


@pytest.mark.parametrize("spec_j", [TINY_J, jswin.SWIN_SPECS["swin_tiny"]],
                         ids=["tiny", "swin_tiny"])
def test_block_geometry_matches_jax(spec_j):
    spec = swin.SwinSpec(**dataclasses.asdict(spec_j))
    for s in range(spec.num_layers):
        assert spec.stage_resolution(s) == spec_j.stage_resolution(s)
        for b in range(spec.depths[s]):
            got = swin.block_geometry(spec, s, b)
            want = jswin.block_geometry(spec_j, s, b)
            assert got[:3] == want[:3]
            assert (got[3] is None) == (want[3] is None)
            if got[3] is not None:
                np.testing.assert_array_equal(got[3], want[3])


def test_relative_index_and_mask_match_jax():
    for ws in (2, 7):
        np.testing.assert_array_equal(swin.relative_position_index(ws),
                                      jswin.relative_position_index(ws))
    for res, ws, shift in (((14, 14), 7, 3), ((56, 56), 7, 3),
                           ((8, 8), 4, 2), ((14, 14), 7, 0)):
        got = swin.shift_attn_mask(res, ws, shift)
        want = jswin.shift_attn_mask(res, ws, shift)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shift", [0, 3])
def test_window_shuffles_match_jax(shift):
    rng = np.random.default_rng(5)
    x = rng.integers(-128, 128, (2, 14 * 14, 8)).astype(np.int8)
    got = swin._windows(_t(x), (14, 14), 7, shift)
    want = np.asarray(jswin._windows(jnp.asarray(x), (14, 14), 7, shift))
    np.testing.assert_array_equal(got.numpy(), want)
    back = swin._unwindows(got, (14, 14), 7, shift, 2)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jswin._unwindows(jnp.asarray(want),
                                                  (14, 14), 7, shift, 2)))
    np.testing.assert_array_equal(back.numpy(), x)
    img = x.reshape(2, 14, 14, 8)
    np.testing.assert_array_equal(
        swin.window_partition(_t(img), 7).numpy(),
        np.asarray(jswin.window_partition(jnp.asarray(img), 7)))


def test_patchify_and_merge_match_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 56, 56)).astype(np.float32)
    np.testing.assert_array_equal(
        swin.swin_patchify(_t(x), TINY).numpy(),
        np.asarray(jswin.swin_patchify(jnp.asarray(x), TINY_J)))
    h = rng.integers(-128, 128, (2, 14 * 14, 8)).astype(np.int8)
    np.testing.assert_array_equal(
        swin._merge_patches(_t(h), (14, 14)).numpy(),
        np.asarray(jswin._merge_patches(jnp.asarray(h), (14, 14))))


# ---- the LIS bound ----------------------------------------------------------

def test_lis_sum_bound_follows_the_key_count():
    assert lis_sum_fits(2.0**-11, 49) and not lis_sum_fits(2.0**-12, 49)
    assert lis_sum_fits(2.0**-10, 197) and not lis_sum_fits(2.0**-11, 197)
    ip = random_swin_int_model(TINY, seed=0)
    p = "layers.0.blocks.1"
    ib = ip["layers"][0]["blocks"][1]
    # below the int64 bound the block takes the 128-bit row sum; only a
    # scale below the reference's own bound, 2^-17, is refused
    for s_a2, wide in ((2.0**-11, False), (2.0**-12, True),
                       (2.0**-17, True)):
        qp = dict(ip["qp"], **{f"{p}.attn.qact2.scale": np.float32(s_a2)})
        assert swin_block_constants(ib, qp, p, TINY, 0, 1,
                                    CFG)["lis_wide"] == wide
    qp = dict(ip["qp"], **{f"{p}.attn.qact2.scale": np.float32(2.0**-18)})
    with pytest.raises(ValueError, match=r"below 2\^-17"):
        swin_block_constants(ib, qp, p, TINY, 0, 1, CFG)


# ---- K4 / K4b ---------------------------------------------------------------

@pytest.fixture(scope="module")
def shifted_block():
    """Block 1 of stage 0 (shifted: 4 windows an image, 2 heads of 16) of
    the random TINY model, and qkv codes for 2 images."""
    ip = random_swin_int_model(TINY, seed=2)
    k = swin_block_constants(ip["layers"][0]["blocks"][1], ip["qp"],
                             "layers.0.blocks.1", TINY, 0, 1, CFG)
    rng = np.random.default_rng(8)
    qkv = np.clip(np.round(rng.standard_normal((8, 49, 96)) * 30), -128,
                  127).astype(np.int8)
    return k, qkv


@pytest.mark.parametrize("contract", ["v1", "v2"])
def test_swin_attention_plain_matches_pallas(shifted_block, contract):
    """The plain version, through each wrapper, vs the interpret-mode Pallas
    kernel of the same contract.  JAX pads the 49 window rows to 56."""
    k, qkv = shifted_block
    npad, pad = 56, ((0, 0), (0, 7), (0, 7))
    bias_p = np.pad(k["bias_q"], pad)
    mask_p = np.pad(k["mask_div"], pad)
    qkv_p = np.pad(qkv, ((0, 0), (0, 7), (0, 0)))
    jkw = dict(num_heads=2, n_real=49, n_windows=4, bits=4, lis=True,
               interpret=True)
    tkw = dict(num_heads=2, n_real=49, n_windows=4)
    args = (_t(k["bias_q"]), _t(k["mask_div"]), _t(k["attn_scalars"]))
    if contract == "v1":
        to5 = lambda a: a.reshape(8, -1, 3, 2, 16).transpose(0, 2, 3, 1, 4)  # noqa: E731
        want = np.asarray(jax_attention.fused_swin_attention(
            jnp.asarray(to5(qkv_p)), jnp.asarray(bias_p), jnp.asarray(mask_p),
            jnp.asarray(k["attn_scalars"]), **jkw))[:, :, :49]
        got = fused_swin_attention(_t(to5(qkv)), *args, **tkw)
    else:
        want = np.asarray(jax_attention.fused_swin_attention_v2(
            jnp.asarray(qkv_p), jnp.asarray(bias_p), jnp.asarray(mask_p),
            jnp.asarray(k["attn_scalars"]), head_dim=16, **jkw))[:, :49]
        got = fused_swin_attention_v2(_t(qkv), *args, head_dim=16, **tkw)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 32  # the codes spread over the grid


def test_swin_attention_wrappers_refuse(shifted_block):
    k, qkv = shifted_block
    args = (_t(k["bias_q"]), _t(k["mask_div"]), _t(k["attn_scalars"]))
    kw = dict(num_heads=2, head_dim=16, n_real=49, n_windows=4)
    with pytest.raises(NotImplementedError, match="bits"):
        fused_swin_attention_v2(_t(qkv), *args, bits=8, **kw)
    # the float softmax takes any bits
    assert torch.equal(
        fused_swin_attention_v2(_t(qkv), *args, bits=8, lis=False, **kw),
        fused_swin_attention_v2(_t(qkv), *args, bits=4, lis=False, **kw))
    meta = [a.to("meta") for a in (_t(qkv), *args)]
    with pytest.raises(ValueError, match="meta"):
        fused_swin_attention_v2(*meta, **kw)


def _assert_softmax_codes_close(got, want):
    """The float softmax's rule (tests/test_pallas_attention.py): within 1
    code on fewer than 2% of codes.  Returns the share that differs."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1 and np.mean(diff > 0) < 0.02, \
        (diff.max(), np.mean(diff > 0))
    return float(np.mean(diff > 0))


@pytest.mark.parametrize("blk", [1, 0], ids=["shifted", "unshifted"])
@pytest.mark.parametrize("contract", ["v1", "v2"])
def test_swin_attention_float_softmax_plain_matches_pallas(shifted_block,
                                                           contract, blk):
    """``lis=False``: the plain version (float64 softmax, bfloat16 weights,
    weights below 2^-32 dropped) vs the interpret-mode Pallas kernel
    (float32 softmax and attn@v), on the shifted block (its mask puts
    weights near e^-100 into the rows) and the unshifted one."""
    ip = random_swin_int_model(TINY, seed=2)
    k = swin_block_constants(ip["layers"][0]["blocks"][blk], ip["qp"],
                             f"layers.0.blocks.{blk}", TINY, 0, blk,
                             QuantConfig(lis=False))
    assert (k["mask_div"] is not None) == (blk == 1)
    qkv = shifted_block[1]
    pad = ((0, 0), (0, 7), (0, 7))
    mask_j = None if blk == 0 else jnp.asarray(np.pad(k["mask_div"], pad))
    mask_t = None if blk == 0 else _t(k["mask_div"])
    qkv_p = np.pad(qkv, ((0, 0), (0, 7), (0, 0)))
    jkw = dict(num_heads=2, n_real=49, n_windows=4 if blk else 1, bits=8,
               lis=False, interpret=True)
    tkw = dict(num_heads=2, n_real=49, n_windows=4 if blk else 1, bits=8,
               lis=False)
    jargs = (jnp.asarray(np.pad(k["bias_q"], pad)), mask_j,
             jnp.asarray(k["attn_scalars"]))
    targs = (_t(k["bias_q"]), mask_t, _t(k["attn_scalars"]))
    if contract == "v1":
        to5 = lambda a: a.reshape(8, -1, 3, 2, 16).transpose(0, 2, 3, 1, 4)  # noqa: E731
        want = np.asarray(jax_attention.fused_swin_attention(
            jnp.asarray(to5(qkv_p)), *jargs, **jkw))[:, :, :49]
        got = fused_swin_attention(_t(to5(qkv)), *targs, **tkw)
    else:
        want = np.asarray(jax_attention.fused_swin_attention_v2(
            jnp.asarray(qkv_p), *jargs, head_dim=16, **jkw))[:, :49]
        got = fused_swin_attention_v2(_t(qkv), *targs, head_dim=16, **tkw)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    _assert_softmax_codes_close(got.numpy(), want)
    assert len(np.unique(want)) > 32  # the codes spread over the grid


def test_float_softmax_sum_does_not_depend_on_the_order(shifted_block):
    """Wide grids (s_a1 = s_a2 = 0.5: logits over +-64, the shift mask's
    -100 on top) fill the rows with weights between 2^-32 and the bfloat16
    subnormals.  Below WEIGHT_FLOOR they are dropped, so the float64 attn@v
    is exact: summing the keys in reverse gives the same codes.  The
    interpret-mode Pallas kernel, which keeps them, agrees by the float
    softmax's rule."""
    from diffvit_tpu_torch.ops.kernels import swin_attention as sa
    k, qkv = shifted_block
    scalars = k["attn_scalars"].copy()
    scalars[1:4] = (0.5, 2.0, 0.5)
    mask_div = k["mask_div"] * np.float32(scalars[3] / k["attn_scalars"][3]) \
        / np.float32(scalars[3] / k["attn_scalars"][3]) ** 2
    np.testing.assert_array_equal(np.unique(mask_div), [-200.0, 0.0])
    view = _t(qkv).view(8, 49, 3, 2, 16).permute(0, 2, 3, 1, 4)
    args = (_t(k["bias_q"]), _t(mask_div), _t(scalars))
    kw = dict(n_real=49, n_windows=4, lis=False)
    seen = {}
    orig = sa._softmax_weights_plain

    def spy(a_int, s_a, col_ok):
        w = orig(a_int, s_a, col_ok)
        seen["tiny"] = int(((w > 0) & (w < sa.WEIGHT_FLOOR)).sum())
        seen["subnormal"] = int(((w > 0) & (w < 2.0**-126)).sum())
        return w
    sa._softmax_weights_plain = spy
    try:
        want = sa.swin_attention_plain(view[:, 0], view[:, 1], view[:, 2],
                                       *args, **kw)
    finally:
        sa._softmax_weights_plain = orig
    assert seen["tiny"] > 1000 and seen["subnormal"] > 0, seen
    flip = torch.arange(48, -1, -1)
    back = sa.swin_attention_plain(
        view[:, 0], view[:, 1][:, :, flip], view[:, 2][:, :, flip],
        args[0][:, :, flip], args[1][:, :, flip], args[2], **kw)
    np.testing.assert_array_equal(back.numpy(), want.numpy())
    assert len(np.unique(want.numpy())) > 32
    pad = ((0, 0), (0, 7), (0, 7))
    qkv_p = np.pad(qkv, ((0, 0), (0, 7), (0, 0))) \
        .reshape(8, -1, 3, 2, 16).transpose(0, 2, 3, 1, 4)
    jax_out = np.asarray(jax_attention.fused_swin_attention(
        jnp.asarray(qkv_p), jnp.asarray(np.pad(k["bias_q"], pad)),
        jnp.asarray(np.pad(mask_div, pad)), jnp.asarray(scalars),
        num_heads=2, n_real=49, n_windows=4, bits=8, lis=False,
        interpret=True))[:, :, :49]
    _assert_softmax_codes_close(want.numpy(), jax_out)


# ---- integer LayerNorm --------------------------------------------------------

@pytest.mark.parametrize("expand", [1, 4])
def test_int_layernorm_matches_jax(expand):
    """Swin's patch norm (float32 out) on fake-quantized input over a
    per-channel grid, and the reference's in_scale_expand (the 4-way
    merge's tiled grid) and out_scale_channel, folded by the caller."""
    rng = np.random.default_rng(9)
    c0 = 96
    c = c0 * expand
    in_scale = (0.0137 * 2.0 ** rng.integers(0, 3, c0)).astype(np.float32)
    grid = np.tile(in_scale, expand)
    x = (np.clip(np.round(rng.standard_normal((4, 49, c)) * 40), -128, 127)
         * grid).astype(np.float32)
    w = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    out_scale, ch = np.float32(0.0213), (2.0 ** rng.integers(-1, 2, c)) \
        .astype(np.float32)
    want = np.asarray(jax_iln.int_layernorm(
        jnp.asarray(x), w, b, jnp.asarray(in_scale), out_scale,
        out_scale_channel=jnp.asarray(ch), in_scale_expand=expand))
    got = int_layernorm(_t(x), _t(w), _t(b), _t(grid),
                        _t(out_scale) * _t(ch)).numpy()
    np.testing.assert_array_equal(got, want)


# ---- the forward ---------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 56, 56)).astype(np.float32)
    pixels = rng.integers(0, 256, (2, 3, 56, 56), dtype=np.uint8)
    return x, pixels


@pytest.fixture(scope="module")
def calibrated(inputs):
    params = jswin.init_swin_params(TINY_J, jax.random.PRNGKey(3))
    qp, _ = jswin.calibrate(params, TINY_J, CFG, jnp.asarray(inputs[0]))
    return params, qp


@pytest.fixture(scope="module")
def models(calibrated):
    params, qp = calibrated
    return {"calibrated": jax.device_get(jswin_int.prepare_int(
                params, qp, TINY_J, CFG, bit=4)),
            "random": random_swin_int_model(TINY, CFG, seed=1)}


def _codes(ip, pixels):
    qp = ip["qp"]
    lut = input_code_lut(np.asarray(qp["qact_input.scale"]),
                         np.asarray(qp["qact_input.zp"]))
    return np.stack([lut[c][pixels[:, c]] for c in range(3)], 1)


@pytest.fixture(scope="module")
def jax_logits(models, inputs):
    """JAX's interpret-mode logits, once per (model, wire)."""
    cache = {}

    def get(model, wire):
        if (model, wire) not in cache:
            ip = models[model]
            x = _codes(ip, inputs[1]) if wire == "codes" else inputs[0]
            cache[model, wire] = x, np.asarray(jswin_int.forward_q_int(
                ip, TINY_J, CFG, jnp.asarray(x), use_pallas=True,
                pallas_interpret=True))
        return cache[model, wire]
    return get


@pytest.mark.parametrize("attn_v2", [False, True], ids=["K4", "K4b"])
@pytest.mark.parametrize("wire", ["codes", "f32"])
@pytest.mark.parametrize("model", ["calibrated", "random"])
def test_forward_matches_jax(models, jax_logits, model, wire, attn_v2):
    """On these inputs every logit agrees exactly (measured: 100%)."""
    x, want = jax_logits(model, wire)
    ip = swin_int_model_from_numpy(models[model], TINY, "cpu", CFG)
    got = swin_int.forward_q_int(ip, TINY, CFG, _t(x), attn_v2=attn_v2)
    got = got.numpy()
    assert got.shape == (2, 10) and np.isfinite(got).all()
    assert not np.array_equal(got[0], got[1])
    _assert_paths_agree(got, want)


def _to_jnp(a):
    return None if a is None else jnp.asarray(a.numpy())


@pytest.mark.parametrize("seed", [6, 9])
def test_random_forward_differs_from_jax_only_inside_the_kernels(seed):
    """A random model's wide grids (softmax scale 2^-4) put some LIS rows on
    an exact tie of rint(exp_sum / exp_int); XLA's CPU ``exp2`` is an ulp
    off at 13 of the 33 integer exponents and breaks the tie the other way,
    and its fused multiply-add moves a K2 code by 1.  So on some seeds a few
    logits differ by one act_out step (seed 6: 2 of 20, through K4; seed 9:
    K2 differs, no logit does), which 20 logits cannot absorb.  This test
    tells that noise from a fault of the port: with the interpret-mode
    Pallas K4 and K2 swapped into the port's forward, every logit equals
    JAX's bit for bit, so everything around the kernels is exact; and on the
    model's own operands each plain version stays within its kernel's rule
    (measured: K4 differs on 12 of 12,544 codes of one block, K2 by 1 on
    2 of 6,272)."""
    x = np.random.default_rng(0).standard_normal((8, 3, 56, 56)) \
        .astype(np.float32)[6:]
    ip_np = random_swin_int_model(TINY, CFG, seed=seed)
    want = np.asarray(jswin_int.forward_q_int(
        ip_np, TINY_J, CFG, jnp.asarray(x), use_pallas=True,
        pallas_interpret=True))
    ip = swin_int_model_from_numpy(ip_np, TINY, "cpu", CFG)
    plain = swin_int.forward_q_int(ip, TINY, CFG, _t(x)).numpy()
    plain_k4, plain_k2 = swin_int.fused_swin_attention, swin_int.fused_int_mlp
    equal = {"k4": [], "k2": []}

    def pallas_k4(qkv, bias_q, mask_div, scalars, *, lis_wide, **kw):
        n, npad = qkv.shape[3], -(-qkv.shape[3] // 8) * 8
        square = ((0, 0), (0, npad - n), (0, npad - n))
        y = jax_attention.fused_swin_attention(
            jnp.pad(_to_jnp(qkv.contiguous()),
                    ((0, 0),) * 3 + ((0, npad - n), (0, 0))),
            jnp.pad(_to_jnp(bias_q), square),
            None if mask_div is None else jnp.pad(_to_jnp(mask_div), square),
            _to_jnp(scalars), interpret=True, **kw)
        y = _t(y[:, :, :n])
        ref = plain_k4(qkv, bias_q, mask_div, scalars, lis_wide=lis_wide,
                       **kw)
        equal["k4"].append(float((y == ref).float().mean()))
        return y

    def pallas_k2(x_i8, *args, emit_codes):
        rows = x_i8.shape[0]
        y = jax_mlp.fused_int_mlp(
            jnp.pad(_to_jnp(x_i8), ((0, -rows % 512), (0, 0))),
            *map(_to_jnp, args), block_rows=512, emit_codes=emit_codes,
            interpret=True)
        y = _t(y[:rows])
        ref = plain_k2(x_i8, *args, emit_codes=emit_codes)
        assert int((y.int() - ref.int()).abs().max()) <= 1
        equal["k2"].append(float((y == ref).float().mean()))
        return y

    swin_int.fused_swin_attention, swin_int.fused_int_mlp = \
        pallas_k4, pallas_k2
    try:
        swapped = swin_int.forward_q_int(ip, TINY, CFG, _t(x)).numpy()
    finally:
        swin_int.fused_swin_attention, swin_int.fused_int_mlp = \
            plain_k4, plain_k2
    np.testing.assert_array_equal(swapped, want)
    assert len(equal["k4"]) == len(equal["k2"]) == sum(TINY.depths)
    assert min(equal["k4"] + equal["k2"]) >= 0.999, equal
    # the plain forward: within one act_out step on a few logits
    assert np.mean(plain == want) >= 0.9
    np.testing.assert_allclose(plain, want, atol=0.0625)
    np.testing.assert_array_equal(plain.argmax(1), want.argmax(1))


def test_calibrated_window_scale_needs_the_key_bound(models):
    """The calibrated TINY's stage-0 softmax scale is below the 2^-10 that
    a ViT's 197 keys need, and within what a 49-key window admits."""
    s = float(np.asarray(
        models["calibrated"]["qp"]["layers.0.blocks.0.attn.qact2.scale"]))
    assert s < 2.0**-10 and lis_sum_fits(s, 49)


# ---- artifacts -----------------------------------------------------------------

def test_jax_artifact_served_by_port(calibrated, inputs, tmp_path):
    params, qp = calibrated
    m = QuantizedViT(TINY_J, CFG, params=params)
    m.qparams = qp
    path = str(tmp_path / "swin.npz")
    m.save_int_model(path)
    served = engine.load_int_model(path, "cpu")
    assert served.is_swin and served.spec == TINY and served.cfg == CFG
    jax_served = jax_load_int_model(path)
    np.testing.assert_array_equal(served.input_lut, jax_served.input_lut)
    pixels = inputs[1]
    got = served(pixels).numpy()
    np.testing.assert_array_equal(served(served.encode(pixels)).numpy(), got)
    _assert_paths_agree(got, np.asarray(jax_served(pixels)))


def test_port_artifact_served_by_jax(inputs, tmp_path):
    path = str(tmp_path / "random_swin.npz")
    engine.save_int_model(path, random_swin_int_model(TINY, seed=4), TINY,
                          CFG)
    got = engine.load_int_model(path, "cpu")(inputs[1]).numpy()
    jax_served = jax_load_int_model(path)
    assert jax_served.is_swin and jax_served.spec == TINY_J
    _assert_paths_agree(got, np.asarray(jax_served(inputs[1])))


# ---- the other branches of the forward -----------------------------------------

TINY_NIQ_J = jswin.SwinSpec("swin_test2", input_quant=False, **TINY_KW)
TINY_NIQ = swin.SwinSpec("swin_test2", input_quant=False, **TINY_KW)
PTF_OFF, LIS_OFF = QuantConfig(ptf=False), QuantConfig(lis=False)
N_SLOTS = swin.num_bit_slots(TINY)
MIXED = tuple([8, 4] * (N_SLOTS // 2) + [8] * (N_SLOTS % 2))
# branch -> (JAX spec, the port's spec, QuantConfig, bit config)
BRANCHES = {
    "float_ln": (TINY_J, TINY, PTF_OFF, 4),
    "asymmetric": (TINY_J, TINY, CFG, 4),
    "float_softmax": (TINY_J, TINY, LIS_OFF, 4),
    "no_input_quant": (TINY_NIQ_J, TINY_NIQ, CFG, 4),
    "mixed_bits": (TINY_J, TINY, CFG, MIXED),
}


def _asymmetric(ip, nonzero_zp):
    """The float32 stream: ``sym_acts`` False, as ``prepare_int`` sets it
    for a nonzero zero-point; ``nonzero_zp`` also moves the zero-points of
    the residual fences and the attention's output fence off 0."""
    qp = dict(ip["qp"])
    if nonzero_zp:
        for k in list(qp):
            residual = k.endswith((".qact2.zp", ".qact4.zp")) \
                and ".attn." not in k and ".mlp." not in k
            if residual or k in ("patch.qact.zp",) \
                    or k.endswith(".attn.qact4.zp"):
                qp[k] = np.asarray(qp[k], np.float32) + np.float32(3.0)
    return dict(ip, qp=qp, sym_acts=False)


@pytest.fixture(scope="module")
def branch_models(inputs, calibrated):
    """(branch, "calibrated" | "random") -> the numpy int-model.  JAX
    calibrates once per QuantConfig that changes the qparams' layout (PTF
    off: layer-wise LN grids; ``input_quant=False``: no qact_input); the
    float softmax, the float32 stream and the mixed bit config bake the
    default calibration, which holds every weight grid."""
    cache = {}

    def get(branch, model):
        if (branch, model) in cache:
            return cache[branch, model]
        spec_j, spec, cfg, bit = BRANCHES[branch]
        if model == "random":
            ip = random_swin_int_model(spec, cfg, seed=6, bit_config=bit
                                       if branch == "mixed_bits" else None)
        else:
            params, qp = calibrated
            if branch in ("float_ln", "no_input_quant"):
                qp, _ = jswin.calibrate(params, spec_j, cfg,
                                        jnp.asarray(inputs[0]))
            ip = jax.device_get(jswin_int.prepare_int(params, qp, spec_j,
                                                      cfg, bit=bit))
        if branch == "asymmetric":
            ip = _asymmetric(ip, nonzero_zp=model == "random")
        cache[branch, model] = ip
        return ip
    return get


@pytest.fixture(scope="module")
def branch_jax_logits(branch_models, inputs):
    """JAX's interpret-mode logits, once per (branch, model, wire).  JAX's
    K4b is bit-identical to its K4, so the port's K4b is held to K4's."""
    cache = {}

    def get(branch, model, wire):
        if (branch, model, wire) not in cache:
            ip = branch_models(branch, model)
            spec_j, _, cfg, _ = BRANCHES[branch]
            x = _codes(ip, inputs[1]) if wire == "codes" else inputs[0]
            cache[branch, model, wire] = x, np.asarray(
                jswin_int.forward_q_int(ip, spec_j, cfg, jnp.asarray(x),
                                        use_pallas=True,
                                        pallas_interpret=True))
        return cache[branch, model, wire]
    return get


BRANCH_CASES = [
    ("float_ln", "calibrated", "f32", False),
    ("float_ln", "calibrated", "codes", False),
    ("float_ln", "random", "f32", False),
    ("asymmetric", "calibrated", "f32", False),
    ("asymmetric", "calibrated", "codes", False),
    ("asymmetric", "random", "f32", True),
    ("float_softmax", "calibrated", "f32", False),
    ("float_softmax", "calibrated", "codes", False),
    ("float_softmax", "random", "f32", False),
    ("float_softmax", "random", "codes", False),
    ("float_softmax", "calibrated", "f32", True),
    ("float_softmax", "calibrated", "codes", True),
    ("float_softmax", "random", "f32", True),
    ("float_softmax", "random", "codes", True),
    ("no_input_quant", "calibrated", "f32", False),
    ("no_input_quant", "random", "f32", False),
    ("mixed_bits", "calibrated", "f32", False),
    ("mixed_bits", "calibrated", "codes", False),
    ("mixed_bits", "random", "f32", True),
]


@pytest.mark.parametrize(
    "branch,model,wire,attn_v2", BRANCH_CASES,
    ids=[f"{b}-{m}-{w}-{'K4b' if v else 'K4'}"
         for b, m, w, v in BRANCH_CASES])
def test_forward_branch_matches_jax(branch_models, branch_jax_logits, branch,
                                    model, wire, attn_v2):
    x, want = branch_jax_logits(branch, model, wire)
    _, spec, cfg, _ = BRANCHES[branch]
    ip_np = branch_models(branch, model)
    ip = swin_int_model_from_numpy(ip_np, spec, "cpu", cfg)
    got = swin_int.forward_q_int(ip, spec, cfg, _t(x), attn_v2=attn_v2)
    got = got.numpy()
    assert got.shape == (2, 10) and np.isfinite(got).all()
    assert not np.array_equal(got[0], got[1])
    _assert_paths_agree(got, want)
    if branch == "mixed_bits":
        assert set(ip_np["bit_config"]) == {4, 8}
        assert ip_np["patch"]["bit"] == 8 \
            and ip_np["layers"][0]["blocks"][0]["qkv"]["bit"] == 4


def test_branch_models_take_their_branches(branch_models):
    """The models above do reach the branches they are named for."""
    assert not branch_models("asymmetric", "random")["sym_acts"]
    zps = branch_models("asymmetric", "random")["qp"]
    assert float(zps["layers.0.blocks.0.qact2.zp"].max()) == 3.0
    assert "qact_input.scale" not in \
        branch_models("no_input_quant", "calibrated")["qp"]
    # PTF off: layer-wise (scalar) LN grids
    assert np.ndim(branch_models("float_ln", "calibrated")["qp"][
        "layers.0.blocks.0.qact2.scale"]) == 0
    # a lis=False model's softmax scale needs no LIS bound; the LIS takes
    # 2^-14 with the 128-bit row sum and refuses 2^-18
    ip = random_swin_int_model(TINY, LIS_OFF, seed=0)
    p = "layers.0.blocks.1"
    ib = ip["layers"][0]["blocks"][1]
    for s_a2 in (2.0**-14, 2.0**-18):
        qp = dict(ip["qp"], **{f"{p}.attn.qact2.scale": np.float32(s_a2)})
        assert not swin_block_constants(ib, qp, p, TINY, 0, 1,
                                        LIS_OFF)["lis_wide"]
    assert swin_block_constants(ib, dict(qp, **{
        f"{p}.attn.qact2.scale": np.float32(2.0**-14)}), p, TINY, 0, 1,
        CFG)["lis_wide"]
    with pytest.raises(ValueError, match=r"below 2\^-17"):
        swin_block_constants(ib, qp, p, TINY, 0, 1, CFG)


def test_no_input_quant_refuses_codes(branch_models):
    ip = swin_int_model_from_numpy(
        branch_models("no_input_quant", "random"), TINY_NIQ, "cpu", CFG)
    codes = torch.zeros((1, 3, 56, 56), dtype=torch.int8)
    with pytest.raises(ValueError, match="input_quant"):
        swin_int.forward_q_int(ip, TINY_NIQ, CFG, codes)
    with pytest.raises(ValueError, match="input_quant"):
        jswin_int.forward_q_int(
            branch_models("no_input_quant", "random"), TINY_NIQ_J, CFG,
            jnp.zeros((1, 3, 56, 56), jnp.int8))


def test_random_model_rejects_float_slots():
    bc = list(MIXED)
    bc[3] = -1
    with pytest.raises(ValueError, match="4, 8"):
        random_swin_int_model(TINY, CFG, bit_config=bc)


@pytest.mark.parametrize("branch", ["float_softmax", "float_ln",
                                    "no_input_quant"])
def test_jax_branch_artifact_served_by_port(calibrated, branch_models,
                                            inputs, branch, tmp_path):
    """A JAX ``save_int_model`` artifact of a configuration beside the codes
    path, loaded and served by the port's engine on uint8 pixels, against
    the JAX engine on the same artifact.  With ``input_quant=False`` there
    is no codes wire: uint8 pixels are normalized on the device and equal
    the float32 wire bit for bit."""
    spec_j, spec, cfg, _ = BRANCHES[branch]
    path = str(tmp_path / f"{branch}.npz")
    save_pytree(path, branch_models(branch, "calibrated"),
                meta={"model": spec_j.name,
                      "spec": dataclasses.asdict(spec_j),
                      "cfg": cfg.to_dict(), "is_swin": True})
    served = engine.load_int_model(path, "cpu")
    assert served.is_swin and served.spec == spec and served.cfg == cfg
    jax_served = jax_load_int_model(path)
    pixels = inputs[1]
    got = served(pixels).numpy()
    # the JAX engine takes its XLA path on the CPU, whose float softmax
    # keeps float32 weights; the port stands for the kernel path
    want = jswin_int.forward_q_int(
        jax_served.ip, jax_served.spec, jax_served.cfg,
        jimagenet.device_normalize(jnp.asarray(pixels)), use_pallas=True,
        pallas_interpret=True)
    _assert_paths_agree(got, np.asarray(want))
    if branch != "float_softmax":
        _assert_paths_agree(got, np.asarray(jax_served(pixels)))
    if branch == "no_input_quant":
        assert served.input_lut is None
        normalized = np.array(jimagenet.device_normalize(
            jnp.asarray(pixels)))
        np.testing.assert_array_equal(served(normalized).numpy(), got)
        np.testing.assert_array_equal(
            served(torch.tensor(pixels)).numpy(), got)
        for bad in (served.encode, lambda x: served(x.astype(np.int8))):
            with pytest.raises(ValueError, match="input_quant"):
                bad(pixels)
    else:
        np.testing.assert_array_equal(served.input_lut, jax_served.input_lut)
        np.testing.assert_array_equal(
            served(served.encode(pixels)).numpy(), got)

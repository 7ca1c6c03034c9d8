"""The port's Swin slice vs the JAX package, on the CPU.

The same seeded numpy inputs go through both.  JAX runs its codes path
with the Pallas kernels in interpret mode (``forward_q_int(use_pallas=True,
pallas_interpret=True)``, as tests/test_swin.py runs it); the port runs the
plain versions of its kernels, which is what a CPU tensor gets.  Kernels
are held to exact equality where it holds, the forward to the JAX suite's
rule between two integer paths (tests/test_pallas_attention.py::
_assert_paths_agree: > 99.5% of logits equal, atol 0.05, equal argmax)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffvit_tpu.config import QuantConfig
from diffvit_tpu.data.imagenet import input_code_lut
from diffvit_tpu.engine import QuantizedViT
from diffvit_tpu.engine import load_int_model as jax_load_int_model
from diffvit_tpu.models import swin as jswin, swin_int as jswin_int
from diffvit_tpu.ops import int_layernorm as jax_iln
from diffvit_tpu.ops.pallas import attention as jax_attention

from diffvit_tpu_torch import engine
from diffvit_tpu_torch.models import swin, swin_int
from diffvit_tpu_torch.models.convert import (swin_block_constants,
                                              swin_int_model_from_numpy)
from diffvit_tpu_torch.ops.int_layernorm import int_layernorm
from diffvit_tpu_torch.ops.kernels.attention import lis_sum_fits
from diffvit_tpu_torch.ops.kernels.swin_attention import (
    fused_swin_attention, fused_swin_attention_v2)
from diffvit_tpu_torch.testing import random_swin_int_model

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
    for s_a2, ok in ((2.0**-11, True), (2.0**-12, False)):
        qp = dict(ip["qp"], **{f"{p}.attn.qact2.scale": np.float32(s_a2)})
        if ok:
            swin_block_constants(ib, qp, p, TINY, 0, 1, CFG)
        else:
            with pytest.raises(ValueError, match="overflow"):
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
    with pytest.raises(NotImplementedError, match="lis=False"):
        fused_swin_attention_v2(_t(qkv), *args, lis=False, **kw)
    with pytest.raises(NotImplementedError, match="bits"):
        fused_swin_attention_v2(_t(qkv), *args, bits=8, **kw)
    meta = [a.to("meta") for a in (_t(qkv), *args)]
    with pytest.raises(ValueError, match="meta"):
        fused_swin_attention_v2(*meta, **kw)


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


def test_other_branches_raise():
    ip = swin_int_model_from_numpy(random_swin_int_model(TINY, seed=0),
                                   TINY, "cpu")
    x = torch.zeros((1, 3, 56, 56))
    for cfg, what in ((QuantConfig(ptf=False), "int_norm"),
                      (QuantConfig(lis=False), "lis=False")):
        with pytest.raises(NotImplementedError, match=what):
            swin_int.forward_q_int(ip, TINY, cfg, x)
    with pytest.raises(NotImplementedError, match="sym_acts"):
        swin_int.forward_q_int(dict(ip, sym_acts=False), TINY, CFG, x)
    with pytest.raises(NotImplementedError, match="input_quant"):
        swin_int.forward_q_int(
            ip, dataclasses.replace(TINY, input_quant=False), CFG, x)

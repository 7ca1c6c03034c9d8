"""The port's attention core (K5) and every other branch of the integer ViT
forward vs the JAX package, on the CPU.

K5's plain version is held against the interpret-mode Pallas
``fused_int_attention``.  The forwards are held against JAX
``forward_q_int(use_pallas=True, pallas_interpret=True)`` on the TINY spec
of tests/test_int_path.py, calibrated by JAX once per QuantConfig (and
on seeded random int-models), under SmoothQuant off (FQ-ViT), the legacy
config, mixed and -1 bit configs, float LayerNorm, asymmetric activations
and ``input_quant=False``.  The rule between the two forwards is the JAX
suite's own between two integer paths
(tests/test_pallas_attention.py::_assert_paths_agree): more than 99.5% of
logits exactly equal, atol 0.05, equal argmax."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffvit_tpu.config import QuantConfig as JaxQuantConfig
from diffvit_tpu.data.imagenet import input_code_lut
from diffvit_tpu.models import vit, vit_int as jax_vit_int
from diffvit_tpu.ops.bit_types import BIT_TYPE_DICT as JAX_BITS
from diffvit_tpu.ops.pallas.attention import \
    fused_int_attention as jax_int_attention

from diffvit_tpu_torch import QuantConfig
from diffvit_tpu_torch.models import vit_int
from diffvit_tpu_torch.models.convert import (int_attn_scalars,
                                              int_model_from_numpy)
from diffvit_tpu_torch.models.vit import VIT_SPECS, ViTSpec
from diffvit_tpu_torch.ops.kernels.attention import fused_int_attention
from diffvit_tpu_torch.testing import random_int_model

from test_torch_calibrate import one_torch_thread  # noqa: F401

TINY = vit.ViTSpec("test_tiny", embed_dim=64, depth=2, num_heads=2,
                   num_classes=10)
NO_INPUT_Q = vit.ViTSpec("test_niq", embed_dim=64, depth=1, num_heads=2,
                         num_classes=10, input_quant=False)
N_SLOTS = vit.num_bit_slots(TINY)

JAX_CFGS = {
    "default": JaxQuantConfig(),
    "sq_off": JaxQuantConfig(smoothquant=False),
    "legacy": JaxQuantConfig(ptf=False, lis=False, smoothquant=False),
    "ptf_off": JaxQuantConfig(ptf=False),
}


def _port_spec(spec):
    return ViTSpec(spec.name, embed_dim=spec.embed_dim, depth=spec.depth,
                   num_heads=spec.num_heads, num_classes=spec.num_classes,
                   input_quant=spec.input_quant)


def _port_cfg(jcfg):
    return QuantConfig.from_dict(jcfg.to_dict())


def _assert_paths_agree(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.mean(got == ref) > 0.995, np.mean(got == ref)
    np.testing.assert_allclose(got, ref, atol=0.05)
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


def _assert_codes_close(got, want, lis):
    """K5's tolerance: LIS exact; the float softmax (bfloat16 weights,
    order-dependent sums) within 1 code on fewer than 2% of codes, the
    JAX suite's rule for that branch (tests/test_pallas_attention.py)."""
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    if lis:
        np.testing.assert_array_equal(got, want)
    diff = np.abs(got - want)
    assert diff.max() <= 1 and np.mean(diff > 0) < 0.02, \
        (diff.max(), np.mean(diff > 0))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 224, 224)).astype(np.float32)
    pixels = rng.integers(0, 256, (2, 3, 224, 224), dtype=np.uint8)
    return x, pixels


@pytest.fixture(scope="module")
def calibrated(inputs):
    """name -> (params, qp) of TINY calibrated by JAX under JAX_CFGS[name],
    each calibrated once."""
    cache = {}

    def get(name):
        if name not in cache:
            params = vit.init_params(TINY, jax.random.PRNGKey(0))
            cache[name] = (params, vit.calibrate(
                params, TINY, JAX_CFGS[name], jnp.asarray(inputs[0]))[0])
        return cache[name]
    return get


def _codes(ip, pixels):
    lut = input_code_lut(np.asarray(ip["qact_input"]["scale"]),
                         np.asarray(ip["qact_input"]["zp"]))
    return np.stack([lut[c][pixels[:, c]] for c in range(3)], 1)


def _both(ip_np, spec, jcfg, x):
    """JAX's and the port's logits for one numpy int-model pytree."""
    want = jax_vit_int.forward_q_int(ip_np, spec, jcfg, jnp.asarray(x),
                                     use_pallas=True, pallas_interpret=True)
    cfg, pspec = _port_cfg(jcfg), _port_spec(spec)
    ip = int_model_from_numpy(ip_np, pspec, "cpu", cfg)
    got = vit_int.forward_q_int(ip, pspec, cfg, torch.tensor(x)).numpy()
    assert got.shape == (x.shape[0], spec.num_classes)
    assert np.isfinite(got).all()
    return got, np.asarray(want)


def _baked(calibrated, name, bit_config):
    params, qp = calibrated(name)
    return jax.device_get(jax_vit_int.prepare_int(
        params, qp, TINY, JAX_CFGS[name], tuple(bit_config)))


# ---- K5: the attention core ----

@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("spec,batch,n_real,npad", [
    (_port_spec(TINY), 2, 197, 256),
    (VIT_SPECS["deit_small"], 1, 197, 256),
    (_port_spec(TINY), 3, 33, 128)])
def test_int_attention_plain_matches_pallas(spec, batch, n_real, npad, lis):
    """The JAX caller pads the tokens to a multiple of 128 with zero rows;
    the port's wrapper masks keys past ``n_real`` and needs no padding."""
    rng = np.random.default_rng(5)
    h, d = spec.num_heads, spec.head_dim
    qkv = np.zeros((batch, 3, h, npad, d), np.int8)
    qkv[:, :, :, :n_real] = np.clip(
        np.round(rng.standard_normal((batch, 3, h, n_real, d)) * 12),
        -128, 127)
    scalars = int_attn_scalars(random_int_model(spec, seed=2)["blocks"][0],
                               spec)
    want = np.asarray(jax_int_attention(
        jnp.asarray(qkv), jnp.asarray(scalars), num_heads=h, n_real=n_real,
        bits=4, lis=lis, interpret=True))
    got = fused_int_attention(torch.tensor(qkv[:, :, :, :n_real]),
                              torch.tensor(scalars), num_heads=h,
                              n_real=n_real, bits=4, lis=lis)
    assert got.shape == (batch, h, n_real, d) and got.dtype == torch.int8
    _assert_codes_close(got.numpy(), want[:, :, :n_real], lis)


def test_int_attention_reads_a_strided_view():
    """The forward hands K5 a permuted view of the (B, N, 3C) qkv codes;
    the result equals that of a contiguous copy."""
    spec = _port_spec(TINY)
    rng = np.random.default_rng(6)
    qkv = torch.tensor(np.clip(np.round(rng.standard_normal(
        (2, 197, 3 * 64)) * 12), -128, 127).astype(np.int8))
    view = qkv.view(2, 197, 3, 2, 32).permute(0, 2, 3, 1, 4)
    scalars = torch.tensor(int_attn_scalars(
        random_int_model(spec, seed=2)["blocks"][0], spec))
    kw = dict(num_heads=2, n_real=197)
    np.testing.assert_array_equal(
        fused_int_attention(view, scalars, **kw).numpy(),
        fused_int_attention(view.contiguous(), scalars, **kw).numpy())


# ---- the forward under each configuration, calibrated TINY ----

@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("wire", ["codes", "f32"])
def test_smoothquant_off_forward_matches_jax(calibrated, inputs, bits, wire):
    """FQ-ViT: qkv GEMM + requant in torch, then K5 with the LIS."""
    ip_np = _baked(calibrated, "sq_off", (bits,) * N_SLOTS)
    assert "ln_out_scale" not in ip_np["blocks"][0]["fc1"]
    x = _codes(ip_np, inputs[1]) if wire == "codes" else inputs[0]
    _assert_paths_agree(*_both(ip_np, TINY, JAX_CFGS["sq_off"], x))


@pytest.mark.parametrize("wire", ["codes", "f32"])
def test_legacy_config_forward_matches_jax(calibrated, inputs, wire):
    """QuantConfig(ptf=False, lis=False, smoothquant=False) at 8 bits: float
    LayerNorm, K5 with the float softmax, the unfused MLP."""
    ip_np = _baked(calibrated, "legacy", (8,) * N_SLOTS)
    x = _codes(ip_np, inputs[1]) if wire == "codes" else inputs[0]
    _assert_paths_agree(*_both(ip_np, TINY, JAX_CFGS["legacy"], x))


def _minus_one(*slots):
    bc = [4] * N_SLOTS
    for s in slots:
        bc[s] = -1
    return tuple(bc)


@pytest.mark.parametrize("bit_config", [
    (8,) + (4, 8) * (2 * TINY.depth) + (8,),   # mixed
    _minus_one(1, 4),       # block 0 qkv and fc2 float
    _minus_one(2),          # block 0 proj float: the unfused attention
    _minus_one(0, 3, N_SLOTS - 1),  # patch, block 0 fc1 and head float
], ids=["mixed", "qkv_fc2", "proj", "patch_fc1_head"])
def test_mixed_and_float_sites_match_jax(calibrated, inputs, bit_config):
    ip_np = _baked(calibrated, "default", bit_config)
    _assert_paths_agree(*_both(ip_np, TINY, JAX_CFGS["default"], inputs[0]))


@pytest.mark.parametrize("wire", ["codes", "f32"])
def test_float_layernorm_forward_matches_jax(calibrated, inputs, wire):
    """QuantConfig(ptf=False): float LN, K5 with the LIS, the unfused MLP
    with the exact GELU, the float-LN head."""
    ip_np = _baked(calibrated, "ptf_off", (4,) * N_SLOTS)
    x = _codes(ip_np, inputs[1]) if wire == "codes" else inputs[0]
    _assert_paths_agree(*_both(ip_np, TINY, JAX_CFGS["ptf_off"], x))


def test_asymmetric_activations_forward_matches_jax(calibrated, inputs):
    """sym_acts False: K1, the float32 fences, K2 emitting float32."""
    ip_np = dict(_baked(calibrated, "default", (4,) * N_SLOTS),
                 sym_acts=False)
    _assert_paths_agree(*_both(ip_np, TINY, JAX_CFGS["default"], inputs[0]))


def test_no_input_quant_matches_jax_and_refuses_codes(inputs):
    """``input_quant=False`` (vit_large-style): the f32 wire through the
    float patch; int8 codes raise ValueError in both packages."""
    params = vit.init_params(NO_INPUT_Q, jax.random.PRNGKey(2))
    cfg = JAX_CFGS["default"]
    qp, _ = vit.calibrate(params, NO_INPUT_Q, cfg, jnp.asarray(inputs[0]))
    ip_np = jax.device_get(jax_vit_int.prepare_int(
        params, qp, NO_INPUT_Q, cfg, (4,) * vit.num_bit_slots(NO_INPUT_Q)))
    assert ip_np["patch"]["fp"] and "qact_input" not in ip_np
    _assert_paths_agree(*_both(ip_np, NO_INPUT_Q, cfg, inputs[0]))
    pspec = _port_spec(NO_INPUT_Q)
    ip = int_model_from_numpy(ip_np, pspec, "cpu")
    codes = torch.zeros((1, 3, 224, 224), dtype=torch.int8)
    with pytest.raises(ValueError, match="input_quant"):
        vit_int.forward_q_int(ip, pspec, QuantConfig(), codes)


# ---- random int-models of the new schemas ----

@pytest.mark.parametrize("name,bits,bit_config", [
    ("sq_off", 8, None),
    ("legacy", 8, None),
    ("default", 4, _minus_one(2, 7)),  # block 0 proj, block 1 fc1 float
], ids=["sq_off_int8", "legacy", "float_sites"])
def test_random_model_matches_jax(inputs, name, bits, bit_config):
    jcfg = dataclasses.replace(JAX_CFGS[name], bit_w=JAX_BITS[f"int{bits}"])
    ip_np = random_int_model(_port_spec(TINY), _port_cfg(jcfg), seed=1,
                             bit_config=bit_config)
    if not jcfg.smoothquant:
        assert all("ln_rescale" not in ib["fc1"] for ib in ip_np["blocks"])
    got, want = _both(ip_np, TINY, jcfg, inputs[0])
    _assert_paths_agree(got, want)
    assert not np.array_equal(got[0], got[1])

"""The port's ViT calibration and float forward vs the JAX package's, on
the CPU, at the TINY spec (64 wide, 2 blocks, 10 classes) with JAX's
params carried across by ``params_from_numpy`` and seeded Gaussian batches
through both; the registry; the ViT refusal of a LIS scale below the int64
row sum.  (The fake-quant forward, the bake and the engine:
tests/test_torch_calibrate_serve.py.)

``calibrate``, for the default P2-ViT config, FQ-ViT int8, PTF off, LIS
off, the ema/omse/percentile observers and a two-entry alpha pool: the
same keys; every PoT entry bit-equal (weights, the minmax activations,
SmoothQuant's channel scales, PTF's channel masks); the plain scales
(PTF's base, ema, percentile, OMSE) within rtol 1e-6 (they follow an
activation maximum, which the port's float64 products put within a few
ulps of the reference's float32 ones); global_distance within rtol 1e-5.

The reference's ``calibrate`` raises for a multi-entry alpha pool (its
jitted block calls ``int()`` on a traced argmin, ``vit.py:410``); that
case runs its blocks unjitted here (``_calibrate_block.__wrapped__``), its
observers still jitted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffvit_tpu.config import QuantConfig as JaxQuantConfig
from diffvit_tpu.models import vit as jax_vit
from diffvit_tpu.ops.bit_types import BIT_TYPE_DICT as JAX_BITS

from diffvit_tpu_torch import QuantConfig, engine
from diffvit_tpu_torch.data.synthetic import gaussian_calibration
from diffvit_tpu_torch.models import registry, vit
from diffvit_tpu_torch.models.convert import int_model_from_numpy
from diffvit_tpu_torch.testing import random_int_model

J_TINY = jax_vit.ViTSpec("test_tiny", embed_dim=64, depth=2, num_heads=2,
                         num_classes=10)
TINY = vit.ViTSpec("test_tiny", embed_dim=64, depth=2, num_heads=2,
                   num_classes=10)
N_SLOTS = vit.num_bit_slots(TINY)
MIXED = (8,) + (4, -1, 8, 4) + (-1, 8, 4, 8) + (4,)

CASES = {
    "default": {},
    "fqvit_int8": dict(smoothquant=False, bit_w=JAX_BITS["int8"]),
    "ptf_off": dict(ptf=False),
    "lis_off": dict(lis=False),
    "ema": dict(quant_method="ema"),
    "omse": dict(quant_method="omse"),
    "percentile": dict(quant_method="percentile"),
    "two_alpha": dict(alpha_pool=(0.35, 0.5)),
}


def _port_cfg(jcfg):
    return QuantConfig.from_dict(jcfg.to_dict())


def _assert_paths_agree(got, ref):
    """tests/test_pallas_attention.py::_assert_paths_agree."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.mean(got == ref) > 0.995, np.mean(got == ref)
    np.testing.assert_allclose(got, ref, atol=0.05)
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


@pytest.fixture(scope="module")
def tiny():
    params_j = jax_vit.init_params(J_TINY, jax.random.PRNGKey(0))
    params = vit.params_from_numpy(jax.device_get(params_j), "cpu")
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((2, 3, 224, 224)).astype(np.float32)
          for _ in range(3)]
    return params_j, params, xs


def _jax_calibrate(params_j, jcfg, x):
    """JAX's calibrate; with a multi-entry alpha pool its blocks run
    unjitted (see the module docstring), in calibrate's own order."""
    if len(jcfg.alpha_pool) == 1 and len(jcfg.mlp_alpha_pool) == 1:
        return jax_vit.calibrate(params_j, J_TINY, jcfg, jnp.asarray(x))
    h, qp = jax_vit._calibrate_embed(params_j, J_TINY, jcfg, jnp.asarray(x))
    qp, dists = dict(qp), []
    for i, blk in enumerate(params_j["blocks"]):
        h, qb, db = jax_vit._calibrate_block.__wrapped__(blk, J_TINY, jcfg,
                                                         h)
        qp.update({f"blocks.{i}.{k}": v for k, v in qb.items()})
        dists.append(db)
    qt, dt = jax_vit._calibrate_tail(params_j, J_TINY, jcfg, h)
    qp.update(qt)
    return qp, jnp.concatenate(dists + [dt])


def _qp_torch(qp):
    return {k: torch.tensor(np.asarray(v)) for k, v in qp.items()}


def _assert_qparams_match(want, got):
    """PoT entries bit-equal; the plain ones within rtol 1e-6, PTF's
    channel masks (scale / its least) bit-equal."""
    assert set(want) == set(got)
    plain = 0
    for k, w in want.items():
        w, g = np.asarray(w), got[k].cpu().numpy()
        assert w.shape == g.shape and w.dtype == g.dtype, k
        pot = np.all(w > 0) and np.all(np.frexp(w)[0] == 0.5)
        if k.endswith(".zp") or pot:
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        plain += 1
        np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=k)
        if w.ndim == 1 and w.size > 1:  # a PTF site's channel masks
            np.testing.assert_array_equal(g / g.min(), w / w.min(),
                                          err_msg=k)
    return plain


@pytest.mark.parametrize("case", list(CASES))
def test_calibrate_matches_jax(tiny, case):
    params_j, params, xs = tiny
    jcfg = JaxQuantConfig(**CASES[case])
    qp_j, dist_j = _jax_calibrate(params_j, jcfg, xs[0])
    qp, dist = vit.calibrate(params, TINY, _port_cfg(jcfg),
                             torch.tensor(xs[0]))
    _assert_qparams_match(qp_j, qp)
    assert dist.shape == (4 * TINY.depth + 1, 4)
    np.testing.assert_allclose(dist.numpy(), np.asarray(dist_j), rtol=1e-5)
    if case == "two_alpha":
        assert qp["blocks.0.attn.qkv.sq.channel_scale"].shape == (2, 64)


def test_forward_fp_matches_jax(tiny):
    params_j, params, xs = tiny
    want = np.asarray(jax_vit.forward_fp(params_j, J_TINY, xs[1]))
    got = vit.forward_fp(params, TINY, torch.tensor(xs[1])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_vit_lis_scale_below_the_int64_sum_is_refused():
    """The ViT counterpart of the Swin refusal: a LIS softmax scale below
    lis_sum_fits (2^-11 over 197 keys) is refused when the model is
    converted; 2^-10 and the float softmax take it."""
    ip = random_int_model(TINY, seed=1)
    ip["blocks"][1]["attn.qact_attn1"]["scale"] = np.float32(2.0**-11)
    with pytest.raises(ValueError, match="block 1: softmax scale"):
        int_model_from_numpy(ip, TINY, "cpu")
    with pytest.raises(ValueError, match="int64"):
        engine.IntModel(ip, TINY, QuantConfig(), "cpu")
    int_model_from_numpy(ip, TINY, "cpu", QuantConfig(lis=False))
    ip["blocks"][1]["attn.qact_attn1"]["scale"] = np.float32(2.0**-10)
    int_model_from_numpy(ip, TINY, "cpu")


def test_registry_and_params():
    """Seeded params, equal for equal seeds, in the reference's layout and
    truncation; a checkpoint or a Swin name is refused, not replaced."""
    spec, p = registry.build_params("deit_tiny", seed=3, device="cpu")
    assert spec is vit.VIT_SPECS["deit_tiny"] and registry.family(
        "deit_tiny") == "deit"
    _, p2 = registry.build_params("deit_tiny", seed=3, device="cpu")
    assert torch.equal(p["blocks"][5]["fc1"]["w"], p2["blocks"][5]["fc1"]["w"])
    w = p["blocks"][0]["qkv"]["w"]
    assert w.shape == (3 * 192, 192) and float(w.abs().max()) <= 0.04
    assert abs(float(w.std()) - 0.0176) < 0.001  # std 0.02 cut at 2 std
    assert torch.equal(p["norm"]["w"], torch.ones(192))
    assert p["patch_embed"]["w"].shape == (192, 768)
    with pytest.raises(NotImplementedError, match="Queue 1, item 4"):
        registry.build_params("deit_tiny", checkpoint="x.pth", device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1, item 4"):
        registry.build_params("swin_tiny", device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1, item 4"):
        engine.QuantizedViT("swin_tiny", device="cpu")
    assert vit.flops_list(TINY) == jax_vit.flops_list(J_TINY)
    np.testing.assert_array_equal(
        gaussian_calibration(2, seed=4),
        __import__("diffvit_tpu.data.synthetic", fromlist=["x"])
        .gaussian_calibration(2, seed=4))
    assert dataclasses.asdict(TINY) == dataclasses.asdict(J_TINY)

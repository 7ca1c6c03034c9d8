"""The port's multi-batch calibration, fake-quant forward, bake and engine
vs the JAX package's, on the CPU, at the TINY spec of
tests/test_torch_calibrate.py (its params and batches):

* ``calibrate_batches`` over 3 batches;
* ``forward_q`` on JAX's qparams by the JAX suite's
  ``_assert_paths_agree`` rule, at all-4, all-8 and a mixed {4, 8, -1}
  bit config;
* ``prepare_int`` equal to JAX's array for array, from the same qparams;
* ``QuantizedViT``: its own calibrate -> bake -> IntModel against JAX's
  integer path on JAX's own; the artifacts and the calibration files both
  ways; ``validate``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffvit_tpu import engine as jax_engine
from diffvit_tpu.config import QuantConfig as JaxQuantConfig
from diffvit_tpu.models import vit as jax_vit
from diffvit_tpu.models import vit_int as jax_vit_int

from diffvit_tpu_torch import QuantConfig, engine
from diffvit_tpu_torch.models import vit, vit_int
from diffvit_tpu_torch.ops.kernels.attention import lis_sum_fits

from test_torch_calibrate import (CASES, J_TINY, MIXED, N_SLOTS,  # noqa: F401
                                  TINY, _assert_paths_agree,
                                  _assert_qparams_match, _port_cfg,
                                  _qp_torch, tiny)


@pytest.mark.parametrize("quant_method", ["minmax", "ema"])
def test_calibrate_batches_matches_jax(tiny, quant_method):
    """Running statistics over the first two batches, the scales on the
    third."""
    params_j, params, xs = tiny
    jcfg = JaxQuantConfig(quant_method=quant_method)
    qp_j, dist_j = jax_vit.calibrate_batches(params_j, J_TINY, jcfg, xs)
    qp, dist = vit.calibrate_batches(params, TINY, _port_cfg(jcfg),
                                     [torch.tensor(x) for x in xs])
    _assert_qparams_match(qp_j, qp)
    np.testing.assert_allclose(dist.numpy(), np.asarray(dist_j), rtol=1e-5)
    single, _ = vit.calibrate(params, TINY, _port_cfg(jcfg),
                              torch.tensor(xs[2]))
    assert any(not torch.equal(single[k], qp[k]) for k in qp)


@pytest.fixture(scope="module")
def calibrated(tiny):
    """JAX's default and FQ-ViT int8 calibrations of TINY on batch 0."""
    params_j, _, xs = tiny
    out = {}
    for name in ("default", "fqvit_int8"):
        jcfg = JaxQuantConfig(**CASES[name])
        out[name] = (jcfg, jax_vit.calibrate(params_j, J_TINY, jcfg,
                                             jnp.asarray(xs[0]))[0])
    return out


@pytest.mark.parametrize("bits", ["all4", "all8", "mixed"])
def test_forward_q_matches_jax(tiny, calibrated, bits):
    """The fake-quant forward on JAX's qparams, both packages."""
    params_j, params, xs = tiny
    jcfg, qp_j = calibrated["default"]
    bc = {"all4": (4,) * N_SLOTS, "all8": (8,) * N_SLOTS,
          "mixed": MIXED}[bits]
    want = jax.jit(lambda p, q, x: jax_vit.forward_q(p, q, J_TINY, jcfg, x,
                                                     bc))(params_j, qp_j,
                                                          xs[1])
    got = vit.forward_q(params, _qp_torch(qp_j), TINY, _port_cfg(jcfg),
                        torch.tensor(xs[1]), bc)
    assert got.shape == (2, 10) and torch.isfinite(got).all()
    _assert_paths_agree(got.numpy(), want)


def _assert_tree_equal(got, want, where="ip"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)) and not np.isscalar(want):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{where}[{i}]")
    elif isinstance(want, (bool, int)):
        assert got == want and type(got) is type(want), where
    else:
        w, g = np.asarray(want), np.asarray(got)
        assert g.dtype == w.dtype, (where, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=where)


@pytest.mark.parametrize("case,bits", [("default", None),
                                       ("default", MIXED),
                                       ("fqvit_int8", None),
                                       ("no_input_quant", None)])
def test_prepare_int_matches_jax(tiny, calibrated, case, bits):
    """From the same qparams, array for array (the per-head qkv layout,
    the norm2 ln_out_scale / ln_rescale, sym_acts included; without an
    input QAct the patch keeps its fake-quantized float weight)."""
    params_j, params, xs = tiny
    spec_j, spec = J_TINY, TINY
    if case == "no_input_quant":
        spec_j = dataclasses.replace(J_TINY, input_quant=False, depth=1)
        spec = dataclasses.replace(TINY, input_quant=False, depth=1)
        params_j = dict(params_j, blocks=params_j["blocks"][:1])
        params = dict(params, blocks=params["blocks"][:1])
        jcfg = JaxQuantConfig()
        qp_j = jax_vit.calibrate(params_j, spec_j, jcfg, xs[0])[0]
    else:
        jcfg, qp_j = calibrated[case]
    want = jax.device_get(jax_vit_int.prepare_int(params_j, qp_j, spec_j,
                                                  jcfg, bits))
    got = vit_int.prepare_int(params, _qp_torch(qp_j), spec,
                              _port_cfg(jcfg), bits)
    _assert_tree_equal(got, want)
    assert got["sym_acts"] is True
    if case == "default":
        assert "ln_rescale" in got["blocks"][0]["fc1"] \
            or got["blocks"][0]["fc1"]["fp"]


@pytest.mark.parametrize("case", ["default", "fqvit_int8"])
def test_own_calibration_served_matches_jax(tiny, case, tmp_path):
    """QuantizedViT on uint8 pixels (normalized on the device, as JAX's
    _prep) calibrates, bakes and serves; JAX does the same on its side.
    The qparams match, the served logits agree with JAX's integer path on
    JAX's own bake, and the artifacts and calibration files cross-load."""
    params_j, params, _ = tiny
    jcfg = JaxQuantConfig(**CASES[case])
    pixels = np.random.default_rng(5).integers(0, 256, (2, 3, 224, 224),
                                               dtype=np.uint8)
    jq = jax_engine.QuantizedViT(J_TINY, jcfg, params=params_j)
    jq.calibrate(pixels)
    q = engine.QuantizedViT(TINY, _port_cfg(jcfg), params=params,
                            device="cpu")
    q.calibrate(pixels)
    _assert_qparams_match(jq.qparams, q.qparams)
    np.testing.assert_allclose(q.global_distance, jq.global_distance,
                               rtol=1e-5)

    ip_j = jax.device_get(jax_vit_int.prepare_int(
        params_j, jq.qparams, J_TINY, jcfg))
    x = jnp.asarray(jax_engine.device_normalize(jnp.asarray(pixels)))
    want = np.asarray(jax_vit_int.forward_q_int(ip_j, J_TINY, jcfg, x,
                                                use_pallas=False))
    model = q.prepare_int()
    assert isinstance(model, engine.IntModel)
    got = model(pixels).numpy()
    _assert_paths_agree(got, want)
    # the fake-quant forward of the same calibration
    _assert_paths_agree(q(pixels).numpy(), np.asarray(jq(pixels)))

    # artifacts: the port's -> JAX's loader, JAX's -> the port's
    port_art, jax_art = tmp_path / "port.npz", tmp_path / "jax.npz"
    q.save_int_model(port_art)
    jq.save_int_model(str(jax_art))
    _assert_paths_agree(np.asarray(jax_engine.load_int_model(
        str(port_art))(jnp.asarray(pixels))), got)
    _assert_paths_agree(engine.load_int_model(jax_art, "cpu")(pixels)
                        .numpy(), want)

    # calibration files both ways
    q.save_calibration(tmp_path / "port_cal.npz")
    jq.save_calibration(str(tmp_path / "jax_cal.npz"))
    jq2 = jax_engine.QuantizedViT(J_TINY, jcfg, params=params_j)
    jq2.load_calibration(str(tmp_path / "port_cal.npz"))
    _assert_tree_equal({k: np.asarray(v) for k, v in jq2.qparams.items()},
                       {k: v.numpy() for k, v in q.qparams.items()})
    q2 = engine.QuantizedViT(TINY, _port_cfg(jcfg), params=params,
                             device="cpu")
    q2.load_calibration(tmp_path / "jax_cal.npz")
    _assert_tree_equal({k: v.numpy() for k, v in q2.qparams.items()},
                       {k: np.asarray(v) for k, v in jq.qparams.items()})
    np.testing.assert_array_equal(q2.global_distance, jq.global_distance)
    _assert_paths_agree(q2.prepare_int()(pixels).numpy(), want)


def test_quantized_vit_validates_and_reports_softmax_scales(tiny):
    """engine.validate drives QuantizedViT as it drives IntModel; the TINY
    calibration's softmax scales stay where the exact LIS row sum fits."""
    _, params, xs = tiny
    q = engine.QuantizedViT(TINY, QuantConfig(), params=params, device="cpu")
    with pytest.raises(RuntimeError, match="calibrate"):
        q(xs[0])
    q.calibrate(xs[0])
    s_a = [float(q.qparams[f"blocks.{i}.attn.qact_attn1.scale"])
           for i in range(TINY.depth)]
    assert all(lis_sum_fits(s, TINY.seq_len) for s in s_a), s_a
    loader = [(xs[1], np.array([1, 2])), (xs[2], np.array([3, 4]))]
    loss, top1, top5 = engine.validate(q, loader, print_freq=0,
                                       log=lambda *a: None)
    assert np.isfinite(loss) and 0 <= top1 <= 100 and 0 <= top5 <= 100
    fp = q(xs[1], quant=False).numpy()
    np.testing.assert_allclose(fp, vit.forward_fp(q.params, TINY,
                                                  torch.tensor(xs[1])))

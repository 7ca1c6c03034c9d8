"""The port's Swin float side vs the JAX package's, on the CPU, at a TINY
Swin with a shifted block (32 wide, depths (2, 1), heads (2, 4), 56 px,
10 classes) with JAX's params carried across by ``params_from_numpy`` and
seeded Gaussian batches through both:

* ``calibrate`` for the default P2-ViT config, FQ-ViT int8, PTF off, LIS
  off and the ema/omse/percentile observers, and ``calibrate_batches`` on
  two batches, by tests/test_torch_calibrate.py's rule (the same keys; PoT
  entries and zero-points bit-equal; plain scales within rtol 1e-6;
  global_distance within rtol 1e-5).  The reference calibrates Swin
  eagerly (``diffvit_tpu/engine.py:83-85``), so its ``calibrate`` runs
  unjitted here too;
* ``forward_fp`` within rtol/atol 1e-5, against the jitted reference (its
  engine jits it);
* ``forward_q`` on JAX's qparams against the jitted reference (its engine
  jits it), by the JAX suite's ``_assert_paths_agree`` over 80 logits:
  uniform 4 and 8, and PTF off (the float LayerNorm); a per-slot
  {4, 8, -1} config by the same rule with the reference's float32
  products at its float (-1) sites, and with the port's own float64 ones
  within one act_out step on one image (the departure of ROADMAP's "How
  the reference holds the port");
* ``prepare_int`` equal to JAX's array for array, from the same qparams;
* ``QuantizedViT`` on a Swin spec: its own calibrate -> bake -> IntModel
  against JAX's calibrate -> bake -> interpret-mode Pallas integer path
  over 80 logits; the calibration files and the artifact both ways;
  ``resident=True`` refused;
* the Swin checkpoint converters on a timm-style state dict, and
  ``build_params`` from a seed, a ``.pth`` and ``DIFFVIT_CKPT_DIR``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffvit_tpu import engine as jax_engine
from diffvit_tpu.config import QuantConfig as JaxQuantConfig
from diffvit_tpu.models import swin as jswin, swin_int as jswin_int

from diffvit_tpu_torch import engine
from diffvit_tpu_torch.models import load, registry, swin, swin_int, vit
from diffvit_tpu_torch.models.vit_int import _host

from test_torch_calibrate import (CASES, _assert_paths_agree,  # noqa: F401
                                  _assert_qparams_match, _port_cfg,
                                  _qp_torch, one_torch_thread)
from test_torch_calibrate_serve import _assert_tree_equal

TINY_KW = dict(embed_dim=32, depths=(2, 1), num_heads=(2, 4), img_size=56,
               num_classes=10)
J_TINY = jswin.SwinSpec("swin_test2", **TINY_KW)
TINY = swin.SwinSpec("swin_test2", **TINY_KW)
N_SLOTS = swin.num_bit_slots(TINY)  # 15: patch, 3 blocks, reduction, head
# patch; block 0 (fc1 float: norm2 float); block 1, shifted (qkv float:
# norm1 float); the reduction in float (its 4-way LN float); block 2; head
MIXED = (8,) + (4, 8, -1, 4) + (-1, 4, 8, 8) + (-1,) + (8, 4, 4, 8) + (4,)
SWIN_CASES = {k: v for k, v in CASES.items() if k != "two_alpha"}
_jit_forward_q = jax.jit(jswin.forward_q,
                         static_argnames=("spec", "cfg", "bit"))
_jit_matmul_t = jax.jit(lambda x, w: x @ w.T)


@pytest.fixture(scope="module")
def tiny():
    params_j = jswin.init_swin_params(J_TINY, jax.random.PRNGKey(0))
    params = vit.params_from_numpy(jax.device_get(params_j), "cpu")
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((b, 3, 56, 56)).astype(np.float32)
          for b in (2, 2, 8)]
    return params_j, params, xs


@pytest.fixture(scope="module")
def jax_qparams(tiny):
    """JAX's calibration of TINY on batch 0, once per case."""
    params_j, _, xs = tiny
    cache = {}

    def get(case):
        if case not in cache:
            jcfg = JaxQuantConfig(**SWIN_CASES[case])
            cache[case] = (jcfg, *jswin.calibrate(params_j, J_TINY, jcfg,
                                                  jnp.asarray(xs[0])))
        return cache[case]
    return get


@pytest.mark.parametrize("case", list(SWIN_CASES))
def test_calibrate_matches_jax(tiny, jax_qparams, case):
    """The default config's SmoothQuant flag is ignored (Swin has none)."""
    _, params, xs = tiny
    jcfg, qp_j, dist_j = jax_qparams(case)
    qp, dist = swin.calibrate(params, TINY, _port_cfg(jcfg),
                              torch.tensor(xs[0]))
    _assert_qparams_match(qp_j, qp)
    assert dist.shape == (N_SLOTS - 1, 4)  # the patch conv records none
    np.testing.assert_allclose(dist.numpy(), np.asarray(dist_j), rtol=1e-5)
    assert not any(".sq." in k for k in qp)
    if case == "default":
        assert qp["layers.0.blocks.1.qact2.scale"].shape == (32,)  # PTF


@pytest.mark.parametrize("quant_method", ["minmax", "ema"])
def test_calibrate_batches_matches_jax(tiny, quant_method):
    """Running statistics over batch 0, the scales on batch 1."""
    params_j, params, xs = tiny
    jcfg = JaxQuantConfig(quant_method=quant_method)
    qp_j, dist_j = jswin.calibrate_batches(params_j, J_TINY, jcfg,
                                           [jnp.asarray(x) for x in xs[:2]])
    qp, dist = swin.calibrate_batches(params, TINY, _port_cfg(jcfg),
                                      [torch.tensor(x) for x in xs[:2]])
    _assert_qparams_match(qp_j, qp)
    np.testing.assert_allclose(dist.numpy(), np.asarray(dist_j), rtol=1e-5)
    single, _ = swin.calibrate(params, TINY, _port_cfg(jcfg),
                               torch.tensor(xs[1]))
    assert any(not torch.equal(single[k], qp[k]) for k in qp)


def test_forward_fp_matches_jax(tiny):
    params_j, params, xs = tiny
    want = np.asarray(jax.jit(lambda p, x: jswin.forward_fp(p, J_TINY, x))(
        params_j, xs[2]))
    got = swin.forward_fp(params, TINY, torch.tensor(xs[2])).numpy()
    assert got.shape == (8, 10)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case,bits", [("default", 4), ("default", 8),
                                       ("ptf_off", 4)],
                         ids=["all4", "all8", "float_ln"])
def test_forward_q_matches_jax(tiny, jax_qparams, case, bits):
    """The fake-quant forward on JAX's qparams, both packages, 8 images."""
    params_j, params, xs = tiny
    jcfg, qp_j, _ = jax_qparams(case)
    want = _jit_forward_q(params_j, qp_j, spec=J_TINY, cfg=jcfg, x=xs[2],
                          bit=bits)
    got = swin.forward_q(params, _qp_torch(qp_j), TINY, _port_cfg(jcfg),
                         torch.tensor(xs[2]), bits)
    assert got.shape == (8, 10) and torch.isfinite(got).all()
    _assert_paths_agree(got.numpy(), want)


def _xla_linear(x, w, b=None):
    """``x @ w.T + b`` with the reference's float32 product (XLA's)."""
    y = torch.from_numpy(np.array(_jit_matmul_t(x.numpy(), w.numpy())))
    return y if b is None else y + b


def test_forward_q_float_sites_depart_only_by_their_products(
        tiny, jax_qparams, monkeypatch):
    """MIXED, on JAX's qparams: the port's float (-1) sites take their
    products in float64 rounded once, the reference in float32 in XLA's
    order.  On these 8 images that flips one mlp.qact1 code of 50,176
    (after block 0's float fc1), and one image's logits differ by one
    act_out step on 3 of its 10 logits; with XLA's float32 products
    swapped into the port, the logits agree by the JAX suite's rule."""
    params_j, params, xs = tiny
    jcfg, qp_j, _ = jax_qparams("default")
    want = np.asarray(_jit_forward_q(params_j, qp_j, spec=J_TINY, cfg=jcfg,
                                     x=xs[2], bit=MIXED))

    def run():
        return swin.forward_q(params, _qp_torch(qp_j), TINY, _port_cfg(jcfg),
                              torch.tensor(xs[2]), MIXED).numpy()
    got = run()
    steps = np.round(np.abs(got - want) / float(qp_j["act_out.scale"]))
    assert got.shape == (8, 10) and np.isfinite(got).all()
    assert steps.max() <= 1 and np.sum(steps.any(1)) <= 1
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    monkeypatch.setattr(swin, "_linear", _xla_linear)
    _assert_paths_agree(run(), want)


def test_forward_q_refuses_bad_bit_configs(tiny, jax_qparams):
    _, params, xs = tiny
    jcfg, qp_j, _ = jax_qparams("default")
    args = (params, _qp_torch(qp_j), TINY, _port_cfg(jcfg),
            torch.tensor(xs[0]))
    with pytest.raises(ValueError, match="entries"):
        swin.forward_q(*args, MIXED[1:])
    with pytest.raises(ValueError, match="4, 8 or -1"):
        swin.forward_q(*args, 2)


@pytest.mark.parametrize("case,bits", [("default", None), ("default", 8),
                                       ("default", tuple(
                                           8 if b == -1 else b
                                           for b in MIXED)),
                                       ("fqvit_int8", None)],
                         ids=["default", "int8", "mixed48", "fqvit_int8"])
def test_prepare_int_matches_jax(tiny, jax_qparams, case, bits):
    """From the same qparams, array for array (weight codes, scales and
    bits, biases and their absence, norms, bias tables, qparams,
    sym_acts)."""
    params_j, params, _ = tiny
    jcfg, qp_j, _ = jax_qparams(case)
    want = jax.device_get(jswin_int.prepare_int(params_j, qp_j, J_TINY, jcfg,
                                                bits))
    got = swin_int.prepare_int(params, _qp_torch(qp_j), TINY,
                               _port_cfg(jcfg), bits)
    _assert_tree_equal(got, want)
    assert got["sym_acts"] is True
    assert got["layers"][0]["downsample"]["reduction"]["b"] is None
    with pytest.raises(ValueError, match="4 or 8"):
        swin_int.prepare_int(params, _qp_torch(qp_j), TINY, _port_cfg(jcfg),
                             MIXED)


def test_own_calibration_served_matches_jax(tiny, tmp_path):
    """QuantizedViT on a Swin spec calibrates on a Gaussian batch, bakes
    and serves uint8 pixels through IntModel (the plain versions of K4 and
    K2 on the CPU); JAX calibrates, bakes and serves through its Pallas
    kernels in interpret mode.  The qparams match, the served logits and
    the fake-quant logits agree over 80 logits, and the calibration files
    and the artifacts cross-load."""
    params_j, params, xs = tiny
    jcfg = JaxQuantConfig()
    cfg = _port_cfg(jcfg)
    pixels = np.random.default_rng(5).integers(0, 256, (8, 3, 56, 56),
                                               dtype=np.uint8)
    jq = jax_engine.QuantizedViT(J_TINY, jcfg, params=params_j)
    jq.calibrate(xs[0])
    q = engine.QuantizedViT(TINY, cfg, params=params, device="cpu")
    assert q.is_swin and q.flops == jswin.flops_list(J_TINY)
    q.calibrate(xs[0])
    _assert_qparams_match(jq.qparams, q.qparams)
    np.testing.assert_allclose(q.global_distance, jq.global_distance,
                               rtol=1e-5)

    ip_j = jax.device_get(jswin_int.prepare_int(params_j, jq.qparams,
                                                J_TINY, jcfg))
    x = jax_engine.device_normalize(jnp.asarray(pixels))
    want = np.asarray(jax.jit(lambda t: jswin_int.forward_q_int(
        ip_j, J_TINY, jcfg, t, use_pallas=True, pallas_interpret=True))(x))
    model = q.prepare_int()
    assert isinstance(model, engine.IntModel) and model is q.prepare_int(4)
    got = model(pixels).numpy()
    assert got.shape == (8, 10) and np.isfinite(got).all()
    _assert_paths_agree(got, want)
    np.testing.assert_array_equal(q(pixels, use_int=True).numpy(), got)
    # the fake-quant and float forwards of the same calibration
    _assert_paths_agree(q(pixels).numpy(), np.asarray(_jit_forward_q(
        params_j, jq.qparams, spec=J_TINY, cfg=jcfg, x=x, bit=4)))
    xt = torch.tensor(np.asarray(x))
    np.testing.assert_array_equal(q(pixels, quant=False).numpy(),
                                  swin.forward_fp(params, TINY, xt).numpy())
    with pytest.raises(ValueError, match="ViT family"):
        q.prepare_int(resident=True)

    # calibration files both ways
    q.save_calibration(tmp_path / "port_cal.npz")
    jq.save_calibration(str(tmp_path / "jax_cal.npz"))
    jq2 = jax_engine.QuantizedViT(J_TINY, jcfg, params=params_j)
    jq2.load_calibration(str(tmp_path / "port_cal.npz"))
    _assert_tree_equal({k: np.asarray(v) for k, v in jq2.qparams.items()},
                       {k: v.numpy() for k, v in q.qparams.items()})
    q2 = engine.QuantizedViT(TINY, cfg, params=params, device="cpu")
    q2.load_calibration(tmp_path / "jax_cal.npz")
    _assert_tree_equal({k: v.numpy() for k, v in q2.qparams.items()},
                       {k: np.asarray(v) for k, v in jq.qparams.items()})
    np.testing.assert_array_equal(q2.global_distance, jq.global_distance)

    # the port's artifact: served by the port as baked, and read by JAX's
    # loader as that Swin int-model
    art = tmp_path / "port.npz"
    q.save_int_model(art)
    served = engine.load_int_model(art, "cpu")
    assert served.is_swin and served.spec == TINY
    np.testing.assert_array_equal(served(pixels).numpy(), got)
    loaded = jax_engine.load_int_model(str(art))
    assert loaded.is_swin and loaded.spec == J_TINY
    _assert_tree_equal(jax.device_get(loaded.ip), swin_int.prepare_int(
        q.params, q.qparams, TINY, cfg))


def _timm_state_dict(params, spec):
    """A timm-style Swin state dict of the numpy ``params``: the patch conv
    as (C, 3, ps, ps), and the relative-position index and shift-mask
    buffers beside the weights."""
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    pe, ps = params["patch_embed"], spec.patch_size
    sd = {"patch_embed.proj.weight": t(pe["proj"]["w"]).reshape(
              spec.embed_dim, 3, ps, ps),
          "patch_embed.proj.bias": t(pe["proj"]["b"])}
    for name, ln in (("patch_embed.norm", pe["norm"]),
                     ("norm", params["norm"]), ("head", params["head"])):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = t(ln["w"]), t(ln["b"])
    for s, stage in enumerate(params["layers"]):
        for bi, blk in enumerate(stage["blocks"]):
            p = f"layers.{s}.blocks.{bi}"
            for name in ("norm1", "attn.qkv", "attn.proj", "norm2",
                         "mlp.fc1", "mlp.fc2"):
                lin = blk[name.split(".")[-1]]
                sd[f"{p}.{name}.weight"] = t(lin["w"])
                sd[f"{p}.{name}.bias"] = t(lin["b"])
            sd[f"{p}.attn.relative_position_bias_table"] = \
                t(blk["rel_bias_table"])
            _, ws, _, mask = swin.block_geometry(spec, s, bi)
            sd[f"{p}.attn.relative_position_index"] = \
                t(swin.relative_position_index(ws))
            if mask is not None:
                sd[f"{p}.attn_mask"] = t(mask)
        if stage["downsample"] is not None:
            ds = stage["downsample"]
            p = f"layers.{s}.downsample"
            sd[f"{p}.norm.weight"] = t(ds["norm"]["w"])
            sd[f"{p}.norm.bias"] = t(ds["norm"]["b"])
            sd[f"{p}.reduction.weight"] = t(ds["reduction"]["w"])
    return sd


@pytest.fixture(scope="module")
def checkpoint(tiny, tmp_path_factory):
    """TINY's params saved as a timm-style ``.pth`` (the ``model`` entry),
    named for the registry."""
    params_j, _, _ = tiny
    path = tmp_path_factory.mktemp("ckpt") / "swin_test2.pth"
    torch.save({"model": _timm_state_dict(jax.device_get(params_j), TINY)},
               path)
    return path


def test_checkpoint_converters_match_jax(tiny, checkpoint):
    params_j, _, _ = tiny
    want = jax.device_get(jswin.load_swin_torch_checkpoint(str(checkpoint),
                                                           J_TINY))
    got = load.load_swin_torch_checkpoint(checkpoint, TINY)
    _assert_tree_equal(_host(got), want)
    _assert_tree_equal(_host(got), jax.device_get(params_j))
    assert got["patch_embed"]["proj"]["w"].shape == (32, 48)


def test_build_params_swin(tiny, checkpoint, monkeypatch):
    """From a seed (the reference's layout and truncation, equal for equal
    seeds), from a ``.pth``, through ``DIFFVIT_CKPT_DIR``, and through
    ``QuantizedViT(name, checkpoint=)``; TINY registered under its name
    (tests/test_torch_calibrate.py builds ``swin_tiny``)."""
    params_j, params, _ = tiny
    monkeypatch.setitem(swin.SWIN_SPECS, "swin_test2", TINY)
    spec, p = registry.build_params("swin_test2", seed=3, device="cpu")
    assert spec is TINY and registry.family("swin_test2") == "swin"
    _, p2 = registry.build_params("swin_test2", seed=3, device="cpu")
    _assert_tree_equal(_host(p2), _host(p))
    jax.tree.map(lambda g, w: None if g.shape == w.shape else
                 pytest.fail(f"{g.shape} vs {w.shape}"), p, params_j)
    for w in (p["layers"][1]["blocks"][0]["qkv"]["w"],
              p["layers"][0]["blocks"][1]["rel_bias_table"]):
        assert float(w.abs().max()) <= 0.04  # std 0.02 cut at 2 std
    w = p["layers"][0]["blocks"][0]["fc1"]["w"]
    assert w.shape == (128, 32) and abs(float(w.std()) - 0.0176) < 0.001
    assert p["layers"][0]["downsample"]["reduction"]["b"] is None
    assert p["layers"][1]["downsample"] is None
    assert torch.equal(p["norm"]["w"], torch.ones(64))

    want = _host(params)
    _, got = registry.build_params("swin_test2", checkpoint=str(checkpoint),
                                   device="cpu")
    _assert_tree_equal(_host(got), want)
    monkeypatch.setenv("DIFFVIT_CKPT_DIR", str(checkpoint.parent))
    _, got = registry.build_params("swin_test2", device="cpu")
    _assert_tree_equal(_host(got), want)
    q = engine.QuantizedViT("swin_test2", device="cpu",
                            checkpoint=str(checkpoint))
    assert q.is_swin and dataclasses.asdict(q.spec) == \
        dataclasses.asdict(J_TINY)
    _assert_tree_equal(_host(q.params), want)

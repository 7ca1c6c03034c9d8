"""The port's mixed-precision search against the JAX package's, on the CPU,
at the TINY ViT (64 wide, 2 blocks, 10 classes) and the TINY Swin (32
wide, depths (2, 1), heads (2, 4), 56 px) with JAX's params carried
across by ``params_from_numpy`` and seeded numpy batches through both:

* the search logic (``analysis.mixed_precision``): ``sample_candidates``
  (the ViT pair layout and the Swin ``bit_slot_groups``), ``omega_rank``
  under both column sets and ``evolutionary_search`` with and without
  ``evaluate_batch`` equal JAX's entry for entry for the same seed and a
  deterministic scorer;
* the fake path: ``forward_q_bits`` bit-equal to the jitted JAX function
  at uniform 4, uniform 8 and two mixed configs (ViT on JAX's own
  calibration of TINY; Swin on the port's calibration carried to JAX,
  because JAX calibrates Swin eagerly, ~35 s for TINY, and
  tests/test_torch_swin_calibrate.py already holds the port's Swin
  qparams to JAX's), and bit-equal to the port's own ``forward_q``;
* the integer path: ``select_int_bits`` equal to ``prepare_int(bits)``
  array for array and to JAX's ``select_int_bits`` on every entry JAX's
  has; the consistency guard; ``forward_bits_int`` bit-equal to the bake's
  ``IntModel``; ``validate_bits[_int]`` equal to per-config ``validate``;
  the bounded ``QuantizedViT`` int-model cache;
* the CLI's ``--mixed`` end to end on a fake ImageFolder, and against
  JAX's ``test_quant.main`` on the same folder, seed and Hessian vector.
"""
import contextlib
import io
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_quant
from diffvit_tpu.analysis import hessian as jax_hessian
from diffvit_tpu.analysis import mixed_precision as jmp
from diffvit_tpu.config import QuantConfig as JaxQuantConfig
from diffvit_tpu.models import swin as jswin
from diffvit_tpu.models import vit as jvit
from diffvit_tpu.models import vit_int as jvit_int

from diffvit_tpu_torch import QuantConfig, cli, engine
from diffvit_tpu_torch.analysis import hessian
from diffvit_tpu_torch.analysis import mixed_precision as mp
from diffvit_tpu_torch.data.synthetic import (gaussian_calibration,
                                              make_fake_imagefolder)
from diffvit_tpu_torch.models import swin, vit, vit_int
from diffvit_tpu_torch.models.convert import int_model_from_numpy

from test_torch_calibrate import (J_TINY, TINY, _port_cfg,  # noqa: F401
                                  _qp_torch, one_torch_thread)

N = vit.num_bit_slots(TINY)
SWIN_KW = dict(embed_dim=32, depths=(2, 1), num_heads=(2, 4), img_size=56,
               num_classes=10)
J_SWIN = jswin.SwinSpec("swin_test2", **SWIN_KW)
SWIN = swin.SwinSpec("swin_test2", **SWIN_KW)
N_SWIN = swin.num_bit_slots(SWIN)
# the CLI's pipeline crops to 224 px
SWIN_224 = swin.SwinSpec("swin_test", **dict(SWIN_KW, img_size=224))

# uniform 4 and 8; both phases of the (b_qkv, b_fc1) norm2 coupling
VIT_BITS = {"all4": (4,) * N, "all8": (8,) * N,
            "mixed_a": (8,) + (4, 4, 8, 8) + (8, 8, 4, 4) + (4,),
            "mixed_b": (8,) + (8, 8, 4, 4) + (4, 4, 8, 8) + (8,)}
SWIN_BITS = {"all4": (4,) * N_SWIN, "all8": (8,) * N_SWIN,
             "mixed_a": (8,) + (4, 4, 8, 8) * 2 + (8,) + (4, 4, 8, 8)
             + (4,),
             "mixed_b": (8,) + (8, 8, 4, 4) * 2 + (4,) + (8, 8, 4, 4)
             + (8,)}


def _quiet(*_):
    pass


# ---------------------------------------------------------------------------
# The search logic
# ---------------------------------------------------------------------------

def _score(c):
    """A deterministic stand-in for a validated top-1."""
    return float(sum(b * (i + 1) for i, b in enumerate(c)) % 97)


# (flops, groups, size factor); at the published widths the default
# factor 1.1 accepts about one draw in 10^4 (~45 s of sampling for 51
# candidates on this host), so the full-size layouts take 1.3
LAYOUTS = {
    "vit_tiny": (vit.flops_list(TINY), None, 2.0),
    "deit_small": (vit.flops_list(vit.VIT_SPECS["deit_small"]), None, 1.3),
    "swin_tiny_test": (swin.flops_list(SWIN), swin.bit_slot_groups(SWIN),
                       2.0),
    "swin_tiny": (swin.flops_list(swin.SWIN_SPECS["swin_tiny"]),
                  swin.bit_slot_groups(swin.SWIN_SPECS["swin_tiny"]), 1.3),
}


def test_flops_and_slot_groups_match_jax():
    assert vit.flops_list(TINY) == jvit.flops_list(J_TINY)
    assert swin.flops_list(SWIN) == jswin.flops_list(J_SWIN)
    assert swin.bit_slot_groups(SWIN) == jswin.bit_slot_groups(J_SWIN)
    big = swin.SWIN_SPECS["swin_tiny"]
    assert swin.bit_slot_groups(big) == jswin.bit_slot_groups(
        jswin.SWIN_SPECS["swin_tiny"])
    assert sorted(s for g in swin.bit_slot_groups(big) for s in g) == \
        list(range(1, swin.num_bit_slots(big)))
    assert (mp.BIT_CHOICE, mp.DIST_COLUMNS) == (jmp.BIT_CHOICE,
                                                jmp.DIST_COLUMNS)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_search_matches_jax(layout):
    """The same seed and scores give the same candidate list, omega order
    (both column sets) and final population, serial and batched, with
    the carry-over of the last valid score to a child over the size
    limit."""
    flops, groups, factor = LAYOUTS[layout]
    for seed in (0, 3):
        cands = mp.sample_candidates(flops, random.Random(seed),
                                     factor=factor, groups=groups)
        assert cands == jmp.sample_candidates(
            flops, random.Random(seed), factor=factor, groups=groups)
        assert cands and all(c[0] == 8 for c in cands)
        rng = np.random.default_rng(seed)
        hess = list(rng.random(len(flops) - 1))
        gd = np.abs(rng.standard_normal((len(flops) - 1, 4)))
        for columns in ("committed", "intended"):
            omega = mp.omega_rank(cands, flops, hess, gd, columns=columns)
            assert omega == jmp.omega_rank(cands, flops, hess, gd,
                                           columns=columns)
        kw = dict(pop_size=6, evo_iter=3, mutate_size=4, crossover_size=4,
                  factor=factor, log=_quiet)
        runs = [
            mod.evolutionary_search(omega, flops, evaluate,
                                    rng=random.Random(seed + 7),
                                    evaluate_batch=batch, **kw)
            for mod in (mp, jmp)
            for evaluate, batch in (
                (_score, None), (None, lambda cs: [_score(c) for c in cs]))]
        assert runs[0] == runs[1] == runs[2] == runs[3]


# ---------------------------------------------------------------------------
# The fake path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vit_cal():
    """TINY's params in both packages, JAX's default calibration on a b=2
    batch, and a b=8 batch."""
    params_j = jvit.init_params(J_TINY, jax.random.PRNGKey(0))
    params = vit.params_from_numpy(jax.device_get(params_j), "cpu")
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((b, 3, 224, 224)).astype(np.float32)
          for b in (2, 8)]
    jcfg = JaxQuantConfig()
    qp_j, dist_j = jvit.calibrate(params_j, J_TINY, jcfg,
                                  jnp.asarray(xs[0]))
    return params_j, params, xs, jcfg, qp_j, np.asarray(dist_j)


_jit_vit_bits = jax.jit(jvit.forward_q_bits, static_argnums=(2, 3))
_jit_swin_bits = jax.jit(jswin.forward_q_bits, static_argnums=(2, 3))


@pytest.mark.parametrize("name", list(VIT_BITS))
def test_forward_q_bits_matches_jax(vit_cal, name):
    """80 logits bit-equal to the jitted JAX forward_q_bits (which the
    _assert_paths_agree rule would only bound), and to the port's own
    forward_q at the same bits."""
    params_j, params, xs, jcfg, qp_j, _ = vit_cal
    bits = VIT_BITS[name]
    want = np.asarray(_jit_vit_bits(params_j, qp_j, J_TINY, jcfg, xs[1],
                                    jnp.asarray(bits, jnp.int32)))
    qp, cfg, x = _qp_torch(qp_j), _port_cfg(jcfg), torch.tensor(xs[1])
    got = vit.forward_q_bits(params, qp, TINY, cfg, x, bits).numpy()
    assert got.shape == (8, 10) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, vit.forward_q(params, qp, TINY, cfg, x, bits).numpy())


def test_forward_q_bits_refuses_outside_the_search_space(vit_cal):
    """A -1 entry, a wrong length, SmoothQuant off or a bit pool without 4
    raise ValueError (JAX asserts the first and the third)."""
    _, params, xs, jcfg, qp_j, _ = vit_cal
    qp, x = _qp_torch(qp_j), torch.tensor(xs[0])
    for cfg, bits in ((QuantConfig(), (8,) + (4,) * (N - 2) + (-1,)),
                      (QuantConfig(), (8,) * (N - 1)),
                      (QuantConfig(smoothquant=False), (8,) * N),
                      (QuantConfig(bit_pool=(8,)), (8,) * N)):
        with pytest.raises(ValueError):
            vit.forward_q_bits(params, qp, TINY, cfg, x, bits)
    with pytest.raises(ValueError, match="search space"):
        swin.forward_q_bits(None, None, SWIN, QuantConfig(), None,
                            (4, -1) + (4,) * (N_SWIN - 2))


@pytest.fixture(scope="module")
def swin_cal():
    """TINY Swin's params in both packages, the port's default calibration
    on a b=2 batch carried to JAX, and a b=8 batch."""
    params_j = jswin.init_swin_params(J_SWIN, jax.random.PRNGKey(0))
    params = vit.params_from_numpy(jax.device_get(params_j), "cpu")
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((b, 3, 56, 56)).astype(np.float32)
          for b in (2, 8)]
    qp, _ = swin.calibrate(params, SWIN, QuantConfig(), torch.tensor(xs[0]))
    qp_j = {k: jnp.asarray(v.numpy()) for k, v in qp.items()}
    return params_j, params, xs, qp, qp_j


@pytest.mark.parametrize("name", list(SWIN_BITS))
def test_swin_forward_q_bits_matches_jax(swin_cal, name):
    params_j, params, xs, qp, qp_j = swin_cal
    bits = SWIN_BITS[name]
    want = np.asarray(_jit_swin_bits(params_j, qp_j, J_SWIN,
                                     JaxQuantConfig(), xs[1],
                                     jnp.asarray(bits, jnp.int32)))
    x = torch.tensor(xs[1])
    got = swin.forward_q_bits(params, qp, SWIN, QuantConfig(), x,
                              bits).numpy()
    assert got.shape == (8, 10) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, swin.forward_q(params, qp, SWIN, QuantConfig(), x,
                            bits).numpy())


def test_swin_forward_bits_and_validate_bits(swin_cal):
    """QuantizedViT on a Swin: forward_bits stacks forward_q_bits per
    candidate; validate_bits scores them as per-config validate does;
    forward_bits_int raises NotImplementedError with JAX's message."""
    _, params, xs, qp, _ = swin_cal
    q = engine.QuantizedViT(SWIN, QuantConfig(), params=params,
                            device="cpu")
    q.qparams = qp
    cands = [list(SWIN_BITS["mixed_a"]), list(SWIN_BITS["all8"])]
    out = q.forward_bits(xs[1], cands)
    assert out.shape == (2, 8, 10)
    for c, o in zip(cands, out):
        np.testing.assert_array_equal(o.numpy(), q(xs[1], c).numpy())
    labels = np.arange(8) % 10
    loader = [(xs[1][:4], labels[:4]), (xs[1][4:], labels[4:])]
    got = engine.validate_bits(q, loader, cands, log=_quiet)
    want = [engine.validate(q, loader, c, print_freq=0, log=_quiet)[1]
            for c in cands]
    assert got == pytest.approx(want, abs=1e-9)
    with pytest.raises(NotImplementedError, match="ViT family"):
        q.forward_bits_int(xs[1], cands[0])


# ---------------------------------------------------------------------------
# The integer path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def int_bits(vit_cal):
    """The port's and JAX's {4, 8} bakes of TINY from JAX's qparams, and a
    QuantizedViT holding them."""
    params_j, params, xs, jcfg, qp_j, dist_j = vit_cal
    qp, cfg = _qp_torch(qp_j), _port_cfg(jcfg)
    variants = vit_int.prepare_int_bits(params, qp, TINY, cfg, "cpu")
    jvariants, jsym = jvit_int.prepare_int_bits(params_j, qp_j, J_TINY, jcfg)
    q = engine.QuantizedViT(TINY, cfg, params=params, device="cpu")
    q.qparams, q.global_distance = qp, dist_j
    return variants, jvariants, jsym, q


def _assert_device_tree_equal(got, want, where="ip", skip=(),
                              broadcast=False):
    """``got`` (the port's device int-model) equal to ``want`` (a device
    int-model, or JAX's pytree) on every key of ``want`` but those in
    ``skip``: tensors in value and dtype (``broadcast``: ``got``'s value
    broadcast to ``want``'s shape, as JAX's ``jnp.where`` select between a
    per-channel and a per-tensor scale gives it), flags and tuples by
    ==."""
    if isinstance(want, dict):
        assert isinstance(got, dict), where
        for k in want:
            if k not in skip:
                assert k in got, f"{where}.{k}"
                _assert_device_tree_equal(got[k], want[k], f"{where}.{k}",
                                          skip, broadcast)
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_device_tree_equal(g, w, f"{where}[{i}]", skip,
                                      broadcast)
    elif isinstance(want, (bool, int, tuple)):
        assert got == want, where
    else:
        w = want.numpy() if isinstance(want, torch.Tensor) \
            else np.asarray(want)
        g = got.cpu().numpy()
        if broadcast:
            g = np.broadcast_to(g, w.shape)
        assert g.dtype == w.dtype and g.shape == w.shape, where
        np.testing.assert_array_equal(g, w, err_msg=where)


@pytest.mark.parametrize("name", list(VIT_BITS))
def test_select_int_bits_matches_prepare_int(vit_cal, int_bits, name):
    """Equal to the converted prepare_int(bits) on every entry, and to
    JAX's select_int_bits on every entry of JAX's but its static
    bit_config; its weights are the bakes' own tensors."""
    params_j, params, xs, jcfg, qp_j, _ = vit_cal
    variants, jvariants, jsym, _ = int_bits
    bits = VIT_BITS[name]
    got = vit_int.select_int_bits(variants, bits, TINY, _port_cfg(jcfg))
    want = int_model_from_numpy(
        vit_int.prepare_int(params, _qp_torch(qp_j), TINY, _port_cfg(jcfg),
                            bits), TINY, "cpu", _port_cfg(jcfg))
    assert set(got) == set(want)
    _assert_device_tree_equal(got, want)
    want_j = jax.device_get(jvit_int.select_int_bits(
        jvariants, jnp.asarray(bits, jnp.int32), jsym, J_TINY, jcfg))
    _assert_device_tree_equal(got, want_j, skip={"bit_config"},
                              broadcast=True)
    bake = {4: variants["b4"], 8: variants["b8"]}
    for i in range(TINY.depth):
        for j, s in enumerate(("qkv", "proj", "fc1", "fc2")):
            b = bits[4 * i + 1 + j]
            assert got["blocks"][i][s]["w_int"] is \
                bake[b]["blocks"][i][s]["w_int"]


def test_select_int_bits_takes_the_joint_norm2_row(vit_cal):
    """Where a block's 4- and 8-bit SmoothQuant scales differ (here the
    calibration's 8-bit entries of the attention's and fc1's channel
    scales and of fc1's input scale scaled by powers of two; on TINY's
    random weights the calibration picks equal ones), the four norm2 rows
    differ and each mixed configuration's select equals its own bake, on
    the int-model and on the logits."""
    _, params, xs, jcfg, qp_j, _ = vit_cal
    cfg = _port_cfg(jcfg)
    qp = _qp_torch(qp_j)
    i8 = cfg.bit_pool.index(8)
    for i in range(TINY.depth):
        for key, f in (("attn.qkv.sq.channel_scale", 2.0),
                       ("mlp.fc1.sq.channel_scale", 4.0),
                       ("mlp.fc1.qact0.scale", 4.0)):
            qp[f"blocks.{i}.{key}"][i8] *= f
    variants = vit_int.prepare_int_bits(params, qp, TINY, cfg, "cpu")
    for rows in variants["fc1_lo"][0], variants["fc1_lr"][0]:
        assert all(not torch.equal(rows[a], rows[b])
                   for a in range(4) for b in range(a))
    x = torch.tensor(xs[1])
    for name in ("mixed_a", "mixed_b"):
        bits = VIT_BITS[name]
        ip = int_model_from_numpy(vit_int.prepare_int(params, qp, TINY, cfg,
                                                      bits), TINY, "cpu", cfg)
        got = vit_int.select_int_bits(variants, bits, TINY, cfg)
        _assert_device_tree_equal(got, ip)
        with torch.inference_mode():
            np.testing.assert_array_equal(
                vit_int.forward_q_int(got, TINY, cfg, x).numpy(),
                vit_int.forward_q_int(ip, TINY, cfg, x).numpy())


def test_prepare_int_bits_guard_raises(vit_cal, monkeypatch):
    """A coupling that prepare_int grows and the stacked cross terms miss
    (here: block 1's norm2 rescale moved in the uniform bakes) raises."""
    _, params, _, jcfg, qp_j, _ = vit_cal
    orig = vit_int.prepare_int

    def coupled(*args, **kw):
        ip = orig(*args, **kw)
        fc1 = ip["blocks"][1]["fc1"]
        fc1["ln_rescale"] = fc1["ln_rescale"] * np.float32(1.5)
        return ip

    monkeypatch.setattr(vit_int, "prepare_int", coupled)
    with pytest.raises(ValueError, match="norm2 cross terms diverge .* "
                                         "block 1"):
        vit_int.prepare_int_bits(params, _qp_torch(qp_j), TINY,
                                 _port_cfg(jcfg), "cpu")


@pytest.mark.parametrize("name", list(VIT_BITS))
def test_forward_bits_int_equals_the_bake(vit_cal, int_bits, name):
    _, _, xs, _, _, _ = vit_cal
    q = int_bits[3]
    got = q.forward_bits_int(xs[1], VIT_BITS[name])
    assert got.shape == (8, 10)
    np.testing.assert_array_equal(got.numpy(),
                                  q.prepare_int(VIT_BITS[name])(xs[1]).numpy())


def test_validate_bits_equal_per_config_validate(vit_cal, int_bits):
    """validate_bits_int's and validate_bits' top-1s equal per-config
    validate(use_int=True) and validate(quant=True) over two batches;
    forward_bits equals forward_q per candidate."""
    _, _, xs, _, _, _ = vit_cal
    q = int_bits[3]
    rng = np.random.default_rng(4)
    x = np.concatenate([xs[1], rng.standard_normal(xs[1].shape)
                        .astype(np.float32)])
    labels = q(x).numpy().argmax(1)
    labels[::3] = (labels[::3] + 1) % 10  # a third of them wrong
    loader = [(x[:8], labels[:8]), (x[8:], labels[8:])]
    cands = [list(VIT_BITS[k]) for k in ("mixed_a", "all4", "mixed_b")]
    got_int = engine.validate_bits_int(q, loader, cands, log=_quiet)
    got_fake = engine.validate_bits(q, loader, cands, log=_quiet)
    want_int = [engine.validate(q, loader, c, print_freq=0, log=_quiet,
                                use_int=True)[1] for c in cands]
    want_fake = [engine.validate(q, loader, c, print_freq=0, log=_quiet)[1]
                 for c in cands]
    assert got_int == pytest.approx(want_int, abs=1e-9)
    assert got_fake == pytest.approx(want_fake, abs=1e-9)
    assert 0 < max(got_fake) < 100
    out = q.forward_bits(x[:8], cands)
    for c, o in zip(cands, out):
        np.testing.assert_array_equal(o.numpy(), q(x[:8], c).numpy())


def test_int_model_cache_is_bounded(vit_cal, int_bits):
    """N validate(use_int=True) calls at N configurations keep at most the
    default configuration's model and the latest other one, with the
    logits of a fresh bake."""
    _, params, xs, _, _, _ = vit_cal
    q = int_bits[3]
    default = q.prepare_int()
    loader = [(xs[1], np.zeros(8, np.int64))]
    rng = np.random.default_rng(5)
    for _ in range(4):
        bits = tuple(int(b) for b in rng.choice([4, 8], N))
        engine.validate(q, loader, bits, print_freq=0, log=_quiet,
                        use_int=True)
        assert len(q._int_models) <= 2
        fresh = engine.IntModel(q._bake(bits), TINY, q.cfg, "cpu")
        np.testing.assert_array_equal(q(xs[1], bits, use_int=True).numpy(),
                                      fresh(xs[1]).numpy())
    assert q.prepare_int() is default


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

SEARCH = ["--quant", "--mode", "1", "--mixed", "--calib-batchsize", "2",
          "--val-batchsize", "6", "--num-workers", "2", "--print-freq", "0",
          "--hessian-batches", "1", "--hessian-iter", "2", "--evo-iter", "1",
          "--evo-pop", "3", "--evo-mutate", "2", "--evo-crossover", "2",
          "--pareto-top", "2", "--size-factor", "2"]


def _tiny_checkpoint(path):
    """A DeiT hub-style state dict of TINY at a realistic scale (weights
    of std 0.05, norms about 1), which both packages load."""
    g = torch.Generator().manual_seed(0)
    c, hid, ps = TINY.embed_dim, TINY.hidden_dim, TINY.patch_size
    r = lambda *s: 0.05 * torch.randn(*s, generator=g)  # noqa: E731
    sd = {"cls_token": r(1, 1, c), "pos_embed": r(1, TINY.seq_len, c),
          "patch_embed.proj.weight": r(c, 3, ps, ps),
          "patch_embed.proj.bias": r(c), "norm.weight": 1 + r(c),
          "norm.bias": r(c), "head.weight": r(TINY.num_classes, c),
          "head.bias": r(TINY.num_classes)}
    for i in range(TINY.depth):
        for name, shape in (("norm1", (c,)), ("norm2", (c,)),
                            ("attn.qkv", (3 * c, c)), ("attn.proj", (c, c)),
                            ("mlp.fc1", (hid, c)), ("mlp.fc2", (c, hid))):
            p = f"blocks.{i}.{name}"
            sd[p + ".weight"] = 1 + r(*shape) if "norm" in name \
                else r(*shape)
            sd[p + ".bias"] = r(shape[0])
    torch.save({"model": sd}, path)
    return str(path)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """A fake ImageFolder (val: 4 classes of 3; train: 4 of 2) and TINY's
    checkpoint."""
    root = tmp_path_factory.mktemp("mixed")
    make_fake_imagefolder(str(root / "val"), num_classes=4, per_class=3,
                          size=(80, 60), seed=3)
    make_fake_imagefolder(str(root / "train"), num_classes=4, per_class=2,
                          size=(80, 60), seed=4)
    return root, _tiny_checkpoint(root / "tiny.pth")


@pytest.fixture
def registered(monkeypatch):
    monkeypatch.setitem(vit.VIT_SPECS, "deit_test", TINY)
    monkeypatch.setitem(jvit.VIT_SPECS, "deit_test", J_TINY)
    monkeypatch.setitem(swin.SWIN_SPECS, "swin_test", SWIN_224)


@pytest.mark.parametrize("flags", [
    ["--search-path", "fake"], ["--search-path", "int"], ["--int-path"]],
    ids=["fake", "int", "int_path"])
def test_cli_mixed_searches_and_saves_the_best(folder, registered, tmp_path,
                                               capsys, flags):
    """--mixed end to end: the Hessian, the Pareto validations, one
    generation, ``best:``, and --save-int writes the best configuration's
    bake, which load_int_model serves with prepare_int(best)'s logits."""
    root, ckpt = folder
    out_path = str(tmp_path / "best.npz")
    result = cli.main(["deit_test", str(root), *SEARCH, "--device", "cpu",
                       "--checkpoint", ckpt, "--save-int", out_path, *flags])
    out = capsys.readouterr().out.splitlines()
    assert out[:3] == ["Model: deit_test",
                       "Calculating the sensitivities via the averaged "
                       "Hessian trace...", "Hutchinson estimator: per-leaf"]
    best = [ln for ln in out if ln.startswith("best: ")]
    assert best == [f"best: {result[0]}"] and len(result) == 3
    assert out[-1] == f"Saved int artifact (mixed best): {out_path}"
    assert all(b in (4, 8) for b in result[0][0]) and result[0][0][0] == 8
    q = engine.QuantizedViT("deit_test", QuantConfig(), checkpoint=ckpt,
                            device="cpu")
    q.calibrate(gaussian_calibration(2, 0))
    x = np.random.default_rng(6).integers(0, 256, (2, 3, 224, 224),
                                          dtype=np.uint8)
    np.testing.assert_array_equal(
        engine.load_int_model(out_path, "cpu")(x).numpy(),
        q.prepare_int(result[0][0])(x).numpy())


def test_cli_mixed_swin_takes_the_fake_path(folder, registered, capsys):
    """A Swin (224 px) under --search-path int prints JAX's message and
    searches on the fake path, over its bit_slot_groups."""
    root, _ = folder
    result = cli.main(["swin_test", str(root), *SEARCH, "--device", "cpu",
                       "--search-path", "int"])
    out = capsys.readouterr().out
    assert "--search-path int is ViT-family/single-chip; falling back to " \
        "the fake-quant search substrate" in out
    assert "validate_bits: " in out and "validate_bits_int" not in out
    best = result[0][0]
    assert len(best) == N_SWIN and best[0] == 8
    assert all(len({best[s] for s in g}) == 1
               for g in swin.bit_slot_groups(SWIN_224))


def test_cli_mixed_matches_jax(folder, registered, monkeypatch):
    """JAX's test_quant.main and the port's cli.main on the same folder,
    checkpoint, seed and Hessian vector print the same final population
    and the same ``best:`` line."""
    root, ckpt = folder
    vec = list(np.random.default_rng(9).random(N - 1))
    monkeypatch.setattr(jax_hessian, "hessian_sensitivity",
                        lambda *a, **k: vec)
    monkeypatch.setattr(hessian, "hessian_sensitivity", lambda *a, **k: vec)
    argv = ["deit_test", str(root), *SEARCH, "--device", "cpu",
            "--checkpoint", ckpt]
    lines = []
    for main, extra in ((test_quant.main, ["--dp", "1"]), (cli.main, [])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv + extra)
        lines.append([ln for ln in buf.getvalue().splitlines()
                      if ln.startswith(("best:", "[[", "Evolutionary"))])
    assert lines[0] == lines[1] and len(lines[1]) == 3
    assert lines[1][-1].startswith("best: [[8, ")

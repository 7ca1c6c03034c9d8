"""The port's mesh (``diffvit_tpu_torch/parallel/``) against the JAX
package's, on the CPU.

``make_mesh``'s shapes and assertion are held to JAX's ``make_mesh`` on the
8 virtual devices of tests/conftest.py.  The megatron rules are held leaf by
leaf to JAX's ``param_shardings`` and ``int_param_shardings`` for the ViT
and the Swin, float and integer: the same sharded dim for every leaf JAX
cuts, and a rank's slice equal to the matching cut of the JAX array (JAX's
own shard, or the rank's heads where the port cuts qkv by heads); the cuts
the port adds (the integer qkv site's ``mult`` and ``b``, Swin's
``bias_q``, the per-head multipliers) are exactly those.

Four gloo ranks are spawned once (``comm.spawn``, one thread each) and run
every leg (``parallel.dryrun.run_legs``): the integer path of a calibrated
depth-4 TINY DeiT (int4, and the FQ-ViT int8 through K5) and of the small
Swin of tests/test_parallel.py:134 under dp, tp, dp x tp and ragged batches,
each bit-equal to the port's single-process forward and held to JAX's
``forward_q_int`` by ``_assert_paths_agree``; under tp a rank's qkv holds
H/tp heads and its fc1 and fc2 shards are megatron's; the fake-quant
forward under tp, sp, tp x sp and dp x sp, and item 6's dryrun with its
input gradient, against the single-process port and JAX within JAX's
rtol = atol = 2e-4 with equal argmax.  The share of equal logits is
measured: 100% on these legs (float64 partial sums summed in another order
cross no float32 rounding boundary here); the STE input gradient's share
is ~17%, every element within 5e-12."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffvit_tpu.config import QuantConfig as JaxQuantConfig
from diffvit_tpu.models import swin as jax_swin
from diffvit_tpu.models import swin_int as jax_swin_int
from diffvit_tpu.models import vit as jax_vit
from diffvit_tpu.models import vit_int as jax_vit_int
from diffvit_tpu.parallel import mesh as jax_mesh

from diffvit_tpu_torch import QuantConfig, engine
from diffvit_tpu_torch.models import swin, swin_int, vit, vit_int
from diffvit_tpu_torch.models.convert import (int_model_from_numpy,
                                              swin_int_model_from_numpy)
from diffvit_tpu_torch.ops.bit_types import BIT_TYPE_DICT
from diffvit_tpu_torch.parallel import comm, dryrun
from diffvit_tpu_torch.parallel import mesh as mesh_mod

from test_torch_calibrate import one_torch_thread  # noqa: F401

TINY = vit.ViTSpec("t4", embed_dim=64, depth=4, num_heads=2, num_classes=10)
J_TINY = jax_vit.ViTSpec("t4", embed_dim=64, depth=4, num_heads=2,
                         num_classes=10)
SWIN_KW = dict(embed_dim=32, depths=(1, 1), num_heads=(2, 4), img_size=56,
               num_classes=10)
SWIN = swin.SwinSpec("swin_par", **SWIN_KW)
J_SWIN = jax_swin.SwinSpec("swin_par", **SWIN_KW)
# three heads (as DeiT-T and Swin-T's first stage): tp=2 does not divide
# them, so the attention runs whole on every rank
VIT3 = vit.ViTSpec("t3", embed_dim=96, depth=2, num_heads=3, num_classes=10)
J_VIT3 = jax_vit.ViTSpec("t3", embed_dim=96, depth=2, num_heads=3,
                         num_classes=10)
SWIN3_KW = dict(embed_dim=48, depths=(1, 1), num_heads=(3, 6), img_size=56,
                num_classes=10)
SWIN3 = swin.SwinSpec("swin3", **SWIN3_KW)
J_SWIN3 = jax_swin.SwinSpec("swin3", **SWIN3_KW)
CFG = QuantConfig()
FQVIT = QuantConfig(smoothquant=False, bit_w=BIT_TYPE_DICT["int8"])
RANKS = 4


def _assert_paths_agree(got, ref):
    """tests/test_pallas_attention.py::_assert_paths_agree."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.mean(got == ref) > 0.995, np.mean(got == ref)
    np.testing.assert_allclose(got, ref, atol=0.05)
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


def _calibrated(spec, cfg, seed, size=224):
    mod = swin if isinstance(spec, swin.SwinSpec) else vit
    g = torch.Generator().manual_seed(seed)
    params = mod.init_swin_params(spec, g, "cpu") if mod is swin \
        else mod.init_params(spec, g, "cpu")
    x = np.random.default_rng(seed).standard_normal(
        (2, 3, size, size)).astype(np.float32)
    with torch.inference_mode():
        qp, _ = mod.calibrate(params, spec, cfg, torch.tensor(x))
    return vit_int._host(params), vit_int._host(qp)


def _batch(b, seed, size=224):
    return np.random.default_rng(seed).standard_normal(
        (b, 3, size, size)).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    vp, vq = _calibrated(TINY, CFG, 0)
    fp, fq = _calibrated(TINY, FQVIT, 0)
    sp_, sq = _calibrated(SWIN, CFG, 1, 56)
    v3p, v3q = _calibrated(VIT3, CFG, 5)
    s3p, s3q = _calibrated(SWIN3, CFG, 6, 56)
    return {
        "vit3": ("int", vit_int.prepare_int(v3p, v3q, VIT3, CFG), VIT3, CFG),
        "swin3": ("int", swin_int.prepare_int(s3p, s3q, SWIN3, CFG), SWIN3,
                  CFG),
        "vit3_fake": ("fake", v3p, v3q, VIT3, CFG),
        "vit": ("int", vit_int.prepare_int(vp, vq, TINY, CFG), TINY, CFG),
        "fqvit": ("int", vit_int.prepare_int(fp, fq, TINY, FQVIT), TINY,
                  FQVIT),
        "swin": ("int", swin_int.prepare_int(sp_, sq, SWIN, CFG), SWIN, CFG),
        "vit_fake": ("fake", vp, vq, TINY, CFG),
    }


# a ragged batch is the first 7 images of the full one (JAX runs once)
X8 = _batch(8, 2)
X7 = X8[:7]
S8 = _batch(8, 3, 56)
S7 = S8[:7]
INT_LEGS = [
    ("vit dp=2", "vit", 2, dict(dp=2), X8),
    ("vit tp=2", "vit", 2, dict(dp=1, tp=2), X8),
    ("vit dp=2 tp=2", "vit", 4, dict(dp=2, tp=2), X8),
    ("vit dp=4 ragged", "vit", 4, dict(dp=4), X7),
    ("vit dp=2 tp=2 ragged", "vit", 4, dict(dp=2, tp=2), X7),
    ("fqvit tp=2", "fqvit", 2, dict(dp=1, tp=2), X8),
    ("fqvit dp=2 tp=2", "fqvit", 4, dict(dp=2, tp=2), X7),
    ("swin dp=2", "swin", 2, dict(dp=2), S8),
    ("swin tp=2", "swin", 2, dict(dp=1, tp=2), S8),
    ("swin dp=2 tp=2", "swin", 4, dict(dp=2, tp=2), S8),
    ("swin dp=2 tp=2 ragged", "swin", 4, dict(dp=2, tp=2), S7),
    ("vit3 tp=2", "vit3", 2, dict(dp=1, tp=2), X8),
    ("swin3 dp=2 tp=2", "swin3", 4, dict(dp=2, tp=2), S8),
]
FAKE_LEGS = [
    ("fake tp=2", 2, dict(dp=1, tp=2), False),
    ("fake sp=2", 2, dict(dp=1, sp=2), False),
    ("fake tp=2 sp=2", 4, dict(dp=1, tp=2, sp=2), True),
    ("fake dp=2 sp=2", 4, dict(dp=2, sp=2), False),
    ("fake3 tp=2", 2, dict(dp=1, tp=2), True),
]
X_FAKE = _batch(4, 4)


@pytest.fixture(scope="module")
def ranks(models):
    legs = [dict(name=n, kind="int", n=r, mesh=m, model=k, x=x)
            for n, k, r, m, x in INT_LEGS]
    legs += [dict(name=n, kind="fake", n=r, mesh=m,
                  model="vit3_fake" if n.startswith("fake3") else "vit_fake",
                  x=X_FAKE, grad=g) for n, r, m, g in FAKE_LEGS]
    legs.append(dict(name="dryrun", kind="dryrun", n=RANKS))
    legs.append(dict(name="engine", kind="engine", n=4,
                     mesh=dict(dp=2, tp=2), model="vit_fake", x=X_FAKE[:2],
                     bits=[[4] * vit.num_bit_slots(TINY),
                           [8] * vit.num_bit_slots(TINY),
                           [4, 8] * (vit.num_bit_slots(TINY) // 2)]))
    legs.append(dict(name="shards", kind="shards", n=2, mesh=dict(tp=2),
                     model="vit"))
    out = comm.spawn(dryrun.run_legs, RANKS, "cpu", args=(legs, models),
                     threads=1)
    return {leg["name"]: [r[i] for r in out] for i, leg in enumerate(legs)}


# ---- make_mesh and the megatron rules (no ranks) --------------------------

@pytest.mark.parametrize("kw", [dict(), dict(tp=2), dict(dp=2, pp=4),
                                dict(dp=2, tp=2, pp=2), dict(tp=2, sp=2),
                                dict(dp=2, tp=2, sp=2), dict(pp=8)])
def test_make_mesh_shapes_match_jax(kw):
    assert mesh_mod.mesh_shape(8, **kw) == dict(jax_mesh.make_mesh(8, **kw)
                                                .shape)


def test_make_mesh_assertion_as_jax():
    with pytest.raises(AssertionError, match="mesh 3x2x1x1 != 8"):
        mesh_mod.mesh_shape(8, dp=3, tp=2)
    with pytest.raises(AssertionError, match="mesh 3x2x1x1 != 8"):
        jax_mesh.make_mesh(8, dp=3, tp=2)


class _Layout:
    """A mesh's layout alone (the rules read only ``size``)."""

    def __init__(self, tp):
        self.shape = {"dp": 8 // tp, "tp": tp}

    def size(self, axis):
        return self.shape.get(axis, 1)


# the leaves the port cuts and JAX replicates (or cuts along another dim)
PORT_ONLY = ("qkv.mult", "qkv.b", "bias_q", "mult_h", "bias_h")


def _jax_leaves(tree):
    return {mesh_mod._path_str(tuple(getattr(k, "key", getattr(k, "idx", k))
                                     for k in path)): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree):
    return {mesh_mod._path_str(p): leaf for p, leaf in mesh_mod._leaves(tree)}


def _held_to_jax(port_specs, jax_tree, jax_shardings, port_tree, spec):
    """Leaf by leaf: the sharded dim is JAX's (or a port-only cut), and each
    tp rank's slice is the matching cut of the JAX array.  Returns the
    leaves checked and the port-only cuts."""
    jl, js = _jax_leaves(jax_tree), _jax_leaves(jax_shardings)
    pl, ps = _port_leaves(port_tree), dict(_spec_leaves(port_specs))
    checked, extra = 0, set()
    for path, arr in jl.items():
        if not hasattr(arr, "shape") or path not in pl:
            continue
        jdims = tuple(js[path].spec)
        pdims = ps[path]
        if "tp" in pdims and "tp" not in jdims:
            assert path.endswith(PORT_ONLY), path
            extra.add(path.split(".")[-1])
        else:
            assert ("tp" in pdims) == ("tp" in jdims), path
            if "tp" in jdims:
                assert pdims.index("tp") == jdims.index("tp"), path
        if "tp" in pdims:
            for r in range(2):
                got = mesh_mod.cut(path, np.asarray(arr), pdims, 2, r, spec)
                d, n = pdims.index("tp"), arr.shape[pdims.index("tp")]
                if path.endswith(mesh_mod._HEAD_CUT + ("bias_q", "mult_h",
                                                       "bias_h")):
                    heads = mesh_mod._heads_of(spec, path)
                    want = _head_cut(np.asarray(arr), d, n, heads, r, path)
                else:
                    want = np.take(np.asarray(arr), np.arange(
                        r * n // 2, (r + 1) * n // 2), axis=d)
                np.testing.assert_array_equal(got, want, err_msg=path)
        checked += 1
    return checked, extra


def _head_cut(a, d, n, heads, r, path):
    """The rank's heads along dim ``d``: of each [slot, head, d] block for a
    qkv dim, a plain head range for a heads dim."""
    if n == heads or path.endswith(("bias_q", "mult_h", "bias_h", "_h")):
        return np.take(a, np.arange(r * n // 2, (r + 1) * n // 2), axis=d)
    hd = n // (3 * heads)
    idx = np.arange(n).reshape(3, heads, hd)[:, r * heads // 2:
                                             (r + 1) * heads // 2]
    return np.take(a, idx.reshape(-1), axis=d)


def _spec_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, path + (i,))
    elif isinstance(tree, tuple) and all(isinstance(e, (str, type(None)))
                                         for e in tree):
        yield mesh_mod._path_str(path), tree


@pytest.fixture(scope="module")
def jmesh():
    return jax_mesh.make_mesh(8, tp=2)


def test_param_shardings_match_jax_vit(models, jmesh):
    _, params, _, _, _ = models["vit_fake"]
    port = mesh_mod.param_shardings(_Layout(2), params)
    checked, extra = _held_to_jax(port, params,
                                  jax_mesh.param_shardings(jmesh, params),
                                  params, TINY)
    assert checked == len(_port_leaves(params)) and not extra
    assert port["blocks"][0]["qkv"]["w"] == ("tp", None)
    assert port["blocks"][0]["proj"]["w"] == (None, "tp")
    assert port["patch_embed"]["w"] == ()


def test_param_shardings_match_jax_swin(jmesh):
    params = vit_int._host(swin.init_swin_params(
        SWIN, torch.Generator().manual_seed(1), "cpu"))
    port = mesh_mod.param_shardings(_Layout(2), params)
    checked, extra = _held_to_jax(port, params,
                                  jax_mesh.param_shardings(jmesh, params),
                                  params, SWIN)
    assert checked == len(_port_leaves(params)) and not extra
    assert port["layers"][1]["blocks"][0]["fc2"]["w"] == (None, "tp")


@pytest.mark.parametrize("key", ["vit", "fqvit", "swin"])
def test_int_param_shardings_match_jax(models, jmesh, key):
    _, ip, spec, cfg = models[key]
    conv = swin_int_model_from_numpy if key == "swin" \
        else int_model_from_numpy
    port_ip = conv(ip, spec, "cpu", cfg)
    port = mesh_mod.int_param_shardings(_Layout(2), port_ip)
    checked, extra = _held_to_jax(
        port, ip, jax_mesh.int_param_shardings(jmesh, ip), port_ip, spec)
    assert checked > 20
    # Swin's multipliers and bias_q are the port's own leaves (convert.py)
    want = {"b"} if key == "swin" else {"mult", "b", "mult_h", "bias_h"}
    if key == "fqvit":
        want -= {"mult"}  # SmoothQuant off: one scalar multiplier
    assert extra == want
    if key == "swin":
        blk = port["layers"][0]["blocks"][0]
        assert blk["bias_q"] == ("tp", None, None)
        assert blk["qkv"]["mult"] == ("tp",)


def test_attention_whole_where_tp_does_not_divide_the_heads(models):
    """Swin's first stage of 3 heads under tp=2: its qkv, proj and bias
    stay whole (JAX cuts qkv along its 3C columns and lets GSPMD reshard);
    the second stage's 6 heads are cut; the MLPs are cut in both."""
    _, ip, spec, cfg = models["swin3"]
    port = mesh_mod.int_param_shardings(
        _Layout(2), swin_int_model_from_numpy(ip, spec, "cpu", cfg), spec)
    b0, b1 = (port["layers"][s]["blocks"][0] for s in (0, 1))
    assert b0["qkv"]["w_int"] == b0["proj"]["w_int"] == b0["bias_q"] == ()
    assert b1["qkv"]["w_int"] == (None, "tp")
    assert b1["bias_q"] == ("tp", None, None)
    assert b0["fc1"]["w_int"] == b1["fc1"]["w_int"] == (None, "tp")
    _, params, _, _, _ = models["vit3_fake"]
    vp = mesh_mod.param_shardings(_Layout(2), params, VIT3)
    assert vp["blocks"][0]["qkv"]["w"] == vp["blocks"][0]["proj"]["w"] == ()
    assert vp["blocks"][0]["fc1"]["w"] == ("tp", None)


def test_shards_hold_the_ranks_heads_and_megatron_mlp(ranks):
    """Under tp=2 a rank's K1 weight holds H/tp heads (its heads' columns
    of q, k and v), its fc1 and fc2 shards are megatron's, and the MLP
    gathers them whole (``mesh.GatheredWeight``)."""
    for res in ranks["shards"][:2]:
        c, h, d = TINY.embed_dim, TINY.num_heads, TINY.head_dim
        assert res["qkv"] == [c, 3 * h // 2 * d] and res["qkv_heads"]
        assert res["mult"] == [3 * c // 2]
        assert res["proj"] == [c // 2, c]
        assert res["fc1"] == [c, TINY.hidden_dim // 2]
        assert res["fc2"] == [TINY.hidden_dim // 2, c]
        assert res["gathered"] == [[c, TINY.hidden_dim],
                                   [TINY.hidden_dim, c]]
        assert res["gathered_equal"]


# ---- the integer path on the ranks ---------------------------------------

def _single(models, key, x):
    _, ip, spec, cfg = models[key]
    return engine.IntModel(ip, spec, cfg, "cpu")(x).numpy()


_JAX = {}


J_SPECS = {"vit": J_TINY, "fqvit": J_TINY, "swin": J_SWIN, "vit3": J_VIT3,
           "swin3": J_SWIN3}


def _jax_int(models, key, x):
    """JAX's forward_q_int of the full batch (jitted), cut to ``x``'s
    rows."""
    if key not in _JAX:
        _, ip, spec, cfg = models[key]
        jcfg = JaxQuantConfig.from_dict(cfg.to_dict())
        jspec = J_SPECS[key]
        full = S8 if key.startswith("swin") else X8
        if key.startswith("swin"):
            fn = jax.jit(lambda xin: jax_swin_int.forward_q_int(
                ip, jspec, jcfg, xin))
        else:
            fn = jax.jit(lambda xin: jax_vit_int.forward_q_int(
                ip, jspec, jcfg, xin, use_pallas=False))
        _JAX[key] = np.asarray(fn(jnp.asarray(full)))
    return _JAX[key][:len(x)]


@pytest.mark.parametrize("name,key,n,dims,x", INT_LEGS,
                         ids=[leg[0] for leg in INT_LEGS])
def test_int_path_on_the_mesh_equals_single_process(ranks, models, name,
                                                    key, n, dims, x):
    res = ranks[name]
    assert all(r is None for r in res[n:])  # ranks past the mesh idle
    assert all(r["equal"] for r in res[:n])
    assert all(r["backend"] == "gloo" and not r["host_staged"]
               for r in res[:n])
    got = res[0]["logits"]
    assert got.shape == (len(x), models[key][2].num_classes)
    np.testing.assert_array_equal(got, _single(models, key, x))
    _assert_paths_agree(got, _jax_int(models, key, x))
    for r in res[:n]:
        # on the CPU the wrappers take their plain versions: no launch
        assert not any(r["launches"].values())
        assert (r["bytes"] > 0) == (n > 1)


# ---- the fake-quant path and the dryrun ----------------------------------

def _jax_fake(models, key, x):
    if key not in _JAX:
        _, params, qp, _, cfg = models[key]
        jcfg = JaxQuantConfig.from_dict(cfg.to_dict())
        qpj = {k: jnp.asarray(v) for k, v in qp.items()}
        jspec = J_VIT3 if key == "vit3_fake" else J_TINY
        _JAX[key] = np.asarray(jax.jit(lambda xin: jax_vit.forward_q(
            params, qpj, jspec, jcfg, xin))(jnp.asarray(x)))
    return _JAX[key]


@pytest.mark.parametrize("name,n,dims,grad", FAKE_LEGS,
                         ids=[leg[0] for leg in FAKE_LEGS])
def test_fake_quant_on_the_mesh_within_tolerance(ranks, models, name, n,
                                                 dims, grad):
    res = ranks[name]
    for r in res[:n]:
        # measured: every logit equal to the single process's
        assert r["logits"]["within"] and r["logits"]["argmax_equal"]
        assert r["logits"]["equal_share"] == 1.0
        if grad:
            assert r["grad"]["within"] and r["grad_logits"]["within"]
    got = res[0]["logits_array"]
    want = _jax_fake(models, "vit3_fake" if name.startswith("fake3")
                     else "vit_fake", X_FAKE)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_dryrun_legs_and_gradient_match_jax(ranks):
    """Item 6's dryrun on four ranks (dp=2 x tp=2, the tp=2 x pp=2
    pipeline leg): its losses, its fake-quant logits and input gradients
    against the single process (checked in the ranks) and JAX's."""
    res = ranks["dryrun"][0]
    assert res["mesh"] == {"dp": 2, "tp": 2}
    assert res["pp_legs"] == ["pp=2,dp=1,tp=2,b=4,pad=0"]
    assert np.isfinite(res["int_loss"]) and np.isfinite(res["swin_int"])
    # JAX's input gradient through rounding is exactly 0, as the port's
    assert not res["grad_round_array"].any()
    assert res["grad_ste"]["within"] and res["grad_ste"]["equal_share"] > 0.1
    spec = jax_vit.ViTSpec("dryrun", embed_dim=64, depth=4, num_heads=2,
                           num_classes=16)
    params = vit_int._host(vit.init_params(dryrun.DRY_SPEC,
                                           torch.Generator().manual_seed(0),
                                           "cpu"))
    x = np.random.default_rng(0).standard_normal(
        (4, 3, 224, 224)).astype(np.float32)
    q = engine.QuantizedViT(dryrun.DRY_SPEC, CFG, params=params,
                            device="cpu")
    with torch.inference_mode():
        q.calibrate(x)
    qp = {k: jnp.asarray(v.numpy()) for k, v in q.qparams.items()}
    labels = jnp.arange(4) % 16

    def loss_fn(xin, ste):
        logits = jax_vit.forward_q(params, qp, spec, JaxQuantConfig(), xin,
                                   ste=ste)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], 1))

    grad = jax.jit(jax.grad(loss_fn), static_argnums=1)
    for ste, tag in ((False, "round"), (True, "ste")):
        g = np.asarray(grad(jnp.asarray(x), ste))
        np.testing.assert_allclose(res[f"grad_{tag}_array"], g, rtol=2e-4,
                                   atol=2e-4)
    np.testing.assert_allclose(res["logits_ste_array"],
                               res["logits_round_array"])


def test_collectives_backward_match_single_process_gradient(ranks):
    """Each autograd collective's backward, checked in the ranks by the
    STE gradient of the tp x sp leg (enter/reduce over tp, the sp split,
    K/V gather and the final gather) against the single process's."""
    for r in ranks["fake tp=2 sp=2"]:
        assert r["grad"]["within"], r["grad"]
        assert r["grad"]["max_abs_diff"] < 1e-9


def test_quantized_vit_on_the_mesh_equals_single_process(ranks):
    """QuantizedViT(mesh=) on dp=2 x tp=2: calibration on the whole batch
    gives every rank the single process's qparams, bias correction its
    params; forward_bits cuts 3 candidates over dp (the last repeated to
    4) and every rank gets all 3, within JAX's tolerance of one process."""
    for r in ranks["engine"]:
        assert r["qparams_equal"] and r["params_equal"]
        assert r["bits_shape"] == [3, 2, TINY.num_classes]
        assert r["bits"]["within"] and r["bits"]["argmax_equal"]
        assert r["logits"]["within"] and r["logits"]["argmax_equal"]

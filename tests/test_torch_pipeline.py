"""The port's pipeline parallelism (``diffvit_tpu_torch/parallel/
pipeline.py``) against its single-process integer forward and JAX's
``forward_q_int_pp``, on the CPU.

Four gloo ranks are spawned once (``comm.spawn``, one thread each) and run
every leg (``parallel.dryrun.run_legs``) on a calibrated depth-4 TINY DeiT:
pp=2, pp=4, dp=2 x pp=2, tp=2 x pp=2 (the codes wire: int8 codes between
stages), ragged batches, and the FQ-ViT int8 (SmoothQuant off: the float32
wire, K5).  Each leg's logits equal the single-process forward bit for bit
and JAX's ``forward_q_int_pp`` on ``make_mesh(4, dp=2, pp=2)`` of the 8
virtual devices (its codes wire, the Pallas kernels in interpret mode), bit
for bit too.  The refusals are JAX's: -1 sites and a depth that pp does not
divide (``prepare_pp``), a Swin, ``resident`` or ``microbatch`` under pp,
sp with pp, ``resident`` under any mesh, and ``forward_bits_int`` under a
mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffvit_tpu.config import QuantConfig as JaxQuantConfig
from diffvit_tpu.models import vit as jax_vit
from diffvit_tpu.parallel import mesh as jax_mesh
from diffvit_tpu.parallel import pipeline as jax_pipeline

from diffvit_tpu_torch import QuantConfig, engine
from diffvit_tpu_torch.models import swin, vit, vit_int
from diffvit_tpu_torch.models.convert import int_model_from_numpy
from diffvit_tpu_torch.ops.bit_types import BIT_TYPE_DICT
from diffvit_tpu_torch.parallel import comm, dryrun, pipeline
from diffvit_tpu_torch.parallel import mesh as mesh_mod
from diffvit_tpu_torch.testing import random_int_model, random_swin_int_model

from test_torch_calibrate import one_torch_thread  # noqa: F401

TINY = vit.ViTSpec("pp_tiny", embed_dim=64, depth=4, num_heads=2,
                   num_classes=10)
J_TINY = jax_vit.ViTSpec("pp_tiny", embed_dim=64, depth=4, num_heads=2,
                         num_classes=10)
CFG = QuantConfig()
FQVIT = QuantConfig(smoothquant=False, bit_w=BIT_TYPE_DICT["int8"])
X8 = np.random.default_rng(2).standard_normal(
    (8, 3, 224, 224)).astype(np.float32)
X7 = X8[:7]
X4 = X8[:4]
LEGS = [
    ("pp=2", "vit", 2, dict(dp=1, pp=2), X8),
    ("pp=4", "vit", 4, dict(dp=1, pp=4), X8),
    ("pp=4 ragged", "vit", 4, dict(dp=1, pp=4), X7),
    ("dp=2 pp=2", "vit", 4, dict(dp=2, pp=2), X8),
    ("dp=2 pp=2 b=4", "vit", 4, dict(dp=2, pp=2), X4),
    ("dp=2 pp=2 ragged", "vit", 4, dict(dp=2, pp=2), X7),
    ("tp=2 pp=2", "vit", 4, dict(dp=1, tp=2, pp=2), X8),
    ("fqvit pp=2", "fqvit", 2, dict(dp=1, pp=2), X8),
    ("fqvit tp=2 pp=2 ragged", "fqvit", 4, dict(dp=1, tp=2, pp=2), X7),
]


def _calibrated_bake(cfg):
    params = vit.init_params(TINY, torch.Generator().manual_seed(0), "cpu")
    x = np.random.default_rng(0).standard_normal(
        (2, 3, 224, 224)).astype(np.float32)
    with torch.inference_mode():
        qp, _ = vit.calibrate(params, TINY, cfg, torch.tensor(x))
    return vit_int.prepare_int(params, qp, TINY, cfg)


@pytest.fixture(scope="module")
def models():
    return {"vit": ("int", _calibrated_bake(CFG), TINY, CFG),
            "fqvit": ("int", _calibrated_bake(FQVIT), TINY, FQVIT)}


@pytest.fixture(scope="module")
def ranks(models):
    legs = [dict(name=n, kind="int", n=r, mesh=m, model=k, x=x)
            for n, k, r, m, x in LEGS]
    out = comm.spawn(dryrun.run_legs, 4, "cpu", args=(legs, models),
                     threads=1)
    return {leg["name"]: [r[i] for r in out] for i, leg in enumerate(legs)}


@pytest.fixture(scope="module")
def jax_pp(models):
    """JAX's pipeline on make_mesh(4, dp=2, pp=2) of the virtual devices:
    the codes wire through the interpret-mode Pallas kernels."""
    _, ip, _, _ = models["vit"]
    m = jax_mesh.make_mesh(4, dp=2, pp=2)
    plan = jax_pipeline.plan_shardings(m, jax_pipeline.prepare_pp(
        ip, J_TINY, JaxQuantConfig(), 2, use_pallas=True))
    assert plan["codes_mode"]
    fn = jax.jit(lambda xin: jax_pipeline.forward_q_int_pp(
        ip, plan, J_TINY, JaxQuantConfig(), xin, m, n_micro=2,
        pallas_interpret=True))
    with m:
        return np.asarray(fn(jnp.asarray(X4)))


@pytest.mark.parametrize("name,key,n,dims,x", LEGS,
                         ids=[leg[0] for leg in LEGS])
def test_pipeline_equals_single_process(ranks, models, name, key, n, dims,
                                        x):
    res = ranks[name]
    assert all(r["equal"] for r in res[:n]) and all(r is None
                                                    for r in res[n:])
    _, ip, spec, cfg = models[key]
    want = engine.IntModel(ip, spec, cfg, "cpu")(x).numpy()
    np.testing.assert_array_equal(res[0]["logits"], want)
    # every stage sends; the logits reach every rank of its pipeline
    assert all(r["bytes"] > 0 for r in res[:n])


def test_pipeline_equals_jax_pipeline(ranks, jax_pp):
    np.testing.assert_array_equal(ranks["dp=2 pp=2 b=4"][0]["logits"],
                                  jax_pp)


def test_prepare_pp_plan(models):
    _, ip, spec, cfg = models["vit"]
    conv = int_model_from_numpy(ip, spec, "cpu", cfg)
    plan = pipeline.prepare_pp(conv, spec, cfg, 2)
    assert plan["codes_mode"] and plan["lps"] == 2 and plan["pp"] == 2
    assert len(plan["lis_fast"]) == len(plan["lis_wide"]) == 4
    _, ip8, _, fq = models["fqvit"]
    assert not pipeline.prepare_pp(int_model_from_numpy(ip8, spec, "cpu", fq),
                                   spec, fq, 4)["codes_mode"]


def test_prepare_pp_refuses_float_sites_and_uneven_depth():
    bc = (8,) + (4, -1, 4, 4) + (4,) * 12 + (8,)
    ip = int_model_from_numpy(random_int_model(TINY, CFG, 0, bc), TINY,
                              "cpu", CFG)
    with pytest.raises(ValueError, match="-1"):
        pipeline.prepare_pp(ip, TINY, CFG, 2)
    ip = int_model_from_numpy(random_int_model(TINY, CFG, 0), TINY, "cpu",
                              CFG)
    with pytest.raises(ValueError, match="not divisible by pp=3"):
        pipeline.prepare_pp(ip, TINY, CFG, 3)


def _layout(**dims):
    """A mesh's layout, for the refusals made before any collective."""
    shape = mesh_mod.mesh_shape(int(np.prod(list(dims.values()))), **dims)
    return mesh_mod.Mesh(shape, {a: 0 for a in mesh_mod.AXES}, {},
                         comm.World(0, 1, torch.device("cpu"), "gloo"))


SWIN = swin.SwinSpec("s", embed_dim=32, depths=(2, 2), num_heads=(2, 4),
                     img_size=56, num_classes=10)


@pytest.mark.parametrize("case", ["swin", "resident", "microbatch", "sp",
                                  "mesh_resident", "mesh_microbatch"])
def test_int_model_refusals_as_jax(case):
    ip = random_int_model(TINY, CFG, 0)
    pp2, dp2 = _layout(dp=1, pp=2), _layout(dp=2)
    kw, match = {
        "swin": (dict(mesh=pp2), "ViT family"),
        "resident": (dict(mesh=pp2, resident=True), "ViT family"),
        "microbatch": (dict(mesh=pp2, microbatch=2), "single-chip"),
        "sp": (dict(mesh=_layout(dp=1, sp=2, pp=2)), "not sp"),
        "mesh_resident": (dict(mesh=dp2, resident=True), "single chip"),
        "mesh_microbatch": (dict(mesh=dp2, microbatch=2), "single-chip"),
    }[case]
    spec = TINY
    if case == "swin":
        ip, spec = random_swin_int_model(SWIN, CFG, 0), SWIN
    with pytest.raises(ValueError, match=match):
        engine.IntModel(ip, spec, CFG, "cpu", **kw)


def test_forward_bits_int_refuses_a_mesh():
    params = vit.init_params(TINY, torch.Generator().manual_seed(0), "cpu")
    q = engine.QuantizedViT(TINY, CFG, params=params, device="cpu",
                            mesh=_layout(dp=2))
    q.qparams = {}
    with pytest.raises(NotImplementedError, match="single-chip"):
        q.forward_bits_int(X4, (4,) * vit.num_bit_slots(TINY))

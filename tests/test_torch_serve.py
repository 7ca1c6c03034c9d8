"""The port's resident serving path (K6) and K1's float-softmax branch vs
the JAX package, on the CPU.

``resident_codes_plain`` is held against the interpret-mode Pallas
``resident_codes`` on the same packed model, the port's
``forward_q_int_serve`` against JAX's and against the port's own
``forward_q_int`` (the codes path it replaces: equal bit for bit), on the
calibrated TINY spec of tests/test_serve_kernel.py.  The rule between two
forwards is the JAX suite's own (tests/test_pallas_attention.py::
_assert_paths_agree): more than 99.5% of logits equal, atol 0.05, equal
argmax."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffvit_tpu.config import QuantConfig as JaxQuantConfig
from diffvit_tpu.engine import QuantizedViT
from diffvit_tpu.engine import load_int_model as jax_load_int_model
from diffvit_tpu.models import vit, vit_int as jax_vit_int
from diffvit_tpu.ops.bit_types import BIT_TYPE_DICT as JAX_BITS
from diffvit_tpu.ops.pallas.attention import \
    fused_qkv_attention_v2 as jax_attention
from diffvit_tpu.ops.pallas.serve import prepare_resident as jax_prepare
from diffvit_tpu.ops.pallas.serve import resident_codes as jax_resident

from diffvit_tpu_torch import QuantConfig, engine
from diffvit_tpu_torch.models import vit_int
from diffvit_tpu_torch.models.convert import (attn_constants,
                                              int_model_from_numpy)
from diffvit_tpu_torch.models.swin import SwinSpec
from diffvit_tpu_torch.models.vit import VIT_SPECS, ViTSpec
from diffvit_tpu_torch.ops.kernels.attention import fused_qkv_attention_v2
from diffvit_tpu_torch.ops.kernels.serve import (prepare_resident,
                                                 resident_codes)
from diffvit_tpu_torch.testing import random_int_model, random_swin_int_model

from test_torch_calibrate import one_torch_thread  # noqa: F401

TINY = vit.ViTSpec("test_tiny", embed_dim=64, depth=2, num_heads=2,
                   num_classes=10)
PTINY = ViTSpec("test_tiny", embed_dim=64, depth=2, num_heads=2,
                num_classes=10)
N_SLOTS = vit.num_bit_slots(TINY)
N, NPAD = 197, 200
JAX_CFGS = {"default": JaxQuantConfig(), "lis_off": JaxQuantConfig(lis=False)}


def _port_cfg(jcfg):
    return QuantConfig.from_dict(jcfg.to_dict())


def _assert_paths_agree(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.mean(got == ref) > 0.995, np.mean(got == ref)
    np.testing.assert_allclose(got, ref, atol=0.05)
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


def _assert_codes_close(got, want, lis):
    """The LIS: >= 99.9% of codes equal and max |diff| <= 1, exact where it
    holds (it holds on these inputs); the float softmax (bfloat16 weights,
    order-dependent float32 sums in the reference): within 1 code on fewer
    than 2% of codes (tests/test_torch_fqvit.py::_assert_codes_close)."""
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    diff = np.abs(got - want)
    if lis:
        np.testing.assert_array_equal(got, want)
        assert np.mean(diff == 0) >= 0.999
    assert diff.max() <= 1 and np.mean(diff > 0) < 0.02, \
        (diff.max(), np.mean(diff > 0))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 3, 224, 224)).astype(np.float32)
    codes = np.zeros((2, NPAD, TINY.embed_dim), np.int8)
    codes[:, :N] = np.clip(np.round(rng.standard_normal((2, N, 64)) * 30),
                           -128, 127)
    return x, codes.reshape(-1, TINY.embed_dim)


@pytest.fixture(scope="module")
def calibrated(inputs):
    """name -> (params, qp) of TINY calibrated by JAX under JAX_CFGS[name],
    each calibrated once."""
    cache = {}

    def get(name):
        if name not in cache:
            params = vit.init_params(TINY, jax.random.PRNGKey(0))
            cache[name] = (params, vit.calibrate(
                params, TINY, JAX_CFGS[name], jnp.asarray(inputs[0][:2]))[0])
        return cache[name]
    return get


def _baked(calibrated, name, bit_config):
    params, qp = calibrated(name)
    return jax.device_get(jax_vit_int.prepare_int(
        params, qp, TINY, JAX_CFGS[name], tuple(bit_config)))


def _port_model(ip_np, name="default", spec=PTINY):
    cfg = _port_cfg(JAX_CFGS[name])
    return int_model_from_numpy(ip_np, spec, "cpu", cfg), cfg


BIT_CONFIGS = {"int4": (4,) * N_SLOTS, "int8": (8,) * N_SLOTS,
               "mixed": (8,) + (4, 8) * (2 * TINY.depth) + (8,)}


# ---- K6: the resident kernel ----

@pytest.mark.parametrize("lis", [True, False], ids=["lis", "softmax"])
@pytest.mark.parametrize("bits", sorted(BIT_CONFIGS))
def test_resident_plain_matches_pallas(calibrated, inputs, bits, lis):
    """The port's packing equals JAX's array for array, and its plain
    kernel the interpret-mode Pallas kernel on two zero-padded images (the
    JAX caller pads each image's rows to a multiple of 8)."""
    ip_np = _baked(calibrated, "default", BIT_CONFIGS[bits])
    packed_j = jax_prepare(ip_np, TINY, JAX_CFGS["default"])
    ip, cfg = _port_model(ip_np)
    packed = prepare_resident(ip, PTINY, cfg)
    for k, v in packed.items():
        if k == "lis_fast":
            assert v == packed_j[k]
        else:
            np.testing.assert_array_equal(v.numpy(), np.asarray(packed_j[k]))
    x = inputs[1]
    want = np.asarray(jax_resident(packed_j, jnp.asarray(x), n_real=N,
                                   bits=4, lis=lis, nelems=2,
                                   interpret=True))
    got = resident_codes(packed, torch.tensor(x), n_real=N, bits=4, lis=lis,
                         nelems=2)
    assert got.shape == x.shape and got.dtype == torch.int8
    real = lambda a: np.asarray(a).reshape(2, NPAD, -1)[:, :N]  # noqa: E731
    _assert_codes_close(real(got.numpy()), real(want), lis)


@pytest.mark.parametrize("batch", [1, 2])
def test_serve_forward_matches_jax(calibrated, inputs, batch):
    ip_np = _baked(calibrated, "default", (4,) * N_SLOTS)
    x = inputs[0][:batch]
    want = jax_vit_int.forward_q_int_serve(ip_np, TINY, JAX_CFGS["default"],
                                           jnp.asarray(x),
                                           pallas_interpret=True)
    ip, cfg = _port_model(ip_np)
    got = vit_int.forward_q_int_serve(ip, PTINY, cfg, torch.tensor(x))
    assert got.shape == (batch, TINY.num_classes)
    _assert_paths_agree(got.numpy(), want)


def _serve_equals_codes_path(ip, spec, cfg, x):
    x = torch.tensor(x)
    got = vit_int.forward_q_int_serve(ip, spec, cfg, x)
    want = vit_int.forward_q_int(ip, spec, cfg, x)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    return got


def test_serve_forward_equals_codes_path_tiny(calibrated, inputs):
    ip, cfg = _port_model(_baked(calibrated, "default", BIT_CONFIGS["mixed"]))
    _serve_equals_codes_path(ip, PTINY, cfg, inputs[0][:2])


def test_serve_forward_equals_codes_path_deit_width():
    """DeiT-S width (384, 6 heads of 64, hidden 1536), 2 blocks, int8
    input codes."""
    spec = dataclasses.replace(VIT_SPECS["deit_small"], depth=2)
    cfg = QuantConfig()
    ip = int_model_from_numpy(random_int_model(spec, cfg, seed=5), spec,
                              "cpu", cfg)
    x = np.random.default_rng(3).integers(-60, 60, (2, 3, 224, 224)) \
        .astype(np.int8)
    got = _serve_equals_codes_path(ip, spec, cfg, x)
    assert not torch.equal(got[0], got[1])


def test_serve_microbatch_chunks_equal_one_launch(calibrated, inputs):
    """B=3 at most 2 images a launch (launches of 2 and 1, no padding):
    the same logits as one launch of 3."""
    ip, cfg = _port_model(_baked(calibrated, "default", (4,) * N_SLOTS))
    packed = prepare_resident(ip, PTINY, cfg)
    x = torch.tensor(inputs[0])
    whole = vit_int.forward_q_int_serve(ip, PTINY, cfg, x, packed=packed,
                                        microbatch=None)
    chunked = vit_int.forward_q_int_serve(ip, PTINY, cfg, x, packed=packed,
                                          microbatch=2)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)
    assert resident_codes.launches == 0  # no kernel on the CPU


@pytest.mark.parametrize("b,most", [(1, 64), (50, 64), (64, 64), (65, 64),
                                    (256, 64), (300, 64), (7, 2), (5, 1)])
def test_even_split(b, most):
    """The resident forward's launches: ceil(b / most) of them, each at
    most ``most``, sizes within one of each other, summing to b (no image
    padded)."""
    sizes = vit_int.even_split(b, most)
    assert sum(sizes) == b
    assert len(sizes) == -(-b // most)
    assert max(sizes) <= most and max(sizes) - min(sizes) <= 1
    assert sizes == sorted(sizes, reverse=True)


@pytest.mark.parametrize("name", ["test_tiny", "deit_small", "deit_base"])
@pytest.mark.parametrize("b", [1, 8, 50, 65, 256, 1000])
def test_k6_launches_hold_the_scratch_cap(name, b):
    """The default cut is the fewest launches whose K6 scratch stays within
    K6_SCRATCH_BYTES at the model's widths (128 DeiT-S images a launch);
    an int ``microbatch`` cuts at that many images, None makes one
    launch."""
    spec = PTINY if name == "test_tiny" else VIT_SPECS[name]
    n, c, hid = spec.seq_len, spec.embed_dim, spec.hidden_dim
    per_image = n * (5 * c + hid)
    sizes = vit_int.k6_launches(b, n, c, hid)
    assert sizes == vit_int.even_split(b, max(sizes))
    assert max(sizes) * per_image <= vit_int.K6_SCRATCH_BYTES
    if len(sizes) > 1:  # one launch fewer would not fit
        assert -(-b // (len(sizes) - 1)) * per_image \
            > vit_int.K6_SCRATCH_BYTES
    if name == "deit_small":
        assert sizes == vit_int.even_split(b, 128)
    assert vit_int.k6_launches(b, n, c, hid, microbatch=8) == \
        vit_int.even_split(b, 8)
    assert vit_int.k6_launches(b, n, c, hid, microbatch=None) == [b]


@pytest.fixture(scope="module")
def tiny_resident():
    """TINY's seeded random int4 bake, packed, with int8 input codes of 7
    images and the logits of each leading batch in one launch."""
    cfg = QuantConfig()
    ip = int_model_from_numpy(random_int_model(PTINY, cfg, seed=7), PTINY,
                              "cpu", cfg)
    packed = prepare_resident(ip, PTINY, cfg)
    x = torch.tensor(np.random.default_rng(3).integers(
        -60, 60, (7, 3, 224, 224)).astype(np.int8))
    whole = {b: vit_int.forward_q_int_serve(ip, PTINY, cfg, x[:b],
                                            packed=packed, microbatch=None)
             for b in (1, 3, 5, 7)}
    return ip, cfg, packed, x, whole


@pytest.mark.parametrize("microbatch", ["default", "default_cap2", 1, 2, 3,
                                        4])
@pytest.mark.parametrize("batch", [1, 3, 5, 7])
def test_serve_launch_sizes_equal_one_launch(tiny_resident, monkeypatch,
                                             batch, microbatch):
    """The default cut (and with K6_SCRATCH_BYTES at two TINY images, so
    that it cuts these batches) and explicit ``microbatch`` values: K6 runs
    on :func:`vit_int.k6_launches`' sizes, no zero image among them, and
    the logits equal one launch's bit for bit."""
    ip, cfg, packed, x, whole = tiny_resident
    n, c, hid = PTINY.seq_len, PTINY.embed_dim, PTINY.hidden_dim
    if microbatch == "default_cap2":
        monkeypatch.setattr(vit_int, "K6_SCRATCH_BYTES",
                            2 * n * (5 * c + hid))
    kw = {} if isinstance(microbatch, str) else dict(microbatch=microbatch)
    launched = []

    def counted(packed, codes, *, nelems, **rest):
        launched.append(nelems)
        assert codes.reshape(nelems, n, c).flatten(1).any(1).all()
        return resident_codes(packed, codes, nelems=nelems, **rest)

    monkeypatch.setattr(vit_int, "resident_codes", counted)
    got = vit_int.forward_q_int_serve(ip, PTINY, cfg, x[:batch],
                                      packed=packed, **kw)
    assert launched == vit_int.k6_launches(batch, n, c, hid, **kw)
    if microbatch == "default_cap2":
        assert launched == vit_int.even_split(batch, 2)
    torch.testing.assert_close(got, whole[batch], rtol=0, atol=0)
    if batch > 1:
        assert not torch.equal(got[0], got[-1])


def _refusals():
    """(name, QuantConfig kwargs, model edit, match)."""
    bc = [4] * N_SLOTS
    bc[1] = -1  # block 0 qkv
    return [
        ("fp_site", {}, dict(bit_config=tuple(bc)), "fp"),
        ("float_norm", {"ptf": False}, {}, "int_norm"),
        ("smoothquant_off", {"smoothquant": False}, {}, "int_norm"),
        ("asymmetric", {}, {"sym_acts": False}, "sym_acts"),
        ("uint8_acts", {"bit_a": "uint8"}, {}, "int8 activations"),
    ]


@pytest.mark.parametrize("name,cfg_kw,edit,match", _refusals(),
                         ids=[r[0] for r in _refusals()])
def test_prepare_resident_refuses_as_jax(name, cfg_kw, edit, match):
    """Each refusal of the JAX ``prepare_resident`` is the port's, with the
    same key words, on the same int-model."""
    kw = {k: JAX_BITS[v] if k == "bit_a" else v for k, v in cfg_kw.items()}
    jcfg = JaxQuantConfig(**kw)
    cfg = _port_cfg(jcfg)
    ip_np = random_int_model(PTINY, cfg, seed=1,
                             bit_config=edit.get("bit_config"))
    if "sym_acts" in edit:
        ip_np["sym_acts"] = edit["sym_acts"]
    with pytest.raises(ValueError, match=match):
        jax_prepare(ip_np, TINY, jcfg)
    ip = int_model_from_numpy(ip_np, PTINY, "cpu", cfg)
    with pytest.raises(ValueError, match=match):
        prepare_resident(ip, PTINY, cfg)
    if name == "fp_site":
        with pytest.raises(ValueError, match=match):
            engine.IntModel(ip_np, PTINY, cfg, "cpu", resident=True)


def test_resident_refuses_swin():
    spec = SwinSpec("s", embed_dim=32, depths=(2, 1), num_heads=(2, 4),
                    img_size=56, num_classes=10)
    with pytest.raises(ValueError, match="ViT"):
        engine.IntModel(random_swin_int_model(spec), spec, QuantConfig(),
                        "cpu", resident=True)


def test_jax_artifact_served_resident(calibrated, inputs, tmp_path):
    """A JAX ``save_int_model`` artifact, served resident by both engines
    (JAX in interpret mode on the CPU)."""
    params, qp = calibrated("default")
    m = QuantizedViT(TINY, JAX_CFGS["default"], params=params)
    m.qparams = qp
    path = str(tmp_path / "tiny.npz")
    m.save_int_model(path)
    pixels = np.random.default_rng(4).integers(0, 256, (2, 3, 224, 224),
                                               dtype=np.uint8)
    served = engine.load_int_model(path, "cpu", resident=True)
    assert served.packed is not None
    got = served(pixels).numpy()
    want = np.asarray(jax_load_int_model(path, resident=True)(pixels))
    _assert_paths_agree(got, want)
    np.testing.assert_array_equal(
        got, engine.load_int_model(path, "cpu")(pixels).numpy())


# ---- K1's float-softmax branch ----

def test_qkv_attention_float_softmax_plain_matches_pallas(inputs):
    ib = random_int_model(PTINY, seed=3)["blocks"][0]
    scalars, _ = attn_constants(ib, PTINY, 0, lis=False)
    x = inputs[1].reshape(2, NPAD, -1)
    q = ib["qkv"]
    kw = dict(num_heads=2, head_dim=32, n_real=N, bits=8, lis=False)
    want = np.asarray(jax_attention(
        jnp.asarray(x), jnp.asarray(q["w_int"]), jnp.asarray(q["mult"]),
        jnp.asarray(q["b"]), jnp.asarray(scalars), interpret=True, **kw))
    got = fused_qkv_attention_v2(torch.tensor(x), torch.tensor(q["w_int"]),
                                 torch.tensor(q["mult"]),
                                 torch.tensor(q["b"]), torch.tensor(scalars),
                                 **kw)
    assert got.shape == (2, 2, NPAD, 32)
    _assert_codes_close(got.numpy()[:, :, :N], want[:, :, :N], lis=False)


@pytest.mark.parametrize("wire", ["codes", "f32"])
def test_float_softmax_forward_matches_jax(calibrated, inputs, wire):
    """QuantConfig(lis=False) with PTF and SmoothQuant on: K1 with the
    float softmax and K2, no K5 (``vit_int.py:360-365``)."""
    ip_np = _baked(calibrated, "lis_off", (4,) * N_SLOTS)
    jcfg = JAX_CFGS["lis_off"]
    if wire == "codes":
        pixels = np.random.default_rng(5).integers(
            0, 256, (2, 3, 224, 224), dtype=np.uint8)
        x = engine.IntModel(ip_np, PTINY, _port_cfg(jcfg), "cpu") \
            .encode(pixels)
    else:
        x = inputs[0][:2]
    want = jax_vit_int.forward_q_int(ip_np, TINY, jcfg, jnp.asarray(x),
                                     use_pallas=True, pallas_interpret=True)
    ip, cfg = _port_model(ip_np, "lis_off")
    got = vit_int.forward_q_int(ip, PTINY, cfg, torch.tensor(x)).numpy()
    assert np.isfinite(got).all() and got.shape == (2, TINY.num_classes)
    _assert_paths_agree(got, want)
    resident = vit_int.forward_q_int_serve(ip, PTINY, cfg, torch.tensor(x))
    np.testing.assert_array_equal(resident.numpy(), got)

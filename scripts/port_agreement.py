"""How far the PyTorch port's integer ViT and Swin forwards agree with the
JAX ones, on the CPU, for every branch of ``forward_q_int``.

    JAX_PLATFORMS=cpu python scripts/port_agreement.py [--images 8]
        [--family vit|swin|all]

JAX calibrates the TINY spec of tests/test_int_path.py once per
QuantConfig and bakes it with ``prepare_int``; both forwards run the same
numpy int-model (JAX with the Pallas kernels in interpret mode, the port
with its plain kernel versions) on the same seeded inputs.  Seeded random
int-models (``diffvit_tpu_torch.testing.random_int_model``) run too.  Then
K5 (``fused_int_attention``): the port's plain version against the
interpret-mode Pallas kernel.  One JSON line per case: the share of equal
logits (or int8 codes), the largest |diff| and whether the argmax agrees.
tests/test_torch_fqvit.py asserts the rule on two images; this script
measures the shares.

The Swin table (``--family swin``) does the same on the TINY Swin of
tests/test_torch_swin.py (embed 32, depths (2, 1), 56 px): the codes path,
float LayerNorm, the float32 stream, the float softmax through K4 and K4b,
``input_quant=False`` and a mixed {4, 8} bit config, calibrated and random;
then K4 and K4b with ``lis=False``: the port's plain version against the
interpret-mode Pallas kernels on a shifted and an unshifted block.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from diffvit_tpu.config import QuantConfig as JaxQuantConfig  # noqa: E402
from diffvit_tpu.data.imagenet import input_code_lut  # noqa: E402
from diffvit_tpu.models import swin as jswin  # noqa: E402
from diffvit_tpu.models import swin_int as jax_swin_int  # noqa: E402
from diffvit_tpu.models import vit, vit_int as jax_vit_int  # noqa: E402
from diffvit_tpu.ops.pallas import attention as jax_attention  # noqa: E402
from diffvit_tpu.ops.bit_types import BIT_TYPE_DICT as JAX_BITS  # noqa: E402
from diffvit_tpu.ops.pallas.attention import \
    fused_int_attention as jax_int_attention  # noqa: E402

from diffvit_tpu_torch import QuantConfig  # noqa: E402
from diffvit_tpu_torch.models import swin, swin_int, vit_int  # noqa: E402
from diffvit_tpu_torch.models.convert import (  # noqa: E402
    int_attn_scalars, int_model_from_numpy, swin_block_constants,
    swin_int_model_from_numpy)
from diffvit_tpu_torch.models.vit import VIT_SPECS, ViTSpec  # noqa: E402
from diffvit_tpu_torch.ops.kernels.attention import \
    fused_int_attention  # noqa: E402
from diffvit_tpu_torch.ops.kernels.swin_attention import (  # noqa: E402
    fused_swin_attention, fused_swin_attention_v2)
from diffvit_tpu_torch.testing import (random_int_model,  # noqa: E402
                                       random_swin_int_model)

TINY = vit.ViTSpec("test_tiny", embed_dim=64, depth=2, num_heads=2,
                   num_classes=10)
NO_INPUT_Q = vit.ViTSpec("test_niq", embed_dim=64, depth=1, num_heads=2,
                         num_classes=10, input_quant=False)
CFGS = {
    "default": JaxQuantConfig(),
    "sq_off": JaxQuantConfig(smoothquant=False),
    "legacy": JaxQuantConfig(ptf=False, lis=False, smoothquant=False),
    "ptf_off": JaxQuantConfig(ptf=False),
}


def port_spec(spec):
    return ViTSpec(spec.name, embed_dim=spec.embed_dim, depth=spec.depth,
                   num_heads=spec.num_heads, num_classes=spec.num_classes,
                   input_quant=spec.input_quant)


def compare(case, got, want, **extra):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rec = dict(case=case, n=int(got.size), equal=float(np.mean(got == want)),
               max_abs_diff=float(np.abs(got - want).max()), **extra)
    if got.ndim == 2:
        rec["argmax_equal"] = bool((got.argmax(1) == want.argmax(1)).all())
    print(json.dumps(rec), flush=True)


def forwards(case, ip_np, spec, jcfg, x):
    want = jax_vit_int.forward_q_int(ip_np, spec, jcfg, jnp.asarray(x),
                                     use_pallas=True, pallas_interpret=True)
    cfg, pspec = QuantConfig.from_dict(jcfg.to_dict()), port_spec(spec)
    ip = int_model_from_numpy(ip_np, pspec, "cpu", cfg)
    got = vit_int.forward_q_int(ip, pspec, cfg, torch.tensor(x))
    compare(case, got.numpy(), np.asarray(want))


def codes_of(ip, pixels):
    lut = input_code_lut(np.asarray(ip["qact_input"]["scale"]),
                         np.asarray(ip["qact_input"]["zp"]))
    return np.stack([lut[c][pixels[:, c]] for c in range(3)], 1)


SWIN_KW = dict(embed_dim=32, depths=(2, 1), num_heads=(2, 4), img_size=56,
               num_classes=10)


def swin_table(images):
    """The Swin forwards and K4/K4b's float softmax (see the module's
    docstring)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((images, 3, 56, 56)).astype(np.float32)
    pixels = rng.integers(0, 256, x.shape, dtype=np.uint8)
    specs = {q: (jswin.SwinSpec("swin_test2", input_quant=q, **SWIN_KW),
                 swin.SwinSpec("swin_test2", input_quant=q, **SWIN_KW))
             for q in (True, False)}
    n = swin.num_bit_slots(specs[True][1])
    mixed = tuple([8, 4] * (n // 2) + [8] * (n % 2))
    default, ptf_off = JaxQuantConfig(), JaxQuantConfig(ptf=False)
    lis_off = JaxQuantConfig(lis=False)
    # (case, input_quant, config, bit config, sym_acts, attn_v2, wires)
    cases = [
        ("codes path", True, default, 4, True, False, ("codes", "f32")),
        ("float_ln", True, ptf_off, 4, True, False, ("codes", "f32")),
        ("asymmetric", True, default, 4, False, False, ("codes", "f32")),
        ("float_softmax K4", True, lis_off, 4, True, False,
         ("codes", "f32")),
        ("float_softmax K4b", True, lis_off, 4, True, True,
         ("codes", "f32")),
        ("input_quant=False", False, default, 4, True, False, ("f32",)),
        ("mixed {4,8}", True, default, mixed, True, False, ("codes", "f32")),
    ]
    params = jswin.init_swin_params(specs[True][0], jax.random.PRNGKey(3))
    calib = {}
    for case, iq, jcfg, bit, sym, attn_v2, wires in cases:
        spec_j, spec = specs[iq]
        cfg = QuantConfig.from_dict(jcfg.to_dict())
        key = (iq, jcfg.ptf)  # what changes the qparams' layout
        if key not in calib:
            calib[key] = jswin.calibrate(params, spec_j, jcfg,
                                         jnp.asarray(x[:2]))[0]
        models = {
            "calibrated": jax.device_get(jax_swin_int.prepare_int(
                params, calib[key], spec_j, jcfg, bit=bit)),
            "random": random_swin_int_model(
                spec, cfg, seed=6, bit_config=None if bit == 4 else bit)}
        for name, ip_np in models.items():
            ip_np = dict(ip_np, sym_acts=ip_np["sym_acts"] and sym)
            ip = swin_int_model_from_numpy(ip_np, spec, "cpu", cfg)
            for wire in wires:
                xin = x
                if wire == "codes":
                    lut = input_code_lut(
                        np.asarray(ip_np["qp"]["qact_input.scale"]),
                        np.asarray(ip_np["qp"]["qact_input.zp"]))
                    xin = np.stack([lut[c][pixels[:, c]] for c in range(3)],
                                   1)
                want = jax_swin_int.forward_q_int(
                    ip_np, spec_j, jcfg, jnp.asarray(xin), use_pallas=True,
                    pallas_interpret=True, attn_v2=attn_v2)
                got = swin_int.forward_q_int(ip, spec, cfg,
                                             torch.tensor(xin),
                                             attn_v2=attn_v2)
                compare(f"swin {name} {case} {wire}", got.numpy(),
                        np.asarray(want))

    # K4 / K4b, lis=False: plain vs the interpret-mode Pallas kernels
    spec = specs[True][1]
    cfg = QuantConfig(lis=False)
    ip = random_swin_int_model(spec, cfg, seed=2)
    bw = 4 * images
    qkv = np.clip(np.round(rng.standard_normal((bw, 49, 96)) * 30), -128,
                  127).astype(np.int8)
    qkv_p = np.pad(qkv, ((0, 0), (0, 7), (0, 0)))
    to5 = lambda a: a.reshape(bw, -1, 3, 2, 16).transpose(0, 2, 3, 1, 4)  # noqa: E731
    pad = ((0, 0), (0, 7), (0, 7))
    t = lambda a: None if a is None else torch.tensor(a)  # noqa: E731
    for blk, block in ((1, "shifted"), (0, "unshifted")):
        k = swin_block_constants(ip["layers"][0]["blocks"][blk], ip["qp"],
                                 f"layers.0.blocks.{blk}", spec, 0, blk, cfg)
        mask = k["mask_div"]
        kw = dict(num_heads=2, n_real=49, n_windows=4 if blk else 1, bits=8,
                  lis=False)
        jargs = (jnp.asarray(np.pad(k["bias_q"], pad)),
                 None if mask is None else jnp.asarray(np.pad(mask, pad)),
                 jnp.asarray(k["attn_scalars"]))
        targs = (t(k["bias_q"]), t(mask), t(k["attn_scalars"]))
        want = np.asarray(jax_attention.fused_swin_attention(
            jnp.asarray(to5(qkv_p)), *jargs, interpret=True, **kw))
        got = fused_swin_attention(t(to5(qkv)), *targs, **kw)
        compare(f"K4 plain vs Pallas lis=False {block}", got.numpy(),
                want[:, :, :49])
        want = np.asarray(jax_attention.fused_swin_attention_v2(
            jnp.asarray(qkv_p), *jargs, head_dim=16, interpret=True, **kw))
        got = fused_swin_attention_v2(t(qkv), *targs, head_dim=16, **kw)
        compare(f"K4b plain vs Pallas lis=False {block}", got.numpy(),
                want[:, :49])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--images", type=int, default=8)
    ap.add_argument("--family", choices=("vit", "swin", "all"),
                    default="all")
    args = ap.parse_args()
    if args.family in ("swin", "all"):
        swin_table(args.images)
    if args.family == "swin":
        return
    rng = np.random.default_rng(0)
    x = rng.standard_normal((args.images, 3, 224, 224)).astype(np.float32)
    pixels = rng.integers(0, 256, x.shape, dtype=np.uint8)
    n_slots = vit.num_bit_slots(TINY)

    def minus_one(*slots):
        bc = [4] * n_slots
        for s in slots:
            bc[s] = -1
        return tuple(bc)

    cases = [  # (case, config, bit config, wires, sym_acts)
        ("sq_off int4", "sq_off", (4,) * n_slots, ("codes", "f32"), True),
        ("sq_off int8", "sq_off", (8,) * n_slots, ("codes", "f32"), True),
        ("legacy int8", "legacy", (8,) * n_slots, ("codes", "f32"), True),
        ("ptf_off int4", "ptf_off", (4,) * n_slots, ("codes", "f32"), True),
        ("mixed", "default", (8,) + (4, 8) * (2 * TINY.depth) + (8,),
         ("f32",), True),
        ("float qkv+fc2", "default", minus_one(1, 4), ("f32",), True),
        ("float proj", "default", minus_one(2), ("f32",), True),
        ("float patch+fc1+head", "default", minus_one(0, 3, n_slots - 1),
         ("f32",), True),
        ("asymmetric int4", "default", (4,) * n_slots, ("f32",), False),
    ]
    params = vit.init_params(TINY, jax.random.PRNGKey(0))
    calib = {}
    for case, name, bc, wires, sym in cases:
        if name not in calib:
            calib[name] = vit.calibrate(params, TINY, CFGS[name],
                                        jnp.asarray(x[:2]))[0]
        ip_np = jax.device_get(jax_vit_int.prepare_int(
            params, calib[name], TINY, CFGS[name], bc))
        ip_np["sym_acts"] = ip_np["sym_acts"] and sym
        for wire in wires:
            xin = codes_of(ip_np, pixels) if wire == "codes" else x
            forwards(f"calibrated {case} {wire}", ip_np, TINY, CFGS[name],
                     xin)

    p_niq = vit.init_params(NO_INPUT_Q, jax.random.PRNGKey(2))
    qp = vit.calibrate(p_niq, NO_INPUT_Q, CFGS["default"],
                       jnp.asarray(x[:2]))[0]
    ip_np = jax.device_get(jax_vit_int.prepare_int(
        p_niq, qp, NO_INPUT_Q, CFGS["default"],
        (4,) * vit.num_bit_slots(NO_INPUT_Q)))
    forwards("calibrated input_quant=False f32", ip_np, NO_INPUT_Q,
             CFGS["default"], x)

    for case, name, bits, bc in (
            ("sq_off int8", "sq_off", 8, None),
            ("legacy int8", "legacy", 8, None),
            ("ptf_off int4", "ptf_off", 4, None),
            ("float proj+fc1", "default", 4, minus_one(2, 7)),
            ("float qkv+fc2", "default", 4, minus_one(1, 4)),
            ("float patch+proj+head", "default", 4,
             minus_one(0, 2, n_slots - 1))):
        jcfg = dataclasses.replace(CFGS[name], bit_w=JAX_BITS[f"int{bits}"])
        ip_np = random_int_model(port_spec(TINY),
                                 QuantConfig.from_dict(jcfg.to_dict()),
                                 seed=1, bit_config=bc)
        forwards(f"random {case} f32", ip_np, TINY, jcfg, x)

    # K5: the port's plain version vs the interpret-mode Pallas kernel
    for spec, batch in ((port_spec(TINY), 8), (VIT_SPECS["deit_small"], 2)):
        h, d, n_real, npad = spec.num_heads, spec.head_dim, 197, 256
        qkv = np.zeros((batch, 3, h, npad, d), np.int8)
        qkv[:, :, :, :n_real] = np.clip(np.round(rng.standard_normal(
            (batch, 3, h, n_real, d)) * 12), -128, 127)
        scalars = int_attn_scalars(random_int_model(spec, seed=2)
                                   ["blocks"][0], spec)
        for lis in (True, False):
            want = np.asarray(jax_int_attention(
                jnp.asarray(qkv), jnp.asarray(scalars), num_heads=h,
                n_real=n_real, bits=4, lis=lis, interpret=True))
            got = fused_int_attention(torch.tensor(qkv[:, :, :, :n_real]),
                                      torch.tensor(scalars), num_heads=h,
                                      n_real=n_real, lis=lis)
            compare(f"K5 plain vs Pallas {spec.name} b={batch}",
                    got.numpy(), want[:, :, :n_real], lis=lis)


if __name__ == "__main__":
    main()

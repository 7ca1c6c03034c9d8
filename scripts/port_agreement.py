"""How far the PyTorch port's integer ViT forward agrees with the JAX one,
on the CPU, for every branch of ``forward_q_int``.

    JAX_PLATFORMS=cpu python scripts/port_agreement.py [--images 8]

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
from diffvit_tpu.models import vit, vit_int as jax_vit_int  # noqa: E402
from diffvit_tpu.ops.bit_types import BIT_TYPE_DICT as JAX_BITS  # noqa: E402
from diffvit_tpu.ops.pallas.attention import \
    fused_int_attention as jax_int_attention  # noqa: E402

from diffvit_tpu_torch import QuantConfig  # noqa: E402
from diffvit_tpu_torch.models import vit_int  # noqa: E402
from diffvit_tpu_torch.models.convert import (int_attn_scalars,  # noqa: E402
                                              int_model_from_numpy)
from diffvit_tpu_torch.models.vit import VIT_SPECS, ViTSpec  # noqa: E402
from diffvit_tpu_torch.ops.kernels.attention import \
    fused_int_attention  # noqa: E402
from diffvit_tpu_torch.testing import random_int_model  # noqa: E402

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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--images", type=int, default=8)
    args = ap.parse_args()
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

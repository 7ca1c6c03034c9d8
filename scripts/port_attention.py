"""The attention kernels of the PyTorch port, timed on the card by row.

    python3 scripts/port_attention.py [label]

From the root of a checkout: K1 (LIS and float softmax) and K5 at DeiT-S
b = 1, 8, 64; K8 v1, K8 ``_v3`` and K7a at DeiT-S b = 64 (200 rows, 197
real); K4 and K4b at Swin-T stage 0 (b = 1, 8, 64) and stages 1-3 (b =
64), LIS and float softmax, on the shifted block.  One JSON line a row:
the wrapper's time (CUDA events, host included, ``chip_smoke.cuda_ms``)
and the summed device time of its launches (``torch.profiler``, mean of
10 calls), with ``label`` (default "tree") in each line.  The arguments are
``chip_smoke.py``'s own case builders, so running this script in a parent
commit's checkout and in this one, in turns within one call, compares the
two on the same inputs.  Seeded random weights; needs a CUDA card;
imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import os
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from diffvit_tpu_torch import QuantConfig  # noqa: E402
from diffvit_tpu_torch.ops.kernels import build  # noqa: E402
from diffvit_tpu_torch.testing import (alt_kernel_cases,  # noqa: E402
                                       random_int_model,
                                       random_swin_int_model)


def device_ms(fn, iters=10, tries=3):
    """Summed device milliseconds of one call's launches, after a warm-up;
    profiled again, up to ``tries`` times, while torch.profiler records no
    device time (it now and then records none).  Kept here rather than
    taken from chip_smoke.py, so that a parent commit's checkout runs it."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(getattr(e, "self_device_time_total", 0)
                    for e in prof.key_averages())
        if total > 0:
            return total / 1e3 / iters
    raise RuntimeError("torch.profiler saw no device time")


def row(label, name, at, args, kw):
    fn = cs.KERNELS[name]["fn"]

    def call():
        return fn(*args, **kw)
    print(json.dumps(dict(tree=label, kernel=name, at=at, ms=cs.cuda_ms(call),
                          device_ms=device_ms(call))), flush=True)


def main():
    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    if not torch.cuda.is_available():
        sys.exit("port_attention: no CUDA card")
    dev = torch.device("cuda", 0)
    build.load_library()
    ib = random_int_model(cs.SPEC, cs.CFG, seed=0)["blocks"][0]
    ib_fq = random_int_model(cs.SPEC, cs.FQVIT, seed=0)["blocks"][0]
    for name, blk, opts, lab in (
            ("fused_qkv_attention_v2", ib, {}, "lis"),
            ("fused_qkv_attention_v2", ib, dict(lis=False, bits=8), "softmax"),
            ("fused_int_attention", ib_fq, {}, "lis"),
            ("fused_int_attention", ib_fq, dict(lis=False), "softmax")):
        for b in (1, 8, 64):
            args, kw = cs.kernel_case(name, blk, cs.SPEC, b, dev, **opts)
            row(label, name, f"{lab} b={b}", args, kw)
    ip_np = random_int_model(cs.SPEC, cs.CFG, seed=0)
    for lis in (True, False):
        cases = alt_kernel_cases(cs.SPEC, ip_np, 64, dev, npad=200, lis=lis,
                                 seed=64)
        for name in ("fused_qkv_attention", "fused_qkv_attention_v3",
                     "fused_attention_block"):
            args, kw = cases[name]
            row(label, name, f"{'lis' if lis else 'softmax'} b=64", args, kw)
    for cfg, lab in ((cs.CFG, "lis"), (QuantConfig(lis=False), "softmax")):
        ip = random_swin_int_model(cs.SWIN, cfg, seed=0)
        for stage in range(4):
            for b in ((1, 8, 64) if stage == 0 else (64,)):
                cases = cs.swin_cases(ip, stage, b, dev, cfg=cfg)
                for name in ("fused_swin_attention",
                             "fused_swin_attention_v2"):
                    args, kw = cases[name]
                    row(label, name, f"{lab} stage {stage} b={b}", args, kw)


if __name__ == "__main__":
    main()

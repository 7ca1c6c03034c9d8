"""The attention kernels of the PyTorch port, timed on the card by row.

    python3 scripts/port_attention.py [label] [--footprints]

From the root of a checkout: K1 (LIS and float softmax) and K5 at DeiT-S
b = 1, 8, 64; K8 v1, K8 ``_v3`` and K7a at DeiT-S b = 64 (200 rows, 197
real), K7a also at b = 1 and 8 with the LIS; K4 and K4b at Swin-T stage 0
(b = 1, 8, 64) and stages 1-3 (b = 64), LIS and float softmax, on the
shifted block.  One JSON line a row: the wrapper's time (CUDA events,
host included, ``chip_smoke.cuda_ms``) and the summed device time of its
launches (``torch.profiler``, mean of 10 calls), with ``label`` (default
"tree") in each line; K7a's rows also give it by launch (its qkv GEMM,
core and proj, by kernel name).  With
``--footprints``, first the footprints (registers, local memory, shared
memory, blocks an SM) of every instance of the attention cores that
``chip_smoke.py``'s phase ``attention`` reads: K1's and K5's core at
DeiT-S b = 1, 8, 64, K4's at Swin-T stages 0-3 b = 64, K1's qkv GEMM, K6
at DeiT-S b = 1, 8, 64, both softmaxes.  The arguments are
``chip_smoke.py``'s own case functions and the package's footprint
entries, so running this script (from any checkout) with the working
directory at a parent commit's checkout and at this one, in turns within
one call, compares the two on the same inputs.  Seeded random weights;
needs a CUDA card; imports neither JAX nor the JAX package.
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
from diffvit_tpu_torch.ops.kernels import (attention, build,  # noqa: E402
                                           swin_attention)
from diffvit_tpu_torch.ops.kernels.serve import \
    resident_footprint  # noqa: E402
from diffvit_tpu_torch.testing import (alt_kernel_cases,  # noqa: E402
                                       random_int_model,
                                       random_swin_int_model)


def device_by_kernel(fn, iters=10, tries=3):
    """Device milliseconds of one call by kernel name, after a warm-up;
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
        times = {e.key: getattr(e, "self_device_time_total", 0) / 1e3 / iters
                 for e in prof.key_averages()}
        times = {k: v for k, v in times.items() if v > 0}
        if times:
            return times
    raise RuntimeError("torch.profiler saw no device time")


def k7a_launch(key):
    """K7a's launch kind by kernel name, in either tree: the qkv GEMM (the
    wgmma kernel with the qkv requant epilogue), the core, else the proj
    (the wgmma kernel with BlockProjOut, or the tile it replaced)."""
    if "qkv_core_kernel" in key:
        return "core"
    return "qkv_gemm" if "QkvOut" in key else "proj"


def row(label, name, at, args, kw):
    fn = cs.KERNELS[name]["fn"]

    def call():
        return fn(*args, **kw)
    times = device_by_kernel(call)
    line = dict(tree=label, kernel=name, at=at, ms=cs.cuda_ms(call),
                device_ms=sum(times.values()))
    if name == "fused_attention_block":
        for key, ms in times.items():
            kind = f"{k7a_launch(key)}_device_ms"
            line[kind] = line.get(kind, 0.0) + ms
    print(json.dumps(line), flush=True)


def footprints(label, dev):
    """One JSON line a core instance's footprint, as phase attention lists
    them."""
    spec, swin = cs.SPEC, cs.SWIN
    rows = []
    for b in (1, 8, 64):
        for lis in (True, False):
            rows.append(("qkv core", f"b={b}", lis, attention.core_footprint(
                b, spec.num_heads, spec.seq_len, spec.head_dim, spec.seq_len,
                dev, lis=lis)))
    for stage in range(swin.num_layers):
        res = swin.stage_resolution(stage)[0]
        for lis in (True, False):
            rows.append(("swin core", f"stage {stage} b=64", lis,
                         swin_attention.footprint(
                             64 * (res // 7) ** 2, swin.num_heads[stage], 56,
                             swin.stage_dim(stage) // swin.num_heads[stage],
                             49, dev, lis=lis)))
    for at, r in (("b=1", spec.seq_len), ("b=64", 64 * spec.seq_len)):
        rows.append(("qkv gemm", at, True, attention.qkv_gemm_footprint(
            r, 3 * spec.embed_dim, spec.embed_dim, dev)))
    for b in (1, 8, 64):
        for lis in (True, False):
            rows.append(("resident_codes", f"b={b}", lis,
                         resident_footprint(b, spec.seq_len, spec, dev,
                                            lis=lis)))
    for kernel, at, lis, f in rows:
        print(json.dumps(dict(tree=label, footprint=kernel, at=at, lis=lis,
                              **f)), flush=True)


def main():
    args = [a for a in sys.argv[1:] if a != "--footprints"]
    label = args[0] if args else "tree"
    if not torch.cuda.is_available():
        sys.exit("port_attention: no CUDA card")
    dev = torch.device("cuda", 0)
    build.load_library()
    if "--footprints" in sys.argv:
        footprints(label, dev)
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
    for b in (1, 8):
        args, kw = alt_kernel_cases(cs.SPEC, ip_np, b, dev, npad=200,
                                    seed=b)["fused_attention_block"]
        row(label, "fused_attention_block", f"lis b={b}", args, kw)
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

"""Where K2's and K3's time goes on the card: the wgmma mainloop
(``diffvit_tpu_torch/csrc/wgmma_gemm.cuh``), tile by tile.

    python3 scripts/port_gemm.py
    python3 scripts/port_gemm.py --served [label]

One JSON line each, after a line with the card's name and power limit:
- K2 (``fused_int_mlp``, DeiT-S block 0, codes out) at b = 1 and 64: the
  wrapper's time (CUDA events, mean of 20, host included), the device time
  of each of its two kernels (``torch.profiler``, mean of 10 calls), and
  the host time a call (100 calls without a synchronize);
- the tile sweep at DeiT-S b = 64: K2's fc1 and fc2 kernels' device times
  with BN in {64, 128} each and 2, 3, 4, 5 or the most stages that fit at
  one block an SM, and 128 x 64 tiles at two blocks an SM with 2 or 3
  stages; each output against the chosen plan's;
- K2 at Swin-T stage 0, b = 64, with the chosen plan and with one block
  an SM of 128 x 128 tiles (4 stages);
- K2 at P3's 50,688 rows beside P3's ``dot`` mode (K2's kernel with the
  probe's keep-alive epilogues), device time and events;
- P3's ``pipelined`` and ``staged`` fc1 kernels at one and two blocks an
  SM beside the plan's choice (``overlap_plan.OWN_BLOCKS``): the
  footprint, the output against ``dot``'s and the device time beside
  ``dot``'s;
- K3 (``fused_int_linear``) at each DeiT-S and Swin-T site at b = 64, each
  mode: device time and events beside ``torch._int_mm``'s (the GEMM alone,
  int32 out; the port never calls it), and the device time with one block
  an SM of 128 x 128 tiles (4 stages);
- the host time of the K3 wrapper's steps at the DeiT-S head (b = 64).
With ``--served``, only the served GEMM kernels' footprints (registers,
shared memory, blocks an SM: K2's fc1 and fc2, K7b's fc1 and fc2, K3 at
the DeiT-S sites in each mode, K7a's proj with its local memory; DeiT-S
b = 1, 8, 64) and device times (K2 at b = 1 and 64, K3 at each DeiT-S
site at b = 64, K7b at b = 64), each line with ``label`` (default
"tree").  The package is imported from this
script's checkout unless ``PYTHONPATH`` names another, so running it with
``PYTHONPATH`` at a parent commit's checkout and without, in turns within
one call, compares the two on the same inputs.
Needs a CUDA card; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

# after PYTHONPATH's entries, so that PYTHONPATH can name another checkout
sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffvit_tpu_torch.models.swin import SWIN_SPECS  # noqa: E402
from diffvit_tpu_torch.models.vit import VIT_SPECS  # noqa: E402
from diffvit_tpu_torch.ops.kernels import (attention, build,  # noqa: E402
                                           gemm, linear, mlp, route)
from diffvit_tpu_torch.probes import overlap_mlp  # noqa: E402
from diffvit_tpu_torch.testing import (alt_kernel_cases,  # noqa: E402
                                       linear_site_cases, random_int_model,
                                       random_swin_int_model)

DEIT, SWIN = VIT_SPECS["deit_small"], SWIN_SPECS["swin_tiny"]


def events_ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=10):
    """Device ms a call of ``fn``, by kernel, from torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        # the kernel's name and template arguments, without its parameters
        name = e.key.replace("void ", "").split(">(")[0]
        out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / iters
    if not out:
        raise RuntimeError("the profiler recorded no device time")
    return out


def host_ms(fn, calls=100):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / calls


def k2_args(rows, dev):
    ib = random_int_model(DEIT, seed=0)["blocks"][0]
    rng = np.random.default_rng(2)
    t = lambda a: torch.tensor(np.asarray(a), device=dev)  # noqa: E731
    f1, f2 = ib["fc1"], ib["fc2"]
    x = np.clip(np.round(rng.standard_normal((rows, DEIT.embed_dim)) * 30),
                -128, 127).astype(np.int8)
    return (t(x), t(f1["w_int"]), t(f2["w_int"]), t(f1["mult"]), t(f1["b"]),
            t(f2["mult"]), t(f2["b"]), t(ib["mlp.qact2"]["scale"]),
            t(ib["mlp.qact1"]["scale"]))


def emit(**record):
    print(json.dumps(record), flush=True)


def k2(dev):
    for b in (1, 64):
        args = k2_args(b * DEIT.seq_len, dev)
        fn = lambda: mlp.fused_int_mlp(*args, emit_codes=True)  # noqa
        emit(what="K2", batch=b, events_ms=events_ms(fn),
             device_ms=device_ms(fn), host_ms=host_ms(fn))


def fixed_plan(bn, blocks, stages, dev):
    """A plan of 128 x ``bn`` tiles at ``blocks`` blocks an SM and
    ``stages`` stages, in place of gemm_plan's choice."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def plan(m, n, k, d):
        tiles = -(-m // 128) * -(-n // bn)
        return gemm.GemmPlan(128, bn, blocks, gemm.BK, stages,
                             gemm.smem_bytes(128, bn, stages),
                             min(tiles, blocks * sms), tiles)
    return plan


# gemm_plan's choice before two blocks an SM: 128 x 128 tiles, 4 stages
ONE_BLOCK = (128, 1, 4)


def sweep(dev):
    """K2's two kernels at DeiT-S b = 64 with each tile (BM = 128), blocks
    an SM and stage count, through a plan that replaces gemm_plan's choice;
    each output held against the chosen plan's."""
    args = k2_args(64 * DEIT.seq_len, dev)
    chosen = mlp.device_plan
    want = mlp.fused_int_mlp(*args, emit_codes=True)
    configs = []
    for bn in (64, 128):
        fit = (gemm.SMEM_LIMIT - gemm.smem_bytes(128, bn, 0)) \
            // ((128 + bn) * gemm.BK)
        configs += [(bn, 1, st) for st in sorted({2, 3, 4, 5, min(
            fit, gemm.MAX_STAGES)})]
    configs += [(64, 2, 2), (64, 2, 3)]  # two blocks an SM
    try:
        for bn, blocks, stages in configs:
            mlp.device_plan = fixed_plan(bn, blocks, stages, dev)
            fn = lambda: mlp.fused_int_mlp(*args, emit_codes=True)  # noqa
            emit(what="K2 sweep", batch=64, bn=bn, blocks=blocks,
                 stages=stages, equal=bool(torch.equal(fn(), want)),
                 device_ms=device_ms(fn))
    finally:
        mlp.device_plan = chosen


def swin_stage0(dev):
    """K2 at Swin-T stage 0, b = 64 (200,704 rows, C = 96), codes out,
    with gemm_plan's choice and at two blocks an SM."""
    ip = random_swin_int_model(SWIN, seed=0)
    ib, qp, p = ip["layers"][0]["blocks"][0], ip["qp"], "layers.0.blocks.0"
    t = lambda a: torch.tensor(np.asarray(a), device=dev)  # noqa: E731
    f1, f2 = ib["fc1"], ib["fc2"]
    rows = 64 * (SWIN.img_size // SWIN.patch_size) ** 2
    x = np.clip(np.round(np.random.default_rng(3).standard_normal(
        (rows, SWIN.embed_dim)) * 30), -128, 127).astype(np.int8)
    args = (t(x), t(f1["w_int"]), t(f2["w_int"]),
            t(qp[f"{p}.qact3.scale"] * f1["sw"]), t(f1["b"]),
            t(qp[f"{p}.mlp.qact1.scale"] * f2["sw"]), t(f2["b"]),
            t(qp[f"{p}.mlp.qact2.scale"]), t(qp[f"{p}.mlp.qact1.scale"]))
    fn = lambda: mlp.fused_int_mlp(*args, emit_codes=True)  # noqa: E731
    want = fn()
    emit(what="K2 swin_tiny stage 0", batch=64, device_ms=device_ms(fn))
    chosen = mlp.device_plan
    mlp.device_plan = fixed_plan(*ONE_BLOCK, dev)
    try:
        emit(what="K2 swin_tiny stage 0", batch=64, plan="one block",
             equal=bool(torch.equal(fn(), want)), device_ms=device_ms(fn))
    finally:
        mlp.device_plan = chosen


def beside_p3(dev):
    args = overlap_mlp.inputs(dev)
    k2_p3 = overlap_mlp.production_args(*args)
    for name, fn in (("P3 dot", lambda: overlap_mlp.mlp_dot(*args)),
                     ("K2", lambda: mlp.fused_int_mlp(*k2_p3))):
        emit(what="beside P3", kernel=name, rows=overlap_mlp.ROWS,
             events_ms=events_ms(fn, 5), device_ms=device_ms(fn, 5))


def p3_blocks(dev):
    """P3's pipelined and staged modes at one and two blocks an SM."""
    # imported here: --served also runs on checkouts without this module
    from diffvit_tpu_torch.ops.kernels.overlap_plan import OWN_BLOCKS
    args = overlap_mlp.inputs(dev)
    want = overlap_mlp.mlp_dot(*args)
    dot_ms = sum(device_ms(lambda: overlap_mlp.mlp_dot(*args), 5).values())
    for blocks in (1, 2):
        for mode in ("pipelined", "staged"):
            fn = functools.partial(overlap_mlp.run, mode, args, blocks)
            emit(what="P3 blocks", mode=mode, blocks=blocks,
                 chosen=OWN_BLOCKS[mode] == blocks,
                 footprint=overlap_mlp.fc1_occupancy(mode, dev=dev,
                                                     blocks=blocks),
                 equal=bool(torch.equal(fn(), want)),
                 device_ms=sum(device_ms(fn, 5).values()),
                 dot_device_ms=dot_ms)


def k3(dev):
    """K3 at each b = 64 site and mode with gemm_plan's choice, and (rows
    past 256) with one block an SM of 128 x 128 tiles, each output held
    against the first."""
    chosen = linear.device_plan
    for spec, model in ((DEIT, random_int_model(DEIT, seed=0)),
                        (SWIN, random_swin_int_model(SWIN, seed=0))):
        for site, (args, out_scale) in linear_site_cases(
                spec, model, 64, dev, seed=64).items():
            x, w = args[:2]
            rec = dict(what="K3", model=spec.name, site=site,
                       shape=[*x.shape, w.shape[1]])
            if x.shape[0] > 16 and x.shape[1] % 8 == 0 \
                    and w.shape[1] % 8 == 0:
                mm = lambda: torch._int_mm(x, w)  # noqa: E731
                rec.update(int_mm_events_ms=events_ms(mm),
                           int_mm_device_ms=sum(device_ms(mm).values()))
            for mode, kw in (("raw", {}), ("fq", dict(out_scale=out_scale)),
                             ("codes", dict(out_scale=out_scale,
                                            emit_codes=True))):
                fn = lambda: linear.fused_int_linear(*args, **kw)  # noqa
                more = {}
                if x.shape[0] > 256:
                    want = fn()
                    linear.device_plan = fixed_plan(*ONE_BLOCK, dev)
                    try:
                        more = dict(one_block_equal=bool(torch.equal(
                            fn(), want)), one_block_device_ms=sum(
                                device_ms(fn).values()))
                    finally:
                        linear.device_plan = chosen
                emit(**rec, mode=mode, events_ms=events_ms(fn),
                     device_ms=sum(device_ms(fn).values()), **more)


def k3_host(dev):
    """Host microseconds of each step of the K3 wrapper at the head."""
    (x, w, mult, bias), out_scale = linear_site_cases(
        DEIT, random_int_model(DEIT, seed=0), 64, dev, seed=64)["head"]
    lib = build.load_library()
    wk = gemm.kmajor(w)
    v = linear.linear_vectors(mult, bias, out_scale, w.shape[1]).contiguous()
    out = torch.empty((x.shape[0], w.shape[1]), device=dev)
    plan = gemm.device_plan(*x.shape[:1], w.shape[1], x.shape[1], dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    steps = {
        "route": lambda: route(x, w, mult, bias, out_scale),
        "per_weight": lambda: gemm.per_weight(
            lambda: v, mult, bias, out_scale, w.shape[1]),
        "kmajor": lambda: gemm.kmajor(w),
        "device_plan": lambda: gemm.device_plan(64, 1000, 384, dev),
        "empty": lambda: torch.empty((64, 1000), device=dev),
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "c_entry": lambda: lib.dvt_int_linear(
            x.data_ptr(), wk.data_ptr(), v.data_ptr(), out.data_ptr(), 64,
            384, 1000, 0, *plan.launch_args(), stream),
        "wrapper": lambda: linear.fused_int_linear(x, w, mult, bias),
    }
    emit(what="K3 host us", **{k: 1e3 * host_ms(f, 1000)
                               for k, f in steps.items()})


# K3's DeiT-S sites: (N, K)
DEIT_SITES = {"qkv": (1152, 384), "proj": (384, 384), "fc1": (1536, 384),
              "fc2": (384, 1536), "head": (1000, 384)}


def served(label, dev):
    """The served GEMM kernels' footprints and device times (``--served``)."""
    c, hid = DEIT.embed_dim, 4 * DEIT.embed_dim
    for b in (1, 8, 64):
        rows = b * DEIT.seq_len
        for name, fps in (("K2", mlp.footprint(rows, c, hid, c, dev)),
                          ("K7b", mlp.mlp_block_footprint(rows, c, hid,
                                                          dev))):
            for launch, f in fps.items():
                emit(tree=label, footprint=name, launch=launch, batch=b, **f)
        for site, (n, k) in DEIT_SITES.items():
            for mode in ("raw", "fq", "codes"):
                emit(tree=label, footprint="K3", site=site, mode=mode,
                     batch=b, **linear.footprint(rows, n, k, dev, mode))
        # K7a's proj at Npad 200 (a checkout whose proj is not on the
        # wgmma mainloop has no such footprint)
        proj = getattr(attention, "proj_gemm_footprint", None)
        if proj is not None:
            emit(tree=label, footprint="K7a", launch="proj", batch=b,
                 **proj(b * 200, c, c, dev))
    for b in (1, 64):
        args = k2_args(b * DEIT.seq_len, dev)
        emit(tree=label, kernel="K2", batch=b, device_ms=sum(device_ms(
            lambda: mlp.fused_int_mlp(*args, emit_codes=True)).values()))
    for site, (args, out_scale) in linear_site_cases(
            DEIT, random_int_model(DEIT, seed=0), 64, dev, seed=64).items():
        emit(tree=label, kernel="K3", site=site, batch=64,
             device_ms=sum(device_ms(lambda: linear.fused_int_linear(
                 *args, out_scale=out_scale)).values()))
    args, kw = alt_kernel_cases(DEIT, random_int_model(DEIT, seed=0), 64,
                                dev, npad=200, seed=64)["fused_int_mlp_block"]
    emit(tree=label, kernel="K7b", batch=64, device_ms=sum(device_ms(
        lambda: mlp.fused_int_mlp_block(*args, **kw)).values()))


def main():
    if not torch.cuda.is_available():
        sys.exit("port_gemm: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    build.load_library()
    dev = torch.device("cuda", 0)
    if "--served" in sys.argv:
        args = sys.argv[sys.argv.index("--served") + 1:]
        served(args[0] if args else "tree", dev)
        return
    build.load_library("probes")
    k2(dev)
    sweep(dev)
    swin_stage0(dev)
    beside_p3(dev)
    p3_blocks(dev)
    k3(dev)
    k3_host(dev)


if __name__ == "__main__":
    main()

"""The resident encoder K6 and K7b of the PyTorch port, timed on the card,
with K1, K2 and K3 beside them.

    python3 scripts/port_resident.py [label]

From the root of a checkout: K6 (``resident_codes``, DeiT-S int4 at full
depth) at b = 1, 8, 64 with the LIS and at b = 8 with the float softmax;
K7b (``fused_int_mlp_block``) at DeiT-S b = 64 (200 rows an image, 197
real); the resident b = 64 forward in chunks of 8 images (``microbatch=8``,
the default) and in one launch (``microbatch=None``); and K1
(``fused_qkv_attention_v2``), K2 (``fused_int_mlp``, codes out) and K3
(``fused_int_linear`` at the qkv site, codes out) at DeiT-S b = 1 and 64,
whose GEMMs run the same wgmma tile routine as K6's.  One JSON line a row:
the wrapper's time (CUDA events, host included, ``chip_smoke.cuda_ms``)
and the summed device time of its launches (``torch.profiler``, mean of
10 calls), with ``label`` (default "tree") in each line.  Where the
checkout's K6 writes barrier stamps (``serve.resident_step_ms``), each K6
row also carries block 0's ms by step kind (LN, qkv, attention, proj,
fc1, fc2, barrier wait) from one more launch.

The arguments are ``chip_smoke.py``'s own case builders, so running this
script in a parent commit's checkout and in this one, in turns within one
call (parent, change, change, parent), compares the two on the same
inputs.  Seeded random weights; needs a CUDA card; imports neither JAX nor
the JAX package.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from diffvit_tpu_torch import engine  # noqa: E402
from diffvit_tpu_torch.models import vit_int  # noqa: E402
from diffvit_tpu_torch.ops.kernels import build, serve  # noqa: E402
from diffvit_tpu_torch.testing import (alt_kernel_cases,  # noqa: E402
                                       linear_site_cases, random_int_model)


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


def row(label, kernel, at, call, **more):
    print(json.dumps(dict(tree=label, kernel=kernel, at=at,
                          ms=cs.cuda_ms(call, iters=10),
                          device_ms=device_ms(call), **more)), flush=True)


def main():
    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    if not torch.cuda.is_available():
        sys.exit("port_resident: no CUDA card")
    dev = torch.device("cuda", 0)
    build.load_library()
    spec, cfg = cs.SPEC, cs.CFG
    ip_np = random_int_model(spec, cfg, seed=0)
    model = engine.IntModel(ip_np, spec, cfg, dev, resident=True)
    for b, lis in ((1, True), (8, True), (64, True), (8, False)):
        x = cs.codes((b * spec.seq_len, spec.embed_dim), b + 11, dev)
        kw = dict(n_real=spec.seq_len, lis=lis, nelems=b)
        more = {}
        if hasattr(serve, "resident_step_ms"):
            more["step_ms"] = serve.resident_step_ms(model.packed, x, **kw)
        row(label, "resident_codes", f"{'lis' if lis else 'softmax'} b={b}",
            lambda: serve.resident_codes(model.packed, x, **kw), **more)
    x64 = torch.tensor(model.encode(np.random.default_rng(1).integers(
        0, 256, (64, 3, spec.img_size, spec.img_size), dtype=np.uint8)),
        device=dev)
    for mb in (8, None):
        def forward(mb=mb):
            with torch.inference_mode():
                return vit_int.forward_q_int_serve(
                    model.ip, spec, cfg, x64, packed=model.packed,
                    microbatch=mb)
        row(label, "resident forward", f"b=64 microbatch={mb}", forward)
    args, kw = alt_kernel_cases(spec, ip_np, 64, dev, npad=200,
                                seed=64)["fused_int_mlp_block"]
    row(label, "fused_int_mlp_block", "b=64",
        lambda: cs.mlp.fused_int_mlp_block(*args, **kw))
    ib = ip_np["blocks"][0]
    for b in (1, 64):
        for name, opts in (("fused_qkv_attention_v2", {}),
                           ("fused_int_mlp", dict(emit_codes=True))):
            a, k = cs.kernel_case(name, ib, spec, b, dev, **opts)
            fn = cs.KERNELS[name]["fn"]
            row(label, name, f"b={b}", lambda: fn(*a, **k))
        (a, out_scale) = linear_site_cases(spec, ip_np, b, dev,
                                           seed=b)["qkv"]
        row(label, "fused_int_linear", f"qkv codes b={b}",
            lambda: cs.linear.fused_int_linear(
                *a, out_scale=out_scale, emit_codes=True))


if __name__ == "__main__":
    main()

"""The resident encoder K6 and K7b of the PyTorch port, timed on the card,
with K1, K2 and K3 beside them; or K6's launch-size sweep.

    python3 scripts/port_resident.py [label] [--sweep] [--spec vit_large_384]

From the root of a checkout: K6 (``resident_codes``, DeiT-S int4 at full
depth) at b = 1, 8, 64 with the LIS and at b = 8 with the float softmax;
K7b (``fused_int_mlp_block``) at DeiT-S b = 64 (200 rows an image, 197
real); the resident b = 64 forward in chunks of 8 images (``microbatch=8``)
and in one launch (``microbatch=None``); and K1
(``fused_qkv_attention_v2``), K2 (``fused_int_mlp``, codes out) and K3
(``fused_int_linear`` at the qkv site, codes out) at DeiT-S b = 1 and 64,
whose GEMMs run the same wgmma tile routine as K6's.  One JSON line a row:
the wrapper's time (CUDA events, host included, ``chip_smoke.cuda_ms``)
and the summed device time of its launches (``torch.profiler``, mean of
10 calls), with ``label`` (default "tree") in each line.  Where the
checkout's K6 writes barrier stamps (``serve.resident_step_ms``), each K6
row also carries block 0's ms by step kind (LN, qkv, attention, proj,
fc1, fc2, barrier wait) from one more launch.

``--sweep`` times, instead, how the resident forward's launches are cut:
the DeiT-S forward (``forward_q_int_serve``) at B = 8, 50, 64, 128 and
256 images with ``microbatch`` 8, 32, 64, 128 and 256 (those below B),
None (one launch) and the checkout's default, each row with the forward's
ms a batch and an image (CUDA events) and its device ms and K6's share of
them (``torch.profiler``, mean of 10 calls), the launches' sizes, and
``resident_plan``'s ``items`` and ``rounds`` of each size; then K6 alone
(``resident_codes``) in one launch of n = 8 .. 256 images, its device ms a
launch and an image.  A checkout without ``vit_int.k6_launches`` cuts as
the forward did before it: zero-padded chunks of ``microbatch``, 8 by
default.

``--spec vit_large_384`` runs the same at ViT-L/16's widths at 384 px
(577 tokens, 1024 wide, 24 blocks; ``chip_smoke.VIT_L384``): K6 at b = 1
and 16 (the forward's launch at these widths) and K1 and K5 at b = 1 and
8, or with ``--sweep`` the forward at B = 256 with ``microbatch`` 4, 8,
16, 32 and the default, then K6 alone at n = 4, 8, 16 and 32.

The arguments are ``chip_smoke.py``'s own case builders, so running this
script with the working directory at a parent commit's checkout and at
this one, in turns within one call (parent, change, change, parent),
compares the two on the same inputs.  Seeded random weights; needs a
CUDA card; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
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


def device_ms(fn, name=None, iters=10, tries=3):
    """Summed device milliseconds of one call's launches, after a warm-up;
    with ``name``, the pair (every launch's, the launches whose name holds
    ``name``).  Profiled again, up to ``tries`` times, while torch.profiler
    records no device time (it now and then records none).  Kept here
    rather than taken from chip_smoke.py, so that a parent commit's
    checkout runs it."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = [(e.key, getattr(e, "self_device_time_total", 0))
                 for e in prof.key_averages()]
        total = sum(t for _, t in times) / 1e3 / iters
        if total > 0:
            if name is None:
                return total
            return total, sum(t for k, t in times
                              if name in k) / 1e3 / iters
    raise RuntimeError("torch.profiler saw no device time")


def row(label, kernel, at, call, **more):
    print(json.dumps(dict(tree=label, kernel=kernel, at=at,
                          ms=cs.cuda_ms(call, iters=10),
                          device_ms=device_ms(call), **more)), flush=True)


# spec name -> (batches, microbatches, K6 launch sizes) of the sweep
SWEEPS = {"deit_small": ((8, 50, 64, 128, 256), (8, 32, 64, 128, 256),
                         (8, 16, 32, 48, 64, 80, 96, 128, 192, 256)),
          "vit_large_384": ((256,), (4, 8, 16, 32), (4, 8, 16, 32))}
DEFAULT = "default"


def launch_sizes(b, spec, microbatch):
    """The images of each K6 launch the checkout's forward makes for ``b``
    images at ``microbatch`` (DEFAULT: the forward's own default)."""
    if hasattr(vit_int, "k6_launches"):
        kw = {} if microbatch == DEFAULT else dict(microbatch=microbatch)
        return vit_int.k6_launches(b, spec.seq_len, spec.embed_dim,
                                   spec.hidden_dim, **kw)
    m = 8 if microbatch == DEFAULT else microbatch  # zero-padded chunks
    return [b] if m is None or b <= m else [m] * -(-b // m)


def plans(sizes, spec, dev):
    """``resident_plan``'s items and rounds of each distinct launch size."""
    shape = serve.EncoderShape(spec.embed_dim, spec.num_heads,
                               spec.hidden_dim, spec.seq_len)
    out = {}
    for n in sorted(set(sizes), reverse=True):
        p = serve.device_resident_plan(n, spec.seq_len, shape, True, dev)
        out[n] = dict(grid=p.grid, items=p.items, rounds=p.rounds)
    return out


def sweep(label, model, spec, cfg, dev):
    batches, chunks, launch = SWEEPS[spec.name]
    # one launch of a whole batch: DeiT-S only (ViT-L's 256 images would
    # take 1.4 GB of scratch)
    whole = [None] if spec is cs.SPEC else []
    rng = np.random.default_rng(1)
    for b in batches:
        x = torch.tensor(model.encode(rng.integers(
            0, 256, (b, 3, spec.img_size, spec.img_size), dtype=np.uint8)),
            device=dev)
        for mb in [m for m in chunks if m < b] + whole + [DEFAULT]:
            kw = {} if mb == DEFAULT else dict(microbatch=mb)

            def forward(kw=kw):
                with torch.inference_mode():
                    return vit_int.forward_q_int_serve(
                        model.ip, spec, cfg, x, packed=model.packed, **kw)
            sizes = launch_sizes(b, spec, mb)
            ms = cs.cuda_ms(forward, iters=10)
            total, k6 = device_ms(forward, "resident_kernel")
            print(json.dumps(dict(
                tree=label, kernel="resident forward", batch=b,
                microbatch=mb, launches=sizes, ms=ms, ms_per_img=ms / b,
                device_ms=total, k6_ms=k6, k6_ms_per_img=k6 / b,
                plans=plans(sizes, spec, dev))), flush=True)
    for n in launch:
        x = cs.codes((n * spec.seq_len, spec.embed_dim), n + 11, dev)
        kw = dict(n_real=spec.seq_len, lis=True, nelems=n)
        total, k6 = device_ms(
            lambda: serve.resident_codes(model.packed, x, **kw),
            "resident_kernel")
        print(json.dumps(dict(
            tree=label, kernel="resident_codes", nelems=n, k6_ms=k6,
            k6_ms_per_img=k6 / n, plans=plans([n], spec, dev))), flush=True)


def long_rows(label, model, ip_np, spec, dev):
    """The rows at ViT-L@384's widths: K6 at b = 1 and 16 with block 0's
    ms by step kind, K1 and K5 (block 0's weights) at b = 1 and 8."""
    for b in (1, 16):
        x = cs.codes((b * spec.seq_len, spec.embed_dim), b + 11, dev)
        kw = dict(n_real=spec.seq_len, lis=True, nelems=b)
        row(label, "resident_codes", f"lis b={b}",
            lambda: serve.resident_codes(model.packed, x, **kw),
            step_ms=serve.resident_step_ms(model.packed, x, **kw))
    ib = ip_np["blocks"][0]
    for b in (1, 8):
        for name in ("fused_qkv_attention_v2", "fused_int_attention"):
            a, k = cs.kernel_case(name, ib, spec, b, dev)
            fn = cs.KERNELS[name]["fn"]
            row(label, name, f"b={b}", lambda: fn(*a, **k))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("label", nargs="?", default="tree")
    ap.add_argument("--sweep", action="store_true",
                    help="K6's launch-size sweep instead of the kernels")
    ap.add_argument("--spec", choices=sorted(SWEEPS), default="deit_small",
                    help="the model's widths (default DeiT-S)")
    args = ap.parse_args()
    label = args.label
    if not torch.cuda.is_available():
        sys.exit("port_resident: no CUDA card")
    dev = torch.device("cuda", 0)
    build.load_library()
    spec = cs.SPEC if args.spec == "deit_small" else cs.VIT_L384
    cfg = cs.CFG
    ip_np = random_int_model(spec, cfg, seed=0)
    model = engine.IntModel(ip_np, spec, cfg, dev, resident=True)
    if args.sweep:
        return sweep(label, model, spec, cfg, dev)
    if spec is not cs.SPEC:
        return long_rows(label, model, ip_np, spec, dev)
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

"""Where a served forward of the PyTorch port spends its time on the card.

    python3 scripts/port_profile.py [--forwards 5] [--batches 1 8 64]

For DeiT-S int4 (per kernel, and served resident: the encoder in one K6
launch per chunk of 8 images), the FQ-ViT DeiT-S int8 (SmoothQuant off)
and Swin-T int4 — seeded random weights at full width and depth, int8
input codes — and
each batch size: the forward's time (CUDA events, mean of 10, not
profiled), then ``torch.profiler`` over ``--forwards`` forwards: the summed
device time of everything the card ran, per forward; the number of device
kernels and copies per forward; the busy share of the un-profiled forward;
and the five largest device items by total time.  One JSON line per
(model, batch), after a line with the card's name and power limit.  Needs
a CUDA card; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from diffvit_tpu_torch import QuantConfig, engine  # noqa: E402
from diffvit_tpu_torch.models.swin import SWIN_SPECS  # noqa: E402
from diffvit_tpu_torch.models.vit import VIT_SPECS  # noqa: E402
from diffvit_tpu_torch.ops.bit_types import BIT_TYPE_DICT  # noqa: E402
from diffvit_tpu_torch.ops.kernels import build  # noqa: E402
from diffvit_tpu_torch.testing import (random_int_model,  # noqa: E402
                                       random_swin_int_model)


def models():
    deit, swin = VIT_SPECS["deit_small"], SWIN_SPECS["swin_tiny"]
    fq = QuantConfig(smoothquant=False, bit_w=BIT_TYPE_DICT["int8"])
    int4 = random_int_model(deit, QuantConfig(), seed=0)
    # name -> (spec, cfg, int-model, resident)
    return {
        "deit_small int4": (deit, QuantConfig(), int4, False),
        "deit_small int4 resident": (deit, QuantConfig(), int4, True),
        "deit_small fqvit_int8": (deit, fq, random_int_model(deit, fq,
                                                             seed=0), False),
        "swin_tiny int4": (swin, QuantConfig(),
                           random_swin_int_model(swin, QuantConfig(),
                                                 seed=0), False),
    }


def forward_ms(fn, iters=10):
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


def device_items(prof):
    """(name, count, total us) of every device-side item of the trace."""
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        rows.append((e.key, e.count, t))
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--forwards", type=int, default=5)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8, 64])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("port_profile: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    build.load_library()
    rng = np.random.default_rng(1)
    for name, (spec, cfg, ip_np, resident) in models().items():
        model = engine.IntModel(ip_np, spec, cfg, "cuda", resident=resident)
        for b in args.batches:
            px = rng.integers(0, 256, (b, 3, spec.img_size, spec.img_size),
                              dtype=np.uint8)
            x = torch.tensor(model.encode(px), device="cuda")
            wall = forward_ms(lambda: model(x))
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(args.forwards):
                    model(x)
                torch.cuda.synchronize()
            items = device_items(prof)
            if not items:
                raise RuntimeError("the profiler recorded no device time")
            busy = sum(t for _, _, t in items) / 1e3 / args.forwards
            top = sorted(items, key=lambda r: -r[2])[:5]
            print(json.dumps({
                "model": name, "batch": b, "forward_ms": wall,
                "device_busy_ms": busy, "busy_share": busy / wall,
                "device_items_per_forward":
                    sum(c for _, c, _ in items) / args.forwards,
                "top": [{"name": k[:80], "count": c, "total_ms": t / 1e3}
                        for k, c, t in top]}), flush=True)


if __name__ == "__main__":
    main()

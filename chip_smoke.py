"""Drive the PyTorch/CUDA port (diffvit_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. device:  fails unless a CUDA card is present;
2. build:   compiles the port's kernels from diffvit_tpu_torch/csrc with nvcc;
3. kernels: holds each kernel against its plain PyTorch version on the card
            at DeiT-S shapes (B = 1, 8, 64) and a tiny shape, and times both;
4. serving: saves a seeded DeiT-S int4 model as an int-model artifact, loads
            it with the port's load_int_model, answers uint8 requests at
            b = 1 (4 times), 8 and 64 through IntModel, checks that every
            forward went through both kernels, compares the card's logits
            with the plain path on the CPU, prints how far the model's codes
            use the int8 range, and runs validate().

Every phase prints one JSON line.  Then come a JSON line with every kernel
of the main path, the card's name and power limit as nvidia-smi reports
them, and as the last line {"ok": true, "device": {...}}.  Any failure
raises: the exit code is then non-zero and no result line is printed.
The weights are random (seeded): the repository has no pretrained ones.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

from diffvit_tpu_torch import QuantConfig, engine
from diffvit_tpu_torch.models import vit_int
from diffvit_tpu_torch.models.convert import attn_constants
from diffvit_tpu_torch.models.vit import VIT_SPECS, ViTSpec
from diffvit_tpu_torch.ops.kernels import attention, build, mlp
from diffvit_tpu_torch.testing import random_int_model

SPEC = VIT_SPECS["deit_small"]  # full width and depth: 384 wide, 12 blocks
TINY = ViTSpec("test_tiny", embed_dim=64, depth=2, num_heads=2,
               num_classes=10)
CFG = QuantConfig()  # PTF, LIS, SmoothQuant on; int4 weights
REQUESTS = (1, 1, 1, 1, 8, 64)  # images per request, served in this order
MIN_EQUAL, MAX_DIFF = 0.999, 1  # kernel vs plain: equal int8 codes, |diff|
KERNELS = {
    "fused_qkv_attention_v2": dict(
        fn=attention.fused_qkv_attention_v2,
        plain=attention.fused_qkv_attention_v2_plain,
        source="diffvit_tpu_torch/csrc/qkv_attention.cu",
        replaces="diffvit_tpu/ops/pallas/attention.py:295"),
    "fused_int_mlp": dict(
        fn=mlp.fused_int_mlp, plain=mlp.fused_int_mlp_plain,
        source="diffvit_tpu_torch/csrc/int_mlp.cu",
        replaces="diffvit_tpu/ops/pallas/mlp.py:290"),
}


def emit(**record):
    print(json.dumps(record), flush=True)


def cuda_ms(fn, iters=20):
    """Mean device milliseconds per call, from CUDA events after a warm-up."""
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


def kernel_case(name, ib, spec, batch, dev):
    """The kernel's arguments at the main path's shapes: LN-like int8 codes
    for ``batch`` images and the weights of one block."""
    rng = np.random.default_rng(batch)
    x = np.clip(np.round(rng.standard_normal(
        (batch, spec.seq_len, spec.embed_dim)) * 30), -128, 127) \
        .astype(np.int8)
    t = lambda a: torch.tensor(np.asarray(a), device=dev)  # noqa: E731
    if name == "fused_qkv_attention_v2":
        scalars, fast = attn_constants(ib, spec, 0)
        q = ib["qkv"]
        return ((t(x), t(q["w_int"]), t(q["mult"]), t(q["b"]), t(scalars)),
                dict(num_heads=spec.num_heads, head_dim=spec.head_dim,
                     n_real=spec.seq_len, lis_fast=fast))
    f1, f2 = ib["fc1"], ib["fc2"]
    return ((t(x.reshape(-1, spec.embed_dim)), t(f1["w_int"]),
             t(f2["w_int"]), t(f1["mult"]), t(f1["b"]), t(f2["mult"]),
             t(f2["b"]), t(ib["mlp.qact2"]["scale"]),
             t(ib["mlp.qact1"]["scale"])), dict(emit_codes=True))


def phase_kernels(dev):
    """Each kernel vs its plain version on the card; returns per kernel the
    largest |diff| and the DeiT-S b=64 times."""
    summary = {name: {"max_abs_err": 0} for name in KERNELS}
    for spec, batches in ((SPEC, (1, 8, 64)), (TINY, (2,))):
        ib = random_int_model(spec, CFG, seed=0)["blocks"][0]
        for name, k in KERNELS.items():
            for b in batches:
                args, kw = kernel_case(name, ib, spec, b, dev)
                got = k["fn"](*args, **kw)
                want = k["plain"](*args, **kw)
                torch.cuda.synchronize()
                diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
                equal = float((got == want).float().mean())
                max_diff = int(diff.max())
                # turns: plain, kernel, kernel, plain
                t = [cuda_ms(lambda: f(*args, **kw))
                     for f in (k["plain"], k["fn"], k["fn"], k["plain"])]
                ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
                emit(phase="kernel", kernel=name, spec=spec.name, batch=b,
                     shape=list(args[0].shape), equal=equal,
                     max_abs_diff=max_diff, ms=ms, plain_ms=plain_ms)
                if equal < MIN_EQUAL or max_diff > MAX_DIFF:
                    raise RuntimeError(
                        f"{name} {spec.name} b={b}: {equal:.6f} of codes "
                        f"equal, max |diff| {max_diff} (tolerance "
                        f">= {MIN_EQUAL}, <= {MAX_DIFF})")
                s = summary[name]
                s["max_abs_err"] = max(s["max_abs_err"], max_diff)
                if spec is SPEC and b == 64:
                    s["ms"], s["plain_ms"] = ms, plain_ms
    return summary


def at_bounds(codes):
    c = codes.to(torch.int32)
    return float(((c == -128) | (c == 127)).float().mean())


def code_stats(model, x):
    """One forward of ``x`` that records, per site family, the share of
    int8 codes at the bounds, and the mean count of nonzero LIS weights
    per attention row (recomputed with the plain stages)."""
    rec = defaultdict(list)
    orig = (vit_int.fused_qkv_attention_v2, vit_int.fused_int_mlp,
            vit_int._block_int)

    def attn(x_i8, w, mult, bias, scalars, **kw):
        out = orig[0](x_i8, w, mult, bias, scalars, **kw)
        qkv = attention.qkv_projection_plain(
            x_i8, w, attention.fold_requant(mult, bias, scalars[2],
                                            w.shape[1]))
        wts = attention.lis_weights_plain(
            qkv, scalars, num_heads=kw["num_heads"],
            head_dim=kw["head_dim"], n_real=kw["n_real"],
            lis_fast=kw["lis_fast"])
        rec["ln1"].append(at_bounds(x_i8))
        rec["qkv"].append(at_bounds(qkv))
        rec["attn_out"].append(at_bounds(out))
        rec["lis_nonzero_per_row"].append(
            float((wts != 0).sum(-1).float().mean()))
        return out

    def mlp_(x_i8, *args, **kw):
        out = orig[1](x_i8, *args, **kw)
        rec["ln2"].append(at_bounds(x_i8))
        rec["mlp_out"].append(at_bounds(out))
        return out

    def block(*args, **kw):
        h, hc = orig[2](*args, **kw)
        rec["residual"].append(at_bounds(hc))
        return h, hc

    vit_int.fused_qkv_attention_v2, vit_int.fused_int_mlp, \
        vit_int._block_int = attn, mlp_, block
    try:
        logits = model(x)
        torch.cuda.synchronize()
    finally:
        vit_int.fused_qkv_attention_v2, vit_int.fused_int_mlp, \
            vit_int._block_int = orig
    return logits, {k: float(np.mean(v)) for k, v in rec.items()}, \
        {k: float(np.max(v)) for k, v in rec.items()}


def phase_serving(dev):
    ip_np = random_int_model(SPEC, CFG, seed=0)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "deit_small_int4.npz")
        engine.save_int_model(path, ip_np, SPEC, CFG)
        model = engine.load_int_model(path, dev)
        model_cpu = engine.load_int_model(path, "cpu")
    rng = np.random.default_rng(1)
    requests = [rng.integers(0, 256, (b, 3, 224, 224), dtype=np.uint8)
                for b in REQUESTS]
    model(requests[0])  # warm-up: library load, cuBLAS handles
    torch.cuda.synchronize()

    for k in KERNELS.values():
        k["fn"].launches = 0
    seconds, outputs = [], []
    for x in requests:
        t0 = time.perf_counter()
        outputs.append(model(x))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = {name: k["fn"].launches for name, k in KERNELS.items()}
    for name, n in launches.items():
        if n != SPEC.depth * len(requests):
            raise RuntimeError(f"{name}: {n} launches for {len(requests)} "
                               f"forwards of {SPEC.depth} blocks")
    for b in sorted(set(REQUESTS)):
        s = [t for t, rb in zip(seconds, REQUESTS) if rb == b]
        codes = torch.tensor(model.encode(requests[REQUESTS.index(b)]),
                             device=dev)
        fwd_ms = cuda_ms(lambda: model(codes), iters=10)
        emit(phase="serve", batch=b, requests=len(s),
             request_ms=1e3 * float(np.mean(s)),
             request_img_per_s=b / float(np.mean(s)),
             forward_ms=fwd_ms, forward_img_per_s=1e3 * b / fwd_ms)

    # the card's logits vs the plain path on the CPU (b=8 request)
    i8 = REQUESTS.index(8)
    got = outputs[i8].cpu().numpy()
    ref = model_cpu(requests[i8]).numpy()
    equal = float(np.mean(got == ref))
    max_diff = float(np.abs(got - ref).max())
    argmax_equal = bool((got.argmax(1) == ref.argmax(1)).all())
    emit(phase="card_vs_cpu", batch=8, logits_equal=equal,
         max_abs_diff=max_diff, argmax_equal=argmax_equal)
    if not (equal > 0.995 and max_diff <= 0.05 and argmax_equal):
        raise RuntimeError("card and CPU logits disagree beyond the "
                           "_assert_paths_agree rule")
    if not np.isfinite(got).all() or got.shape != (8, SPEC.num_classes):
        raise RuntimeError(f"bad logits: shape {got.shape}")

    logits, mean_stats, max_stats = code_stats(model, requests[i8])
    distinct = bool((logits != logits[0]).any())
    emit(phase="codes", batch=8, at_bounds_mean=mean_stats,
         at_bounds_max=max_stats, logits_distinct_across_images=distinct)
    if not distinct:
        raise RuntimeError("logits are identical across images")

    labels = np.random.default_rng(2).integers(0, SPEC.num_classes, 24)
    big = requests[REQUESTS.index(64)]
    loader = [(big[8 * i:8 * i + 8], labels[8 * i:8 * i + 8])
              for i in range(3)]
    loss, top1, top5 = engine.validate(model, loader, print_freq=1)
    emit(phase="validate", images=24, loss=loss, prec1=top1, prec5=top5)
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    emit(phase="device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    path, seconds = build.build()
    build.load_library()
    emit(phase="build", seconds=seconds, cached=seconds == 0.0,
         library=os.path.relpath(path))

    summary = phase_kernels(dev)
    launches = phase_serving(dev)

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=k["source"],
             replaces=k["replaces"], launches=launches[name],
             **summary[name]) for name, k in KERNELS.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

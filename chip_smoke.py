"""Drive the PyTorch/CUDA port (diffvit_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. device:  fails unless a CUDA card is present;
2. build:   compiles the port's kernels from diffvit_tpu_torch/csrc with nvcc
            (one nvcc per source, all started together);
3. kernels: holds each kernel against its plain PyTorch version on the card
            and times both: K1 (LIS and float softmax), K2 (int8 codes out
            and float32 out), K5 (LIS and float softmax) and K6 (the whole
            12-block encoder in one launch, on the wgmma GEMM mainloop and
            the tensor-core attention core; LIS, and the float softmax at
            b = 8) at DeiT-S shapes (B = 1, 8, 64) and a tiny shape; K4 and
            K4b at Swin-T's four stage geometries and K2 at its four widths
            (B = 1, 8, 64); K4 and K4b with the float softmax (lis=False)
            at stage 0 (B = 1, 8, 64) and stages 1-3 (B = 8, 64), on a
            shifted (masked) and an unshifted block each, and K2 emitting
            float32 at Swin-T's four widths at the same batches;
4. serving: for DeiT-S int4, the FQ-ViT DeiT-S int8 (SmoothQuant off: K5
            and K2 emitting float32), DeiT-S int4 served resident (K6 once
            per chunk of 8 images, no K1 or K2; its logits must equal the
            per-kernel forward's, and with microbatch=None too) and Swin-T
            int4: saves a seeded model
            as an int-model artifact, loads it with the port's
            load_int_model, answers uint8 requests at b = 1 (4 times), 8
            and 64 through IntModel, checks that every forward went through
            the path's kernels and no other, compares the card's logits
            with the plain path on the CPU and runs validate().  DeiT-S
            int4 also prints how far its codes use the int8 range; Swin-T
            also runs one forward through the natural-layout attention
            contract (K4b) and checks that its logits equal K4's; the
            resident phase also prints K6's device time at b = 1, 8, 64 and
            block 0's ms by step kind from the kernel's barrier stamps
            (LN, qkv, attention, proj, fc1, fc2, barrier wait);
5. branches: the other branches of the ViT forward at DeiT-S width, b = 8:
            float (-1) sites, float LayerNorm (PTF off), asymmetric
            activations, the float softmax (K1 with lis=False); launches
            per forward, and the first two images' logits against the CPU
            plain path;
6. swin_branches: the other branches of the Swin forward at Swin-T's full
            width and depth, b = 8, one request each through IntModel:
            float LayerNorm (PTF off), asymmetric activations (the float32
            stream, nonzero zero-points at the residual, patch and
            attention-output fences), the float softmax through K4 and
            through K4b,
            input_quant=False (uint8 and float32 wires, which must agree
            bit for bit) and a mixed {4, 8} bit config; launches per
            forward (K4 or K4b 12, K2 12), the first two images' logits
            against the CPU plain path, forward time; and one
            float-softmax request at b = 64;
7. alternatives: the kernels on no model path.  Kernel rows against
            their plain versions: K8 (fused_qkv_attention v1, _v3, _v4,
            _v5) and K7a (fused_attention_block) at DeiT-S b = 1, 8, 64,
            LIS and float softmax; K7b (fused_int_mlp_block) at b = 1, 8,
            64; K3 (fused_int_linear) at the DeiT-S patch, qkv, proj, fc1
            and head sites and Swin-T's patch and stage-0 qkv, b = 1 and
            64, every mode, with torch._int_mm's time beside it (the GEMM
            alone: a yardstick the port never calls).  Then the path: all
            of them fed from block 0 of DeiT-S int4 on a b = 8 request,
            held against what they stand for (K8 v1 against K1, K7a
            against K1 + proj + code fences, K7b against the fences + LN2
            + K2 + qact4; K3's raw mode bit for bit against the forward's
            int_matmul(x, w) * mult + b at the patch, proj and head).
8. attention: the tensor-core attention core (csrc/attention_mma.cuh) and
            K1's qkv GEMM on the wgmma mainloop: device time per launch
            from torch.profiler (qkv GEMM against core) for K1 at DeiT-S
            b = 1, 8, 64 (LIS and float softmax), K5 at the same batches,
            and K4/K4b at Swin-T stages 0-3, b = 1 and 64, both softmaxes;
            the core's and the GEMM's footprints (registers, local memory,
            shared memory, blocks an SM), and K6's at DeiT-S b = 1, 8, 64
            (both softmaxes), failing on a spill; K7b's two GEMM kernels'
            footprints and its device time at b = 64 come with K2's and
            K3's (phase gemm);
9. probes:  the H100 counterparts of the inline Pallas kernels of scripts/
            (diffvit_tpu_torch/probes, their own library built from
            csrc/probes): each probe kernel against its plain version at
            the script's full geometry (P1 producer, consumer and paired
            at B = 128, P2's five modes at 32768 x 512 with 220 chain
            steps, P3's five modes at 50,688 rows, P4 on a b = 64 uint8
            batch cast to float32, P5 at B = 256), paired against the two
            halves, and the served kernels that the legs time beside them
            at the legs' shapes (K1 with the fast LIS and the float
            softmax, K8's _v3, _v4 with group 2 and 4 and _v5 at B = 256;
            K2 at 50,688 rows); then each probe's timing legs once, with
            every count set to 0 before and checked after against the
            legs' exact launch counts, and each probe's answer (medians
            with their min and max over five rounds) as one JSON line.
10. calibrate: the port calibrates, bakes and serves its own DeiT-S
            (params from vit.init_params at seed 0, through
            engine.QuantizedViT): first on the Gaussian batch of 8 on the
            card and, on the plain path, on the CPU, with the share of
            equal qparam elements (at least 99.9%) and every element that
            differs, and the card-baked model's logits held against the
            CPU-baked one's; then the CLI's default Gaussian batch of 50
            for P2-ViT int4 and FQ-ViT int8 (their wall times, every
            block's softmax scale and whether the fast LIS takes it),
            served at b = 1, 8, 64 through exactly K1 + K2 and K5 + K2, 12
            of each a forward, and P2-ViT resident through K6 with logits
            equal to the per-kernel forward's bit for bit; the share of
            equal argmax between the fake-quant forward_q and the served
            integer logits is printed, not gated.

Every phase prints one JSON line.  Then come a JSON line with every kernel
of the main paths (launches, error, times, and the bound: the least time
the card could take for the same work), the card's name and power limit as
nvidia-smi reports them, and as the last line {"ok": true, "device":
{...}}.  Any failure raises: the exit code is then non-zero and no result
line is printed.  The weights are random (seeded): the repository has no
pretrained ones.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter, defaultdict

import numpy as np
import torch

from diffvit_tpu_torch import QuantConfig, engine
from diffvit_tpu_torch.data.imagenet import device_normalize
from diffvit_tpu_torch.data.synthetic import gaussian_calibration
from diffvit_tpu_torch.models import swin_int, vit_int
from diffvit_tpu_torch.models.convert import (attn_block_operands,
                                              attn_constants,
                                              int_attn_scalars,
                                              int_model_from_numpy,
                                              mlp_block_operands,
                                              swin_block_constants,
                                              swin_int_model_from_numpy)
from diffvit_tpu_torch.models.swin import SWIN_SPECS, num_bit_slots
from diffvit_tpu_torch.models.vit import VIT_SPECS, ViTSpec, patchify
from diffvit_tpu_torch.ops.bit_types import BIT_TYPE_DICT
from diffvit_tpu_torch.ops.kernels import (attention, build, gemm, linear,
                                           mlp, swin_attention)
from diffvit_tpu_torch.ops.kernels.serve import (prepare_resident,
                                                 resident_codes,
                                                 resident_codes_plain,
                                                 resident_footprint,
                                                 resident_step_ms)
from diffvit_tpu_torch.probes import (attn_overlap, ingest, overlap,
                                      overlap_mlp, pingpong, timing)
from diffvit_tpu_torch.testing import (alt_kernel_cases, linear_site_cases,
                                       random_int_model,
                                       random_swin_int_model)

SPEC = VIT_SPECS["deit_small"]  # full width and depth: 384 wide, 12 blocks
SWIN = SWIN_SPECS["swin_tiny"]  # full width and depth: 96..768, 2/2/6/2
TINY = ViTSpec("test_tiny", embed_dim=64, depth=2, num_heads=2,
               num_classes=10)
CFG = QuantConfig()  # PTF, LIS, SmoothQuant on; int4 weights
# FQ-ViT (--ptf --lis, W8A8, 4-bit LIS): SmoothQuant off, int8 weights
FQVIT = QuantConfig(smoothquant=False, bit_w=BIT_TYPE_DICT["int8"])
REQUESTS = (1, 1, 1, 1, 8, 64)  # images per request, served in this order
MICROBATCH = 8  # forward_q_int_serve's default chunk
# kernel vs plain: share of equal int8 codes, max |diff|; the float softmax
# (lis=False) is held to the JAX suite's rule for it: |diff| <= 1 on
# fewer than 2% of codes
TOL = {"exact": (0.999, 1), "softmax": (0.98, 1)}
PEAK_OPS, PEAK_BYTES = 1979e12, 3.35e12  # H100 SXM: int8 op/s, HBM B/s
# H100 SXM dense peaks by operand type (op/s); the probes' tanh chain,
# which has no published rate, counts three float32 operations a step
PEAKS = {"int8": PEAK_OPS, "bf16": 989e12, "float32": 67e12}


def _swin_plain(qkv5, bias_q, mask_div, scalars, *, num_heads, n_real,
                n_windows, bits=4, lis=True):
    return swin_attention.swin_attention_plain(
        qkv5[:, 0], qkv5[:, 1], qkv5[:, 2], bias_q, mask_div, scalars,
        n_real=n_real, n_windows=n_windows, bits=bits, lis=lis)


def _swin_plain_v2(qkv, bias_q, mask_div, scalars, *, num_heads, head_dim,
                   n_real, n_windows, bits=4, lis=True):
    bw, npad, c3 = qkv.shape
    view = qkv.view(bw, npad, 3, num_heads, head_dim).permute(0, 2, 3, 1, 4)
    o = _swin_plain(view, bias_q, mask_div, scalars, num_heads=num_heads,
                    n_real=n_real, n_windows=n_windows, bits=bits, lis=lis)
    return o.permute(0, 2, 1, 3).reshape(bw, npad, c3 // 3)


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
    "fused_swin_attention": dict(
        fn=swin_attention.fused_swin_attention, plain=_swin_plain,
        source="diffvit_tpu_torch/csrc/swin_attention.cu",
        replaces="diffvit_tpu/ops/pallas/attention.py:820"),
    "fused_swin_attention_v2": dict(
        fn=swin_attention.fused_swin_attention_v2, plain=_swin_plain_v2,
        source="diffvit_tpu_torch/csrc/swin_attention.cu",
        replaces="diffvit_tpu/ops/pallas/attention.py:928"),
    "fused_int_attention": dict(
        fn=attention.fused_int_attention,
        plain=attention.fused_int_attention_plain,
        source="diffvit_tpu_torch/csrc/qkv_attention.cu",
        replaces="diffvit_tpu/ops/pallas/attention.py:993"),
    "resident_codes": dict(
        fn=resident_codes, plain=resident_codes_plain,
        source="diffvit_tpu_torch/csrc/resident.cu",
        replaces="diffvit_tpu/ops/pallas/serve.py:316"),
    "fused_int_linear": dict(
        fn=linear.fused_int_linear, plain=linear.fused_int_linear_plain,
        source="diffvit_tpu_torch/csrc/int_linear.cu",
        replaces="diffvit_tpu/ops/pallas/linear.py:69"),
    "fused_attention_block": dict(
        fn=attention.fused_attention_block,
        plain=attention.fused_attention_block_plain,
        source="diffvit_tpu_torch/csrc/qkv_attention.cu",
        replaces="diffvit_tpu/ops/pallas/attention.py:698"),
    "fused_int_mlp_block": dict(
        fn=mlp.fused_int_mlp_block, plain=mlp.fused_int_mlp_block_plain,
        source="diffvit_tpu_torch/csrc/int_mlp_block.cu",
        replaces="diffvit_tpu/ops/pallas/mlp.py:231"),
    "fused_qkv_attention": dict(
        fn=attention.fused_qkv_attention,
        plain=attention.fused_qkv_attention_plain,
        source="diffvit_tpu_torch/csrc/qkv_attention.cu",
        replaces="diffvit_tpu/ops/pallas/attention.py:734"),
}


def _v345_plain(*args, group=None, **kw):
    """v3's plain version for v3, v4 and v5 (v4's ``group`` changes
    nothing)."""
    return attention.fused_qkv_attention_v3_plain(*args, **kw)


# K8's scheduling variants: v1's function on K1's weight layout, one kernel
for _v, _line in (("v3", 398), ("v4", 489), ("v5", 597)):
    KERNELS[f"fused_qkv_attention_{_v}"] = dict(
        fn=getattr(attention, f"fused_qkv_attention_{_v}"),
        plain=_v345_plain,
        source="diffvit_tpu_torch/csrc/qkv_attention.cu",
        replaces=f"diffvit_tpu/ops/pallas/attention.py:{_line}")
K8 = ("fused_qkv_attention", "fused_qkv_attention_v3",
      "fused_qkv_attention_v4", "fused_qkv_attention_v5")

# The probes: name -> (wrapper, plain version, source, Pallas kernel)
_PROBE_SRC = "diffvit_tpu_torch/csrc/probes/"
PROBES = {
    "attn_overlap.qkv_attention_nv": (
        attn_overlap.qkv_attention_nv, attn_overlap.qkv_attention_nv_plain,
        "attn_nv.cu", "scripts/ab_attn_overlap_r3.py:75"),
    "pingpong.producer": (pingpong.producer, pingpong.producer_plain,
                          "pingpong.cu", "scripts/ab_pingpong_probe.py:80"),
    "pingpong.consumer": (pingpong.consumer, pingpong.consumer_plain,
                          "pingpong.cu", "scripts/ab_pingpong_probe.py:102"),
    "pingpong.paired": (pingpong.paired, pingpong.paired_plain,
                        "pingpong.cu", "scripts/ab_pingpong_probe.py:119"),
    "ingest.tile_sum": (ingest.tile_sum, ingest.tile_sum_plain, "ingest.cu",
                        "scripts/ab_regime_discriminate.py:45"),
}
for _m, _line in zip(overlap.MODES, (38, 44, 49, 56, 63)):
    PROBES[f"overlap.{_m}"] = (
        overlap.KERNELS[_m], functools.partial(
            lambda a, b, v, *, iters, mode: overlap.overlap_plain(
                a, b, v, mode, iters), mode=_m),
        "overlap.cu", f"scripts/overlap_probe.py:{_line}")
for _m in overlap_mlp.MODES:
    PROBES[f"overlap_mlp.mlp_{_m}"] = (
        overlap_mlp.KERNELS[f"mlp_{_m}"], functools.partial(
            lambda *a, mode: overlap_mlp.overlap_mlp_plain(*a, mode),
            mode=_m),
        "overlap_mlp.cu", "scripts/overlap_probe_mlp.py:36")
# the attention launches by kernel name (torch.profiler's): the qkv GEMM on
# the wgmma mainloop, the tensor-core cores
LAUNCH_KINDS = (("wgmma_gemm_kernel", "gemm"), ("qkv_core_kernel", "core"),
                ("swin_core_kernel", "core"))
for _name, (_fn, _plain, _src, _at) in PROBES.items():
    KERNELS[_name] = dict(fn=_fn, plain=_plain, source=_PROBE_SRC + _src,
                          replaces=_at)


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


PROFILE_TRIES = 3  # torch.profiler now and then records no device activity


def profiled(fn, iters):
    """``prof.key_averages()`` of ``iters`` calls of ``fn`` under
    torch.profiler, after a warm-up; profiled again, up to PROFILE_TRIES
    times, while the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        if any(getattr(e, "self_device_time_total", 0) > 0 for e in events):
            return events
    raise RuntimeError("torch.profiler saw no device time")


def device_ms(fn, iters=10):
    """Device milliseconds per call: the summed time of every kernel a call
    of ``fn`` launches, from torch.profiler, after a warm-up.  Unlike
    :func:`cuda_ms` it leaves out the host's time between launches."""
    return sum(getattr(e, "self_device_time_total", 0)
               for e in profiled(fn, iters)) / 1e3 / iters


def codes(shape, seed, dev, std=30):
    """LN-like int8 codes (std 30 by default) on the card."""
    rng = np.random.default_rng(seed)
    return torch.tensor(np.clip(np.round(rng.standard_normal(shape) * std),
                                -128, 127).astype(np.int8), device=dev)


def kernel_case(name, ib, spec, batch, dev, **kw):
    """The kernel's arguments at the main path's shapes: LN-like int8 codes
    for ``batch`` images and the weights of one block.  K5 takes the qkv
    codes as the qkv requant emits them, on its strided (B, 3, H, N, D)
    view; ``kw`` goes to the kernel (``lis``, ``emit_codes``)."""
    x = codes((batch, spec.seq_len, spec.embed_dim), batch, dev)
    t = lambda a: torch.tensor(np.asarray(a), device=dev)  # noqa: E731
    if name == "fused_qkv_attention_v2":
        scalars, fast = attn_constants(ib, spec, 0)
        q = ib["qkv"]
        return ((x, t(q["w_int"]), t(q["mult"]), t(q["b"]), t(scalars)),
                dict(num_heads=spec.num_heads, head_dim=spec.head_dim,
                     n_real=spec.seq_len, lis_fast=fast, **kw))
    if name == "fused_int_attention":
        qkv = codes((batch, spec.seq_len, 3 * spec.embed_dim), batch + 7,
                    dev, std=10)
        view = qkv.view(batch, spec.seq_len, 3, spec.num_heads,
                        spec.head_dim).permute(0, 2, 3, 1, 4)
        return ((view, t(int_attn_scalars(ib, spec))),
                dict(num_heads=spec.num_heads, n_real=spec.seq_len, **kw))
    f1, f2 = ib["fc1"], ib["fc2"]
    return ((x.reshape(-1, spec.embed_dim), t(f1["w_int"]),
             t(f2["w_int"]), t(f1["mult"]), t(f1["b"]), t(f2["mult"]),
             t(f2["b"]), t(ib["mlp.qact2"]["scale"]),
             t(ib["mlp.qact1"]["scale"])), kw)


def nbytes(a):
    """Bytes of a tensor, or of every tensor of a dict (K6's packed model)."""
    if isinstance(a, dict):
        return sum(nbytes(v) for v in a.values())
    return a.numel() * a.element_size() if isinstance(a, torch.Tensor) else 0


def work(name, args, kw):
    """(operations, bytes) one call needs: every input byte read once and
    every output byte written once; the integer products, and for the
    attention cores the scores and attn@v over the real keys."""
    inputs = sum(nbytes(a) for a in (*args, *kw.values()))
    if name in PROBES:
        return probe_work(name, args, kw, inputs)
    if name == "fused_int_linear":
        x, w = args[:2]
        rows, k = x.shape
        n = w.shape[1]
        out = rows * n * (1 if kw.get("emit_codes") else 4)
        return 2 * rows * k * n, inputs + out
    if name in K8 or name == "fused_attention_block":
        x = args[0]
        b, n, cin = x.shape
        w = args[2] if name == "fused_attention_block" else args[1]
        c = w.shape[0] * w.shape[2] if w.dim() == 3 else w.shape[1] // 3
        ops = 2 * b * n * cin * 3 * c + 4 * b * n * kw["n_real"] * c
        if name != "fused_attention_block":
            return ops, inputs + b * n * c
        cout = args[5].shape[2]
        return ops + 2 * b * n * c * cout, inputs + b * n * cout * 4
    if name == "fused_int_mlp_block":
        rows, c = args[0].shape
        hid = kw["w1"].shape[1]
        return 4 * rows * c * hid, inputs + rows * c * 4
    if name == "resident_codes":
        packed, x = args
        rows, c = x.shape
        depth, _, c3 = packed["wqkv"].shape
        hid = packed["w1"].shape[2]
        ops = depth * (2 * rows * c * (c3 + c + 2 * hid)
                       + 4 * rows * kw["n_real"] * c)
        return ops, inputs + rows * c
    if name == "fused_qkv_attention_v2":
        x, w = args[0], args[1]
        b, n, cin = x.shape
        c = w.shape[1] // 3
        ops = 2 * b * n * cin * 3 * c + 4 * b * n * kw["n_real"] * c
        return ops, inputs + b * n * c
    if name == "fused_int_mlp":
        x, w1, w2 = args[:3]
        rows, cin = x.shape
        hid, cout = w2.shape
        out = rows * cout * (1 if kw.get("emit_codes") else 4)
        return 2 * rows * (cin * hid + hid * cout), inputs + out
    # the attention cores: K5 (B, 3, H, N, D), K4 the same on windows, K4b
    # the natural (Bw, N, 3C)
    qkv = args[0]
    if qkv.dim() == 5:
        b, _, h, n, d = qkv.shape
        c = h * d
    else:
        b, n, c3 = qkv.shape
        c = c3 // 3
    n_real = kw["n_real"]
    return 4 * b * n * n_real * c, inputs + b * n * c


def probe_work(name, args, kw, inputs):
    """(operations by operand type, bytes) of one probe call, as
    :func:`work`: the bytes each input read once and each output written
    once (P3's g_src only where its mode reads it); P1 and P5 count their
    int8 GEMM, scores and attn@v (P1's consumer over the real keys, P5 over
    all Npad), P2 its bf16 dot and three float32 operations a chain step,
    P3 its two int8 GEMMs, P4 one float32 add an element."""
    probe = name.split(".")[1]
    if probe == "consumer":
        scores, v = args[0], args[1]
        rows = scores.numel() // scores.shape[-1]
        return ({"int8": 2 * rows * kw["n_real"] * v.shape[-1]},
                 inputs + v.numel())
    if probe in ("qkv_attention_nv", "producer", "paired"):
        x, w = args[0], args[1]
        b, n, cin = x.shape
        c = w.shape[1] // 3
        ops = 2 * b * n * cin * 3 * c + 2 * b * n * n * c  # GEMM, scores
        if probe == "qkv_attention_nv":
            return {"int8": ops + 2 * b * n * n * c}, inputs + b * n * c
        out = b * c // kw["head_dim"] * n * n
        if probe == "paired":
            consumer, more = probe_work("pingpong.consumer", args[3:5], kw, 0)
            ops += consumer["int8"]
            out += more
        return {"int8": ops}, inputs + out
    if probe == "tile_sum":
        return {"float32": args[0].numel()}, inputs + 8 * 128 * 4
    if probe.startswith("mlp_"):
        x, w1 = args[0], args[1]
        rows, cin = x.shape
        if probe != "mlp_input":
            inputs -= nbytes(args[5])  # g_src is read in mode input only
        return ({"int8": 4 * rows * cin * w1.shape[1]},
                inputs + rows * cin * 4)
    a, b, v = args
    chain = 0 if probe == "dot_only" else 3 * kw["iters"] * v.numel()
    ops = {"float32": chain}
    if probe != "vpu_only":
        ops["bf16"] = 2 * a.shape[0] * a.shape[1] * b.shape[1]
    return ops, inputs + 2 * v.numel() * 4


def bound(name, args, kw):
    """The least time the card could take for the call: the larger of the
    operations over the peak rate of their type (the int8 tensor cores
    unless the work says otherwise) and the bytes over the HBM rate.
    Returns (ms, "operations" or "bytes")."""
    ops, nbytes = work(name, args, kw)
    if not isinstance(ops, dict):
        ops = {"int8": ops}
    t_ops = max(n / PEAKS[kind] for kind, n in ops.items())
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def swin_cases(ip, stage, batch, dev, blk=1, cfg=CFG, emit_codes=True):
    """K4, K4b and K2 arguments at Swin-T stage ``stage`` for ``batch``
    images: block ``blk`` of the stage (block 1 is shifted: a mask in
    stages 0-2; block 0 has none), qkv as the qkv GEMM emits it, K4 on its
    strided (Bw, 3, H, n, D) view.  ``cfg.lis`` False gives the float
    softmax's arguments; ``emit_codes`` False K2 emitting float32."""
    p = f"layers.{stage}.blocks.{blk}"
    ib, qp = ip["layers"][stage]["blocks"][blk], ip["qp"]
    k = swin_block_constants(ib, qp, p, SWIN, stage, blk, cfg)
    t = lambda a: None if a is None else torch.tensor(  # noqa: E731
        np.asarray(a), device=dev)
    res = SWIN.stage_resolution(stage)[0]
    nw, heads, c = (res // 7) ** 2, SWIN.num_heads[stage], \
        SWIN.stage_dim(stage)
    qkv = codes((batch * nw, 49, 3 * c),
                100 * stage + batch + 1000 * (1 - blk), dev)
    consts = (t(k["bias_q"]), t(k["mask_div"]), t(k["attn_scalars"]))
    kw = dict(num_heads=heads, n_real=49,
              n_windows=1 if k["mask_div"] is None else nw)
    if not cfg.lis:
        kw.update(bits=cfg.bit_s.bits, lis=False)
    view = qkv.view(batch * nw, 49, 3, heads, c // heads) \
        .permute(0, 2, 3, 1, 4)
    f1, f2 = ib["fc1"], ib["fc2"]
    mlp_args = (codes((batch * res * res, c), stage + batch, dev),
                t(f1["w_int"]), t(f2["w_int"]),
                t(qp[f"{p}.qact3.scale"] * f1["sw"]), t(f1["b"]),
                t(qp[f"{p}.mlp.qact1.scale"] * f2["sw"]), t(f2["b"]),
                t(qp[f"{p}.mlp.qact2.scale"]), t(qp[f"{p}.mlp.qact1.scale"]))
    return {"fused_swin_attention": ((view, *consts), kw),
            "fused_swin_attention_v2": ((qkv, *consts),
                                        dict(kw, head_dim=c // heads)),
            "fused_int_mlp": (mlp_args, dict(emit_codes=emit_codes))}


def hold(name, args, kw, tol="exact", decode=None, compare=None, iters=20,
         **where):
    """The kernel vs its plain version on the same inputs on the card, both
    timed in turns (plain, kernel, kernel, plain; ``iters`` calls each); one
    JSON line.  Fails beyond the tolerance ``TOL[tol]``.  ``decode`` turns a
    float32 output into its int8-grid codes; a tuple of outputs is held as
    one.  ``compare(got, want)`` -> (share, max |diff|, ok) replaces the
    codes rule for float outputs.  Returns (max |diff|, ms, plain ms)."""
    k = KERNELS[name]
    got = k["fn"](*args, **kw)
    want = k["plain"](*args, **kw)
    torch.cuda.synchronize()
    if compare is not None:
        equal, max_diff, ok = compare(got, want)
    else:
        if isinstance(got, tuple):
            got, want = (torch.cat([t.flatten() for t in o])
                         for o in (got, want))
        if decode is not None:
            got, want = decode(got), decode(want)
        diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
        equal = float((got == want).float().mean())
        max_diff = int(diff.max())
        min_equal, max_allowed = TOL[tol]
        ok = equal >= min_equal and max_diff <= max_allowed
    t = [cuda_ms(lambda: f(*args, **kw), iters)
         for f in (k["plain"], k["fn"], k["fn"], k["plain"])]
    ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    opts = {key: v for key, v in kw.items()
            if key in ("lis", "lis_fast", "group", "emit_codes", "iters")}
    shape = next(a for a in args if isinstance(a, torch.Tensor)).shape
    emit(phase="kernel", kernel=name, **where, **opts,
         shape=list(shape), equal=equal, max_abs_diff=max_diff,
         ms=ms, plain_ms=plain_ms)
    if not ok:
        raise RuntimeError(
            f"{name} {where} {opts}: {equal:.6f} equal or within tolerance, "
            f"max |diff| {max_diff} (tolerance {compare or TOL[tol]})")
    return max_diff, ms, plain_ms


def note(summary, name, result, heaviest=None, library_ms=None,
         variant=None):
    """Record a kernel row's |diff| in ``summary[name]`` and, for the row
    at the kernel's heaviest shape (``heaviest`` = (label, args, kw)), its
    times, its bound and the library call's time.  ``variant`` names a
    second branch of the kernel (the float softmax, float32 out): its
    heaviest row's times go under ``{variant}_ms``, ``{variant}_plain_ms``
    and ``{variant}_bound_ms`` beside the main branch's."""
    s = summary[name]
    s["max_abs_err"] = max(s["max_abs_err"], result[0])
    if heaviest and variant:
        at, args, kw = heaviest
        s[f"{variant}_ms"], s[f"{variant}_plain_ms"] = result[1], result[2]
        s[f"{variant}_bound_ms"], s[f"{variant}_at"] = \
            bound(name, args, kw)[0], at
    elif heaviest:
        at, args, kw = heaviest
        s["ms"], s["plain_ms"] = result[1], result[2]
        s["bound_ms"], s["bound_by"] = bound(name, args, kw)
        s["library_ms"], s["at"] = library_ms, at


def phase_kernels(dev, summary):
    """Each kernel of the model paths vs its plain version on the card;
    records per kernel the largest |diff| and, at the heaviest shape of
    the main paths (DeiT-S b=64 for K1, K2, K5 and K6; Swin-T stage 0 b=64
    for K4 and K4b), its times and its bound."""
    for spec, batches in ((SPEC, (1, 8, 64)), (TINY, (2,))):
        ib = random_int_model(spec, CFG, seed=0)["blocks"][0]
        ib_fq = random_int_model(spec, FQVIT, seed=0)["blocks"][0]
        # (kernel, block, options, tolerance); the first row of each kernel
        # is the one its main path runs
        cases = (("fused_qkv_attention_v2", ib, {}, "exact"),
                 ("fused_qkv_attention_v2", ib, dict(lis=False, bits=8),
                  "softmax"),
                 ("fused_int_mlp", ib, dict(emit_codes=True), "exact"),
                 ("fused_int_mlp", ib_fq, dict(emit_codes=False), "exact"),
                 ("fused_int_attention", ib_fq, dict(lis=True), "exact"),
                 ("fused_int_attention", ib_fq, dict(lis=False), "softmax"))
        for name, blk, opts, tol in cases:
            main_row = opts.get("emit_codes", True) and opts.get("lis", True)
            for b in batches:
                args, kw = kernel_case(name, blk, spec, b, dev, **opts)
                decode = None
                if name == "fused_int_mlp" and not kw["emit_codes"]:
                    # float32 out: compare its codes on the mlp.qact2 grid
                    def decode(y, s=args[7]):
                        return torch.round(y / s)
                heaviest = spec is SPEC and b == 64 and main_row \
                    and (f"{spec.name} b=64", args, kw)
                note(summary, name, hold(name, args, kw, tol, decode,
                                         spec=spec.name, batch=b), heaviest)
        # K6: the whole encoder (12 blocks at DeiT-S) in one launch
        ip = int_model_from_numpy(random_int_model(spec, CFG, seed=0), spec,
                                  dev, CFG)
        packed = prepare_resident(ip, spec, CFG)
        for lis, tol, bs in ((True, "exact", batches),
                             (False, "softmax", batches[1:2] or batches)):
            for b in bs:
                args = (packed, codes((b * spec.seq_len, spec.embed_dim),
                                      b + 11, dev))
                kw = dict(n_real=spec.seq_len, bits=4, lis=lis, nelems=b)
                heaviest = spec is SPEC and b == 64 and lis \
                    and (f"{spec.name} b=64", args, kw)
                note(summary, "resident_codes",
                     hold("resident_codes", args, kw, tol, spec=spec.name,
                          batch=b), heaviest)
    ip = random_swin_int_model(SWIN, CFG, seed=0)
    for stage in range(SWIN.num_layers):
        for b in (1, 8, 64):
            for name, (args, kw) in swin_cases(ip, stage, b, dev).items():
                heaviest = name != "fused_int_mlp" and stage == 0 \
                    and b == 64 and (f"{SWIN.name} stage 0 b=64", args, kw)
                note(summary, name, hold(name, args, kw, spec=SWIN.name,
                                         stage=stage, batch=b), heaviest)
    # K4 and K4b with the float softmax, on a shifted (masked) and an
    # unshifted block, and K2 emitting float32, at every shape the Swin-T
    # branch forwards give them (b=8 and b=64; b=1 at stage 0 as well)
    lis_off = QuantConfig(lis=False)
    ip = random_swin_int_model(SWIN, lis_off, seed=0)
    for stage in range(SWIN.num_layers):
        for b in ((1, 8, 64) if stage == 0 else (8, 64)):
            top = stage == 0 and b == 64
            for blk in (1, 0):
                cases = swin_cases(ip, stage, b, dev, blk, lis_off,
                                   emit_codes=False)
                for name in ("fused_swin_attention",
                             "fused_swin_attention_v2"):
                    args, kw = cases[name]
                    heaviest = top and blk == 1 and (
                        f"{SWIN.name} stage 0 b=64", args, kw)
                    note(summary, name,
                         hold(name, args, kw, "exact", spec=SWIN.name,
                              stage=stage, batch=b,
                              block="shifted" if blk else "unshifted"),
                         heaviest, variant="float_softmax")
            args, kw = cases["fused_int_mlp"]  # block 0's weights

            def decode(y, s=args[7]):  # float32 out: its mlp.qact2 codes
                return torch.round(y / s)
            note(summary, "fused_int_mlp",
                 hold("fused_int_mlp", args, kw, "exact", decode,
                      spec=SWIN.name, stage=stage, batch=b),
                 top and (f"{SWIN.name} stage 0 b=64", args, kw),
                 variant="float32_out")


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


def drive(expected, run):
    """Set every kernel's count to 0, call ``run``, read the counts: fails
    unless each kernel launched exactly ``expected[name]`` times (0 for the
    kernels not named).  Returns run's result and the counts."""
    for k in KERNELS.values():
        k["fn"].launches = 0
    out = run()
    torch.cuda.synchronize()
    launches = {name: k["fn"].launches for name, k in KERNELS.items()}
    for name, n in launches.items():
        if n != expected.get(name, 0):
            raise RuntimeError(f"{name}: {n} launches, expected "
                               f"{expected.get(name, 0)}")
    return out, launches


def agree(got, ref, shape, **where):
    """The _assert_paths_agree rule between two integer paths (the JAX
    suite's): > 99.5% of logits equal, |diff| <= 0.05, equal argmax."""
    equal = float(np.mean(got == ref))
    max_diff = float(np.abs(got - ref).max())
    argmax_equal = bool((got.argmax(1) == ref.argmax(1)).all())
    emit(**where, logits_equal=equal, max_abs_diff=max_diff,
         argmax_equal=argmax_equal)
    if not (equal > 0.995 and max_diff <= 0.05 and argmax_equal):
        raise RuntimeError(f"{where}: logits disagree beyond the "
                           "_assert_paths_agree rule")
    if not np.isfinite(got).all() or got.shape != shape:
        raise RuntimeError(f"{where}: bad logits, shape {got.shape}")


def serve(spec, ip_np, path_kernels, dev, cfg=CFG, label=None,
          resident=False):
    """Save ``ip_np`` (under ``cfg``) as an artifact, load it on the card
    and on the CPU (``resident``: served through K6), answer the uint8
    requests through IntModel with a launch check (each kernel of
    ``path_kernels`` once per block of every forward, or K6 once per chunk
    of MICROBATCH images), time requests and forwards, hold the b=8 logits
    against the CPU plain path and run validate().  ``label`` names the
    model in the JSON lines (default: the spec's name).  Returns the model,
    the requests, their logits and the launches."""
    label = label or spec.name
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, f"{spec.name}.npz")
        engine.save_int_model(path, ip_np, spec, cfg)
        model = engine.load_int_model(path, dev, resident=resident)
        model_cpu = engine.load_int_model(path, "cpu", resident=resident)
    size = spec.img_size
    rng = np.random.default_rng(1)
    requests = [rng.integers(0, 256, (b, 3, size, size), dtype=np.uint8)
                for b in REQUESTS]
    model(requests[0])  # warm-up: library load, cuBLAS handles
    torch.cuda.synchronize()

    depth = sum(spec.depths) if model.is_swin else spec.depth
    seconds = []

    def run():
        outputs = []
        for x in requests:
            t0 = time.perf_counter()
            outputs.append(model(x))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        return outputs

    expected = {name: depth * len(requests) for name in path_kernels}
    if resident:
        expected = {"resident_codes": sum(-(-b // MICROBATCH)
                                          for b in REQUESTS)}
    outputs, launches = drive(expected, run)
    for b in sorted(set(REQUESTS)):
        s = [t for t, rb in zip(seconds, REQUESTS) if rb == b]
        x = torch.tensor(model.encode(requests[REQUESTS.index(b)]),
                         device=dev)
        fwd_ms = cuda_ms(lambda: model(x), iters=10)
        emit(phase="serve", model=label, batch=b, requests=len(s),
             request_ms=1e3 * float(np.mean(s)),
             request_img_per_s=b / float(np.mean(s)),
             forward_ms=fwd_ms, forward_img_per_s=1e3 * b / fwd_ms)

    # the card's logits vs the plain path on the CPU (b=8 request)
    i8 = REQUESTS.index(8)
    agree(outputs[i8].cpu().numpy(), model_cpu(requests[i8]).numpy(),
          (8, spec.num_classes), phase="card_vs_cpu", model=label,
          batch=8)

    labels = np.random.default_rng(2).integers(0, spec.num_classes, 24)
    big = requests[REQUESTS.index(64)]
    loader = [(big[8 * i:8 * i + 8], labels[8 * i:8 * i + 8])
              for i in range(3)]
    loss, top1, top5 = engine.validate(model, loader, print_freq=1)
    emit(phase="validate", model=label, images=24, loss=loss,
         prec1=top1, prec5=top5)
    return model, requests, outputs, launches


def phase_serving(dev):
    """DeiT-S int4 through K1 and K2, with the code statistics."""
    model, requests, _, launches = serve(
        SPEC, random_int_model(SPEC, CFG, seed=0),
        ("fused_qkv_attention_v2", "fused_int_mlp"), dev)
    x8 = requests[REQUESTS.index(8)]
    logits, mean_stats, max_stats = code_stats(model, x8)
    distinct = bool((logits != logits[0]).any())
    emit(phase="codes", batch=8, at_bounds_mean=mean_stats,
         at_bounds_max=max_stats, logits_distinct_across_images=distinct)
    if not distinct:
        raise RuntimeError("logits are identical across images")
    return launches


def phase_serving_fqvit(dev):
    """The FQ-ViT DeiT-S int8 (SmoothQuant off) through K5 and K2 emitting
    float32: 12 launches of each per forward, none of K1."""
    _, _, _, launches = serve(
        SPEC, random_int_model(SPEC, FQVIT, seed=0),
        ("fused_int_attention", "fused_int_mlp"), dev, FQVIT,
        f"{SPEC.name} fqvit_int8")
    return launches


def phase_serving_resident(dev, summary):
    """DeiT-S int4 served resident: K6 once per chunk of MICROBATCH images
    and no K1 or K2 (checked by serve); every request's logits equal the
    per-kernel IntModel's on the card; b=64 in one launch
    (``microbatch=None``) gives the same logits, and its forward is
    timed.  Then K6 alone at b = 1, 8, 64 on the model's packed weights:
    its device time (torch.profiler) and block 0's ms by step kind from
    one launch with its barrier stamps on (``resident_step_ms``); the
    b=64 device time and stamped total go into the kernels line."""
    label = f"{SPEC.name} resident"
    ip_np = random_int_model(SPEC, CFG, seed=0)
    model, requests, outputs, launches = serve(SPEC, ip_np, (), dev,
                                               label=label, resident=True)
    per_kernel = engine.IntModel(ip_np, SPEC, CFG, dev)
    equal = all(np.array_equal(o.cpu().numpy(), per_kernel(x).cpu().numpy())
                for o, x in zip(outputs, requests))
    x64 = torch.tensor(model.encode(requests[REQUESTS.index(64)]),
                       device=dev)

    def one_launch():
        with torch.inference_mode():
            return vit_int.forward_q_int_serve(model.ip, SPEC, CFG, x64,
                                               packed=model.packed,
                                               microbatch=None)

    whole, _ = drive({"resident_codes": 1}, one_launch)
    equal_whole = bool(np.array_equal(
        whole.cpu().numpy(), outputs[REQUESTS.index(64)].cpu().numpy()))
    emit(phase="resident", model=label, logits_equal_per_kernel=equal,
         microbatch_none_equal=equal_whole, batch=64,
         microbatch_none_forward_ms=cuda_ms(one_launch, iters=10))
    if not (equal and equal_whole):
        raise RuntimeError("the resident forward's logits differ from the "
                           "per-kernel forward's, or microbatch=None differs")
    for b in (1, 8, 64):
        x = codes((b * SPEC.seq_len, SPEC.embed_dim), b + 11, dev)
        kw = dict(n_real=SPEC.seq_len, lis=True, nelems=b)
        ms = device_ms(lambda: resident_codes(model.packed, x, **kw))
        steps = resident_step_ms(model.packed, x, **kw)
        emit(phase="resident", model=label, batch=b, device_ms=ms,
             step_ms=steps)
        if b == 64:
            summary["resident_codes"].update(device_ms=ms,
                                             stamped_ms=steps["total"])
    return launches


def phase_branches(dev):
    """The other branches of the ViT forward at DeiT-S width and depth, one
    b=8 request each through IntModel: launches per forward as the
    reference's branch rules give them, the forward's time, and the card's
    logits for the first two images against the CPU plain path on those
    two."""
    k1, k2, k5 = "fused_qkv_attention_v2", "fused_int_mlp", \
        "fused_int_attention"
    bc = [4] * (4 * SPEC.depth + 2)
    for slot in (1, 4 * 5 + 2, 4 * 11 + 4):  # qkv 0, proj 5, fc2 11
        bc[slot] = -1
    ptf_off, lis_off = QuantConfig(ptf=False), QuantConfig(lis=False)
    cases = {
        # block 0: K5 (float qkv) and K2; block 5: the unfused attention
        # (float proj) and K2; block 11: K1 and the unfused MLP
        "float_sites": (CFG, random_int_model(SPEC, CFG, 3, bc),
                        {k1: 10, k5: 1, k2: 11}),
        # float LayerNorm: K5, the unfused MLP, the float-LN head
        "ptf_off": (ptf_off, random_int_model(SPEC, ptf_off, 3), {k5: 12}),
        # the float32 stream: K1, the fake-quant fences, K2 emitting float32
        "asymmetric": (CFG, dict(random_int_model(SPEC, CFG, 3),
                                 sym_acts=False), {k1: 12, k2: 12}),
        # K1 with the float softmax (lis=False) and K2
        "float_softmax": (lis_off, random_int_model(SPEC, lis_off, 3),
                          {k1: 12, k2: 12}),
    }
    x = np.random.default_rng(4).integers(0, 256, (8, 3, 224, 224),
                                          dtype=np.uint8)
    launches = {}
    for name, (cfg, ip_np, per_forward) in cases.items():
        model = engine.IntModel(ip_np, SPEC, cfg, dev)
        got, launches[f"{SPEC.name} {name}"] = drive(per_forward,
                                                     lambda: model(x))
        xc = torch.tensor(model.encode(x), device=dev)
        fwd_ms = cuda_ms(lambda: model(xc), iters=5)
        got = got.cpu().numpy()
        if got.shape != (8, SPEC.num_classes) or not np.isfinite(got).all():
            raise RuntimeError(f"{name}: bad logits, shape {got.shape}")
        want = engine.IntModel(ip_np, SPEC, cfg, "cpu")(x[:2]).numpy()
        agree(got[:2], want, (2, SPEC.num_classes), phase="branches",
              branch=name, batch=8, images_held=2, forward_ms=fwd_ms)
    return launches


def phase_serving_swin(dev):
    """Swin-T int4 through K4 and K2; then one forward through K4b (the
    natural-layout contract), whose logits must equal K4's."""
    model, requests, _, launches = serve(
        SWIN, random_swin_int_model(SWIN, CFG, seed=0),
        ("fused_swin_attention", "fused_int_mlp"), dev)
    x = torch.tensor(model.encode(requests[REQUESTS.index(8)]), device=dev)
    with torch.inference_mode():
        want = model(x).cpu().numpy()
        got, launches_v2 = drive(
            {name: sum(SWIN.depths) for name in
             ("fused_swin_attention_v2", "fused_int_mlp")},
            lambda: swin_int.forward_q_int(model.ip, SWIN, CFG, x,
                                           attn_v2=True))
    got = got.cpu().numpy()
    equal = bool(np.array_equal(got, want))
    distinct = bool((got != got[0]).any())
    emit(phase="attn_v2", model=SWIN.name, batch=8, logits_equal_k4=equal,
         launches=launches_v2["fused_swin_attention_v2"],
         logits_distinct_across_images=distinct)
    if not (equal and distinct):
        raise RuntimeError("the K4b forward's logits differ from K4's, or "
                           "are identical across images")
    return launches, launches_v2


def phase_swin_branches(dev):
    """The other branches of the Swin forward at Swin-T's full width and
    depth, one b=8 request each through IntModel: launches per forward (K4
    or K4b once a block, K2 once a block), the forward's time, and the
    card's logits for the first two images against the CPU plain path on
    those two (a Swin-T forward of 8 on the CPU takes seconds a case).
    The asymmetric model's residual fences have a nonzero zero-point.
    ``input_quant=False`` has no codes wire: its uint8 request is
    normalized on the card and must equal the float32 wire's logits bit
    for bit.  Then one float-softmax request at b=64, timed."""
    k4, k4b, k2 = "fused_swin_attention", "fused_swin_attention_v2", \
        "fused_int_mlp"
    depth = sum(SWIN.depths)
    ptf_off, lis_off = QuantConfig(ptf=False), QuantConfig(lis=False)
    niq = dataclasses.replace(SWIN, input_quant=False)
    n = num_bit_slots(SWIN)
    mixed = [8, 4] * (n // 2) + [8] * (n % 2)
    asym = dict(random_swin_int_model(SWIN, CFG, 3), sym_acts=False)
    # the residual fences, the patch fence and the attention's output fence
    fences = re.compile(r"(blocks\.\d+\.(attn\.qact4|qact[24])|patch\.qact)"
                        r"\.zp$")
    asym["qp"] = {k: v + np.float32(3.0) if fences.search(k) else v
                  for k, v in asym["qp"].items()}
    # name -> (spec, config, int-model, the attention contracts it runs)
    cases = {
        "float_ln": (SWIN, ptf_off, random_swin_int_model(SWIN, ptf_off, 3),
                     (k4,)),
        "asymmetric": (SWIN, CFG, asym, (k4,)),
        "float_softmax": (SWIN, lis_off,
                          random_swin_int_model(SWIN, lis_off, 3), (k4, k4b)),
        "no_input_quant": (niq, CFG, random_swin_int_model(niq, CFG, 3),
                           (k4,)),
        "mixed_bits": (SWIN, CFG, random_swin_int_model(
            SWIN, CFG, 3, bit_config=mixed), (k4,)),
    }
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, (8, 3, 224, 224), dtype=np.uint8)
    x64 = rng.integers(0, 256, (64, 3, 224, 224), dtype=np.uint8)
    launches = {}

    def wire(model, pixels):
        """The request as the forward takes it: codes, or float32 pixels
        where the model has no codes wire."""
        if model.input_lut is None:
            return device_normalize(torch.tensor(pixels, device=dev))
        return torch.tensor(model.encode(pixels), device=dev)

    for name, (spec, cfg, ip_np, contracts) in cases.items():
        model = engine.IntModel(ip_np, spec, cfg, dev)
        model_cpu = engine.IntModel(ip_np, spec, cfg, "cpu")
        for attn in contracts:
            label = name + ("_v2" if attn == k4b else "")
            for m in (model, model_cpu):
                m._forward = functools.partial(swin_int.forward_q_int,
                                               attn_v2=attn == k4b)
            got, launches[f"{SWIN.name} {label}"] = drive(
                {attn: depth, k2: depth}, lambda: model(x))
            xw = wire(model, x)
            fwd_ms = cuda_ms(lambda: model(xw), iters=5)
            got = got.cpu().numpy()
            if got.shape != (8, SWIN.num_classes) \
                    or not np.isfinite(got).all():
                raise RuntimeError(f"{label}: bad logits, shape {got.shape}")
            agree(got[:2], model_cpu(x[:2]).numpy(), (2, SWIN.num_classes),
                  phase="swin_branches", branch=label, batch=8,
                  images_held=2, forward_ms=fwd_ms)
            if model.input_lut is None and not np.array_equal(
                    model(xw).cpu().numpy(), got):
                raise RuntimeError(f"{label}: the uint8 wire's logits "
                                   "differ from the float32 wire's")
        if name == "float_softmax":  # the same model at b=64, through K4
            model._forward = swin_int.forward_q_int
            out, launches[f"{SWIN.name} float_softmax b=64"] = drive(
                {k4: depth, k2: depth}, lambda: model(x64))
            xw = wire(model, x64)
            fwd_ms = cuda_ms(lambda: model(xw), iters=5)
            finite = bool(torch.isfinite(out).all())
            emit(phase="swin_branches", branch="float_softmax", batch=64,
                 forward_ms=fwd_ms, forward_img_per_s=64e3 / fwd_ms,
                 finite=finite)
            if not finite or tuple(out.shape) != (64, SWIN.num_classes):
                raise RuntimeError("float_softmax b=64: bad logits")
    return launches


def int_mm_takes(x, w):
    """Whether ``torch._int_mm`` takes the shape: M > 16, K and N multiples
    of 8."""
    return x.shape[0] > 16 and x.shape[1] % 8 == 0 and w.shape[1] % 8 == 0


def int_mm_ms(x, w):
    """The time of ``torch._int_mm(x, w)``, the GEMM alone with int32 out
    (K3's yardstick; the port never calls it), or None where it takes no
    such shape."""
    return cuda_ms(lambda: torch._int_mm(x, w)) if int_mm_takes(x, w) \
        else None


def linear_modes(out_scale):
    """K3's three modes: (mode, kwargs, decode to comparable integers)."""
    return (("raw", {}, lambda y: y.view(torch.int32)),
            ("fq", dict(out_scale=out_scale),
             lambda y, s=out_scale: torch.round(y / s)),
            ("codes", dict(out_scale=out_scale, emit_codes=True), None))


CALIB_SERVE = (1, 8, 64)  # images per request on the calibrated models


def _qparam_diffs(got, want):
    """(elements, equal elements, every differing element with its site)
    between two qparam dicts of the same keys."""
    total = equal = 0
    diffs = []
    for k in sorted(want):
        a, b = got[k].cpu().numpy(), want[k].cpu().numpy()
        if a.shape != b.shape:
            raise RuntimeError(f"{k}: shape {a.shape} against {b.shape}")
        ne = np.argwhere(a != b)
        total += a.size
        equal += a.size - len(ne)
        diffs += [{"site": k, "index": [int(i) for i in idx],
                   "card": float(a[tuple(idx)]), "cpu": float(b[tuple(idx)])}
                  for idx in ne]
    return total, equal, diffs


def _calibrated(cfg, x, dev):
    """engine.QuantizedViT of DeiT-S (params at seed 0) calibrated on
    ``x`` on ``dev``, and the calibration's wall seconds."""
    q = engine.QuantizedViT(SPEC.name, cfg, seed=0, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    q.calibrate(x)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return q, time.perf_counter() - t0


def phase_calibrate(dev):
    """Calibrate -> bake -> serve on the card, the port's own DeiT-S: the
    card against the CPU at b=8, then the b=50 P2-ViT int4 and FQ-ViT int8
    bakes served through their kernels and P2-ViT through K6.  Returns the
    launches by path."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 is on for float32 matmuls")
    k1, k2, k5 = "fused_qkv_attention_v2", "fused_int_mlp", \
        "fused_int_attention"
    rng = np.random.default_rng(6)
    requests = [rng.integers(0, 256, (b, 3, 224, 224), dtype=np.uint8)
                for b in CALIB_SERVE]

    # the card against the CPU, b = 8
    x8 = gaussian_calibration(8, seed=0)
    card, card_s = _calibrated(CFG, x8, dev)
    cpu, cpu_s = _calibrated(CFG, x8, torch.device("cpu"))
    total, equal, diffs = _qparam_diffs(card.qparams, cpu.qparams)
    emit(phase="calibrate", part="card_vs_cpu", batch=8,
         qparam_elements=total, equal_share=equal / total,
         differing=len(diffs), card_seconds=card_s, cpu_seconds=cpu_s,
         global_distance_equal=bool(np.array_equal(card.global_distance,
                                                   cpu.global_distance)))
    emit(phase="calibrate_diffs", elements=diffs)
    if equal / total < 0.999:
        raise RuntimeError(f"card vs CPU: {equal / total:.6f} of qparam "
                           "elements equal, under 0.999")
    x = requests[1]
    got, launches_cvc = drive({k1: SPEC.depth, k2: SPEC.depth},
                              lambda: card.prepare_int()(x))
    agree(got.cpu().numpy(), cpu.prepare_int()(x).numpy(),
          (8, SPEC.num_classes), phase="calibrate", part="card_vs_cpu_logits",
          batch=8)

    # the CLI's default calibration batch of 50, two configurations
    x50 = gaussian_calibration(50, seed=0)
    paths = {}
    for label, cfg, per_forward in (
            ("p2vit_int4", CFG, {k1: SPEC.depth, k2: SPEC.depth}),
            ("fqvit_int8", FQVIT, {k5: SPEC.depth, k2: SPEC.depth})):
        torch.cuda.reset_peak_memory_stats()
        q, secs = _calibrated(cfg, x50, dev)
        s_a = [float(q.qparams[f"blocks.{i}.attn.qact_attn1.scale"])
               for i in range(SPEC.depth)]
        emit(phase="calibrate", part="b50", config=label, batch=50,
             seconds=secs, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
             softmax_scale_log2=[float(np.log2(v)) for v in s_a],
             lis_fast_ok=[attention.lis_fast_ok(v) for v in s_a],
             lis_sum_fits=[attention.lis_sum_fits(v, SPEC.seq_len)
                           for v in s_a])
        model = q.prepare_int()
        model(requests[0])  # warm-up: K-major weight copies
        expected = {k: n * len(requests) for k, n in per_forward.items()}
        outs, launches = drive(expected,
                               lambda: [model(r) for r in requests])
        if label == "p2vit_int4":
            launches = {k: n + launches_cvc[k] for k, n in launches.items()}
        paths[f"{SPEC.name} calibrated {label}"] = launches
        for r, o in zip(requests, outs):
            o = o.cpu().numpy()
            if o.shape != (len(r), SPEC.num_classes) \
                    or not np.isfinite(o).all():
                raise RuntimeError(f"{label}: bad logits, shape {o.shape}")
            fake = q(r).cpu().numpy()
            xc = torch.tensor(model.encode(r), device=dev)
            emit(phase="calibrate", part="serve", config=label,
                 batch=len(r), forward_ms=cuda_ms(lambda: model(xc), 5),
                 argmax_equal_forward_q=float(np.mean(
                     fake.argmax(1) == o.argmax(1))),
                 logits_distinct_across_images=bool(len(r) == 1 or (
                     o != o[0]).any()))
        if label != "p2vit_int4":
            continue
        resident = q.prepare_int(resident=True)
        resident(requests[0])
        res_outs, paths[f"{SPEC.name} calibrated resident"] = drive(
            {"resident_codes": sum(-(-len(r) // MICROBATCH)
                                   for r in requests)},
            lambda: [resident(r) for r in requests])
        equal_res = all(torch.equal(a, b) for a, b in zip(res_outs, outs))
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "p2vit_int4.npz")
            q.save_int_model(path)
            loaded = engine.load_int_model(path, dev)(requests[1])
        equal_art = bool(torch.equal(loaded, outs[1]))
        emit(phase="calibrate", part="resident", config=label,
             logits_equal_per_kernel=equal_res,
             artifact_logits_equal=equal_art)
        if not (equal_res and equal_art):
            raise RuntimeError("the calibrated resident forward, or the "
                               "saved artifact, differs from the per-kernel "
                               "forward")
    return paths


def phase_alternatives_kernels(dev, summary):
    """The kernels that no model path runs, each vs its plain version on the
    card: K8 (v1, v3, v4, v5) and K7a at DeiT-S b = 1, 8, 64 (200 rows,
    197 real), LIS and float softmax; K7b at b = 1, 8, 64 (B * 197 rows);
    K3 at the DeiT-S patch, qkv, proj, fc1 and head sites and at Swin-T's
    patch (K = 48) and stage-0 qkv, b = 1 and 64, each mode, with
    ``torch._int_mm``'s time at the same shape beside it.  v5 takes an
    even batch only: its b = 1 call must raise, and it runs at b = 2."""
    ip_np = random_int_model(SPEC, CFG, seed=0)
    for lis, tol in ((True, "exact"), (False, "softmax")):
        for b in (1, 8, 64):
            cases = alt_kernel_cases(SPEC, ip_np, b, dev, npad=200, lis=lis,
                                     seed=b)
            for name in K8 + ("fused_attention_block", "fused_int_mlp_block"):
                if name == "fused_int_mlp_block" and not lis:
                    continue  # K7b has no softmax
                args, kw = cases[name]
                batch = b
                if name == "fused_qkv_attention_v5" and b % 2:
                    try:
                        attention.fused_qkv_attention_v5(*args, **kw)
                    except ValueError as e:
                        emit(phase="kernel", kernel=name, batch=b,
                             refused=str(e))
                    else:
                        raise RuntimeError("fused_qkv_attention_v5 took an "
                                           f"odd batch, B={b}")
                    batch = b + 1
                    args, kw = alt_kernel_cases(SPEC, ip_np, batch, dev,
                                                npad=200, lis=lis,
                                                seed=b)[name]
                decode = None
                if name == "fused_attention_block":
                    def decode(y, s=args[8][3]):  # the qact2 grid
                        return torch.round(y / s)
                elif name == "fused_int_mlp_block":
                    def decode(y, s=kw["s4_vec"]):  # the qact4 grid
                        return torch.round(y / s)
                heaviest = b == 64 and lis and (f"{SPEC.name} b=64", args,
                                                kw)
                note(summary, name, hold(name, args, kw, tol, decode,
                                         spec=SPEC.name, batch=batch),
                     heaviest)
    swin_np = random_swin_int_model(SWIN, CFG, seed=0)
    best = 0.0
    for b in (1, 64):
        for spec, model in ((SPEC, ip_np), (SWIN, swin_np)):
            for site, (args, out_scale) in linear_site_cases(
                    spec, model, b, dev, seed=b).items():
                lib_ms = int_mm_ms(args[0], args[1])
                for mode, kw, decode in linear_modes(out_scale):
                    result = hold("fused_int_linear", args, kw, "exact",
                                  decode, spec=spec.name, site=site,
                                  batch=b, mode=mode, library_ms=lib_ms)
                    b_ms = bound("fused_int_linear", args, kw)[0]
                    heaviest = b_ms > best and (
                        f"{spec.name} {site} b={b} {mode}", args, kw)
                    best = max(best, b_ms)
                    note(summary, "fused_int_linear", result, heaviest,
                         lib_ms)


def phase_gemm(dev, summary):
    """The wgmma mainloop of K2, K3 and K7b (``csrc/wgmma_gemm.cuh``): each
    kernel's footprint (registers, shared memory, blocks an SM) at the
    plans of the main shapes; the one-time cost of the K-major weight
    copies (``gemm.kmajor``) for every K2 weight of DeiT-S and Swin-T;
    and device times from torch.profiler, which leave out the host's time
    between launches: K2 and K7b at DeiT-S b=64 and K3 at each b=64 site
    beside ``torch._int_mm`` (the GEMM alone, int32 out; the port never
    calls it)."""
    rows = 64 * SPEC.seq_len
    c, hid = SPEC.embed_dim, 4 * SPEC.embed_dim
    mlp64 = mlp.footprint(rows, c, hid, c, dev)
    k7b = {b: mlp.mlp_block_footprint(b * SPEC.seq_len, c, hid, dev)
           for b in (1, 64)}
    for name, at, (m, n, k), f in (
            ("fused_int_mlp_block fc1", "b=64", (rows, hid, c), k7b[64]["fc1"]),
            ("fused_int_mlp_block fc2", "b=64", (rows, c, hid), k7b[64]["fc2"]),
            ("fused_int_mlp_block fc1", "b=1", (SPEC.seq_len, hid, c),
             k7b[1]["fc1"]),
            ("fused_int_mlp_block fc2", "b=1", (SPEC.seq_len, c, hid),
             k7b[1]["fc2"]),
            ("fused_int_mlp fc1", "b=64", (rows, hid, c), mlp64["fc1"]),
            ("fused_int_mlp fc2", "b=64", (rows, c, hid), mlp64["fc2"]),
            ("fused_int_mlp fc2 float32 out", "b=64", (rows, c, hid),
             mlp64["fc2_f32"]),
            ("fused_int_mlp fc2", "b=1", (SPEC.seq_len, c, hid),
             mlp.footprint(SPEC.seq_len, c, hid, c, dev)["fc2"]),
            ("fused_int_linear", "qkv b=64", (rows, 3 * c, c),
             linear.footprint(rows, 3 * c, c, dev))):
        plan = gemm.device_plan(m, n, k, dev)
        emit(phase="footprint", kernel=name, at=f"{SPEC.name} {at}",
             bm=plan.bm, bn=plan.bn, stages=plan.stages, grid=plan.grid,
             tiles=plan.tiles, **f)
    for spec, model in ((SPEC, int_model_from_numpy(
            random_int_model(SPEC, CFG, seed=0), SPEC, dev, CFG)),
            (SWIN, swin_int_model_from_numpy(
                random_swin_int_model(SWIN, CFG, seed=0), SWIN, dev))):
        blocks = model["blocks"] if spec is SPEC else \
            [b for layer in model["layers"] for b in layer["blocks"]]
        weights = [b[f]["w_int"] for b in blocks for f in ("fc1", "fc2")]
        before = gemm.kmajor.copies
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for w in weights:
            gemm.kmajor(w)
        torch.cuda.synchronize()
        emit(phase="kmajor", model=spec.name, weights=len(weights),
             copies=gemm.kmajor.copies - before,
             bytes=sum(nbytes(w) for w in weights),
             ms=1e3 * (time.perf_counter() - t0))
    ib = random_int_model(SPEC, CFG, seed=0)["blocks"][0]
    args, kw = kernel_case("fused_int_mlp", ib, SPEC, 64, dev,
                           emit_codes=True)
    ms = device_ms(lambda: mlp.fused_int_mlp(*args, **kw))
    summary["fused_int_mlp"]["device_ms"] = ms
    emit(phase="gemm", kernel="fused_int_mlp", at=f"{SPEC.name} b=64",
         device_ms=ms, bound_ms=bound("fused_int_mlp", args, kw)[0])
    args, kw = alt_kernel_cases(SPEC, random_int_model(SPEC, CFG, seed=0), 64,
                                dev, npad=200, seed=64)["fused_int_mlp_block"]
    ms = device_ms(lambda: mlp.fused_int_mlp_block(*args, **kw))
    summary["fused_int_mlp_block"]["device_ms"] = ms
    emit(phase="gemm", kernel="fused_int_mlp_block", at=f"{SPEC.name} b=64",
         device_ms=ms, bound_ms=bound("fused_int_mlp_block", args, kw)[0])
    slower = []
    k3 = summary["fused_int_linear"]
    for spec, model in ((SPEC, random_int_model(SPEC, CFG, seed=0)),
                        (SWIN, random_swin_int_model(SWIN, CFG, seed=0))):
        for site, (args, out_scale) in linear_site_cases(
                spec, model, 64, dev, seed=64).items():
            lib = device_ms(lambda: torch._int_mm(args[0], args[1])) \
                if int_mm_takes(args[0], args[1]) else None
            for mode, kw, _ in linear_modes(out_scale):
                at = f"{spec.name} {site} b=64 {mode}"
                ms = device_ms(lambda: linear.fused_int_linear(*args, **kw))
                emit(phase="gemm", kernel="fused_int_linear", at=at,
                     device_ms=ms, int_mm_device_ms=lib)
                if lib is not None and ms > lib:
                    slower.append(at)
                if at == k3.get("at"):
                    k3.update(device_ms=ms, library_device_ms=lib)
    emit(phase="gemm", kernel="fused_int_linear",
         slower_than_int_mm_on_the_device=slower)


def device_by_launch(fn, iters=10):
    """Device milliseconds per call of ``fn`` by launch kind (LAUNCH_KINDS:
    "gemm", "core"; anything else "other"), from torch.profiler after a
    warm-up."""
    out = defaultdict(float)
    for e in profiled(fn, iters):
        t = getattr(e, "self_device_time_total", 0)
        if t > 0:
            kind = next((k for pat, k in LAUNCH_KINDS if pat in e.key),
                        "other")
            out[kind] += t / 1e3 / iters
    return dict(out)


def phase_attention(dev, summary):
    """The redesigned attention kernels: device time per launch (qkv GEMM,
    core) for K1 at DeiT-S b = 1, 8, 64 with the LIS and the float softmax,
    K5 at the same batches, K4 and K4b at Swin-T stages 0-3 (b = 1 and 64,
    both softmaxes); the footprints of the cores and of the qkv GEMM at
    the main shapes, and K6's (DeiT-S b = 1, 8, 64, both softmaxes).  The
    b=64 / stage-0 b=64 device times go into the kernels line.  Fails on a
    spill in any core or in K6."""
    ib = random_int_model(SPEC, CFG, seed=0)["blocks"][0]
    ib_fq = random_int_model(SPEC, FQVIT, seed=0)["blocks"][0]
    for name, blk, opts in (
            ("fused_qkv_attention_v2", ib, {}),
            ("fused_qkv_attention_v2", ib, dict(lis=False, bits=8)),
            ("fused_int_attention", ib_fq, {}),
            ("fused_int_attention", ib_fq, dict(lis=False))):
        for b in (1, 8, 64):
            args, kw = kernel_case(name, blk, SPEC, b, dev, **opts)
            fn = KERNELS[name]["fn"]
            t = device_by_launch(lambda: fn(*args, **kw))
            lis = opts.get("lis", True)
            emit(phase="attention", kernel=name, at=f"{SPEC.name} b={b}",
                 lis=lis, device_ms=sum(t.values()), **{
                     f"{k}_device_ms": v for k, v in t.items()},
                 bound_ms=bound(name, args, kw)[0])
            if b == 64 and lis:
                summary[name].update(device_ms=sum(t.values()), **{
                    f"{k}_device_ms": v for k, v in t.items()})
    for cfg in (CFG, QuantConfig(lis=False)):
        ip = random_swin_int_model(SWIN, cfg, seed=0)
        for stage in range(SWIN.num_layers):
            for b in (1, 64):
                cases = swin_cases(ip, stage, b, dev, cfg=cfg)
                for name in ("fused_swin_attention", "fused_swin_attention_v2"):
                    args, kw = cases[name]
                    fn = KERNELS[name]["fn"]
                    t = device_by_launch(lambda: fn(*args, **kw))
                    emit(phase="attention", kernel=name,
                         at=f"{SWIN.name} stage {stage} b={b}", lis=cfg.lis,
                         device_ms=sum(t.values()),
                         bound_ms=bound(name, args, kw)[0])
                    if stage == 0 and b == 64 and cfg.lis:
                        summary[name]["device_ms"] = sum(t.values())
    rows = 64 * SPEC.seq_len
    prints = []
    for b in (1, 8, 64):
        for lis in (True, False):
            f = attention.core_footprint(b, SPEC.num_heads, SPEC.seq_len,
                                         SPEC.head_dim, SPEC.seq_len, dev,
                                         lis=lis)
            prints.append(("qkv core", f"{SPEC.name} b={b}", lis, f))
    for stage in range(SWIN.num_layers):
        res = SWIN.stage_resolution(stage)[0]
        for lis in (True, False):
            f = swin_attention.footprint(
                64 * (res // 7) ** 2, SWIN.num_heads[stage], 56,
                SWIN.stage_dim(stage) // SWIN.num_heads[stage], 49, dev,
                lis=lis)
            prints.append(("swin core", f"{SWIN.name} stage {stage} b=64",
                           lis, f))
    for label, r in (("b=1", SPEC.seq_len), ("b=64", rows)):
        f = attention.qkv_gemm_footprint(r, 3 * SPEC.embed_dim,
                                         SPEC.embed_dim, dev)
        prints.append(("qkv gemm", f"{SPEC.name} {label}", True, f))
    for b in (1, 8, 64):
        for lis in (True, False):
            prints.append(("resident_codes", f"{SPEC.name} b={b}", lis,
                           resident_footprint(b, SPEC.seq_len, SPEC, dev,
                                              lis=lis)))
    spills = []
    for kernel, at, lis, f in prints:
        emit(phase="footprint", kernel=kernel, at=at, lis=lis, **f)
        if f.get("local_bytes", 0) > 0:
            spills.append((kernel, at, lis))
    if spills:
        raise RuntimeError(f"attention kernels or K6 spill to local memory: "
                           f"{spills}")


def alternatives_path(model, x):
    """The model-fed run of K3, K7a, K7b and K8: block 0 of ``model`` (an
    IntModel of DeiT-S int4) on the int8 input codes ``x``.  The embed and
    block 0's LN1 give real LN codes; K1, its proj and the code fences are
    the per-kernel composition that K7a replaces; the fake-quant fences,
    LN2, K2 and qact4 the default MLP half that K7b replaces; K3 runs the
    patch, proj and head GEMMs beside the forward's own expression.
    Returns the outputs to compare."""
    ip, cfg, spec = model.ip, model.cfg, model.spec
    ib = ip["blocks"][0]
    b, n, c = x.shape[0], spec.seq_len, spec.embed_dim
    eps, bt = spec.ln_eps, cfg.bit_a
    in_scale = ip["qact1"]["scale"]
    hc = vit_int._codes(vit_int._embed_front(ip, spec, cfg, x), in_scale, bt)
    x1 = vit_int._ln_int8(None, ib["norm1"], in_scale, ib["qkv"]["in_scale"],
                          eps, x_codes=hc)
    h = hc.to(torch.float32) * in_scale
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 200 - n))  # noqa
    ab = attn_block_operands(ib, spec)
    q = ib["qkv"]
    heads = dict(num_heads=spec.num_heads, head_dim=spec.head_dim, n_real=n)
    out = {}
    # K1, the proj and the codes fences (the per-kernel composition)
    o1 = attention.fused_qkv_attention_v2(
        x1, q["w_int"], q["mult"], q["b"], ib["attn_scalars"],
        lis_fast=ib["lis_fast"], **heads)
    out["k1"] = o1
    o_rows = o1.permute(0, 2, 1, 3).reshape(b * n, c)
    y = vit_int._int_linear(o_rows, ib["proj"])
    s3, s_blk2 = ib["attn.qact3"]["scale"], ib["qact2"]["scale"]
    yq3 = torch.clamp(torch.round(y / s3), bt.lower_bound, bt.upper_bound)
    out["composition_qact2"] = vit_int._codes(
        h.reshape(b * n, c) + yq3 * s3, s_blk2, bt).to(torch.float32)
    # K8's four entries on the same LN1 codes, padded to 200 rows
    out["fused_qkv_attention"] = attention.fused_qkv_attention(
        pad(x1), ab["wq"], ab["wk"], ab["wv"], ab["mult"], ab["bias"],
        ab["scalars"], n_real=n)
    for name in K8[1:]:
        out[name] = KERNELS[name]["fn"](pad(x1), q["w_int"], q["mult"],
                                        q["b"], ab["scalars"], **heads)
    # K7a on the LN1 codes and the residual
    out["k7a_qact2"] = torch.round(attention.fused_attention_block(
        pad(x1), pad(h), **ab, n_real=n)[:, :n].reshape(b * n, c) / s_blk2)
    # K7b and the default MLP half (fake-quant fences, LN2, K2, qact4)
    mops = mlp_block_operands(ib)
    out["k7b"] = mlp.fused_int_mlp_block(y, h.reshape(b * n, c), **mops)
    y3 = vit_int._fq_site(ib["attn.qact3"], y, bt)
    h2 = vit_int._fq_site(ib["qact2"], h.reshape(b * n, c) + y3, bt)
    x2 = vit_int._ln_int8(h2, ib["norm2"], s_blk2, mops["ln_out_scale"], eps,
                          rescale=mops["ln_rescale"])
    y2 = vit_int._mlp_kernel(ib, x2.reshape(b, n, c), emit_codes=False)
    out["default_mlp"] = vit_int._fq_site(ib["qact4"],
                                          h2 + y2.reshape(b * n, c), bt)
    # K3 raw at the patch, proj and head sites vs the forward's expression
    head_x = vit_int._ln_int8(None, ip["norm"], in_scale, ip["qact2"]["scale"],
                              eps, x_codes=hc[:, 0])
    for site, s, xs in (("patch", ip["patch"], patchify(x, spec)),
                        ("proj", ib["proj"], o_rows),
                        ("head", ip["head"], head_x)):
        xs = xs.reshape(-1, s["w_int"].shape[0]).contiguous()
        out[f"k3_{site}"] = linear.fused_int_linear(xs, s["w_int"], s["mult"],
                                                    s["b"])
        out[f"forward_{site}"] = vit_int._int_linear(xs, s)
    return out


def model_fed_checks(out, n):
    """The shares of equal codes between the alternatives and what they
    stand for, and the failures: K3 raw not bit-equal to the forward's
    expression, v3-v5 not equal to v1, K8 v1 / K7a / K7b beyond the
    kernel rule (>= 99.9% equal, |diff| <= 1 code) against K1 / the
    composition / the default MLP half, or a non-finite output."""
    def share(a, b):
        return float((a == b).float().mean())

    def max_diff(a, b):
        return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())

    v1 = out["fused_qkv_attention"][:, :, :n]
    res = {"k8_v1_vs_k1": share(v1, out["k1"]),
           "k8_v1_vs_k1_max_diff": max_diff(v1, out["k1"])}
    for name in K8[1:]:
        res[f"{name}_vs_v1"] = share(out[name][:, :, :n], v1)
    res["k7a_vs_composition"] = share(out["k7a_qact2"],
                                      out["composition_qact2"])
    res["k7a_vs_composition_max_diff"] = max_diff(out["k7a_qact2"],
                                                  out["composition_qact2"])
    res["k7b_vs_default_mlp"] = share(out["k7b"], out["default_mlp"])
    for site in ("patch", "proj", "head"):
        res[f"k3_{site}_raw_bit_equal"] = bool(torch.equal(
            out[f"k3_{site}"], out[f"forward_{site}"]))
    finite = all(bool(torch.isfinite(t.to(torch.float32)).all())
                 for t in out.values())
    failed = [k for k, v in res.items()
              if (k.endswith("bit_equal") and not v)
              or (k.endswith("_vs_v1") and v != 1.0)
              or (k in ("k8_v1_vs_k1", "k7a_vs_composition",
                        "k7b_vs_default_mlp") and v < 0.999)
              or (k.endswith("max_diff") and v > 1)]
    return res, finite, failed


def phase_alternatives_path(dev):
    """K3, K7a, K7b and K8 fed from block 0 of DeiT-S int4 on a b=8
    request, through their public wrappers, with every count set to 0
    before and read after: each runs (K3 three times, the rest once), as
    do K1 and K2 for the compositions they are held against."""
    model = engine.IntModel(random_int_model(SPEC, CFG, seed=0), SPEC, CFG,
                            dev)
    x = torch.tensor(model.encode(np.random.default_rng(6).integers(
        0, 256, (8, 3, 224, 224), dtype=np.uint8)), device=dev)
    expected = {name: 1 for name in K8 + (
        "fused_attention_block", "fused_int_mlp_block",
        "fused_qkv_attention_v2", "fused_int_mlp")}
    expected["fused_int_linear"] = 3
    out, launches = drive(expected, lambda: alternatives_path(model, x))
    res, finite, failed = model_fed_checks(out, SPEC.seq_len)
    emit(phase="alternatives", model=SPEC.name, batch=8, finite=finite,
         **res)
    if failed or not finite:
        raise RuntimeError(f"model-fed alternatives failed: {failed}, "
                           f"finite={finite}")
    return launches


def _variant_name(fn):
    """The KERNELS name of a wrapper of attn_overlap.VARIANTS."""
    return "attn_overlap.qkv_attention_nv" \
        if fn is attn_overlap.qkv_attention_nv else fn.__name__


def phase_probes_kernels(dev, summary):
    """Each probe kernel against its plain version at its script's full
    geometry (iters 5 a side: the plain versions take up to tens of ms);
    P1's paired against the producer and the consumer run alone; P4 with
    torch.sum beside it (the function in one PyTorch call, which the port
    never calls).  The served kernels that the legs time beside the probes
    (K1 with the fast LIS and with the float softmax, K8's _v3, _v4 with
    group 2 and 4, _v5; K2 on P3's operands) are held at the legs' shapes
    and arguments too."""
    def row(name, args, kw, label, library_ms=None, tol="exact",
            beside=None, **opts):
        # a served kernel's line names the probe it is timed beside
        where = dict(beside=beside) if beside else \
            dict(probe=name.split(".")[0])
        result = hold(name, args, kw, tol, iters=5, at=label, **where,
                      **opts)
        note(summary, name, result,
             None if beside else (label, args, kw), library_ms)

    x, *ops = attn_overlap.inputs(dev)
    at = f"B={x.shape[0]}"
    for fn, kw in attn_overlap.VARIANTS.values():
        name = _variant_name(fn)
        row(name, (x, *ops), kw, at,
            tol="exact" if kw.get("lis", True) else "softmax",
            beside=None if name in PROBES else "attn_overlap")
    heads = dict(num_heads=attn_overlap.H, head_dim=attn_overlap.D)

    x, w, mb, scores, v, scal = pingpong.inputs(dev)
    p_args, c_args = (x, w, mb, scal), (scores, v, scal)
    n_real = dict(n_real=pingpong.N)
    at = f"B={x.shape[0]}"
    row("pingpong.producer", p_args, heads, at)
    row("pingpong.consumer", c_args, n_real, at)
    row("pingpong.paired", (x, w, mb, scores, v, scal), dict(heads, **n_real),
        at)
    sco, out = pingpong.paired(x, w, mb, scores, v, scal, **heads, **n_real)
    halves = bool(torch.equal(sco, pingpong.producer(*p_args, **heads))
                  and torch.equal(out, pingpong.consumer(*c_args, **n_real)))
    emit(phase="probes", probe="pingpong", paired_equals_halves=halves)
    if not halves:
        raise RuntimeError("pingpong.paired differs from its two halves")

    a, b, v = overlap.inputs(dev)
    for mode in overlap.MODES:
        row(f"overlap.{mode}", (a, b, v), dict(iters=overlap.ITERS),
            f"{a.shape[0]}x{b.shape[1]}",
            compare=lambda got, want, m=mode: overlap.compare(
                m, a, b, got, want, overlap.ITERS))

    args = overlap_mlp.inputs(dev)
    at = f"rows={args[0].shape[0]}"
    for mode in overlap_mlp.MODES:
        row(f"overlap_mlp.mlp_{mode}", args, {}, at,
            decode=lambda y, s=args[4][2]: torch.round(y / s))
    k2 = overlap_mlp.production_args(*args)
    row("fused_int_mlp", k2, {}, at, beside="overlap_mlp",
        decode=lambda y, s=k2[7]: torch.round(y / s))

    xf = torch.tensor(np.random.default_rng(0).integers(
        0, 255, ingest.SHAPE, dtype=np.uint8), device=dev) \
        .reshape(ingest.FLAT).to(torch.float32)
    row("ingest.tile_sum", (xf,), {}, "b=64 uint8 batch",
        library_ms=cuda_ms(lambda: torch.sum(xf, dtype=torch.float64)))


def phase_probes(dev):
    """Each probe's timing legs once, through the probes' and the port's
    wrappers, with every kernel's launches counted: each function a leg
    times is called ``timing.REPEATS * (WARMUP + STEPS)`` times, P1's and
    P5's chains DEPTH launches a call.  One JSON line of answers a
    probe."""
    legs = {"attn_overlap": attn_overlap.legs, "pingpong": pingpong.legs,
            "overlap": overlap.legs, "overlap_mlp": overlap_mlp.legs,
            "ingest": ingest.legs}
    calls = timing.REPEATS * (timing.WARMUP + timing.STEPS)
    expected = Counter()
    for fn, _ in attn_overlap.VARIANTS.values():  # K1 twice, _v4 twice
        expected[_variant_name(fn)] += attn_overlap.DEPTH * calls
    for role, chains in (("producer", 2), ("consumer", 2), ("paired", 1)):
        # producer and consumer alone and on two streams; paired alone
        expected[f"pingpong.{role}"] = chains * pingpong.DEPTH * calls
    for mode in overlap.MODES:  # dot_only and vpu_only also size the chain
        expected[f"overlap.{mode}"] = \
            (2 if mode in ("dot_only", "vpu_only") else 1) * calls
    for mode in overlap_mlp.MODES:
        expected[f"overlap_mlp.mlp_{mode}"] = calls
    expected["fused_int_mlp"] = calls
    expected["ingest.tile_sum"] = 6 * calls  # one a step in each leg
    answers, launches = drive(expected,
                              lambda: {k: f(dev) for k, f in legs.items()})
    for probe, answer in answers.items():
        emit(phase="probes", probe=probe, **answer)
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

    # both libraries at once, each with one nvcc per source
    with concurrent.futures.ThreadPoolExecutor(len(build.LIBRARIES)) as ex:
        built = list(ex.map(build.build, build.LIBRARIES))
    for lib, (path, seconds) in zip(build.LIBRARIES, built):
        build.load_library(lib)
        emit(phase="build", library=os.path.relpath(path), seconds=seconds,
             cached=seconds == 0.0)

    t = [time.perf_counter()]
    summary = {name: {"max_abs_err": 0} for name in KERNELS}
    phase_kernels(dev, summary)
    t.append(time.perf_counter())
    phase_alternatives_kernels(dev, summary)
    phase_gemm(dev, summary)
    phase_attention(dev, summary)
    t.append(time.perf_counter())
    paths = {SPEC.name: phase_serving(dev)}
    t.append(time.perf_counter())
    paths[f"{SPEC.name} fqvit_int8"] = phase_serving_fqvit(dev)
    t.append(time.perf_counter())
    paths[f"{SPEC.name} resident"] = phase_serving_resident(dev, summary)
    t.append(time.perf_counter())
    paths.update(phase_branches(dev))
    t.append(time.perf_counter())
    paths[SWIN.name], paths[f"{SWIN.name} attn_v2"] = phase_serving_swin(dev)
    t.append(time.perf_counter())
    paths.update(phase_swin_branches(dev))
    t.append(time.perf_counter())
    paths[f"{SPEC.name} alternatives"] = phase_alternatives_path(dev)
    t.append(time.perf_counter())
    paths.update(phase_calibrate(dev))
    t.append(time.perf_counter())
    phase_probes_kernels(dev, summary)
    paths["probes"] = phase_probes(dev)
    t.append(time.perf_counter())
    emit(phase="seconds", **{k: b - a for k, a, b in zip(
        ("kernels", "alternative_kernels", "deit_small", "deit_small_fqvit",
         "deit_small_resident", "branches", "swin_tiny", "swin_branches",
         "alternatives", "calibrate", "probes"),
        t, t[1:])})

    kernels = []
    for name, k in KERNELS.items():
        by_path = {p: n[name] for p, n in paths.items() if n[name]}
        s = summary[name]
        kernels.append(dict(
            name=name, route="cuda", source=k["source"],
            replaces=k["replaces"], launches=sum(by_path.values()),
            launches_by_path=by_path, **s,
            share=s["bound_ms"] / s["ms"] if s.get("ms") else None))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""Drive the PyTorch/CUDA port (diffvit_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. device:  fails unless a CUDA card is present;
2. build:   compiles the port's kernels from diffvit_tpu_torch/csrc with nvcc
            (one nvcc per source, all started together) and, beside them,
            its host library (csrc/host, one g++);
3. kernels: holds each kernel against its plain PyTorch version on the card
            and times both: K1 (LIS and float softmax), K2 (int8 codes out
            and float32 out), K5 (LIS and float softmax) and K6 (the whole
            12-block encoder in one launch, on the wgmma GEMM mainloop and
            the tensor-core attention core; LIS, and the float softmax at
            b = 8) at DeiT-S shapes (B = 1, 8, 64; K6 also at 128, the
            launch of a resident batch of 256) and a tiny shape; K4 and
            K4b at Swin-T's four stage geometries and K2 at its four widths
            (B = 1, 8, 64); K4 and K4b with the float softmax (lis=False)
            at stage 0 (B = 1, 8, 64) and stages 1-3 (B = 8, 64), on a
            shifted (masked) and an unshifted block each, and K2 emitting
            float32 at Swin-T's four widths at the same batches; then
            ViT-L/16 at 384 px (577 keys, the cores' long rows): K1 and K5
            at b = 1 and 8 on block 0, K6 at full depth at b = 1 and 16,
            each bit for bit against its plain version;
4. serving: for DeiT-S int4, the FQ-ViT DeiT-S int8 (SmoothQuant off: K5
            and K2 emitting float32), DeiT-S int4 served resident (K6 once
            per launch of its default cut, no K1 or K2; its logits must
            equal the per-kernel forward's, and with microbatch=None too,
            at b = 64 and on a b = 200 request cut into 2 launches)
            and Swin-T int4: saves a seeded model
            as an int-model artifact, loads it with the port's
            load_int_model, answers uint8 requests at b = 1 (4 times), 8
            and 64 through IntModel, checks that every forward went through
            the path's kernels and no other, compares the card's logits
            with the plain path on the CPU and runs validate().  DeiT-S
            int4 also prints how far its codes use the int8 range; Swin-T
            also runs one forward through the natural-layout attention
            contract (K4b) and checks that its logits equal K4's; the
            resident phase also prints K6's device time at b = 1, 8, 64,
            128 and
            block 0's ms by step kind from the kernel's barrier stamps
            (LN, qkv, attention, proj, fc1, fc2, barrier wait); and
            ViT-L/16 at 384 px on both routes: resident (K6 at 577 keys)
            at b = 1 and 16, per kernel (K1 at 577 keys, K2) at b = 8, each
            request's logits equal to the other route's, with K6's device
            time and step times at b = 1 and 16;
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
            K7a's three launches (qkv GEMM, core, proj on the wgmma
            mainloop) at DeiT-S b = 1, 8, 64, with torch._int_mm on the
            proj's GEMM alone beside them; the core's, the qkv GEMM's and
            K7a's proj's footprints (registers, local memory, shared
            memory, blocks an SM), and K6's at DeiT-S b = 1, 8, 64 (both
            softmaxes), failing on a spill; K7b's two GEMM kernels'
            footprints and its device time at b = 64 come with K2's and
            K3's (phase gemm);
9. probes:  the H100 counterparts of the inline Pallas kernels of scripts/
            (diffvit_tpu_torch/probes, their own library built from
            csrc/probes): each probe kernel against its plain version at
            the script's full geometry (P1 producer, consumer and paired
            at B = 128, P2's five modes at 32768 x 512 with 220 chain
            steps, P3's five modes at 50,688 rows, P4 on a b = 64 uint8
            batch cast to float32 (bit for bit, with its device time and
            torch.sum's) and at 4, 16, 8,188, 8,196 and 57,344 elements
            and on (1176, 1024) halves, P5 at B = 256; P1 and P5 also at
            B = 1 and 8, P2 at 64 and 192 rows and at K = 32, 96 and 0,
            P3 at 197 and 1,000 rows and at Cin 1024 -> 4096, with P3's
            dot, pipelined and staged bit-equal), paired against the
            two halves at each batch, P1's, P2's, P3's and P5's
            footprints (failing on a spill), a chain step's instructions
            counted in the probes library's SASS (cuobjdump; the bound of
            P2's chain modes), torch.mm and torch.mm + copy_ beside P2's
            dot_only, and the served kernels that the legs time beside them
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
11. calibrate_swin: the same for the port's own Swin-T (params from
            swin.init_swin_params at seed 0): the card against the CPU at
            b = 8 (at least 99.9% of qparam elements equal, every one that
            differs printed, global_distance equal, and the fake-quant and
            served logits held by the _assert_paths_agree rule); the CLI's
            Gaussian batch of 50 (wall seconds, peak memory, every block's
            softmax scale); that bake served at b = 1, 8, 64 through
            exactly 12 K4 + 12 K2 a forward, and at b = 8 through K4b with
            logits equal to K4's; K4, K4b and K2 bit for bit against their
            plain versions on every operand the bake gave them at b = 8.
12. lis_wide: the 128-bit LIS row sum, for a softmax scale whose int64
            row sum could overflow: K1, K5, K8 (v1, _v3, _v4, _v5), K7a and
            K6 at DeiT-S (s_a = 2^-12 over 197 keys; b = 1, 8, 64) and K4
            and K4b at Swin-T's four stages (s_a2 = 2^-13 over a 49-key
            window; b = 1, 64), each bit for bit against its plain version.
13. cli:    the port's CLI (diffvit_tpu_torch/cli.py) end to end, through
            cli.main on a fake ImageFolder of JPEGs, with
            --device-prefetch 2: DeiT-S P2-ViT int4 calibrated on the CLI's
            Gaussian batch of 50, baked, saved and validated through its
            integer path (--quant --mode 1 --int-path --save-int, the u8
            wire encoded into codes on the loader side), that artifact
            served with --load-int on the u8 and the f32 wires and
            resident (K6), and a Swin-T artifact served with --load-int;
            each run's Prec@1 line, wall seconds and launch counts (exactly
            12 K1 + 12 K2 a forward, 12 K4 + 12 K2 for Swin-T, K6 once per
            launch of its default cut); then the artifact's per-kernel and
            resident logits bit for bit on a b = 64 batch, and
            IntModel(microbatch=8) at b = 64 against microbatch=None, bit
            for bit.
14. native: the native JPEG pipeline (data/native_decode.py over the host
            library built by g++ from csrc/host, linked against the
            libjpeg PIL loads): the build seconds, the libjpeg and its
            headers, PIL's libjpeg-turbo, the CPU; NativeJpegLoader
            against the PIL route (DataLoader, CodesLoader) bit for bit in
            every emit (f32, u8, codes) on 64 JPEGs of 500 x 375 and on a
            grayscale JPEG (decoded natively), a CMYK JPEG, a PNG named
            .jpg and a truncated JPEG (the last three through PIL; the
            truncated one refused by both routes unless PIL's
            LOAD_TRUNCATED_IMAGES is set); the fast (DCT-scaled) decode
            against the exact one (mean absolute difference < 0.05,
            correlation > 0.998); the ingest rate at b = 64 on 256 such
            JPEGs of the PIL route and the native codes, exact and fast
            (median of 3 passes), beside the DeiT-S int4 forward's img/s
            per kernel and resident; one b = 64 batch's codes and
            per-kernel logits equal between the two loaders; and the CLI
            through the native loader (DeiT-S per kernel and resident and
            Swin-T on --wire u8, DeiT-S --wire f32 --native-preproc), each
            run's launches exact and its report equal to the PIL route's.
15. mixed:  the mixed-precision search (--mixed) on the port's own DeiT-S
            (params at seed 0, the CLI's Gaussian calibration of 50): the
            Hessian sensitivity on one batch of 8 through both estimators
            at --hessian-iter 3 (their seconds), one block HVP's and one
            joint HVP's ms (all 49 target weights), and the card against
            the CPU on the head and block 11's fc1, per leaf and jointly,
            with the same probes (within 1e-4 of max|Hv|, and of
            sum|v * Hv| for v . Hv); then sample_candidates -> omega_rank
            -> evolutionary_search (pop 4, one iteration, 2 mutations, 2
            crossovers, size factor 1.3) on 64 seeded images through
            validate_bits (the fake-quant forward: no kernel) and
            validate_bits_int (exactly 12 K1 + 12 K2 a candidate forward):
            seconds per candidate on each, the device memory the integer
            search holds (two bakes, not one per candidate) and its peak;
            each integer candidate's logits bit for bit, and its top-1,
            against its own bake's (prepare_int(bits), which
            validate(use_int=True) serves; validate's Prec@1 printed
            beside); forward_bits_int's launches; the best configuration
            baked, saved, loaded and served (12 K1 + 12 K2) with
            prepare_int's logits; Swin-T calibrated on the card at b = 8,
            one mixed forward_q_bits at b = 8 against the CPU
            (_assert_paths_agree) and its per-slot bake served through
            exactly 12 K4 + 12 K2; then one CLI run (--mixed --search-path
            int --save-int on a fake ImageFolder) with its launches counted
            from its validate_bits_int lines, and its artifact served.
16. recovery: the recovery passes (calib/adaround.py, qat.py, biascorr.py)
            on the port's own DeiT-S (params at seed 0, the CLI's Gaussian
            calibration of 50): one AdaRound site (block 11's fc1, 2048
            rows) at 1000 and at 100 steps; then AdaRound at 100 steps a
            site, 3 QAT steps at b = 50, one more step of QAT without and
            with remat from the same params (the losses bit-equal), and
            bias correction, each with its seconds and peak memory; the AdaRound weights on their grid and
            a bake of them holding exactly their codes; the final bake
            served through exactly 12 K1 + 12 K2, its codes equal to the
            params' at every site, and with equal logits through K6, from a
            saved and loaded artifact and from a fresh bake; Swin-T
            (calibrated on 8 images) through AdaRound at 50 steps and bias
            correction, served through exactly 12 K4 + 12 K2 with its codes;
            the card against the CPU at DeiT-S width, depth 2, on 4 images
            (the share of equal AdaRound codes, the QAT losses from the
            same params, the first one equal; bias correction from the
            CPU's QAT params on both, the biases equal, and the served
            logits by _assert_paths_agree); and the
            CLI with --adaround --adaround-steps 20 --qat-steps 5
            --bias-corr --int-path --save-int, its report lines, seconds and
            launches, and its artifact served.
17. analysis: PSAQ data generation (analysis/datagen.py) and the CKA
            toolkit on the port's own models (params at seed 0): DeiT-S
            generates 50 images (two epochs of 3 steps; seconds a step,
            peak GiB), calibrates on them, and its bake is served through
            exactly 12 K1 + 12 K2 and through K6 once (logits equal), every
            K1, K2 and K6 call of a b = 8 forward held bit for bit against
            its plain version; Swin-T the same at b = 8 through exactly 12
            K4 + 12 K2; the CLI with --mode 2 --int-path --save-int
            (1,000 steps at --calib-batchsize 2), its report lines,
            seconds and launches, and its artifact served;
            compute_cka_internal on the float DeiT-S and
            compute_cka_with_adversarial (10 PGD steps against the float
            DeiT-S, the generated bake's fake-quant forward as model 2) on
            2 batches of 32, their seconds and pickles; the card against
            the CPU at DeiT-S width, depth 2: the first PSAQ loss, the
            images after two steps, an internal CKA heatmap and 3 PGD
            steps from the same start.
18. diff:   the rest of the diff-analysis toolkit on the port's own DeiT-S
            (params at seed 0): the DDV Hessian (analysis/ddv_hessian.py)
            on one batch of 5 with 50-step PGD inputs against the float
            model, the reference driver's tap 30 (blocks.4.mlp.fc2, 20
            weights), 3 probes a trace (seconds a HVP, peak GiB); the
            spectrum at b = 8 over all 49 weights (top_eigenvalues, two at
            max_iter 10; eigenvalue_density at 10 Lanczos steps; seconds,
            HVPs); the restore sweep (analysis/restore.py) of the CLI's
            Gaussian-50 calibration over 64 JPEGs, the baseline and three
            one-index restores, on the fake-quant path (no kernel) and
            through validate(use_int=True) (exactly 12 K1 + 12 K2 a
            forward), every K1 and K2 call of a restored bake's b = 8
            forward held bit for bit against its plain version; ModelDiff
            at b = 8 (analysis/modeldiff.py) between the float model and
            the int4 bake, blackbox 20 iterations (exactly 2 + 2 x 20
            forwards of the bake) and whitebox 2 iterations of 5-step PGD;
            the card against the CPU at DeiT-S width, depth 2, with the
            same params and draws (DDV traces and eigenvalues within 1e-6
            relative, the blackbox's final inputs bit-equal, the restore
            lines equal apart from Time); then the drivers
            ddv_hessian_calc, layerwise_quant_compare and modeldiff_p2
            (diffvit_tpu_torch/drivers) each to its report, with no kernel
            launched.  ddv_cka_calc and the plotting functions need
            matplotlib and are not run here.
19. parallel: the mesh (diffvit_tpu_torch/parallel) on ranks of their own,
            spawned once per world size (2, then 4; each rank a process
            with its own kernel counts): ranks that share the card talk
            over gloo through pinned host memory, NCCL only where every
            rank has a card (else a line says why it was not run).  The
            seeded DeiT-S int4 at b = 64 and a ragged b = 61 under dp=2,
            tp=2, pp=2, pp=4, dp=2 x pp=2 and tp=2 x pp=2; the FQ-ViT
            DeiT-S int8 (K5 + K2 float32 out) and Swin-T int4 (K4 + K2)
            under dp=2 x tp=2 at b = 8; each leg's logits bit-equal to the
            single-process forward on the card, its launches exact on every
            rank (12 K1 + 12 K2 a forward on a dp or tp rank, K1 on 3 of
            the 6 heads under tp; 6 M K1 + 6 M K2 on a pp=2 stage of M
            microbatches), every kernel call of rank 0's forward held bit
            for bit against its plain version, the median of 5 forwards
            and the bytes each rank sends a forward.  The fake-quant DeiT-S
            (calibrated here on 8 images) under sp=2 x tp=2 at b = 8, its
            logits and STE input gradient against the single process
            (rtol = atol = 2e-4, the share of equal elements printed); the
            dryrun of parallel/dryrun.py on 4 ranks; the CLI with
            --int-path --tp 2 --pp 2 on phase cli's fake ImageFolder, its
            report equal to the single-process run's apart from Time.

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
import contextlib
import dataclasses
import functools
import gc
import io
import json
import os
import random
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter, defaultdict

import numpy as np
import torch

from diffvit_tpu_torch import QuantConfig, cli, engine
from diffvit_tpu_torch.analysis import (cka_drivers, datagen, ddv_hessian,
                                        hessian, modeldiff, pgd, restore)
from diffvit_tpu_torch.analysis import mixed_precision as mp
from diffvit_tpu_torch.calib import adaround, qat
from diffvit_tpu_torch.data import imagenet, native_decode
from diffvit_tpu_torch.data.imagenet import device_normalize, normalize_lut
from diffvit_tpu_torch.data.synthetic import (gaussian_calibration,
                                              make_fake_imagefolder)
from diffvit_tpu_torch.drivers import ddv_hessian_calc as drv_ddv_hessian
from diffvit_tpu_torch.drivers import layerwise_quant_compare as drv_restore
from diffvit_tpu_torch.drivers import modeldiff_p2 as drv_modeldiff
from diffvit_tpu_torch.models import swin, swin_int, vit, vit_int
from diffvit_tpu_torch.models.convert import (attn_block_operands,
                                              attn_constants,
                                              int_attn_scalars,
                                              int_model_from_numpy,
                                              mlp_block_operands,
                                              swin_block_constants,
                                              swin_int_model_from_numpy)
from diffvit_tpu_torch.models.swin import (SWIN_SPECS, bit_slot_groups,
                                           num_bit_slots)
from diffvit_tpu_torch.models.vit import VIT_SPECS, ViTSpec, patchify
from diffvit_tpu_torch.ops.bit_types import BIT_TYPE_DICT
from diffvit_tpu_torch.ops.quant import fake_quant
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
# ViT-L/16 at 384 px, full width and depth: 577 tokens, 1024 wide, 24 blocks
VIT_L384 = ViTSpec("vit_large_384", embed_dim=1024, depth=24, num_heads=16,
                   img_size=384)
TINY = ViTSpec("test_tiny", embed_dim=64, depth=2, num_heads=2,
               num_classes=10)
CFG = QuantConfig()  # PTF, LIS, SmoothQuant on; int4 weights
# FQ-ViT (--ptf --lis, W8A8, 4-bit LIS): SmoothQuant off, int8 weights
FQVIT = QuantConfig(smoothquant=False, bit_w=BIT_TYPE_DICT["int8"])
REQUESTS = (1, 1, 1, 1, 8, 64)  # images per request, served in this order
# DeiT-S images a K6 launch of the resident forward's default cut
# (vit_int.K6_SCRATCH_BYTES): a batch of b goes in ceil(b / 128) launches
K6_IMAGES = 128
# kernel vs plain: share of equal int8 codes, max |diff|; the float softmax
# (lis=False) is held to the JAX suite's rule for it: |diff| <= 1 on
# fewer than 2% of codes
TOL = {"exact": (0.999, 1), "softmax": (0.98, 1), "bitwise": (1.0, 0)}
# softmax scales whose int64 LIS row sum could overflow: ViT's 197 keys,
# a Swin window's 49 (lis_sum_fits fails; the 128-bit sum serves them)
WIDE_VIT, WIDE_SWIN = 2.0**-12, 2.0**-13
PEAK_OPS, PEAK_BYTES = 1979e12, 3.35e12  # H100 SXM: int8 op/s, HBM B/s
# H100 SXM dense peaks by operand type (op/s).  P2's tanh chain has no
# published rate: a step is counted in the SASS (phase probes, CHAIN) as
# special-function results ("sfu", 16 a clock an SM) and float32-pipe
# instructions ("fp32_pipe", 128 a clock an SM), whose rates phase probes
# sets from the SM count and nvidia-smi's clocks.max.sm
PEAKS = {"int8": PEAK_OPS, "bf16": 989e12, "float32": 67e12}
CHAIN = {}  # a chain step's instructions by unit (overlap.chain_instructions)


def _swin_plain(qkv5, bias_q, mask_div, scalars, *, num_heads, n_real,
                n_windows, bits=4, lis=True, lis_wide=False):
    return swin_attention.swin_attention_plain(
        qkv5[:, 0], qkv5[:, 1], qkv5[:, 2], bias_q, mask_div, scalars,
        n_real=n_real, n_windows=n_windows, bits=bits, lis=lis,
        lis_wide=lis_wide)


def _swin_plain_v2(qkv, bias_q, mask_div, scalars, *, num_heads, head_dim,
                   n_real, n_windows, bits=4, lis=True, lis_wide=False):
    bw, npad, c3 = qkv.shape
    view = qkv.view(bw, npad, 3, num_heads, head_dim).permute(0, 2, 3, 1, 4)
    o = _swin_plain(view, bias_q, mask_div, scalars, num_heads=num_heads,
                    n_real=n_real, n_windows=n_windows, bits=bits, lis=lis,
                    lis_wide=lis_wide)
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
# the attention launches by kernel name (torch.profiler's): K7a's proj and
# the qkv GEMM on the wgmma mainloop (the proj's instance named by its
# epilogue), the tensor-core cores
LAUNCH_KINDS = (("BlockProjOut", "proj"), ("wgmma_gemm_kernel", "gemm"),
                ("qkv_core_kernel", "core"), ("swin_core_kernel", "core"))
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


PROFILE_TRIES = 5  # torch.profiler now and then records no device activity


def profiled(fn, iters):
    """``prof.key_averages()`` of ``iters`` calls of ``fn`` under
    torch.profiler, after a warm-up; profiled again, up to PROFILE_TRIES
    times, while the trace holds no device time.  None (and a JSON line
    naming what the trace held) when no try saw any: the callers then time
    with CUDA events instead, and say so."""
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
    emit(phase="profiler", no_device_time_after=PROFILE_TRIES,
         keys=sorted({e.key for e in events})[:8], fallback="cuda events")
    return None


def device_ms(fn, iters=10):
    """Device milliseconds per call: the summed time of every kernel a call
    of ``fn`` launches, from torch.profiler, after a warm-up.  Unlike
    :func:`cuda_ms` it leaves out the host's time between launches (where
    the profiler saw nothing, the CUDA events' time, which includes it)."""
    events = profiled(fn, iters)
    if events is None:
        return cuda_ms(fn, iters)
    return sum(getattr(e, "self_device_time_total", 0)
               for e in events) / 1e3 / iters


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
    all Npad), P2 its bf16 dot and a chain step's special-function and
    float32-pipe instructions as the SASS counts them (CHAIN), P3 its two
    int8 GEMMs, P4 one float32 add an element."""
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
    ops = {}
    if probe != "dot_only":
        steps = kw["iters"] * v.numel()
        ops.update(sfu=CHAIN["sfu"] * steps, fp32_pipe=CHAIN["fp32"] * steps)
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
    elif k["lis_wide"]:
        kw.update(lis_wide=True)
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
            if key in ("lis", "lis_fast", "lis_wide", "group", "emit_codes",
                       "iters")}
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
    the main paths (DeiT-S b=64 for K1, K2 and K5, b=128 for K6; Swin-T
    stage 0 b=64 for K4 and K4b), its times and its bound."""
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
        # DeiT-S also at K6_IMAGES, the launch the resident forward makes
        # of a batch of 256
        k6_batches = batches + (K6_IMAGES,) * (spec is SPEC)
        for lis, tol, bs in ((True, "exact", k6_batches),
                             (False, "softmax", batches[1:2] or batches)):
            for b in bs:
                args = (packed, codes((b * spec.seq_len, spec.embed_dim),
                                      b + 11, dev))
                kw = dict(n_real=spec.seq_len, bits=4, lis=lis, nelems=b)
                heaviest = spec is SPEC and b == K6_IMAGES and lis \
                    and (f"{spec.name} b={b}", args, kw)
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
    kernels_past_256_keys(dev, summary)


def kernels_past_256_keys(dev, summary):
    """ViT-L/16 at 384 px (577 keys, past the 256 a warp's packed scores
    hold: the cores' long rows): K1 and K5 at b = 1 and 8 on block 0's
    weights, K6 at full depth at b = 1 and 16 (the resident forward's
    launch at these widths), each bit for bit against its plain version."""
    spec = VIT_L384
    ip_np = random_int_model(spec, CFG, seed=0)
    ib = ip_np["blocks"][0]
    for name in ("fused_qkv_attention_v2", "fused_int_attention"):
        for b in (1, 8):
            args, kw = kernel_case(name, ib, spec, b, dev)
            note(summary, name, hold(name, args, kw, "bitwise", iters=5,
                                     spec=spec.name, batch=b))
    ip = int_model_from_numpy(ip_np, spec, dev, CFG)
    packed = prepare_resident(ip, spec, CFG)
    for b in (1, 16):
        args = (packed, codes((b * spec.seq_len, spec.embed_dim), b + 11,
                              dev))
        kw = dict(n_real=spec.seq_len, bits=4, lis=True, nelems=b)
        note(summary, "resident_codes",
             hold("resident_codes", args, kw, "bitwise", iters=3,
                  spec=spec.name, batch=b))


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


def _counted(run):
    """Set every kernel's count to 0, call ``run``, read the counts."""
    for k in KERNELS.values():
        k["fn"].launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {name: k["fn"].launches for name, k in KERNELS.items()}


def _exact(counts, expected, where):
    for name, n in counts.items():
        if n != expected.get(name, 0):
            raise RuntimeError(f"{where}: {name} launched {n} times, "
                               f"expected {expected.get(name, 0)}")


def drive(expected, run):
    """Set every kernel's count to 0, call ``run``, read the counts: fails
    unless each kernel launched exactly ``expected[name]`` times (0 for the
    kernels not named).  Returns run's result and the counts."""
    out, launches = _counted(run)
    _exact(launches, expected, "drive")
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


def k6_launches(b):
    """K6 launches of the DeiT-S resident forward for ``b`` images at its
    default cut: at most K6_IMAGES a launch."""
    return -(-b // K6_IMAGES)


def serve(spec, ip_np, path_kernels, dev, cfg=CFG, label=None,
          resident=False):
    """Save ``ip_np`` (under ``cfg``) as an artifact, load it on the card
    and on the CPU (``resident``: served through K6), answer the uint8
    requests through IntModel with a launch check (each kernel of
    ``path_kernels`` once per block of every forward, or K6 once per launch
    of ``k6_launches``), time requests and forwards, hold the b=8 logits
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
        expected = {"resident_codes": sum(k6_launches(b)
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
    """DeiT-S int4 served resident: K6 once per launch of ``k6_launches``
    and no K1 or K2 (checked by serve); every request's logits equal the
    per-kernel IntModel's on the card; b=64, and a b=200 request above
    K6_IMAGES (2 launches of 100 at the default cut), in one launch
    (``microbatch=None``) give the same logits, and both forwards are
    timed.  Then K6 alone at b = 1, 8, 64, 128 on the model's packed
    weights: its device time (torch.profiler) and block 0's ms by step
    kind from one launch with its barrier stamps on
    (``resident_step_ms``); the b=128 device time and stamped total go
    into the kernels line."""
    label = f"{SPEC.name} resident"
    ip_np = random_int_model(SPEC, CFG, seed=0)
    model, requests, outputs, launches = serve(SPEC, ip_np, (), dev,
                                               label=label, resident=True)
    per_kernel = engine.IntModel(ip_np, SPEC, CFG, dev)
    equal = all(np.array_equal(o.cpu().numpy(), per_kernel(x).cpu().numpy())
                for o, x in zip(outputs, requests))
    big = np.random.default_rng(3).integers(0, 256, (200, 3, SPEC.img_size,
                                                     SPEC.img_size),
                                            dtype=np.uint8)
    cut, _ = drive({"resident_codes": k6_launches(len(big))},
                   lambda: model(big))
    equal = equal and np.array_equal(cut.cpu().numpy(),
                                     per_kernel(big).cpu().numpy())
    for request, default in ((requests[REQUESTS.index(64)],
                              outputs[REQUESTS.index(64)]), (big, cut)):
        x = torch.tensor(model.encode(request), device=dev)

        def one_launch(x=x):
            with torch.inference_mode():
                return vit_int.forward_q_int_serve(model.ip, SPEC, CFG, x,
                                                   packed=model.packed,
                                                   microbatch=None)

        whole, _ = drive({"resident_codes": 1}, one_launch)
        equal_whole = bool(np.array_equal(whole.cpu().numpy(),
                                          default.cpu().numpy()))
        emit(phase="resident", model=label, logits_equal_per_kernel=equal,
             microbatch_none_equal=equal_whole, batch=len(request),
             launches=k6_launches(len(request)),
             forward_ms=cuda_ms(lambda: model(x), iters=10),
             microbatch_none_forward_ms=cuda_ms(one_launch, iters=10))
        if not (equal and equal_whole):
            raise RuntimeError(
                "the resident forward's logits differ from the per-kernel "
                "forward's, or microbatch=None differs")
    for b in (1, 8, 64, K6_IMAGES):
        x = codes((b * SPEC.seq_len, SPEC.embed_dim), b + 11, dev)
        kw = dict(n_real=SPEC.seq_len, lis=True, nelems=b)
        ms = device_ms(lambda: resident_codes(model.packed, x, **kw))
        steps = resident_step_ms(model.packed, x, **kw)
        emit(phase="resident", model=label, batch=b, device_ms=ms,
             step_ms=steps)
        if b == K6_IMAGES:
            summary["resident_codes"].update(device_ms=ms,
                                             stamped_ms=steps["total"])
    serving_past_256_keys(dev)
    return launches


def serving_past_256_keys(dev):
    """ViT-L/16 at 384 px on both routes: resident (K6 at 577 keys, at
    most 16 images a launch) at b = 1 and 16 and per kernel (K1 at 577
    keys and K2, 24 of each) at b = 8, each request's logits equal to the
    other route's bit for bit, both forwards timed; then K6 alone at b = 1
    and 16: its device time and block 0's ms by step kind."""
    spec, label = VIT_L384, f"{VIT_L384.name} resident"
    ip_np = random_int_model(spec, CFG, seed=0)
    resident = engine.IntModel(ip_np, spec, CFG, dev, resident=True)
    per_kernel = engine.IntModel(ip_np, spec, CFG, dev)
    rng = np.random.default_rng(5)
    per_forward = {"fused_qkv_attention_v2": spec.depth,
                   "fused_int_mlp": spec.depth}
    for b, route in ((1, "resident"), (16, "resident"), (8, "kernels")):
        x = rng.integers(0, 256, (b, 3, spec.img_size, spec.img_size),
                         dtype=np.uint8)
        model, other = (resident, per_kernel) if route == "resident" \
            else (per_kernel, resident)
        got, _ = drive({"resident_codes": 1} if route == "resident"
                       else per_forward, lambda: model(x))
        equal = bool(np.array_equal(got.cpu().numpy(),
                                    other(x).cpu().numpy()))
        xc = torch.tensor(model.encode(x), device=dev)
        emit(phase="resident", model=label, route=route, batch=b,
             logits_equal_other_route=equal,
             finite=bool(torch.isfinite(got).all()),
             forward_ms=cuda_ms(lambda: model(xc), iters=3))
        if not equal:
            raise RuntimeError(f"{spec.name} b={b}: the resident and the "
                               "per-kernel logits differ")
    for b in (1, 16):
        x = codes((b * spec.seq_len, spec.embed_dim), b + 11, dev)
        kw = dict(n_real=spec.seq_len, lis=True, nelems=b)
        emit(phase="resident", model=label, batch=b,
             device_ms=device_ms(lambda: resident_codes(resident.packed, x,
                                                        **kw)),
             step_ms=resident_step_ms(resident.packed, x, **kw))


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


def _calibrated(cfg, x, dev, name=SPEC.name):
    """engine.QuantizedViT of the model ``name`` (DeiT-S by default; params
    at seed 0) calibrated on ``x`` on ``dev``, and the calibration's wall
    seconds."""
    q = engine.QuantizedViT(name, cfg, seed=0, device=dev)
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
            {"resident_codes": sum(k6_launches(len(r))
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


SWIN_KERNELS = ("fused_swin_attention", "fused_swin_attention_v2",
                "fused_int_mlp")


def kernel_calls(run, module=swin_int, names=SWIN_KERNELS):
    """Every call ``run()`` makes to the kernels ``names`` of the forward's
    ``module`` (by default the Swin forward's), in order, as (kernel name,
    args, kwargs)."""
    calls = []
    orig = {name: getattr(module, name) for name in names}

    def recording(name):
        def call(*args, **kw):
            calls.append((name, args, kw))
            return orig[name](*args, **kw)
        return call

    for name in names:
        setattr(module, name, recording(name))
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for name, fn in orig.items():
            setattr(module, name, fn)
    return calls


def phase_calibrate_swin(dev, summary):
    """Calibrate -> bake -> serve on the card, the port's own Swin-T
    (params from swin.init_swin_params at seed 0, through
    engine.QuantizedViT): the card against the CPU at b=8 (the qparams,
    global_distance, the fake-quant forward's and the served logits); the
    CLI's default Gaussian batch of 50 (seconds, peak memory, every
    block's softmax scale); that bake served at b = 1, 8, 64 through
    exactly 12 K4 + 12 K2 a forward, and at b = 8 through K4b with logits
    equal to K4's; then K4, K4b and K2 bit for bit against their plain
    versions on every operand that bake gave them at b = 8.  Returns the
    launches by path."""
    k4, k4b, k2 = SWIN_KERNELS
    depth = sum(SWIN.depths)
    rng = np.random.default_rng(7)
    requests = [rng.integers(0, 256, (b, 3, 224, 224), dtype=np.uint8)
                for b in CALIB_SERVE]
    classes = SWIN.num_classes
    paths = {}

    # the card against the CPU, b = 8
    x8 = gaussian_calibration(8, seed=0)
    card, card_s = _calibrated(CFG, x8, dev, SWIN.name)
    cpu, cpu_s = _calibrated(CFG, x8, torch.device("cpu"), SWIN.name)
    total, equal, diffs = _qparam_diffs(card.qparams, cpu.qparams)
    gd_equal = bool(np.array_equal(card.global_distance,
                                   cpu.global_distance))
    emit(phase="calibrate_swin", part="card_vs_cpu", batch=8,
         qparam_elements=total, equal_share=equal / total,
         differing=len(diffs), card_seconds=card_s, cpu_seconds=cpu_s,
         global_distance_rows=len(card.global_distance),
         global_distance_equal=gd_equal)
    emit(phase="calibrate_swin_diffs", elements=diffs)
    if equal / total < 0.999 or not gd_equal:
        raise RuntimeError(f"Swin card vs CPU: {equal / total:.6f} of "
                           f"qparam elements equal (at least 0.999 needed), "
                           f"global_distance equal: {gd_equal}")
    x = requests[1]
    agree(card(x).cpu().numpy(), cpu(x).numpy(), (len(x), classes),
          phase="calibrate_swin", part="card_vs_cpu_forward_q", batch=8)
    got, launches_cvc = drive({k4: depth, k2: depth},
                              lambda: card.prepare_int()(x))
    agree(got.cpu().numpy(), cpu.prepare_int()(x).numpy(),
          (len(x), classes), phase="calibrate_swin",
          part="card_vs_cpu_served", batch=8)

    # the CLI's default calibration batch of 50
    x50 = gaussian_calibration(50, seed=0)
    torch.cuda.reset_peak_memory_stats()
    q, secs = _calibrated(CFG, x50, dev, SWIN.name)
    s_a2 = [float(q.qparams[f"layers.{si}.blocks.{bi}.attn.qact2.scale"])
            for si, d in enumerate(SWIN.depths) for bi in range(d)]
    emit(phase="calibrate_swin", part="b50", config="p2vit_int4", batch=50,
         seconds=secs, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
         softmax_scale_log2=[float(np.log2(v)) for v in s_a2],
         lis_sum_fits=[attention.lis_sum_fits(v, 49) for v in s_a2])
    model = q.prepare_int()
    model(requests[0])  # warm-up: K-major weight copies
    outs, launches = drive({k4: depth * len(requests),
                            k2: depth * len(requests)},
                           lambda: [model(r) for r in requests])
    paths[f"{SWIN.name} calibrated"] = {
        k: n + launches_cvc[k] for k, n in launches.items()}
    for r, o in zip(requests, outs):
        o = o.cpu().numpy()
        if o.shape != (len(r), classes) or not np.isfinite(o).all():
            raise RuntimeError(f"calibrated Swin-T: bad logits, shape "
                               f"{o.shape}")
        fake = q(r).cpu().numpy()
        xc = torch.tensor(model.encode(r), device=dev)
        emit(phase="calibrate_swin", part="serve", config="p2vit_int4",
             batch=len(r), forward_ms=cuda_ms(lambda: model(xc), 5),
             argmax_equal_forward_q=float(np.mean(
                 fake.argmax(1) == o.argmax(1))),
             logits_distinct_across_images=bool(len(r) == 1 or (
                 o != o[0]).any()))

    # the natural-layout contract (K4b) on the same bake, b = 8
    xc = torch.tensor(model.encode(requests[1]), device=dev)

    def forward_v2():
        with torch.inference_mode():
            return swin_int.forward_q_int(model.ip, SWIN, CFG, xc,
                                          attn_v2=True)
    got_v2, paths[f"{SWIN.name} calibrated attn_v2"] = drive(
        {k4b: depth, k2: depth}, forward_v2)
    equal_v2 = bool(torch.equal(got_v2, outs[1]))
    emit(phase="calibrate_swin", part="attn_v2", batch=8,
         logits_equal_k4=equal_v2)
    if not equal_v2:
        raise RuntimeError("the calibrated Swin-T's K4b logits differ from "
                           "its K4 logits")

    # the kernels on the operands this bake gives them: per block the
    # attention, then the MLP
    for route, run in (("K4", lambda: model(xc)), ("K4b", forward_v2)):
        for i, (name, args, kw) in enumerate(kernel_calls(run)):
            note(summary, name, hold(name, args, kw, "bitwise", iters=5,
                                     model=f"{SWIN.name} calibrated",
                                     route=route, batch=8, block=i // 2))
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
    warm-up ("events": the whole call by CUDA events, where the profiler
    saw nothing)."""
    events = profiled(fn, iters)
    if events is None:  # no launch kinds: the whole call by CUDA events
        return {"events": cuda_ms(fn, iters)}
    out = defaultdict(float)
    for e in events:
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
    # K7a's three launches (qkv GEMM, core, proj), and the proj GEMM alone
    # in torch._int_mm (int32 out: a reference, not the same function)
    ip_np = random_int_model(SPEC, CFG, seed=0)
    for b in (1, 8, 64):
        args, kw = alt_kernel_cases(SPEC, ip_np, b, dev, npad=200,
                                    seed=b)["fused_attention_block"]
        fn = attention.fused_attention_block
        t = device_by_launch(lambda: fn(*args, **kw))
        rows, c = b * 200, SPEC.embed_dim
        a = codes((rows, c), b + 11, dev)
        w = codes((c, c), b + 12, dev)
        mm = dict(proj_int_mm_ms=int_mm_ms(a, w), proj_int_mm_device_ms=(
            device_ms(lambda: torch._int_mm(a, w))
            if int_mm_takes(a, w) else None))
        emit(phase="attention", kernel="fused_attention_block",
             at=f"{SPEC.name} b={b}", lis=True, events_ms=cuda_ms(
                 lambda: fn(*args, **kw)), device_ms=sum(t.values()),
             **{f"{k}_device_ms": v for k, v in t.items()}, **mm,
             bound_ms=bound("fused_attention_block", args, kw)[0])
        if b == 64:
            summary["fused_attention_block"].update(
                device_ms=sum(t.values()), **mm,
                **{f"{k}_device_ms": v for k, v in t.items()})
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
    for b in (1, 8, 64):  # K7a's proj at Npad 200
        f = attention.proj_gemm_footprint(b * 200, SPEC.embed_dim,
                                          SPEC.embed_dim, dev)
        prints.append(("fused_attention_block proj", f"{SPEC.name} b={b}",
                       True, f))
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
    geometry (iters 5 a side: the plain versions take up to tens of ms),
    P1's and P5's also at B = 1 and 8; P1's paired against the producer and
    the consumer run alone at each batch; P1's and P5's footprints, failing
    on a spill; P2's dot_only with torch.mm (float32 out) and P4 with
    torch.sum beside them (the function in one PyTorch call, which the port
    never calls).  P2 at 64 and 192 rows and P3 at 197 and 1,000 rows too
    (partly filled persistent blocks, masked edges), P2 at K = 32, 96 and
    0, P3 at Cin 1024 -> 4096 (more K stages than pipelined's ring), P3's
    dot, pipelined and staged held bit-equal to each other at each shape;
    P2's and P3's footprints; the chain's instructions counted in the SASS,
    which bound P2's chain modes; P4 bit for bit at ragged sizes (shares
    shorter than a stage, short last stages) and its device time beside
    torch.sum's at the legs' batch.  The served kernels that the legs time
    beside the probes (K1 with the fast LIS and with the float softmax,
    K8's _v3, _v4 with group 2 and 4, _v5; K2 on P3's operands) are held
    at the legs' shapes and arguments too."""
    def row(name, args, kw, label, library_ms=None, tol="exact",
            beside=None, heaviest=True, **opts):
        # a served kernel's line names the probe it is timed beside
        where = dict(beside=beside) if beside else \
            dict(probe=name.split(".")[0])
        result = hold(name, args, kw, tol, iters=5, at=label, **where,
                      **opts)
        note(summary, name, result,
             None if beside or not heaviest else (label, args, kw),
             library_ms)

    # P5 and P1 also at B = 1 and 8 (ragged grids, persistent blocks with
    # few items), before the legs' batch, whose row goes to the summary
    heads = dict(num_heads=attn_overlap.H, head_dim=attn_overlap.D)
    for b in (1, 8):
        xb, *ops = attn_overlap.inputs(dev, b)
        row("attn_overlap.qkv_attention_nv", (xb, *ops), heads, f"B={b}",
            heaviest=False)
    x, *ops = attn_overlap.inputs(dev)
    at = f"B={x.shape[0]}"
    for fn, kw in attn_overlap.VARIANTS.values():
        name = _variant_name(fn)
        row(name, (x, *ops), kw, at,
            tol="exact" if kw.get("lis", True) else "softmax",
            beside=None if name in PROBES else "attn_overlap")
    # K1 with the LIS and P5 by launch: one qkv GEMM kernel, so the cores'
    # difference is the LIS step's device time.  A trace here has held as
    # little as 39% of the call's event time (launches dropped): up to
    # three tries, the line gives both
    for variant in ("k1_lis", "p5_linear"):
        fn, kw = attn_overlap.VARIANTS[variant]
        events = cuda_ms(lambda: fn(x, *ops, **kw))
        for _ in range(3):
            t = device_by_launch(lambda: fn(x, *ops, **kw))
            if sum(t.values()) >= 0.9 * events:
                break
        emit(phase="probes", probe="attn_overlap", variant=variant, at=at,
             events_ms=events, device_ms=sum(t.values()),
             **{f"{k}_device_ms": v for k, v in t.items()})

    n_real = dict(n_real=pingpong.N)
    for b in (1, 8, pingpong.BATCH):
        x, w, mb, scores, v, scal = pingpong.inputs(dev, b)
        p_args, c_args = (x, w, mb, scal), (scores, v, scal)
        at, top = f"B={b}", b == pingpong.BATCH
        row("pingpong.producer", p_args, heads, at, heaviest=top)
        row("pingpong.consumer", c_args, n_real, at, heaviest=top)
        row("pingpong.paired", (x, w, mb, scores, v, scal),
            dict(heads, **n_real), at, heaviest=top)
        sco, out = pingpong.paired(x, w, mb, scores, v, scal, **heads,
                                   **n_real)
        halves = bool(
            torch.equal(sco, pingpong.producer(*p_args, **heads))
            and torch.equal(out, pingpong.consumer(*c_args, **n_real)))
        emit(phase="probes", probe="pingpong", at=at,
             paired_equals_halves=halves)
        if not halves:
            raise RuntimeError(f"pingpong.paired differs from its two halves"
                               f" at {at}")
    probe_footprints(dev)

    chain_bound(dev)
    for rows in (64, 192, overlap.ROWS):
        a, b, v = overlap.inputs(dev, rows)
        top, mm = rows == overlap.ROWS, None
        if top:  # y alone, and y with the copy of v (the whole dot_only)
            mm = mm_f32_ms(a, b)
            pair = None if mm is None else mm_copy_ms(a, b, v)
            summary["overlap.dot_only"]["library_pair_ms"] = pair
            emit(phase="probes", probe="overlap", at=f"{rows}x{b.shape[1]}",
                 torch_mm_ms=mm, torch_mm_copy_ms=pair)
        for mode in overlap.MODES:
            row(f"overlap.{mode}", (a, b, v), dict(iters=overlap.ITERS),
                f"{rows}x{b.shape[1]}", heaviest=top,
                library_ms=mm if mode == "dot_only" else None,
                compare=lambda got, want, m=mode, a=a, b=b: overlap.compare(
                    m, a, b, got, want, overlap.ITERS))
    # off the legs' geometry: K = 32 (a stage half zero filled), K = 96 on
    # three column tiles, K = 0 (no stage)
    for shape in ((128, 64, 32), (192, 192, 96), (64, 64, 0)):
        a, b, v = overlap.inputs(dev, *shape)
        for mode in overlap.MODES:
            row(f"overlap.{mode}", (a, b, v), dict(iters=overlap.ITERS),
                "x".join(map(str, shape)), heaviest=False,
                compare=lambda got, want, m=mode, a=a, b=b: overlap.compare(
                    m, a, b, got, want, overlap.ITERS))

    # the legs' widths, then Cin = 1024 (ViT-L's MLP): more K stages than
    # pipelined's ring holds for a tile
    for rows, widths in ((197, ()), (1000, ()), (1000, (1024, 4096)),
                         (overlap_mlp.ROWS, ())):
        args = overlap_mlp.inputs(dev, rows, *widths)
        at = f"rows={rows}" + (f" {widths[0]}->{widths[1]}" if widths
                               else "")
        outs = {}
        for mode in overlap_mlp.MODES:
            row(f"overlap_mlp.mlp_{mode}", args, {}, at,
                heaviest=rows == overlap_mlp.ROWS,
                decode=lambda y, s=args[4][2]: torch.round(y / s))
            outs[mode] = overlap_mlp.KERNELS[f"mlp_{mode}"](*args)
        equal = all(torch.equal(outs["dot"], outs[m])
                    for m in ("pipelined", "staged"))
        emit(phase="probes", probe="overlap_mlp", at=at,
             dot_pipelined_staged_bit_equal=equal)
        if not equal:
            raise RuntimeError(f"P3's pipelined or staged differs from dot "
                               f"at {at}")
    k2 = overlap_mlp.production_args(*args)
    row("fused_int_mlp", k2, {}, at, beside="overlap_mlp",
        decode=lambda y, s=k2[7]: torch.round(y / s))

    # P4 on ragged sizes (a share shorter than a stage, a short last stage,
    # an odd number of stages, the legs' constant of halves), then at the
    # legs' b=64 batch with its device time and torch.sum's beside it
    rng = np.random.default_rng(0)
    for shape in ((4,), (16,), (8188,), (8196,), (7 * 8192,), (1176, 1024)):
        xs = torch.full(shape, 0.5, device=dev) if len(shape) == 2 else \
            torch.tensor(rng.integers(0, 255, shape), dtype=torch.float32,
                         device=dev)
        row("ingest.tile_sum", (xs,), {}, "x".join(map(str, shape)),
            heaviest=False, tol="bitwise",
            decode=lambda y: y.view(torch.int32))
    xf = torch.tensor(rng.integers(0, 255, ingest.SHAPE, dtype=np.uint8),
                      device=dev).reshape(ingest.FLAT).to(torch.float32)

    def torch_sum():
        return torch.sum(xf, dtype=torch.float64)
    row("ingest.tile_sum", (xf,), {}, "b=64 uint8 batch", tol="bitwise",
        decode=lambda y: y.view(torch.int32), library_ms=cuda_ms(torch_sum))
    p4 = dict(device_ms=device_ms(lambda: ingest.tile_sum(xf)),
              library_device_ms=device_ms(torch_sum))
    summary["ingest.tile_sum"].update(p4)
    emit(phase="probes", probe="ingest", at="b=64 uint8 batch",
         events_ms=summary["ingest.tile_sum"]["ms"],
         torch_sum_ms=summary["ingest.tile_sum"]["library_ms"], **p4,
         bound_ms=summary["ingest.tile_sum"]["bound_ms"])


def probe_footprints(dev):
    """The footprints of P1's three kernels (paired by role) and of P5's
    linear core at B = 1, 8 and the legs' batch, of P2's five kernels and
    of P3's five fc1 kernels at the legs' plans (setmaxnreg's split by
    role beside each); fails on a spill."""
    prints = [(f"pingpong.{role}", f"B={b}", pingpong.footprint(role, b, dev))
              for b in (1, 8, pingpong.BATCH)
              for role in ("producer", "consumer", "paired")]
    prints += [("attn_overlap.qkv_attention_nv core", f"B={b}",
                attn_overlap.core_footprint(b, dev))
               for b in (1, 8, attn_overlap.BATCH)]
    prints += [(f"overlap.{mode}", f"rows={overlap.ROWS}",
                overlap.footprint(mode, dev=dev)) for mode in overlap.MODES]
    prints += [(f"overlap_mlp.mlp_{mode} fc1", f"rows={overlap_mlp.ROWS}",
                overlap_mlp.fc1_occupancy(mode, dev=dev))
               for mode in overlap_mlp.MODES]
    for kernel, at, f in prints:
        emit(phase="footprint", kernel=kernel, at=at, **f)
    spills = [(kernel, at) for kernel, at, f in prints
              if f["local_bytes"] > 0]
    if spills:
        raise RuntimeError(f"probe kernels spill to local memory: {spills}")


def mm_f32_ms(a, b):
    """ms of ``torch.mm(a, b, out_dtype=torch.float32)`` (the
    ``aten::mm.dtype`` overload: P2 dot_only's bf16 product, float32 out,
    in one PyTorch call), or None where this torch lacks it (a line says
    why)."""
    def call():
        return torch.mm(a, b, out_dtype=torch.float32)
    try:
        call()
    except (TypeError, RuntimeError, NotImplementedError) as e:
        emit(phase="probes", probe="overlap", library="torch.mm out_dtype",
             unavailable=f"{type(e).__name__}: {str(e)[:200]}")
        return None
    return cuda_ms(call)


def mm_copy_ms(a, b, v):
    """ms of ``torch.mm(a, b, out_dtype=torch.float32)`` and
    ``o2.copy_(v)`` in turn: the library pair for P2 dot_only's whole
    function (y, and the copy of v)."""
    o2 = torch.empty_like(v)
    return cuda_ms(lambda: (torch.mm(a, b, out_dtype=torch.float32),
                            o2.copy_(v)))


def chain_bound(dev):
    """Counts a chain step's instructions in the probes library's SASS
    (``overlap.chain_instructions``: vpu_only's step loop) into CHAIN, and
    sets the special-function and float32-pipe rates from the SM count and
    the maximum SM clock (nvidia-smi); one JSON line with the counts, the
    rates and the bounds of 220 steps over the legs' elements by unit,
    beside the issue slots' (every instruction of a step, one warp
    instruction a clock a scheduler: the float32 pipe's 128 lanes a clock
    an SM) and the three-float32-operations count the unit bound
    replaces."""
    CHAIN.update(overlap.chain_instructions(build.library_path("probes")))
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    PEAKS.update(sfu=16 * sms * mhz * 1e6, fp32_pipe=128 * sms * mhz * 1e6)
    steps = overlap.ITERS * overlap.ROWS * overlap.N
    emit(phase="probes", probe="overlap", chain_sass=CHAIN, sms=sms,
         clocks_max_sm_mhz=mhz, sfu_per_s=PEAKS["sfu"],
         fp32_pipe_per_s=PEAKS["fp32_pipe"],
         chain_bound_ms={"sfu": 1e3 * CHAIN["sfu"] * steps / PEAKS["sfu"],
                         "fp32_pipe": 1e3 * CHAIN["fp32"] * steps
                         / PEAKS["fp32_pipe"],
                         "issue": 1e3 * CHAIN["instructions"] * steps
                         / PEAKS["fp32_pipe"],
                         "three_float32_ops": 1e3 * 3 * steps
                         / PEAKS["float32"]})


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
    # dot_only and vpu_only (at two lengths) also size the chain
    for mode in overlap.MODES:
        expected[f"overlap.{mode}"] = \
            {"dot_only": 2, "vpu_only": 3}.get(mode, 1) * calls
    for mode in overlap_mlp.MODES:
        expected[f"overlap_mlp.mlp_{mode}"] = calls
    expected["fused_int_mlp"] = calls
    expected["ingest.tile_sum"] = 6 * calls  # one a step in each leg
    answers, launches = drive(expected,
                              lambda: {k: f(dev) for k, f in legs.items()})
    for probe, answer in answers.items():
        emit(phase="probes", probe=probe, **answer)
    return launches


def _wide_vit(cfg):
    """DeiT-S random int-model with every block's softmax scale at
    WIDE_VIT."""
    ip = random_int_model(SPEC, cfg, seed=0)
    for ib in ip["blocks"]:
        ib["attn.qact_attn1"]["scale"] = np.float32(WIDE_VIT)
    return ip


def phase_lis_wide(dev, summary):
    """Every kernel that includes csrc/lis.cuh with the 128-bit LIS row sum
    (``lis_wide``), bit for bit against its plain version: K1, K5, K8 (v1,
    v3, v4, v5), K7a and K6 at DeiT-S b = 1, 8, 64 with s_a = WIDE_VIT, and
    K4 and K4b at Swin-T's four stages, b = 1 and 64, with s_a2 =
    WIDE_SWIN on every block; the b = 64 (stage 0) row's times and bound go
    into the kernels line as ``lis_wide_*``."""
    if attention.lis_sum_fits(WIDE_VIT, SPEC.seq_len) \
            or attention.lis_sum_fits(WIDE_SWIN, 49):
        raise RuntimeError("the lis_wide scales fit the int64 row sum")
    ip, ip_fq = _wide_vit(CFG), _wide_vit(FQVIT)
    packed = prepare_resident(int_model_from_numpy(ip, SPEC, dev, CFG), SPEC,
                              CFG)
    for b in (1, 8, 64):
        rows = {
            "fused_qkv_attention_v2": kernel_case(
                "fused_qkv_attention_v2", ip["blocks"][0], SPEC, b, dev,
                lis_wide=True),
            "fused_int_attention": kernel_case(
                "fused_int_attention", ip_fq["blocks"][0], SPEC, b, dev,
                lis=True, lis_wide=True),
            "resident_codes": (
                (packed, codes((b * SPEC.seq_len, SPEC.embed_dim), b + 11,
                               dev)),
                dict(n_real=SPEC.seq_len, bits=4, lis=True, nelems=b,
                     lis_wide=True))}
        alt = alt_kernel_cases(SPEC, ip, b, dev, npad=200, seed=b)
        for name in K8 + ("fused_attention_block",):
            if name != "fused_qkv_attention_v5" or b % 2 == 0:
                rows[name] = (alt[name][0], dict(alt[name][1], lis_wide=True))
        for name, (args, kw) in rows.items():
            decode = None
            if name == "fused_attention_block":
                def decode(y, s=args[8][3]):  # the qact2 grid
                    return torch.round(y / s)
            heaviest = b == 64 and (f"{SPEC.name} b=64", args, kw)
            note(summary, name, hold(name, args, kw, "bitwise", decode,
                                     iters=5, spec=SPEC.name, batch=b,
                                     s_a=WIDE_VIT),
                 heaviest, variant="lis_wide")
    ips = random_swin_int_model(SWIN, CFG, seed=0)
    for key in ips["qp"]:
        if key.endswith(".attn.qact2.scale"):
            ips["qp"][key] = np.float32(WIDE_SWIN)
    for stage in range(SWIN.num_layers):
        for b in (1, 64):
            cases = swin_cases(ips, stage, b, dev)
            for name in ("fused_swin_attention", "fused_swin_attention_v2"):
                args, kw = cases[name]
                if not kw.get("lis_wide"):
                    raise RuntimeError(f"{name}: stage {stage} not wide")
                heaviest = stage == 0 and b == 64 and (
                    f"{SWIN.name} stage 0 b=64", args, kw)
                note(summary, name, hold(name, args, kw, "bitwise", iters=5,
                                         spec=SWIN.name, stage=stage,
                                         batch=b, s_a2=WIDE_SWIN),
                     heaviest, variant="lis_wide")


CLI_FOLDER = dict(num_classes=8, per_class=8, size=(96, 80))  # 64 JPEGs
CLI_BATCH = 16  # --val-batchsize
K1, K2, K4, K6 = ("fused_qkv_attention_v2", "fused_int_mlp",
                  "fused_swin_attention", "resident_codes")


def phase_cli(dev):
    """The port's CLI end to end (cli.main, as ``python3 -m
    diffvit_tpu_torch.cli`` runs it) on a fake ImageFolder; each run's
    launch counts held exactly (drive), its summary line, loss, Prec@1 and
    Prec@5 and wall seconds printed; then the served artifact's per-kernel
    and resident logits, and IntModel(microbatch=8) at b = 64, each bit
    for bit against the unchunked per-kernel forward."""
    launches = {}
    images = CLI_FOLDER["num_classes"] * CLI_FOLDER["per_class"]
    forwards = -(-images // CLI_BATCH)
    per_kernel = {K1: SPEC.depth * forwards, K2: SPEC.depth * forwards}
    with tempfile.TemporaryDirectory() as tmp:
        make_fake_imagefolder(os.path.join(tmp, "val"), **CLI_FOLDER)
        deit = os.path.join(tmp, "deit_small_int4.npz")
        swin = os.path.join(tmp, "swin_tiny_int4.npz")
        engine.save_int_model(swin, random_swin_int_model(SWIN, CFG, seed=0),
                              SWIN, CFG)
        common = ["--device-prefetch", "2", "--val-batchsize",
                  str(CLI_BATCH), "--num-workers", "8"]
        runs = (
            ("deit_small --quant --int-path --save-int",
             [SPEC.name, tmp, "--quant", "--mode", "1", "--int-path",
              "--save-int", deit, "--wire", "u8"], per_kernel),
            ("deit_small --load-int u8",
             [SPEC.name, tmp, "--load-int", deit, "--wire", "u8"],
             per_kernel),
            ("deit_small --load-int f32",
             [SPEC.name, tmp, "--load-int", deit, "--wire", "f32"],
             per_kernel),
            ("deit_small --load-int --resident",
             [SPEC.name, tmp, "--load-int", deit, "--resident", "--wire",
              "u8"], {K6: forwards * k6_launches(CLI_BATCH)}),
            ("swin_tiny --load-int",
             [SWIN.name, tmp, "--load-int", swin, "--wire", "u8"],
             {K4: sum(SWIN.depths) * forwards,
              K2: sum(SWIN.depths) * forwards}),
        )
        for label, argv, expected in runs:
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                (loss, top1, top5), counts = drive(
                    expected, lambda: cli.main(argv + common))
            seconds = time.perf_counter() - t0
            summary_line = [ln for ln in out.getvalue().splitlines()
                            if ln.startswith(" * Prec@1")]
            emit(phase="cli", run=label, images=images, seconds=seconds,
                 line=summary_line, loss=loss, prec1=top1, prec5=top5,
                 launches={k: v for k, v in counts.items() if v})
            if len(summary_line) != 1 or not np.isfinite(loss):
                raise RuntimeError(f"cli {label}: no report, or loss {loss}")
            launches[f"cli {label}"] = counts
        x = np.random.default_rng(5).integers(0, 256, (64, 3, 224, 224),
                                              dtype=np.uint8)
        models = {
            "per_kernel": engine.load_int_model(deit, dev),
            "resident": engine.load_int_model(deit, dev, resident=True),
            "microbatch_8": engine.load_int_model(deit, dev, microbatch=8),
        }
    expected = {"per_kernel": {K1: SPEC.depth, K2: SPEC.depth},
                "resident": {K6: k6_launches(64)},
                "microbatch_8": {K1: SPEC.depth * 8, K2: SPEC.depth * 8}}
    logits = {}
    for name, model in models.items():
        got, launches[f"cli logits {name}"] = drive(expected[name],
                                                    lambda: model(x))
        logits[name] = got.cpu().numpy()
    equal = {name: bool(np.array_equal(v, logits["per_kernel"]))
             for name, v in logits.items() if name != "per_kernel"}
    emit(phase="cli", run="logits", batch=64,
         equal_to_per_kernel=equal,
         finite=bool(np.isfinite(logits["per_kernel"]).all()))
    if not all(equal.values()) or not np.isfinite(logits["per_kernel"]).all():
        raise RuntimeError(f"the artifact's logits differ by route: {equal}")
    return launches



NATIVE_SIZE = (500, 375)  # width x height: an ImageNet-like JPEG
NATIVE_FOLDER = dict(num_classes=8, per_class=8, size=NATIVE_SIZE,
                     texture="photo")  # 64 JPEGs
NATIVE_INGEST = dict(num_classes=8, per_class=32, size=NATIVE_SIZE,
                     texture="photo", seed=1)  # 256 JPEGs
NATIVE_BATCH = 64
NATIVE_PASSES = 3  # ingest passes a route; the median is printed
FAST_BOUNDS = (0.05, 0.998)  # tests/test_native_fast_decode.py: mean, corr
_TIMES = re.compile(r"Time \S+( \(\S+\))?")


class PilRoute:
    """The PIL route in NativeJpegLoader's place (what the CLI's u8 wire
    ran before the native loader): the threaded DataLoader, with
    CodesLoader where a table is given."""

    def __init__(self, dataset, batch_size, emit, code_lut=None):
        loader = imagenet.DataLoader(dataset, batch_size, num_workers=16)
        self.loader = loader if code_lut is None else \
            imagenet.CodesLoader(loader, code_lut)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        return iter(self.loader)


@contextlib.contextmanager
def _pil_route():
    """cli.main's u8 wire through PilRoute."""
    native = imagenet.NativeJpegLoader
    imagenet.NativeJpegLoader = PilRoute
    try:
        yield
    finally:
        imagenet.NativeJpegLoader = native


@contextlib.contextmanager
def _load_truncated():
    """PIL's ImageFile.LOAD_TRUNCATED_IMAGES set: PIL pads a truncated
    JPEG with grey instead of raising."""
    from PIL import ImageFile
    before = ImageFile.LOAD_TRUNCATED_IMAGES
    ImageFile.LOAD_TRUNCATED_IMAGES = True
    try:
        yield
    finally:
        ImageFile.LOAD_TRUNCATED_IMAGES = before


def _native_env(host_seconds):
    """The host library's build, the libjpeg it linked (and the headers it
    was compiled against), PIL's libjpeg-turbo, the CPU."""
    import PIL
    import PIL.features

    cfg = (build.HOST / "include" / "jconfig.h").read_text()
    macros = dict(re.findall(r"#define (JPEG_LIB_VERSION|LIBJPEG_TURBO_VERSION)"
                             r"\s+(\S+)", cfg))
    cpu = [ln.split(":", 1)[1].strip() for ln in
           open("/proc/cpuinfo").read().splitlines()
           if ln.startswith("model name")]
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    emit(phase="native", part="environment",
         library=os.path.relpath(build.library_path("host")),
         build_seconds=host_seconds, gxx=gxx,
         libjpeg=str(build.pil_libjpeg()),
         headers={"JPEG_LIB_VERSION": macros["JPEG_LIB_VERSION"],
                  "LIBJPEG_TURBO_VERSION": macros["LIBJPEG_TURBO_VERSION"]},
         pil=PIL.__version__,
         pil_libjpeg_turbo=PIL.features.version("libjpeg_turbo"),
         nproc=len(os.sched_getaffinity(0)), cpu_model=cpu[0] if cpu else None)


def _loader_batches(loader):
    out = list(loader)
    return np.concatenate([b[0] for b in out]), \
        np.concatenate([b[1] for b in out])


def _native_vs_pil(root, lut, pp, label, fallback_expected):
    """Every emit of NativeJpegLoader against the PIL route on the files
    of ``root`` in one batch: the share of equal elements, and the files
    that went to PIL (which must be ``fallback_expected``)."""
    for emit_kind in ("f32", "u8", "codes"):
        ds = imagenet.ImageFolder(root, imagenet.build_transform(
            mean=pp.mean, std=pp.std, crop_pct=pp.crop_pct,
            normalize=emit_kind == "f32"))
        table = lut if emit_kind == "codes" else None
        loader = imagenet.NativeJpegLoader(ds, NATIVE_BATCH, emit=emit_kind,
                                           code_lut=table)
        fell_back = []
        fallback = loader._pil_fallback
        loader._pil_fallback = lambda i: fell_back.append(
            os.path.basename(ds.samples[i][0])) or fallback(i)
        got, got_labels = _loader_batches(loader)
        want, want_labels = _loader_batches(PilRoute(ds, NATIVE_BATCH,
                                                     emit_kind, table))
        share = float(np.mean(got == want)) if got.shape == want.shape \
            else 0.0
        emit(phase="native", part="pil_equal", files=label, emit=emit_kind,
             images=len(ds), dtype=str(got.dtype), equal_share=share,
             labels_equal=bool(np.array_equal(got_labels, want_labels)),
             fell_back=sorted(fell_back))
        if share != 1.0 or not np.array_equal(got_labels, want_labels) \
                or sorted(fell_back) != fallback_expected:
            raise RuntimeError(f"native {label} {emit_kind}: {share} equal "
                               f"to PIL, fell back on {fell_back}")


def _cli_runs(argv_native, argv_pil, expected, common):
    """cli.main on the native route and on the PIL route, each with exact
    launch counts; returns their stdout, results, launches and seconds."""
    out = {}
    for route, argv in (("native", argv_native), ("pil", argv_pil)):
        buf = io.StringIO()
        ctx = _pil_route() if route == "pil" else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx, contextlib.redirect_stdout(buf):
            res, counts = drive(expected, lambda: cli.main(argv + common))
        out[route] = dict(seconds=time.perf_counter() - t0, result=res,
                          counts=counts,
                          lines=[_TIMES.sub("Time", ln) for ln in
                                 buf.getvalue().splitlines()
                                 if "Prec@1" in ln])
    return out


def phase_native(dev, host_seconds, smi):
    """The native JPEG pipeline (data/native_decode.py over the host
    library of csrc/host): its environment; NativeJpegLoader against the
    PIL route bit for bit on 64 JPEGs of 500 x 375 and on the odd files
    (a grayscale JPEG decoded natively; a CMYK JPEG, a PNG named .jpg and
    a truncated JPEG through PIL, which refuses the truncated one unless
    ImageFile.LOAD_TRUNCATED_IMAGES is set); the fast mode against the
    exact one; the ingest rate at b = 64 of three routes beside the DeiT-S
    int4 forward's; then the CLI through the native loader (DeiT-S per
    kernel and resident and Swin-T on --wire u8, DeiT-S --wire f32
    --native-preproc), each run's launches exact and its report equal to
    the PIL route's, and one b = 64 batch's codes and logits equal between
    the two loaders."""
    from diffvit_tpu_torch.data.synthetic import write_odd_images
    from diffvit_tpu_torch.models.registry import preprocessing_for

    _native_env(host_seconds)
    pp = preprocessing_for(SPEC.name)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        val = os.path.join(tmp, "val")
        make_fake_imagefolder(val, **NATIVE_FOLDER)
        odd = os.path.join(tmp, "odd")
        os.makedirs(os.path.join(odd, "class_000"))
        write_odd_images(os.path.join(odd, "class_000"), seed=2)
        many = os.path.join(tmp, "ingest")
        make_fake_imagefolder(many, **NATIVE_INGEST)
        deit = os.path.join(tmp, "deit_small_int4.npz")
        swin = os.path.join(tmp, "swin_tiny_int4.npz")
        engine.save_int_model(deit, random_int_model(SPEC, CFG, seed=0),
                              SPEC, CFG)
        engine.save_int_model(swin, random_swin_int_model(SWIN, CFG, seed=0),
                              SWIN, CFG)
        models = {"per_kernel": engine.load_int_model(deit, dev),
                  "resident": engine.load_int_model(deit, dev,
                                                    resident=True)}
        lut = models["per_kernel"].input_lut
        emit(phase="native", part="setup", seconds=time.perf_counter() - t0)

        # bit-equality with PIL, every emit
        _native_vs_pil(val, lut, pp, "jpeg64", [])
        refused = {}
        ds = imagenet.ImageFolder(odd, imagenet.build_transform(
            normalize=False))
        for route in ("native", "pil"):
            loader = imagenet.NativeJpegLoader(ds, 4, emit="u8") \
                if route == "native" else PilRoute(ds, 4, "u8")
            try:
                list(loader)
            except OSError as e:
                refused[route] = str(e)
        emit(phase="native", part="truncated_refused", refused=refused)
        if set(refused) != {"native", "pil"}:
            raise RuntimeError(f"truncated JPEG: refused by {refused}")
        with _load_truncated():
            _native_vs_pil(odd, lut, pp, "odd", ["cmyk.jpg", "png.jpg",
                                                 "truncated.jpg"])

        # the fast mode against the exact one
        paths = [p for p, _ in imagenet.ImageFolder(val, None).samples]
        exact = native_decode.decode_preprocess_batch(paths)
        fast = native_decode.decode_preprocess_batch(paths, fast=True)
        mean_abs = float(np.abs(exact - fast).mean())
        corr = float(np.corrcoef(exact.reshape(-1), fast.reshape(-1))[0, 1])
        emit(phase="native", part="fast_vs_exact", images=len(paths),
             mean_abs_diff=mean_abs, corr=corr,
             equal_share=float(np.mean(exact == fast)),
             bounds={"mean_abs_diff": FAST_BOUNDS[0], "corr": FAST_BOUNDS[1]})
        if not (mean_abs < FAST_BOUNDS[0] and corr > FAST_BOUNDS[1]):
            raise RuntimeError(f"fast mode: mean {mean_abs}, corr {corr}")

        # ingest rate at b = 64, beside the forward's
        ds = imagenet.ImageFolder(many, imagenet.build_transform(
            normalize=False))
        routes = {
            "pil_dataloader16_codesloader":
                lambda: PilRoute(ds, NATIVE_BATCH, "codes", lut),
            "native_codes": lambda: imagenet.NativeJpegLoader(
                ds, NATIVE_BATCH, emit="codes", code_lut=lut),
            "native_codes_fast": lambda: imagenet.NativeJpegLoader(
                ds, NATIVE_BATCH, emit="codes", code_lut=lut, fast=True),
        }
        rates = {}
        for name, make in routes.items():
            per_pass = []
            for _ in range(NATIVE_PASSES):
                t0 = time.perf_counter()
                n = sum(len(labels) for _, labels in make())
                per_pass.append(n / (time.perf_counter() - t0))
            rates[name] = dict(median=float(np.median(per_pass)),
                               passes=per_pass)
        codes = {}
        for name, make in (("native", routes["native_codes"]),
                           ("pil", routes["pil_dataloader16_codesloader"])):
            codes[name] = next(iter(make()))[0]
        x = torch.tensor(codes["native"], device=dev)
        forward = {name: 1e3 * NATIVE_BATCH / cuda_ms(lambda: m(x), iters=10)
                   for name, m in models.items()}
        emit(phase="native", part="ingest", batch=NATIVE_BATCH,
             images=len(ds), image_size=NATIVE_SIZE, img_per_s=rates,
             forward_img_per_s=forward, nproc=len(os.sched_getaffinity(0)),
             nvidia_smi=smi)

        # one b = 64 batch: the codes and the per-kernel logits of both
        logits = {}
        for name, batch in codes.items():
            logits[name], launches[f"native logits {name}"] = drive(
                {K1: SPEC.depth, K2: SPEC.depth},
                lambda: models["per_kernel"](torch.tensor(batch, device=dev)))
            logits[name] = logits[name].cpu().numpy()
        same = dict(codes=bool(np.array_equal(codes["native"], codes["pil"])),
                    logits=bool(np.array_equal(logits["native"],
                                               logits["pil"])))
        emit(phase="native", part="b64_batch", equal=same,
             finite=bool(np.isfinite(logits["native"]).all()))
        if not all(same.values()) or not np.isfinite(logits["native"]).all():
            raise RuntimeError(f"b=64 batch differs by loader: {same}")

        # the CLI through the native loader, each run against the PIL route
        forwards = -(-len(paths) // CLI_BATCH)
        per_kernel = {K1: SPEC.depth * forwards, K2: SPEC.depth * forwards}
        common = ["--device-prefetch", "2", "--val-batchsize", str(CLI_BATCH),
                  "--num-workers", "8"]
        u8 = [SPEC.name, tmp, "--load-int", deit, "--wire", "u8"]
        f32 = [SPEC.name, tmp, "--load-int", deit, "--wire", "f32"]
        swin_u8 = [SWIN.name, tmp, "--load-int", swin, "--wire", "u8"]
        runs = (
            ("deit_small --load-int u8", u8, u8, per_kernel),
            ("deit_small --load-int --resident u8", u8 + ["--resident"],
             u8 + ["--resident"], {K6: forwards * k6_launches(CLI_BATCH)}),
            ("swin_tiny --load-int u8", swin_u8, swin_u8,
             {K4: sum(SWIN.depths) * forwards,
              K2: sum(SWIN.depths) * forwards}),
            ("deit_small --load-int f32 --native-preproc",
             f32 + ["--native-preproc"], f32, per_kernel),
        )
        for label, argv, argv_pil, expected in runs:
            r = _cli_runs(argv, argv_pil, expected, common)
            equal = r["native"]["lines"] == r["pil"]["lines"] and \
                r["native"]["result"] == r["pil"]["result"]
            emit(phase="native", part="cli", run=label, images=len(paths),
                 seconds=r["native"]["seconds"],
                 pil_route_seconds=r["pil"]["seconds"],
                 line=r["native"]["lines"][-1:],
                 report_equal_to_pil_route=equal,
                 launches={k: v for k, v in r["native"]["counts"].items()
                           if v})
            if not equal or len(r["native"]["lines"]) < 2:
                raise RuntimeError(f"native cli {label}: report differs from "
                                   f"the PIL route's: {r['native']['lines']}"
                                   f" vs {r['pil']['lines']}")
            launches[f"native cli {label}"] = r["native"]["counts"]
    return launches

MIXED_IMAGES, MIXED_BATCH = 64, 16  # the search's seeded validation set
MIXED_FACTOR = 1.3  # at 1.1 a DeiT-S draw passes about once in 10^4
MIXED_EVO = dict(pop_size=4, evo_iter=1, mutate_size=2, crossover_size=2,
                 factor=MIXED_FACTOR)
HVP_RTOL = 1e-4  # tests/test_torch_hessian.py's tolerance


def _quiet(*_):
    pass


def _hvp_agree(card, cpu, v, where):
    """The HVP on the card against the CPU's within HVP_RTOL of max|Hv|,
    and v . Hv within HVP_RTOL of sum|v * Hv|."""
    card, cpu, v = card.double().cpu(), cpu.double(), v.double().cpu()
    rel = float((card - cpu).abs().max() / cpu.abs().max())
    vhv_rel = float(abs((card * v).sum() - (cpu * v).sum())
                    / (cpu * v).abs().sum())
    if not (rel <= HVP_RTOL and vhv_rel <= HVP_RTOL):
        raise RuntimeError(f"{where}: the card's HVP differs from the CPU's "
                           f"by {rel:.3g} (v.Hv {vhv_rel:.3g})")
    return {"max_rel": rel, "vhv_rel": vhv_rel}


def _tensor_bytes(tree, seen=None):
    """Bytes of the distinct tensors of a pytree."""
    seen = set() if seen is None else seen
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v, seen) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v, seen) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.data_ptr() not in seen:
        seen.add(tree.data_ptr())
        return tree.numel() * tree.element_size()
    return 0


def phase_mixed(dev):
    """The mixed-precision search on the card (see the module docstring,
    14).  Returns the launches by path."""
    k1, k2, k4 = "fused_qkv_attention_v2", "fused_int_mlp", \
        "fused_swin_attention"
    paths = {}
    q, calib_s = _calibrated(CFG, gaussian_calibration(50, seed=0), dev,
                             SPEC.name)
    names = hessian.hessian_target_names(SPEC)

    # the Hessian: one batch of 8, both estimators, --hessian-iter 3
    x8 = gaussian_calibration(8, seed=1)
    y8 = np.random.default_rng(8).integers(0, SPEC.num_classes, 8)
    sens, secs = {}, {}
    for est in ("per-leaf", "joint"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sens[est] = hessian.hessian_sensitivity(
            q.params, SPEC, [(x8, y8)], torch.Generator(dev).manual_seed(0),
            max_iter=3, joint=est == "joint", log=_quiet)
        torch.cuda.synchronize()
        secs[est] = time.perf_counter() - t0
        if len(sens[est]) != len(names) or not np.isfinite(sens[est]).all():
            raise RuntimeError(f"hessian {est}: bad sensitivity")
    fc1 = f"blocks.{SPEC.depth - 1}.mlp.fc1.weight"
    torch.cuda.reset_peak_memory_stats()
    g_all = hessian.BatchGrads(q.params, SPEC, x8, y8, names)
    gen = torch.Generator(dev).manual_seed(1)
    v_all = {n: hessian.rademacher(g_all.ws[n], gen) for n in names}
    block_ms = cuda_ms(lambda: g_all.hvp(fc1, v_all[fc1]), iters=5)
    head_ms = cuda_ms(lambda: g_all.hvp("head.weight", v_all["head.weight"]),
                      iters=5)
    joint_ms = cuda_ms(lambda: g_all.joint_hvp(v_all), iters=5)
    hvp_gib = torch.cuda.max_memory_allocated() / 2**30
    del g_all
    two = ["head.weight", fc1]
    g_card = hessian.BatchGrads(q.params, SPEC, x8, y8, two)
    g_cpu = hessian.BatchGrads(vit.params_from_numpy(q.params, "cpu"), SPEC,
                           x8, y8, two)
    gen = torch.Generator().manual_seed(2)
    v = {n: hessian.rademacher(g_cpu.ws[n], gen) for n in two}
    v_dev = {n: t.to(dev) for n, t in v.items()}
    held = {n: _hvp_agree(g_card.hvp(n, v_dev[n]), g_cpu.hvp(n, v[n]), v[n],
                          f"block HVP {n}") for n in two}
    joint_card, joint_cpu = g_card.joint_hvp(v_dev), g_cpu.joint_hvp(v)
    held.update({f"joint {n}": _hvp_agree(joint_card[n], joint_cpu[n], v[n],
                                          f"joint HVP {n}") for n in two})
    del g_card, g_cpu
    emit(phase="mixed", part="hessian", batch=8, hessian_iter=3,
         targets=len(names), per_leaf_seconds=secs["per-leaf"],
         joint_seconds=secs["joint"], block_hvp_ms=block_ms,
         head_hvp_ms=head_ms, joint_hvp_ms=joint_ms, hvp_peak_gib=hvp_gib,
         card_vs_cpu=held, calibration_seconds=calib_s)

    # the search on 64 seeded images (the f32 wire), both substrates
    lut = torch.tensor(normalize_lut(*q.input_norm))
    rng = np.random.default_rng(9)
    images = device_normalize(torch.tensor(rng.integers(
        0, 256, (MIXED_IMAGES, 3, 224, 224), dtype=np.uint8)),
        lut=lut).numpy()
    flops = q.flops
    t0 = time.perf_counter()
    cands = mp.sample_candidates(flops, random.Random(0),
                                 factor=MIXED_FACTOR)
    omega = mp.omega_rank(cands, flops, sens["per-leaf"], q.global_distance)
    sample_s = time.perf_counter() - t0
    # labels that the candidates can get right: the all-8 forward's
    # argmax, a third of them moved, so that top-1s spread
    labels = np.concatenate([
        q(images[i:i + MIXED_BATCH], (8,) * len(flops)).argmax(1).cpu()
        .numpy() for i in range(0, MIXED_IMAGES, MIXED_BATCH)])
    labels[::3] = (labels[::3] + 1) % SPEC.num_classes
    loader = [(images[i:i + MIXED_BATCH], labels[i:i + MIXED_BATCH])
              for i in range(0, MIXED_IMAGES, MIXED_BATCH)]
    searches = {}
    for substrate, scorer in (("fake", engine.validate_bits),
                              ("int", engine.validate_bits_int)):
        scored, seconds, held = [], [], []

        def score(configs, scorer=scorer, scored=scored, seconds=seconds,
                  held=held):
            torch.cuda.synchronize()
            t = time.perf_counter()
            top1 = scorer(q, loader, configs, log=_quiet)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t)
            scored.extend(zip(configs, top1))
            gc.collect()
            held.append(torch.cuda.memory_allocated())
            return top1

        gc.collect()  # the HVP graphs hold reference cycles
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        bake_s = None
        if substrate == "int":  # the two bakes, once
            t = time.perf_counter()
            q._int_bits = vit_int.prepare_int_bits(q.params, q.qparams,
                                                   SPEC, CFG, dev)
            torch.cuda.synchronize()
            bake_s = time.perf_counter() - t
        result, counts = _counted(lambda: mp.evolutionary_search(
            omega, flops, None, rng=random.Random(1), log=_quiet,
            evaluate_batch=score, **MIXED_EVO))
        forwards = len(scored) * len(loader)
        per_forward = {k1: SPEC.depth, k2: SPEC.depth} \
            if substrate == "int" else {}
        _exact(counts, {k: n * forwards for k, n in per_forward.items()},
               f"mixed search {substrate}")
        paths[f"{SPEC.name} mixed search {substrate}"] = counts
        held_gib = [(m - mem0) / 2**30 for m in held]
        record = dict(phase="mixed", part="search", substrate=substrate,
                      candidates=len(scored), images=MIXED_IMAGES,
                      generations=len(seconds), seconds=sum(seconds),
                      seconds_per_candidate=sum(seconds) / len(scored),
                      bake_seconds=bake_s, best=result[0],
                      top1=[t for _, t in scored],
                      held_gib_by_generation=held_gib,
                      peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                      launches={k: n for k, n in counts.items() if n})
        if substrate == "int":
            bake_gib = _tensor_bytes(q._int_bits["b8"]) / 2**30
            record.update(one_bake_gib=bake_gib)
            # two bakes and their K-major weight copies, not one a candidate
            if max(held_gib) > 5 * bake_gib:
                raise RuntimeError(f"the integer search holds "
                                   f"{max(held_gib):.3f} GiB, one bake is "
                                   f"{bake_gib:.3f}")
        emit(**record)
        searches[substrate] = (result, scored)
    emit(phase="mixed", part="sample", candidates=len(cands),
         omega_best=omega[0], seconds=sample_s,
         fake_int_same_best=searches["fake"][0][0] == searches["int"][0][0])

    # each integer candidate against its own bake (what validate(use_int=
    # True) serves), batch by batch: the logits bit for bit, and the top-1
    # by validate_bits' argmax.  validate's Prec@1 ranks by the reference's
    # np.argsort, which orders tied maxima otherwise: printed beside, with
    # the rows whose top logit ties
    result, scored = searches["int"]
    t0 = time.perf_counter()
    logits_equal, per_config, prec1, tied = True, [], [], 0
    for c, _ in scored:
        bake = q.prepare_int(c)
        correct = 0
        for xb, yb in loader:
            want = bake(xb)
            logits_equal &= bool(torch.equal(q.forward_bits_int(xb, c),
                                             want))
            w = want.cpu().numpy()
            correct += int((w.argmax(1) == yb).sum())
            tied += int(((w == w.max(1, keepdims=True)).sum(1) > 1).sum())
        per_config.append(100.0 * correct / MIXED_IMAGES)
        prec1.append(engine.validate(q, loader, c, print_freq=0, log=_quiet,
                                     use_int=True)[1])
    top1_equal = [abs(a - b) < 1e-9 for (_, a), b in zip(scored, per_config)]
    emit(phase="mixed", part="validate_bits_int_vs_own_bake",
         candidates=len(scored), logits_equal=logits_equal,
         top1_equal=all(top1_equal), top1=[s for _, s in scored],
         validate_prec1=prec1, tied_top_rows=tied,
         seconds=time.perf_counter() - t0,
         cached_int_models=len(q._int_models))
    if not (logits_equal and all(top1_equal)) or len(q._int_models) > 2:
        raise RuntimeError(f"validate_bits_int differs from the candidates' "
                           f"own bakes (logits equal: {logits_equal}, top-1 "
                           f"{[s for _, s in scored]} against {per_config}) "
                           f"or the int-model cache grew past two")
    best = result[0][0]
    xf = torch.tensor(images[:8], device=dev)
    bits_equal = {}
    for label, bits in (("best", best), ("omega_first", omega[0][0])):
        got, counts = _counted(lambda: q.forward_bits_int(xf, bits))
        _exact(counts, {k1: SPEC.depth, k2: SPEC.depth},
               f"forward_bits_int {label}")
        bits_equal[label] = bool(torch.equal(got, q.prepare_int(bits)(xf)))
    forward_ms = cuda_ms(lambda: q.forward_bits_int(xf, best), iters=5)
    emit(phase="mixed", part="forward_bits_int", batch=8,
         logits_equal_prepare_int=bits_equal, forward_ms=forward_ms)
    if not all(bits_equal.values()):
        raise RuntimeError(f"forward_bits_int differs from prepare_int: "
                           f"{bits_equal}")

    # the best configuration baked, saved, loaded and served
    x = np.random.default_rng(10).integers(0, 256, (8, 3, 224, 224),
                                           dtype=np.uint8)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "best.npz")
        q.save_int_model(path, best)
        served = engine.load_int_model(path, dev)
    got, paths[f"{SPEC.name} mixed bake"] = drive(
        {k1: SPEC.depth, k2: SPEC.depth}, lambda: served(x))
    bake_equal = bool(torch.equal(got, q.prepare_int(best)(x)))
    emit(phase="mixed", part="bake", bits=best, batch=8,
         logits_equal_prepare_int=bake_equal,
         finite=bool(torch.isfinite(got).all()))
    if not bake_equal or not torch.isfinite(got).all():
        raise RuntimeError("the searched bake's logits differ from "
                           "prepare_int(best)'s")
    del q, served

    # Swin-T: one mixed forward_q_bits, card against the CPU; its bake
    qs, _ = _calibrated(CFG, gaussian_calibration(8, seed=0), dev, SWIN.name)
    bits = next(c for c in mp.sample_candidates(
        swin.flops_list(SWIN), random.Random(0), factor=MIXED_FACTOR,
        groups=bit_slot_groups(SWIN)) if len(set(c)) == 2)
    xs = np.random.default_rng(11).integers(0, 256, (8, 3, 224, 224),
                                            dtype=np.uint8)
    xsf = device_normalize(torch.tensor(xs), lut=lut)
    with torch.inference_mode():
        card = swin.forward_q_bits(qs.params, qs.qparams, SWIN, CFG,
                                   xsf.to(dev), bits).cpu().numpy()
        cpu = swin.forward_q_bits(
            vit.params_from_numpy(qs.params, "cpu"),
            {k: t.cpu() for k, t in qs.qparams.items()}, SWIN, CFG, xsf,
            bits).numpy()
    agree(card, cpu, (8, SWIN.num_classes), phase="mixed",
          part="swin_forward_q_bits_card_vs_cpu", batch=8, bits=list(bits))
    model = qs.prepare_int(bits)
    model(xs[:1])  # warm-up: K-major weight copies
    got, paths[f"{SWIN.name} mixed bake"] = drive(
        {k4: sum(SWIN.depths), k2: sum(SWIN.depths)}, lambda: model(xs))
    emit(phase="mixed", part="swin_bake", batch=8,
         finite=bool(torch.isfinite(got).all()),
         argmax_equal_forward_q_bits=float(np.mean(
             got.cpu().numpy().argmax(1) == card.argmax(1))))
    if not torch.isfinite(got).all():
        raise RuntimeError("the Swin-T mixed bake's logits are not finite")
    del qs, model

    # the CLI: --mixed --search-path int --save-int on a fake ImageFolder
    with tempfile.TemporaryDirectory() as tmp:
        make_fake_imagefolder(os.path.join(tmp, "val"), **CLI_FOLDER)
        make_fake_imagefolder(os.path.join(tmp, "train"), num_classes=2,
                              per_class=4, size=(96, 80), seed=1)
        art = os.path.join(tmp, "mixed_best.npz")
        argv = [SPEC.name, tmp, "--quant", "--mode", "1", "--mixed",
                "--search-path", "int", "--save-int", art,
                "--calib-batchsize", "8", "--hessian-batches", "1",
                "--hessian-iter", "3", "--evo-pop", "4", "--evo-iter", "1",
                "--evo-mutate", "2", "--evo-crossover", "2",
                "--pareto-top", "2", "--size-factor", str(MIXED_FACTOR),
                "--val-batchsize", str(CLI_BATCH), "--num-workers", "8",
                "--print-freq", "0", "--device", dev.type]
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result, counts = _counted(lambda: cli.main(argv))
        seconds = time.perf_counter() - t0
        lines = out.getvalue().splitlines()
        scored = [re.match(r"validate_bits_int: (\d+) configs x (\d+) "
                           r"images", ln) for ln in lines]
        forwards = sum(int(m[1]) * -(-int(m[2]) // CLI_BATCH)
                       for m in scored if m)
        _exact(counts, {k1: SPEC.depth * forwards, k2: SPEC.depth * forwards},
               "cli --mixed")
        paths["cli --mixed --search-path int"] = counts
        best_line = [ln for ln in lines if ln.startswith("best:")]
        served = engine.load_int_model(art, dev)
        got, counts_art = drive({k1: SPEC.depth, k2: SPEC.depth},
                                lambda: served(x))
    emit(phase="mixed", part="cli", seconds=seconds, line=best_line,
         candidate_forwards=forwards, launches={k: n for k, n in
                                                counts.items() if n},
         artifact_finite=bool(torch.isfinite(got).all()))
    if len(best_line) != 1 or forwards == 0 \
            or not torch.isfinite(got).all():
        raise RuntimeError(f"cli --mixed: best line {best_line}, "
                           f"{forwards} candidate forwards")
    paths["cli --mixed artifact"] = counts_art
    return paths


RECOVERY_STEPS = 100  # AdaRound steps a site in the phase (the CLI's: 1000)
RECOVERY_QAT = 3  # QAT steps at b = 50 (the CLI's lr, 1e-5)


def _site_codes(q, sites):
    """For each weight site of ``q`` (``adaround._vit_sites`` /
    ``_swin_sites`` order): the codes its fake-quant forward rounds the
    weight to (clamp(round(w_s / s)), w_s the SmoothQuant-scaled weight),
    and whether w_s / s is integral (the weight is on its grid)."""
    qp, out = q.qparams, {}
    for site in sites:
        name, ppath, spre, bit = site[0], site[1], site[2], site[-1]
        smooth = len(site) == 5 and site[3]  # qkv, fc1: a qact0 and .w.
        bt = BIT_TYPE_DICT[f"int{bit}"]
        w = adaround._get(q.params, ppath)
        if smooth and q.cfg.smoothquant:
            idx = q.cfg.bit_pool.index(bit)
            ws = w * qp[f"{spre}.sq.channel_scale"][idx]
            s = qp[f"{spre}.w.{bt.name}.scale"][idx]
        else:
            ws = w
            s = qp[f"{spre}.w.{bt.name}.scale" if smooth
                   else f"{spre}.{bt.name}.scale"]
        r = ws / (s[:, None] if s.dim() == 1 else s)
        out[name] = (torch.clamp(torch.round(r), bt.lower_bound,
                                 bt.upper_bound), bool(
            torch.equal(r, torch.round(r))))
    return out


def _served_codes(ip, sites):
    """Each site's (Cout, K) int8 weight codes as the bake ``ip`` (numpy or
    the served model's tensors) holds them (transposed (K, Cout))."""
    out = {}
    for site in sites:
        path = site[1][:-1]
        path = ("patch",) if path[0] == "patch_embed" else path
        w = adaround._get(ip, path)["w_int"]
        out[site[0]] = torch.as_tensor(np.asarray(w.cpu() if isinstance(
            w, torch.Tensor) else w)).to(torch.float32).T
    return out


def _codes_held(q, ip, sites, where):
    """Fails unless the bake ``ip`` holds, at every site, the codes of
    ``q``'s params; returns (sites, weights)."""
    want, got = _site_codes(q, sites), _served_codes(ip, sites)
    bad = [n for n in want if not torch.equal(got[n], want[n][0].cpu())]
    if bad:
        raise RuntimeError(f"{where}: the bake's codes differ from the "
                           f"params' at {bad}")
    return len(want), sum(int(c.numel()) for c, _ in want.values())


def phase_recovery(dev):
    """The recovery passes on the card (see the module docstring, 15).
    Returns the launches by path."""
    paths = {}
    rng = np.random.default_rng(12)
    px = rng.integers(0, 256, (8, 3, 224, 224), dtype=np.uint8)
    bits = (CFG.bit_w.bits,) * vit.num_bit_slots(SPEC)
    vit_sites = adaround._vit_sites(SPEC, bits)

    # DeiT-S at full width and depth, the CLI's Gaussian batch of 50
    x50 = gaussian_calibration(50, seed=0)
    q, calib_s = _calibrated(CFG, x50, dev)
    # one site at the CLI's 1000 steps: block 11's fc1
    name = f"blocks.{SPEC.depth - 1}.mlp.fc1"
    site = next(s for s in vit_sites if s[0] == name)
    xd = q._prep(x50)
    qp = vit.autograd_safe(q.qparams)
    y_q = adaround._site_input(lambda t: vit.forward_q(
        q.params, qp, SPEC, CFG, xd, bits, w_in_taps=t), name)
    y_f = adaround._site_input(lambda t: vit.forward_fp(
        q.params, SPEC, xd, w_in_taps=t), name)
    ch = qp[f"{name}.sq.channel_scale"][0]
    xq = fake_quant(y_q / ch, qp[f"{name}.qact0.scale"][0],
                    qp[f"{name}.qact0.zp"][0], CFG.bit_a)
    w = adaround._get(q.params, site[1]) * ch
    site_s = {}
    for steps in (1000, 100):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m0, m1 = adaround._reconstruct(
            xq, y_f / ch, w, qp[f"{name}.w.int4.scale"][0],
            BIT_TYPE_DICT["int4"], np.random.default_rng(0), 2048, steps,
            1e-2, 0.01, (20.0, 2.0), int(round(steps * 0.2)))
        torch.cuda.synchronize()
        site_s[steps] = time.perf_counter() - t0
    emit(phase="recovery", part="adaround_site", site=name, rows=2048,
         seconds_1000_steps=site_s[1000], seconds_100_steps=site_s[100],
         mse_nearest=float(m0), mse_learned=float(m1))
    del y_q, y_f, xq, xd

    secs, peaks, one_step = {}, {}, {}
    for pass_, kw in (("adaround", dict(steps=RECOVERY_STEPS)),
                      ("qat", dict(steps=RECOVERY_QAT)),
                      ("qat_one_step", dict(steps=1)),
                      ("qat_one_step_remat", dict(steps=1, remat=True)),
                      ("bias_correct", {})):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if pass_.startswith("qat_one"):  # one step, q.params kept
            out = qat.qat_distill(q.params, q.qparams, SPEC, CFG,
                                  [q._prep(x50)], bits, fp_params=q.fp_params,
                                  **kw)[1]
        else:
            out = getattr(q, pass_)(x50, **kw)
        torch.cuda.synchronize()
        secs[pass_] = time.perf_counter() - t0
        peaks[pass_] = torch.cuda.max_memory_allocated() / 2**30
        if pass_ == "adaround":
            report = out
            on_grid = all(g for _, g in _site_codes(q, vit_sites).values())
            n_sites, n_weights = _codes_held(
                q, vit_int.prepare_int(q.params, q.qparams, SPEC, CFG),
                vit_sites, "after AdaRound")
        elif pass_.startswith("qat_one"):
            one_step[pass_] = out[0]
        elif pass_ == "qat":
            losses = out
        else:
            bias_report = out
    improved = sum(a <= b * 1.001 for b, a in report.values())
    emit(phase="recovery", part="deit_small", batch=50,
         calibration_seconds=calib_s, seconds=secs, peak_gib=peaks,
         adaround_steps=RECOVERY_STEPS, sites=len(report),
         sites_improved=improved, learned_on_grid=on_grid,
         bake_codes_equal_learned=dict(sites=n_sites, weights=n_weights),
         mse_reduction=float(np.mean([1 - a / b for b, a in report.values()
                                      if b > 0])),
         qat_losses=losses, qat_seconds_per_step=secs["qat"] / RECOVERY_QAT,
         qat_remat_loss_equal=one_step["qat_one_step_remat"]
         == one_step["qat_one_step"],
         bias_shift=[float(np.mean([b for b, _ in bias_report.values()])),
                     float(np.mean([a for _, a in bias_report.values()]))])
    if improved != len(report) or not on_grid \
            or not np.isfinite(losses).all() \
            or one_step["qat_one_step_remat"] != one_step["qat_one_step"]:
        raise RuntimeError(f"AdaRound: {improved} of {len(report)} sites "
                           f"improved, on grid {on_grid}; QAT {losses}")

    # the recovered bake: per kernel, resident, saved and loaded
    model = q.prepare_int()
    model(px[:1])  # warm-up: K-major weight copies
    got, paths[f"{SPEC.name} recovery"] = drive(
        {K1: SPEC.depth, K2: SPEC.depth}, lambda: model(px))
    served = _codes_held(q, model.ip, vit_sites, "served")
    resident = q.prepare_int(resident=True)
    res, paths[f"{SPEC.name} recovery resident"] = drive(
        {K6: 1}, lambda: resident(px))
    with tempfile.TemporaryDirectory() as d:
        art = os.path.join(d, "recovered.npz")
        q.save_int_model(art)
        loaded = engine.load_int_model(art, dev)
    got_art, paths[f"{SPEC.name} recovery artifact"] = drive(
        {K1: SPEC.depth, K2: SPEC.depth}, lambda: loaded(px))
    fresh = engine.IntModel(vit_int.prepare_int(q.params, q.qparams, SPEC,
                                                CFG), SPEC, CFG, dev)(px)
    equal = dict(resident=bool(torch.equal(res, got)),
                 artifact=bool(torch.equal(got_art, got)),
                 fresh_bake=bool(torch.equal(fresh, got)))
    emit(phase="recovery", part="deit_small_serve", batch=8,
         served_codes_equal_learned=dict(zip(("sites", "weights"), served)),
         logits_equal=equal, finite=bool(torch.isfinite(got).all()))
    if not all(equal.values()) or not torch.isfinite(got).all():
        raise RuntimeError(f"the recovered DeiT-S bake: {equal}")
    del q, model, resident, loaded

    # Swin-T at full width and depth, calibrated on 8 images
    x8 = gaussian_calibration(8, seed=0)
    qs, calib_s = _calibrated(CFG, x8, dev, SWIN.name)
    swin_sites = adaround._swin_sites(SWIN, (CFG.bit_w.bits,) *
                                      num_bit_slots(SWIN))
    secs = {}
    for pass_, kw in (("adaround", dict(steps=RECOVERY_STEPS // 2)),
                      ("bias_correct", {})):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = getattr(qs, pass_)(x8, **kw)
        torch.cuda.synchronize()
        secs[pass_] = (time.perf_counter() - t0,
                       torch.cuda.max_memory_allocated() / 2**30)
        if pass_ == "adaround":
            report = out
    model = qs.prepare_int()
    model(px[:1])
    got, paths[f"{SWIN.name} recovery"] = drive(
        {K4: sum(SWIN.depths), K2: sum(SWIN.depths)}, lambda: model(px))
    served = _codes_held(qs, model.ip, swin_sites, "served Swin-T")
    improved = sum(a <= b * 1.001 for b, a in report.values())
    emit(phase="recovery", part="swin_tiny", batch=8,
         calibration_seconds=calib_s,
         seconds_and_peak_gib=secs, sites=len(report),
         sites_improved=improved,
         served_codes_equal_learned=dict(zip(("sites", "weights"), served)),
         finite=bool(torch.isfinite(got).all()))
    if improved != len(report) or not torch.isfinite(got).all():
        raise RuntimeError(f"Swin-T AdaRound: {improved} of {len(report)} "
                           "sites improved, or logits not finite")
    del qs, model

    # the card against the CPU at DeiT-S width, depth 2, 4 images: the
    # passes from the same params on both (AdaRound's codes, QAT's losses;
    # bias correction and the bake from the CPU's QAT params, because
    # Adam moves a weight by about lr whatever its gradient's size, so a
    # last-bit difference of a float64 backward can flip a code)
    spec = dataclasses.replace(SPEC, depth=2)
    sites = adaround._vit_sites(spec, (CFG.bit_w.bits,) *
                                vit.num_bit_slots(spec))
    params = vit.init_params(spec, torch.Generator().manual_seed(0), "cpu")
    x4 = gaussian_calibration(4, seed=1)
    runs = []
    t0 = time.perf_counter()
    for d in (dev, torch.device("cpu")):
        qd = engine.QuantizedViT(spec, CFG, params=params, device=d)
        qd.calibrate(x4)
        qd.adaround(x4, steps=20, max_rows=512)
        codes = {n: c.cpu() for n, (c, _) in _site_codes(qd, sites).items()}
        runs.append((qd, codes, qd.qat(x4, steps=3)))
    card, cpu = runs[0][0], runs[1][0]
    card.params = vit.params_from_numpy(cpu.params, dev)
    for qd in (card, cpu):
        qd.bias_correct(x4)
    cpu_s = time.perf_counter() - t0
    (_, c_card, l_card), (_, c_cpu, l_cpu) = runs
    equal = sum(int((c_card[n] == c_cpu[n]).sum()) for n in c_cpu)
    total = sum(c.numel() for c in c_cpu.values())
    bias_diff = max(float((adaround._get(card.params, p).cpu()
                           - adaround._get(cpu.params, p)).abs().max())
                    for p in [("head", "b")] + [
                        ("blocks", i, k, "b") for i in range(spec.depth)
                        for k in ("qkv", "proj", "fc1", "fc2")])
    loss_rel = np.abs(np.array(l_card) / np.array(l_cpu) - 1)
    emit(phase="recovery", part="card_vs_cpu", depth=spec.depth, images=4,
         codes_equal_share=equal / total, weights=total,
         qat_losses_card=l_card, qat_losses_cpu=l_cpu,
         qat_loss_rel_diff=loss_rel.tolist(),
         bias_max_abs_diff=bias_diff, seconds=cpu_s)
    agree(card.prepare_int()(px).cpu().numpy(),
          cpu.prepare_int()(px).numpy(), (8, spec.num_classes),
          phase="recovery", part="card_vs_cpu_logits", batch=8)
    if equal / total < 0.999 or loss_rel[0] > 1e-6 or bias_diff > 1e-6:
        raise RuntimeError(f"card vs CPU: {equal / total} of codes equal, "
                           f"first QAT loss {loss_rel[0]} apart, biases "
                           f"{bias_diff} apart")
    del card, cpu, runs

    # the CLI: the three passes, the integer path and --save-int
    with tempfile.TemporaryDirectory() as tmp:
        make_fake_imagefolder(os.path.join(tmp, "val"), **CLI_FOLDER)
        art = os.path.join(tmp, "recovered.npz")
        images = CLI_FOLDER["num_classes"] * CLI_FOLDER["per_class"]
        forwards = -(-images // CLI_BATCH)
        argv = [SPEC.name, tmp, "--quant", "--mode", "1", "--adaround",
                "--adaround-steps", "20", "--qat-steps", "5", "--bias-corr",
                "--int-path", "--save-int", art, "--calib-batchsize", "16",
                "--val-batchsize", str(CLI_BATCH), "--num-workers", "8",
                "--wire", "u8", "--device", dev.type]
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            (loss, top1, _), counts = drive(
                {K1: SPEC.depth * forwards, K2: SPEC.depth * forwards},
                lambda: cli.main(argv))
        seconds = time.perf_counter() - t0
        lines = [ln for ln in out.getvalue().splitlines()
                 if ln.startswith(("AdaRound", "Distillation", "QAT",
                                   "Bias correction", " * Prec@1",
                                   "Saved"))]
        served = engine.load_int_model(art, dev)
        got_art, counts_art = drive({K1: SPEC.depth, K2: SPEC.depth},
                                    lambda: served(px))
    emit(phase="recovery", part="cli", seconds=seconds, lines=lines,
         loss=loss, prec1=top1,
         artifact_finite=bool(torch.isfinite(got_art).all()))
    if len(lines) != 8 or not np.isfinite(loss):
        raise RuntimeError(f"cli recovery: report {lines}")
    paths["cli recovery"] = counts
    paths["cli recovery artifact"] = counts_art
    return paths


ANALYSIS_ITERS = 3  # generate_data iterations an epoch in the phase (CLI: 500)
ANALYSIS_CLI_BATCH = 2  # --calib-batchsize of the --mode 2 CLI run
ANALYSIS_PGD = 10  # PGD steps of the adversarial CKA (the reference's: 50)
ANALYSIS_CKA_BATCH = 32  # images a CKA batch


def _generated(name, batch, dev):
    """engine.QuantizedViT of ``name`` (params at seed 0) on ``dev``, the
    PSAQ batch generated from it at seed 0 (two epochs of ANALYSIS_ITERS,
    after a one-step warm-up run), the seconds a step and the peak GiB.
    Fails unless the batch has its shape and lies within the clip."""
    q = engine.QuantizedViT(name, CFG, seed=0, device=dev)
    kw = dict(batch_size=batch, seed=0)
    datagen.generate_data(q.params, q.spec, iters_per_epoch=1, epochs=1,
                          **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    imgs = datagen.generate_data(q.params, q.spec,
                                 iters_per_epoch=ANALYSIS_ITERS, **kw)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (2 * ANALYSIS_ITERS)
    lo, hi = datagen._clip_bounds(dev)
    size = q.spec.img_size
    if imgs.shape != (batch, 3, size, size) \
            or not bool(((imgs >= lo) & (imgs <= hi)).all()):
        raise RuntimeError(f"{name}: generated batch {tuple(imgs.shape)} "
                           "off its shape or its clip")
    return q, imgs, step_s, torch.cuda.max_memory_allocated() / 2**30


def _held_calls(summary, run, module, names, **where):
    """Every call ``run()`` makes to the kernels ``names`` of ``module``,
    held bit for bit against its plain version; returns their number."""
    calls = kernel_calls(run, module, names)
    for i, (name, args, kw) in enumerate(calls):
        note(summary, name, hold(name, args, kw, "bitwise", iters=5, call=i,
                                 **where))
    return len(calls)


def _timed(fn):
    """fn() and its wall seconds, the card synchronized at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _cka_card_vs_cpu(dev, tmp):
    """DeiT-S width, depth 2, on both devices from the same params and
    draws: the first PSAQ loss, the images after two steps, the internal
    CKA heatmap of 8 images and 3 PGD steps on 4."""
    spec = dataclasses.replace(SPEC, depth=2)
    params = vit.init_params(spec, torch.Generator().manual_seed(0), "cpu")
    img, pred, var = datagen._draws(spec, 4, seed=0)
    rng = np.random.default_rng(15)
    x8 = rng.standard_normal((8, 3, 224, 224)).astype(np.float32)
    y4 = rng.integers(0, spec.num_classes, 4)
    runs = []
    for d in (dev, torch.device("cpu")):
        p = vit.params_from_numpy(params, d)
        loss = float(datagen.psaq_loss(p, spec, img.to(d), pred.to(d), var,
                                       4))
        two = datagen.generate_data(p, spec, batch_size=4, seed=0,
                                    iters_per_epoch=2, epochs=1).cpu()
        fp = engine.QuantizedViT(spec, CFG, params=params, device=d)
        heat = cka_drivers.compute_cka_internal(
            fp, lambda: iter([(x8, None)]), cka_iter=1, cka_batch_iter=0,
            result_name=os.path.join(tmp, f"card_vs_cpu_{len(runs)}"),
            log=_quiet)
        adv = pgd.AttackPGD(fp, num_steps=3, quant=False).gen_adv_inputs(
            x8[:4], y4, generator=torch.Generator().manual_seed(0)).cpu()
        runs.append((loss, two, heat, adv))
    (l_card, two_card, h_card, a_card), (l_cpu, two_cpu, h_cpu, a_cpu) = runs
    d = (two_card - two_cpu).abs()
    out = dict(first_loss_card=l_card, first_loss_cpu=l_cpu,
               first_loss_rel_diff=abs(l_card / l_cpu - 1),
               pixels_equal_after_two_steps=float((d == 0).float().mean()),
               pixels_apart_1e3=float((d > 1e-3).float().mean()),
               pixels_max_abs_diff=float(d.max()),
               heatmap_max_abs_diff=float(np.nanmax(np.abs(h_card - h_cpu))),
               heatmap_nan_equal=bool(np.array_equal(np.isnan(h_card),
                                                     np.isnan(h_cpu))),
               pgd_equal_share=float((a_card == a_cpu).float().mean()))
    emit(phase="analysis", part="card_vs_cpu", depth=2, **out)
    # measured 100% of the pixels bit-equal; a few sign flips of Adam's
    # first step (lr * sign(g)) may part some, a fault confined to one
    # row of one channel (224 pixels) may not
    if out["first_loss_rel_diff"] > 1e-6 \
            or out["pixels_equal_after_two_steps"] < 0.999 \
            or out["pixels_apart_1e3"] > 1e-4 \
            or out["heatmap_max_abs_diff"] > 1e-5 \
            or not out["heatmap_nan_equal"] or out["pgd_equal_share"] < 0.99:
        raise RuntimeError(f"analysis card vs CPU: {out}")


def phase_analysis(dev, summary):
    """PSAQ data generation, CKA and PGD on the card (see the module
    docstring, 16).  Returns the launches by path."""
    paths = {}
    px = np.random.default_rng(13).integers(0, 256, (8, 3, 224, 224),
                                            dtype=np.uint8)

    # DeiT-S: generate 50 images, calibrate, bake, serve (K1 + K2 and K6)
    q, imgs, step_s, peak = _generated(SPEC.name, 50, dev)
    _, calib_s = _timed(lambda: q.calibrate(imgs))
    model = q.prepare_int()
    model(px[:1])  # warm-up: K-major weight copies
    got, paths[f"{SPEC.name} generated"] = drive(
        {K1: SPEC.depth, K2: SPEC.depth}, lambda: model(px))
    resident = q.prepare_int(resident=True)
    resident(px[:1])
    res, paths[f"{SPEC.name} generated resident"] = drive(
        {K6: 1}, lambda: resident(px))
    xc = torch.tensor(model.encode(px), device=dev)
    where = dict(model=f"{SPEC.name} generated", batch=8)
    held = _held_calls(summary, lambda: model(xc), vit_int, (K1, K2),
                       route="K1+K2", **where)
    held += _held_calls(summary, lambda: resident(xc), vit_int, (K6,),
                        route="K6", **where)
    equal = bool(torch.equal(res, got))
    finite = bool(torch.isfinite(got).all())
    emit(phase="analysis", part="deit_small", batch=50,
         iters_per_epoch=ANALYSIS_ITERS, epochs=2, seconds_per_step=step_s,
         peak_gib=peak, calibration_seconds=calib_s,
         kernel_calls_held=held, resident_logits_equal=equal, finite=finite)
    if not (equal and finite and held == 2 * SPEC.depth + 1):
        raise RuntimeError(f"the generated-data DeiT-S bake: K6 equal "
                           f"{equal}, finite {finite}, {held} calls held")

    # Swin-T: generate 8 images, calibrate, bake, serve (K4 + K2)
    qs, imgs_s, step_s, peak = _generated(SWIN.name, 8, dev)
    _, calib_s = _timed(lambda: qs.calibrate(imgs_s))
    model_s = qs.prepare_int()
    model_s(px[:1])
    depth = sum(SWIN.depths)
    got_s, paths[f"{SWIN.name} generated"] = drive(
        {K4: depth, K2: depth}, lambda: model_s(px))
    xs = torch.tensor(model_s.encode(px), device=dev)
    held = _held_calls(summary, lambda: model_s(xs), swin_int, (K4, K2),
                       model=f"{SWIN.name} generated", batch=8)
    finite = bool(torch.isfinite(got_s).all())
    emit(phase="analysis", part="swin_tiny", batch=8,
         iters_per_epoch=ANALYSIS_ITERS, epochs=2, seconds_per_step=step_s,
         peak_gib=peak, calibration_seconds=calib_s,
         kernel_calls_held=held, finite=finite)
    if not (finite and held == 2 * depth):
        raise RuntimeError(f"the generated-data Swin-T bake: finite "
                           f"{finite}, {held} calls held")
    del qs, model_s, imgs_s

    # the CLI: --mode 2 (1,000 Adam steps) --int-path --save-int
    with tempfile.TemporaryDirectory() as tmp:
        make_fake_imagefolder(os.path.join(tmp, "val"), **CLI_FOLDER)
        art = os.path.join(tmp, "psaq.npz")
        forwards = -(-CLI_FOLDER["num_classes"] * CLI_FOLDER["per_class"]
                     // CLI_BATCH)
        argv = [SPEC.name, tmp, "--quant", "--mode", "2", "--int-path",
                "--save-int", art, "--calib-batchsize",
                str(ANALYSIS_CLI_BATCH), "--val-batchsize", str(CLI_BATCH),
                "--num-workers", "8", "--wire", "u8", "--device", dev.type]
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            (loss, top1, _), counts = drive(
                {K1: SPEC.depth * forwards, K2: SPEC.depth * forwards},
                lambda: cli.main(argv))
        seconds = time.perf_counter() - t0
        lines = [ln for ln in out.getvalue().splitlines()
                 if ln.startswith(("Generating", "Calibrating with",
                                   " * Prec@1", "Saved"))]
        served = engine.load_int_model(art, dev)
        got_art, counts_art = drive({K1: SPEC.depth, K2: SPEC.depth},
                                    lambda: served(px))
    emit(phase="analysis", part="cli", seconds=seconds, lines=lines,
         calib_batchsize=ANALYSIS_CLI_BATCH, loss=loss, prec1=top1,
         artifact_finite=bool(torch.isfinite(got_art).all()))
    if len(lines) != 4 or not np.isfinite(loss):
        raise RuntimeError(f"cli --mode 2: report {lines}")
    paths["cli mode 2"] = counts
    paths["cli mode 2 artifact"] = counts_art

    # CKA at DeiT-S: the float model alone, and against the generated bake
    rng = np.random.default_rng(14)
    batches = [(rng.standard_normal((ANALYSIS_CKA_BATCH, 3, 224, 224))
                .astype(np.float32), rng.integers(0, 1000, ANALYSIS_CKA_BATCH))
               for _ in range(2)]
    fp = engine.QuantizedViT(SPEC.name, CFG, seed=0, device=dev)
    bits = (CFG.bit_w.bits,) * vit.num_bit_slots(SPEC)
    with tempfile.TemporaryDirectory() as tmp:
        heat, internal_s = _timed(lambda: cka_drivers.compute_cka_internal(
            fp, lambda: iter(batches), cka_iter=1, cka_batch_iter=1,
            result_name=os.path.join(tmp, "internal"), log=_quiet))
        adv, adv_s = _timed(lambda: cka_drivers.compute_cka_with_adversarial(
            fp, q, lambda: iter(batches), model2_bit_config=bits,
            cka_iter=1, cka_batch_iter=1, pgd_steps=ANALYSIS_PGD,
            result_name=os.path.join(tmp, "adv"), log=_quiet))
        pickles = [os.path.exists(os.path.join(tmp, f))
                   for f in ("internal/_heatmap.pkl", "adv/adv_heatmap.pkl")]
        diag = np.diag(heat)
        emit(phase="analysis", part="cka", batch=ANALYSIS_CKA_BATCH,
             batches=len(batches), internal_seconds=internal_s,
             internal_shape=list(heat.shape),
             internal_diag_max_err=float(np.nanmax(np.abs(diag - 1))),
             adversarial_seconds=adv_s, pgd_steps=ANALYSIS_PGD,
             adversarial_shape=list(adv.shape),
             adversarial_finite_share=float(np.isfinite(adv).mean()),
             pickles=pickles)
        if heat.shape != (6 * SPEC.depth + 2,) * 2 \
                or adv.shape != (6 * SPEC.depth + 2, 4 * SPEC.depth + 2) \
                or not all(pickles) or np.nanmax(np.abs(diag - 1)) > 1e-5:
            raise RuntimeError("the CKA drivers' heatmaps or pickles")
        _cka_card_vs_cpu(dev, tmp)
    return paths


DIFF_PGD = 50  # PGD steps of the DDV-Hessian inputs (the reference driver's)
DIFF_LAYER = 30  # the reference driver's tap: blocks.4.mlp.fc2 at DeiT-S
DIFF_BLACKBOX = 20  # blackbox ModelDiff iterations in the phase
DIFF_RTOL = 1e-6  # card vs CPU: traces and eigenvalues


@contextlib.contextmanager
def _hvp_count():
    """Counts the joint HVPs (``BatchGrads.joint_hvp``) taken inside."""
    count = [0]
    joint = hessian.BatchGrads.joint_hvp

    def counted(self, vs):
        count[0] += 1
        return joint(self, vs)

    hessian.BatchGrads.joint_hvp = counted
    try:
        yield count
    finally:
        hessian.BatchGrads.joint_hvp = joint


def _cpu_draws(kind):
    """Start vectors or probes drawn on the CPU (one generator a draw,
    seeded by the draw's key) and moved to the tensor's device: the same
    values on the card and on the CPU."""
    table = {}

    def draw(*key):
        *key, like = key
        key = tuple(key)
        if key not in table:
            g = torch.Generator().manual_seed(len(table))
            table[key] = hessian.rademacher(like.cpu(), g) \
                if kind == "rademacher" else torch.randn(like.shape,
                                                         generator=g)
        return table[key].to(like.device)
    return draw


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def _diff_card_vs_cpu(dev, root):
    """DeiT-S width, depth 2, on both devices from the same params and
    draws: the DDV-Hessian traces (tap 10, its 7 weights), the top two
    eigenvalues, the blackbox search's final inputs and the restore
    lines."""
    spec = dataclasses.replace(SPEC, depth=2)
    params = vit.init_params(spec, torch.Generator().manual_seed(0), "cpu")
    params2 = vit.init_params(spec, torch.Generator().manual_seed(1), "cpu")
    rng = np.random.default_rng(21)
    x5 = gaussian_calibration(5, seed=21)
    adv5 = x5 + rng.uniform(-0.06, 0.06, x5.shape).astype(np.float32)
    x4, y4 = gaussian_calibration(4, seed=22), rng.integers(0, spec.num_classes,
                                                            4)
    probes, starts = _cpu_draws("rademacher"), _cpu_draws("normal")
    cpu_q = engine.QuantizedViT(spec, CFG, params=params, device="cpu")
    cpu_q.calibrate(gaussian_calibration(8, seed=23))
    loader = imagenet.DataLoader(imagenet.ImageFolder(
        os.path.join(root, "val"), imagenet.build_transform()), CLI_BATCH,
        num_workers=8)
    combos = restore.k_layer_combinations(1, vit.num_bit_slots(spec), 2)
    runs = []
    for d in (dev, torch.device("cpu")):
        fp = engine.QuantizedViT(spec, CFG, params=params, device=d)
        fp2 = engine.QuantizedViT(spec, CFG, params=params2, device=d)
        names, traces = ddv_hessian.DDVHessian(
            fp, fp, (x5, None), adv5, layer_indices=10, max_iter=3).trace(
            probes=probes)
        eig, _ = hessian.top_eigenvalues(fp.params, spec, x4, y4, top_n=2,
                                         max_iter=5, starts=starts)
        found = modeldiff.gen_profiling_inputs_blackbox(
            lambda x, m=fp: m(x, quant=False),
            lambda x, m=fp2: m(x, quant=False), x4, max_iterations=10,
            seed=2, device=d).cpu()
        fp.qparams = {k: v.to(d) for k, v in cpu_q.qparams.items()}
        lines = []
        restore.run_restore_sweep(fp, loader, combos,
                                  log=lambda ln: lines.append(
                                      ln.rsplit(" Time ", 1)[0]))
        runs.append((names, traces, eig, found, lines))
    (n_card, t_card, e_card, f_card, l_card), \
        (n_cpu, t_cpu, e_cpu, f_cpu, l_cpu) = runs
    out = dict(ddv_weights=len(n_card), ddv_traces_max_rel=_rel(t_card,
                                                                t_cpu),
               eigenvalues_card=e_card, eigenvalues_cpu=e_cpu,
               eigenvalues_max_rel=_rel(e_card, e_cpu),
               blackbox_inputs_equal=bool(torch.equal(f_card, f_cpu)),
               blackbox_moved=bool((f_cpu != torch.tensor(x4)).any()),
               restore_lines_equal=l_card == l_cpu, restore_lines=l_cpu)
    emit(phase="diff", part="card_vs_cpu", depth=2, **out)
    if n_card != n_cpu or len(n_card) != 7 \
            or out["ddv_traces_max_rel"] > DIFF_RTOL \
            or out["eigenvalues_max_rel"] > DIFF_RTOL \
            or not (out["blackbox_inputs_equal"] and out["blackbox_moved"]
                    and out["restore_lines_equal"]) or len(l_cpu) != 3:
        raise RuntimeError(f"diff card vs CPU: {out}")


def _driver(main, argv, cwd):
    """Run a driver's ``main(argv)`` in ``cwd`` with no kernel launched
    (its forwards are float or fake-quant); its printed lines, result and
    wall seconds."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.chdir(cwd), contextlib.redirect_stdout(out):
        res, counts = drive({}, lambda: main(argv))
    return out.getvalue().splitlines(), res, time.perf_counter() - t0, \
        counts


def phase_diff(dev, summary):
    """The DDV Hessian, the Hessian spectrum, the restore sweeps, ModelDiff
    and the analysis drivers on the card (see the module docstring, 17).
    Returns the launches by path."""
    paths = {}
    rng = np.random.default_rng(20)
    fp = engine.QuantizedViT(SPEC.name, CFG, seed=0, device=dev)

    # the DDV Hessian: PGD inputs against the float DeiT-S, b = 5, tap 30
    x5 = gaussian_calibration(5, seed=20)
    y5 = rng.integers(0, SPEC.num_classes, 5)
    attack = pgd.AttackPGD(fp, epsilon=0.06, step_size=0.01,
                           num_steps=DIFF_PGD, quant=False)
    adv, pgd_s = _timed(lambda: attack.gen_adv_inputs(
        x5, y5, generator=torch.Generator().manual_seed(0)))
    torch.cuda.reset_peak_memory_stats()
    ddvh = ddv_hessian.DDVHessian(fp, fp, (x5, y5), adv,
                                  layer_indices=DIFF_LAYER, max_iter=3)
    hvps = [0]

    def probes(name, k, like, g=torch.Generator(dev).manual_seed(0)):
        hvps[0] += 1
        return hessian.rademacher(like, g)

    (names, traces), trace_s = _timed(lambda: ddvh.trace(probes=probes))
    peak = torch.cuda.max_memory_allocated() / 2**30
    grads = hessian.BatchGrads(ddvh.q_params, SPEC, None, None,
                               ddvh.param_names, loss_fn=ddvh.loss)
    gen = torch.Generator(dev).manual_seed(1)
    hvp_ms = {n: cuda_ms(lambda n=n, v=hessian.rademacher(grads.ws[n], gen):
                         grads.hvp(n, v), iters=5)
              for n in (names[0], names[-1])}
    del grads
    emit(phase="diff", part="ddv_hessian", batch=5, pgd_steps=DIFF_PGD,
         pgd_seconds=pgd_s, layer_index=DIFF_LAYER, tap=ddvh.tap_names,
         weights=len(names), last_weight=names[-1], max_iter=3, hvps=hvps[0],
         trace_seconds=trace_s, seconds_per_hvp=trace_s / hvps[0],
         hvp_ms=hvp_ms, peak_gib=peak, traces=traces)
    if len(names) != 20 or names[-1] != "blocks.4.mlp.fc2.weight" \
            or not np.isfinite(traces).all():
        raise RuntimeError(f"DDV Hessian: {len(names)} weights, traces "
                           f"{traces}")
    del ddvh, attack

    # the spectrum at b = 8 over all 49 weights
    x8 = gaussian_calibration(8, seed=24)
    y8 = rng.integers(0, SPEC.num_classes, 8)
    torch.cuda.reset_peak_memory_stats()
    with _hvp_count() as top_hvps:
        (eigs, _), top_s = _timed(lambda: hessian.top_eigenvalues(
            fp.params, SPEC, x8, y8, torch.Generator(dev).manual_seed(0),
            top_n=2, max_iter=10))
    with _hvp_count() as lanczos_hvps:
        (ritz, weights), density_s = _timed(
            lambda: hessian.eigenvalue_density(
                fp.params, SPEC, x8, y8, torch.Generator(dev).manual_seed(0),
                iters=10))
    wsum = float(sum(weights[0]))
    emit(phase="diff", part="spectrum", batch=8,
         targets=len(hessian.hessian_target_names(SPEC)),
         top_eigenvalues=eigs, top_hvps=top_hvps[0], top_seconds=top_s,
         ritz_values=ritz[0], lanczos_hvps=lanczos_hvps[0],
         density_seconds=density_s, weights_sum=wsum,
         peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    if not (np.isfinite(eigs).all() and np.isfinite(ritz[0]).all()) \
            or abs(wsum - 1) > 1e-6 or len(eigs) != 2:
        raise RuntimeError(f"spectrum: {eigs}, {ritz}, weights {wsum}")

    # the restore sweeps on the calibrated DeiT-S, 64 images, two paths
    q, _ = _calibrated(CFG, gaussian_calibration(50, seed=0), dev)
    with tempfile.TemporaryDirectory() as root:
        for split in ("train", "val"):
            make_fake_imagefolder(os.path.join(root, split), **CLI_FOLDER)
        loader = imagenet.DataLoader(imagenet.ImageFolder(
            os.path.join(root, "val"), imagenet.build_transform()),
            CLI_BATCH, num_workers=8)
        combos = restore.k_layer_combinations(1, limit=3)
        forwards = -(-CLI_FOLDER["num_classes"] * CLI_FOLDER["per_class"]
                     // CLI_BATCH)
        sweeps = {}
        for route, validate_fn, expected in (
                ("fake", None, {}),
                ("int", lambda bc: engine.validate(
                    q, loader, bc, print_freq=0, log=_quiet,
                    use_int=True)[1:],
                 {K1: SPEC.depth * forwards * (1 + len(combos)),
                  K2: SPEC.depth * forwards * (1 + len(combos))})):
            path = os.path.join(root, f"restore_{route}.txt")
            (res, counts), secs = _timed(lambda: drive(
                expected, lambda: restore.run_restore_sweep(
                    q, loader, combos, out_path=path, log=_quiet,
                    validate_fn=validate_fn)))
            paths[f"{SPEC.name} restore {route}"] = counts
            sweeps[route] = dict(seconds_per_config=secs / len(res),
                                 lines=[ln.rstrip() for ln in open(path)],
                                 results=res)
        restored = q.prepare_int((8,) + (4,) * (vit.num_bit_slots(SPEC) - 1))
        px = rng.integers(0, 256, (8, 3, 224, 224), dtype=np.uint8)
        xc = torch.tensor(restored.encode(px), device=dev)
        held = _held_calls(summary, lambda: restored(xc), vit_int, (K1, K2),
                           model=f"{SPEC.name} restore [0]", batch=8)
        emit(phase="diff", part="restore", images=forwards * CLI_BATCH,
             configs=1 + len(combos), kernel_calls_held=held,
             **{f"{r}_{k}": v for r, sw in sweeps.items()
                for k, v in sw.items() if k != "results"})
        if held != 2 * SPEC.depth or len(sweeps["int"]["lines"]) != 4:
            raise RuntimeError(f"restore sweeps: {held} calls held, "
                               f"{sweeps}")

        # ModelDiff at b = 8: the float DeiT-S against the int4 bake
        model = q.prepare_int()
        model(px[:1])  # warm-up: K-major weight copies
        seeds = gaussian_calibration(8, seed=25)
        n = 2 + 2 * DIFF_BLACKBOX
        (found, blackbox_s), counts = drive(
            {K1: SPEC.depth * n, K2: SPEC.depth * n},
            lambda: _timed(lambda: modeldiff.gen_profiling_inputs_blackbox(
                lambda x: fp(x, quant=False), model, seeds,
                max_iterations=DIFF_BLACKBOX, seed=0, device=dev)))
        paths[f"{SPEC.name} modeldiff blackbox"] = counts
        moved = int((found.cpu() != torch.tensor(seeds)).sum())
        attack = pgd.AttackPGD(fp, num_steps=5, quant=False)
        g = torch.Generator().manual_seed(0)
        (best, whitebox_s), counts = drive(
            {K1: SPEC.depth * 4, K2: SPEC.depth * 4},
            lambda: _timed(lambda: modeldiff.gen_profiling_inputs_whitebox(
                lambda x: fp(x, quant=False), model,
                lambda x, y: attack.gen_adv_inputs(x, y, generator=g),
                seeds, rng.integers(0, SPEC.num_classes, 8),
                max_iterations=2, device=dev)))
        paths[f"{SPEC.name} modeldiff whitebox"] = counts
        emit(phase="diff", part="modeldiff", batch=8,
             blackbox_iterations=DIFF_BLACKBOX, blackbox_seconds=blackbox_s,
             forward2_calls=n, elements_moved=moved,
             whitebox_iterations=2, whitebox_pgd_steps=5,
             whitebox_seconds=whitebox_s, whitebox_improved=best is not None)
        if not bool(torch.isfinite(found).all()) or found.shape != (
                8, 3, 224, 224):
            raise RuntimeError("ModelDiff blackbox: bad inputs")
        del model, attack

        _diff_card_vs_cpu(dev, root)

        # the drivers, each to its report (float and fake-quant: no kernel)
        common = [SPEC.name, root, "--num-workers", "8", "--device",
                  dev.type]
        for name, main, argv, check in (
                ("ddv_hessian_calc", drv_ddv_hessian.main,
                 ["--batch-num", "1", "--max-iter", "3"],
                 lambda ln: ln[-1].startswith("***Trace:  [")),
                ("layerwise_quant_compare", drv_restore.main,
                 ["--mode", "1", "--k", "1", "--limit", "2", "--val-limit",
                  "32"],
                 lambda ln: sum(x.startswith("Restore Index:")
                                for x in ln) == 3),
                ("modeldiff_p2", drv_modeldiff.main,
                 ["--mode", "1", "--pgd-steps", "5", "--seed-batch", "8"],
                 lambda ln: sum("layer similarity" in x for x in ln)
                 == 4 * SPEC.depth + 2)):
            lines, _, secs, counts = _driver(main, common + argv, root)
            paths[f"driver {name}"] = counts
            emit(phase="diff", part="driver", driver=name, argv=argv,
                 seconds=secs, lines=lines[-4:])
            if not check(lines):
                raise RuntimeError(f"driver {name}: report {lines[-3:]}")
    return paths


PAR_REPEAT = 5  # forwards timed a leg (the median is printed)


def _par_legs(models):
    """Phase parallel's legs by world size, each with the launches every
    rank of it must make in one forward."""
    rng = np.random.default_rng(7)
    x64 = rng.integers(0, 256, (64, 3, 224, 224), dtype=np.uint8)
    x8 = x64[:8]
    s8 = rng.integers(0, 256, (8, 3, 224, 224), dtype=np.uint8)
    xf = rng.standard_normal((8, 3, 224, 224)).astype(np.float32)
    d = SPEC.depth
    per_forward = {K1: d, K2: d}
    legs = {2: [], 4: []}
    for b in (64, 61):
        x = x64[:b]
        for n, dims in ((2, dict(dp=2)), (2, dict(dp=1, tp=2)),
                        (2, dict(dp=1, pp=2)), (4, dict(dp=1, pp=4)),
                        (4, dict(dp=2, pp=2)), (4, dict(dp=1, tp=2, pp=2))):
            pp, dp = dims.get("pp", 1), dims["dp"]
            expected = per_forward
            if pp > 1:  # a stage's blocks, once a microbatch
                m = 2 * pp if b >= 2 * pp * dp else pp
                expected = {K1: d // pp * m, K2: d // pp * m}
            name = "x".join(f"{k}={v}" for k, v in dims.items() if v > 1)
            legs[n].append(dict(name=f"{SPEC.name} int4 b={b} {name}",
                                kind="int", n=n, mesh=dims, model="deit",
                                x=x, repeat=PAR_REPEAT, hold=True,
                                expected=expected))
    legs[4] += [
        dict(name=f"{SPEC.name} fqvit_int8 b=8 dp=2xtp=2", kind="int", n=4,
             mesh=dict(dp=2, tp=2), model="fqvit", x=x8, repeat=PAR_REPEAT,
             hold=True, expected={"fused_int_attention": d, K2: d}),
        dict(name=f"{SWIN.name} int4 b=8 dp=2xtp=2", kind="int", n=4,
             mesh=dict(dp=2, tp=2), model="swin", x=s8, repeat=PAR_REPEAT,
             hold=True, expected={K4: sum(SWIN.depths),
                                  K2: sum(SWIN.depths)}),
        dict(name=f"{SPEC.name} fake-quant b=8 tp=2xsp=2", kind="fake", n=4,
             mesh=dict(dp=1, tp=2, sp=2), model="fake", x=xf,
             repeat=PAR_REPEAT, grad=True, expected={}),
        dict(name="dryrun", kind="dryrun", n=4)]
    return legs


def _par_models(dev):
    """The seeded bakes of phases serve and calibrate, and the DeiT-S
    float params with qparams calibrated here on 8 Gaussian images."""
    q, _ = _calibrated(CFG, gaussian_calibration(8, 0), dev)
    return {
        "deit": ("int", random_int_model(SPEC, CFG, seed=0), SPEC, CFG),
        "fqvit": ("int", random_int_model(SPEC, FQVIT, seed=0), SPEC,
                  FQVIT),
        "swin": ("int", random_swin_int_model(SWIN, CFG, seed=0), SWIN,
                 CFG),
        "fake": ("fake", vit_int._host(q.params), vit_int._host(q.qparams),
                 SPEC, CFG)}


@contextlib.contextmanager
def _fd1(path):
    """File descriptor 1 (this process's stdout and its children's) sent to
    ``path`` for the block."""
    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, "w") as f:
        os.dup2(f.fileno(), 1)
        try:
            yield
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)


def _par_cli():
    """The CLI with --int-path --tp 2 --pp 2 (four ranks sharing the card)
    against the same run on one process: their report lines, times
    aside."""
    with tempfile.TemporaryDirectory() as tmp:
        make_fake_imagefolder(os.path.join(tmp, "val"), **CLI_FOLDER)
        argv = [SPEC.name, tmp, "--quant", "--mode", "1", "--int-path",
                "--calib-batchsize", "8", "--val-batchsize", str(CLI_BATCH),
                "--num-workers", "8", "--wire", "u8", "--print-freq", "1"]
        runs = {}
        for label, extra in (("single", []), ("tp=2xpp=2", ["--tp", "2",
                                                            "--pp", "2"])):
            log = os.path.join(tmp, f"{label}.log")
            t0 = time.perf_counter()
            with _fd1(log):
                result = cli.main(argv + extra)
            with open(log) as f:
                out = f.read().splitlines()
            runs[label] = dict(result=result, seconds=time.perf_counter() - t0,
                               report=[_TIMES.sub("Time", ln) for ln in out
                                       if "Prec@1" in ln],
                               mesh=[ln for ln in out
                                     if ln.startswith("mesh:")])
    equal = runs["single"]["report"] == runs["tp=2xpp=2"]["report"]
    emit(phase="parallel", leg="cli --int-path --tp 2 --pp 2",
         mesh=runs["tp=2xpp=2"]["mesh"], report_equal=equal,
         report_lines=len(runs["single"]["report"]),
         seconds={k: r["seconds"] for k, r in runs.items()},
         result=[float(v) for v in runs["tp=2xpp=2"]["result"]])
    if not equal or len(runs["single"]["report"]) < 2:
        raise RuntimeError("the CLI's report under tp=2 x pp=2 differs from "
                           "the single-process run's")


def phase_parallel(dev):
    """Phase 19 (module docstring).  Returns the launches by leg, every
    rank's added."""
    from diffvit_tpu_torch.parallel import comm, dryrun

    count = torch.cuda.device_count()
    models = _par_models(dev)
    launches = {}
    for world, legs in _par_legs(models).items():
        if count < world:
            emit(phase="parallel", world=world, nccl="not run",
                 reason=f"{count} card(s) for {world} ranks: NCCL refuses "
                        "two ranks on one device, so the ranks share the "
                        "card over gloo through pinned host memory")
        t0 = time.perf_counter()
        ranks = comm.spawn(dryrun.run_legs, world, "cuda",
                           args=([{k: v for k, v in leg.items()
                                   if k != "expected"} for leg in legs],
                                 models))
        seconds = time.perf_counter() - t0
        for i, leg in enumerate(legs):
            res = [r[i] for r in ranks][:leg["n"]]
            if leg["kind"] == "dryrun":
                emit(phase="parallel", leg="dryrun", world=world,
                     **dryrun._summary(res[0]))
                continue
            _par_check(leg, res, launches)
        emit(phase="parallel", world=world, legs=len(legs), seconds=seconds)
    _par_cli()
    return launches


def _par_check(leg, res, launches):
    """One leg's JSON line from its ranks' results; fails on a departure
    from the single process, an inexact launch count or a held kernel
    call that differs from its plain version."""
    counts = [r.get("launches", {}) for r in res]
    exact = all(c.get(k, 0) == leg["expected"].get(k, 0)
                for c in counts for k in set(c) | set(leg["expected"]))
    r0 = res[0]
    line = dict(phase="parallel", leg=leg["name"], ranks=leg["n"],
                backend=r0["backend"], host_staged=r0["host_staged"],
                ms=r0["ms"], bytes_per_rank=[r["bytes"] for r in res],
                launches_per_rank=[{k: v for k, v in c.items() if v}
                                   for c in counts], launches_exact=exact)
    if leg["kind"] == "int":
        held = r0["held"]
        line.update(equal_to_single=[r["equal"] for r in res],
                    held_calls=held[0], held_equal=held[1],
                    held_kernels=held[2])
        ok = all(r["equal"] for r in res) and held[0] == held[1] > 0
    else:
        line.update(logits=r0["logits"], grad=r0["grad"],
                    grad_logits=r0["grad_logits"])
        ok = all(r["logits"]["within"] and r["logits"]["argmax_equal"]
                 and r["grad"]["within"] for r in res)
    emit(**line)
    if not (ok and exact):
        raise RuntimeError(f"parallel leg {leg['name']} failed: {line}")
    total = launches.setdefault("parallel", dict.fromkeys(KERNELS, 0))
    for c in counts:
        for k, v in c.items():
            total[k] += v


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
    host_seconds = dict(zip(build.LIBRARIES, built))["host"][1]

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
    paths.update(phase_calibrate_swin(dev, summary))
    t.append(time.perf_counter())
    phase_probes_kernels(dev, summary)
    paths["probes"] = phase_probes(dev)
    t.append(time.perf_counter())
    phase_lis_wide(dev, summary)
    t.append(time.perf_counter())
    paths.update(phase_cli(dev))
    t.append(time.perf_counter())
    paths.update(phase_native(dev, host_seconds, smi))
    t.append(time.perf_counter())
    paths.update(phase_mixed(dev))
    t.append(time.perf_counter())
    paths.update(phase_recovery(dev))
    t.append(time.perf_counter())
    paths.update(phase_analysis(dev, summary))
    t.append(time.perf_counter())
    paths.update(phase_diff(dev, summary))
    t.append(time.perf_counter())
    paths.update(phase_parallel(dev))
    t.append(time.perf_counter())
    emit(phase="seconds", **{k: b - a for k, a, b in zip(
        ("kernels", "alternative_kernels", "deit_small", "deit_small_fqvit",
         "deit_small_resident", "branches", "swin_tiny", "swin_branches",
         "alternatives", "calibrate", "calibrate_swin", "probes",
         "lis_wide", "cli", "native", "mixed", "recovery", "analysis",
         "diff", "parallel"),
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

"""Quantized ViT/DeiT/Swin ImageNet evaluation, on the H100 (the port's
counterpart of the repo's ``test_quant.py``: the same parser names, the
same prints and the same Prec@1/Prec@5 report).

    python3 -m diffvit_tpu_torch.cli deit_small <data> --quant --mode 1 \\
        --int-path --save-int deit_s.npz
    python3 -m diffvit_tpu_torch.cli deit_small <data> --load-int deit_s.npz \\
        --resident --wire u8
    python3 -m diffvit_tpu_torch.cli swin_tiny <data> --quant --mode 1 \\
        --int-path

``<data>`` holds ImageFolder trees ``val/`` (validation) and ``train/``
(real calibration data, ``--mode 0``).  ``--device`` is ``cuda`` (the
default: every kernel runs on the card) or ``cpu`` (the kernels' plain
versions).  On ``--wire u8`` the validation images go through the native
JPEG pipeline (``data.imagenet.NativeJpegLoader``: libjpeg and the
Pillow-exact resampler in the host library), which ships the uint8 crop;
where the served model has a codes table (``--load-int``, or
``--int-path``), the loader encodes it into int8 input codes before the
prefetcher moves it to the card.  ``--native-preproc`` (``--wire f32``
only) keeps PIL's decode and resamples natively
(``data.native_preproc.build_native_transform``).

``--trace-out PATH`` (with ``--load-int``) records the validation's spans
(``utils/tracing.py``: each call's input, embed, encoder and head, the
wait for the prefetcher, the read of the logits and the scoring) and
writes them as a Chrome trace that Perfetto opens:

    python3 -m diffvit_tpu_torch.cli deit_small <data> --load-int deit_s.npz \\
        --resident --trace-out val_trace.json

``--mixed`` runs the mixed-precision search as the reference does: the
Hessian sensitivity on ``--hessian-batches`` train batches
(``analysis.hessian``, probes from a ``torch.Generator`` seeded with
``--seed``), calibration, the Pareto candidates ranked by omega, the
``--pareto-top`` single validations, then the evolutionary search scored
through the fake-quant forward (``--search-path fake``,
``engine.validate_bits``) or the integer path (``--search-path int``,
``engine.validate_bits_int``: K1 + K2 on the card), or per candidate
through ``validate(use_int=True)`` with ``--int-path``.  It prints
``best:`` and, with ``--save-int``, bakes the best configuration:

    python3 -m diffvit_tpu_torch.cli deit_small <data> --quant --mode 1 \\
        --mixed --search-path int --save-int best.npz

The recovery passes run after calibration and before the bake, in the
reference's order: ``--adaround`` (``--adaround-steps`` a site), QAT
(``--qat-steps``, ``--qat-lr``, ``--qat-remat``), ``--bias-corr``; under
``--mixed`` they run after the search, at the best configuration, before
``--save-int`` bakes it:

    python3 -m diffvit_tpu_torch.cli deit_small <data> --quant --mode 1 \\
        --adaround --qat-steps 100 --bias-corr --int-path --save-int r.npz

``--mode 2`` calibrates on a batch of ``--calib-batchsize`` images that
PSAQ generates on the device (``analysis/datagen.py``: 2 x 500 Adam steps
inverting the float model, or the ``--prior-checkpoint`` weights):

    python3 -m diffvit_tpu_torch.cli deit_small <data> --quant --mode 2 \\
        --int-path --save-int psaq.npz

``--dp/--tp/--sp/--pp`` build a mesh (``parallel/mesh.py``) as
``test_quant.py`` does: the CLI starts ``dp * tp * sp * pp`` ranks itself
(``parallel.comm.spawn``; without ``--dp``, dp fills the visible cards),
on the visible cards in turn, or joins the ranks torchrun started; ranks
that share a card talk over gloo.  ``--host-devices N`` runs N gloo ranks
on the CPU (with ``--device cpu``).  ``--pp`` pipelines the integer path,
so it needs ``--int-path`` or ``--load-int``.  Rank 0 prints the report:

    python3 -m diffvit_tpu_torch.cli deit_small <data> --quant --mode 1 \
        --int-path --tp 2 --pp 2
    torchrun --nproc-per-node 4 -m diffvit_tpu_torch.cli deit_small <data> \
        --quant --mode 1 --int-path --dp 2 --tp 2
"""
from __future__ import annotations

import argparse
import os
import random
import sys

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(
        description="P2-ViT on the H100 (diffvit_tpu_torch)")
    p.add_argument("model_pos", nargs="?", default=None,
                   help="model name (positional form)")
    p.add_argument("data_pos", nargs="?", default=None,
                   help="ImageNet dir (positional form)")
    p.add_argument("--model", default="deit_tiny")
    p.add_argument("--data", default="/home/ubuntu/imagenet")
    p.add_argument("--quant", default=False, action="store_true")
    p.add_argument("--ptf", default=True,
                   type=lambda s: s not in ("False", "false", "0"))
    p.add_argument("--lis", default=True,
                   type=lambda s: s not in ("False", "false", "0"))
    p.add_argument("--quant-method", default="minmax",
                   choices=["minmax", "ema", "omse", "percentile"])
    p.add_argument("--mixed", default=False, action="store_true")
    p.add_argument("--calib-batchsize", default=50, type=int)
    p.add_argument("--mode", default=0, type=int,
                   help="calibration data: 0 real, 1 Gaussian noise, "
                        "2 generated (PSAQ, analysis/datagen.py)")
    p.add_argument("--calib-iter", default=6, type=int)
    p.add_argument("--val-batchsize", default=50, type=int)
    p.add_argument("--num-workers", default=16, type=int)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: the kernels on the card; cpu: their plain "
                        "versions")
    p.add_argument("--print-freq", default=100, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--checkpoint", default=None,
                   help="local weights: a .pth, or for ViT/DeiT a .npz")
    p.add_argument("--prior-checkpoint", default=None,
                   help="--mode 2: invert these local weights (a .pth, "
                        "or for ViT/DeiT a .npz) in place of the model's")
    p.add_argument("--dp", default=None, type=int,
                   help="data-parallel ranks (default: the rest of the "
                        "devices)")
    p.add_argument("--tp", default=1, type=int,
                   help="tensor-parallel ranks (megatron-sharded weights)")
    p.add_argument("--sp", default=1, type=int,
                   help="sequence-parallel ranks (the fake-quant residual "
                        "stream's tokens)")
    p.add_argument("--pp", default=1, type=int,
                   help="pipeline stages of the integer path (needs "
                        "--int-path or --load-int)")
    p.add_argument("--host-devices", default=0, type=int,
                   help="run this many gloo ranks on the CPU (--device "
                        "cpu)")
    p.add_argument("--adaround", default=False, action="store_true",
                   help="after calibration, learn each weight site's "
                        "rounding (AdaRound, calib/adaround.py)")
    p.add_argument("--adaround-steps", default=1000, type=int,
                   help="Adam steps per weight site for --adaround")
    p.add_argument("--qat-steps", default=0, type=int,
                   help="after calibration (and --adaround), this many "
                        "distillation QAT steps on the calibration data "
                        "(calib/qat.py); 0 disables")
    p.add_argument("--qat-remat", default=False, action="store_true",
                   help="recompute each block in QAT's backward pass "
                        "(ViT family): less memory, the same losses")
    p.add_argument("--qat-lr", default=1e-5, type=float,
                   help="Adam learning rate for --qat-steps")
    p.add_argument("--bias-corr", default=False, action="store_true",
                   help="after calibration (and --adaround / QAT), fold "
                        "each linear's output mean shift into its bias "
                        "(calib/biascorr.py)")
    p.add_argument("--calib-multi-batch", default=False, action="store_true",
                   help="observe stats over --calib-iter batches and "
                        "finalize on the last")
    p.add_argument("--int-path", default=False, action="store_true",
                   help="validate the baked integer model (its kernels) "
                        "instead of the fake-quant simulation")
    p.add_argument("--wire", default="f32", choices=["f32", "u8"],
                   help="eval batches as normalized float32, or as the "
                        "uint8 crop (encoded into int8 codes on the "
                        "loader's side where the served model has a codes "
                        "table, else normalized on the card)")
    p.add_argument("--device-prefetch", default=2, type=int,
                   metavar="DEPTH",
                   help="batches copied to the device ahead of the model "
                        "(data/imagenet.DevicePrefetcher); 0 disables")
    p.add_argument("--native-preproc", default=False, action="store_true",
                   help="resample, crop and normalize with the native "
                        "resampler (PIL only decodes); --wire f32 only")
    p.add_argument("--hessian-batches", default=10, type=int,
                   help="train batches of --calib-batchsize for the "
                        "Hessian sensitivity (--mixed)")
    p.add_argument("--hessian-iter", default=150, type=int,
                   help="most Hutchinson probes a trace")
    p.add_argument("--hessian-estimator", default="per-leaf",
                   choices=["per-leaf", "joint"],
                   help="'per-leaf': the reference's per-parameter HVP "
                        "loop; 'joint': joint probes over every target "
                        "weight (same estimand)")
    p.add_argument("--evo-pop", default=25, type=int)
    p.add_argument("--evo-iter", default=8, type=int)
    p.add_argument("--evo-mutate", default=10, type=int)
    p.add_argument("--evo-crossover", default=10, type=int)
    p.add_argument("--pareto-top", default=5, type=int)
    p.add_argument("--size-factor", default=1.1, type=float,
                   help="model-size limit against all-4-bit")
    p.add_argument("--omega-columns", default="committed",
                   choices=["committed", "intended"],
                   help="global_distance columns the omega ranking reads: "
                        "'committed' replicates the reference's search "
                        "(an upstream indexing bug the published results "
                        "ran through); 'intended' the int4/int8 columns")
    p.add_argument("--search-path", default="fake", choices=["fake", "int"],
                   help="the evolutionary search's scorer: 'fake', the "
                        "fake-quant forward; 'int', the integer path "
                        "(ViT family; a Swin takes 'fake')")
    p.add_argument("--val-limit", default=None, type=int,
                   help="cap validation images (debug)")
    p.add_argument("--save-int", default=None, metavar="PATH",
                   help="after calibration, write the baked integer model "
                        "(engine.save_int_model)")
    p.add_argument("--load-int", default=None, metavar="PATH",
                   help="serve a --save-int artifact of either package: no "
                        "checkpoint, no calibration")
    p.add_argument("--resident", action="store_true",
                   help="with --load-int (ViT family): serve the encoder "
                        "through the resident kernel K6")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="with --load-int: record the validation's spans "
                        "(utils/tracing.py) and write them to PATH as a "
                        "Chrome trace (Perfetto, chrome://tracing)")
    return p


def parse_args(argv=None):
    """The parsed flags, with the refusals of flags that do not combine."""
    args = build_parser().parse_args(argv)
    if args.model_pos is not None:
        args.model = args.model_pos
    if args.data_pos is not None:
        args.data = args.data_pos
    if args.wire == "u8" and args.native_preproc:
        raise SystemExit("--wire u8 already decodes natively; "
                         "drop --native-preproc")
    if args.pp > 1 and not (args.int_path or args.load_int):
        raise SystemExit("--pp pipelines the integer path; add --int-path "
                         "(or serve one with --load-int)")
    if args.trace_out and not args.load_int:
        raise SystemExit("--trace-out traces a --load-int validation")
    if args.host_devices and args.device != "cpu":
        raise SystemExit("--host-devices runs gloo ranks on the CPU; it "
                         "requires --device cpu")
    return args


def mesh_dims(args, n_devices: int):
    """(dp, tp, sp, pp) of the flags over ``n_devices`` devices
    (``test_quant.py``'s rule): dp defaults to the devices that tp, sp and
    pp leave."""
    rest = args.tp * args.sp * args.pp
    dp = args.dp if args.dp is not None else max(1, n_devices // rest)
    return dp, args.tp, args.sp, args.pp


def _n_devices(args) -> int:
    from .parallel import comm

    if args.host_devices:
        return args.host_devices
    if comm.launched():
        return int(os.environ["WORLD_SIZE"])
    if args.device == "cuda" and torch.cuda.is_available():
        return torch.cuda.device_count()
    return 1


def seed_everything(seed):
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def main(argv=None):
    """Run the CLI; returns validate's (loss, Prec@1, Prec@5), or under
    ``--mixed`` the search's final population, best first (rank 0's,
    where it starts ranks)."""
    from .parallel import comm

    args = parse_args(argv)
    dims = mesh_dims(args, _n_devices(args))
    world = int(np.prod(dims))
    if args.trace_out and world > 1:
        raise SystemExit("--trace-out traces one process's validation; "
                         "drop the mesh flags")
    if comm.launched() and world != int(os.environ["WORLD_SIZE"]):
        raise SystemExit(f"the mesh dp*tp*sp*pp = {world} does not match "
                         f"torchrun's {os.environ['WORLD_SIZE']} ranks")
    if world > 1 and not comm.launched() and comm.WORLD is None:
        from .models.swin import SWIN_SPECS
        from .models.vit import VIT_SPECS

        # the ranks see this process's registry (specs added at run time)
        return comm.spawn(_rank_main, world, args.device,
                          args=(argv, dict(VIT_SPECS), dict(SWIN_SPECS)),
                          threads=1 if args.device == "cpu" else None)[0]
    return run(args, dims if world > 1 else None)


def _rank_main(world, argv, vit_specs, swin_specs):
    """One rank of :func:`main`: the registry of the process that started
    it, then :func:`run`; only rank 0 prints."""
    from .models.swin import SWIN_SPECS
    from .models.vit import VIT_SPECS

    VIT_SPECS.update(vit_specs)
    SWIN_SPECS.update(swin_specs)
    if world.rank != 0:
        sys.stdout = open(os.devnull, "w")
    try:
        args = parse_args(argv)
        return run(args, mesh_dims(args, world.size))
    finally:
        sys.stdout.flush()


def run(args, dims=None):
    """The CLI's work on this process: on one device, or (``dims``: dp,
    tp, sp, pp) as one rank of the mesh over the ranks of
    ``parallel.comm`` (torchrun's, where it started this process)."""
    seed_everything(args.seed)
    mesh = None
    device = args.device
    if dims is not None:
        from .parallel import comm
        from .parallel.mesh import make_mesh

        if comm.WORLD is None:
            comm.init_parallel(args.device)
        dp, tp, sp, pp = dims
        mesh = make_mesh(dp * tp * sp * pp, dp=dp, tp=tp, sp=sp, pp=pp)
        device = mesh.device
        print(f"mesh: dp={dp} tp={tp}" + (f" sp={sp}" if sp > 1 else "")
              + (f" pp={pp}" if pp > 1 else ""))

    from .config import QuantConfig
    from .data.imagenet import (DataLoader, DevicePrefetcher, ImageFolder,
                                NativeJpegLoader, build_transform)
    from .data.native_preproc import build_native_transform
    from .data.synthetic import gaussian_calibration
    from .engine import QuantizedViT, load_int_model, validate
    from .models import vit as vit_mod
    from .models.registry import preprocessing_for

    cfg = QuantConfig(ptf=args.ptf, lis=args.lis,
                      quant_method=args.quant_method)
    print(f"Model: {args.model}")
    pp = preprocessing_for(args.model)
    if args.save_int and not args.quant:
        raise SystemExit("--save-int bakes a calibrated integer model; "
                         "it requires --quant")
    if args.save_int and args.load_int:
        raise SystemExit("--save-int and --load-int are mutually exclusive")
    if args.load_int:
        if args.mixed:
            raise SystemExit("--load-int serves one baked bit_config; "
                             "run --mixed with --save-int instead")
        model = load_int_model(args.load_int, device,
                               resident=args.resident,
                               input_norm=(pp.mean, pp.std), mesh=mesh)
        print(f"Serving int artifact: {args.load_int} "
              f"({model.spec.name})"
              + (" [resident kernel]" if args.resident else ""))
    else:
        model = QuantizedViT(args.model, cfg, checkpoint=args.checkpoint,
                             seed=args.seed, device=device,
                             input_norm=(pp.mean, pp.std), mesh=mesh)

    def transform(normalize):
        if args.native_preproc:  # on --wire f32 only: normalize is True
            return build_native_transform(mean=pp.mean, std=pp.std,
                                          crop_pct=pp.crop_pct)
        return build_transform(mean=pp.mean, std=pp.std,
                               crop_pct=pp.crop_pct, normalize=normalize)

    val_dataset = ImageFolder(os.path.join(args.data, "val"),
                              transform(args.wire == "f32"))
    if args.val_limit:
        val_dataset.samples = val_dataset.samples[: args.val_limit]

    def val_loader(code_lut=None):
        """The validation batches: on --wire u8 from the native pipeline,
        as int8 codes through ``code_lut`` where the served model has one;
        then the prefetcher."""
        if args.wire == "u8":
            loader = NativeJpegLoader(
                val_dataset, args.val_batchsize, code_lut=code_lut,
                emit="u8" if code_lut is None else "codes")
        else:
            loader = DataLoader(val_dataset, args.val_batchsize,
                                shuffle=False, num_workers=args.num_workers)
        if args.device_prefetch > 0:
            from .parallel.mesh import batch_sharding

            loader = DevicePrefetcher(
                loader, depth=args.device_prefetch, device=device,
                sharding=None if mesh is None else batch_sharding(mesh))
        return loader

    train_loader = None

    def train_batches(n, batch_size):
        # one shared loader per batch size: successive calls advance its
        # per-epoch shuffle
        nonlocal train_loader
        if train_loader is None or train_loader.batch_size != batch_size:
            ds = ImageFolder(os.path.join(args.data, "train"),
                             transform(True))
            train_loader = DataLoader(ds, batch_size, shuffle=True,
                                      num_workers=args.num_workers,
                                      drop_last=True, seed=args.seed)
        out = []
        for i, b in enumerate(train_loader):
            if i >= n:
                break
            out.append(b)
        return out

    mean_hessian = None
    if args.mixed:
        from .analysis.hessian import hessian_sensitivity

        print("Calculating the sensitivities via the averaged Hessian "
              "trace...")
        print(f"Hutchinson estimator: {args.hessian_estimator}")
        batches = train_batches(args.hessian_batches, args.calib_batchsize)
        mean_hessian = hessian_sensitivity(
            model.params, model.spec, batches,
            torch.Generator(model.device).manual_seed(args.seed),
            max_iter=args.hessian_iter,
            joint=args.hessian_estimator == "joint")
        print("\n***Trace: ", mean_hessian)

    if args.quant and not args.load_int:
        if args.mode == 2:
            from .analysis.datagen import generate_data
            from .models.registry import build_params

            prior_params = None
            if args.prior_checkpoint:
                _, prior_params = build_params(args.model,
                                               args.prior_checkpoint,
                                               args.seed, device=model.device)
                print(f"PSAQ prior: {args.prior_checkpoint}")
            print("Generating data...")
            calib = generate_data(model.params, model.spec,
                                  batch_size=args.calib_batchsize,
                                  seed=args.seed, prior_params=prior_params)
            print("Calibrating with generated data...")
        elif args.mode == 1:
            print("Calibrating with Gaussian noise...")
            if args.calib_multi_batch:
                calib = [gaussian_calibration(args.calib_batchsize,
                                              args.seed + i)
                         for i in range(args.calib_iter)]
            else:
                calib = gaussian_calibration(args.calib_batchsize, args.seed)
        else:
            print("Calibrating with real data...")
            if args.calib_multi_batch:
                calib = [b[0] for b in train_batches(args.calib_iter,
                                                     args.calib_batchsize)]
            else:
                calib = train_batches(1, args.calib_batchsize)[0][0]
        model.calibrate(calib)
        if not args.mixed:
            reconstruct(args, model, calib)
            if args.save_int:
                model.save_int_model(args.save_int)
                print(f"Saved int artifact: {args.save_int}")
    if args.mixed:
        return _mixed_search(args, model, val_loader(), mean_hessian,
                             calib if args.quant else None)

    if not args.quant:
        bit_config = None
    elif model.is_swin:
        bit_config = model.cfg.bit_w.bits
    else:
        bit_config = [model.cfg.bit_w.bits] * \
            vit_mod.num_bit_slots(model.spec)
    use_int = args.int_path and args.quant

    # the codes wire: the served model's table encodes on the loader side
    served = model if args.load_int else \
        model.prepare_int(bit_config) if use_int else None
    loader = val_loader(None if served is None else served.input_lut)
    print(bit_config)
    if not args.trace_out:
        return validate(model, loader, bit_config, quant=args.quant,
                        print_freq=args.print_freq, use_int=use_int)
    from .utils import tracing

    with tracing.recording() as rec:
        res = validate(model, loader, bit_config, quant=args.quant,
                       print_freq=args.print_freq, use_int=use_int)
    tracing.write_chrome_trace(rec, args.trace_out)
    print(f"Wrote trace: {args.trace_out}")
    return res


def reconstruct(args, model, calib, bit_config=None):
    """The recovery passes the flags ask for (``test_quant.py:363-395``),
    on the calibration data ``calib``, at ``bit_config`` (None: the uniform
    default), with the reference's report lines."""
    nb = len(calib) if isinstance(calib, (list, tuple)) else 1
    if args.adaround:
        print(f"AdaRound reconstruction ({args.adaround_steps} steps/site, "
              f"{nb} calib batch{'es' if nb > 1 else ''})...")
        report = model.adaround(calib, bit_config,
                                steps=args.adaround_steps, seed=args.seed)
        imps = [1.0 - after / before
                for before, after in report.values() if before > 0]
        print(f"AdaRound: {len(report)} sites, mean site-MSE reduction "
              f"{100.0 * float(np.mean(imps)):.1f}%")
    if args.qat_steps > 0:
        print(f"Distillation QAT ({args.qat_steps} steps, "
              f"lr {args.qat_lr:g})...")
        losses = model.qat(calib, bit_config, steps=args.qat_steps,
                           lr=args.qat_lr, remat=args.qat_remat)
        print(f"QAT: distill MSE {losses[0]:.3e} -> {losses[-1]:.3e}")
    if args.bias_corr:
        print("Bias correction (DFQ-style mean-shift fold)...")
        report = model.bias_correct(calib, bit_config)
        before = [b for b, _ in report.values()]
        after = [a for _, a in report.values()]
        print(f"Bias correction: {len(report)} sites, mean |shift| "
              f"{float(np.mean(before)):.3e} -> {float(np.mean(after)):.3e}")


def _mixed_search(args, model, val_loader, mean_hessian, calib):
    """The reference's Pareto + evolutionary search (``test_quant.py:
    411-464``): returns the final population, best first.  The recovery
    passes then run at the best configuration on ``calib`` (None: not
    calibrated here), before ``--save-int`` bakes it."""
    from .analysis import mixed_precision as mp
    from .engine import validate, validate_bits, validate_bits_int
    from .models.swin import bit_slot_groups

    def evaluate(bit_config):
        print(bit_config)
        _, prec1, _ = validate(model, val_loader, tuple(bit_config),
                               quant=args.quant, print_freq=args.print_freq,
                               use_int=args.int_path)
        print("")
        return prec1

    flops = model.flops
    assert len(flops) - 1 == len(model.global_distance) == len(mean_hessian)
    print("Pareto Frontier.......")
    rng = random.Random(args.seed)
    groups = bit_slot_groups(model.spec) if model.is_swin else None
    bit_list = mp.sample_candidates(flops, rng, factor=args.size_factor,
                                    groups=groups)
    omega_list = mp.omega_rank(bit_list, flops, mean_hessian,
                               model.global_distance,
                               columns=args.omega_columns)
    print("Hessien-Based Validating...")
    for i in range(min(args.pareto_top, len(omega_list))):
        evaluate(omega_list[i][0])
    print("Start Evolutionary.......")
    # a generation's candidates in one pass over the data: the fake-quant
    # forward, or (--search-path int) the integer path; --int-path alone
    # validates each candidate's own bake
    evaluate_batch = None
    if args.search_path == "int":
        if model.is_swin or model.mesh is not None:
            print("--search-path int is ViT-family/single-chip; "
                  "falling back to the fake-quant search substrate")
        else:
            evaluate_batch = lambda cands: validate_bits_int(  # noqa: E731
                model, val_loader, cands)
    if evaluate_batch is None and not args.int_path:
        evaluate_batch = lambda cands: validate_bits(  # noqa: E731
            model, val_loader, cands)
    result = mp.evolutionary_search(
        omega_list, flops, evaluate, rng=rng, pop_size=args.evo_pop,
        evo_iter=args.evo_iter, mutate_size=args.evo_mutate,
        crossover_size=args.evo_crossover, factor=args.size_factor,
        evaluate_batch=evaluate_batch)
    print("best:", result[0])
    if calib is not None:
        # the search ranks nearest-rounded candidates; the passes fit the
        # configuration that ships
        reconstruct(args, model, calib, tuple(result[0][0]))
    if args.save_int:
        # bake the searched best configuration, not the uniform default
        model.save_int_model(args.save_int, bit_config=result[0][0])
        print(f"Saved int artifact (mixed best): {args.save_int}")
    return result


if __name__ == "__main__":
    main()

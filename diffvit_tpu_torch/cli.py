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

A flag whose machinery is not ported yet exits with ``SystemExit`` and
names its ROADMAP item (:data:`NOT_PORTED`).
"""
from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

# ROADMAP Queue 1 items of the flags whose machinery is not ported yet
_ITEMS = {
    9: "parallelism",
}
NOT_PORTED = dict.fromkeys(("dp", "tp", "sp", "pp", "host_devices"), 9)
_UNSET = object()


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
    p.add_argument("--dp", default=None, type=int, help="(not ported)")
    p.add_argument("--tp", default=1, type=int, help="(not ported)")
    p.add_argument("--sp", default=1, type=int, help="(not ported)")
    p.add_argument("--pp", default=1, type=int, help="(not ported)")
    p.add_argument("--host-devices", default=0, type=int,
                   help="(not ported)")
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
    return p


def parse_args(argv=None):
    """The parsed flags, after :func:`refuse_unported`."""
    parser = build_parser()
    # a flag not on the command line keeps _UNSET: argparse sets a default
    # only where the namespace has no value yet
    args = parser.parse_args(
        argv, argparse.Namespace(**dict.fromkeys(NOT_PORTED, _UNSET)))
    given = {d for d in NOT_PORTED if getattr(args, d) is not _UNSET}
    for d in NOT_PORTED.keys() - given:
        setattr(args, d, parser.get_default(d))
    if args.model_pos is not None:
        args.model = args.model_pos
    if args.data_pos is not None:
        args.data = args.data_pos
    refuse_unported(given)
    if args.wire == "u8" and args.native_preproc:
        raise SystemExit("--wire u8 already decodes natively; "
                         "drop --native-preproc")
    return args


def _not_ported(what: str, item: int):
    raise SystemExit(f"{what} is not ported to diffvit_tpu_torch yet "
                     f"(ROADMAP Queue 1, item {item}: {_ITEMS[item]})")


def refuse_unported(given):
    """``SystemExit`` naming the ROADMAP item of the first flag in
    ``given`` whose machinery is not ported."""
    for dest in sorted(given, key=list(NOT_PORTED).index):
        _not_ported("--" + dest.replace("_", "-"), NOT_PORTED[dest])


def seed_everything(seed):
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def main(argv=None):
    """Run the CLI; returns validate's (loss, Prec@1, Prec@5), or under
    ``--mixed`` the search's final population, best first."""
    args = parse_args(argv)
    seed_everything(args.seed)

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
        model = load_int_model(args.load_int, args.device,
                               resident=args.resident,
                               input_norm=(pp.mean, pp.std))
        print(f"Serving int artifact: {args.load_int} "
              f"({model.spec.name})"
              + (" [resident kernel]" if args.resident else ""))
    else:
        model = QuantizedViT(args.model, cfg, checkpoint=args.checkpoint,
                             seed=args.seed, device=args.device,
                             input_norm=(pp.mean, pp.std))

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
            loader = DevicePrefetcher(loader, depth=args.device_prefetch,
                                      device=args.device)
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
    return validate(model, loader, bit_config, quant=args.quant,
                    print_freq=args.print_freq, use_int=use_int)


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
        if model.is_swin:
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

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
versions).  On ``--wire u8`` the loader ships the uint8 crop; where the
served model has a codes table (``--load-int``, or ``--int-path``), the
loader encodes it into int8 input codes (``CodesLoader``) before the
prefetcher moves it to the card.

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
    6: "mixed precision",
    7: "the recovery passes",
    8: "the analysis toolkit",
    9: "parallelism",
    11: "the native JPEG decoder and preprocessing",
}
NOT_PORTED = {
    **dict.fromkeys(
        ("mixed", "hessian_batches", "hessian_iter", "hessian_estimator",
         "evo_pop", "evo_iter", "evo_mutate", "evo_crossover", "pareto_top",
         "size_factor", "omega_columns", "search_path"), 6),
    **dict.fromkeys(
        ("adaround", "adaround_steps", "qat_steps", "qat_remat", "qat_lr",
         "bias_corr"), 7),
    "prior_checkpoint": 8,
    **dict.fromkeys(("dp", "tp", "sp", "pp", "host_devices"), 9),
    "native_preproc": 11,
}
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
                        "2 generated (not ported)")
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
                   help="mode-2 prior weights (not ported)")
    p.add_argument("--dp", default=None, type=int, help="(not ported)")
    p.add_argument("--tp", default=1, type=int, help="(not ported)")
    p.add_argument("--sp", default=1, type=int, help="(not ported)")
    p.add_argument("--pp", default=1, type=int, help="(not ported)")
    p.add_argument("--host-devices", default=0, type=int,
                   help="(not ported)")
    p.add_argument("--adaround", default=False, action="store_true",
                   help="(not ported)")
    p.add_argument("--adaround-steps", default=1000, type=int,
                   help="(not ported)")
    p.add_argument("--qat-steps", default=0, type=int, help="(not ported)")
    p.add_argument("--qat-remat", default=False, action="store_true",
                   help="(not ported)")
    p.add_argument("--qat-lr", default=1e-5, type=float,
                   help="(not ported)")
    p.add_argument("--bias-corr", default=False, action="store_true",
                   help="(not ported)")
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
                   help="(not ported)")
    p.add_argument("--hessian-batches", default=10, type=int)
    p.add_argument("--hessian-iter", default=150, type=int)
    p.add_argument("--hessian-estimator", default="per-leaf",
                   choices=["per-leaf", "joint"])
    p.add_argument("--evo-pop", default=25, type=int)
    p.add_argument("--evo-iter", default=8, type=int)
    p.add_argument("--evo-mutate", default=10, type=int)
    p.add_argument("--evo-crossover", default=10, type=int)
    p.add_argument("--pareto-top", default=5, type=int)
    p.add_argument("--size-factor", default=1.1, type=float)
    p.add_argument("--omega-columns", default="committed",
                   choices=["committed", "intended"])
    p.add_argument("--search-path", default="fake", choices=["fake", "int"])
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
    refuse_unported(args, given)
    return args


def _not_ported(what: str, item: int):
    raise SystemExit(f"{what} is not ported to diffvit_tpu_torch yet "
                     f"(ROADMAP Queue 1, item {item}: {_ITEMS[item]})")


def refuse_unported(args, given):
    """``SystemExit`` naming the ROADMAP item of the first flag in
    ``given`` whose machinery is not ported, or of ``--mode 2``."""
    for dest in sorted(given, key=list(NOT_PORTED).index):
        _not_ported("--" + dest.replace("_", "-"), NOT_PORTED[dest])
    if args.mode == 2:
        _not_ported("--mode 2 (generated calibration data)", 8)


def seed_everything(seed):
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def main(argv=None):
    """Run the CLI; returns validate's (loss, Prec@1, Prec@5)."""
    args = parse_args(argv)
    seed_everything(args.seed)

    from .config import QuantConfig
    from .data.imagenet import (CodesLoader, DataLoader, DevicePrefetcher,
                                ImageFolder, build_transform)
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
        return build_transform(mean=pp.mean, std=pp.std,
                               crop_pct=pp.crop_pct, normalize=normalize)

    val_dataset = ImageFolder(os.path.join(args.data, "val"),
                              transform(args.wire == "f32"))
    if args.val_limit:
        val_dataset.samples = val_dataset.samples[: args.val_limit]
    val_loader = DataLoader(val_dataset, args.val_batchsize, shuffle=False,
                            num_workers=args.num_workers)

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

    if args.quant and not args.load_int:
        if args.mode == 1:
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
        if args.save_int:
            model.save_int_model(args.save_int)
            print(f"Saved int artifact: {args.save_int}")

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
    if args.wire == "u8" and served is not None \
            and served.input_lut is not None:
        val_loader = CodesLoader(val_loader, served.input_lut)
    if args.device_prefetch > 0:
        val_loader = DevicePrefetcher(val_loader, depth=args.device_prefetch,
                                      device=args.device)
    print(bit_config)
    return validate(model, val_loader, bit_config, quant=args.quant,
                    print_freq=args.print_freq, use_int=use_int)


if __name__ == "__main__":
    main()

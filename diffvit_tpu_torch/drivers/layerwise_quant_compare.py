"""Layer-restore sweep (the port's copy of ``layerwise_quant_compare.py``):
calibrate an int4 model, then evaluate bit configurations with chosen
indices restored to 8 bits through the fake-quant forward, appending the
results to ``restore_<k>_layers.txt`` in the working directory.

    python3 -m diffvit_tpu_torch.drivers.layerwise_quant_compare \\
        deit_small <data> --mode 1 --k 1 --limit 4
"""
from __future__ import annotations

import argparse
import ast
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="layerwise restore sweep")
    p.add_argument("model", nargs="?", default="deit_small")
    p.add_argument("data", nargs="?", default="/home/ubuntu/imagenet")
    p.add_argument("--quant-method", default="minmax")
    p.add_argument("--ptf", default=True)
    p.add_argument("--lis", default=True)
    p.add_argument("--calib-batchsize", default=50, type=int)
    p.add_argument("--val-batchsize", default=50, type=int)
    p.add_argument("--num-workers", default=8, type=int)
    p.add_argument("--mode", default=0, type=int)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--k", default=1, type=int,
                   help="number of restored layers per combination")
    p.add_argument("--combinations", default=None,
                   help="explicit list, e.g. '[(0,1),(4,5)]'")
    p.add_argument("--limit", default=None, type=int)
    p.add_argument("--val-limit", default=None, type=int)
    args = p.parse_args(argv)

    from ..analysis.restore import k_layer_combinations, run_restore_sweep
    from ..config import QuantConfig
    from ..data.imagenet import DataLoader, ImageFolder, build_transform
    from ..data.synthetic import gaussian_calibration
    from ..engine import QuantizedViT
    from ..models import vit as vit_mod
    from ..models.registry import preprocessing_for

    cfg = QuantConfig(ptf=args.ptf, lis=args.lis,
                      quant_method=args.quant_method)
    model = QuantizedViT(args.model, cfg, checkpoint=args.checkpoint,
                         seed=args.seed, device=args.device)
    pp = preprocessing_for(args.model)
    tf = build_transform(mean=pp.mean, std=pp.std, crop_pct=pp.crop_pct)
    val_ds = ImageFolder(os.path.join(args.data, "val"), tf)
    if args.val_limit:
        val_ds.samples = val_ds.samples[: args.val_limit]
    val_loader = DataLoader(val_ds, args.val_batchsize,
                            num_workers=args.num_workers)

    if args.mode == 1:
        calib = gaussian_calibration(args.calib_batchsize, args.seed)
    else:
        train_ds = ImageFolder(os.path.join(args.data, "train"), tf)
        dl = DataLoader(train_ds, args.calib_batchsize, shuffle=True,
                        num_workers=args.num_workers, drop_last=True,
                        seed=args.seed)
        calib = next(iter(dl))[0]
    model.calibrate(calib)

    slots = vit_mod.num_bit_slots(model.spec)
    if args.combinations:
        combos = [tuple(c) if hasattr(c, "__len__") else (c,)
                  for c in ast.literal_eval(args.combinations)]
    else:
        combos = k_layer_combinations(args.k, slots=slots, limit=args.limit)
    out_path = f"restore_{args.k}_layers.txt"
    return run_restore_sweep(model, val_loader, combos, out_path=out_path)


if __name__ == "__main__":
    main()

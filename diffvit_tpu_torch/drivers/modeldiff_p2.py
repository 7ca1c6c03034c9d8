"""ModelDiff-style DDV similarity (the port's copy of ``modeldiff_p2.py``):
the float model against its calibrated fake-quant model on the
reference's profiling attack inputs, the per-layer DDV cosine
similarities in %.

    python3 -m diffvit_tpu_torch.drivers.modeldiff_p2 deit_small <data> \\
        --mode 1 --pgd-steps 50
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="ModelDiff DDV comparison")
    p.add_argument("model", nargs="?", default="deit_small")
    p.add_argument("data", nargs="?", default="/home/ubuntu/imagenet")
    p.add_argument("--quant-method", default="minmax")
    p.add_argument("--calib-batchsize", default=50, type=int)
    p.add_argument("--seed-batch", default=50, type=int)
    p.add_argument("--num-workers", default=8, type=int)
    p.add_argument("--mode", default=0, type=int)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--pgd-steps", default=50, type=int)
    args = p.parse_args(argv)

    import torch

    from ..analysis.ddv import compute_ddv, ddv_similarities
    from ..analysis.pgd import gen_profiling_adv_inputs
    from ..config import QuantConfig
    from ..data.imagenet import DataLoader, ImageFolder, build_transform
    from ..data.synthetic import gaussian_calibration
    from ..engine import QuantizedViT
    from ..models.registry import preprocessing_for

    cfg = QuantConfig(quant_method=args.quant_method)
    fp_model = QuantizedViT(args.model, cfg, checkpoint=args.checkpoint,
                            seed=args.seed, device=args.device)
    q_model = QuantizedViT(args.model, cfg, checkpoint=args.checkpoint,
                           seed=args.seed, device=args.device)

    pp = preprocessing_for(args.model)
    tf = build_transform(mean=pp.mean, std=pp.std, crop_pct=pp.crop_pct)
    if args.mode == 1:
        calib = gaussian_calibration(args.calib_batchsize, args.seed)
        seeds = gaussian_calibration(args.seed_batch, args.seed + 1)
    else:
        ds = ImageFolder(os.path.join(args.data, "train"), tf)
        dl = DataLoader(ds, args.calib_batchsize, shuffle=True,
                        num_workers=args.num_workers, drop_last=True,
                        seed=args.seed)
        calib = next(iter(dl))[0]
        dl2 = DataLoader(ds, args.seed_batch, shuffle=True,
                         num_workers=args.num_workers, drop_last=True,
                         seed=args.seed + 1)
        seeds, _ = next(iter(dl2))  # labels unused by the profiling attack
    q_model.calibrate(calib)

    # the reference's profiling attack (modeldiff_p2.py:152-194): eps 0.3,
    # myloss on (mean - output) x 1000 pseudo-targets, clamped to [0, 1]
    adv = gen_profiling_adv_inputs(
        fp_model, seeds, generator=torch.Generator().manual_seed(args.seed),
        quant=False, num_steps=args.pgd_steps)

    src = compute_ddv(fp_model, seeds, adv, quant=False)
    tgt = compute_ddv(q_model, seeds, adv, quant=True)
    return ddv_similarities(src, tgt)


if __name__ == "__main__":
    main()

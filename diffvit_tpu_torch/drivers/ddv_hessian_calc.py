"""DDV-Hessian sensitivity (the port's copy of ``ddv_hessian_calc.py``):
PGD adversarial inputs against the float model, per-weight DDV-Hessian
traces on each of ``--batch-num`` train batches, and the per-batch
min-max-normalized mean trace.  The PGD starts (on the CPU) and the
Hutchinson probes (on the device) come from ``torch.Generator``s seeded
with ``--seed``.

    python3 -m diffvit_tpu_torch.drivers.ddv_hessian_calc deit_small <data> \\
        --batch-num 10 --max-iter 100
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description="DDV-Hessian sensitivity")
    p.add_argument("model", nargs="?", default="deit_small")
    p.add_argument("data", nargs="?", default="/home/ubuntu/imagenet")
    p.add_argument("--quant-method", default="minmax")
    p.add_argument("--calib-batchsize", default=5, type=int)
    p.add_argument("--num-workers", default=8, type=int)
    p.add_argument("--batch-num", default=10, type=int)
    p.add_argument("--layer-index", default=30, type=int,
                   help="single activation tap to diff (reference's "
                        "selectedIndex=30)")
    p.add_argument("--max-iter", default=100, type=int)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--checkpoint", default=None)
    args = p.parse_args(argv)

    import torch

    from ..analysis.ddv_hessian import DDVHessian
    from ..analysis.pgd import AttackPGD
    from ..config import QuantConfig
    from ..data.imagenet import DataLoader, ImageFolder, build_transform
    from ..engine import QuantizedViT
    from ..models.registry import preprocessing_for

    cfg = QuantConfig(quant_method=args.quant_method)
    # both models run the float path, as in the committed reference driver
    model = QuantizedViT(args.model, cfg, checkpoint=args.checkpoint,
                         seed=args.seed, device=args.device)
    q_model = QuantizedViT(args.model, cfg, checkpoint=args.checkpoint,
                           seed=args.seed, device=args.device)
    attack = AttackPGD(model, epsilon=0.06, step_size=0.01, num_steps=50,
                       quant=False)

    pp = preprocessing_for(args.model)
    tf = build_transform(mean=pp.mean, std=pp.std, crop_pct=pp.crop_pct)
    ds = ImageFolder(os.path.join(args.data, "train"), tf)
    dl = DataLoader(ds, args.calib_batchsize, shuffle=True,
                    num_workers=args.num_workers, drop_last=True,
                    seed=args.seed)

    starts = torch.Generator().manual_seed(args.seed)
    probes = torch.Generator(model.device).manual_seed(args.seed)
    trace_list = []
    names = None
    print("Calculating the sensitivities via the averaged Hessian trace...")
    for bi, (inputs, labels) in enumerate(dl):
        if bi >= args.batch_num:
            break
        adv = attack.gen_adv_inputs(inputs, labels, generator=starts)
        ddvh = DDVHessian(model, q_model, (inputs, labels), adv,
                          layer_indices=args.layer_index,
                          max_iter=args.max_iter)
        names, traces = ddvh.trace(generator=probes)
        trace_list.append(traces)
        print(f"batch {bi}: done")

    normalized = []
    for traces in trace_list:
        t = np.abs(np.asarray(traces))
        lo, hi = t.min(), t.max()
        normalized.append((t - lo) / (hi - lo) if hi > lo else t * 0)
    mean_hessian = np.stack(normalized).mean(axis=0).tolist()
    print(names)
    print("\n***Trace: ", mean_hessian)
    return names, mean_hessian


if __name__ == "__main__":
    main()

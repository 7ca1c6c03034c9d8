"""Adversarial DDV-CKA between a float and a quantized model (the port's
copy of ``examples/ddv_cka_calc.py``): calibrate an int4 model, run
``compute_cka_with_adversarial`` (PGD inputs against the float model),
pickle the heatmap and draw the qkv / proj / fc1 / fc2 sub-maps and the
diagonal (``analysis/plotting.py``: needs matplotlib).

    python3 -m diffvit_tpu_torch.drivers.ddv_cka_calc deit_small <data> \\
        --cka-iter 10 --cka-batch-iter 10
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("model", nargs="?", default="deit_small")
    p.add_argument("data", nargs="?", default="/home/ubuntu/imagenet")
    p.add_argument("--cka-batch", default=50, type=int)
    p.add_argument("--cka-iter", default=10, type=int)
    p.add_argument("--cka-batch-iter", default=10, type=int)
    p.add_argument("--calib-batchsize", default=50, type=int)
    p.add_argument("--num-workers", default=8, type=int)
    p.add_argument("--result-name", default="cka_with_adversarial_int4")
    p.add_argument("--base-dir", default="ddv_cka_score")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--pgd-steps", default=50, type=int)
    args = p.parse_args(argv)

    import torch

    from ..analysis.cka_drivers import compute_cka_with_adversarial
    from ..analysis.plotting import load_and_plot_diagonal, plot_cka_map
    from ..config import QuantConfig
    from ..data.imagenet import DataLoader, ImageFolder, build_transform
    from ..engine import QuantizedViT
    from ..models import vit as vit_mod
    from ..models.registry import preprocessing_for

    cfg = QuantConfig()
    fp_model = QuantizedViT(args.model, cfg, checkpoint=args.checkpoint,
                            seed=args.seed, device=args.device)
    q_model = QuantizedViT(args.model, cfg, checkpoint=args.checkpoint,
                           seed=args.seed, device=args.device)

    pp = preprocessing_for(args.model)
    tf = build_transform(mean=pp.mean, std=pp.std, crop_pct=pp.crop_pct)
    train_ds = ImageFolder(os.path.join(args.data, "train"), tf)

    # ONE loader shared by every factory call: its per-epoch shuffle
    # advances, so each cka_iter pass takes a distinct shuffle, as the
    # reference's repeated get_dataset calls do (dataset_utility.py:45-80)
    dl = DataLoader(train_ds, args.cka_batch, shuffle=True,
                    num_workers=args.num_workers, drop_last=True,
                    seed=args.seed)

    def batches():
        return iter(dl)

    q_model.calibrate(next(batches())[0])

    # both models take the (4 * depth + 2)-tap conv/linear set (-1 keeps
    # every float site float), so the heatmap is square and plot_cka_map
    # can slice it
    q_bits = (cfg.bit_w.bits,) * vit_mod.num_bit_slots(q_model.spec)
    fp_bits = (-1,) * vit_mod.num_bit_slots(fp_model.spec)
    out_dir = os.path.join(args.base_dir, args.result_name)
    compute_cka_with_adversarial(
        fp_model, q_model, batches,
        model1_bit_config=fp_bits, model2_bit_config=q_bits,
        cka_iter=args.cka_iter, cka_batch_iter=args.cka_batch_iter,
        pgd_steps=args.pgd_steps, result_name=out_dir,
        generator=torch.Generator().manual_seed(args.seed))
    plot_cka_map(args.result_name, args.result_name, args.base_dir,
                 depth=q_model.spec.depth)
    diag = load_and_plot_diagonal(
        os.path.join(out_dir, args.result_name + "_heatmap.pkl"))
    print("diagonal_values:", list(map(float, diag)))
    return diag


if __name__ == "__main__":
    main()

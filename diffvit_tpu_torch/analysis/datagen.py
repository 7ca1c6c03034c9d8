"""PSAQ-ViT data-free calibration image synthesis (the port's counterpart of
``diffvit_tpu/analysis/datagen.py``): Gaussian-noise images optimized with
Adam against (a) cross-entropy to random pseudo labels, (b) a
total-variation prior anchored to a random target variance and (c) the
negative KDE differential entropy of the row cosine similarities of every
attention context (attn @ v averaged over the heads, the ``attn.ctx``
taps of ``forward_fp``), with jitter and flip augmentation, a cosine
learning rate and a per-channel clip to the normalized [0, 1] range
(``_clip_bounds``).  ViT /
DeiT hook every block, Swin every block of every stage (base lr 0.25, and
the entropy pools all windows of an image).

The loss runs on the port's float forward with autograd, its terms in
float64 and rounded once; Adam is optax's as the JAX package runs it here,
eagerly (``calib.optim.Adam`` with ``eager=True``).  The images, labels and target
variance are drawn on the CPU from a ``torch.Generator`` seeded with
``seed`` (the same on every device) or given as ``draws``; the jitter and
flips come from ``np.random.default_rng(seed)`` in the JAX package's order
of calls.
"""
from __future__ import annotations

import numpy as np
import torch

from ..calib.optim import Adam
from ..data.imagenet import IMAGENET_MEAN, IMAGENET_STD
from ..models import swin as swin_mod
from ..models import vit as vit_mod

F32, F64 = torch.float32, torch.float64


def _ctx_hooks(spec):
    """Ordered (tap name, num_heads) of every attention context hook."""
    if isinstance(spec, swin_mod.SwinSpec):
        return [(f"layers.{s}.blocks.{bi}.attn.ctx", spec.num_heads[s])
                for s in range(spec.num_layers)
                for bi in range(spec.depths[s])]
    return [(f"blocks.{i}.attn.ctx", spec.num_heads)
            for i in range(spec.depth)]


def _linspace(lo, hi, num):
    """``jnp.linspace(lo, hi, num)``, differentiable in ``lo`` and ``hi``:
    ``lo * (1 - k / d) + hi * k / d`` for k < d = num - 1, then ``hi``."""
    d = num - 1
    # made on the device, and multiplied by 1 / d on every device (CUDA
    # torch divides by a Python number so)
    step = torch.arange(d, dtype=lo.dtype, device=lo.device) * (1.0 / d)
    return torch.cat([lo * (1 - step) + hi * step, hi[None]])


def attention_entropy(ctx, num_heads, batch_size):
    """-H of the KDE of the pairwise row cosine similarities of one hook's
    head-averaged context ``ctx`` (B_, N, H*hd), row 0 dropped (the CLS
    token; a Swin window's first row), each image's similarities pooled
    (a Swin's over all its windows).  In float64."""
    b_, n, c = ctx.shape
    a = ctx.to(F64).reshape(b_, n, num_heads, c // num_heads).mean(2)[:, 1:]
    a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-12)
    sims = a @ a.transpose(1, 2)
    flat = sims.reshape(batch_size, -1)
    # ties at the maximum (the diagonal) share its gradient, as in JAX
    x_plot = _linspace(sims.amin(), sims.amax(), 10).expand(batch_size, 10)
    kde_est = gaussian_kde(flat, x_plot)
    return -differential_entropy(kde_est, x_plot)


def total_variation(x):
    """The image prior: the L2 norms of the four neighbour differences,
    summed (in float64)."""
    x = x.to(F64)
    d1 = x[:, :, :, :-1] - x[:, :, :, 1:]
    d2 = x[:, :, :-1, :] - x[:, :, 1:, :]
    d3 = x[:, :, 1:, :-1] - x[:, :, :-1, 1:]
    d4 = x[:, :, :-1, :-1] - x[:, :, 1:, 1:]
    return sum(torch.linalg.vector_norm(d) for d in (d1, d2, d3, d4))


def gaussian_kde(train_xs, x, bandwidth=0.01):
    """The Gaussian kernel density of each row of ``train_xs`` (B, M) at
    the points ``x`` (B, P): the mean over the M points of N(x - xi;
    bandwidth^2)."""
    diffs = x[:, :, None] - train_xs[:, None, :]
    var = bandwidth**2
    coef = 1.0 / np.sqrt(2 * np.pi * var)
    # a multiply by the reciprocal on every device (CUDA torch divides by
    # a Python number so)
    return (coef * torch.exp(diffs**2 * (-0.5 / var))).mean(-1)


def differential_entropy(pdf, x_pdf):
    """The trapezoidal -integral of p log p over ``x_pdf``, averaged over
    the rows."""
    pdf = pdf + 1e-4
    f = -pdf * torch.log(pdf)
    dx = x_pdf[:, 1:] - x_pdf[:, :-1]
    return (0.5 * (dx * (f[:, 1:] + f[:, :-1])).sum(-1)).mean()


def _clip_bounds(device):
    """The per-channel bounds of the normalized [0, 1] range (the clip of
    every step), in float32 as JAX takes them: ``-mean / std`` and ``(1 -
    mean) / std``, taken on the host."""
    mean, std = np.float32(IMAGENET_MEAN), np.float32(IMAGENET_STD)
    return tuple(torch.tensor(b.reshape(1, 3, 1, 1), device=device)
                 for b in (-mean / std, (np.float32(1) - mean) / std))


def _cosine_lr(base_lr, warmup, total):
    """The schedule ``lr(it) = 0.5 * (1 + cos(pi * min(it, total) /
    total)) * base_lr`` as float32 numbers, in JAX's float32 operations;
    the cosine taken in float64 and rounded once (XLA's float32 ``cos``
    on the CPU is an ulp off it at 2 of the 500 arguments of an epoch).
    ``warmup`` is never reached with the reference's settings (an epoch
    is one iteration here) and is ignored, as in JAX."""
    del warmup
    pi, half, one = np.float32(np.pi), np.float32(0.5), np.float32(1)
    base = np.float32(base_lr)

    def lr_fn(it):
        a = pi * np.float32(min(it, total)) / np.float32(total)
        c = np.float32(np.cos(np.float64(a)))
        return half * (one + c) * base

    return lr_fn


def _draws(spec, batch_size, seed):
    """The starting images (B, 3, S, S), labels and target variance, drawn
    on the CPU from a ``torch.Generator`` seeded with ``seed``."""
    g = torch.Generator().manual_seed(seed)
    img = torch.randn((batch_size, 3, spec.img_size, spec.img_size),
                      generator=g)
    pred = torch.randint(0, spec.num_classes, (batch_size,), generator=g)
    var_pred = float(np.float32(torch.empty(()).uniform_(
        2500.0, 3000.0, generator=g)))
    return img, pred, var_pred


def _device_of(tree):
    """The device of the first tensor of a params pytree."""
    while not isinstance(tree, torch.Tensor):
        tree = next(v for v in (tree.values() if isinstance(tree, dict)
                                else tree) if v is not None)
    return tree.device


def psaq_loss(params, spec, x, pred, var_pred, batch_size,
              weights=(1.0, 1.0, 0.05)):
    """The loss of the (augmented) images ``x``, a float64 scalar:
    ``weights`` = (entropy, one-hot, total variation) times the summed
    attention entropies of every hook, the cross-entropy to the labels
    ``pred`` and |TV(x) - var_pred|."""
    is_swin = isinstance(spec, swin_mod.SwinSpec)
    fwd = swin_mod.forward_fp if is_swin else vit_mod.forward_fp
    taps: list = []
    logits = fwd(params, spec, x, taps=taps)
    tapd = dict(taps)
    logp = torch.log_softmax(logits.to(F64), dim=-1)
    loss_oh = -logp.gather(1, pred[:, None]).mean()
    loss_tv = torch.abs(total_variation(x) - var_pred)
    loss_entropy = sum(attention_entropy(tapd[name], nh, batch_size)
                       for name, nh in _ctx_hooks(spec))
    entropy_weight, oh_weight, tv_weight = weights
    return entropy_weight * loss_entropy + oh_weight * loss_oh \
        + tv_weight * loss_tv


def generate_data(params, spec, *, batch_size=32, seed=0, iters_per_epoch=500,
                  epochs=2, lr=None, entropy_weight=1.0, oh_weight=1.0,
                  tv_weight=0.05, log=None, prior_params=None,
                  prior_spec=None, draws=None):
    """Synthesize a calibration batch on the params' device.  Returns
    (batch_size, 3, spec.img_size, spec.img_size) float32 images.
    ``prior_params`` / ``prior_spec``: a separate float model to invert in
    place of ``params``.  ``draws``: the starting (images, labels, target
    variance) in place of :func:`_draws`'s."""
    if prior_params is not None:
        params = prior_params
        spec = prior_spec if prior_spec is not None else spec
    device = _device_of(params)
    img, pred, var_pred = draws if draws is not None else \
        _draws(spec, batch_size, seed)
    img = torch.tensor(np.asarray(img, np.float32)) \
        if not isinstance(img, torch.Tensor) else img
    img = img.to(device, F32, copy=True)  # Adam updates it in place
    pred = torch.as_tensor(np.asarray(pred, np.int64)).to(device)
    var_pred = float(var_pred)
    is_swin = isinstance(spec, swin_mod.SwinSpec)
    base_lr = lr if lr is not None else (0.25 if is_swin else 0.20)
    weights = (entropy_weight, oh_weight, tv_weight)

    def loss_fn(img, off, flip):
        x = torch.roll(img, (off, off), dims=(2, 3))
        if flip:
            x = torch.flip(x, dims=(3,))
        return psaq_loss(params, spec, x, pred, var_pred, batch_size,
                         weights)

    lo, hi = _clip_bounds(device)
    rng = np.random.default_rng(seed)
    for epoch in range(epochs):
        lim = 15 if epoch == 0 else 30
        lr_sched = _cosine_lr(base_lr, 100, iters_per_epoch)
        opt = Adam(img, lr_sched, iters_per_epoch, b1=0.5, b2=0.9,
                   eps=1e-8, eager=True)
        for it in range(iters_per_epoch):
            off = int(rng.integers(-lim, lim + 1))
            flip = bool(rng.random() > 0.5)
            leaf = img.detach().requires_grad_(True)
            loss = loss_fn(leaf, off, flip)
            (g,) = torch.autograd.grad(loss, leaf)
            opt.step(g)
            img.clamp_(lo, hi)
            if log and it % 100 == 0:
                log(f"epoch {epoch} iter {it}: loss {float(loss):.3f}")
    return img.detach()

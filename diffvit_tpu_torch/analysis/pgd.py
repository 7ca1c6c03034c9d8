"""PGD adversarial inputs (the port's counterpart of
``diffvit_tpu/analysis/pgd.py``): L-infinity PGD from a uniform random
start, each step ``x + step_size * sign(grad)``, clamped to the epsilon
ball around the inputs and to the inputs' global [min, max] (or, for the
ModelDiff profiling attack, to [0, 1]).

The attacked forward is the engine's differentiable logits forward
(``QuantizedViT.forward_fn``).  Its fake-quant form rounds without the
STE, as JAX's does, so the gradient there is exactly 0 and the iterates
stay at the clamped start.  The uniform start is drawn on the CPU from a
``torch.Generator`` (default: seeded with 0) and moved to the inputs'
device, or given as ``init_noise``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

F32, F64 = torch.float32, torch.float64


def _ce_sum(logits, targets):
    logp = torch.log_softmax(logits.to(F64), dim=-1)
    return -logp.gather(1, targets[:, None]).sum()


def _uniform_start(inputs, epsilon, generator):
    """A uniform draw in [-epsilon, epsilon) of the inputs' shape, on the
    CPU from ``generator`` (None: seeded with 0), on their device."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    u = torch.empty(inputs.shape).uniform_(-epsilon, epsilon,
                                           generator=generator)
    return u.to(inputs.device)


def _pgd(loss_fn, inputs, x0, epsilon, step_size, num_steps, lo, hi):
    """``num_steps`` signed-gradient ascent steps of ``loss_fn`` from
    ``x0``, each clamped to the ball and to [lo, hi]."""
    below, above = inputs - epsilon, inputs + epsilon
    x = x0
    for _ in range(num_steps):
        leaf = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss_fn(leaf), leaf)
        x = x + step_size * torch.sign(g)
        x = torch.minimum(torch.maximum(x, below), above)
        x = torch.clamp(x, lo, hi)
    return x.detach()


def _as_tensor(a, device):
    return a.to(device) if isinstance(a, torch.Tensor) else \
        torch.tensor(np.asarray(a), device=device)


def make_pgd(forward_fn, epsilon=0.06, step_size=0.01, num_steps=50):
    """``forward_fn(x) -> logits`` (the attacked network, float or
    fake-quant).  Returns ``gen(inputs, targets, generator=None,
    init_noise=None) -> adversarial inputs`` ascending the summed
    cross-entropy to ``targets``."""

    def gen(inputs, targets, generator=None, init_noise=None):
        inputs = torch.as_tensor(inputs)
        targets = torch.as_tensor(targets).to(inputs.device, torch.int64)
        noise = _uniform_start(inputs, epsilon, generator) \
            if init_noise is None else _as_tensor(init_noise, inputs.device)
        return _pgd(lambda x: _ce_sum(forward_fn(x), targets), inputs,
                    inputs + noise, epsilon, step_size, num_steps,
                    inputs.min(), inputs.max())

    return gen


def make_pseudo_label_pgd(forward_fn, epsilon=0.3, step_size=0.01,
                          num_steps=50):
    """The ModelDiff profiling attack: PGD ascending ``myloss`` to the
    pseudo-targets, clamped to the ball and to [0, 1].  ``myloss(yhat,
    y) = -mean((yhat_0 - y_0)^2 + 0.1 * mean((yhat_1: - y_1:)^2))``:
    ascending it drives the logits toward the targets.  Returns
    ``run(inputs, targets, generator=None, init_noise=None)``."""

    def myloss(yhat, y):
        yhat, y = yhat.to(F64), y.to(F64)
        return -torch.mean((yhat[:, 0] - y[:, 0]) ** 2
                           + 0.1 * torch.mean((yhat[:, 1:] - y[:, 1:]) ** 2,
                                              dim=1))

    def run(inputs, targets, generator=None, init_noise=None):
        inputs = torch.as_tensor(inputs)
        targets = _as_tensor(targets, inputs.device)
        noise = _uniform_start(inputs, epsilon, generator) \
            if init_noise is None else _as_tensor(init_noise, inputs.device)
        return _pgd(lambda x: myloss(forward_fn(x), targets), inputs,
                    inputs + noise, epsilon, step_size, num_steps, 0.0, 1.0)

    return run


def gen_profiling_adv_inputs(model, inputs, generator=None, quant=False,
                             bit_config=None, epsilon=0.3, step_size=0.01,
                             num_steps=50, init_noise=None):
    """The ModelDiff profiling inputs: pseudo-targets (mean(clean logits)
    - clean logits) x 1000, then :func:`make_pseudo_label_pgd`."""
    fwd = _engine_forward(model, quant, bit_config)
    inputs = model._prep(inputs)
    with torch.no_grad():
        clean = fwd(inputs).to(F64)
    y = ((clean.mean(0) - clean) * 1000.0).to(F32)
    attack = make_pseudo_label_pgd(fwd, epsilon, step_size, num_steps)
    return attack(inputs, y, generator=generator, init_noise=init_noise)


def _hashable_bits(bit_config):
    """A bit config as the forwards take it: None and ints (a Swin's
    uniform bit) as they are, sequences as int tuples."""
    if bit_config is None or isinstance(bit_config, int):
        return bit_config
    return tuple(int(b) for b in bit_config)


def _engine_forward(model, quant, bit_config):
    """The logits-only differentiable forward of an engine.QuantizedViT."""
    return model.forward_fn(quant, _hashable_bits(bit_config))


class AttackPGD:
    """The reference's object-style PGD: ``gen_adv_inputs(inputs, labels,
    generator=None, init_noise=None)`` against ``model`` (float, or
    fake-quant at ``bit_config`` when ``quant``; default: whether it is
    calibrated)."""

    def __init__(self, model, epsilon=0.06, step_size=0.01, num_steps=50,
                 bit_config=None, quant=None):
        self.model = model
        self.bit_config = bit_config
        quant = (model.qparams is not None) if quant is None else quant
        self._fwd = _engine_forward(model, quant, bit_config)
        self._gen = make_pgd(self._fwd, epsilon, step_size, num_steps)

    def gen_adv_inputs(self, inputs, labels, generator=None,
                       init_noise=None):
        return self._gen(self.model._prep(inputs), labels,
                         generator=generator, init_noise=init_noise)

    def get_seed_inputs(self, n, args=None, rand=False):
        """A shuffled batch of ``n`` train images from ``args.data``'s
        ``train/`` ImageFolder, or (``rand``) Gaussian noise with zero
        labels."""
        if rand:
            return np.random.normal(size=(n, 3, 224, 224)).astype("float32"), \
                np.zeros((n,), "int32")
        from ..data.imagenet import DataLoader, ImageFolder, build_transform
        from ..models.registry import preprocessing_for

        pp = preprocessing_for(args.model)
        tf = build_transform(mean=pp.mean, std=pp.std, crop_pct=pp.crop_pct)
        ds = ImageFolder(os.path.join(args.data, "train"), tf)
        dl = DataLoader(ds, n, shuffle=True, num_workers=args.num_workers,
                        drop_last=True)
        return next(iter(dl))

"""Minibatch CKA and adversarial-DDV CKA accumulators (the port's
counterpart of ``diffvit_tpu/analysis/cka.py``): unbiased-HSIC minibatch
CKA over layer x layer centred Grams, and its clean x adversarial variant.

Each Gram and each batch's HSIC products are taken in float64 and rounded
once to float32; the accumulators are float32 tensors on the activations'
device.  Against JAX's float32 products they agree within an rtol, not
bit for bit.
"""
from __future__ import annotations

import torch

F32, F64 = torch.float32, torch.float64


def centered_gram(x):
    """The unbiased-HSIC centred Gram of a (N, ...) activation, flattened:
    G = X X^T with its diagonal zeroed, doubly centred with the unbiased
    means, its diagonal zeroed again."""
    x = x.reshape(x.shape[0], -1).to(F64)
    return _center(x @ x.T)


def centered_adv_gram(x, adv_x):
    """The DDV Gram X X_adv^T between the clean and the adversarial
    activations of one layer, centred as :func:`centered_gram`'s."""
    x = x.reshape(x.shape[0], -1).to(F64)
    adv_x = adv_x.reshape(adv_x.shape[0], -1).to(F64)
    return _center(x @ adv_x.T)


def _center(gram):
    """Centre a float64 Gram; returns it flattened, rounded to float32."""
    n = gram.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=gram.device)
    gram = gram.masked_fill(eye, 0.0)
    means = gram.sum(0) / (n - 2)
    means = means - means.sum() / (2 * (n - 1))
    gram = gram - means[None, :] - means[:, None]
    return gram.masked_fill(eye, 0.0).reshape(-1).to(F32)


def _products(g1, g2):
    """``g1 @ g2.T`` of two stacks of float32 Grams, in float64 rounded
    once."""
    return (g1.to(F64) @ g2.to(F64).T).to(F32)


def _sq_norms(g):
    """Each row's squared norm, in float64 rounded once."""
    return (g.to(F64) ** 2).sum(1).to(F32)


def _sqrt(t):
    return torch.sqrt(t.to(F64)).to(F32)


class MinibatchCKA:
    """Accumulates the layer x layer HSIC across minibatches."""

    def __init__(self, num_layers, num_layers2=None, across_models=False):
        num_layers2 = num_layers2 or num_layers
        self.hsic = torch.zeros((num_layers, num_layers2))
        self.across_models = across_models
        if across_models:
            self.hsic1 = torch.zeros((num_layers,))
            self.hsic2 = torch.zeros((num_layers2,))

    def update_state(self, activations):
        grams = torch.stack([centered_gram(a) for a in activations])
        self.hsic = self.hsic.to(grams.device) + _products(grams, grams)

    def update_state_across_models(self, activations1, activations2):
        assert self.hsic.shape[0] == len(activations1)
        assert self.hsic.shape[1] == len(activations2)
        g1 = torch.stack([centered_gram(a) for a in activations1])
        g2 = torch.stack([centered_gram(a) for a in activations2])
        self.hsic = self.hsic.to(g1.device) + _products(g1, g2)
        self.hsic1 = self.hsic1.to(g1.device) + _sq_norms(g1)
        self.hsic2 = self.hsic2.to(g1.device) + _sq_norms(g2)

    def result(self):
        m = self.hsic
        if self.across_models:
            return m / _sqrt(self.hsic1)[:, None] / _sqrt(self.hsic2)[None, :]
        norm = _sqrt(torch.diagonal(m))
        return m / norm[:, None] / norm[None, :]


class MinibatchAdvCKA:
    """Cross-model CKA over the clean x adversarial DDV Grams."""

    def __init__(self, num_layers, num_layers2=None):
        num_layers2 = num_layers2 or num_layers
        self.hsic = torch.zeros((num_layers, num_layers2))
        self.hsic1 = torch.zeros((num_layers,))
        self.hsic2 = torch.zeros((num_layers2,))

    def update_state(self, m1_acts, m1_adv_acts, m2_acts, m2_adv_acts):
        g1 = torch.stack([centered_adv_gram(a, b)
                          for a, b in zip(m1_acts, m1_adv_acts)])
        g2 = torch.stack([centered_adv_gram(a, b)
                          for a, b in zip(m2_acts, m2_adv_acts)])
        self.hsic = self.hsic.to(g1.device) + _products(g1, g2)
        self.hsic1 = self.hsic1.to(g1.device) + _sq_norms(g1)
        self.hsic2 = self.hsic2.to(g1.device) + _sq_norms(g2)

    def result(self):
        return self.hsic / _sqrt(self.hsic1)[:, None] \
            / _sqrt(self.hsic2)[None, :]

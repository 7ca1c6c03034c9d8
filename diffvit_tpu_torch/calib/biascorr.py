"""Bias correction (counterpart of ``diffvit_tpu/calib/biascorr.py``;
DFQ-style, Nagel et al., ICCV 2019): quantization shifts each linear's
output mean; the empirical per-channel shift is folded into its bias, at
no cost to inference.

The float path's output means are collected once through the forwards'
``taps``; the sites are corrected in forward order, each from a quantized
forward of the partly corrected model, so that each correction absorbs
the shift arriving from upstream.  One last forward measures what is left.
It composes with AdaRound and QAT when given the original float params.
Means are taken in float64 and rounded once (the JAX package's are float32
sums in XLA's order).
"""
from __future__ import annotations

import torch

from ..config import QuantConfig
from ..models import swin, vit
from .adaround import _get, _set

F32, F64 = torch.float32, torch.float64


def _mean(t):
    """The per-output-channel mean over every leading axis."""
    return t.reshape(-1, t.shape[-1]).to(F64).mean(0).to(F32)


class _Means:
    """A ``taps`` list for the forwards that keeps the channel mean of each
    tensor (of the one named ``name`` only, where given)."""

    def __init__(self, name=None):
        self.name, self.means = name, {}

    def append(self, pair):
        if self.name is None or pair[0] == self.name:
            self.means[pair[0]] = _mean(pair[1])


def _vit_bias_sites(spec):
    sites = [("patch_embed.proj", ("patch_embed", "b"))]
    for i in range(spec.depth):
        p, base = f"blocks.{i}", ("blocks", i)
        sites += [(f"{p}.attn.qkv", base + ("qkv", "b")),
                  (f"{p}.attn.proj", base + ("proj", "b")),
                  (f"{p}.mlp.fc1", base + ("fc1", "b")),
                  (f"{p}.mlp.fc2", base + ("fc2", "b"))]
    sites.append(("head", ("head", "b")))
    return sites


def _swin_bias_sites(spec):
    sites = [("patch_embed.proj", ("patch_embed", "proj", "b"))]
    for s in range(spec.num_layers):
        for bi in range(spec.depths[s]):
            p = f"layers.{s}.blocks.{bi}"
            base = ("layers", s, "blocks", bi)
            sites += [(f"{p}.attn.qkv", base + ("qkv", "b")),
                      (f"{p}.attn.proj", base + ("proj", "b")),
                      (f"{p}.mlp.fc1", base + ("fc1", "b")),
                      (f"{p}.mlp.fc2", base + ("fc2", "b"))]
        # the reductions have no bias
    sites.append(("head", ("head", "b")))
    return sites


@torch.no_grad()
def bias_correct(params, qp, spec, cfg: QuantConfig, x, bit_config=None,
                 fp_params=None):
    """Sequential empirical bias correction of every biased linear.
    Returns ``(new_params, report)``, report mapping each site to (the mean
    |shift| before, after) in output units, 'after' from one last forward
    of the corrected model.  ``fp_params``: the float params whose means
    are the targets; pass the original ones when ``params`` was already
    reconstructed (the float forward of rounded weights is not the float
    model)."""
    if fp_params is None:
        fp_params = params
    if isinstance(spec, swin.SwinSpec):
        mod, sites = swin, _swin_bias_sites(spec)
    else:
        mod, sites = vit, _vit_bias_sites(spec)

    def q_means(p_, name=None):
        taps = _Means(name)
        mod.forward_q(p_, qp, spec, cfg, x, bit_config, taps=taps)
        return taps.means

    fp = _Means()
    mod.forward_fp(fp_params, spec, x, taps=fp)
    cur, before = params, []
    for name, bpath in sites:
        shift = fp.means[name] - q_means(cur, name)[name]
        cur = _set(cur, bpath, _get(cur, bpath) + shift)
        before.append(torch.abs(shift).to(F64).mean())
    q = q_means(cur)
    after = [torch.abs(fp.means[name] - q[name]).to(F64).mean()
             for name, _ in sites]
    values = torch.stack([torch.stack(before), torch.stack(after)], 1)
    return cur, {name: tuple(v) for (name, _), v in
                 zip(sites, values.to(F32).cpu().tolist())}

"""AdaRound: learned rounding of the PoT weight grids (counterpart of
``diffvit_tpu/calib/adaround.py``; Nagel et al., "Up or Down? Adaptive
Rounding for Post-Training Quantization", ICML 2020).

Per weight site, a binary up/down rounding decision is learned that
minimizes the site's output error on calibration data:

* the soft rounding h = clip(1.2 * sigmoid(v) - 0.1, 0, 1) starts where
  h(v0) is the weight's fraction on its grid, and the annealed regularizer
  sum(1 - |2h - 1|^beta) is off for the warm-up, then beta falls from 20
  to 2; Adam in optax's order (``calib/optim.py``), one Python step a
  step (the JAX package runs one jitted ``fori_loop``);
* the objective is the asymmetric reconstruction ``|| Xq @ W_soft.T - Xf
  @ W.T ||^2``: the quantized path's input against the float path's
  target, both on the same subsample of at most ``max_rows`` rows, drawn
  by ``np.random.default_rng(seed)`` as the JAX package draws them;
* sites are reconstructed in forward order, each with its quantized-path
  input refreshed from the partly reconstructed model; the float inputs
  are collected once;
* the result is a weight pytree whose every weight is ``scale * codes``
  (divided back by the SmoothQuant channel scale at qkv and fc1), so
  ``forward_q``, ``prepare_int`` and the artifact re-round it to the
  learned codes bit for bit.

The float products are taken in float64 and rounded once, as everywhere
in the port, so the card learns the CPU's codes; the JAX package's are
float32 XLA products, so a borderline weight may round the other way.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import QuantConfig
from ..models import swin, vit
from ..models.vit import _linear
from ..ops.bit_types import BIT_TYPE_DICT
from ..ops.quant import clip_ties, fake_quant
from .optim import Adam

F32, F64 = torch.float32, torch.float64


def _mse(x, w, target):
    """mean((x @ w.T - target)^2), the mean in float64, rounded once."""
    d = (_linear(x, w) - target).to(F64)
    return (d * d).mean().to(F32)


def _h(v):
    """The soft rounding, its clip's gradient split at 0 and 1 as
    ``jnp.clip``'s."""
    return clip_ties(1.2 * torch.sigmoid(v) - 0.1, 0.0, 1.0)


def _schedule(steps: int, warm: int, beta0: float, beta1: float, device):
    """(beta, regularizer on) a step, as float32 device tensors: beta
    anneals from ``beta0`` to ``beta1`` after ``warm`` steps, before which
    the regularizer is off."""
    i = np.arange(steps)
    t = np.clip((i - warm).astype(np.float32)
                / np.float32(max(steps - warm, 1)), 0.0, 1.0)
    beta = np.float32(beta0) + np.float32(beta1 - beta0) * t
    return (torch.tensor(beta.astype(np.float32), device=device),
            torch.tensor((i >= warm).astype(np.float32), device=device))


def _optimize_site(Xq, Xf, Wt, floor, s_b, lb, ub, steps, lr, lam, beta0,
                   beta1, warm):
    """Minimize mean((Xq @ W_soft.T - Xf @ Wt.T)^2) + lam * f_reg(h) over
    the rounding logits v.  ``floor``: floor(Wt / s); ``s_b``: the scale
    broadcast to Wt's shape.  Returns (the hard-rounded weight, the site
    mse with nearest rounding, the site mse with the learned rounding),
    the mses as float32 device scalars."""
    frac = torch.clamp(Wt / s_b - floor, 0.0, 1.0)
    v = -torch.log(torch.full_like(frac, 1.2) / (frac + 0.1) - 1.0)
    target = _linear(Xf, Wt)
    betas, reg_on = _schedule(steps, warm, beta0, beta1, Wt.device)
    v.requires_grad_(True)
    adam = Adam(v, lr, steps)
    for i in range(steps):
        w_soft = clip_ties(floor + _h(v), lb, ub) * s_b
        reg = torch.sum(1.0 - torch.abs(2.0 * _h(v) - 1.0) ** betas[i])
        loss = _mse(Xq, w_soft, target) + reg_on[i] * lam * reg
        adam.step(torch.autograd.grad(loss, v)[0])
    with torch.no_grad():
        codes = torch.clamp(floor + (_h(v) > 0.5).to(F32), lb, ub)
        w_hard = codes * s_b
        w_near = torch.clamp(torch.round(Wt / s_b), lb, ub) * s_b
        return w_hard, _mse(Xq, w_near, target), _mse(Xq, w_hard, target)


def _rows(xq, xf, k, max_rows, rng):
    """Both inputs flattened to (-1, k), the same rows subsampled (at most
    ``max_rows``, drawn by the numpy generator ``rng``)."""
    fq, ff = xq.reshape(-1, k), xf.reshape(-1, k)
    if fq.shape != ff.shape:
        raise ValueError(f"site inputs differ in shape: {tuple(fq.shape)} "
                         f"against {tuple(ff.shape)}")
    if fq.shape[0] > max_rows:
        idx = torch.as_tensor(rng.choice(fq.shape[0], size=max_rows,
                                         replace=False), device=fq.device)
        fq, ff = fq[idx], ff[idx]
    return fq, ff


def _vit_sites(spec, bit_config):
    """(w_in_taps name, params path, qparam weight-scale prefix, smooth?,
    bit) per weight site, in forward order."""
    sites = [("patch", ("patch_embed", "w"), "patch.w", False,
              bit_config[0])]
    for i in range(spec.depth):
        p = f"blocks.{i}"
        sites += [
            (f"{p}.attn.qkv", ("blocks", i, "qkv", "w"),
             f"{p}.attn.qkv", True, bit_config[4 * i + 1]),
            (f"{p}.attn.proj", ("blocks", i, "proj", "w"),
             f"{p}.attn.proj.w", False, bit_config[4 * i + 2]),
            (f"{p}.mlp.fc1", ("blocks", i, "fc1", "w"),
             f"{p}.mlp.fc1", True, bit_config[4 * i + 3]),
            (f"{p}.mlp.fc2", ("blocks", i, "fc2", "w"),
             f"{p}.mlp.fc2.w", False, bit_config[4 * i + 4]),
        ]
    sites.append(("head", ("head", "w"), "head.w", False, bit_config[-1]))
    return sites


def _swin_sites(spec, bc):
    """(w_in_taps name, params path, qparam weight-scale prefix, bit) per
    Swin weight site in forward order: the patch, four a block, each
    stage's reduction, the head (every one plain: no SmoothQuant)."""
    sites = [("patch", ("patch_embed", "proj", "w"), "patch.w", bc[0])]
    slot = 1
    for s in range(spec.num_layers):
        for bi in range(spec.depths[s]):
            p = f"layers.{s}.blocks.{bi}"
            base = ("layers", s, "blocks", bi)
            sites += [
                (f"{p}.attn.qkv", base + ("qkv", "w"),
                 f"{p}.attn.qkv.w", bc[slot]),
                (f"{p}.attn.proj", base + ("proj", "w"),
                 f"{p}.attn.proj.w", bc[slot + 1]),
                (f"{p}.mlp.fc1", base + ("fc1", "w"),
                 f"{p}.mlp.fc1.w", bc[slot + 2]),
                (f"{p}.mlp.fc2", base + ("fc2", "w"),
                 f"{p}.mlp.fc2.w", bc[slot + 3]),
            ]
            slot += 4
        if s < spec.num_layers - 1:
            sites.append((f"layers.{s}.downsample.reduction",
                          ("layers", s, "downsample", "reduction", "w"),
                          f"layers.{s}.downsample.reduction.w", bc[slot]))
            slot += 1
    sites.append(("head", ("head", "w"), "head.w", bc[slot]))
    return sites


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value):
    """``tree`` with the leaf at ``path`` replaced: the dicts and lists on
    the path copied, everything else shared."""
    if not path:
        return value
    head, rest = path[0], path[1:]
    out = dict(tree) if isinstance(tree, dict) else list(tree)
    out[head] = _set(tree[head], rest, value)
    return out


class SiteTap:
    """A ``taps`` / ``w_in_taps`` list for the forwards that keeps only
    the tensor named ``name`` (the last one appended under it), so that a
    refreshed forward holds one site's tensor, not every site's."""

    def __init__(self, name):
        self.name, self.value = name, None

    def append(self, pair):
        if pair[0] == self.name:
            self.value = pair[1]


def _site_input(forward, name):
    tap = SiteTap(name)
    with torch.no_grad():
        forward(tap)
    return tap.value


def _fp_inputs(mod, params, spec, x):
    """Every weight site's float-path input, from one float forward."""
    taps = []
    with torch.no_grad():
        mod.forward_fp(params, spec, x, w_in_taps=taps)
    return dict(taps)


def _report(found):
    """{site: (mse before, mse after)} as floats, read from the device at
    once."""
    if not found:
        return {}
    values = torch.stack([torch.stack(v) for v in found.values()])
    return {name: tuple(v) for name, v in zip(found, values.cpu().tolist())}


def _reconstruct(Xq, Xf, Wt, s, bt, rng, max_rows, steps, lr, lam,
                 beta_range, warm):
    s_b = (s[:, None] if s.dim() == 1 else s).to(Wt.dtype).expand(Wt.shape)
    Xq_r, Xf_r = _rows(Xq, Xf, Wt.shape[1], max_rows, rng)
    return _optimize_site(Xq_r, Xf_r, Wt, torch.floor(Wt / s_b), s_b,
                          float(bt.lower_bound), float(bt.upper_bound),
                          steps, lr, lam, beta_range[0], beta_range[1], warm)


def adaround_swin(params, qp, spec, cfg: QuantConfig, x, bit=None, *,
                  steps=1000, lr=1e-2, lam=0.01, beta_range=(20.0, 2.0),
                  warmup=0.2, max_rows=2048, seed=0, fp_params=None):
    """Learned-rounding reconstruction of every quantized Swin weight site
    (``swin.normalize_bit_config``'s slots; -1 sites are skipped).  Same
    protocol as :func:`adaround_vit`; every Swin site is plain (its
    quantized-path input is already fake-quantized upstream)."""
    bc = swin.normalize_bit_config(spec, bit if bit is not None
                                   else cfg.bit_w.bits)
    qp = vit.autograd_safe(qp)
    fp_in = _fp_inputs(swin, fp_params if fp_params is not None else params,
                       spec, x)
    rng = np.random.default_rng(seed)
    warm = int(round(steps * warmup))

    cur, found = params, {}
    for name, ppath, spre, bit_w in _swin_sites(spec, bc):
        if bit_w == -1:
            continue
        y_q = _site_input(lambda t, cur=cur: swin.forward_q(
            cur, qp, spec, cfg, x, bc, w_in_taps=t), name)
        w = _get(params, ppath)
        bt = BIT_TYPE_DICT[f"int{bit_w}"]
        w_hard, mse0, mse1 = _reconstruct(
            y_q, fp_in[name], w, qp[f"{spre}.{bt.name}.scale"], bt, rng,
            max_rows, steps, lr, lam, beta_range, warm)
        cur = _set(cur, ppath, w_hard)
        found[name] = (mse0, mse1)
    return cur, _report(found)


def adaround_vit(params, qp, spec, cfg: QuantConfig, x, bit_config=None, *,
                 steps=1000, lr=1e-2, lam=0.01, beta_range=(20.0, 2.0),
                 warmup=0.2, max_rows=2048, seed=0, fp_params=None):
    """Learned-rounding reconstruction of every quantized ViT/DeiT weight
    site at ``bit_config`` (-1 sites are skipped).  ``x``: the
    reconstruction batch (float32, on the params' device).  Returns
    ``(new_params, report)``, report mapping each site to (its mse with
    nearest rounding, with the learned rounding), both against the float
    path's target.  ``fp_params``: the float pytree that anchors the
    targets when ``params`` was already reconstructed."""
    if bit_config is None:
        bit_config = (cfg.bit_w.bits,) * vit.num_bit_slots(spec)
    bit_config = tuple(int(b) for b in bit_config)
    qp = vit.autograd_safe(qp)
    fp_in = _fp_inputs(vit, fp_params if fp_params is not None else params,
                       spec, x)
    rng = np.random.default_rng(seed)
    warm = int(round(steps * warmup))

    cur, found = params, {}
    for name, ppath, spre, smooth, bit in _vit_sites(spec, bit_config):
        if bit == -1:  # the site runs in float: nothing to round
            continue
        # the quantized path's input from the partly reconstructed model
        y_q = _site_input(lambda t, cur=cur: vit.forward_q(
            cur, qp, spec, cfg, x, bit_config, w_in_taps=t), name)
        y_f = fp_in[name]
        w = _get(params, ppath)
        bt = BIT_TYPE_DICT[f"int{bit}"]
        ch = None
        with torch.no_grad():
            if smooth and cfg.smoothquant:
                idx = cfg.bit_pool.index(bit)
                ch = qp[f"{spre}.sq.channel_scale"][idx]
                Wt = w * ch
                Xq = fake_quant(y_q / ch, qp[f"{spre}.qact0.scale"][idx],
                                qp[f"{spre}.qact0.zp"][idx], cfg.bit_a)
                Xf = y_f / ch  # the float branch in the smoothed frame
                s = qp[f"{spre}.w.{bt.name}.scale"][idx]
            elif smooth:  # SmoothQuant off: a plain linear with its qact0
                Xq = fake_quant(y_q, qp[f"{spre}.qact0.scale"],
                                qp[f"{spre}.qact0.zp"], cfg.bit_a)
                Xf, Wt, s = y_f, w, qp[f"{spre}.w.{bt.name}.scale"]
            else:  # already fake-quantized by its fence
                Xq, Xf, Wt, s = y_q, y_f, w, qp[f"{spre}.{bt.name}.scale"]
        w_hard, mse0, mse1 = _reconstruct(Xq, Xf, Wt, s, bt, rng, max_rows,
                                          steps, lr, lam, beta_range, warm)
        if ch is not None:
            w_hard = w_hard / ch  # back to the unsmoothed parameter
        cur = _set(cur, ppath, w_hard)
        found[name] = (mse0, mse1)
    return cur, _report(found)

"""Calibration observers as functions of tensors (counterpart of
``diffvit_tpu/calib/observers.py``): each takes the calibration tensor
(and optional running statistics) and returns ``(scale, zero_point)`` as
float32 tensors on its device.

* Weights are always quantized symmetrically (zp = 0), the unsigned bit
  types included, as in the reference.
* The minmax PoT search scores the 4 candidate exponents floor(log2 s) - 1
  .. + 2 by the L2 error of the layer's output (weights; per output
  channel where channel-wise) or of the tensor itself (activations); the
  4 candidates go through one batched product or one batched pass.  PTF
  scores its 4 channel factors the same way.

Exactness, so that the card and the CPU pick the same scales:

* the candidates' errors are summed in float64 (the layer output's error
  ``X @ (wq - w).T`` is one float64 product), and ``torch.argmin`` takes the
  first minimum, as ``jnp.argmin`` does; the reference's float32 means
  differ from them only in their rounding, so a candidate flips only at a
  near-tie;
* powers of two and ``floor(log2 ·)`` come from exponent bits
  (``ops.quant.exp2``, ``round_ln``);
* the reference divides by a Python constant inside ``jax.jit``, which XLA
  compiles to a multiply by the float32 reciprocal; the port multiplies by
  that reciprocal on every device (``_times_rcp``), where CUDA torch's own
  division by a Python number would take another path;
* the reference's XLA contracts ``a + c * (b - a)`` (the EMA update) and
  ``1 - i * 0.01`` (OMSE's shrink) into one fused multiply-add; the port
  takes them in float64 and rounds once.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.bit_types import BitType
from ..ops.quant import exp2, fake_quant, round_ln

F32, F64 = torch.float32, torch.float64
_EPS = float(np.finfo(np.float32).eps)
_POT_OFFSETS = (-1.0, 0.0, 1.0, 2.0)  # the candidate exponents' offsets


def _times_rcp(x, d):
    """``x / d`` for a Python constant ``d`` as the reference's jitted XLA
    computes it: ``x`` times the float32 reciprocal of ``d``."""
    return x * x.new_tensor(np.float32(1.0) / np.float32(d))


def _eps_max(s):
    return torch.maximum(s, s.new_tensor(_EPS))


# ---------------------------------------------------------------------------
# Statistics
# ---------------------------------------------------------------------------

def weight_minmax(w2d, channel_wise: bool):
    """w2d: the weight as (Cout, K).  Per-channel (or scalar) max and min."""
    mx, mn = w2d.amax(1), w2d.amin(1)
    if not channel_wise:
        mx, mn = mx.amax(), mn.amin()
    return mx, mn


def act_minmax(x, channel_wise: bool):
    """x: activation (..., C).  Per-channel max/min over every leading
    axis; layer-wise collapses to scalars."""
    flat = x.reshape(-1, x.shape[-1])
    mx, mn = flat.amax(0), flat.amin(0)
    if not channel_wise:
        mx, mn = mx.amax(), mn.amin()
    return mx, mn


def _symmetric_base_scale(mx, mn, bit_type: BitType):
    """max(|min|, max) / ((qmax - qmin) / 2)."""
    m = torch.maximum(-mn, mx)
    return _times_rcp(m, (bit_type.upper_bound - bit_type.lower_bound) / 2.0)


def _quantile(x, q: float):
    """``jnp.quantile(x.reshape(-1), q)`` (method "linear") in the
    reference's float32 steps: pos = q * (n - 1), the two order statistics
    around it, weighted by pos - floor(pos).  The order statistics come
    from ``kthvalue``, which takes a tensor of any size (``torch.quantile``
    refuses more than 2^24 elements)."""
    flat = x.reshape(-1)
    n = flat.numel()
    pos = np.float32(q) * (np.float32(n) - np.float32(1))
    low, high = math.floor(pos), math.ceil(pos)
    hw = np.float32(pos - np.float32(low))
    lw = np.float32(np.float32(1) - hw)
    lo = torch.kthvalue(flat, min(max(low, 0), n - 1) + 1).values
    hi = torch.kthvalue(flat, min(max(high, 0), n - 1) + 1).values
    return (lo.to(F64) * float(lw) + hi.to(F64) * float(hw)).to(F32)


# ---------------------------------------------------------------------------
# Minmax with the PoT output-aware exponent search (the P2-ViT core)
# ---------------------------------------------------------------------------

def _pot_candidates(af):
    """(4, *af.shape) candidate scales 2^(af + offset)."""
    off = af.new_tensor(_POT_OFFSETS).reshape((4,) + (1,) * af.dim())
    return exp2(af + off)


def _pot_choice(af, score):
    """The scale of the least score along axis 0 (the first on a tie)."""
    alpha = af - 1.0 + torch.argmin(score, 0).to(af.dtype)
    return _eps_max(exp2(alpha))


def minmax_weight_qparams(w2d, x_in, bit_type: BitType, channel_wise: bool):
    """Scale/zp of a weight site by the minmax + PoT output search.

    w2d:  (Cout, K) weight (the patch conv flattened to K = 3*ps*ps).
    x_in: (..., K) the layer's calibration input.
    Returns (scale, zero_point); scale (Cout,) if channel_wise else ().
    The bias cancels in the output difference."""
    mx, mn = weight_minmax(w2d, channel_wise)
    af = round_ln(_symmetric_base_scale(mx, mn, bit_type), "floor")
    s = _pot_candidates(af)
    s_b = s[..., None] if channel_wise else s[:, None, None]
    dw = fake_quant(w2d, s_b, 0.0, bit_type).to(F64) - w2d.to(F64)
    x = x_in.reshape(-1, w2d.shape[1]).to(F64)
    err = torch.matmul(x, dw.transpose(1, 2))  # (4, rows, Cout)
    err = err * err
    score = err.sum(1) if channel_wise else err.sum((1, 2))
    scale = _pot_choice(af, score)
    return scale, torch.zeros_like(scale)


def make_attn_replay(num_heads: int, dim: int, scale: float):
    """The observer's attention replay: treat the tensor as a (B, N, 3C)
    qkv output, replay heads-split q @ k^T * scale -> float softmax -> @ v
    (float64, rounded once to float32), and score the PoT candidate through
    that output."""

    def replay(x):
        b, n, _ = x.shape
        hd = dim // num_heads
        qkv = x.reshape(b, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0].to(F64), qkv[1].to(F64), qkv[2].to(F64)
        attn = torch.matmul(q, k.transpose(-1, -2)).to(F32) * scale
        attn = torch.softmax(attn.to(F64), dim=-1).to(F32).to(F64)
        out = torch.matmul(attn, v).to(F32)
        return out.permute(0, 2, 1, 3).reshape(b, n, dim)

    return replay


def _sq_err(a, b):
    d = a.to(F64) - b.to(F64)
    return (d * d).sum()


def minmax_act_qparams(x, bit_type: BitType, attn_replay=None, stats=None):
    """Scale/zp of an activation site (layer-wise, symmetric) by minmax +
    the PoT search scoring the (optionally attention-replayed) tensor
    itself.  ``stats``: running (max, min) of earlier batches; the
    candidates are always scored on ``x``."""
    mx, mn = stats if stats is not None else act_minmax(x, False)
    af = round_ln(_symmetric_base_scale(mx, mn, bit_type), "floor")
    s = _pot_candidates(af)
    if attn_replay is None:
        xq = fake_quant(x[None], s.reshape((4,) + (1,) * x.dim()), 0.0,
                        bit_type)
        d = xq.to(F64) - x.to(F64)
        score = (d * d).flatten(1).sum(1)
    else:
        ref = attn_replay(x)
        score = torch.stack([_sq_err(attn_replay(fake_quant(
            x, s[i], 0.0, bit_type)), ref) for i in range(4)])
    scale = _pot_choice(af, score)
    return scale, torch.zeros_like(scale)


def minmax_act_qparams_asymmetric(x, bit_type: BitType, stats=None):
    """The uint8 asymmetric QAct path: scale = (max - min) / (qmax - qmin),
    zp = clamp(qmin - round(min / scale)), then the 4-candidate PoT search
    scoring the fake-quant with that zero point."""
    mx, mn = stats if stats is not None else act_minmax(x, False)
    qmax, qmin = bit_type.upper_bound, bit_type.lower_bound
    base = _eps_max(_times_rcp(mx - mn, float(qmax - qmin)))
    zp = torch.clamp(qmin - torch.round(mn / base), qmin, qmax)
    af = round_ln(base, "floor")
    s = _pot_candidates(af)
    xq = fake_quant(x[None], s.reshape((4,) + (1,) * x.dim()), zp, bit_type)
    d = xq.to(F64) - x.to(F64)
    return _pot_choice(af, (d * d).flatten(1).sum(1)), zp


# ---------------------------------------------------------------------------
# EMA / percentile observers (plain scales, no PoT)
# ---------------------------------------------------------------------------

def _plain_symmetric(mx, mn, bit_type: BitType):
    scale = _eps_max(_symmetric_base_scale(mx, mn, bit_type))
    return scale, torch.zeros_like(scale)


def ema_act_qparams(x, bit_type: BitType, stats=None):
    mx, mn = stats if stats is not None else act_minmax(x, False)
    return _plain_symmetric(mx, mn, bit_type)


def percentile_act_qparams(x, bit_type: BitType, alpha: float = 0.99999,
                           stats=None):
    if stats is not None:
        mx, mn = stats
    else:
        mx, mn = _quantile(x, alpha), _quantile(x, 1.0 - alpha)
    return _plain_symmetric(mx, mn, bit_type)


# ---------------------------------------------------------------------------
# OMSE (90-step range shrink minimizing the L2 error; always the
# asymmetric scale/zp formula, even for signed types)
# ---------------------------------------------------------------------------

def omse_act_qparams(x, bit_type: BitType, stats=None):
    mx, mn = stats if stats is not None else act_minmax(x, False)
    qmax, qmin = bit_type.upper_bound, bit_type.lower_bound
    i = torch.arange(90, dtype=F64, device=x.device)
    shrink = (1.0 - i * float(np.float32(0.01))).to(F32)
    scales, zps, scores = [], [], []
    for k in range(90):
        new_max, new_min = mx * shrink[k], mn * shrink[k]
        scale = _eps_max(_times_rcp(new_max - new_min, float(qmax - qmin)))
        zp = torch.clamp(qmin - torch.round(new_min / scale), qmin, qmax)
        scales.append(scale)
        zps.append(zp)
        scores.append(_sq_err(fake_quant(x, scale, zp, bit_type), x))
    # the reference keeps the first strict minimum below its initial 1e10
    best = torch.argmin(torch.stack(scores))
    found = torch.stack(scores)[best] < 1e10 * x.numel()
    scale = torch.where(found, torch.stack(scales)[best], 1.0)
    zp = torch.where(found, torch.stack(zps)[best], 0.0)
    return scale, zp


# ---------------------------------------------------------------------------
# PTF (the Power-of-Two-Factor observer of FQ-ViT for LayerNorm inputs):
# one global symmetric base scale (not PoT-rounded) and a per-channel
# factor in {1, 2, 4, 8}
# ---------------------------------------------------------------------------

def ptf_act_qparams(x, bit_type: BitType, stats=None):
    """x: (..., C).  Returns (scale (C,), zero_point scalar 0): scale =
    scale1 * mask, scale1 = scale8 / 8, the mask chosen per channel among
    {1, 2, 4, 8} by the L2 quantization error."""
    qmax, qmin = bit_type.upper_bound, bit_type.lower_bound
    flat = x.reshape(-1, x.shape[-1])
    if stats is not None:
        max_t = torch.maximum(-stats[1].amin(), stats[0].amax())
    else:
        max_t = torch.maximum(-flat.amin(), flat.amax())
    scale8 = _eps_max(_times_rcp(2.0 * max_t, float(qmax - qmin)))
    scale1 = scale8 / 8.0
    s = scale1 * flat.new_tensor([1.0, 2.0, 4.0, 8.0])
    xq = fake_quant(flat[None], s[:, None, None], 0.0, bit_type)
    d = flat.to(F64) - xq.to(F64)
    idx = torch.argmin((d * d).sum(1), 0)  # (C,)
    return scale1 * exp2(idx.to(F32)), flat.new_zeros(())


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

ACT_OBSERVERS = {
    "minmax": minmax_act_qparams,
    "ema": ema_act_qparams,
    "omse": omse_act_qparams,
    "percentile": percentile_act_qparams,
    "ptf": ptf_act_qparams,
}


def act_qparams(observer: str, x, bit_type: BitType, attn_replay=None,
                stats=None):
    """(scale, zp) of an activation site with the named observer.  Only
    minmax takes ``attn_replay``; ``stats``: running observation state of
    earlier batches (multi-batch calibration)."""
    if observer == "minmax":
        return minmax_act_qparams(x, bit_type, attn_replay=attn_replay,
                                  stats=stats)
    return ACT_OBSERVERS[observer](x, bit_type, stats=stats)


def act_stats_update(observer: str, state, x, percentile_alpha=0.99999):
    """Multi-batch observation state: minmax/omse running max/min, ptf
    running per-channel max/min, ema an EMA of the max/min (sigma 0.01),
    percentile an EMA of the quantiles."""
    if observer in ("minmax", "omse", "ema"):
        mx, mn = act_minmax(x, False)
    elif observer == "ptf":
        mx, mn = act_minmax(x, True)
    elif observer == "percentile":
        mx = _quantile(x, percentile_alpha)
        mn = _quantile(x, 1.0 - percentile_alpha)
    else:
        raise KeyError(observer)
    if state is None:
        return (mx, mn)
    if observer in ("ema", "percentile"):
        c = float(np.float32(0.01))
        return tuple((s.to(F64) + c * (v - s).to(F64)).to(F32)
                     for s, v in ((state[0], mx), (state[1], mn)))
    return (torch.maximum(state[0], mx), torch.minimum(state[1], mn))

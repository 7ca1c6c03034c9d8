"""ViT/DeiT: specs, parameters, the float forward, post-training
calibration and the fake-quant forward (counterpart of
``diffvit_tpu/models/vit.py``), as functions of tensors over a params dict
with the JAX pytree's keys:

* ``init_params(spec, generator, device)`` and ``params_from_numpy``;
* ``forward_fp(params, spec, x)``, the float forward;
* ``calibrate(params, spec, cfg, x)`` and ``calibrate_batches``: every
  quantization parameter (observer scales, PoT exponents, SmoothQuant
  channel scales, per-bit weight scales) as the flat ``{path: tensor}``
  dict under the reference's key names, and the per-linear per-bit weight
  distances (``global_distance``);
* ``forward_q(params, qp, spec, cfg, x, bit_config)``, the fake-quant
  forward, ``bit_config`` in {4, 8, -1} per slot.

Exactness, so that calibration on the card equals calibration on the CPU:
every float product (the linears, q @ k^T, attn @ v) and the float
LayerNorm, the exact GELU and the float softmax are taken in float64 and
rounded once to float32 (the reference's float32 values depend on the
order of their sums); the LIS is the port's exact one (``ops.lis``); the
observers' rules are in ``calib/observers.py``.  Against the reference
they agree within an ulp, and the scale a calibration picks differs only
where a candidate's score is within that of another.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..calib.observers import (act_qparams, act_stats_update,
                               minmax_act_qparams_asymmetric,
                               minmax_weight_qparams)
from ..config import QuantConfig
from ..ops.bit_types import BIT_TYPE_DICT, CALIB_WEIGHT_BIT_TYPES, BitType
from ..ops.int_layernorm import float_layernorm, int_layernorm
from ..ops.lis import log_int_softmax
from ..ops.quant import exp2, fake_quant, round_ln

F32, F64 = torch.float32, torch.float64
_SQRT_HALF = float(np.float32(np.sqrt(0.5)))  # the reference's constant


@dataclasses.dataclass(frozen=True)
class ViTSpec:
    name: str
    embed_dim: int
    depth: int
    num_heads: int
    patch_size: int = 16
    img_size: int = 224
    mlp_ratio: int = 4
    num_classes: int = 1000
    input_quant: bool = True
    ln_eps: float = 1e-6
    drop_path_rate: float = 0.0

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def attn_scale(self) -> float:
        return self.head_dim ** -0.5

    @property
    def hidden_dim(self) -> int:
        return self.embed_dim * self.mlp_ratio


VIT_SPECS = {
    "deit_tiny": ViTSpec("deit_tiny", 192, 12, 3),
    "deit_small": ViTSpec("deit_small", 384, 12, 6),
    "deit_base": ViTSpec("deit_base", 768, 12, 12),
    "vit_base": ViTSpec("vit_base", 768, 12, 12),
    "vit_large": ViTSpec("vit_large", 1024, 24, 16, input_quant=False),
}


def num_bit_slots(spec: ViTSpec) -> int:
    return 4 * spec.depth + 2


def flops_list(spec: ViTSpec):
    """Static per-layer MAC counts: the patch conv, 4 linears a block, the
    head (4 * depth + 2 entries)."""
    c, n = spec.embed_dim, spec.seq_len
    g = spec.img_size // spec.patch_size
    fl = [3 * spec.patch_size**2 * c * g * g]
    for _ in range(spec.depth):
        fl += [n * c * 3 * c, n * c * c, n * c * spec.hidden_dim,
               n * spec.hidden_dim * c]
    fl.append(c * spec.num_classes)
    return fl


def patchify(x: torch.Tensor, spec: ViTSpec) -> torch.Tensor:
    """NCHW image -> (B, num_patches, 3*ps*ps) patches flattened in
    (Cin, kh, kw) order, so the patch conv is exactly patches @ W.T + b."""
    b = x.shape[0]
    g, p = spec.img_size // spec.patch_size, spec.patch_size
    x = x.reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, g * g, 3 * p * p)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(spec: ViTSpec, generator: torch.Generator, device="cuda"):
    """Random parameters in the reference's layout and distributions:
    weights (out, in) and the cls/pos tokens from a normal of std 0.02
    truncated at +-2 std, zero biases, unit LayerNorm weights.  The patch
    conv is stored flattened as (embed_dim, 3*ps*ps).  Drawn on the CPU
    from ``generator`` (a CPU generator), in the reference's order, then
    moved to ``device``: the same seed gives the same parameters on every
    device."""
    c, hd = spec.embed_dim, spec.hidden_dim

    def tn(*shape):
        t = torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, 1.0, -2.0,
                                        2.0, generator=generator)
        return (0.02 * t).to(device)

    def lin(cout, cin):
        return {"w": tn(cout, cin), "b": torch.zeros(cout, device=device)}

    def ln():
        return {"w": torch.ones(c, device=device),
                "b": torch.zeros(c, device=device)}

    params = {"cls_token": tn(1, 1, c), "pos_embed": tn(1, spec.seq_len, c),
              "patch_embed": lin(c, 3 * spec.patch_size**2)}
    params["head"] = lin(spec.num_classes, c)
    params["norm"] = ln()
    params["blocks"] = [{"norm1": ln(), "qkv": lin(3 * c, c),
                         "proj": lin(c, c), "norm2": ln(),
                         "fc1": lin(hd, c), "fc2": lin(c, hd)}
                        for _ in range(spec.depth)]
    return params


def params_from_numpy(tree, device="cuda"):
    """A float parameter pytree of numpy arrays (the JAX package's params
    through ``jax.device_get``, or loaded from disk), or of tensors on any
    device, as float32 tensors on ``device``, dicts, lists and None (a
    Swin reduction's bias, an absent patch norm) kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(tree, np.float32), device=device)


# ---------------------------------------------------------------------------
# Float pieces, each rounded once to float32
# ---------------------------------------------------------------------------

def _linear(x, w, b=None):
    """``x @ w.T + b`` summed in float64, rounded once to float32."""
    y = torch.matmul(x.to(F64), w.to(F64).T)
    if b is not None:
        y = y + b.to(F64)
    return y.to(F32)


def gelu_exact(y):
    """The exact-erf GELU in the reference's form, ``0.5 * y * erfc(-y *
    sqrt(1/2))`` (``jax.nn.gelu(approximate=False)``), in float64 and
    rounded once to float32: ``erfc`` differs by an ulp between XLA, CPU
    torch and CUDA in float32."""
    yd = y.to(F64)
    return (0.5 * yd * torch.special.erfc(-yd * _SQRT_HALF)).to(F32)


def _softmax(a):
    return torch.softmax(a.to(F64), dim=-1).to(F32)


def _sdpa(qkv, spec: ViTSpec, softmax_fn):
    """qkv (B, N, 3C) -> attention output (B, N, C) and the weights."""
    b, n, _ = qkv.shape
    h, d = spec.num_heads, spec.head_dim
    t = qkv.reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
    q, k, v = t[0].to(F64), t[1].to(F64), t[2].to(F64)
    attn = torch.matmul(q, k.transpose(-1, -2)).to(F32) * spec.attn_scale
    attn = softmax_fn(attn)
    out = torch.matmul(attn.to(F64), v).to(F32)
    return out.permute(0, 2, 1, 3).reshape(b, n, h * d), attn


def _float_ln(h, ln, spec: ViTSpec):
    return float_layernorm(h, ln["w"], ln["b"], spec.ln_eps)


def _embed_tokens(params, spec: ViTSpec, h):
    cls = params["cls_token"].expand(h.shape[0], 1, spec.embed_dim)
    return torch.cat([cls, h], dim=1)


def forward_fp(params, spec: ViTSpec, x):
    """The float forward: (B, 3, H, W) float32 -> (B, classes) logits."""
    pe = params["patch_embed"]
    h = _linear(patchify(x, spec), pe["w"], pe["b"])
    h = _embed_tokens(params, spec, h) + params["pos_embed"]
    for blk in params["blocks"]:
        y = _linear(_float_ln(h, blk["norm1"], spec), blk["qkv"]["w"],
                    blk["qkv"]["b"])
        y, _ = _sdpa(y, spec, _softmax)
        h = h + _linear(y, blk["proj"]["w"], blk["proj"]["b"])
        y = gelu_exact(_linear(_float_ln(h, blk["norm2"], spec),
                               blk["fc1"]["w"], blk["fc1"]["b"]))
        h = h + _linear(y, blk["fc2"]["w"], blk["fc2"]["b"])
    h = _float_ln(h, params["norm"], spec)[:, 0]
    return _linear(h, params["head"]["w"], params["head"]["b"])


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

def _smoothquant_channel_scale(x, w, alpha):
    """PoT-rounded SmoothQuant channel scale, 2^round_ln(max|x|^alpha /
    max|w|^(1-alpha)).  Each power is taken in float64 and rounded once to
    float32 at the reference's float32 exponents (``powf`` differs by an
    ulp between devices)."""
    gmax = torch.abs(x).reshape(-1, x.shape[-1]).amax(0)
    wmax = torch.abs(w).amax(0)
    a1, a2 = float(np.float32(alpha)), float(np.float32(1.0 - alpha))
    cs = torch.pow(gmax.to(F64), a1).to(F32) / torch.pow(wmax.to(F64),
                                                          a2).to(F32)
    return exp2(round_ln(cs))


def _wq(w, s, bt: BitType):
    """Fake-quant of a (Cout, K) weight at a per-channel or scalar scale."""
    return fake_quant(w, s[:, None] if s.dim() == 1 else s, 0.0, bt)


def _wdist(w, s, bt: BitType):
    """mean((w - fq(w))^2), summed in float64, rounded once."""
    d = w.to(F64) - _wq(w, s, bt).to(F64)
    return (d * d).mean().to(F32)


def _calib_weight_site(qp, dist, path, w2d, x_in, cfg: QuantConfig,
                       record_distance=True):
    """The per-bit weight scale sweep: bit types [uint3, uint4, int4, int8],
    int8 layer-wise, the others channel-wise, always symmetric.  Stores
    ``{path}.{bit}.scale`` and appends the per-bit L2 weight errors to
    ``dist``."""
    d = []
    for bt in CALIB_WEIGHT_BIT_TYPES:
        scale, _ = minmax_weight_qparams(w2d, x_in, bt, bt.name != "int8")
        d.append(_wdist(w2d, scale, bt))
        qp[f"{path}.{bt.name}.scale"] = scale
    if record_distance:
        dist.append(d)


def _calib_act_site(qp, path, x, cfg: QuantConfig, observer=None,
                    bit_type=None, stats=None, asymmetric=False):
    """Observe and finalize an activation site; returns ``x`` unchanged.
    ``stats``: the running observation state of earlier batches (keyed by
    path).  ``asymmetric``: the uint8 QAct with a nonzero zero point."""
    if asymmetric:
        prior = None
        if stats is not None and path in stats:
            prior = act_stats_update("minmax", stats[path], x)
        scale, zp = minmax_act_qparams_asymmetric(
            x, BIT_TYPE_DICT["uint8"], stats=prior)
    else:
        observer = observer or cfg.observer_a
        prior = None
        if stats is not None and path in stats:
            prior = act_stats_update(observer, stats[path], x)
        scale, zp = act_qparams(observer, x, bit_type or cfg.bit_a,
                                stats=prior)
    qp[f"{path}.scale"] = scale
    qp[f"{path}.zp"] = zp
    return x


def _observe_act_site(states, path, x, cfg: QuantConfig, observer=None):
    """Stats-only update of a multi-batch observation pass."""
    observer = observer or cfg.observer_a
    states[path] = act_stats_update(observer, states.get(path), x)
    return x


def _calib_smooth_linear(qp, dist, path, x, w, b, cfg: QuantConfig,
                         alpha_pool, stats=None):
    """SmoothQuant calibration of qkv/fc1: per alpha, the PoT channel
    scale, the smoothed activation's observer and the weight bit sweep;
    each (alpha, pool bit) pair scored by the quantized output's MSE and
    the winners kept per pool bit (with one alpha there is nothing to
    choose).  Returns the float smoothed output of the last alpha, which is
    what flows onward (the reference's)."""
    if not cfg.smoothquant:
        x = _calib_act_site(qp, f"{path}.qact0", x, cfg, stats=stats)
        _calib_weight_site(qp, dist, f"{path}.w", w, x, cfg)
        return _linear(x, w, b)

    cand = []
    for alpha in alpha_pool:
        ch = _smoothquant_channel_scale(x, w, alpha)
        x_s, w_s = x / ch, w * ch
        prior = None
        if stats is not None and f"{path}.qact0" in stats:
            prior = act_stats_update(cfg.observer_a, stats[f"{path}.qact0"],
                                     x_s)
        a_scale, a_zp = act_qparams(cfg.observer_a, x_s, cfg.bit_a,
                                    stats=prior)
        wq, wdist = {}, []
        for bt in CALIB_WEIGHT_BIT_TYPES:
            s, _ = minmax_weight_qparams(w_s, x_s, bt, bt.name != "int8")
            wq[bt.name] = s
            wdist.append(_wdist(w_s, s, bt))
        cand.append(dict(ch=ch, a_scale=a_scale, a_zp=a_zp, wq=wq,
                         gt=_linear(x_s, w_s, b), x_s=x_s, w_s=w_s,
                         wdist=wdist))

    best = [0] * len(cfg.bit_pool)
    if len(cand) > 1:
        best = []
        for pool_bit in cfg.bit_pool:
            bt = BIT_TYPE_DICT[f"int{pool_bit}"]
            losses = []
            for c in cand:
                xq = fake_quant(c["x_s"], c["a_scale"], c["a_zp"], cfg.bit_a)
                y = _linear(xq, _wq(c["w_s"], c["wq"][bt.name], bt), b)
                e = c["gt"].to(F64) - y.to(F64)
                losses.append((e * e).sum())
            best.append(int(torch.argmin(torch.stack(losses))))

    qp[f"{path}.sq.channel_scale"] = torch.stack([cand[i]["ch"]
                                                  for i in best])
    qp[f"{path}.qact0.scale"] = torch.stack([cand[i]["a_scale"]
                                             for i in best])
    qp[f"{path}.qact0.zp"] = torch.stack([cand[i]["a_zp"] for i in best])
    for bt in CALIB_WEIGHT_BIT_TYPES:
        qp[f"{path}.w.{bt.name}.scale"] = torch.stack(
            [cand[i]["wq"][bt.name] for i in best])
    dist.append(cand[-1]["wdist"])
    return cand[-1]["gt"]


def _calibrate_embed(params, spec: ViTSpec, cfg: QuantConfig, x, stats=None):
    qp: dict = {}
    if spec.input_quant:
        _calib_act_site(qp, "qact_input", x, cfg, stats=stats)
    pe = params["patch_embed"]
    patches = patchify(x, spec)
    _calib_weight_site(qp, [], "patch.w", pe["w"], patches, cfg,
                       record_distance=False)
    h = _calib_act_site(qp, "patch.qact", _linear(patches, pe["w"], pe["b"]),
                        cfg, stats=stats)
    h = _calib_act_site(qp, "qact_embed", _embed_tokens(params, spec, h),
                        cfg, stats=stats)
    _calib_act_site(qp, "qact_pos", params["pos_embed"], cfg, stats=stats)
    h = h + params["pos_embed"]
    _calib_act_site(qp, "qact1", h, cfg, observer=cfg.observer_a_ln,
                    stats=stats)
    return h, qp


def _calibrate_block(blk, spec: ViTSpec, cfg: QuantConfig, h, stats=None):
    """One block's calibration: (h', qp with block-relative keys, dist)."""
    qp: dict = {}
    dist: list = []
    ob_ln = cfg.observer_a_ln

    y = _float_ln(h, blk["norm1"], spec)
    qkv = _calib_smooth_linear(qp, dist, "attn.qkv", y, blk["qkv"]["w"],
                               blk["qkv"]["b"], cfg, cfg.alpha_pool,
                               stats=stats)
    qkv = _calib_act_site(qp, "attn.qact1", qkv, cfg, stats=stats)

    def lis_fn(a):
        prior = None
        if stats is not None and "attn.qact_attn1" in stats:
            prior = act_stats_update(cfg.observer_a,
                                     stats["attn.qact_attn1"], a)
        scale = act_qparams(cfg.observer_a, a, cfg.bit_a, stats=prior)[0]
        qp["attn.qact_attn1.scale"] = scale
        qp["attn.qact_attn1.zp"] = torch.zeros_like(scale)
        if cfg.lis:
            return log_int_softmax(a, scale, cfg.bit_s)
        return _softmax(a)

    y, _ = _sdpa(qkv, spec, lis_fn)
    y = _calib_act_site(qp, "attn.qact2", y, cfg, stats=stats)
    _calib_weight_site(qp, dist, "attn.proj.w", blk["proj"]["w"], y, cfg)
    y = _linear(y, blk["proj"]["w"], blk["proj"]["b"])
    _calib_act_site(qp, "attn.qact3", y, cfg, observer=ob_ln, stats=stats)
    h = h + y
    _calib_act_site(qp, "qact2", h, cfg, observer=ob_ln, stats=stats)

    y = _float_ln(h, blk["norm2"], spec)
    y = _calib_smooth_linear(qp, dist, "mlp.fc1", y, blk["fc1"]["w"],
                             blk["fc1"]["b"], cfg, cfg.mlp_alpha_pool,
                             stats=stats)
    y = _calib_act_site(qp, "mlp.qact1", gelu_exact(y), cfg, stats=stats)
    _calib_weight_site(qp, dist, "mlp.fc2.w", blk["fc2"]["w"], y, cfg)
    y = _linear(y, blk["fc2"]["w"], blk["fc2"]["b"])
    # Mlp.qact2 is a PTF site (the LN observer)
    y = _calib_act_site(qp, "mlp.qact2", y, cfg, observer=ob_ln, stats=stats)
    h = h + y
    _calib_act_site(qp, "qact4", h, cfg, observer=ob_ln, stats=stats)
    return h, qp, dist


def _calibrate_tail(params, spec: ViTSpec, cfg: QuantConfig, h, stats=None):
    qp: dict = {}
    dist: list = []
    h = _float_ln(h, params["norm"], spec)[:, 0]
    h = _calib_act_site(qp, "qact2", h, cfg, stats=stats)
    _calib_weight_site(qp, dist, "head.w", params["head"]["w"], h, cfg)
    logits = _linear(h, params["head"]["w"], params["head"]["b"])
    _calib_act_site(qp, "act_out", logits, cfg, stats=stats)
    return qp, dist


# Multi-batch observation passes: every batch but the last updates the
# observers' running statistics; the last computes the scales.  While
# observing, the softmax is the float one (qact_attn1 has no scale yet).

def _observe_embed(params, spec: ViTSpec, cfg: QuantConfig, x, states):
    states = dict(states)
    if spec.input_quant:
        _observe_act_site(states, "qact_input", x, cfg)
    pe = params["patch_embed"]
    h = _linear(patchify(x, spec), pe["w"], pe["b"])
    _observe_act_site(states, "patch.qact", h, cfg)
    h = _embed_tokens(params, spec, h)
    _observe_act_site(states, "qact_embed", h, cfg)
    _observe_act_site(states, "qact_pos", params["pos_embed"], cfg)
    h = h + params["pos_embed"]
    _observe_act_site(states, "qact1", h, cfg, observer=cfg.observer_a_ln)
    return h, states


def _observe_block(blk, spec: ViTSpec, cfg: QuantConfig, h, states):
    states = dict(states)
    ob_ln = cfg.observer_a_ln

    def smooth_observe(path, x, lin, alpha_pool):
        if not cfg.smoothquant:
            _observe_act_site(states, f"{path}.qact0", x, cfg)
            return _linear(x, lin["w"], lin["b"])
        for alpha in alpha_pool:
            ch = _smoothquant_channel_scale(x, lin["w"], alpha)
            x_s = x / ch
            _observe_act_site(states, f"{path}.qact0", x_s, cfg)
        return _linear(x_s, lin["w"] * ch, lin["b"])

    y = _float_ln(h, blk["norm1"], spec)
    qkv = smooth_observe("attn.qkv", y, blk["qkv"], cfg.alpha_pool)
    _observe_act_site(states, "attn.qact1", qkv, cfg)

    def soft_fn(a):
        _observe_act_site(states, "attn.qact_attn1", a, cfg)
        return _softmax(a)

    y, _ = _sdpa(qkv, spec, soft_fn)
    _observe_act_site(states, "attn.qact2", y, cfg)
    y = _linear(y, blk["proj"]["w"], blk["proj"]["b"])
    _observe_act_site(states, "attn.qact3", y, cfg, observer=ob_ln)
    h = h + y
    _observe_act_site(states, "qact2", h, cfg, observer=ob_ln)

    y = _float_ln(h, blk["norm2"], spec)
    y = gelu_exact(smooth_observe("mlp.fc1", y, blk["fc1"],
                                  cfg.mlp_alpha_pool))
    _observe_act_site(states, "mlp.qact1", y, cfg)
    y = _linear(y, blk["fc2"]["w"], blk["fc2"]["b"])
    _observe_act_site(states, "mlp.qact2", y, cfg, observer=ob_ln)
    h = h + y
    _observe_act_site(states, "qact4", h, cfg, observer=ob_ln)
    return h, states


def _observe_tail(params, spec: ViTSpec, cfg: QuantConfig, h, states):
    states = dict(states)
    h = _float_ln(h, params["norm"], spec)[:, 0]
    _observe_act_site(states, "qact2", h, cfg)
    logits = _linear(h, params["head"]["w"], params["head"]["b"])
    _observe_act_site(states, "act_out", logits, cfg)
    return states


_TAIL_KEYS = ("qact2", "act_out")


def _sub_states(states, prefix):
    if states is None:
        return None
    sub = {k[len(prefix):]: v for k, v in states.items()
           if k.startswith(prefix)}
    return sub or None


def _embed_states(states):
    """The embed's share of the running state: no block key and none of
    the tail's (whose ``qact2`` is not the blocks')."""
    return {k: v for k, v in states.items()
            if not k.startswith("blocks.") and k not in _TAIL_KEYS}


def calibrate(params, spec: ViTSpec, cfg: QuantConfig, x, stats=None):
    """Single-batch calibration of the float32 batch ``x`` (on the params'
    device).  Returns (qparams, global_distance): qparams a flat {path:
    tensor} dict; global_distance a (4 * depth + 1, 4) float32 tensor of the
    per-linear per-bit weight L2 errors in the order [uint3, uint4, int4,
    int8].  ``stats``: the running observation state of earlier batches
    (see calibrate_batches)."""
    embed_stats = None if stats is None else (_embed_states(stats) or None)
    h, qp = _calibrate_embed(params, spec, cfg, x, stats=embed_stats)
    dists = []
    for i, blk in enumerate(params["blocks"]):
        h, qp_blk, dist_blk = _calibrate_block(
            blk, spec, cfg, h, stats=_sub_states(stats, f"blocks.{i}."))
        qp.update({f"blocks.{i}.{k}": v for k, v in qp_blk.items()})
        dists += dist_blk
    tail_stats = None
    if stats is not None:
        tail_stats = {k: stats[k] for k in _TAIL_KEYS if k in stats} or None
    qp_tail, dist_tail = _calibrate_tail(params, spec, cfg, h,
                                         stats=tail_stats)
    qp.update(qp_tail)
    dist = torch.stack([torch.stack(d) for d in dists + dist_tail])
    return qp, dist


def calibrate_batches(params, spec: ViTSpec, cfg: QuantConfig, batches):
    """Multi-batch calibration: running statistics observed on
    batches[:-1], every scale finalized on the last batch merged with
    them."""
    batches = list(batches)
    if len(batches) == 1:
        return calibrate(params, spec, cfg, batches[0])
    states: dict = {}
    for x in batches[:-1]:
        h, em = _observe_embed(params, spec, cfg, x, _embed_states(states))
        states.update(em)
        for i, blk in enumerate(params["blocks"]):
            h, st = _observe_block(blk, spec, cfg, h,
                                   _sub_states(states, f"blocks.{i}.") or {})
            states.update({f"blocks.{i}.{k}": v for k, v in st.items()})
        states.update(_observe_tail(params, spec, cfg, h,
                                    {k: states[k] for k in _TAIL_KEYS
                                     if k in states}))
    return calibrate(params, spec, cfg, batches[-1], stats=states)


# ---------------------------------------------------------------------------
# The fake-quant forward
# ---------------------------------------------------------------------------

def _fq(qp, path, x, bit_type: BitType):
    """A QAct site: fake-quant with the stored scale and zero point."""
    return fake_quant(x, qp[f"{path}.scale"], qp[f"{path}.zp"], bit_type)


def _q_weight(qp, path, w2d, bit: int):
    """A weight fake-quantized at its calibrated PoT scale for ``bit``."""
    bt = BIT_TYPE_DICT[f"int{bit}"]
    s = qp[f"{path}.{bt.name}.scale"]
    s = s[:, None] if s.dim() == 1 and s.shape[0] == w2d.shape[0] else s
    return fake_quant(w2d, s, 0.0, bt)


def _q_smooth_linear(qp, path, x, w, b, bit: int, cfg: QuantConfig):
    """qkv/fc1: divide by the SmoothQuant channel scale, fake-quant the
    activation and the smoothed weight at the bit-pool entry of ``bit``.
    -1: the float linear (the channel scale cancels)."""
    if bit == -1:
        return _linear(x, w, b)
    if not cfg.smoothquant:
        xq = _fq(qp, f"{path}.qact0", x, cfg.bit_a)
        return _linear(xq, _q_weight(qp, f"{path}.w", w, bit), b)
    idx = cfg.bit_pool.index(bit)
    ch = qp[f"{path}.sq.channel_scale"][idx]
    xq = fake_quant(x / ch, qp[f"{path}.qact0.scale"][idx],
                    qp[f"{path}.qact0.zp"][idx], cfg.bit_a)
    bt = BIT_TYPE_DICT[f"int{bit}"]
    return _linear(xq, _wq(w * ch, qp[f"{path}.w.{bt.name}.scale"][idx],
                           bt), b)


def _q_norm(qp, x, ln, in_path, out_scale, out_ch, cfg: QuantConfig,
            float_mode: bool, spec: ViTSpec):
    if float_mode or not cfg.int_norm:
        return _float_ln(x, ln, spec)
    return int_layernorm(x, ln["w"], ln["b"], qp[f"{in_path}.scale"],
                         out_scale, out_scale_channel=out_ch)


def _check_bit_config(spec: ViTSpec, cfg: QuantConfig, bit_config):
    if bit_config is None:
        return (cfg.bit_w.bits,) * num_bit_slots(spec)
    bit_config = tuple(int(v) for v in bit_config)
    if len(bit_config) != num_bit_slots(spec):
        raise ValueError(f"bit_config needs {num_bit_slots(spec)} entries, "
                         f"got {len(bit_config)}")
    if not set(bit_config) <= {4, 8, -1}:
        raise ValueError(f"bit_config entries must be 4, 8 or -1, got "
                         f"{sorted(set(bit_config))}")
    return bit_config


def forward_q(params, qp, spec: ViTSpec, cfg: QuantConfig, x,
              bit_config=None):
    """The fake-quant forward.  ``bit_config``: 4 * depth + 2 ints in {4, 8,
    -1} (patch, then qkv/proj/fc1/fc2 a block, then head; None: every slot
    ``cfg.bit_w``'s); -1 runs the site in float and its LayerNorm in float.
    Returns (B, classes) float32 logits on the act_out grid."""
    bit_config = _check_bit_config(spec, cfg, bit_config)
    bt_a = cfg.bit_a
    if spec.input_quant:
        x = _fq(qp, "qact_input", x, bt_a)
    pe = params["patch_embed"]
    pb = bit_config[0]
    w = pe["w"] if pb == -1 else _q_weight(qp, "patch.w", pe["w"], pb)
    h = _fq(qp, "patch.qact", _linear(patchify(x, spec), w, pe["b"]), bt_a)
    h = _fq(qp, "qact_embed", _embed_tokens(params, spec, h), bt_a)
    h = h + _fq(qp, "qact_pos", params["pos_embed"], bt_a)
    h = _fq(qp, "qact1", h, bt_a)

    for i, blk in enumerate(params["blocks"]):
        p = f"blocks.{i}"
        b_qkv, b_proj, b_fc1, b_fc2 = bit_config[4 * i + 1: 4 * i + 5]
        in_path = "qact1" if i == 0 else f"blocks.{i - 1}.qact4"

        # attention
        out_scale = out_ch = None
        if b_qkv != -1 and cfg.smoothquant:
            idx = cfg.bit_pool.index(b_qkv)
            out_scale = qp[f"{p}.attn.qkv.qact0.scale"][idx]
            out_ch = qp[f"{p}.attn.qkv.sq.channel_scale"][idx]
        y = _q_norm(qp, h, blk["norm1"], in_path,
                    out_scale if out_scale is not None
                    else qp.get(f"{p}.attn.qkv.qact0.scale"),
                    out_ch, cfg, -1 in (b_qkv, b_proj), spec)
        qkv = _q_smooth_linear(qp, f"{p}.attn.qkv", y, blk["qkv"]["w"],
                               blk["qkv"]["b"], b_qkv, cfg)
        qkv = _fq(qp, f"{p}.attn.qact1", qkv, bt_a)

        def softmax_fn(a, p=p):
            a = _fq(qp, f"{p}.attn.qact_attn1", a, bt_a)
            if cfg.lis:
                return log_int_softmax(a, qp[f"{p}.attn.qact_attn1.scale"],
                                       cfg.bit_s)
            return _softmax(a)

        y, _ = _sdpa(qkv, spec, softmax_fn)
        y = _fq(qp, f"{p}.attn.qact2", y, bt_a)
        w = blk["proj"]["w"] if b_proj == -1 else _q_weight(
            qp, f"{p}.attn.proj.w", blk["proj"]["w"], b_proj)
        y = _fq(qp, f"{p}.attn.qact3", _linear(y, w, blk["proj"]["b"]), bt_a)
        h = _fq(qp, f"{p}.qact2", h + y, bt_a)

        # mlp
        out_scale = out_ch = None
        if b_fc1 != -1 and cfg.smoothquant:
            idx = cfg.bit_pool.index(b_fc1)
            out_scale = qp[f"{p}.mlp.fc1.qact0.scale"][idx]
            # norm2 takes the attention's channel scale, not the MLP's (the
            # reference's quirk, which its published accuracies come from)
            a_idx = cfg.bit_pool.index(b_qkv) if b_qkv != -1 else -1
            out_ch = qp[f"{p}.attn.qkv.sq.channel_scale"][a_idx]
        y = _q_norm(qp, h, blk["norm2"], f"{p}.qact2",
                    out_scale if out_scale is not None
                    else qp.get(f"{p}.mlp.fc1.qact0.scale"),
                    out_ch, cfg, -1 in (b_fc1, b_fc2), spec)
        y = _q_smooth_linear(qp, f"{p}.mlp.fc1", y, blk["fc1"]["w"],
                             blk["fc1"]["b"], b_fc1, cfg)
        y = _fq(qp, f"{p}.mlp.qact1", gelu_exact(y), bt_a)
        w = blk["fc2"]["w"] if b_fc2 == -1 else _q_weight(
            qp, f"{p}.mlp.fc2.w", blk["fc2"]["w"], b_fc2)
        y = _fq(qp, f"{p}.mlp.qact2", _linear(y, w, blk["fc2"]["b"]), bt_a)
        h = _fq(qp, f"{p}.qact4", h + y, bt_a)

    h = _q_norm(qp, h, params["norm"], f"blocks.{spec.depth - 1}.qact4",
                qp["qact2.scale"], None, cfg, False, spec)[:, 0]
    h = _fq(qp, "qact2", h, bt_a)
    hb = bit_config[-1]
    w = params["head"]["w"] if hb == -1 else _q_weight(
        qp, "head.w", params["head"]["w"], hb)
    return _fq(qp, "act_out", _linear(h, w, params["head"]["b"]), bt_a)


def check_search_bits(cfg: QuantConfig, bits, n_slots: int, smoothquant=True):
    """``bits`` as a tuple of ints after the checks of the JAX package's
    bit-traced forwards: ``n_slots`` entries, each 4 or 8 (the search space
    of the mixed-precision search), and with ``smoothquant`` (the ViT
    family) ``cfg.smoothquant`` on and 4 and 8 in ``cfg.bit_pool``.
    Raises ``ValueError``."""
    bits = tuple(int(b) for b in bits)
    if smoothquant and not cfg.smoothquant:
        raise ValueError("the bit-traced forward mirrors the reference search: "
                         "it needs cfg.smoothquant")
    if smoothquant and not {4, 8} <= set(cfg.bit_pool):
        raise ValueError(f"the search needs 4 and 8 in cfg.bit_pool, got "
                         f"{cfg.bit_pool}")
    if len(bits) != n_slots:
        raise ValueError(f"bits needs {n_slots} entries, got {len(bits)}")
    if not set(bits) <= {4, 8}:
        raise ValueError(f"the search space is {{4, 8}} a slot, got "
                         f"{sorted(set(bits))}")
    return bits


def forward_q_bits(params, qp, spec: ViTSpec, cfg: QuantConfig, x, bits):
    """The mixed-precision search's forward (``diffvit_tpu/models/vit.py:
    886``): ``bits`` holds 4 * depth + 2 entries in {4, 8}.  The JAX
    function selects between the 4- and 8-bit variants with ``jnp.where``
    so that one trace serves every candidate, and its numerics are
    ``forward_q(bit_config)``'s; here there is no trace to share, so it
    checks the search space (:func:`check_search_bits`) and runs
    :func:`forward_q` at ``bits``."""
    bits = check_search_bits(cfg, bits, num_bit_slots(spec))
    return forward_q(params, qp, spec, cfg, x, bits)

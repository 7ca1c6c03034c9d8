"""Swin Transformer (counterpart of ``diffvit_tpu/models/swin.py``), as
functions of tensors over a params dict with the JAX pytree's keys:

* specs, window geometry and token reshuffles (``relative_position_index``
  and ``shift_attn_mask`` are numpy, as in the reference; the reshuffles
  take torch tensors);
* ``init_swin_params(spec, generator, device)``;
* ``forward_fp(params, spec, x)``, the float forward;
* ``calibrate(params, spec, cfg, x)`` and ``calibrate_batches``: the flat
  ``{path: tensor}`` qparams under the reference's key names and the
  per-linear per-bit weight distances (``global_distance``, no row for
  the patch conv);
* ``forward_q(params, qp, spec, cfg, x, bit)``, the fake-quant forward,
  ``bit`` an int or a per-slot bit config in {4, 8, -1}.

Swin has no SmoothQuant: ``cfg.smoothquant`` is ignored.  The arithmetic
is ViT's (``models/vit.py``): the linears, q @ k^T, attn @ v, the float
LayerNorm, the exact GELU, the float softmax and the token mean are taken
in float64 and rounded once to float32, and the sites are ViT's
(``_calib_act_site``, ``_calib_weight_site``, ``_fq``, ``_q_weight``), so
calibration on the card equals calibration on the CPU.  The reference
calibrates Swin eagerly, op by op, with jitted observers, and the engine
jits its ``forward_q``; outside the observers the port copies no
arithmetic of either."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..config import QuantConfig
from ..ops.int_layernorm import float_layernorm, int_layernorm
from ..ops.lis import log_int_softmax
from .vit import (F32, F64, _calib_act_site, _calib_weight_site, _fq,
                  _linear, _observe_act_site, _q_weight, _softmax, _tapper,
                  check_search_bits, gelu_exact)


@dataclasses.dataclass(frozen=True)
class SwinSpec:
    name: str
    embed_dim: int
    depths: tuple
    num_heads: tuple
    window: int = 7
    patch_size: int = 4
    img_size: int = 224
    mlp_ratio: int = 4
    num_classes: int = 1000
    input_quant: bool = True
    patch_norm: bool = True
    ln_eps: float = 1e-5

    @property
    def num_layers(self):
        return len(self.depths)

    @property
    def num_features(self):
        return int(self.embed_dim * 2 ** (self.num_layers - 1))

    @property
    def patch_grid(self):
        g = self.img_size // self.patch_size
        return (g, g)

    def stage_dim(self, s):
        return int(self.embed_dim * 2**s)

    def stage_resolution(self, s):
        g = self.patch_grid[0]
        return (g // 2**s, g // 2**s)


SWIN_SPECS = {
    "swin_tiny": SwinSpec("swin_tiny", 96, (2, 2, 6, 2), (3, 6, 12, 24)),
    "swin_small": SwinSpec("swin_small", 96, (2, 2, 18, 2), (3, 6, 12, 24)),
    "swin_base": SwinSpec("swin_base", 128, (2, 2, 18, 2), (4, 8, 16, 32)),
}


def num_bit_slots(spec: SwinSpec) -> int:
    """Patch conv + 4 per block + one reduction per stage but the last +
    head: the length of the Swin bit_config."""
    return 1 + 4 * sum(spec.depths) + (spec.num_layers - 1) + 1


def flops_list(spec: SwinSpec):
    """Per-linear MAC counts: the patch conv, [qkv, proj, fc1, fc2] a
    block, the reduction of every stage but the last, the head."""
    fl = [3 * spec.patch_size**2 * spec.embed_dim * spec.patch_grid[0] ** 2]
    for s in range(spec.num_layers):
        dim = spec.stage_dim(s)
        n = spec.stage_resolution(s)[0] ** 2
        for _ in range(spec.depths[s]):
            fl += [n * dim * 3 * dim, n * dim * dim,
                   n * dim * spec.mlp_ratio * dim,
                   n * spec.mlp_ratio * dim * dim]
        if s < spec.num_layers - 1:
            fl.append((n // 4) * 4 * dim * 2 * dim)
    fl.append(spec.num_features * spec.num_classes)
    return fl


def bit_slot_groups(spec: SwinSpec):
    """Slot-index groups for the mixed-precision candidate sampler
    (``diffvit_tpu/models/swin.py:229``): within a block (qkv, proj) share
    a bit and (fc1, fc2) share a bit (the reference's ViT pair doubling,
    carried to Swin); each downsample reduction and the head draw their own
    bit.  Slot 0 (the patch conv) stays pinned to 8 by the sampler."""
    groups = []
    slot = 1
    for s in range(spec.num_layers):
        for _ in range(spec.depths[s]):
            groups.append([slot, slot + 1])
            groups.append([slot + 2, slot + 3])
            slot += 4
        if s < spec.num_layers - 1:
            groups.append([slot])
            slot += 1
    groups.append([slot])  # head
    return groups


def normalize_bit_config(spec: SwinSpec, bit):
    """An int (uniform) or a per-slot sequence -> the bit_config tuple."""
    n = num_bit_slots(spec)
    if bit is None or isinstance(bit, (int, np.integer)):
        return tuple([int(bit)] * n) if bit is not None else None
    bc = tuple(int(v) for v in bit)
    if len(bc) != n:
        raise ValueError(f"Swin bit_config needs {n} entries, got {len(bc)}")
    return bc


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int):
    """(B*nW, ws*ws, C) -> (B, H, W, C)."""
    c = windows.shape[-1]
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) int index into the (2ws-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def shift_attn_mask(resolution, ws: int, shift: int):
    """(nW, ws*ws, ws*ws) float32 0/-100 mask of the shifted windows, or
    None without a shift."""
    if shift == 0:
        return None
    h, w = resolution
    img = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    mw = img.reshape(1, h // ws, ws, w // ws, ws, 1)
    mw = mw.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    mask = mw[:, None, :] - mw[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def block_geometry(spec: SwinSpec, stage: int, blk: int):
    """(resolution, window, shift, mask) of a block; the window shrinks to
    the resolution, and stops shifting, where the resolution is no larger
    than the window."""
    res = spec.stage_resolution(stage)
    ws = spec.window
    shift = 0 if blk % 2 == 0 else ws // 2
    if min(res) <= ws:
        shift = 0
        ws = min(res)
    return res, ws, shift, shift_attn_mask(res, ws, shift)


def swin_patchify(x: torch.Tensor, spec: SwinSpec) -> torch.Tensor:
    """NCHW -> (B, grid*grid, 3*ps*ps) in the Conv2d weight's (Cin, kh, kw)
    order."""
    b = x.shape[0]
    g, p = spec.patch_grid[0], spec.patch_size
    x = x.reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, g * g, 3 * p * p)


def _windows(x: torch.Tensor, res, ws: int, shift: int) -> torch.Tensor:
    """(B, H*W, C) tokens -> (B*nW, ws*ws, C) windows, cyclically shifted
    by ``-shift`` first."""
    b, _, c = x.shape
    h, w = res
    x = x.reshape(b, h, w, c)
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    return window_partition(x, ws)


def _unwindows(xw: torch.Tensor, res, ws: int, shift: int, b: int):
    """Inverse of :func:`_windows`: (B*nW, ws*ws, C) -> (B, H*W, C)."""
    h, w = res
    c = xw.shape[-1]
    x = window_reverse(xw.reshape(-1, ws, ws, c), ws, h, w)
    if shift > 0:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    return x.reshape(b, h * w, c)


def _merge_patches(x: torch.Tensor, res) -> torch.Tensor:
    """2x2 patch concat: (B, H*W, C) -> (B, H/2*W/2, 4C)."""
    b, _, c = x.shape
    h, w = res
    x = x.reshape(b, h, w, c)
    parts = (x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
             x[:, 1::2, 1::2])
    return torch.cat(parts, -1).reshape(b, -1, 4 * c)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_swin_params(spec: SwinSpec, generator: torch.Generator,
                     device="cuda"):
    """Random parameters in the reference's layout and distributions:
    weights (out, in) and the relative-position bias tables from a normal
    of std 0.02 truncated at +-2 std, zero biases (the reductions have
    none), unit LayerNorm weights.  The patch conv is stored flattened as
    (embed_dim, 3*ps*ps).  Drawn on the CPU from ``generator`` (a CPU
    generator), in the reference's order, then moved to ``device``: the
    same seed gives the same parameters on every device."""

    def tn(*shape):
        t = torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, 1.0, -2.0,
                                        2.0, generator=generator)
        return (0.02 * t).to(device)

    def lin(cout, cin, bias=True):
        return {"w": tn(cout, cin),
                "b": torch.zeros(cout, device=device) if bias else None}

    def ln(c):
        return {"w": torch.ones(c, device=device),
                "b": torch.zeros(c, device=device)}

    params = {
        "patch_embed": {
            "proj": lin(spec.embed_dim, 3 * spec.patch_size**2),
            "norm": ln(spec.embed_dim) if spec.patch_norm else None,
        },
        "layers": [],
        "norm": ln(spec.num_features),
        "head": lin(spec.num_classes, spec.num_features),
    }
    for s in range(spec.num_layers):
        dim = spec.stage_dim(s)
        _, ws, _, _ = block_geometry(spec, s, 0)
        stage = {"blocks": [], "downsample": None}
        for _ in range(spec.depths[s]):
            stage["blocks"].append({
                "norm1": ln(dim),
                "qkv": lin(3 * dim, dim),
                "proj": lin(dim, dim),
                "rel_bias_table": tn((2 * ws - 1) ** 2, spec.num_heads[s]),
                "norm2": ln(dim),
                "fc1": lin(spec.mlp_ratio * dim, dim),
                "fc2": lin(dim, spec.mlp_ratio * dim),
            })
        if s < spec.num_layers - 1:
            stage["downsample"] = {
                "norm": ln(4 * dim),
                "reduction": lin(2 * dim, 4 * dim, bias=False),
            }
        params["layers"].append(stage)
    return params


# ---------------------------------------------------------------------------
# Shared block math
# ---------------------------------------------------------------------------

def _attn_core(x, blk, spec: SwinSpec, stage: int, geom, softmax_fn,
               qact_fns):
    """Window attention on (B*nW, N, C) windows.  ``qact_fns`` maps each
    fence (``qkv``: the linear and its qact1, ``qact_attn1``,
    ``qact_table``, ``qact2``, ``qact3``, ``proj``, ``qact4``) to a
    function of the tensor: identities in the float forward, observers in
    calibration, fake-quant in ``forward_q``.  The shift mask is added
    after qact2, before ``softmax_fn``."""
    _, ws, _, mask = geom
    nh = spec.num_heads[stage]
    b_, n, c = x.shape
    hd = c // nh

    qkv = qact_fns["qkv"](x)
    qkv = qkv.reshape(b_, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = q * float(np.float32(hd**-0.5))  # the reference scales q first
    attn = torch.matmul(q.to(F64), k.to(F64).transpose(-1, -2)).to(F32)
    attn = qact_fns["qact_attn1"](attn)

    table_q = qact_fns["qact_table"](blk["rel_bias_table"])
    idx = torch.as_tensor(relative_position_index(ws).reshape(-1),
                          device=table_q.device)
    bias = table_q[idx].reshape(n, n, nh).permute(2, 0, 1)
    attn = qact_fns["qact2"](attn + bias[None])

    if mask is not None:
        nw = mask.shape[0]
        attn = attn.reshape(b_ // nw, nw, nh, n, n) \
            + torch.as_tensor(mask, device=attn.device)[None, :, None]
        attn = attn.reshape(-1, nh, n, n)
    attn = softmax_fn(attn)

    x = torch.matmul(attn.to(F64), v.to(F64)).to(F32)
    x = qact_fns["qact3"](x.permute(0, 2, 1, 3).reshape(b_, n, c))
    return qact_fns["qact4"](qact_fns["proj"](x))


_ATTN_FENCES = ("qact_attn1", "qact_table", "qact2", "qact3", "qact4")


def _attn_fences(p, site):
    """Block ``p``'s attention fences for ``_attn_core``, each
    ``site(path, t)`` at its ``{p}.attn.{name}`` path."""
    return {name: (lambda t, path=f"{p}.attn.{name}": site(path, t))
            for name in _ATTN_FENCES}


def _token_mean(h):
    """The mean over the tokens (axis 1), in float64 rounded once."""
    return h.to(F64).mean(1).to(F32)


def _identity(t):
    return t


# ---------------------------------------------------------------------------
# Float forward
# ---------------------------------------------------------------------------

def forward_fp(params, spec: SwinSpec, x, taps=None, w_in_taps=None):
    """The float forward: (B, 3, H, W) float32 -> (B, classes) logits.
    ``taps``: the outputs of the patch embedding, of each block's qkv, its
    attention context (``attn.ctx``, at the qact3 fence), proj, fc1 and
    fc2, of each reduction and of the head; ``w_in_taps``: each weight
    site's input (the JAX package's names and order)."""
    tap, wtap = _tapper(taps), _tapper(w_in_taps)
    eps = spec.ln_eps
    pe = params["patch_embed"]
    patches = swin_patchify(x, spec)
    wtap("patch", patches)
    h = _linear(patches, pe["proj"]["w"], pe["proj"]["b"])
    tap("patch_embed.proj", h)
    if pe["norm"] is not None:
        h = float_layernorm(h, pe["norm"]["w"], pe["norm"]["b"], eps)

    for s, stage in enumerate(params["layers"]):
        for bi, blk in enumerate(stage["blocks"]):
            p = f"layers.{s}.blocks.{bi}"
            geom = block_geometry(spec, s, bi)
            res, ws, shift, _ = geom

            def linear_fn(name, t, blk=blk, p=p):
                wtap(f"{p}.attn.{name}", t)
                out = _linear(t, blk[name]["w"], blk[name]["b"])
                tap(f"{p}.attn.{name}", out)
                return out

            def ctx_fn(t, p=p):
                tap(f"{p}.attn.ctx", t)
                return t

            y = float_layernorm(h, blk["norm1"]["w"], blk["norm1"]["b"], eps)
            aw = _attn_core(
                _windows(y, res, ws, shift), blk, spec, s, geom, _softmax,
                {**dict.fromkeys(_ATTN_FENCES, _identity),
                 "qkv": functools.partial(linear_fn, "qkv"),
                 "proj": functools.partial(linear_fn, "proj"),
                 "qact3": ctx_fn})
            h = h + _unwindows(aw, res, ws, shift, h.shape[0])

            y = float_layernorm(h, blk["norm2"]["w"], blk["norm2"]["b"], eps)
            wtap(f"{p}.mlp.fc1", y)
            y = _linear(y, blk["fc1"]["w"], blk["fc1"]["b"])
            tap(f"{p}.mlp.fc1", y)
            y = gelu_exact(y)
            wtap(f"{p}.mlp.fc2", y)
            y = _linear(y, blk["fc2"]["w"], blk["fc2"]["b"])
            tap(f"{p}.mlp.fc2", y)
            h = h + y
        if stage["downsample"] is not None:
            ds = stage["downsample"]
            h = _merge_patches(h, spec.stage_resolution(s))
            h = float_layernorm(h, ds["norm"]["w"], ds["norm"]["b"], eps)
            wtap(f"layers.{s}.downsample.reduction", h)
            h = _linear(h, ds["reduction"]["w"])
            tap(f"layers.{s}.downsample.reduction", h)

    h = float_layernorm(h, params["norm"]["w"], params["norm"]["b"], eps)
    h = _token_mean(h)
    wtap("head", h)
    logits = _linear(h, params["head"]["w"], params["head"]["b"])
    tap("head", logits)
    return logits


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

def calibrate(params, spec: SwinSpec, cfg: QuantConfig, x, stats=None,
              _observe=None):
    """Single-batch calibration of the float32 batch ``x`` (on the params'
    device).  Returns (qparams, global_distance): qparams a flat {path:
    tensor} dict; global_distance a (num_bit_slots - 1, 4) float32 tensor
    of the per-linear per-bit weight L2 errors in the order [uint3, uint4,
    int4, int8] (the patch conv records none).  ``stats``: the running
    observation state of earlier batches, merged into this batch's;
    ``_observe`` (a states dict): an observe-only pass that updates it and
    returns ({}, None) (see calibrate_batches).  The softmax of an
    observe-only pass is the float one: the LIS scale (qact2's) does not
    exist yet."""
    qp: dict = {}
    dist: list = []
    eps = spec.ln_eps
    ob_ln = cfg.observer_a_ln

    def act(path, t, observer=None):
        if _observe is not None:
            return _observe_act_site(_observe, path, t, cfg,
                                     observer=observer)
        return _calib_act_site(qp, path, t, cfg, observer=observer,
                               stats=stats)

    def weight(path, w, xin, record_distance=True):
        if _observe is None:
            _calib_weight_site(qp, dist, path, w, xin, cfg,
                               record_distance=record_distance)

    if spec.input_quant:
        act("qact_input", x)
    pe = params["patch_embed"]
    patches = swin_patchify(x, spec)
    weight("patch.w", pe["proj"]["w"], patches, record_distance=False)
    h = _linear(patches, pe["proj"]["w"], pe["proj"]["b"])
    if pe["norm"] is not None:
        act("patch.qact_bn", h)
        h = float_layernorm(h, pe["norm"]["w"], pe["norm"]["b"], eps)
    act("patch.qact", h)

    for s, stage in enumerate(params["layers"]):
        for bi, blk in enumerate(stage["blocks"]):
            p = f"layers.{s}.blocks.{bi}"
            geom = block_geometry(spec, s, bi)
            res, ws, shift, _ = geom
            shortcut = h
            y = float_layernorm(h, blk["norm1"]["w"], blk["norm1"]["b"], eps)
            y = act(f"{p}.qact1", y)

            def qkv_fn(t, p=p, blk=blk):
                weight(f"{p}.attn.qkv.w", blk["qkv"]["w"], t)
                return act(f"{p}.attn.qact1",
                           _linear(t, blk["qkv"]["w"], blk["qkv"]["b"]))

            def proj_fn(t, p=p, blk=blk):
                weight(f"{p}.attn.proj.w", blk["proj"]["w"], t)
                return _linear(t, blk["proj"]["w"], blk["proj"]["b"])

            def softmax_fn(a, p=p):
                # on the qact2 scale just calibrated in the fence before
                if cfg.lis and _observe is None:
                    return log_int_softmax(a, qp[f"{p}.attn.qact2.scale"],
                                           cfg.bit_s)
                return _softmax(a)

            aw = _attn_core(_windows(y, res, ws, shift), blk, spec, s, geom,
                            softmax_fn, dict(_attn_fences(p, act), qkv=qkv_fn,
                                             proj=proj_fn))
            h = shortcut + _unwindows(aw, res, ws, shift, h.shape[0])
            h = act(f"{p}.qact2", h, observer=ob_ln)

            y = float_layernorm(h, blk["norm2"]["w"], blk["norm2"]["b"], eps)
            y = act(f"{p}.qact3", y)
            weight(f"{p}.mlp.fc1.w", blk["fc1"]["w"], y)
            y = gelu_exact(_linear(y, blk["fc1"]["w"], blk["fc1"]["b"]))
            y = act(f"{p}.mlp.qact1", y)
            weight(f"{p}.mlp.fc2.w", blk["fc2"]["w"], y)
            y = _linear(y, blk["fc2"]["w"], blk["fc2"]["b"])
            # Mlp.qact2 is a PTF site (the LN observer)
            y = act(f"{p}.mlp.qact2", y, observer=ob_ln)
            h = act(f"{p}.qact4", h + y, observer=ob_ln)

        if stage["downsample"] is not None:
            ds = stage["downsample"]
            p = f"layers.{s}.downsample"
            h = _merge_patches(h, spec.stage_resolution(s))
            h = float_layernorm(h, ds["norm"]["w"], ds["norm"]["b"], eps)
            h = act(f"{p}.qact1", h)
            weight(f"{p}.reduction.w", ds["reduction"]["w"], h)
            h = act(f"{p}.qact2", _linear(h, ds["reduction"]["w"]),
                    observer=ob_ln)

    h = float_layernorm(h, params["norm"]["w"], params["norm"]["b"], eps)
    h = act("qact3", _token_mean(act("qact2", h)))
    weight("head.w", params["head"]["w"], h)
    act("act_out", _linear(h, params["head"]["w"], params["head"]["b"]))
    if _observe is not None:
        return qp, None
    return qp, torch.stack([torch.stack(d) for d in dist])


def calibrate_batches(params, spec: SwinSpec, cfg: QuantConfig, batches):
    """Multi-batch calibration: running statistics observed on
    batches[:-1], every scale finalized on the last batch merged with
    them."""
    batches = list(batches)
    if len(batches) == 1:
        return calibrate(params, spec, cfg, batches[0])
    states: dict = {}
    for x in batches[:-1]:
        calibrate(params, spec, cfg, x, _observe=states)
    return calibrate(params, spec, cfg, batches[-1], stats=states)


# ---------------------------------------------------------------------------
# The fake-quant forward
# ---------------------------------------------------------------------------

def forward_q(params, qp, spec: SwinSpec, cfg: QuantConfig, x, bit=None,
              taps=None, w_in_taps=None, ste: bool = False):
    """The fake-quant forward.  ``bit``: the uniform weight bit, or a
    per-slot bit config (``normalize_bit_config``: the patch conv, [qkv,
    proj, fc1, fc2] a block, the reductions, the head; None: every slot
    ``cfg.bit_w``'s) in {4, 8, -1}: -1 runs the site in float and the
    LayerNorm that feeds it in float.  Returns (B, classes) float32 logits
    on the act_out grid.  ``taps`` / ``w_in_taps``: the biased linears'
    outputs and the weight sites' inputs, as in ``vit.forward_q``;
    ``ste``: straight-through rounding, the same values."""
    bc = normalize_bit_config(spec, bit if bit is not None
                              else cfg.bit_w.bits)
    if not set(bc) <= {4, 8, -1}:
        raise ValueError(f"bit_config entries must be 4, 8 or -1, got "
                         f"{sorted(set(bc))}")

    def wfn(path, w, slot):
        return w if bc[slot] == -1 else _q_weight(qp, path, w, bc[slot], ste)

    return _forward_q_body(params, qp, spec, cfg, x, wfn,
                           lambda slot: bc[slot] == -1, taps, w_in_taps,
                           ste)


def _forward_q_body(params, qp, spec: SwinSpec, cfg: QuantConfig, x, wfn,
                    lnfloat, taps=None, w_in_taps=None, ste: bool = False):
    """The fake-quant forward's body: ``wfn(qp_path, w, slot)`` gives each
    slot's weight; ``lnfloat(slot)`` turns the LayerNorm that feeds the
    slot to float."""
    bt_a = cfg.bit_a
    eps = spec.ln_eps
    tap, wtap = _tapper(taps), _tapper(w_in_taps)

    def fq(path, t):
        return _fq(qp, path, t, bt_a, ste)

    def norm(ln, x_, in_path, out_path, consumer_slot, expand=1):
        if not cfg.int_norm or lnfloat(consumer_slot):
            return float_layernorm(x_, ln["w"], ln["b"], eps)
        # the merged grid is the source grid tiled (never repeated
        # element by element)
        in_scale = torch.tile(qp[f"{in_path}.scale"], (expand,))
        return int_layernorm(x_, ln["w"], ln["b"], in_scale,
                             qp[f"{out_path}.scale"], ste=ste)

    def linear(name, t, w, b=None):
        wtap(name, t)
        out = _linear(t, w, b)
        tap(name, out)
        return out

    if spec.input_quant:
        x = fq("qact_input", x)
    pe = params["patch_embed"]
    patches = swin_patchify(x, spec)
    wtap("patch", patches)
    h = _linear(patches, wfn("patch.w", pe["proj"]["w"], 0), pe["proj"]["b"])
    tap("patch_embed.proj", h)
    if pe["norm"] is not None:
        h = fq("patch.qact_bn", h)
        h = norm(pe["norm"], h, "patch.qact_bn", "patch.qact", 0)
    h = fq("patch.qact", h)
    last_q = "patch.qact"
    slot = 1  # 0 was the patch conv; flops_list order from here

    for s, stage in enumerate(params["layers"]):
        for bi, blk in enumerate(stage["blocks"]):
            p = f"layers.{s}.blocks.{bi}"
            s_qkv, s_proj, s_fc1, s_fc2 = slot, slot + 1, slot + 2, slot + 3
            slot += 4
            geom = block_geometry(spec, s, bi)
            res, ws, shift, _ = geom
            shortcut = h
            y = norm(blk["norm1"], h, last_q, f"{p}.qact1", s_qkv)
            y = fq(f"{p}.qact1", y)

            def qkv_fn(t, p=p, blk=blk, s_qkv=s_qkv):
                w = wfn(f"{p}.attn.qkv.w", blk["qkv"]["w"], s_qkv)
                return fq(f"{p}.attn.qact1",
                          linear(f"{p}.attn.qkv", t, w, blk["qkv"]["b"]))

            def proj_fn(t, p=p, blk=blk, s_proj=s_proj):
                w = wfn(f"{p}.attn.proj.w", blk["proj"]["w"], s_proj)
                return linear(f"{p}.attn.proj", t, w, blk["proj"]["b"])

            def softmax_fn(a, p=p):
                if cfg.lis:
                    return log_int_softmax(a, qp[f"{p}.attn.qact2.scale"],
                                           cfg.bit_s, ste)
                return _softmax(a)

            aw = _attn_core(_windows(y, res, ws, shift), blk, spec, s, geom,
                            softmax_fn, dict(_attn_fences(p, fq), qkv=qkv_fn,
                                             proj=proj_fn))
            h = shortcut + _unwindows(aw, res, ws, shift, h.shape[0])
            h = fq(f"{p}.qact2", h)

            y = norm(blk["norm2"], h, f"{p}.qact2", f"{p}.qact3", s_fc1)
            y = fq(f"{p}.qact3", y)
            y = linear(f"{p}.mlp.fc1", y,
                       wfn(f"{p}.mlp.fc1.w", blk["fc1"]["w"], s_fc1),
                       blk["fc1"]["b"])
            y = fq(f"{p}.mlp.qact1", gelu_exact(y))
            y = linear(f"{p}.mlp.fc2", y,
                       wfn(f"{p}.mlp.fc2.w", blk["fc2"]["w"], s_fc2),
                       blk["fc2"]["b"])
            y = fq(f"{p}.mlp.qact2", y)
            h = fq(f"{p}.qact4", h + y)
            last_q = f"{p}.qact4"

        if stage["downsample"] is not None:
            ds = stage["downsample"]
            p = f"layers.{s}.downsample"
            s_red = slot
            slot += 1
            h = _merge_patches(h, spec.stage_resolution(s))
            h = norm(ds["norm"], h, last_q, f"{p}.qact1", s_red, expand=4)
            h = fq(f"{p}.qact1", h)
            h = linear(f"{p}.reduction", h,
                       wfn(f"{p}.reduction.w", ds["reduction"]["w"], s_red))
            h = fq(f"{p}.qact2", h)
            last_q = f"{p}.qact2"

    h = norm(params["norm"], h, last_q, "qact2", slot)
    h = fq("qact3", _token_mean(fq("qact2", h)))
    logits = linear("head", h, wfn("head.w", params["head"]["w"], slot),
                    params["head"]["b"])
    return fq("act_out", logits)


def forward_q_bits(params, qp, spec: SwinSpec, cfg: QuantConfig, x, bits):
    """The mixed-precision search's Swin forward (``diffvit_tpu/models/
    swin.py:712``): ``bits`` holds ``num_bit_slots`` entries in {4, 8};
    each weight site takes its int4 or int8 fake-quant weight through
    :func:`_forward_q_body`'s ``wfn``, no LayerNorm turns float.  Raises
    ``ValueError`` outside the search space."""
    bits = check_search_bits(cfg, bits, num_bit_slots(spec),
                             smoothquant=False)

    def wfn(path, w, slot):
        return _q_weight(qp, path, w, bits[slot])

    return _forward_q_body(params, qp, spec, cfg, x, wfn, lambda slot: False)

"""The plain reference: the integer ViT and Swin forwards of P2-ViT's
codes path, in plain PyTorch, from the int-model pytree (host numpy) and
int8 input codes.

It follows the integer semantics that the program's kernels are held to
(every product of integers exact, each float32 operation rounding on its
own, half to even): integer LayerNorm (the M * 2^-N scheme: exact integer
row sums, the root taken in float64 and rounded once), the qkv requant
onto the qact1 grid, the Log-Int-Softmax (the i-BERT integer
exponential, an exact row sum, log2 codes as powers of two, attn@v
exact), the code fences of the residual stream, the polynomial GELU of
the integer MLP, the head.  Every constant that the program's set-up
derives (the folded requant vectors, the attention scalars, the Swin
bias tables and shift masks, the resident kernel's packing) is worked
out again here from the pytree.

``control=True`` is the control of the correctness check: the same
forward with every float32 requant product and sum taken in bfloat16 and
every float64 step in float32, the step below what the configuration
states.  A comparison that does not fail it cannot see a fault.

Only codes-path configurations are taken (``sym_acts``, integer LN,
integer sites, SmoothQuant for a ViT, the LIS within ``lis_sum_fits``);
anything else raises ``ValueError``.  Imports torch and numpy only."""
from __future__ import annotations

import math

import numpy as np
import torch

from .specs import Swin, ViT

I8, I32, I64 = torch.int8, torch.int32, torch.int64
F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
f32 = np.float32

# float32 roundings of the LIS's constants (i-BERT's polynomial of exp on
# [-ln2, 0], the log2 tail's 4/3 nudge)
_X0 = float(f32(-0.6931))
_B = float(f32(0.96963238 / 0.35815147))
_C = float(f32(1.0 / 0.35815147))
_NUDGE = float(f32(4.0 / 3.0 * (1.0 + 2.0**-17)))
# the polynomial GELU: a Chebyshev fit of (Phi(sqrt(u)) - 0.5)/sqrt(u) on
# u in [0, 4.8^2], monomial form in s = 2u/4.8^2 - 1
_GELU_P = tuple(float(f32(c)) for c in (
    1.472124915e-01, -7.297722655e-02, 5.292239887e-02, -4.063959391e-02,
    3.055344378e-02, -2.162323356e-02, 1.431964120e-02, -9.132027657e-03,
    5.130726935e-03, -2.055695227e-03, 1.023744687e-03, -9.600747865e-04,
    3.919371191e-04))
_GELU_B2 = float(f32(4.8 * 4.8))
_GELU_2_OVER_B2 = float(f32(2.0 / (4.8 * 4.8)))


class Arith:
    """The reference's precisions: float32 requant arithmetic and float64
    roots and sums, or (``control``) bfloat16 and float32."""

    def __init__(self, device, control: bool = False):
        self.device = torch.device(device)
        self.control = control
        self.wide = F32 if control else F64

    def t(self, a):
        """A numpy value of the pytree as a tensor on the device (floats as
        float32)."""
        a = np.asarray(a)
        return torch.as_tensor(a, device=self.device,
                               dtype=F32 if a.dtype.kind == "f" else None)

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Exact int8 (..., K) @ (..., K, N) -> int32: int32 on the CPU,
        float64 on a card (exact below 2^53; TF32 does not touch
        float64)."""
        if a.device.type == "cpu":
            return torch.matmul(a.to(I32), b.to(I32))
        return torch.matmul(a.to(F64), b.to(F64)).to(I32)

    def affine(self, acc, mult, bias=None):
        """``acc * mult + bias`` of an int32 accumulator, in float32 (the
        control: bfloat16)."""
        if not self.control:
            y = acc.to(F32) * mult
            return y if bias is None else y + bias
        y = acc.to(BF16) * mult.to(BF16)
        if bias is not None:
            y = y + bias.to(BF16)
        return y.to(F32)

    def fence(self, codes, scale, codes2, scale2):
        """``codes * scale + codes2 * scale2``: a residual add of two code
        streams, in float32 (the control: bfloat16)."""
        if not self.control:
            return codes.to(F32) * scale + codes2.to(F32) * scale2
        return (codes.to(BF16) * scale.to(BF16)
                + codes2.to(BF16) * scale2.to(BF16)).to(F32)


def pow2(n: torch.Tensor) -> torch.Tensor:
    """Exact float32 2^n for integer n in [-126, 127], from the exponent
    bits."""
    return ((n.to(I32) + 127) << 23).view(F32)


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """Exact floor(log2 x) of a positive finite float32."""
    ok = torch.isfinite(x) & (x > 0)
    e = (torch.frexp(torch.where(ok, x, 1.0)).exponent - 1).to(x.dtype)
    return torch.where(ok, e, torch.floor(torch.log2(x)))


def fake_quant(x, scale, lo, hi):
    """quantize-dequantize on the ``scale`` grid (zero-point 0)."""
    return torch.clamp(torch.round(x / scale), lo, hi) * scale


def codes_of(x, scale, lo=-128, hi=127):
    return torch.clamp(torch.round(x / scale), lo, hi).to(I8)


# ---- integer LayerNorm ------------------------------------------------------

def ln_codes(ar: Arith, x_q, in_scale, weight, bias, out_scale):
    """Integer LN over the last axis of the float32 codes ``x_q`` on the
    per-channel ``in_scale`` grid -> float32 output codes on
    ``out_scale``, rounded and not clipped: the inputs folded onto the
    smallest channel scale, exact int64 row sums rounded to float32, the
    std's root in float64, a = M * 2^-N with a 7-bit mantissa."""
    c = weight.shape[-1]
    in_scale = in_scale.expand(c)
    s1 = in_scale.min()
    x_q = x_q * torch.round(in_scale / s1)
    out_scale = out_scale.expand(c)
    xi = x_q.to(I64)
    sum_x = xi.sum(-1).to(F32)
    sum_x2 = (xi * xi).sum(-1).to(F32)
    c_t = sum_x.new_full((), float(c))
    mean = (sum_x / c_t) * s1
    var = (c * sum_x2 - sum_x * sum_x).to(ar.wide)
    std = (s1 / c_t) * torch.sqrt(var).to(F32)
    a = (s1 / std)[..., None] * weight / out_scale
    a_abs = torch.abs(a)
    n = torch.clamp(7 - floor_log2(a_abs), 0, 31)
    m = torch.clamp(torch.floor(a_abs * pow2(n)), 0, 255)
    p2n = pow2(n)
    b = torch.round((bias - (mean / std)[..., None] * weight)
                    / out_scale * p2n)
    return torch.round((torch.sign(a) * m * x_q + b) / p2n)


def ln_int8(ar: Arith, x_codes, ln, in_scale, out_scale, rescale=None):
    """The integer LN of int8 codes to int8 codes on ``out_scale``;
    ``rescale``: the per-channel grid conversion of the raw codes."""
    y = ln_codes(ar, x_codes.to(F32), in_scale, ln["w"], ln["b"], out_scale)
    if rescale is not None:
        y = torch.round(y * rescale)
    return torch.clamp(y, -128, 127).to(I8)


# ---- Log-Int-Softmax ---------------------------------------------------------

def lis_sum_fits(s: float, n_keys: int) -> bool:
    """Whether the int64 row sum of ``n_keys`` integer exponentials cannot
    overflow at the softmax scale ``s``."""
    s = f32(s)
    return n_keys * math.floor(f32(_C) / (s * s)) < 2**31


def lis_weights(a_int, scale, bits: int):
    """LIS of integer scores (float32 carrier, every column a real key) at
    the softmax scale ``scale`` (a 0-dim float32 tensor): int32 weights
    2^(15 - code), 0 where the log2 code saturates."""
    full = lambda v: torch.full_like(scale, v)  # noqa: E731
    x = a_int - torch.amax(a_int, -1, keepdim=True)
    x0 = torch.floor(full(_X0) / scale)
    x = torch.maximum(x, 32.0 * x0)
    q = torch.floor(x / x0)
    r = x - x0 * q
    b_int = torch.floor(full(_B) / scale)
    c_int = torch.floor(full(_C) / (scale * scale))
    e = (r * (r + b_int) + c_int) * pow2(32.0 - q)
    e = torch.clamp(torch.floor(e), min=0.0)
    total = e.to(I64).sum(-1, keepdim=True).to(F32)
    y = torch.round(total / e) * _NUDGE
    code = torch.frexp(y).exponent - 1
    keep = y < 2.0 ** (2**bits)
    w = torch.ones_like(code) << torch.where(keep, 15 - code, 0)
    return torch.where(keep, w, 0).to(I32)


def weighted_values(ar: Arith, weights, v):
    """``weights @ v`` of int32 LIS weights and int8 values, exact (the
    control: in float32)."""
    if ar.control:
        return torch.matmul(weights.to(F32), v.to(F32))
    if weights.device.type == "cpu":
        return torch.matmul(weights, v.to(I32)).to(F32)
    return torch.matmul(weights.to(F64), v.to(F64)).to(F32)


def gelu_poly(x):
    """x * clip(0.5 + x * P(min(x^2, 4.8^2)), 0, 1), division- and exp-free."""
    u = torch.clamp(x * x, max=_GELU_B2)
    s = u * _GELU_2_OVER_B2 - 1.0
    p = _GELU_P[-1] * s + _GELU_P[-2]
    for coef in _GELU_P[-3::-1]:
        p = p * s + coef
    return x * torch.clamp(0.5 + x * p, 0.0, 1.0)


def mlp(ar: Arith, x_i8, fc1, fc2, s_q1, s_out):
    """The integer MLP on int8 LN codes: fc1, the polynomial GELU onto the
    mlp.qact1 grid, fc2, int8 codes on the mlp.qact2 grid."""
    w1, w2 = ar.t(fc1["w_int"]), ar.t(fc2["w_int"])
    hid, cout = w1.shape[1], w2.shape[1]
    mid = ar.affine(ar.dot(x_i8, w1), ar.t(fc1["mult"]).expand(hid),
                    _bias(ar, fc1, hid))
    g = torch.clamp(torch.round(gelu_poly(mid) * (1.0 / s_q1)), -128, 127)
    y = ar.affine(ar.dot(g.to(I8), w2), ar.t(fc2["mult"]).expand(cout),
                  _bias(ar, fc2, cout))
    return torch.clamp(torch.round(y * (1.0 / s_out.expand(cout))),
                       -128, 127).to(I8)


def _bias(ar, site, n):
    b = site.get("b")
    return None if b is None else ar.t(b).expand(n)


def linear(ar: Arith, x_i8, site, mult):
    """An integer site: ``acc * mult + b``."""
    w = ar.t(site["w_int"])
    return ar.affine(ar.dot(x_i8, w), mult, _bias(ar, site, w.shape[1]))


# ---- ViT ----------------------------------------------------------------------

def _check_vit(spec: ViT, ip):
    q = spec.quant
    if not (q["ptf"] and q["lis"] and q["smoothquant"]
            and ip.get("sym_acts") and spec.input_quant):
        raise ValueError("the reference takes the ViT codes path only "
                         "(PTF, LIS, SmoothQuant, symmetric activations, "
                         "quantized input)")
    for i, ib in enumerate(ip["blocks"]):
        for s in ("qkv", "proj", "fc1", "fc2"):
            if ib[s].get("fp"):
                raise ValueError(f"block {i}: {s} is a float site")
    if ip["patch"].get("fp") or ip["head"].get("fp"):
        raise ValueError("float patch or head site")


def vit_forward(spec: ViT, ip, x_codes, ar: Arith):
    """(B, num_classes) float32 logits of the int8 input codes
    ``x_codes`` (B, 3, H, W) on the act_out grid."""
    _check_vit(spec, ip)
    t = ar.t
    lo, hi = spec.quant.a_bounds
    b = x_codes.shape[0]
    c = spec.embed_dim
    g, p = spec.img_size // spec.patch_size, spec.patch_size
    x = x_codes.reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5) \
        .reshape(b, g * g, 3 * p * p)

    def fq(site, v):
        return fake_quant(v, t(site["scale"]), lo, hi)

    h = linear(ar, x, ip["patch"], t(ip["patch"]["mult"]))
    h = fq(ip["patch.qact"], h)
    h = torch.cat([t(ip["cls_token"]).expand(b, 1, c), h], 1)
    h = fq(ip["qact_embed"], h)
    h = h + fq(ip["qact_pos"], t(ip["pos_embed"]))
    in_scale = t(ip["qact1"]["scale"])
    hc = codes_of(fq(ip["qact1"], h), in_scale, lo, hi)

    for ib in ip["blocks"]:
        hc = vit_block(spec, ib, hc, in_scale, ar)
        in_scale = t(ib["qact4"]["scale"])

    s_out = t(ip["qact2"]["scale"])
    h_i8 = ln_int8(ar, hc[:, 0], {k: t(v) for k, v in ip["norm"].items()},
                   in_scale, s_out)
    logits = linear(ar, h_i8, ip["head"], t(ip["head"]["mult"]))
    return fq(ip["act_out"], logits)


def vit_block(spec: ViT, ib, hc, in_scale, ar: Arith):
    """One encoder block on the int8 residual codes ``hc`` (B, N, C) of the
    ``in_scale`` grid -> the qact4 codes."""
    t = ar.t
    b, n, c = hc.shape
    nh, hd = spec.num_heads, spec.head_dim
    s1 = f32(np.asarray(ib["attn.qact1"]["scale"]).reshape(()))
    s_a = f32(np.asarray(ib["attn.qact_attn1"]["scale"]).reshape(()))
    s2 = f32(np.asarray(ib["attn.qact2"]["scale"]).reshape(()))
    if not lis_sum_fits(s_a, n):
        raise ValueError("softmax scale outside lis_sum_fits")
    c1 = s1 * s1 * f32(spec.attn_scale) / s_a
    s1_inv = f32(1.0) / s1
    qkv = ib["qkv"]
    ln1 = {k: t(v) for k, v in ib["norm1"].items()}
    x_i8 = ln_int8(ar, hc, ln1, in_scale, t(qkv["in_scale"]))
    mb0 = (np.broadcast_to(np.asarray(qkv["mult"], f32), (3 * c,))
           * s1_inv).astype(f32)
    mb1 = (np.broadcast_to(np.asarray(qkv["b"], f32), (3 * c,))
           * s1_inv).astype(f32)
    y = ar.affine(ar.dot(x_i8, t(qkv["w_int"])), t(mb0), t(mb1))
    qkv_i8 = torch.clamp(torch.round(y), -128, 127).to(I8)
    q5 = qkv_i8.reshape(b, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
    scores = ar.dot(q5[0], q5[1].transpose(-1, -2))
    a_int = torch.clamp(torch.round(scores.to(F32) * t(c1)), -128, 127)
    w = lis_weights(a_int, t(s_a), spec.quant.s_bits)
    acc = weighted_values(ar, w, q5[2]) * 2.0**-15
    o = torch.clamp(torch.round(acc * t(s1 / s2)), -128, 127).to(I8)
    o = o.permute(0, 2, 1, 3).reshape(b, n, c)
    proj = ib["proj"]
    y = linear(ar, o, proj, t(proj["mult"]))

    s3 = t(ib["attn.qact3"]["scale"])
    s_blk2 = t(ib["qact2"]["scale"])
    yq3 = torch.clamp(torch.round(y / s3), -128, 127)
    hc = codes_of(ar.fence(hc, in_scale, yq3, s3), s_blk2)
    fc1, fc2 = ib["fc1"], ib["fc2"]
    ln2 = {k: t(v) for k, v in ib["norm2"].items()}
    rescale = t(fc1["ln_rescale"]) if "ln_rescale" in fc1 else None
    x_i8 = ln_int8(ar, hc, ln2, s_blk2,
                   t(fc1.get("ln_out_scale", fc1["in_scale"])), rescale)
    y2c = mlp(ar, x_i8, fc1, fc2, t(ib["mlp.qact1"]["scale"]),
              t(ib["mlp.qact2"]["scale"]))
    hs = ar.fence(hc, s_blk2, y2c, t(ib["mlp.qact2"]["scale"]))
    return codes_of(hs, t(ib["qact4"]["scale"]))


# ---- Swin ---------------------------------------------------------------------

def relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) index into the (2ws-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def shift_mask(res: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws*ws, ws*ws) float32 0 / -100 mask of the shifted windows."""
    img = np.zeros((res, res), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    mw = img.reshape(res // ws, ws, res // ws, ws).transpose(0, 2, 1, 3) \
        .reshape(-1, ws * ws)
    d = mw[:, None, :] - mw[:, :, None]
    return np.where(d != 0, -100.0, 0.0).astype(np.float32)


def windows(x, res: int, ws: int, shift: int):
    """(B, res*res, C) -> (B*nW, ws*ws, C), cyclically shifted by -shift."""
    b, _, c = x.shape
    x = x.reshape(b, res, res, c)
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    x = x.reshape(b, res // ws, ws, res // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def unwindows(xw, res: int, ws: int, shift: int, b: int):
    """Inverse of :func:`windows`."""
    c = xw.shape[-1]
    x = xw.reshape(b, res // ws, res // ws, ws, ws, c) \
        .permute(0, 1, 3, 2, 4, 5).reshape(b, res, res, c)
    if shift:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    return x.reshape(b, res * res, c)


def merge_patches(x, res: int):
    """2x2 patch concat: (B, res*res, C) -> (B, res*res/4, 4C)."""
    b, _, c = x.shape
    x = x.reshape(b, res, res, c)
    parts = (x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
             x[:, 1::2, 1::2])
    return torch.cat(parts, -1).reshape(b, -1, 4 * c)


def window_attention(ar: Arith, qkv_i8, nh, bias_q, mask_div, sc, bits):
    """Window attention of qact1 codes (Bw, n, 3C) -> (Bw, n, C) qact3
    codes: scores on qact_attn1, the fake-quantized position bias, the
    qact2 grid, the shift mask, the LIS, attn@v."""
    bw, n, c3 = qkv_i8.shape
    hd = c3 // 3 // nh
    q5 = qkv_i8.reshape(bw, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
    scores = ar.dot(q5[0], q5[1].transpose(-1, -2)).to(F32)
    a1c = torch.clamp(torch.round(scores * sc[0]), -128, 127)
    af = a1c * sc[1] + bias_q
    am = torch.clamp(torch.round(af * sc[2]), -128, 127)
    if mask_div is not None:
        nw = mask_div.shape[0]
        am = (am.reshape(bw // nw, nw, nh, n, n) + mask_div[None, :, None]) \
            .reshape(bw, nh, n, n)
    w = lis_weights(am, sc[3], bits)
    acc = weighted_values(ar, w, q5[2]) * 2.0**-15
    o = torch.clamp(torch.round(acc * sc[4]), -128, 127).to(I8)
    return o.permute(0, 2, 1, 3).reshape(bw, n, nh * hd)


def _check_swin(spec: Swin, ip):
    q = spec.quant
    if not (q["ptf"] and q["lis"] and ip.get("sym_acts")
            and spec.input_quant):
        raise ValueError("the reference takes the Swin codes path only "
                         "(PTF, LIS, symmetric activations, quantized "
                         "input)")


def swin_forward(spec: Swin, ip, x_codes, ar: Arith):
    """(B, num_classes) float32 logits of the int8 input codes ``x_codes``
    (B, 3, H, W) on the act_out grid."""
    _check_swin(spec, ip)
    t = ar.t
    qp = ip["qp"]
    lo, hi = spec.quant.a_bounds
    bits = spec.quant.s_bits

    def s_np(path):
        return np.asarray(qp[f"{path}.scale"], f32)

    def s(path):
        return t(s_np(path))

    def fq(path, v):
        return fake_quant(v, s(path), lo, hi)

    def lin(site, x_i8, in_path, in_scale=None):
        sc = s_np(in_path) if in_scale is None else in_scale
        mult = (np.asarray(sc, f32) * np.asarray(site["sw"], f32)).astype(f32)
        return linear(ar, x_i8, site, t(mult))

    def norm(ln):
        return {k: t(v) for k, v in ln.items()}

    b = x_codes.shape[0]
    g, p = spec.grid, spec.patch_size
    x = x_codes.reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5) \
        .reshape(b, g * g, 3 * p * p)
    h = lin(ip["patch"], x, "qact_input")
    if ip["patch_norm"] is not None:
        h = fq("patch.qact_bn", h)
        x_q = torch.round(h / s("patch.qact_bn"))
        pn = norm(ip["patch_norm"])
        h = ln_codes(ar, x_q, s("patch.qact_bn"), pn["w"], pn["b"],
                     s("patch.qact")) * s("patch.qact")
    h = fq("patch.qact", h)
    last = "patch.qact"
    hc = codes_of(h, s(last), lo, hi)

    for si, st in enumerate(ip["layers"]):
        res = spec.stage_resolution(si)
        nh = spec.num_heads[si]
        for bi, ib in enumerate(st["blocks"]):
            pre = f"layers.{si}.blocks.{bi}"
            ws, shift = spec.block_window(si, bi)
            n = ws * ws
            hd = spec.stage_dim(si) // nh
            s1 = f32(s_np(f"{pre}.attn.qact1").reshape(()))
            s_a1 = f32(s_np(f"{pre}.attn.qact_attn1").reshape(()))
            s_a2 = f32(s_np(f"{pre}.attn.qact2").reshape(()))
            s_a3 = f32(s_np(f"{pre}.attn.qact3").reshape(()))
            if not lis_sum_fits(s_a2, n):
                raise ValueError(f"{pre}: softmax scale outside "
                                 "lis_sum_fits")
            table = fake_quant(t(ib["rel_bias_table"]),
                               s(f"{pre}.attn.qact_table"), lo, hi)
            idx = torch.as_tensor(relative_position_index(ws).reshape(-1),
                                  device=ar.device)
            bias_q = table[idx].reshape(n, n, nh).permute(2, 0, 1)
            mask_div = None if shift == 0 else \
                t(shift_mask(res, ws, shift) / s_a2)
            sc = t(np.asarray([s1 * s1 * f32(hd**-0.5) / s_a1, s_a1,
                               f32(1.0) / s_a2, s_a2, s1 / s_a3], f32))

            x_i8 = ln_int8(ar, hc, norm(ib["norm1"]), s(last),
                           s(f"{pre}.qact1"))
            yw = windows(x_i8, res, ws, shift)
            qkv = lin(ib["qkv"], yw, f"{pre}.qact1")
            qkv_i8 = codes_of(qkv, t(s1), lo, hi)
            o = window_attention(ar, qkv_i8, nh, bias_q, mask_div, sc, bits)
            y = lin(ib["proj"], o, f"{pre}.attn.qact3")
            s_aq4 = s(f"{pre}.attn.qact4")
            yq = torch.clamp(torch.round(y / s_aq4), lo, hi)
            hs = ar.fence(hc, s(last), unwindows(yq, res, ws, shift, b),
                          s_aq4)
            hc = codes_of(hs, s(f"{pre}.qact2"), lo, hi)
            c = hc.shape[-1]
            x_i8 = ln_int8(ar, hc, norm(ib["norm2"]), s(f"{pre}.qact2"),
                           s(f"{pre}.qact3"))
            fc1 = dict(ib["fc1"], mult=(s_np(f"{pre}.qact3")
                                        * ib["fc1"]["sw"]).astype(f32))
            fc2 = dict(ib["fc2"], mult=(s_np(f"{pre}.mlp.qact1")
                                        * ib["fc2"]["sw"]).astype(f32))
            y = mlp(ar, x_i8.reshape(-1, c), fc1, fc2,
                    s(f"{pre}.mlp.qact1"), s(f"{pre}.mlp.qact2")) \
                .reshape(x_i8.shape)
            hs = ar.fence(hc, s(f"{pre}.qact2"), y, s(f"{pre}.mlp.qact2"))
            hc = codes_of(hs, s(f"{pre}.qact4"), lo, hi)
            last = f"{pre}.qact4"
        ds = st["downsample"]
        if ds is not None:
            pre = f"layers.{si}.downsample"
            hc = merge_patches(hc, res)
            in4 = np.tile(s_np(last), 4) if s_np(last).ndim else s_np(last)
            x_i8 = ln_int8(ar, hc, norm(ds["norm"]), t(in4),
                           s(f"{pre}.qact1"))
            y = lin(ds["reduction"], x_i8, f"{pre}.qact1")
            hc = codes_of(y, s(f"{pre}.qact2"), lo, hi)
            last = f"{pre}.qact2"

    h = ln_int8(ar, hc, norm(ip["norm"]), s(last), s("qact2")).to(F32) \
        * s("qact2")
    tokens = h.new_full((), float(h.shape[1]))
    h = h.to(ar.wide).sum(1).to(F32) / tokens
    h = fq("qact3", h)
    logits = lin(ip["head"], codes_of(h, s("qact3")), "qact3")
    return fq("act_out", logits)


def forward(spec, ip, x_codes, ar: Arith):
    """The reference logits of ``spec``'s family."""
    fn = swin_forward if isinstance(spec, Swin) else vit_forward
    return fn(spec, ip, x_codes, ar)


def act_out_scale(spec, ip) -> float:
    """The act_out grid's step: the logits are its multiples."""
    s = ip["qp"]["act_out.scale"] if isinstance(spec, Swin) \
        else ip["act_out"]["scale"]
    return float(np.asarray(s).reshape(()))

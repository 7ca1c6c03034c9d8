"""Integer Swin forward (counterpart of ``diffvit_tpu/models/swin_int.py::
forward_q_int`` with ``use_pallas`` on).

The model is the int-model pytree of ``diffvit_tpu.models.swin_int.
prepare_int`` on one device, from ``models/convert.
swin_int_model_from_numpy``.  Per block: the LN, the window shuffle, the
qkv GEMM requantized onto attn.qact1, the fused window-attention kernel
(K4, or K4b with ``attn_v2``; the LIS or, under ``lis=False``, the float
softmax), the proj GEMM, the attn.qact4 / residual / qact2 fences, the LN,
the integer MLP kernel (K2) and the residual / qact4 fence; per stage the
patch merge, its LN and the reduction GEMM; then the final LN, the token
mean and the head.  Every branch of the reference is here, chosen by the
same rules:

* the codes path (integer LN and symmetric activations): the residual
  travels as int8 codes (the reference's ``hc``), the fences run on codes
  and K2 emits codes;
* the float32 stream (``sym_acts`` False, or float LN): the residual
  travels as float32 fake-quant values through the fake-quant fences, the
  qkv codes come from ``fq(attn.qact1)`` and K2 emits float32;
* float LayerNorm (``int_norm`` off, i.e. PTF off): ``float_layernorm`` +
  fake-quant + requant at norm1, norm2, the downsample norm, the patch norm
  and the final norm;
* ``input_quant=False``: the float patch product with the dequantized
  weights; int8 input codes then raise ``ValueError``.

The float LN and the float patch product, whose float32 values depend on
the order of their sums, are computed in float64 and rounded once to
float32, so the card agrees with the CPU, and both with the reference
within an ulp; the integer products are exact.

The window rows are not padded: the reference pads them to a multiple of 8
for its TPU tiles, and its pad rows only ever feed masked keys or query
rows that it slices off.
"""
from __future__ import annotations

import torch

from ..config import QuantConfig
from ..ops.int_layernorm import float_layernorm, int_layernorm
from ..ops.kernels.mlp import fused_int_mlp
from ..ops.kernels.swin_attention import (fused_swin_attention,
                                          fused_swin_attention_v2)
from ..ops.quant import fake_quant
from .swin import (SwinSpec, _merge_patches, _unwindows, _windows,
                   block_geometry, swin_patchify)
from .vit_int import F32, I8, _fp_linear, _int_dot, _ln_int8, _requant_i8


def int_linear(site, x_i8):
    """(.., K) int8 @ the site's (K, N) int8 weight, times ``mult``
    (in_scale * sw), plus the bias where the site has one."""
    y = _int_dot(x_i8, site["w_int"]).to(F32) * site["mult"]
    return y if site["b"] is None else y + site["b"]


def _float_patch(site, patches):
    """The patch product of unquantized input (``input_quant=False``):
    float32 patches times the dequantized weight ``w_int * sw`` (a float32
    product, as the reference forms it), plus the bias."""
    w = site["w_int"].to(F32) * site["sw"]  # (K, N)
    return _fp_linear(patches, {"w": w.T, "b": site["b"]})


def _codes(t, scale, bt):
    return torch.clamp(torch.round(t / scale), bt.lower_bound,
                       bt.upper_bound)


def forward_q_int(ip, spec: SwinSpec, cfg: QuantConfig, x, *,
                  attn_v2=False):
    """Integer Swin forward over a converted int-model.  ``x``: (B, 3, H,
    W) int8 qact_input codes or float32 pixels, on the model's device.
    ``attn_v2`` runs the window attention through the natural-layout
    contract (K4b) instead of K4.  Returns (B, num_classes) float32 logits
    on the act_out grid."""
    qp = ip["qp"]
    bt_a = cfg.bit_a
    eps = spec.ln_eps

    def s(path):
        return qp[f"{path}.scale"]

    def fq(path, t):
        return fake_quant(t, s(path), qp[f"{path}.zp"], bt_a)

    if x.dtype == I8:
        if not spec.input_quant:
            raise ValueError("int8 input codes require input_quant=True")
        h = int_linear(ip["patch"], swin_patchify(x, spec))
    elif spec.input_quant:
        p_i8 = _requant_i8(swin_patchify(fq("qact_input", x), spec),
                           s("qact_input"))
        h = int_linear(ip["patch"], p_i8)
    else:
        h = _float_patch(ip["patch"], swin_patchify(x, spec))
    if ip["patch_norm"] is not None:
        h = fq("patch.qact_bn", h)
        pn = ip["patch_norm"]
        if cfg.int_norm:
            h = int_layernorm(h, pn["w"], pn["b"], s("patch.qact_bn"),
                              s("patch.qact"))
        else:
            h = float_layernorm(h, pn["w"], pn["b"], eps)
    h = fq("patch.qact", h)
    last_q = "patch.qact"
    b0 = h.shape[0]

    # the codes-carrying residual stream: int8 codes on the current qact
    # grid instead of float32 fake-quant values (every zero-point is 0)
    hc = None
    if cfg.int_norm and ip.get("sym_acts", False):
        hc = _codes(h, s(last_q), bt_a).to(I8)

    def ln_i8(ln, in_scale, path):
        """The LN between the residual stream and ``path``'s int8 grid:
        the integer LN, or the float LN -> fake-quant -> requant."""
        if not cfg.int_norm:
            y = fq(path, float_layernorm(h, ln["w"], ln["b"], eps))
            return _requant_i8(y, s(path))
        return _ln_int8(h if hc is None else None, ln, in_scale, s(path),
                        eps, x_codes=hc)

    for si, st in enumerate(ip["layers"]):
        for bi, ib in enumerate(st["blocks"]):
            p = f"layers.{si}.blocks.{bi}"
            res, ws, shift, _ = block_geometry(spec, si, bi)
            nh = spec.num_heads[si]

            x_i8 = ln_i8(ib["norm1"], s(last_q), f"{p}.qact1")
            yw_i8 = _windows(x_i8, res, ws, shift)
            bw, n, c = yw_i8.shape
            hd = c // nh
            # rint((acc * (in_scale * sw) + b) / s1), not a fold into the
            # GEMM epilogue: that would round differently
            qkv = int_linear(ib["qkv"], yw_i8)
            s1 = s(f"{p}.attn.qact1")
            if hc is not None:
                qkv_i8 = _requant_i8(qkv, s1, bt_a.lower_bound,
                                     bt_a.upper_bound)
            else:
                qkv_i8 = _requant_i8(fq(f"{p}.attn.qact1", qkv), s1)
            mask_div = ib["mask_div"]
            nw = 1 if mask_div is None else mask_div.shape[0]
            kw = dict(num_heads=nh, n_real=n, n_windows=nw,
                      bits=cfg.bit_s.bits, lis=cfg.lis,
                      lis_wide=ib["lis_wide"])
            if attn_v2:
                o_i8 = fused_swin_attention_v2(
                    qkv_i8, ib["bias_q"], mask_div, ib["attn_scalars"],
                    head_dim=hd, **kw)
            else:
                # a strided view of the natural layout: no copy
                qkv_p = qkv_i8.view(bw, n, 3, nh, hd).permute(0, 2, 3, 1, 4)
                o_i8 = fused_swin_attention(
                    qkv_p, ib["bias_q"], mask_div, ib["attn_scalars"], **kw) \
                    .permute(0, 2, 1, 3).reshape(bw, n, c)
            y = int_linear(ib["proj"], o_i8)

            if hc is not None:
                # attn.qact4 -> residual -> qact2 on int8 codes
                s_aq4 = s(f"{p}.attn.qact4")
                yq = _codes(y, s_aq4, bt_a)
                hs = hc.to(F32) * s(last_q) \
                    + _unwindows(yq, res, ws, shift, b0) * s_aq4
                hc = _codes(hs, s(f"{p}.qact2"), bt_a).to(I8)
            else:
                y = fq(f"{p}.attn.qact4", y)
                h = fq(f"{p}.qact2", h + _unwindows(y, res, ws, shift, b0))

            x_i8 = ln_i8(ib["norm2"], s(f"{p}.qact2"), f"{p}.qact3")
            y = fused_int_mlp(
                x_i8.reshape(-1, c), ib["fc1"]["w_int"], ib["fc2"]["w_int"],
                ib["fc1"]["mult"], ib["fc1"]["b"], ib["fc2"]["mult"],
                ib["fc2"]["b"], s(f"{p}.mlp.qact2"), s(f"{p}.mlp.qact1"),
                emit_codes=hc is not None).reshape(x_i8.shape)
            if hc is not None:
                # mlp.qact2 codes -> residual -> qact4 on int8 codes
                hs = hc.to(F32) * s(f"{p}.qact2") \
                    + y.to(F32) * s(f"{p}.mlp.qact2")
                hc = _codes(hs, s(f"{p}.qact4"), bt_a).to(I8)
            else:
                h = fq(f"{p}.qact4", h + y)
            last_q = f"{p}.qact4"

        if st["downsample"] is not None:
            ds = st["downsample"]
            p = f"layers.{si}.downsample"
            # the merge permutes tokens; the merged grid is the source grid
            # tiled 4 times
            if hc is not None:
                hc = _merge_patches(hc, spec.stage_resolution(si))
            else:
                h = _merge_patches(h, spec.stage_resolution(si))
            x_i8 = ln_i8(ds["norm"], torch.tile(s(last_q), (4,)),
                         f"{p}.qact1")
            y = int_linear(ds["reduction"], x_i8)
            if hc is not None:
                hc = _codes(y, s(f"{p}.qact2"), bt_a).to(I8)
            else:
                h = fq(f"{p}.qact2", y)
            last_q = f"{p}.qact2"

    if cfg.int_norm:
        h = ln_i8(ip["norm"], s(last_q), "qact2").to(F32) * s("qact2")
    else:
        h = fq("qact2", float_layernorm(h, ip["norm"]["w"], ip["norm"]["b"],
                                        eps))
    # the token mean as sum / L: the float64 sum of these float32 terms is
    # exact, so the one rounding to float32 does not depend on the order
    # the device sums in (the reference's float32 sum does)
    tokens = h.new_full((), float(h.shape[1]))
    h = h.to(torch.float64).sum(1).to(F32) / tokens
    h = fq("qact3", h)
    logits = int_linear(ip["head"], _requant_i8(h, s("qact3")))
    return fq("act_out", logits)

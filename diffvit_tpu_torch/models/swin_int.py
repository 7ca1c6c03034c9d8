"""Integer Swin forward on the int8-codes residual path (counterpart of
``diffvit_tpu/models/swin_int.py::forward_q_int`` with ``use_pallas`` on).

The model is the int-model pytree of ``diffvit_tpu.models.swin_int.
prepare_int`` on one device, from ``models/convert.
swin_int_model_from_numpy``.  The residual travels as int8 codes (the
reference's ``hc``): per block the integer LN, the window shuffle, the qkv
GEMM requantized onto attn.qact1, the fused window-attention kernel (K4,
or K4b with ``attn_v2``), the proj GEMM, the attn.qact4 / residual / qact2
fences, the integer LN, the integer MLP kernel (K2) emitting codes and the
residual / qact4 fence; per stage the patch merge, its LN and the
reduction GEMM; then the final LN, the token mean and the head.  The other
branches of the reference (float LN, asymmetric activations, the float
softmax, unquantized input) raise.

The window rows are not padded: the reference pads them to a multiple of 8
for its TPU tiles, and its pad rows only ever feed masked keys or query
rows that it slices off.
"""
from __future__ import annotations

import torch

from ..config import QuantConfig
from ..ops.int_layernorm import int_layernorm
from ..ops.kernels.mlp import fused_int_mlp
from ..ops.kernels.swin_attention import (fused_swin_attention,
                                          fused_swin_attention_v2)
from ..ops.quant import fake_quant
from .swin import (SwinSpec, _merge_patches, _unwindows, _windows,
                   block_geometry, swin_patchify)
from .vit_int import I8, _int_dot, _ln_int8, _requant_i8


def int_linear(site, x_i8):
    """(.., K) int8 @ the site's (K, N) int8 weight, times ``mult``
    (in_scale * sw), plus the bias where the site has one."""
    y = _int_dot(x_i8, site["w_int"]).to(torch.float32) * site["mult"]
    return y if site["b"] is None else y + site["b"]


def _check_codes_path(ip, spec: SwinSpec, cfg: QuantConfig):
    """Raise for every branch of the reference but the codes path."""
    if not cfg.int_norm:
        raise NotImplementedError(
            "swin_int.forward_q_int: float LayerNorm (int_norm off)")
    if not ip.get("sym_acts", False):
        raise NotImplementedError(
            "swin_int.forward_q_int: asymmetric activations (sym_acts "
            "False, the f32 fence path)")
    if not cfg.lis:
        raise NotImplementedError(
            "swin_int.forward_q_int: float softmax (lis=False)")
    if not spec.input_quant:
        raise NotImplementedError(
            "swin_int.forward_q_int: input_quant=False (unquantized input)")


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
    _check_codes_path(ip, spec, cfg)
    qp = ip["qp"]
    bt_a = cfg.bit_a
    eps = spec.ln_eps

    def s(path):
        return qp[f"{path}.scale"]

    def fq(path, t):
        return fake_quant(t, s(path), qp[f"{path}.zp"], bt_a)

    if x.dtype == I8:
        p_i8 = swin_patchify(x, spec)
    else:
        p_i8 = _requant_i8(swin_patchify(fq("qact_input", x), spec),
                           s("qact_input"))
    h = int_linear(ip["patch"], p_i8)
    if ip["patch_norm"] is not None:
        h = fq("patch.qact_bn", h)
        h = int_layernorm(h, ip["patch_norm"]["w"], ip["patch_norm"]["b"],
                          s("patch.qact_bn"), s("patch.qact"))
    h = fq("patch.qact", h)
    last_q = "patch.qact"
    b0 = h.shape[0]
    hc = _codes(h, s(last_q), bt_a).to(I8)

    for si, st in enumerate(ip["layers"]):
        for bi, ib in enumerate(st["blocks"]):
            p = f"layers.{si}.blocks.{bi}"
            res, ws, shift, _ = block_geometry(spec, si, bi)
            nh = spec.num_heads[si]

            x_i8 = _ln_int8(None, ib["norm1"], s(last_q), s(f"{p}.qact1"),
                            eps, x_codes=hc)
            yw_i8 = _windows(x_i8, res, ws, shift)
            bw, n, c = yw_i8.shape
            hd = c // nh
            # rint((acc * (in_scale * sw) + b) / s1), not a fold into the
            # GEMM epilogue: that would round differently
            qkv_i8 = _requant_i8(int_linear(ib["qkv"], yw_i8),
                                 s(f"{p}.attn.qact1"), bt_a.lower_bound,
                                 bt_a.upper_bound)
            mask_div = ib["mask_div"]
            nw = 1 if mask_div is None else mask_div.shape[0]
            kw = dict(num_heads=nh, n_real=n, n_windows=nw,
                      bits=cfg.bit_s.bits, lis=cfg.lis)
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

            # attn.qact4 -> residual -> qact2 on int8 codes
            s_aq4 = s(f"{p}.attn.qact4")
            yq = _codes(y, s_aq4, bt_a)
            hs = hc.to(torch.float32) * s(last_q) \
                + _unwindows(yq, res, ws, shift, b0) * s_aq4
            hc = _codes(hs, s(f"{p}.qact2"), bt_a).to(I8)

            x_i8 = _ln_int8(None, ib["norm2"], s(f"{p}.qact2"),
                            s(f"{p}.qact3"), eps, x_codes=hc)
            y = fused_int_mlp(
                x_i8.reshape(-1, c), ib["fc1"]["w_int"], ib["fc2"]["w_int"],
                ib["fc1"]["mult"], ib["fc1"]["b"], ib["fc2"]["mult"],
                ib["fc2"]["b"], s(f"{p}.mlp.qact2"), s(f"{p}.mlp.qact1"),
                emit_codes=True).reshape(hc.shape)
            # mlp.qact2 codes -> residual -> qact4 on int8 codes
            hs = hc.to(torch.float32) * s(f"{p}.qact2") \
                + y.to(torch.float32) * s(f"{p}.mlp.qact2")
            hc = _codes(hs, s(f"{p}.qact4"), bt_a).to(I8)
            last_q = f"{p}.qact4"

        if st["downsample"] is not None:
            ds = st["downsample"]
            p = f"layers.{si}.downsample"
            # the merge permutes codes; the merged grid is the source grid
            # tiled 4 times
            hcm = _merge_patches(hc, spec.stage_resolution(si))
            x_i8 = _ln_int8(None, ds["norm"], torch.tile(s(last_q), (4,)),
                            s(f"{p}.qact1"), eps, x_codes=hcm)
            y = int_linear(ds["reduction"], x_i8)
            hc = _codes(y, s(f"{p}.qact2"), bt_a).to(I8)
            last_q = f"{p}.qact2"

    x_i8 = _ln_int8(None, ip["norm"], s(last_q), s("qact2"), eps, x_codes=hc)
    h = x_i8.to(torch.float32) * s("qact2")
    # the token mean as sum / L: the float64 sum of these float32 terms is
    # exact, so the one rounding to float32 does not depend on the order
    # the device sums in (the reference's float32 sum does)
    tokens = h.new_full((), float(h.shape[1]))
    h = h.to(torch.float64).sum(1).to(torch.float32) / tokens
    h = fq("qact3", h)
    logits = int_linear(ip["head"], _requant_i8(h, s("qact3")))
    return fq("act_out", logits)

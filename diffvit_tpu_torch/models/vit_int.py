"""Integer ViT forward on the int8-codes residual path (counterpart of
``diffvit_tpu/models/vit_int.py``).

The model is the int-model pytree of ``diffvit_tpu.models.vit_int.
prepare_int``, turned into torch tensors on one device by
``models/convert.int_model_from_numpy``.  Each block runs the reference's
codes path (``_block_int``, ``vit_int.py:365-513``): integer LayerNorm on
the residual codes, the fused qkv + Log-Int-Softmax attention kernel, the
proj GEMM, the qact3/residual/qact2 fences, integer LayerNorm with the
norm2 rescale, the integer MLP kernel emitting codes, and the
residual/qact4 fence.  The other branches of the reference's
``_block_int`` (float sites, SmoothQuant or the integer LayerNorm off,
asymmetric activations) are not ported yet and raise.

Exactness: integer products are exact (``ops.quant.int_matmul``); the
integer LayerNorm's row sums are exact int64 sums, where the reference sums
float32 values (``sum_x2`` passes 2^24 at C=384, so the reference's value
depends on its summation order); everything else rounds as the reference's
op sequence does.
"""
from __future__ import annotations

import torch

from diffvit_tpu.config import QuantConfig

from ..ops.int_layernorm import int_ln_codes
from ..ops.kernels.attention import fused_qkv_attention_v2
from ..ops.kernels.mlp import fused_int_mlp
from ..ops.quant import fake_quant, int_matmul
from .vit import ViTSpec, patchify

I8 = torch.int8


def _requant_i8(y, scale, lb=-128, ub=127):
    """f32 -> int8 codes on the ``scale`` grid."""
    return torch.clamp(torch.round(y / scale), lb, ub).to(I8)


def _int_dot(x_i8, w_i8_t):
    """(.., K) int8 @ (K, N) int8 -> int32, exact."""
    return int_matmul(x_i8, w_i8_t)


def _fq_site(site, x, bt):
    return fake_quant(x, site["scale"], site["zp"], bt)


def _ln_int8(x, ln, in_scale, out_scale_vec, eps, a_bits=8, rescale=None,
             x_codes=None):
    """Integer LayerNorm emitting int8 codes on the ``out_scale_vec`` grid
    (the M·2^-N scheme).  ``rescale``: optional per-channel grid conversion
    of the raw LN codes (the norm2 channel-scale quirk); ``x_codes``:
    the input's int8 codes on the ``in_scale`` grid, used instead of
    rounding ``x``.  ``eps`` is unused, as in the reference."""
    in_scale = in_scale.expand(ln["w"].shape[-1])
    x_q = x_codes.to(torch.float32) if x_codes is not None \
        else torch.round(x / in_scale)
    y = int_ln_codes(x_q, ln["w"], ln["b"], in_scale, out_scale_vec)
    if rescale is not None:
        y = torch.round(y * rescale)
    lb, ub = -(2 ** (a_bits - 1)), 2 ** (a_bits - 1) - 1
    return torch.clamp(y, lb, ub).to(I8)


def _embed_front(ip, spec: ViTSpec, cfg: QuantConfig, x):
    """Input quant -> patch embed -> cls/pos fences -> qact1 fake-quant.
    int8 ``x`` holds pre-encoded qact_input codes (``input_code_lut``);
    float32 ``x`` is fake-quantized here."""
    bt_a = cfg.bit_a
    pt = ip["patch"]
    if pt["fp"]:
        raise NotImplementedError("_embed_front: float (-1) patch site")
    if not spec.input_quant:
        raise NotImplementedError(
            "_embed_front: input_quant=False (unquantized input)")
    if x.dtype == I8:
        p_int = patchify(x, spec)
    else:
        x = _fq_site(ip["qact_input"], x, bt_a)
        p_int = _requant_i8(patchify(x, spec), ip["qact_input"]["scale"])
    h = _int_dot(p_int, pt["w_int"]).to(torch.float32) * pt["mult"] + pt["b"]
    h = _fq_site(ip["patch.qact"], h, bt_a)
    cls = ip["cls_token"].expand(x.shape[0], 1, spec.embed_dim)
    h = torch.cat([cls, h], dim=1)
    h = _fq_site(ip["qact_embed"], h, bt_a)
    h = h + _fq_site(ip["qact_pos"], ip["pos_embed"], bt_a)
    return _fq_site(ip["qact1"], h, bt_a)


def _head_tail(ip, spec: ViTSpec, cfg: QuantConfig, hc):
    """Final integer LN of the cls token -> head GEMM -> act_out, from the
    residual codes ``hc`` (the reference's ``int_norm`` branch with codes)."""
    if not cfg.int_norm:
        raise NotImplementedError("_head_tail: float LayerNorm (int_norm off)")
    head = ip["head"]
    if head["fp"]:
        raise NotImplementedError("_head_tail: float (-1) head site")
    s_out = ip["qact2"]["scale"]
    # the LN is per token, so only the cls row is normalized
    h_i8 = _ln_int8(None, ip["norm"], ip["blocks"][-1]["qact4"]["scale"],
                    s_out, spec.ln_eps, x_codes=hc[:, 0])
    logits = _int_dot(h_i8, head["w_int"]).to(torch.float32) * head["mult"] \
        + head["b"]
    return _fq_site(ip["act_out"], logits, cfg.bit_a)


def _check_codes_path(ib, bits4, cfg: QuantConfig, sym_acts: bool):
    """Raise for every branch of the reference's _block_int but the codes
    path, naming it."""
    if any(ib[s]["fp"] for s in ("qkv", "proj", "fc1", "fc2")) \
            or -1 in bits4:
        raise NotImplementedError("_block_int: float (-1) site in a block")
    if not cfg.smoothquant:
        raise NotImplementedError(
            "_block_int: SmoothQuant off (the fused_int_attention branch)")
    if not cfg.int_norm:
        raise NotImplementedError(
            "_block_int: float LayerNorm (int_norm off)")
    if not sym_acts:
        raise NotImplementedError(
            "_block_int: asymmetric activations (sym_acts False, the f32 "
            "fence path)")


def _block_int(ib, bits4, in_scale, h, hc, spec: ViTSpec, cfg: QuantConfig,
               *, sym_acts=False):
    """One encoder block on the int8-codes residual stream: (h, hc) ->
    (h, hc).  ``hc`` holds the residual's codes on the ``in_scale`` grid;
    when it is None, ``h`` (a fake-quant output on that grid) is turned
    into codes first."""
    _check_codes_path(ib, bits4, cfg, sym_acts)
    bt_a = cfg.bit_a
    eps = spec.ln_eps
    n_heads, h_dim = spec.num_heads, spec.head_dim
    if hc is None:
        hc = torch.clamp(torch.round(h / in_scale), bt_a.lower_bound,
                         bt_a.upper_bound).to(I8)
    B, N = hc.shape[0], hc.shape[1]
    qkv_site, proj_site = ib["qkv"], ib["proj"]
    fc1_site, fc2_site = ib["fc1"], ib["fc2"]

    # ---- attention ----
    x_i8 = _ln_int8(None, ib["norm1"], in_scale, qkv_site["in_scale"], eps,
                    x_codes=hc)
    o_i8 = fused_qkv_attention_v2(
        x_i8, qkv_site["w_int"], qkv_site["mult"], qkv_site["b"],
        ib["attn_scalars"], num_heads=n_heads, head_dim=h_dim, n_real=N,
        bits=cfg.bit_s.bits, lis=cfg.lis, lis_fast=ib["lis_fast"])
    # proj contracts the (H, D) head layout jointly
    o_flat = o_i8.permute(0, 2, 1, 3).reshape(B, N, n_heads * h_dim)
    y = _int_dot(o_flat, proj_site["w_int"]).to(torch.float32) \
        * proj_site["mult"] + proj_site["b"]

    # ---- fences + mlp ----
    s3 = ib["attn.qact3"]["scale"]
    s_blk2 = ib["qact2"]["scale"]
    yq3 = torch.clamp(torch.round(y / s3), bt_a.lower_bound,
                      bt_a.upper_bound)                    # attn.qact3
    hs = hc.to(torch.float32) * in_scale + yq3 * s3          # residual
    hc = torch.clamp(torch.round(hs / s_blk2), bt_a.lower_bound,
                     bt_a.upper_bound).to(I8)              # qact2
    x_i8 = _ln_int8(None, ib["norm2"], s_blk2,
                    fc1_site.get("ln_out_scale", fc1_site["in_scale"]), eps,
                    rescale=fc1_site.get("ln_rescale"), x_codes=hc)
    y2c = fused_int_mlp(
        x_i8.reshape(B * N, -1), fc1_site["w_int"], fc2_site["w_int"],
        fc1_site["mult"], fc1_site["b"], fc2_site["mult"], fc2_site["b"],
        ib["mlp.qact2"]["scale"], ib["mlp.qact1"]["scale"],
        emit_codes=True).reshape(B, N, -1)
    hs = hc.to(torch.float32) * s_blk2 \
        + y2c.to(torch.float32) * ib["mlp.qact2"]["scale"]   # residual
    hc = torch.clamp(torch.round(hs / ib["qact4"]["scale"]), bt_a.lower_bound,
                     bt_a.upper_bound).to(I8)              # qact4
    return h, hc


def forward_q_int(ip, spec: ViTSpec, cfg: QuantConfig, x):
    """Integer forward over a converted int-model (``int_model_from_numpy``).
    ``x``: (B, 3, H, W) int8 input codes or float32 pixels, on the model's
    device.  Returns (B, num_classes) float32 logits on the act_out grid."""
    h = _embed_front(ip, spec, cfg, x)
    bc = ip["bit_config"]
    hc = None
    for i, ib in enumerate(ip["blocks"]):
        in_scale = ip["qact1"]["scale"] if i == 0 \
            else ip["blocks"][i - 1]["qact4"]["scale"]
        h, hc = _block_int(ib, bc[4 * i + 1: 4 * i + 5], in_scale, h, hc,
                           spec, cfg, sym_acts=ip.get("sym_acts", False))
    return _head_tail(ip, spec, cfg, hc)

"""Integer ViT forward (counterpart of ``diffvit_tpu/models/vit_int.py``,
``forward_q_int`` with ``use_pallas`` on, and ``forward_q_int_serve``, the
whole encoder in one launch of the resident kernel K6).

The model is the int-model pytree of the JAX package's ``prepare_int``,
turned into torch tensors on one device by
``models/convert.int_model_from_numpy``.  Every branch of the reference's
``_embed_front``, ``_block_int`` and ``_head_tail`` is here, chosen by the
same rules (``vit_int.py:360-374``):

* the codes path (PTF, LIS and SmoothQuant on, no float site, symmetric
  activations): integer LN on the int8 residual codes, the fused qkv + LIS
  kernel (K1), the proj GEMM, the code fences, integer LN with the norm2
  rescale, the integer MLP kernel (K2) emitting codes;
* the float32 stream with the same kernels (``sym_acts`` False): K1, the
  fake-quant fences, K2 emitting float32;
* SmoothQuant off (FQ-ViT) or float LayerNorm: the qkv GEMM and its
  requant in torch, then the attention core kernel (K5,
  ``fused_int_attention``), LIS or float softmax;
* a float (-1) proj site: the unfused attention in torch;
* float LayerNorm or a float fc1/fc2 site: the unfused MLP with the
  exact-erf GELU;
* float (-1) patch and head sites, ``input_quant=False`` (an f32 wire
  through a float patch), and the float-LN head.

Exactness: integer products are exact (``ops.quant.int_matmul``); the
integer LayerNorm's row sums are exact int64 sums, where the reference sums
float32 values (``sum_x2`` passes 2^24 at C=384, so the reference's value
depends on its summation order); the float LayerNorm, the float sites'
matmuls, the exact GELU and the float softmax, whose float32 values depend
on the order of their sums or on the transcendental's implementation, are
computed in float64 and rounded once to float32, so the card agrees with
the CPU, and both with the reference within an ulp; everything else rounds
as the reference's op sequence does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import QuantConfig
from ..ops.bit_types import BIT_TYPE_DICT
from ..ops.int_layernorm import float_layernorm, int_ln_codes
from ..ops.kernels.attention import (fused_int_attention,
                                     fused_qkv_attention_v2)
from ..ops.kernels.attn_plan import key_tiles
from ..ops.kernels.mlp import fused_int_mlp
from ..ops.kernels.serve import (prepare_resident, resident_codes,
                                 scratch_layout)
from ..ops.lis import log_int_softmax_from_int
from ..ops.quant import fake_quant, int_matmul
from ..utils.tracing import span
from .convert import int_model_from_numpy
from .vit import (ViTSpec, _linear, _wq, check_search_bits, gelu_exact,
                  num_bit_slots, patchify)

I8 = torch.int8
F32, F64 = torch.float32, torch.float64


def _requant_i8(y, scale, lb=-128, ub=127):
    """f32 -> int8 codes on the ``scale`` grid."""
    return torch.clamp(torch.round(y / scale), lb, ub).to(I8)


def _int_dot(x_i8, w_i8_t):
    """(.., K) int8 @ (K, N) int8 -> int32, exact."""
    return int_matmul(x_i8, w_i8_t)


def _int_linear(x_i8, site):
    """An integer site: int32 product -> float32 ``acc * mult + b``."""
    return _int_dot(x_i8, site["w_int"]).to(F32) * site["mult"] + site["b"]


def _fp_linear(x, site):
    """A float (-1) site: ``x @ w.T + b`` of float32 ``x``, summed in
    float64 and rounded once to float32 (the reference's float32 sum
    depends on its order)."""
    return _linear(x, site["w"], site["b"])


def _fq_site(site, x, bt):
    return fake_quant(x, site["scale"], site["zp"], bt)


# ---------------------------------------------------------------------------
# Baking: (params, qparams, bit_config) -> the int-model pytree
# ---------------------------------------------------------------------------

def _host(tree):
    """A pytree of tensors (any device) or arrays as float32/int numpy,
    None kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _quant_w(w, scale, bit):
    """A (Cout, K) float32 weight -> its integer codes held in int8."""
    bt = BIT_TYPE_DICT[f"int{bit}"]
    s = scale[:, None] if scale.ndim == 1 else scale
    q = np.clip(np.round(w / s), bt.lower_bound, bt.upper_bound)
    return q.astype(np.int8)


def _t(a):
    """A weight's codes as (K, Cout), the int-model's layout."""
    return np.ascontiguousarray(a.T)


def prepare_int(params, qp, spec: ViTSpec, cfg: QuantConfig,
                bit_config=None) -> dict:
    """Bake the float params, the calibration's qparams (tensors on any
    device, or numpy) and ``bit_config`` into the int-model pytree of
    ``diffvit_tpu.models.vit_int.prepare_int``: the same keys and values,
    as host-side numpy (int8 weight codes as (K, Cout), float32 requant
    multipliers, the per-head qkv layout, the norm2 ``ln_out_scale`` and
    ``ln_rescale`` of SmoothQuant, ``sym_acts``).  -1 sites keep their
    float weights.  ``engine.IntModel``, ``convert.int_model_from_numpy``
    and ``engine.save_int_model`` take it as it is."""
    bit_config = tuple(int(v) for v in bit_config) if bit_config is not None \
        else (cfg.bit_w.bits,) * num_bit_slots(spec)
    params, qp = _host(params), _host(qp)
    ip = {"bit_config": bit_config, "blocks": []}

    def site(k):
        return {"scale": qp[f"{k}.scale"], "zp": qp[f"{k}.zp"]}

    pb = bit_config[0]
    pe = params["patch_embed"]
    if pb == -1:
        ip["patch"] = {"w": pe["w"], "b": pe["b"], "fp": True}
    elif not spec.input_quant:
        # no input QAct (vit_large): the patch input is unquantized float,
        # so only the weight is quantized, and the product stays float
        bt = BIT_TYPE_DICT[f"int{pb}"]
        w = _wq(torch.from_numpy(pe["w"]),
                torch.from_numpy(np.asarray(qp[f"patch.w.int{pb}.scale"])), bt)
        ip["patch"] = {"w": w.numpy(), "b": pe["b"], "fp": True}
    else:
        sw = qp[f"patch.w.int{pb}.scale"]
        ip["patch"] = {"w_int": _t(_quant_w(pe["w"], sw, pb)), "b": pe["b"],
                       "fp": False, "mult": qp["qact_input.scale"] * sw}
    for k in ("qact_input", "patch.qact", "qact_embed", "qact_pos", "qact1",
              "qact2", "act_out"):
        if k != "qact_input" or spec.input_quant:
            ip[k] = site(k)
    ip["cls_token"] = params["cls_token"]
    ip["pos_embed"] = params["pos_embed"]
    ip["norm"] = params["norm"]

    h, d, c = spec.num_heads, spec.head_dim, spec.embed_dim
    for i, blk in enumerate(params["blocks"]):
        p = f"blocks.{i}"
        b_qkv, b_proj, b_fc1, b_fc2 = bit_config[4 * i + 1: 4 * i + 5]
        ib = {"norm1": blk["norm1"], "norm2": blk["norm2"]}

        def smooth_site(path, lin, bit, ln_ch=None):
            if bit == -1:
                return {"w": lin["w"], "b": lin["b"], "fp": True}
            if cfg.smoothquant:
                idx = cfg.bit_pool.index(bit)
                ch = qp[f"{path}.sq.channel_scale"][idx]
                s_x = qp[f"{path}.qact0.scale"][idx]
                sw = qp[f"{path}.w.int{bit}.scale"][idx]
                w_s = lin["w"] * ch
            else:
                ch = np.float32(1.0)
                s_x = qp[f"{path}.qact0.scale"]
                sw = qp[f"{path}.w.int{bit}.scale"]
                w_s = lin["w"]
            out = {"w_int": _t(_quant_w(w_s, sw, bit)), "b": lin["b"],
                   "fp": False, "in_scale": ch * s_x, "mult": s_x * sw}
            if ln_ch is not None and cfg.smoothquant:
                # norm2 emits on the attention's channel scale; its codes
                # are rescaled by ch_attn / ch_mlp before this product
                out["ln_out_scale"] = s_x * ln_ch
                out["ln_rescale"] = ln_ch / ch
            return out

        def plain_site(path, lin, bit, in_scale):
            if bit == -1:
                return {"w": lin["w"], "b": lin["b"], "fp": True}
            sw = qp[f"{path}.int{bit}.scale"]
            return {"w_int": _t(_quant_w(lin["w"], sw, bit)), "b": lin["b"],
                    "fp": False, "mult": in_scale * sw}

        qkv = ib["qkv"] = smooth_site(f"{p}.attn.qkv", blk["qkv"], b_qkv)
        if not qkv["fp"]:
            # the per-head layout of the fully fused attention: (H, Cin, D)
            # int8 blocks and (3, H, D) multipliers and biases
            codes = qkv["w_int"].T.reshape(3, h, d, c).transpose(0, 1, 3, 2)
            qkv["wq_h"], qkv["wk_h"], qkv["wv_h"] = (
                np.ascontiguousarray(codes[j]) for j in range(3))
            qkv["mult_h"] = np.broadcast_to(qkv["mult"], (3 * c,)) \
                .reshape(3, h, d).astype(np.float32)
            qkv["bias_h"] = qkv["b"].reshape(3, h, d).astype(np.float32)
        ib["proj"] = plain_site(f"{p}.attn.proj.w", blk["proj"], b_proj,
                                qp[f"{p}.attn.qact2.scale"])
        a_idx = cfg.bit_pool.index(b_qkv) if b_qkv != -1 else -1
        attn_ch = qp[f"{p}.attn.qkv.sq.channel_scale"][a_idx] \
            if cfg.smoothquant else None
        ib["fc1"] = smooth_site(f"{p}.mlp.fc1", blk["fc1"], b_fc1,
                                ln_ch=attn_ch)
        ib["fc2"] = plain_site(f"{p}.mlp.fc2.w", blk["fc2"], b_fc2,
                               qp[f"{p}.mlp.qact1.scale"])
        for k in ("attn.qact1", "attn.qact_attn1", "attn.qact2", "attn.qact3",
                  "qact2", "mlp.qact1", "mlp.qact2", "qact4"):
            ib[k] = site(f"{p}.{k}")
        ip["blocks"].append(ib)

    hb = bit_config[-1]
    head = params["head"]
    if hb == -1:
        ip["head"] = {"w": head["w"], "b": head["b"], "fp": True}
    else:
        sw = qp[f"head.w.int{hb}.scale"]
        ip["head"] = {"w_int": _t(_quant_w(head["w"], sw, hb)),
                      "b": head["b"], "fp": False,
                      "mult": qp["qact2.scale"] * sw}

    # the codes-carrying residual path needs every activation zero-point on
    # the stream to be 0
    zps = [v["zp"] for v in ip.values() if isinstance(v, dict) and "zp" in v]
    for ib in ip["blocks"]:
        zps += [v["zp"] for v in ib.values()
                if isinstance(v, dict) and "zp" in v]
    ip["sym_acts"] = all(bool(np.all(np.asarray(z) == 0)) for z in zps)
    return ip


# ---------------------------------------------------------------------------
# The {4, 8} search space baked once (the integer search substrate)
# ---------------------------------------------------------------------------
# A candidate's int-model is the uniform 4- or 8-bit bake's site, slot by
# slot, except for one coupling: norm2 emits on the ATTENTION's SmoothQuant
# channel scale (the reference's quirk), so fc1's ln_out_scale and
# ln_rescale depend on (b_qkv, b_fc1) jointly.  Their four combinations
# are stacked per block; a consistency guard pins the stacked diagonal to
# the uniform bakes bitwise, so a coupling that prepare_int grows and this
# decomposition misses fails loudly.

_SITES = ("qkv", "proj", "fc1", "fc2")
_COMBOS = ((4, 4), (4, 8), (8, 4), (8, 8))  # (b_qkv, b_fc1) by joint index


def norm2_cross_terms(qp_host, cfg: QuantConfig, block: int):
    """fc1's ``ln_out_scale`` and ``ln_rescale`` for the four (b_qkv,
    b_fc1) combinations of block ``block``, stacked by the joint index
    ``2 * (b_qkv == 8) + (b_fc1 == 8)`` (``diffvit_tpu/models/vit_int.py:
    750-760``), from the qparams as numpy (``_host``), with
    ``prepare_int``'s float32 operations."""
    qp = qp_host
    p = f"blocks.{block}"
    idx = {b: cfg.bit_pool.index(b) for b in (4, 8)}
    ch_a = {b: qp[f"{p}.attn.qkv.sq.channel_scale"][i] for b, i in idx.items()}
    ch_m = {b: qp[f"{p}.mlp.fc1.sq.channel_scale"][i] for b, i in idx.items()}
    s_x = {b: qp[f"{p}.mlp.fc1.qact0.scale"][i] for b, i in idx.items()}
    lo = np.stack([s_x[bf] * ch_a[bq] for bq, bf in _COMBOS])
    lr = np.stack([ch_a[bq] / ch_m[bf] for bq, bf in _COMBOS])
    return lo, lr


def prepare_int_bits(params, qp, spec: ViTSpec, cfg: QuantConfig,
                     device="cuda") -> dict:
    """Bake the {4, 8} search space once (``diffvit_tpu/models/vit_int.py:
    704``): the uniform 4- and 8-bit int-models, each converted onto
    ``device`` once (``int_model_from_numpy``), and per block the norm2
    cross terms (:func:`norm2_cross_terms`) as rows on ``device``.
    :func:`select_int_bits` builds each candidate from these tensors
    without a copy, so the kernels' K-major weight copies, cached per
    tensor, are made once per bake, and the device holds two bakes.
    Raises ``ValueError`` when the stacked diagonal does not reproduce the
    uniform bakes bitwise (``vit_int.py:762-776``)."""
    n = num_bit_slots(spec)
    ip4 = prepare_int(params, qp, spec, cfg, (4,) * n)
    ip8 = prepare_int(params, qp, spec, cfg, (8,) * n)
    variants = {"b4": int_model_from_numpy(ip4, spec, device, cfg),
                "b8": int_model_from_numpy(ip8, spec, device, cfg),
                "fc1_lo": [], "fc1_lr": []}
    if not cfg.smoothquant:
        return variants
    qp_host = _host(qp)
    for i in range(spec.depth):
        lo, lr = norm2_cross_terms(qp_host, cfg, i)
        for row, ibu in ((0, ip4["blocks"][i]), (3, ip8["blocks"][i])):
            if not (np.array_equal(lo[row], ibu["fc1"]["ln_out_scale"])
                    and np.array_equal(lr[row], ibu["fc1"]["ln_rescale"])):
                raise ValueError(
                    "prepare_int_bits: norm2 cross terms diverge from "
                    f"prepare_int at block {i} — prepare_int grew a "
                    "coupling this decomposition does not model")
        variants["fc1_lo"].append([torch.tensor(r, device=device)
                                   for r in lo])
        variants["fc1_lr"].append([torch.tensor(r, device=device)
                                   for r in lr])
    return variants


def select_int_bits(variants, bits, spec: ViTSpec, cfg: QuantConfig) -> dict:
    """The int-model of the {4, 8} configuration ``bits`` from
    :func:`prepare_int_bits`'s bakes (``diffvit_tpu/models/vit_int.py:
    780``): each slot's site dict of the uniform bake of its bit, fc1's
    norm2 terms from the joint row, everything else shared with the 8-bit
    bake; no tensor is copied.  Equal to ``int_model_from_numpy(
    prepare_int(bits))`` on every entry, for :func:`forward_q_int`.
    Raises ``ValueError`` outside {4, 8}."""
    bits = check_search_bits(cfg, bits, num_bit_slots(spec),
                             smoothquant=False)
    bake = {4: variants["b4"], 8: variants["b8"]}
    ip = dict(bake[8], bit_config=bits, patch=bake[bits[0]]["patch"],
              head=bake[bits[-1]]["head"], blocks=[])
    for i, ib8 in enumerate(bake[8]["blocks"]):
        b = bits[4 * i + 1: 4 * i + 5]
        ib = dict(ib8, **{s: bake[bb]["blocks"][i][s]
                          for s, bb in zip(_SITES, b)})
        if cfg.smoothquant:
            k = 2 * (b[0] == 8) + (b[2] == 8)
            ib["fc1"] = dict(ib["fc1"], ln_out_scale=variants["fc1_lo"][i][k],
                             ln_rescale=variants["fc1_lr"][i][k])
        ip["blocks"].append(ib)
    return ip


def _codes(h, scale, bt):
    """The codes of ``h``, a fake-quant output on the ``scale`` grid."""
    return torch.clamp(torch.round(h / scale), bt.lower_bound,
                       bt.upper_bound).to(I8)


def _ln_int8(x, ln, in_scale, out_scale_vec, eps, a_bits=8, rescale=None,
             x_codes=None):
    """Integer LayerNorm emitting int8 codes on the ``out_scale_vec`` grid
    (the M·2^-N scheme).  ``rescale``: optional per-channel grid conversion
    of the raw LN codes (the norm2 channel-scale quirk); ``x_codes``:
    the input's int8 codes on the ``in_scale`` grid, used instead of
    rounding ``x``.  ``eps`` is unused, as in the reference."""
    in_scale = in_scale.expand(ln["w"].shape[-1])
    x_q = x_codes.to(F32) if x_codes is not None \
        else torch.round(x / in_scale)
    y = int_ln_codes(x_q, ln["w"], ln["b"], in_scale, out_scale_vec)
    if rescale is not None:
        y = torch.round(y * rescale)
    lb, ub = -(2 ** (a_bits - 1)), 2 ** (a_bits - 1) - 1
    return torch.clamp(y, lb, ub).to(I8)


def _float_ln(h, ln, spec: ViTSpec):
    return float_layernorm(h, ln["w"], ln["b"], spec.ln_eps)


def _embed_front(ip, spec: ViTSpec, cfg: QuantConfig, x):
    """Input quant -> patch embed -> cls/pos fences -> qact1 fake-quant.
    int8 ``x`` holds pre-encoded qact_input codes (``input_code_lut``);
    float32 ``x`` is fake-quantized here (``input_quant=False``: taken as
    it is, through the float patch)."""
    bt_a = cfg.bit_a
    pt = ip["patch"]
    if x.dtype == I8:
        if not spec.input_quant:
            raise ValueError(
                "int8 input codes require input_quant=True (vit_large-"
                "style models take unquantized input; ship f32 instead)")
        p_int = patchify(x, spec)
        h = _fp_linear(p_int.to(F32) * ip["qact_input"]["scale"], pt) \
            if pt["fp"] else _int_linear(p_int, pt)
    else:
        if spec.input_quant:
            x = _fq_site(ip["qact_input"], x, bt_a)
        patches = patchify(x, spec)
        h = _fp_linear(patches, pt) if pt["fp"] else _int_linear(
            _requant_i8(patches, ip["qact_input"]["scale"]), pt)
    h = _fq_site(ip["patch.qact"], h, bt_a)
    cls = ip["cls_token"].expand(x.shape[0], 1, spec.embed_dim)
    h = torch.cat([cls, h], dim=1)
    h = _fq_site(ip["qact_embed"], h, bt_a)
    h = h + _fq_site(ip["qact_pos"], ip["pos_embed"], bt_a)
    return _fq_site(ip["qact1"], h, bt_a)


def _head_tail(ip, spec: ViTSpec, cfg: QuantConfig, h, hc):
    """Final norm of the cls token -> head -> act_out.  ``h`` is the f32
    residual stream, ``hc`` its int8 codes or None (codes win when given).
    The LN is per token, so only the cls row is normalized."""
    head = ip["head"]
    if cfg.int_norm:
        s_out = ip["qact2"]["scale"]
        h_i8 = _ln_int8(h[:, 0] if hc is None else None, ip["norm"],
                        ip["blocks"][-1]["qact4"]["scale"], s_out,
                        spec.ln_eps,
                        x_codes=None if hc is None else hc[:, 0])
        logits = _fp_linear(h_i8.to(F32) * s_out, head) if head["fp"] \
            else _int_linear(h_i8, head)
    else:
        hf = _fq_site(ip["qact2"], _float_ln(h[:, 0], ip["norm"], spec),
                      cfg.bit_a)
        logits = _fp_linear(hf, head) if head["fp"] else _int_linear(
            _requant_i8(hf, ip["qact2"]["scale"]), head)
    return _fq_site(ip["act_out"], logits, cfg.bit_a)


def _attention_unfused(ib, qkv_i8, spec: ViTSpec, cfg: QuantConfig):
    """The attention of a block whose proj site is float (``vit_int.py:
    448-476``): scores, LIS (or float softmax) and attn@v in torch, then
    the qact2 fence and the float proj.  The LIS weights are powers of two
    and attn@v is exact, as in the reference; the float softmax and its
    attn@v are taken in float64 and rounded once to float32."""
    B, N = qkv_i8.shape[:2]
    t = qkv_i8.view(B, N, 3, spec.num_heads, spec.head_dim) \
        .permute(2, 0, 3, 1, 4)
    scalars = ib["int_attn_scalars"]  # [c1, s1/s2, s_a]
    s_a = scalars[2]
    a32 = int_matmul(t[0], t[1].transpose(-1, -2))
    a_int = torch.clamp(torch.round(a32.to(F32) * scalars[0]),
                        cfg.bit_a.lower_bound, cfg.bit_a.upper_bound)
    if cfg.lis:
        attn = log_int_softmax_from_int(a_int, s_a, cfg.bit_s).to(F64)
    else:
        attn = torch.softmax((a_int * s_a).to(F64), dim=-1) \
            .to(F32).to(F64)
    o = torch.matmul(attn, t[2].to(F64)).to(F32)
    o = o.permute(0, 2, 1, 3).reshape(B, N, spec.embed_dim) \
        * ib["attn.qact1"]["scale"]
    return _fp_linear(_fq_site(ib["attn.qact2"], o, cfg.bit_a), ib["proj"])


def whole_site(ib, name):
    """The block's integer site ``name`` ("fc1" or "fc2") with its whole
    int8 weight: under tp (``parallel.mesh.shard_int_params``) gathered
    from the rank's tp group (``ib["mlp_tp"]``)."""
    if "mlp_tp" not in ib:
        return ib[name]
    return dict(ib[name], w_int=ib["mlp_tp"][("fc1", "fc2").index(name)]())


def mlp_weights(ib):
    """fc1's and fc2's whole int8 weights (:func:`whole_site`)."""
    return tuple(whole_site(ib, n)["w_int"] for n in ("fc1", "fc2"))


def _mlp_kernel(ib, x_i8, *, emit_codes):
    """K2 over the block's (B, N, C) int8 LN2 codes: int8 mlp.qact2 codes
    or their float32 values, (B, N, C)."""
    B, N, _ = x_i8.shape
    fc1, fc2 = ib["fc1"], ib["fc2"]
    w1, w2 = mlp_weights(ib)
    return fused_int_mlp(
        x_i8.reshape(B * N, -1), w1, w2, fc1["mult"],
        fc1["b"], fc2["mult"], fc2["b"], ib["mlp.qact2"]["scale"],
        ib["mlp.qact1"]["scale"], emit_codes=emit_codes).reshape(B, N, -1)


def row_parallel(o_i8, site, tp):
    """proj on the rank's heads' codes ``o_i8`` (.., C / tp) and its Cin
    rows of the weight: the int32 partial sums summed over ``tp`` (exact in
    any order), then ``* mult + b`` as :func:`_int_linear` (``tp`` None:
    :func:`_int_linear` itself)."""
    if tp is None:
        return _int_linear(o_i8, site)
    from ..parallel import comm

    acc = comm.all_reduce(_int_dot(o_i8, site["w_int"]).contiguous(), tp)
    return acc.to(F32) * site["mult"] + site["b"]


def _block_int(ib, bits4, in_scale, h, hc, spec: ViTSpec, cfg: QuantConfig,
               *, sym_acts=False, tp=None):
    """One encoder block: (h, hc) -> (h, hc).  ``h`` is the f32 residual
    stream (meaningless while ``hc`` is set); ``hc`` its int8 codes on the
    ``in_scale`` grid, carried between blocks that take the codes path.
    ``tp``: the rank's tp group (``parallel.comm.Group``) of a block cut by
    ``parallel.mesh.shard_int_params``: attention on the rank's heads,
    proj row-parallel, the MLP on its gathered weights."""
    b_qkv, b_proj, b_fc1, b_fc2 = bits4
    bt_a = cfg.bit_a
    eps = spec.ln_eps
    n_heads, h_dim = spec.num_heads, spec.head_dim
    atp = None  # the attention's tp group: None where it runs whole
    if tp is not None:  # the rank's heads: all where tp does not divide them
        n_heads = ib["qkv"]["w_int"].shape[1] // (3 * h_dim)
        atp = tp if n_heads < spec.num_heads else None
    qkv_site, proj_site = ib["qkv"], ib["proj"]
    fc1_site, fc2_site = ib["fc1"], ib["fc2"]
    fused2_path = (not qkv_site["fp"] and not proj_site["fp"]
                   and cfg.int_norm and cfg.smoothquant)
    mlp_fused = (cfg.int_norm and not fc1_site["fp"] and not fc2_site["fp"]
                 and b_fc2 != -1)
    codes_path = fused2_path and mlp_fused and sym_acts
    if codes_path and hc is None:
        hc = _codes(h, in_scale, bt_a)  # enter codes mode
    elif not codes_path and hc is not None:
        h, hc = hc.to(F32) * in_scale, None  # leave codes mode
    B, N = (hc if codes_path else h).shape[:2]

    # ---- attention ----
    x_i8 = y = None
    if qkv_site["fp"]:
        y = _fp_linear(_float_ln(h, ib["norm1"], spec), qkv_site)
    elif codes_path:
        x_i8 = _ln_int8(None, ib["norm1"], in_scale, qkv_site["in_scale"],
                        eps, x_codes=hc)
    elif cfg.int_norm and b_proj != -1:
        x_i8 = _ln_int8(h, ib["norm1"], in_scale, qkv_site["in_scale"], eps)
    else:
        x_i8 = _requant_i8(_float_ln(h, ib["norm1"], spec),
                           qkv_site["in_scale"])
    if fused2_path:
        o_i8 = fused_qkv_attention_v2(
            x_i8, qkv_site["w_int"], qkv_site["mult"], qkv_site["b"],
            ib["attn_scalars"], num_heads=n_heads, head_dim=h_dim, n_real=N,
            bits=cfg.bit_s.bits, lis=cfg.lis, lis_fast=ib["lis_fast"],
            lis_wide=ib["lis_wide"])
        # proj contracts the (H, D) head layout jointly
        y = row_parallel(o_i8.permute(0, 2, 1, 3).reshape(B, N, -1),
                         proj_site, atp)
    else:
        if y is None:
            y = _int_linear(x_i8, qkv_site)
        # the qkv requant divides by s1 (a tensor: CUDA torch would take
        # the reciprocal of a Python number)
        qkv_i8 = _requant_i8(y, ib["attn.qact1"]["scale"])
        if proj_site["fp"]:
            y = _attention_unfused(ib, qkv_i8, spec, cfg)
        else:
            qkv5 = qkv_i8.view(B, N, 3, n_heads, h_dim).permute(0, 2, 3, 1, 4)
            o_i8 = fused_int_attention(
                qkv5, ib["int_attn_scalars"], num_heads=n_heads, n_real=N,
                bits=cfg.bit_s.bits, lis=cfg.lis, lis_wide=ib["lis_wide"])
            y = row_parallel(o_i8.permute(0, 2, 1, 3).reshape(B, N, -1),
                             proj_site, atp)

    # ---- fences + mlp ----
    s_blk2 = ib["qact2"]["scale"]
    ln_out = fc1_site.get("ln_out_scale", fc1_site.get("in_scale"))
    ln_rescale = fc1_site.get("ln_rescale")
    if codes_path:
        s3 = ib["attn.qact3"]["scale"]
        yq3 = torch.clamp(torch.round(y / s3), bt_a.lower_bound,
                          bt_a.upper_bound)                # attn.qact3
        hs = hc.to(F32) * in_scale + yq3 * s3              # residual
        hc = _codes(hs, s_blk2, bt_a)                      # qact2
        x_i8 = _ln_int8(None, ib["norm2"], s_blk2, ln_out, eps,
                        rescale=ln_rescale, x_codes=hc)
        y2c = _mlp_kernel(ib, x_i8, emit_codes=True)
        hs = hc.to(F32) * s_blk2 \
            + y2c.to(F32) * ib["mlp.qact2"]["scale"]       # residual
        return h, _codes(hs, ib["qact4"]["scale"], bt_a)   # qact4
    y = _fq_site(ib["attn.qact3"], y, bt_a)
    h = _fq_site(ib["qact2"], h + y, bt_a)
    if mlp_fused:
        x_i8 = _ln_int8(h, ib["norm2"], s_blk2, ln_out, eps,
                        rescale=ln_rescale)
        y = _mlp_kernel(ib, x_i8, emit_codes=False)
    else:
        if fc1_site["fp"]:
            y = _fp_linear(_float_ln(h, ib["norm2"], spec), fc1_site)
        else:
            if cfg.int_norm and b_fc2 != -1:
                x_i8 = _ln_int8(h, ib["norm2"], s_blk2, ln_out, eps,
                                rescale=ln_rescale)
            else:
                x_i8 = _requant_i8(_float_ln(h, ib["norm2"], spec),
                                   fc1_site["in_scale"])
            y = _int_linear(x_i8, whole_site(ib, "fc1"))
        y = gelu_exact(y)
        if fc2_site["fp"]:
            y = _fp_linear(_fq_site(ib["mlp.qact1"], y, bt_a), fc2_site)
        else:
            y = _int_linear(_requant_i8(y, ib["mlp.qact1"]["scale"]),
                            whole_site(ib, "fc2"))
        y = _fq_site(ib["mlp.qact2"], y, bt_a)
    return _fq_site(ib["qact4"], h + y, bt_a), hc


def forward_q_int(ip, spec: ViTSpec, cfg: QuantConfig, x, *, tp=None):
    """Integer forward over a converted int-model (``int_model_from_numpy``).
    ``x``: (B, 3, H, W) int8 input codes or float32 pixels, on the model's
    device.  Returns (B, num_classes) float32 logits on the act_out grid.
    ``tp``: the rank's tp group, for a model cut by
    ``parallel.mesh.shard_int_params`` (:func:`_block_int`)."""
    with span("dvt.embed"):
        h = _embed_front(ip, spec, cfg, x)
    bc = ip["bit_config"]
    sym_acts = bool(ip.get("sym_acts", False))
    hc = None
    with span("dvt.encoder") as enc:
        if enc is not None:
            enc.count("attn_key_tiles", key_tiles(spec.seq_len))
        for i, ib in enumerate(ip["blocks"]):
            in_scale = ip["qact1"]["scale"] if i == 0 \
                else ip["blocks"][i - 1]["qact4"]["scale"]
            h, hc = _block_int(ib, bc[4 * i + 1: 4 * i + 5], in_scale, h, hc,
                               spec, cfg, sym_acts=sym_acts, tp=tp)
    with span("dvt.head"):
        return _head_tail(ip, spec, cfg, h, hc)


# The most K6 scratch (``serve.scratch_layout``: 5C + hidden bytes a row)
# one launch of the resident forward takes: 128 DeiT-S images of 197 rows
# of 3,456 bytes.  On an H100 a launch of 128 images costs within 2% an
# image of one of 256, and 64 costs 9% more (PERF.md §6, K6's sweep).  It
# also keeps every launch far inside K6's 32-bit row indexing, which
# refuses a launch of about 7,000 DeiT-S images (3,500 DeiT-B).
K6_SCRATCH_BYTES = 128 * 197 * 3456


def even_split(b: int, most: int) -> list[int]:
    """``b`` images as the fewest launches of at most ``most`` each, their
    sizes differing by at most one, largest first: 65 at most 64 is
    [33, 32]."""
    n = -(-b // most)
    q, r = divmod(b, n)
    return [q + 1] * r + [q] * (n - r)


def k6_launches(b: int, npad: int, c: int, hid: int,
                microbatch="scratch") -> list[int]:
    """The images of each K6 launch of :func:`forward_q_int_serve` for a
    batch of ``b`` images of ``npad`` rows, width ``c`` and MLP width
    ``hid`` (its ``microbatch``)."""
    if microbatch is None:
        return [b]
    if microbatch == "scratch":
        off, row = scratch_layout(npad, c, hid)["hidden"]
        microbatch = max(1, K6_SCRATCH_BYTES // (off + npad * row))
    return even_split(b, int(microbatch))


def forward_q_int_serve(ip, spec: ViTSpec, cfg: QuantConfig, x, *,
                        packed=None, microbatch="scratch"):
    """The serving forward whose encoder runs as launches of the resident
    kernel (``ops/kernels/serve.py``, K6), each the whole encoder for its
    images, instead of two kernels and the torch glue per block.  The same
    logits as :func:`forward_q_int`'s codes path (which this needs:
    ``prepare_resident`` refuses every other configuration).

    ``packed``: ``prepare_resident(ip, spec, cfg)``, passed to pack once
    across calls.  ``microbatch``: the most images a launch takes; a batch
    above it goes through the kernel in the fewest launches of near-equal
    size (:func:`k6_launches`), with the same result as one launch, since
    K6 computes each image on its own.  "scratch" (the default): as many
    as ``K6_SCRATCH_BYTES`` of K6 scratch holds at the model's widths; an
    int: that many; None: any batch in one launch."""
    if packed is None:
        packed = prepare_resident(ip, spec, cfg)
    with span("dvt.embed"):
        h = _embed_front(ip, spec, cfg, x)
        B, N, C = h.shape
        hc = _codes(h, ip["qact1"]["scale"], cfg.bit_a)
    lis_wide = any(ib["lis_wide"] for ib in ip["blocks"])

    def run(chunk):  # (b, N, C) int8 codes -> the last block's codes
        b = chunk.shape[0]
        return resident_codes(packed, chunk.reshape(b * N, C), n_real=N,
                              bits=cfg.bit_s.bits, lis=cfg.lis,
                              nelems=b, lis_wide=lis_wide).reshape(b, N, C)

    with span("dvt.encoder") as enc:
        if enc is not None:
            enc.count("attn_key_tiles", key_tiles(N))
        sizes = k6_launches(B, N, C, packed["w1"].shape[2], microbatch)
        out = run(hc) if len(sizes) == 1 else \
            torch.cat([run(chunk) for chunk in hc.split(sizes)])
    with span("dvt.head"):
        return _head_tail(ip, spec, cfg, None, out)

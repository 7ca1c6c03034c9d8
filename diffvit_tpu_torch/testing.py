"""Seeded synthetic int-models in ``prepare_int``'s exact schemas.

There are no pretrained weights in the repository, so the port is driven
at full width on random models.  ``random_int_model`` builds, with numpy
only, the int-model pytree that ``diffvit_tpu.models.vit_int.prepare_int``
would bake for a DeiT/ViT spec, a QuantConfig and a bit config: exactly
the keys that ``_embed_front``, ``_block_int`` and ``_head_tail`` read,
plus ``bit_config`` and ``sym_acts=True``.  ``random_swin_int_model`` does
the same for ``diffvit_tpu.models.swin_int.prepare_int`` and a Swin spec,
at a uniform bit width or a per-slot {4, 8} bit config.  The JAX forwards
accept them unchanged
(``tests/test_torch_vit_int.py``, ``tests/test_torch_fqvit.py`` and
``tests/test_torch_swin.py`` hold each against the port), so they are
valid int-models, not private formats.

* weights are int codes of each slot's width (``cfg.bit_w``'s by
  default), or float for a -1 slot;
* every zero-point is 0 (symmetric activations);
* every scale is a power of two chosen from the site's fan-in, so that
  activations keep a spread of about one in value space, use a good part
  of the int8 range and saturate only in the tails;
* the softmax scale lies inside ``lis_fast_ok``'s window.

``alt_kernel_cases`` and ``linear_site_cases`` cut the arguments of the
kernels that no model path runs (K3, K7a, K7b, K8) from such a model's
blocks and sites, for the tests and ``chip_smoke.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import QuantConfig
from .models import swin
from .models.convert import (attn_block_operands, int_model_from_numpy,
                             mlp_block_operands, swin_int_model_from_numpy)
from .models.vit import ViTSpec, num_bit_slots


f32 = np.float32


def _pot(x):
    return f32(2.0 ** np.round(np.log2(x)))


def _weight(rng, bits, fan_in, fan_out, gain):
    """int weight codes (fan_in, fan_out) of ``bits`` and a per-channel
    weight scale s_w picked so that the output std is ~gain times the
    input std (in value space)."""
    w_hi = 2 ** (bits - 1) - 1
    w_std = (2 ** bits) / np.sqrt(12.0)  # std of uniform codes
    w = rng.integers(-w_hi - 1, w_hi + 1, (fan_in, fan_out)).astype(np.int8)
    s_w = _pot(gain / (np.sqrt(fan_in) * w_std)) \
        * 2.0 ** rng.integers(-1, 1, fan_out)
    return w, s_w.astype(f32)


def _norm(rng, c):
    return {"w": (1.0 + 0.1 * rng.standard_normal(c)).astype(f32),
            "b": (0.1 * rng.standard_normal(c)).astype(f32)}


def random_int_model(spec: ViTSpec, cfg: QuantConfig | None = None,
                     seed: int = 0, bit_config=None) -> dict:
    """The schema ``prepare_int`` bakes for ``cfg`` and ``bit_config``
    (default: every slot ``cfg.bit_w``, int4 by default).  A -1 slot is a
    float site ``{"w": (out, in) float32, "b", "fp": True}``; with
    SmoothQuant off the sites carry no channel factors (scalar
    ``in_scale``, no ``ln_out_scale``/``ln_rescale``); with PTF off the LN
    inputs take scalar (layer-wise) scales; ``input_quant=False`` gives a
    float patch and no ``qact_input``."""
    cfg = cfg or QuantConfig()
    bc = tuple(int(b) for b in bit_config) if bit_config is not None \
        else (cfg.bit_w.bits,) * num_bit_slots(spec)
    rng = np.random.default_rng(seed)
    c, hid, n = spec.embed_dim, spec.hidden_dim, spec.seq_len

    def site(scale):
        return {"scale": np.asarray(scale, f32), "zp": np.asarray(0.0, f32)}

    def ptf(base, size):
        # per-channel PTF grid: base * 2^k, k in {0, 1}; layer-wise without
        # PTF
        k = rng.integers(0, 2, size)
        return (base * 2.0 ** k).astype(f32) if cfg.ptf else f32(base)

    def linear(bits, fan_in, fan_out, in_step, gain=1.0):
        """int weight codes + per-channel multiplier (in_step * s_w), or a
        float site of the same gain for bits -1."""
        if bits == -1:
            std = gain / np.sqrt(fan_in)
            w = rng.standard_normal((fan_out, fan_in)) * std
            return {"w": w.astype(f32),
                    "b": (0.02 * rng.standard_normal(fan_out)).astype(f32),
                    "fp": True}
        w, s_w = _weight(rng, bits, fan_in, fan_out, gain)
        return {"w_int": w, "b": (0.02 * rng.standard_normal(fan_out)).astype(f32),
                "fp": False, "mult": (in_step * s_w).astype(f32)}

    def norm():
        return _norm(rng, c)

    s_in = f32(2.0**-5)   # ImageNet-normalized pixels span about +-2.6
    act = f32(2.0**-5)    # activations of std ~1 span +-4
    patch_bits = bc[0] if spec.input_quant else -1
    ip = {
        "bit_config": bc,
        "patch": linear(patch_bits, 3 * spec.patch_size**2, c, s_in),
        "qact_input": site(s_in), "patch.qact": site(act),
        "qact_embed": site(act), "qact_pos": site(act / 2),
        "qact1": site(ptf(act, c)), "qact2": site(act),
        "act_out": site(f32(2.0**-4)),
        "cls_token": rng.standard_normal((1, 1, c)).astype(f32),
        "pos_embed": (0.5 * rng.standard_normal((1, n, c))).astype(f32),
        "norm": norm(),
        "blocks": [],
    }
    if not spec.input_quant:
        del ip["qact_input"]
    s1, s2, s_a = 2 * act, 2 * act, f32(2.0**-4)
    for i in range(spec.depth):
        b_qkv, b_proj, b_fc1, b_fc2 = bc[4 * i + 1: 4 * i + 5]
        ch_attn = (2.0 ** rng.integers(0, 2, c)).astype(f32)
        ch_mlp = (2.0 ** rng.integers(0, 2, c)).astype(f32)
        if not cfg.smoothquant:
            ch_attn = ch_mlp = f32(1.0)
        # LN codes on the (channel scale x act) grid, output multiplier
        # act * s_w
        qkv = linear(b_qkv, c, 3 * c, act, gain=4.0)
        fc1 = linear(b_fc1, c, hid, act, gain=1.5)
        if not qkv["fp"]:
            qkv["in_scale"] = (ch_attn * act).astype(f32)
        if not fc1["fp"]:
            fc1["in_scale"] = (ch_mlp * act).astype(f32)
            if cfg.smoothquant:
                # norm2 emits on the attention's channel grid (prepare_int's
                # quirk)
                fc1["ln_out_scale"] = (act * ch_attn).astype(f32)
                fc1["ln_rescale"] = (ch_attn / ch_mlp).astype(f32)
        ip["blocks"].append({
            "norm1": norm(), "norm2": norm(),
            "qkv": qkv,
            "proj": linear(b_proj, c, c, s2, gain=0.25),
            "fc1": fc1,
            "fc2": linear(b_fc2, hid, c, act / 2, gain=0.25),
            "attn.qact1": site(s1), "attn.qact_attn1": site(s_a),
            "attn.qact2": site(s2), "attn.qact3": site(ptf(act / 2, c)),
            "qact2": site(ptf(act, c)), "mlp.qact1": site(act / 2),
            "mlp.qact2": site(ptf(act / 2, c)), "qact4": site(ptf(act, c)),
        })
    ip["head"] = linear(bc[-1], c, spec.num_classes, act)
    ip["sym_acts"] = True
    return ip


def random_swin_int_model(spec: swin.SwinSpec,
                          cfg: QuantConfig | None = None,
                          seed: int = 0, bit_config=None) -> dict:
    """Swin ``prepare_int``'s schema (``diffvit_tpu/models/swin_int.py:
    25-82``): ``qp``, the flat ``{site}.scale`` / ``{site}.zp`` dict of the
    activation sites (and ``{weight}.int{bits}.scale``), ``layers`` of
    blocks and downsamples, ``patch``, ``patch_norm``, ``norm``, ``head``,
    ``bit_config`` and ``sym_acts=True``.  Each weight takes its slot of
    ``bit_config`` (4 or 8; default: every slot ``cfg.bit_w``), in
    ``prepare_int``'s order: the patch, four per block, a stage's reduction
    after its blocks, the head.  Every scale is a power of two; under PTF
    the LN inputs (qact2, qact4, mlp.qact2, the downsample's qact2) take
    per-channel grids, without it layer-wise ones; the softmax scale
    attn.qact2 is 2^-4, well inside ``lis_sum_fits`` for a window;
    ``input_quant=False`` gives no ``qact_input``."""
    cfg = cfg or QuantConfig()
    bc = swin.normalize_bit_config(
        spec, bit_config if bit_config is not None else cfg.bit_w.bits)
    if not all(b in (4, 8) for b in bc):
        raise ValueError("the Swin integer path takes {4, 8} slots only")
    slots = iter(bc)
    rng = np.random.default_rng(seed)
    qp = {}
    act = f32(2.0**-5)  # activations of std ~1 span +-4

    def site(path, scale):
        qp[f"{path}.scale"] = np.asarray(scale, f32)
        qp[f"{path}.zp"] = np.asarray(0.0, f32)

    def ptf(path, base, c):
        site(path, base * 2.0 ** rng.integers(0, 2, c) if cfg.ptf else base)

    def w_site(path, fan_in, fan_out, gain, bias=True):
        bits = next(slots)
        w, s_w = _weight(rng, bits, fan_in, fan_out, gain)
        qp[f"{path}.int{bits}.scale"] = s_w
        b = (0.02 * rng.standard_normal(fan_out)).astype(f32) if bias \
            else None
        return {"w_int": w, "sw": s_w, "bit": bits, "b": b}

    c0 = spec.embed_dim
    if spec.input_quant:
        site("qact_input", act)  # normalized pixels span about +-2.6
    ip = {"bit_config": bc, "layers": [], "qp": qp,
          "patch": w_site("patch.w", 3 * spec.patch_size**2, c0, 1.0)}
    ip["patch_norm"] = _norm(rng, c0) if spec.patch_norm else None
    site("patch.qact_bn", act)
    site("patch.qact", act)
    for s in range(spec.num_layers):
        c, nh = spec.stage_dim(s), spec.num_heads[s]
        hid = spec.mlp_ratio * c
        _, ws, _, _ = swin.block_geometry(spec, s, 0)
        st = {"blocks": [], "downsample": None}
        for bi in range(spec.depths[s]):
            p = f"layers.{s}.blocks.{bi}"
            st["blocks"].append({
                "norm1": _norm(rng, c), "norm2": _norm(rng, c),
                "qkv": w_site(f"{p}.attn.qkv.w", c, 3 * c, 1.5),
                "proj": w_site(f"{p}.attn.proj.w", c, c, 0.25),
                "fc1": w_site(f"{p}.mlp.fc1.w", c, hid, 1.5),
                "fc2": w_site(f"{p}.mlp.fc2.w", hid, c, 0.25),
                "rel_bias_table": (0.5 * rng.standard_normal(
                    ((2 * ws - 1) ** 2, nh))).astype(f32),
            })
            site(f"{p}.qact1", act)
            site(f"{p}.attn.qact1", act)
            site(f"{p}.attn.qact_attn1", 2 * act)
            site(f"{p}.attn.qact_table", act)
            site(f"{p}.attn.qact2", 2 * act)
            site(f"{p}.attn.qact3", act)
            site(f"{p}.attn.qact4", act / 2)
            ptf(f"{p}.qact2", act, c)
            site(f"{p}.qact3", act)
            site(f"{p}.mlp.qact1", act / 2)
            ptf(f"{p}.mlp.qact2", act / 2, c)
            ptf(f"{p}.qact4", act, c)
        if s < spec.num_layers - 1:
            p = f"layers.{s}.downsample"
            st["downsample"] = {
                "norm": _norm(rng, 4 * c),
                "reduction": w_site(f"{p}.reduction.w", 4 * c, 2 * c, 1.0,
                                    bias=False)}
            site(f"{p}.qact1", act)
            ptf(f"{p}.qact2", act, 2 * c)
        ip["layers"].append(st)
    ip["norm"] = _norm(rng, spec.num_features)
    ip["head"] = w_site("head.w", spec.num_features, spec.num_classes, 1.0)
    site("qact2", act)
    site("qact3", act / 4)
    site("act_out", 2 * act)
    ip["sym_acts"] = True
    return ip


def int8_codes(shape, seed, std=30.0) -> np.ndarray:
    """Seeded int8 codes of about ``std`` spread (an LN output's, by
    default)."""
    rng = np.random.default_rng(seed)
    return np.clip(np.round(rng.standard_normal(shape) * std), -128,
                   127).astype(np.int8)


def alt_kernel_cases(spec: ViTSpec, ip, batch, device, *, npad=None,
                     lis=True, seed=0) -> dict:
    """The arguments of K8 (``fused_qkv_attention`` v1, ``_v3``, ``_v4``,
    ``_v5``), K7a (``fused_attention_block``) and K7b
    (``fused_int_mlp_block``) at block 0 of the ViT int-model ``ip``
    (numpy, ``random_int_model``'s schema), for ``batch`` images:
    LN-like int8 codes x (B, Npad, C), zero at and past the spec's
    ``seq_len`` as the JAX callers pad them; a residual h (codes on the
    block's input grid) and, for K7b, a proj output y of the qact3 grid's
    spread, (B * seq_len, C).  Returns ``{name: (args, kwargs)}`` of torch
    tensors on ``device``."""
    ib = int_model_from_numpy(ip, spec, device)["blocks"][0]
    n, c = spec.seq_len, spec.embed_dim
    npad = npad or n
    t = lambda a: torch.tensor(a, device=device)  # noqa: E731
    x = int8_codes((batch, npad, c), seed)
    x[:, n:] = 0
    in_scale = np.broadcast_to(np.asarray(ip["qact1"]["scale"], f32), (c,))
    h = (int8_codes((batch, npad, c), seed + 1, std=40) * in_scale).astype(f32)
    s3 = np.asarray(ip["blocks"][0]["attn.qact3"]["scale"], f32)
    rng = np.random.default_rng(seed + 2)
    y = (rng.standard_normal((batch * n, c)) * 30 * s3).astype(f32)
    h_rows = (int8_codes((batch * n, c), seed + 3, std=40)
              * in_scale).astype(f32)
    ab = attn_block_operands(ib, spec)
    q = ib["qkv"]
    k8 = dict(num_heads=spec.num_heads, head_dim=spec.head_dim, n_real=n,
              lis=lis)
    v345 = ((t(x), q["w_int"], q["mult"], q["b"], ab["scalars"]), k8)
    heads = tuple(ab[k] for k in ("wq", "wk", "wv", "mult", "bias"))
    return {
        "fused_qkv_attention": ((t(x), *heads, ab["scalars"]),
                                dict(n_real=n, lis=lis)),
        "fused_qkv_attention_v3": v345,
        "fused_qkv_attention_v4": v345,
        "fused_qkv_attention_v5": v345,
        "fused_attention_block": (
            (t(x), t(h), *heads[:3], ab["wp"], *heads[3:], ab["pvec"],
             ab["scalars"]), dict(n_real=n, lis=lis)),
        "fused_int_mlp_block": (
            (t(y), t(h_rows)), mlp_block_operands(ib)),
    }


def linear_site_cases(spec, ip, batch, device, *, seed=0) -> dict:
    """K3's (``fused_int_linear``) arguments at the integer GEMM sites of a
    model for ``batch`` images: for a ViT int-model (numpy,
    ``random_int_model``'s schema) the patch embed (K = 3 * 16 * 16), the
    block-0 qkv, proj and fc1 and the head (one row an image); for a Swin
    one (``random_swin_int_model``'s) the patch embed (K = 48) and the
    stage-0 qkv over every window row.  Each site is ``(args, out_scale)``
    with args (x, w_int, mult, bias) of torch tensors on ``device`` and
    out_scale the grid of the site's consumer (its next fence), for the fq
    and codes modes."""
    if isinstance(spec, swin.SwinSpec):
        m = swin_int_model_from_numpy(ip, spec, device)
        qp = m["qp"]
        res = spec.img_size // spec.patch_size
        sites = {"patch": (m["patch"], batch * res * res,
                           qp["patch.qact.scale"]),
                 "qkv": (m["layers"][0]["blocks"][0]["qkv"],
                         batch * res * res,
                         qp["layers.0.blocks.0.attn.qact1.scale"])}
    else:
        m = int_model_from_numpy(ip, spec, device)
        ib = m["blocks"][0]
        rows = batch * spec.seq_len
        sites = {"patch": (m["patch"], batch * (spec.seq_len - 1),
                           m["patch.qact"]["scale"]),
                 "qkv": (ib["qkv"], rows, ib["attn.qact1"]["scale"]),
                 "proj": (ib["proj"], rows, ib["attn.qact3"]["scale"]),
                 "fc1": (ib["fc1"], rows, ib["mlp.qact1"]["scale"]),
                 "head": (m["head"], batch, m["act_out"]["scale"])}
    out = {}
    for i, (name, (site, rows, out_scale)) in enumerate(sites.items()):
        x = torch.tensor(int8_codes((rows, site["w_int"].shape[0]),
                                    seed + i), device=device)
        out[name] = ((x, site["w_int"], site["mult"], site["b"]), out_scale)
    return out

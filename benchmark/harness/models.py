"""The benchmark's inputs, made from ``--seed``: a seeded int-model in the
schema that ``prepare_int`` bakes (the same keys and value rules as the
program's random int-models, frozen here so that the yardstick does not
move with the program), and the int8 input codes of seeded uint8 pixels.

* weights are int codes of ``bit_w``, with a per-channel power-of-two
  scale picked from the site's fan-in, so that activations keep a spread
  of about one in value space, use a good part of the int8 range and
  saturate only in the tails;
* every zero-point is 0 (symmetric activations), every scale a power of
  two, the PTF grids per channel;
* the softmax scale lies inside the fast LIS window and ``lis_sum_fits``.

The pytree is host numpy: the program loads it as an artifact, the
reference reads it as it is."""
from __future__ import annotations

import numpy as np

from .specs import Swin, ViT

f32 = np.float32
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def streams(seed: int, n: int = 4) -> list[np.random.Generator]:
    """``n`` independent generators of ``seed`` (any integer): the model,
    the pixels, the traffic's order and the check's sample."""
    ss = np.random.SeedSequence(int(seed) % 2**64)
    return [np.random.default_rng(s) for s in ss.spawn(n)]


def _pot(x):
    return f32(2.0 ** np.round(np.log2(x)))


def _weight(rng, bits, fan_in, fan_out, gain):
    """int weight codes (fan_in, fan_out) of ``bits`` and a per-channel
    weight scale s_w picked so that the output std is about ``gain``
    times the input std (in value space)."""
    w_hi = 2 ** (bits - 1) - 1
    w_std = (2 ** bits) / np.sqrt(12.0)  # std of uniform codes
    w = rng.integers(-w_hi - 1, w_hi + 1, (fan_in, fan_out)).astype(np.int8)
    s_w = _pot(gain / (np.sqrt(fan_in) * w_std)) \
        * 2.0 ** rng.integers(-1, 1, fan_out)
    return w, s_w.astype(f32)


def _norm(rng, c):
    return {"w": (1.0 + 0.1 * rng.standard_normal(c)).astype(f32),
            "b": (0.1 * rng.standard_normal(c)).astype(f32)}


def vit_int_model(spec: ViT, rng: np.random.Generator) -> dict:
    """A ViT int-model at ``spec.quant``'s uniform weight bits: every site
    integer, the codes path's schema (per-head qkv layout excluded: the
    served models do not read it)."""
    q = spec.quant
    bits = q.w_bits
    bc = (bits,) * (4 * spec.depth + 2)
    c, hid, n = spec.embed_dim, spec.hidden_dim, spec.seq_len

    def site(scale):
        return {"scale": np.asarray(scale, f32), "zp": np.asarray(0.0, f32)}

    def ptf(base, size):
        k = rng.integers(0, 2, size)
        return (base * 2.0 ** k).astype(f32) if q["ptf"] else f32(base)

    def linear(fan_in, fan_out, in_step, gain=1.0):
        w, s_w = _weight(rng, bits, fan_in, fan_out, gain)
        return {"w_int": w,
                "b": (0.02 * rng.standard_normal(fan_out)).astype(f32),
                "fp": False, "mult": (in_step * s_w).astype(f32)}

    s_in = f32(2.0**-5)   # ImageNet-normalized pixels span about +-2.6
    act = f32(2.0**-5)    # activations of std ~1 span +-4
    ip = {
        "bit_config": bc,
        "patch": linear(3 * spec.patch_size**2, c, s_in),
        "qact_input": site(s_in), "patch.qact": site(act),
        "qact_embed": site(act), "qact_pos": site(act / 2),
        "qact1": site(ptf(act, c)), "qact2": site(act),
        "act_out": site(f32(2.0**-4)),
        "cls_token": rng.standard_normal((1, 1, c)).astype(f32),
        "pos_embed": (0.5 * rng.standard_normal((1, n, c))).astype(f32),
        "norm": _norm(rng, c),
        "blocks": [],
    }
    s1, s2, s_a = 2 * act, 2 * act, f32(2.0**-4)
    for _ in range(spec.depth):
        ch_attn = (2.0 ** rng.integers(0, 2, c)).astype(f32)
        ch_mlp = (2.0 ** rng.integers(0, 2, c)).astype(f32)
        if not q["smoothquant"]:
            ch_attn = ch_mlp = f32(1.0)
        qkv = linear(c, 3 * c, act, gain=4.0)
        fc1 = linear(c, hid, act, gain=1.5)
        qkv["in_scale"] = (ch_attn * act).astype(f32)
        fc1["in_scale"] = (ch_mlp * act).astype(f32)
        if q["smoothquant"]:
            # norm2 emits on the attention's channel grid (prepare_int's
            # quirk)
            fc1["ln_out_scale"] = (act * ch_attn).astype(f32)
            fc1["ln_rescale"] = (ch_attn / ch_mlp).astype(f32)
        ip["blocks"].append({
            "norm1": _norm(rng, c), "norm2": _norm(rng, c),
            "qkv": qkv,
            "proj": linear(c, c, s2, gain=0.25),
            "fc1": fc1,
            "fc2": linear(hid, c, act / 2, gain=0.25),
            "attn.qact1": site(s1), "attn.qact_attn1": site(s_a),
            "attn.qact2": site(s2), "attn.qact3": site(ptf(act / 2, c)),
            "qact2": site(ptf(act, c)), "mlp.qact1": site(act / 2),
            "mlp.qact2": site(ptf(act / 2, c)), "qact4": site(ptf(act, c)),
        })
    ip["head"] = linear(c, spec.num_classes, act)
    ip["sym_acts"] = True
    return ip


def swin_int_model(spec: Swin, rng: np.random.Generator) -> dict:
    """A Swin int-model at ``spec.quant``'s uniform weight bits: ``qp``, the
    flat ``{site}.scale`` / ``{site}.zp`` dict (and each weight's
    ``{weight}.int{bits}.scale``), ``layers`` of blocks and downsamples,
    ``patch``, ``patch_norm``, ``norm``, ``head``, ``bit_config`` and
    ``sym_acts``."""
    q = spec.quant
    bits = q.w_bits
    n_slots = 1 + 4 * sum(spec.depths) + (spec.num_layers - 1) + 1
    bc = (bits,) * n_slots
    qp = {}
    act = f32(2.0**-5)

    def site(path, scale):
        qp[f"{path}.scale"] = np.asarray(scale, f32)
        qp[f"{path}.zp"] = np.asarray(0.0, f32)

    def ptf(path, base, c):
        site(path, base * 2.0 ** rng.integers(0, 2, c) if q["ptf"] else base)

    def w_site(path, fan_in, fan_out, gain, bias=True):
        w, s_w = _weight(rng, bits, fan_in, fan_out, gain)
        qp[f"{path}.int{bits}.scale"] = s_w
        b = (0.02 * rng.standard_normal(fan_out)).astype(f32) if bias \
            else None
        return {"w_int": w, "sw": s_w, "bit": bits, "b": b}

    c0 = spec.embed_dim
    site("qact_input", act)
    ip = {"bit_config": bc, "layers": [], "qp": qp,
          "patch": w_site("patch.w", 3 * spec.patch_size**2, c0, 1.0)}
    ip["patch_norm"] = _norm(rng, c0) if spec.patch_norm else None
    site("patch.qact_bn", act)
    site("patch.qact", act)
    for s in range(spec.num_layers):
        c, nh = spec.stage_dim(s), spec.num_heads[s]
        hid = spec.mlp_ratio * c
        ws = spec.block_window(s, 0)[0]
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


def int_model(spec, rng):
    """The seeded int-model of ``spec``'s family."""
    return swin_int_model(spec, rng) if isinstance(spec, Swin) \
        else vit_int_model(spec, rng)


def input_scale(spec, ip) -> np.float32:
    """The qact_input scale of an int-model."""
    s = ip["qp"]["qact_input.scale"] if isinstance(spec, Swin) \
        else ip["qact_input"]["scale"]
    return f32(np.asarray(s).reshape(()))


def code_table(spec, ip) -> np.ndarray:
    """(3, 256) int8: the qact_input code of every uint8 pixel value per
    channel (ToTensor + Normalize in float32, then the input fake-quant and
    the integer path's requant, zero-point 0)."""
    lo, hi = spec.quant.a_bounds
    v = np.arange(256, dtype=np.float32)
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    norm = np.stack([(v / np.float32(255.0) - m) / s
                     for m, s in zip(mean, std)])
    scale = input_scale(spec, ip)
    xq = np.clip(np.round(norm / scale), lo, hi) * scale
    return np.clip(np.round(xq / scale), -128, 127).astype(np.int8)


def codes_pool(spec, ip, n: int, rng: np.random.Generator) -> np.ndarray:
    """(n, 3, H, W) int8 input codes of seeded uint8 pixels."""
    px = rng.integers(0, 256, (n, 3, spec.img_size, spec.img_size),
                      dtype=np.uint8)
    table = code_table(spec, ip)
    return np.stack([table[c][px[:, c]] for c in range(3)], 1)


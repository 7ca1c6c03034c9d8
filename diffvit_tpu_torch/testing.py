"""A seeded synthetic int-model in ``prepare_int``'s exact schema.

There are no pretrained weights in the repository, so the port is driven
at full width on a random model.  ``random_int_model`` builds, with numpy
only, the int-model pytree that ``diffvit_tpu.models.vit_int.prepare_int``
would bake for a DeiT/ViT spec at a uniform bit width: exactly the keys
that ``_embed_front``, ``_block_int`` (codes path) and ``_head_tail`` read,
plus ``bit_config`` and ``sym_acts=True``.  The JAX forward accepts it
unchanged (``tests/test_torch_vit_int.py`` holds the two against each
other), so it is a valid int-model, not a private format.

* weights are int codes of ``cfg.bit_w``'s width;
* every zero-point is 0 (symmetric activations);
* every scale is a power of two chosen from the site's fan-in, so that
  activations keep a spread of about one in value space, use a good part
  of the int8 range and saturate only in the tails;
* the softmax scale lies inside ``lis_fast_ok``'s window.
"""
from __future__ import annotations

import numpy as np

from diffvit_tpu.config import QuantConfig

from .models.vit import ViTSpec, num_bit_slots


def random_int_model(spec: ViTSpec, cfg: QuantConfig | None = None,
                     seed: int = 0) -> dict:
    """The weights take ``cfg.bit_w`` (int4 by default)."""
    cfg = cfg or QuantConfig()
    bits = cfg.bit_w.bits
    rng = np.random.default_rng(seed)
    c, hid, n = spec.embed_dim, spec.hidden_dim, spec.seq_len
    f32 = np.float32
    w_hi = 2 ** (bits - 1) - 1
    w_std = (2 ** bits) / np.sqrt(12.0)  # std of uniform codes

    def pot(x):
        return f32(2.0 ** np.round(np.log2(x)))

    def site(scale):
        return {"scale": np.asarray(scale, f32), "zp": np.asarray(0.0, f32)}

    def ptf(base, size):
        # per-channel PTF grid: base * 2^k, k in {0, 1}
        return (base * 2.0 ** rng.integers(0, 2, size)).astype(f32)

    def linear(fan_in, fan_out, in_step, gain=1.0):
        """int weight codes + per-channel multiplier (in_step * s_w) with
        s_w picked so that the output std is ~gain times the input std."""
        w = rng.integers(-w_hi - 1, w_hi + 1, (fan_in, fan_out)).astype(np.int8)
        s_w = pot(gain / (np.sqrt(fan_in) * w_std)) \
            * 2.0 ** rng.integers(-1, 1, fan_out)
        return {"w_int": w, "b": (0.02 * rng.standard_normal(fan_out)).astype(f32),
                "fp": False, "mult": (in_step * s_w).astype(f32)}

    def norm():
        return {"w": (1.0 + 0.1 * rng.standard_normal(c)).astype(f32),
                "b": (0.1 * rng.standard_normal(c)).astype(f32)}

    s_in = f32(2.0**-5)   # ImageNet-normalized pixels span about +-2.6
    act = f32(2.0**-5)    # activations of std ~1 span +-4
    ip = {
        "bit_config": (bits,) * num_bit_slots(spec),
        "patch": linear(3 * spec.patch_size**2, c, s_in),
        "qact_input": site(s_in), "patch.qact": site(act),
        "qact_embed": site(act), "qact_pos": site(act / 2),
        "qact1": site(ptf(act, c)), "qact2": site(act),
        "act_out": site(f32(2.0**-4)),
        "cls_token": rng.standard_normal((1, 1, c)).astype(f32),
        "pos_embed": (0.5 * rng.standard_normal((1, n, c))).astype(f32),
        "norm": norm(),
        "blocks": [],
    }
    s1, s2, s_a = 2 * act, 2 * act, f32(2.0**-4)
    for _ in range(spec.depth):
        ch_attn = (2.0 ** rng.integers(0, 2, c)).astype(f32)
        ch_mlp = (2.0 ** rng.integers(0, 2, c)).astype(f32)
        # SmoothQuant sites: LN codes on the (channel scale x act) grid,
        # output multiplier act * s_w
        qkv = linear(c, 3 * c, act, gain=4.0)
        qkv["in_scale"] = (ch_attn * act).astype(f32)
        fc1 = linear(c, hid, act, gain=1.5)
        fc1["in_scale"] = (ch_mlp * act).astype(f32)
        # norm2 emits on the attention's channel grid (prepare_int's quirk)
        fc1["ln_out_scale"] = (act * ch_attn).astype(f32)
        fc1["ln_rescale"] = (ch_attn / ch_mlp).astype(f32)
        ip["blocks"].append({
            "norm1": norm(), "norm2": norm(),
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

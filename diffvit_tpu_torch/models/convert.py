"""The JAX int-model pytree -> the port's form, on one device.

The pytree is ``prepare_int``'s (``diffvit_tpu.models.vit_int`` or
``.swin_int``): loaded from a ``save_int_model`` artifact with
``utils.serialize.load_pytree``, or taken from JAX directly with
``jax.device_get``.  This is where weights and state cross from JAX to the
port.  Values the reference recomputes on every forward from the model
alone are computed here once, with the same float32 operations in the
same order."""
from __future__ import annotations

import numpy as np
import torch

from ..config import QuantConfig
from ..ops.kernels.attention import lis_fast_ok, lis_sum_fits
from ..ops.quant import fake_quant
from .swin import SwinSpec, block_geometry, relative_position_index
from .vit import ViTSpec

f32 = np.float32


def _to_torch(node, device):
    if isinstance(node, dict):
        return {k: _to_torch(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_torch(v, device) for v in node]
    if node is None or isinstance(node, (bool, int, tuple)):
        return node  # absent bias, fp / sym_acts flags, bits, bit_config
    a = np.asarray(node)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.tensor(a, device=device)


def _scalar(a):
    return f32(np.asarray(a).reshape(()))


def _check_lis_sum(s_a, n_keys, where):
    if not lis_sum_fits(float(s_a), n_keys):
        raise ValueError(
            f"{where}: softmax scale {float(s_a)} over {n_keys} keys; the "
            "exact int64 row sum of the LIS exponentials would overflow")


def _attn_scales(ib, spec: ViTSpec):
    """s1, s_a, s2 and c1 = s1^2 * attn_scale / s_a in float32, the
    reference's order of operations (``vit_int.py:408, 439``)."""
    s1 = _scalar(ib["attn.qact1"]["scale"])
    s_a = _scalar(ib["attn.qact_attn1"]["scale"])
    s2 = _scalar(ib["attn.qact2"]["scale"])
    return s1, s_a, s2, s1 * s1 * f32(spec.attn_scale) / s_a


def attn_constants(ib, spec: ViTSpec, block: int, lis: bool = True):
    """The per-block host-side constants of the reference forward
    (``vit_int.py:407-419``): K1's scalars [s_a, c1, 1/s1, s1/s2] in
    float32, and the fast-LIS gate.  With ``lis`` the softmax scale must
    keep the exact LIS row sum in int64 (:func:`lis_sum_fits`)."""
    s1, s_a, s2, c1 = _attn_scales(ib, spec)
    if lis:
        _check_lis_sum(s_a, spec.seq_len, f"block {block}")
    scalars = np.asarray([s_a, c1, f32(1.0) / s1, s1 / s2], np.float32)
    return scalars, lis_fast_ok(float(s_a))


def int_attn_scalars(ib, spec: ViTSpec) -> np.ndarray:
    """K5's scalars [c1, s1/s2, s_a] in float32 (``vit_int.py:439-440``);
    the unfused attention reads c1 and s_a from them too."""
    s1, s_a, s2, c1 = _attn_scales(ib, spec)
    return np.asarray([c1, s1 / s2, s_a], np.float32)


def int_model_from_numpy(ip, spec: ViTSpec, device,
                         cfg: QuantConfig | None = None) -> dict:
    """Copy every array of ``ip`` to ``device`` as a torch tensor (floats as
    float32, int8 codes as int8; a float site keeps its float32 ``w`` and
    ``b``) and add, per block, ``attn_scalars`` (K1's (4,) float32
    scalars), ``int_attn_scalars`` (K5's (3,)) and ``lis_fast``.  The LIS
    bound is checked where ``cfg.lis`` holds (default QuantConfig)."""
    lis = (cfg or QuantConfig()).lis
    out = _to_torch(ip, device)
    for i, (ib_np, ib) in enumerate(zip(ip["blocks"], out["blocks"])):
        scalars, fast = attn_constants(ib_np, spec, i, lis=lis)
        ib["attn_scalars"] = torch.tensor(scalars, device=device)
        ib["int_attn_scalars"] = torch.tensor(int_attn_scalars(ib_np, spec),
                                              device=device)
        ib["lis_fast"] = fast
    return out


def qkv_head_blocks(ib, spec: ViTSpec) -> dict:
    """The per-head layout of a converted block's qkv site that K8 v1 and
    K7a read (``vit_int.py:140-153``, ``qkv_head_blocks``): ``wq_h``,
    ``wk_h``, ``wv_h`` (H, Cin, D) int8 and ``mult_h``, ``bias_h`` (3, H,
    D) float32, on the block's device.  Built on request: the served
    models carry only the (Cin, 3C) weight."""
    site = ib["qkv"]
    h, d, c = spec.num_heads, spec.head_dim, spec.embed_dim
    codes = site["w_int"].T.reshape(3, h, d, -1).permute(0, 1, 3, 2)
    return {"wq_h": codes[0].contiguous(), "wk_h": codes[1].contiguous(),
            "wv_h": codes[2].contiguous(),
            "mult_h": site["mult"].expand(3 * c).reshape(3, h, d)
            .to(torch.float32),
            "bias_h": site["b"].reshape(3, h, d).to(torch.float32)}


def attn_block_operands(ib, spec: ViTSpec) -> dict:
    """K7a's operands beside x and h, from a converted block (with the LIS
    scalars ``attn_scalars`` of :func:`int_model_from_numpy`): the per-head
    qkv layout, ``wp`` = proj.w_int as (H, D, C), and ``pvec`` (4, C)
    float32 [mult_p, bias_p, s_qact3, s_qact2]; keyword names of
    ``fused_attention_block``."""
    hb = qkv_head_blocks(ib, spec)
    h, d, c = spec.num_heads, spec.head_dim, spec.embed_dim
    proj = ib["proj"]
    pvec = torch.stack([t.expand(c) for t in (
        proj["mult"], proj["b"], ib["attn.qact3"]["scale"],
        ib["qact2"]["scale"])]).to(torch.float32).contiguous()
    return dict(wq=hb["wq_h"], wk=hb["wk_h"], wv=hb["wv_h"],
                wp=proj["w_int"].reshape(h, d, c), mult=hb["mult_h"],
                bias=hb["bias_h"], pvec=pvec, scalars=ib["attn_scalars"])


def mlp_block_operands(ib) -> dict:
    """K7b's operands beside y and h, from a converted block; keyword names
    of ``fused_int_mlp_block`` (which folds them)."""
    fc1, fc2 = ib["fc1"], ib["fc2"]
    return dict(w1=fc1["w_int"], w2=fc2["w_int"], mult1=fc1["mult"],
                bias1=fc1["b"], mult2=fc2["mult"], bias2=fc2["b"],
                mlp_out_scale=ib["mlp.qact2"]["scale"],
                s_q1=ib["mlp.qact1"]["scale"], ln=ib["norm2"],
                ln_in_scale=ib["qact2"]["scale"],
                ln_out_scale=fc1.get("ln_out_scale", fc1["in_scale"]),
                ln_rescale=fc1.get("ln_rescale"),
                s3=ib["attn.qact3"]["scale"], s2_vec=ib["qact2"]["scale"],
                s4_vec=ib["qact4"]["scale"])


def _fq_np(x, qp, path, bit_type):
    """The reference's ``fq(path, x)`` on numpy float32, through the
    port's fake_quant (the same float32 operations as the JAX one)."""
    t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    return fake_quant(t(x), t(qp[f"{path}.scale"]), t(qp[f"{path}.zp"]),
                      bit_type).numpy()


def swin_block_constants(ib, qp, p, spec: SwinSpec, stage: int, blk: int,
                         cfg) -> dict:
    """A Swin block's window-attention constants, as
    ``swin_int.forward_q_int`` computes them on every forward
    (``swin_int.py:234-255``), in numpy: ``bias_q``, the fake-quantized
    relative-position table gathered to (H, n, n); ``mask_div``, the shift
    mask over s_a2 (or None); ``attn_scalars``, the kernel's
    [c1, s_a1, 1/s_a2, s_a2, c2] in float32.  With ``cfg.lis`` the softmax
    scale must keep the exact LIS row sum in int64 (:func:`lis_sum_fits`);
    the float softmax takes any scale."""
    _, ws, _, mask = block_geometry(spec, stage, blk)
    n, nh = ws * ws, spec.num_heads[stage]
    hd = spec.stage_dim(stage) // nh
    s1 = _scalar(qp[f"{p}.attn.qact1.scale"])
    s_a1 = _scalar(qp[f"{p}.attn.qact_attn1.scale"])
    s_a2 = _scalar(qp[f"{p}.attn.qact2.scale"])
    s_a3 = _scalar(qp[f"{p}.attn.qact3.scale"])
    if cfg.lis:
        _check_lis_sum(s_a2, n, p)
    table_q = _fq_np(ib["rel_bias_table"], qp, f"{p}.attn.qact_table",
                     cfg.bit_a)
    idx = relative_position_index(ws).reshape(-1)
    bias_q = table_q[idx].reshape(n, n, nh).transpose(2, 0, 1)
    return {
        "bias_q": np.ascontiguousarray(bias_q),
        "mask_div": None if mask is None else mask / s_a2,
        "attn_scalars": np.asarray(
            [s1 * s1 * f32(hd**-0.5) / s_a1, s_a1, f32(1.0) / s_a2, s_a2,
             s1 / s_a3], np.float32),
    }


def _with_mult(site, in_scale):
    """An ``int_linear`` site with ``mult = in_scale * sw``, the factor the
    reference multiplies its int32 accumulator by (``swin_int.py:145``)."""
    mult = np.asarray(in_scale, np.float32) * np.asarray(site["sw"],
                                                         np.float32)
    return dict(site, mult=mult)


def swin_int_model_from_numpy(ip, spec: SwinSpec, device,
                              cfg: QuantConfig | None = None) -> dict:
    """The Swin int-model of ``diffvit_tpu.models.swin_int.prepare_int`` on
    ``device``: every array as a torch tensor (as ``int_model_from_numpy``
    does), every ``int_linear`` site with its ``mult`` (the patch site
    only under ``input_quant``: without it the patch product is float and
    there is no qact_input), and per block the window-attention constants
    of :func:`swin_block_constants` (``cfg.bit_a`` fake-quantizes the bias
    table)."""
    cfg = cfg or QuantConfig()
    qp = {k: np.asarray(v) for k, v in ip["qp"].items()}

    def s(path):
        return qp[f"{path}.scale"]

    layers = []
    for si, st in enumerate(ip["layers"]):
        blocks = []
        for bi, ib in enumerate(st["blocks"]):
            p = f"layers.{si}.blocks.{bi}"
            blocks.append(dict(
                ib, **swin_block_constants(ib, qp, p, spec, si, bi, cfg),
                qkv=_with_mult(ib["qkv"], s(f"{p}.qact1")),
                proj=_with_mult(ib["proj"], s(f"{p}.attn.qact3")),
                fc1=_with_mult(ib["fc1"], s(f"{p}.qact3")),
                fc2=_with_mult(ib["fc2"], s(f"{p}.mlp.qact1"))))
        ds = st["downsample"]
        if ds is not None:
            ds = dict(ds, reduction=_with_mult(
                ds["reduction"], s(f"layers.{si}.downsample.qact1")))
        layers.append({"blocks": blocks, "downsample": ds})
    patch = _with_mult(ip["patch"], s("qact_input")) if spec.input_quant \
        else ip["patch"]
    ip = dict(ip, layers=layers, qp=qp, patch=patch,
              head=_with_mult(ip["head"], s("qact3")))
    return _to_torch(ip, device)

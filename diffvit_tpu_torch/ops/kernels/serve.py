"""The resident whole-encoder serving kernel, K6 (counterpart of
``diffvit_tpu/ops/pallas/serve.py``: ``prepare_resident``,
``resident_codes``, ``_serve_kernel`` and ``_ln_emit``).

Every encoder block of a ViT runs in one launch, on the int8 codes of the
residual stream; per block, op for op the integer codes path of
``models/vit_int._block_int``:

    int LN1 -> qkv GEMM + qact1 requant -> per-head scores -> LIS (or the
    float softmax) -> attn@v -> qact2 -> proj (int32 over the heads) ->
    qact3 / residual / qact2 fences -> int LN2 (norm2 rescale quirk) ->
    fc1 -> poly GELU -> qact1 -> fc2 -> qact2 codes -> residual / qact4

The one difference from the codes path is the LayerNorm's std floor of
``_ln_emit`` (``serve.py:100``): a row whose codes are all equal (std 0)
gets finite codes here, NaN there.  Real rows of random or calibrated
inputs have no such row, so there the codes equal the codes path's.

``prepare_resident`` stacks the per-layer weights and constants of a
converted int-model (``models/convert.int_model_from_numpy``) on its
device, in the JAX package's layout.  The float32 constants are computed
on the host in numpy, in the reference's order (CUDA torch takes ``1 / t``
and a division by a Python number through a reciprocal).

The CUDA kernel is ``csrc/resident.cu``; :func:`resident_codes_plain` is
its exact specification, built from the port's plain pieces
(:func:`~.attention.attention_core_plain`, ``ops/int_layernorm.ln_codes``,
:func:`~.mlp.gelu_poly`, ``int_matmul``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..int_layernorm import ln_codes
from ..quant import int_matmul
from . import check_for_kernel, require, route
from .attention import MAX_KEYS, attention_core_plain
from .build import check, load_library
from .mlp import gelu_poly

# vec slots (per layer, C-wide float32; serve.py:59-75)
(V_IN_SCALE, V_LN1_MASK, V_LN1_W, V_LN1_B, V_LN1_OUT, V_PROJ_MULT, V_PROJ_B,
 V_S3, V_SBLK2, V_LN2_MASK, V_LN2_W, V_LN2_B, V_LN2_OUT, V_LN2_RESCALE,
 V_S4) = range(15)
# scal slots (per layer, float32; serve.py:77-84)
S_SA, S_C1, S_S1_OVER_S2, S_M1_INV, S_LN1_MIN, S_LN2_MIN = range(6)
STD_FLOOR = float(np.float32(1e-37))  # _ln_emit's floor, as float32
# prepare_resident's tensors, in the C entry's order
PACKED = ("wqkv", "wproj", "w1", "w2", "mb", "vec", "vhid", "vout", "scal")

f32 = np.float32
I8, F32 = torch.int8, torch.float32


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def prepare_resident(ip, spec, cfg) -> dict:
    """The stacked per-layer tensors the resident kernel reads, on the
    int-model's device: ``wqkv`` (depth, C, 3C), ``wproj`` (depth, H, D, C),
    ``w1`` (depth, C, hid), ``w2`` (depth, hid, C) int8; ``mb`` (depth, 2,
    3C) [mult/s1, bias/s1], ``vec`` (depth, 15, C), ``vhid`` (depth, 2, hid)
    [fc1 mult, bias], ``vout`` (depth, 4, C) [fc2 mult, bias, s_m2, 1/s_m2],
    ``scal`` (depth, 6) float32; ``lis_fast``, the fast-LIS gate of every
    layer.  Needs the full codes path: every site integer, int_norm and
    smoothquant on, symmetric int8 activations."""
    if not (cfg.int_norm and cfg.smoothquant):
        raise ValueError("resident serving needs int_norm + smoothquant")
    if not ip.get("sym_acts", False):
        raise ValueError("resident serving needs symmetric activations "
                         "(sym_acts) to carry the int8-codes stream")
    if cfg.bit_a.bits != 8 or cfg.bit_a.signed is not True:
        # every requant fence of the kernel clips to [-128, 127]
        raise ValueError("resident serving assumes int8 activations "
                         f"(cfg.bit_a is {cfg.bit_a.name})")
    for i, ib in enumerate(ip["blocks"]):
        for site in ("qkv", "proj", "fc1", "fc2"):
            if ib[site]["fp"]:
                raise ValueError(
                    f"resident serving supports all-integer blocks only; "
                    f"blocks[{i}].{site} is fp (bit -1)")
    c, heads, hd = spec.embed_dim, spec.num_heads, spec.head_dim
    dev = ip["qact1"]["scale"].device

    def bc(a, n=c):
        return np.broadcast_to(_np(a).astype(f32), (n,))

    def sc(a):
        return _np(a).astype(f32).reshape(())

    mb, vec, vhid, vout, scal = [], [], [], [], []
    for i, ib in enumerate(ip["blocks"]):
        qs, ps, f1, f2 = ib["qkv"], ib["proj"], ib["fc1"], ib["fc2"]
        hid = f1["w_int"].shape[1]
        in_scale = bc(ip["qact1"]["scale"] if i == 0
                      else ip["blocks"][i - 1]["qact4"]["scale"])
        s1 = sc(ib["attn.qact1"]["scale"])
        s_a = sc(ib["attn.qact_attn1"]["scale"])
        s2 = sc(ib["attn.qact2"]["scale"])
        s_blk2 = bc(ib["qact2"]["scale"])
        ln1_min, ln2_min = in_scale.min(), s_blk2.min()
        s1_inv = f32(1.0) / s1
        mb.append([bc(qs["mult"], 3 * c) * s1_inv,
                   bc(qs["b"], 3 * c) * s1_inv])
        vec.append([
            in_scale, np.round(in_scale / ln1_min),
            bc(ib["norm1"]["w"]), bc(ib["norm1"]["b"]), bc(qs["in_scale"]),
            bc(ps["mult"]), bc(ps["b"]), bc(ib["attn.qact3"]["scale"]),
            s_blk2, np.round(s_blk2 / ln2_min),
            bc(ib["norm2"]["w"]), bc(ib["norm2"]["b"]),
            bc(f1.get("ln_out_scale", f1["in_scale"])),
            bc(f1["ln_rescale"]) if "ln_rescale" in f1 else np.ones(c, f32),
            bc(ib["qact4"]["scale"])])
        vhid.append([bc(f1["mult"], hid), bc(f1["b"], hid)])
        s_m2 = bc(ib["mlp.qact2"]["scale"])
        vout.append([bc(f2["mult"]), bc(f2["b"]), s_m2, f32(1.0) / s_m2])
        scal.append([s_a, s1 * s1 * f32(spec.attn_scale) / s_a, s1 / s2,
                     f32(1.0) / sc(ib["mlp.qact1"]["scale"]), ln1_min,
                     ln2_min])

    def stack_w(key, shape=None):
        ws = [ib[key]["w_int"] for ib in ip["blocks"]]
        if shape is not None:
            ws = [w.reshape(shape) for w in ws]
        return torch.stack(ws).contiguous()

    def stack_f(rows):
        return torch.tensor(np.asarray(rows, f32), device=dev)

    return {
        "wqkv": stack_w("qkv"), "wproj": stack_w("proj", (heads, hd, c)),
        "w1": stack_w("fc1"), "w2": stack_w("fc2"),
        "mb": stack_f(mb), "vec": stack_f(vec), "vhid": stack_f(vhid),
        "vout": stack_f(vout), "scal": stack_f(scal),
        "lis_fast": all(bool(ib["lis_fast"]) for ib in ip["blocks"]),
    }


def _ln_emit(codes, mask, s_min, w, b, out_scale, rescale=None):
    """``_ln_emit`` (``serve.py:87``): the integer LN of the float32 codes
    with the std floor, the optional rescale, clipped to int8 values."""
    y = ln_codes(codes * mask, s_min, w, b, out_scale, std_floor=STD_FLOOR)
    if rescale is not None:
        y = torch.round(y * rescale)
    return torch.clamp(y, -128, 127)


def resident_codes_plain(packed, x_codes, *, n_real, bits=4, lis=True,
                         nelems):
    """Plain PyTorch version of :func:`resident_codes` (``_serve_kernel``,
    ``serve.py:113``, op for op)."""
    if lis and bits > 4:
        raise NotImplementedError("resident_codes: LIS supports bits <= 4 "
                                  "only")
    rows, c = x_codes.shape
    npad = rows // nelems
    _, heads, hd, _ = packed["wproj"].shape

    def clip(y):
        return torch.clamp(y, -128, 127)

    codes = x_codes.to(F32)
    for i in range(packed["wqkv"].shape[0]):
        v, s = packed["vec"][i], packed["scal"][i]
        mb, vh, vo = packed["mb"][i], packed["vhid"][i], packed["vout"][i]
        x1 = _ln_emit(codes, v[V_LN1_MASK], s[S_LN1_MIN], v[V_LN1_W],
                      v[V_LN1_B], v[V_LN1_OUT]).to(I8)
        qkv = clip(torch.round(int_matmul(x1, packed["wqkv"][i]).to(F32)
                               * mb[0] + mb[1])).to(I8)
        t = qkv.reshape(nelems, npad, 3, heads, hd).permute(2, 0, 3, 1, 4)
        o = attention_core_plain(t[0], t[1], t[2], s[S_C1], s[S_SA],
                                 s[S_S1_OVER_S2], n_real=n_real, bits=bits,
                                 lis=lis, lis_fast=packed["lis_fast"])
        # the per-head proj sums are int32, exact: one (H, D) contraction
        o = o.permute(0, 2, 1, 3).reshape(rows, c)
        y = int_matmul(o, packed["wproj"][i].reshape(c, c)).to(F32) \
            * v[V_PROJ_MULT] + v[V_PROJ_B]
        yq3 = clip(torch.round(y / v[V_S3]))                      # qact3
        hs = codes * v[V_IN_SCALE] + yq3 * v[V_S3]                # residual
        hc2 = clip(torch.round(hs / v[V_SBLK2]))                  # qact2
        x2 = _ln_emit(hc2, v[V_LN2_MASK], s[S_LN2_MIN], v[V_LN2_W],
                      v[V_LN2_B], v[V_LN2_OUT], v[V_LN2_RESCALE]).to(I8)
        mid = int_matmul(x2, packed["w1"][i]).to(F32) * vh[0] + vh[1]
        gq = clip(torch.round(gelu_poly(mid) * s[S_M1_INV])).to(I8)
        y2 = int_matmul(gq, packed["w2"][i]).to(F32) * vo[0] + vo[1]
        y2c = clip(torch.round(y2 * vo[3]))                       # mlp.qact2
        hs2 = hc2 * v[V_SBLK2] + y2c * vo[2]                      # residual
        codes = clip(torch.round(hs2 / v[V_S4]))                  # qact4
    return codes.to(I8)


def resident_codes(packed, x_codes, *, n_real, bits=4, lis=True, nelems):
    """Every encoder block in one launch.  x_codes: (nelems * npad, C) int8
    on the qact1 grid, ``nelems`` images of ``npad`` rows each; rows at or
    past ``n_real`` of an image are padding (computed, never used as keys).
    ``packed``: :func:`prepare_resident`'s tensors.  Returns (nelems * npad,
    C) int8 codes on the last block's qact4 grid.

    A CUDA tensor runs ``csrc/resident.cu``; a CPU tensor runs
    :func:`resident_codes_plain`."""
    if route(x_codes, *(packed[k] for k in PACKED)) == "cpu":
        return resident_codes_plain(packed, x_codes, n_real=n_real,
                                    bits=bits, lis=lis, nelems=nelems)
    if lis and bits > 4:
        raise NotImplementedError("resident_codes: LIS supports bits <= 4 "
                                  "only")
    rows, c = x_codes.shape
    depth, heads, hd, _ = packed["wproj"].shape
    hid = packed["w1"].shape[2]
    check_for_kernel(x_codes, "x_codes", I8, 2)
    for k, dt in (("wqkv", I8), ("wproj", I8), ("w1", I8), ("w2", I8)):
        check_for_kernel(packed[k], k, dt, 3 if k != "wproj" else 4)
    for k in ("mb", "vec", "vhid", "vout"):
        check_for_kernel(packed[k], k, F32, 3)
    check_for_kernel(packed["scal"], "scal", F32, 2)
    require(nelems > 0 and rows % nelems == 0,
            f"{rows} rows do not split into {nelems} images")
    npad = rows // nelems
    require(packed["wqkv"].shape == (depth, c, 3 * c)
            and heads * hd == c and packed["w2"].shape == (depth, hid, c)
            and packed["vec"].shape == (depth, 15, c)
            and packed["scal"].shape == (depth, 6),
            f"packed tensors do not match x_codes {tuple(x_codes.shape)}")
    require(0 < n_real <= min(npad, MAX_KEYS),
            f"n_real={n_real}: the kernel takes 1..min(npad, {MAX_KEYS}) keys")
    require(hd <= 64 and hd % 4 == 0,
            f"head_dim={hd}: the kernel takes multiples of 4 up to 64")
    require(c % 32 == 0 and hid % 32 == 0,
            f"C={c} and hidden={hid} must be multiples of 32")
    scratch = torch.empty(rows * (5 * c + hid), dtype=I8,
                          device=x_codes.device)
    barrier = torch.zeros(1, dtype=torch.int32, device=x_codes.device)
    out = torch.empty_like(x_codes)
    err = load_library().dvt_resident_codes(
        x_codes.data_ptr(), out.data_ptr(),
        *(packed[k].data_ptr() for k in PACKED),
        scratch.data_ptr(), barrier.data_ptr(), depth, nelems, npad, n_real,
        c, hid, heads, hd, int(lis), int(packed["lis_fast"]),
        torch.cuda.current_stream(x_codes.device).cuda_stream)
    check(err, "resident_codes")
    resident_codes.launches += 1
    return out


resident_codes.launches = 0

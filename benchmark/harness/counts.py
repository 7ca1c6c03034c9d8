"""The yardstick's arithmetic: the card's peaks, the operations and bytes
of the kernels whose rooflines the benchmark reports, and the integer
operations of a whole forward.

A kernel's work is what its call needs, from the shapes: every integer
product counted as int8 whatever type the program computes it in, every
input byte read once and every output byte written once.  Its bound is
the larger of the operations over the int8 peak and the bytes over the
HBM rate: the least time the card could take.  (The same rules as the
program's own kernel table, frozen here.)"""
from __future__ import annotations

from .specs import Swin, ViT

# one NVIDIA H100 SXM at 700 W, dense rates (NVIDIA's data sheet)
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12


def bound_s(ops: float, nbytes: float) -> float:
    """The least seconds the card could take for ``ops`` int8 operations
    moving ``nbytes`` bytes."""
    return max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES)


def k2_work(rows: int, cin: int, hid: int, cout: int,
            emit_codes: bool = True) -> tuple[int, int]:
    """(operations, bytes) of one integer MLP call (fc1, the GELU, fc2) on
    ``rows`` rows: the two products; x, both int8 weights, the float32
    vectors mult1, bias1 (hid), mult2, bias2, out_scale (cout) and the
    mlp.qact1 scale, and the output (int8 codes or float32)."""
    ops = 2 * rows * (cin * hid + hid * cout)
    inputs = rows * cin + cin * hid + hid * cout \
        + 4 * (2 * hid + 3 * cout + 1)
    return ops, inputs + rows * cout * (1 if emit_codes else 4)


def k6_work(spec: ViT, images: int) -> tuple[int, int]:
    """(operations, bytes) of the resident encoder over ``images`` images
    in one launch: per block the qkv, proj, fc1 and fc2 products and the
    scores and attn@v over the real keys; the packed int8 weights, the
    float32 per-layer vectors (mb 2 x 3C, vec 15 x C, vhid 2 x hid, vout
    4 x C, scal 6), the input codes and the output codes."""
    c, hid, n, d = spec.embed_dim, spec.hidden_dim, spec.seq_len, spec.depth
    rows = images * n
    ops = d * (2 * rows * c * (3 * c + c + 2 * hid) + 4 * rows * n * c)
    weights = d * (c * 3 * c + c * c + 2 * c * hid)
    vectors = 4 * d * (2 * 3 * c + 15 * c + 2 * hid + 4 * c + 6)
    return ops, weights + vectors + 2 * rows * c


def k2_calls(spec, images: int) -> list[tuple[int, int, int, int]]:
    """The (rows, cin, hid, cout) of every integer MLP call of a forward
    over ``images`` images on the per-kernel route."""
    if isinstance(spec, Swin):
        out = []
        for s in range(spec.num_layers):
            c = spec.stage_dim(s)
            rows = images * spec.stage_resolution(s) ** 2
            out += [(rows, c, spec.mlp_ratio * c, c)] * spec.depths[s]
        return out
    c = spec.embed_dim
    return [(images * spec.seq_len, c, spec.hidden_dim, c)] * spec.depth


def k2_bound_s(spec, images: int) -> float:
    """Summed bound of a forward's integer MLP calls."""
    return sum(bound_s(*k2_work(*call)) for call in k2_calls(spec, images))


def k6_bound_s(spec: ViT, images: int) -> float:
    """The bound of the encoder's work for ``images`` real images."""
    return bound_s(*k6_work(spec, images))


def forward_ops(spec, images: int = 1) -> int:
    """Integer operations (2 a multiply-add) of a forward over ``images``
    images: the patch embed, every block's qkv, scores, attn@v, proj, fc1
    and fc2, a Swin's patch-merging reductions, and the head."""
    if isinstance(spec, Swin):
        g, c0 = spec.grid, spec.embed_dim
        macs = g * g * 3 * spec.patch_size**2 * c0
        for s in range(spec.num_layers):
            c = spec.stage_dim(s)
            tokens = spec.stage_resolution(s) ** 2
            for bi in range(spec.depths[s]):
                ws = spec.block_window(s, bi)[0]
                macs += tokens * (3 * c * c + c * c
                                  + 2 * spec.mlp_ratio * c * c)
                macs += 2 * tokens * ws * ws * c  # scores and attn@v
            if s < spec.num_layers - 1:
                macs += (tokens // 4) * 4 * c * 2 * c
        macs += spec.num_features * spec.num_classes
        return 2 * macs * images
    c, n, hid = spec.embed_dim, spec.seq_len, spec.hidden_dim
    macs = spec.num_patches * 3 * spec.patch_size**2 * c
    macs += spec.depth * (n * (3 * c * c + c * c + 2 * c * hid)
                          + 2 * n * n * c)
    macs += c * spec.num_classes
    return 2 * macs * images

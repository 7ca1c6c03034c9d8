"""Probe P1: K1 split at the scores into a producer and a consumer, and the
two paired in one launch.

The counterpart of ``scripts/ab_pingpong_probe.py``, whose Pallas kernels
are ``producer_part`` (``:80``, called at ``:141``), ``consumer_part``
(``:102``, called at ``:159``) and ``paired_kernel`` (``:119``, called at
``:177``):

    producer  scores = clip(rint(q_h @ k_h^T * c1)),  q, k from
              clip(rint(x_i8 @ w * mult/s1 + bias/s1))      (B, H, Npad, Npad)
    consumer  out = clip(rint(LIS(scores) @ v_h * s1/s2))    (B, H, Npad, D)
    paired    both, on two half-streams, in one launch

The kernels are ``csrc/probes/pingpong.cu``.  :func:`legs` answers the
script's question on the card: does the paired launch take max(producer,
consumer) or their sum?  It times each chained 12 deep, and the producer and
the consumer on two CUDA streams at once."""
from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels import attention, check_for_kernel, require, route
from ..ops.kernels.build import check, load_library
from ..ops.quant import int_matmul
from .timing import REPEATS, occupancy, rounds_ms, run_main, spread

NP, N, H, D = 200, 197, 6, 64
C = H * D
BATCH, DEPTH = 128, 12  # images a half-stream; depth-equivalent chain


def producer_plain(x_i8, w_all, mb, scalars, *, num_heads, head_dim):
    """Plain PyTorch version of :func:`producer`."""
    qkv = attention.qkv_projection_plain(x_i8, w_all, mb)
    b, npad, _ = qkv.shape
    t = qkv.reshape(b, npad, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4)
    s = int_matmul(t[0], t[1].transpose(-1, -2)).to(torch.float32)
    return torch.clamp(torch.round(s * scalars[1]), -128, 127) \
        .to(torch.int8)


def consumer_plain(scores, v, scalars, *, n_real):
    """Plain PyTorch version of :func:`consumer`: the fast LIS (weights x
    2^15, keys at or past ``n_real`` masked), attn@v exact in int32."""
    col_ok = torch.arange(scores.shape[-1], device=scores.device) < n_real
    w = attention.lis_body_plain(scores.to(torch.float32), scalars[0], 4,
                                 col_ok, fast=True)
    o = attention.weighted_values(w, v).to(torch.float32) * 2.0**-15
    return torch.clamp(torch.round(o * scalars[3]), -128, 127) \
        .to(torch.int8)


def paired_plain(x_i8, w_all, mb, scores, v, scalars, *, num_heads,
                 head_dim, n_real):
    """Plain PyTorch version of :func:`paired`."""
    return (producer_plain(x_i8, w_all, mb, scalars, num_heads=num_heads,
                           head_dim=head_dim),
            consumer_plain(scores, v, scalars, n_real=n_real))


def _check_producer(x_i8, w_all, mb, scalars, num_heads, head_dim):
    check_for_kernel(x_i8, "x_i8", torch.int8, 3)
    check_for_kernel(w_all, "w_all", torch.int8, 2)
    check_for_kernel(mb, "mb", torch.float32, 2)
    check_for_kernel(scalars, "scalars", torch.float32, 1)
    b, npad, cin = x_i8.shape
    c3 = 3 * num_heads * head_dim
    require(b > 0 and 0 < npad <= attention.MAX_KEYS,
            f"x {tuple(x_i8.shape)}: the kernel takes 1..{attention.MAX_KEYS}"
            " rows an image")
    require(head_dim <= 64 and head_dim % 4 == 0,
            f"head_dim={head_dim}: the kernel takes multiples of 4 up to 64")
    require(w_all.shape == (cin, c3) and mb.shape == (2, c3),
            f"w_all {tuple(w_all.shape)} / mb {tuple(mb.shape)} do not match "
            f"x {tuple(x_i8.shape)} and {num_heads} heads of {head_dim}")
    require(scalars.numel() == 4, "scalars must hold [s_a, c1, 1/s1, s1/s2]")


def _check_consumer(scores, v, scalars, n_real):
    check_for_kernel(scores, "scores", torch.int8, 4)
    check_for_kernel(v, "v", torch.int8, 4)
    check_for_kernel(scalars, "scalars", torch.float32, 1)
    b, h, npad, d = v.shape
    require(scores.shape == (b, h, npad, npad),
            f"scores {tuple(scores.shape)} do not match v {tuple(v.shape)}")
    require(b * h > 0 and 0 < n_real <= npad <= attention.MAX_KEYS,
            f"n_real={n_real}, Npad={npad}: the kernel takes "
            f"n_real <= Npad <= {attention.MAX_KEYS}")
    require(d <= 64 and d % 4 == 0,
            f"D={d}: the kernel takes multiples of 4 up to 64")
    require(scalars.numel() == 4, "scalars must hold [s_a, c1, 1/s1, s1/s2]")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def producer(x_i8, w_all, mb, scalars, *, num_heads, head_dim):
    """x_i8: (B, Npad, Cin) int8; w_all: (Cin, 3C) int8, columns [slot,
    head, d]; mb: (2, 3C) float32 [mult/s1, bias/s1]; scalars: (4,) float32
    [s_a, c1, 1/s1, s1/s2].  Returns the (B, H, Npad, Npad) int8 scores.  A
    CUDA tensor runs ``csrc/probes/pingpong.cu``; a CPU tensor
    :func:`producer_plain`."""
    if route(x_i8, w_all, mb, scalars) == "cpu":
        return producer_plain(x_i8, w_all, mb, scalars, num_heads=num_heads,
                              head_dim=head_dim)
    _check_producer(x_i8, w_all, mb, scalars, num_heads, head_dim)
    b, npad, cin = x_i8.shape
    scores = torch.empty((b, num_heads, npad, npad), dtype=torch.int8,
                         device=x_i8.device)
    err = load_library("probes").dvt_probe_producer(
        x_i8.data_ptr(), w_all.data_ptr(), mb.data_ptr(), scalars.data_ptr(),
        scores.data_ptr(), b, npad, cin, num_heads, head_dim,
        _stream(x_i8))
    check(err, "producer", "probes")
    producer.launches += 1
    return scores


def consumer(scores, v, scalars, *, n_real):
    """scores: (B, H, Npad, Npad) int8; v: (B, H, Npad, D) int8; scalars
    as :func:`producer`'s (s_a must lie in [2^-10, ln 2]: the fast LIS).
    Returns (B, H, Npad, D) int8.  A CUDA tensor runs
    ``csrc/probes/pingpong.cu``; a CPU tensor :func:`consumer_plain`."""
    if route(scores, v, scalars) == "cpu":
        return consumer_plain(scores, v, scalars, n_real=n_real)
    _check_consumer(scores, v, scalars, n_real)
    b, h, npad, d = v.shape
    out = torch.empty_like(v)
    err = load_library("probes").dvt_probe_consumer(
        scores.data_ptr(), v.data_ptr(), scalars.data_ptr(), out.data_ptr(),
        b, npad, h, d, n_real, _stream(v))
    check(err, "consumer", "probes")
    consumer.launches += 1
    return out


def paired(x_i8, w_all, mb, scores, v, scalars, *, num_heads, head_dim,
           n_real):
    """:func:`producer` on (x_i8, w_all, mb) and :func:`consumer` on
    (scores, v) in one launch; returns (the producer's scores, the
    consumer's output).  A CUDA tensor runs ``csrc/probes/pingpong.cu``; a
    CPU tensor :func:`paired_plain`."""
    if route(x_i8, w_all, mb, scores, v, scalars) == "cpu":
        return paired_plain(x_i8, w_all, mb, scores, v, scalars,
                            num_heads=num_heads, head_dim=head_dim,
                            n_real=n_real)
    _check_producer(x_i8, w_all, mb, scalars, num_heads, head_dim)
    _check_consumer(scores, v, scalars, n_real)
    b, npad, cin = x_i8.shape
    require(v.shape == (b, num_heads, npad, head_dim),
            f"v {tuple(v.shape)} does not match x {tuple(x_i8.shape)}")
    scores_out = torch.empty_like(scores)
    out = torch.empty_like(v)
    err = load_library("probes").dvt_probe_paired(
        x_i8.data_ptr(), w_all.data_ptr(), mb.data_ptr(), scores.data_ptr(),
        v.data_ptr(), scalars.data_ptr(), scores_out.data_ptr(),
        out.data_ptr(), b, npad, cin, num_heads, head_dim, n_real,
        _stream(x_i8))
    check(err, "paired", "probes")
    paired.launches += 1
    return scores_out, out


for _fn in (producer, consumer, paired):
    _fn.launches = 0
del _fn


def footprint(role):
    """{"registers", "smem_bytes", "blocks_per_sm"} of the kernel of role
    ``role`` ("producer", "consumer" or "paired") on the current card.
    Needs a card."""
    return occupancy(load_library("probes").dvt_probe_pingpong_occupancy,
                     ("producer", "consumer", "paired").index(role))


def inputs(dev, batch=BATCH):
    """The script's operands, seeded: x (B, Npad, C) int8, scores (B, H,
    Npad, Npad) and v (B, H, Npad, D) int8, w_all (C, 3C) int8 in [-8, 8),
    mb = [2^-9, bias ~ N(0, 0.01)] * 1/s1, scalars [2^-4, 0.05, 24, 1.3]."""
    rng = np.random.default_rng(0)
    t = lambda a, dt: torch.tensor(np.asarray(a), dtype=dt, device=dev)  # noqa
    x = t(rng.integers(-128, 128, (batch, NP, C)), torch.int8)
    scores = t(rng.integers(-128, 128, (batch, H, NP, NP)), torch.int8)
    v = t(rng.integers(-128, 128, (batch, H, NP, D)), torch.int8)
    w_all = t(rng.integers(-8, 8, (C, 3 * C)), torch.int8)
    bias = rng.standard_normal(3 * C) * 0.01
    scalars = t([2.0**-4, 0.05, 24.0, 1.3], torch.float32)
    mb = torch.stack([torch.full((3 * C,), 2.0**-9, device=dev),
                      t(bias, torch.float32)]) * scalars[2]
    return x, w_all, mb.contiguous(), scores, v, scalars


def legs(dev):
    """Producer x DEPTH, consumer x DEPTH, paired x DEPTH (each tick's
    consumer reads the scores the previous tick produced, as the script
    chains them), and the producer and the consumer on two CUDA streams at
    once, at B = BATCH: ms per chain, and paired and two streams over the
    sum and over the max, each as the median, min and max over the rounds
    (``timing``); and each role's kernel footprint (registers, shared
    memory, blocks an SM): paired gives every block the larger of the two."""
    x, w_all, mb, scores, v, scalars = inputs(dev)
    heads = dict(num_heads=H, head_dim=D)

    def run_producer():
        for _ in range(DEPTH):
            producer(x, w_all, mb, scalars, **heads)

    def run_consumer():
        for _ in range(DEPTH):
            consumer(scores, v, scalars, n_real=N)

    def run_paired():
        sa = scores
        for _ in range(DEPTH):
            sa, _ = paired(x, w_all, mb, sa, v, scalars, n_real=N, **heads)

    side = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))

    def run_two_streams():
        main = torch.cuda.current_stream(dev)
        for s, run in zip(side, (run_producer, run_consumer)):
            s.wait_stream(main)
            with torch.cuda.stream(s):
                run()
        for s in side:
            main.wait_stream(s)

    rounds = rounds_ms({"producer": run_producer, "consumer": run_consumer,
                        "paired": run_paired, "two_streams": run_two_streams})
    ratios = []
    for r in rounds:
        total, most = r["producer"] + r["consumer"], max(r["producer"],
                                                         r["consumer"])
        ratios.append({"paired_over_sum": r["paired"] / total,
                       "paired_over_max": r["paired"] / most,
                       "two_streams_over_sum": r["two_streams"] / total,
                       "two_streams_over_max": r["two_streams"] / most})
    return {"batch": BATCH, "depth": DEPTH, "repeats": REPEATS,
            "ms": spread(rounds), **spread(ratios),
            "footprint": {role: footprint(role)
                          for role in ("producer", "consumer", "paired")}}


def main():
    run_main("pingpong", legs)


if __name__ == "__main__":
    main()

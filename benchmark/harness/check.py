"""The check that decides ``correct``: the logits that the timed path
returned, for a sample of its calls drawn from the seed, against the
plain reference (``harness.reference``) on the same input codes.

Two numbers are compared: ``gap_steps``, the largest distance between a
served logit and the reference's, in steps of the act_out grid that every
logit lies on (0 where the two agree bit for bit), and ``mismatch_pct``,
the share of the compared logits that differ from the reference's at all.
Their limits are in ``benchmark/checks/<configuration>.json``; the
readings they were set from are in PERF.md."""
from __future__ import annotations

import math

import numpy as np
import torch

from . import reference

CHUNK = 64  # images a reference forward takes at once


def reference_logits(spec, ip, codes: np.ndarray, device, control=False):
    """(n, classes) float32 logits of the reference (or its control) over
    int8 input codes, in chunks of :data:`CHUNK` images, on the host."""
    ar = reference.Arith(device, control=control)
    out = []
    with torch.inference_mode():
        for i in range(0, len(codes), CHUNK):
            x = torch.as_tensor(codes[i:i + CHUNK], device=ar.device)
            out.append(reference.forward(spec, ip, x, ar).float().cpu())
    return torch.cat(out)


def numbers(spec, ip, got: torch.Tensor, want: torch.Tensor) -> dict:
    """``gap_steps``, the largest |got - want| in act_out steps, and
    ``mismatch_pct``, the share of logits that differ (inf and 100 where
    the shapes differ or a value is not finite)."""
    d = (got.double() - want.double()).abs() if got.shape == want.shape \
        else None
    if d is None or not torch.isfinite(d).all():
        return {"gap_steps": math.inf, "mismatch_pct": 100.0}
    return {"gap_steps": float(d.max()) / reference.act_out_scale(spec, ip),
            "mismatch_pct": 100.0 * float((d > 0).double().mean())}


def compare(cell, ip, pool: np.ndarray, served: list, device, log) -> dict:
    """The numbers compared, from ``served``: (pool rows, logits) of each
    sampled call."""
    if not served:
        return {"gap_steps": math.inf, "mismatch_pct": 100.0}
    rows = np.concatenate([r for r, _ in served])
    got = torch.cat([g for _, g in served])
    want = reference_logits(cell.spec, ip, pool[rows], device)
    out = numbers(cell.spec, ip, got, want)
    for k, v in out.items():
        log(f"check {k} {v!r} limit {cell.limits[k]!r} "
            f"({len(served)} calls, {len(rows)} images)")
    return out


def passes(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit (a NaN fails)."""
    return all(v <= limits[k] for k, v in numbers.items())

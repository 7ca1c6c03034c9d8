"""Where the host's time goes in the benchmark's cells, read from the
port's own spans (``diffvit_tpu_torch/utils/tracing.py``), on the card.

    python3 scripts/port_spans.py [--seed N] [--seconds S] [--rounds R]
        [cell ...]

From the root of a checkout.  Each cell of ``BENCHMARK.json`` (default:
all) is set up as ``benchmark/run.py`` sets it up: the harness's seeded
artifact loaded with the mix's arguments, its pool of codes, its warm-up.
Then four stretches of ``--seconds`` each, driven as the mix's mode
drives its window (offline: ``engine.validate`` over a
``DevicePrefetcher``; online: one closed-loop client reading its logits
back), in the order off, on, on, off (``--rounds`` times), where "on"
is inside ``tracing.recording()``; then one ``torch.profiler`` capture
of host and device over a few calls, with a recording on, whose idle
gaps are named by the calling thread's innermost ``dvt.`` span and op.

One JSON line a cell, with the card's name and power limit:

* ``score_ms``, ``readback_ms``, ``feed_wait_ms`` (offline): mean ms a
  batch of ``dvt.validate.score``, ``dvt.validate.readback`` and
  ``dvt.feed.wait``;
* ``embed_host_ms``, ``encoder_host_ms``, ``head_host_ms``,
  ``input_host_ms``, ``call_host_ms``: mean host ms a call;
* ``k6_barrier_pct`` (resident): block 0's barrier waits over its total,
  summed over the recorded K6 launches (their barrier stamps);
  ``k6_attention_pct`` beside it, the share of that total in K6's
  attention step;
* ``attn_key_tiles``: the ``dvt.encoder`` spans' counter, the passes a
  row's scores make over its keys in the attention core (1 up to 256
  keys, 3 past: ViT-L at 384 px);
* ``k6_launches_per_call``, ``images_per_k6_launch`` (resident): from the
  ``dvt.call`` counters, K6 launches a call and the calls' images over
  their K6 launches (how the forward cut its batches);
* ``host_cover_pct`` (offline): the share of the calling thread's seconds
  from the first recorded call's start to the last one's end that
  ``dvt.call``, ``dvt.validate.readback``, ``dvt.validate.score`` and
  ``dvt.feed.wait`` cover; ``call_cover_pct``: the share of ``dvt.call``
  that its input, embed, encoder and head cover;
* ``s_per_call_off``, ``s_per_call_on``, ``cost_on_pct``: the stretches'
  seconds a call and what recording adds; ``host_s_per_call_*``: the
  host seconds of a call, from the call to its return;
* ``idle_gaps``: the capture's longest stretches with no device item,
  each with the calling thread's label and the label of the innermost
  host event on any thread at its middle.

Needs a CUDA card; imports neither JAX nor the JAX package."""
from __future__ import annotations

import argparse
import bisect
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "benchmark"))

from diffvit_tpu_torch import engine  # noqa: E402
from diffvit_tpu_torch.config import QuantConfig  # noqa: E402
from diffvit_tpu_torch.data.imagenet import DevicePrefetcher  # noqa: E402
from diffvit_tpu_torch.models.swin import SwinSpec  # noqa: E402
from diffvit_tpu_torch.models.vit import ViTSpec  # noqa: E402
from diffvit_tpu_torch.ops.kernels import build  # noqa: E402
from diffvit_tpu_torch.utils import tracing  # noqa: E402
from harness import cells, drive, models  # noqa: E402

PARTS = ("dvt.call.input", "dvt.embed", "dvt.encoder", "dvt.head")
HOST = ("dvt.call", "dvt.validate.readback", "dvt.validate.score",
        "dvt.feed.wait")
CAPTURE_CALLS = 5


def _quiet(*a):
    return None


class Cell:
    """One cell set up as ``benchmark/harness/drive.py`` sets it up."""

    def __init__(self, name, seed, root=REPO, device="cuda"):
        self.cell = cell = cells.load(root, name, root / "benchmark")
        self.device = device
        tr = cell.traffic
        rng_model, rng_pixels, rng_order, _ = models.streams(seed)
        ip = models.int_model(cell.spec, rng_model)
        pspec = (SwinSpec if cell.config["family"] == "swin" else ViTSpec)(
            **cell.spec.program_fields())
        tmp = tempfile.mkdtemp(prefix="spans-artifact-")
        try:
            path = os.path.join(tmp, "int_model.npz")
            engine.save_int_model(
                path, ip, pspec, QuantConfig.from_dict(cell.spec.quant
                                                       .as_dict()))
            self.model = engine.load_int_model(path, device, **tr["load"])
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        pool = models.codes_pool(cell.spec, ip, tr["pool_images"],
                                 rng_pixels)
        labels = rng_order.integers(0, cell.spec.num_classes, len(pool))
        order = rng_order.permutation(len(pool))
        self.run = drive.Run(engine=engine, DevicePrefetcher=DevicePrefetcher,
                             model=self.model, traffic=tr,
                             seq=np.ascontiguousarray(pool[order]),
                             labels=labels[order], order=order,
                             device=device, cuda=device == "cuda")
        self.offline = tr["mode"] == "offline"
        self.calls = 0
        cell.mode.warm(self.run)
        self.sync()

    def sync(self):
        if self.device == "cuda":
            torch.cuda.synchronize()

    def stretch(self, seconds, calls=None):
        """Calls for ``seconds`` (or ``calls`` of them) as the mix's mode
        drives its window; (seconds, calls, mean host seconds of a call
        from the call to its return)."""
        mode, run, k0 = self.cell.mode, self.run, self.calls
        host = []

        def call(x, **kw):
            t = time.perf_counter()
            out = self.model(x, **kw)
            host.append(time.perf_counter() - t)
            return out

        t0 = time.perf_counter()
        deadline = t0 + seconds

        def stop():
            return time.perf_counter() >= deadline

        if self.offline:
            loader = mode.Batches(run, first=k0, stop=stop, limit=calls)
            feed = DevicePrefetcher(loader, run.traffic["prefetch_depth"],
                                    device=self.device)
            engine.validate(call, feed, print_freq=0, log=_quiet)
            self.calls += len(loader.rows)
        else:
            while (calls is None and not stop()) or \
                    (calls is not None and self.calls - k0 < calls):
                call(mode._request(run, self.calls)[0]).cpu()
                self.calls += 1
        return (time.perf_counter() - t0, self.calls - k0,
                sum(host) / len(host))


def _mean_ms(rec, name, per):
    return sum(s.ms for s in rec.named(name)) / per if per else None


def _union_ns(ivs, lo, hi):
    total, end = 0, lo
    for s, e in sorted(ivs):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def span_metrics(rec, offline):
    calls = rec.named("dvt.call")
    out = {"calls": len(calls)}
    for name, key in zip(PARTS + ("dvt.call",),
                         ("input", "embed", "encoder", "head", "call")):
        out[f"{key}_host_ms"] = _mean_ms(rec, name, len(calls))
    inside = sum(s.ms for s in rec.spans
                 if s.name in PARTS and s.parent is not None
                 and rec.spans[s.parent].name == "dvt.call")
    out["call_cover_pct"] = 100.0 * inside / sum(c.ms for c in calls)
    if offline:
        batches = len(rec.named("dvt.validate.score"))
        out["score_ms"] = _mean_ms(rec, "dvt.validate.score", batches)
        out["readback_ms"] = _mean_ms(rec, "dvt.validate.readback", batches)
        out["feed_wait_ms"] = _mean_ms(rec, "dvt.feed.wait", batches)
        thread = calls[0].thread
        lo, hi = calls[0].start_ns, calls[-1].end_ns
        ivs = [(s.start_ns, s.end_ns) for s in rec.spans
               if s.name in HOST and s.thread == thread]
        out["host_cover_pct"] = 100.0 * _union_ns(ivs, lo, hi) / (hi - lo)
    k6 = [c.counters for c in calls
          if c.counters and c.counters.get("resident_codes")]
    if k6:
        launches = sum(c["resident_codes"] for c in k6)
        out["k6_launches_per_call"] = launches / len(k6)
        out["images_per_k6_launch"] = sum(c["images"] for c in k6) / launches
    tiles = {s.counters["attn_key_tiles"] for s in rec.named("dvt.encoder")
             if s.counters and "attn_key_tiles" in s.counters}
    if tiles:
        out["attn_key_tiles"] = max(tiles)
    if rec.k6:
        wait = sum(ms["barrier_wait"] for _, ms in rec.k6)
        total = sum(ms["total"] for _, ms in rec.k6)
        out["k6_barrier_pct"] = 100.0 * wait / total
        out["k6_attention_pct"] = 100.0 * sum(
            ms["attention"] for _, ms in rec.k6) / total
        out["k6_launches"] = len(rec.k6)
        out["k6_ms_by_kind"] = {k: sum(ms[k] for _, ms in rec.k6)
                                / len(rec.k6) for k in rec.k6[0][1]}
    return out


def idle_gaps(prof, top=6):
    """The capture's longest device-idle stretches, named two ways: by the
    calling thread's innermost ``dvt.`` span and op, and by the innermost
    host event of any thread (the harness's rule before program spans)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        row = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6,
               e.thread)
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith("dvt."):
                dev.append(row)
        elif e.device_type == DeviceType.CPU:
            host.append(row)
    threads = {h[3] for h in host if h[0] == "dvt.call"}
    ivs = sorted((s, e) for _, s, e, _ in dev)
    gaps, end = [], None
    for s, e in ivs:
        if end is not None and s > end:
            gaps.append((s - end, end, s))
        end = e if end is None else max(end, e)
    gaps.sort(reverse=True)
    host.sort(key=lambda r: r[1])
    starts = [h[1] for h in host]
    out = []
    for length, g0, g1 in gaps[:top]:
        mid = 0.5 * (g0 + g1)
        cover = [h for h in host[:bisect.bisect_right(starts, mid)]
                 if h[2] >= mid]
        mine = [h for h in cover if h[3] in threads]
        inner = lambda hs: min(hs, key=lambda h: h[2] - h[1],  # noqa: E731
                               default=None)
        parts = [inner([h for h in mine if h[0].startswith("dvt.")]),
                 inner([h for h in mine if not h[0].startswith("dvt.")])]
        label = " > ".join(h[0] for h in parts if h is not None)
        anyop = inner(cover)
        out.append({"ms": 1e3 * length,
                    "label": label or "no host event on the calling thread",
                    "any_thread": anyop[0] if anyop else "no host event"})
    return out


def measure(c: Cell, seconds, rounds=1):
    """The cell's line (without the card)."""
    from torch.profiler import ProfilerActivity, profile

    off, on, recs = [], [], []
    for phase in ("off", "on", "on", "off") * rounds:
        c.sync()
        if phase == "on":
            with tracing.recording() as rec:
                s, n, host = c.stretch(seconds)
            recs.append(rec)
            on.append((s / n, host))
        else:
            s, n, host = c.stretch(seconds)
            off.append((s / n, host))
    res = {"cell": c.cell.name}
    for i, rec in enumerate(recs):
        res[f"on{i}"] = span_metrics(rec, c.offline)
    for k, pairs in (("off", off), ("on", on)):
        res["s_per_call_" + k] = [p[0] for p in pairs]
        res["host_s_per_call_" + k] = [p[1] for p in pairs]
    res["cost_on_pct"] = 100.0 * (sum(p[0] for p in on)
                                  / sum(p[0] for p in off) - 1.0)
    c.sync()
    acts = [ProfilerActivity.CPU]
    if c.device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with tracing.recording():
            c.stretch(60.0, calls=CAPTURE_CALLS if c.offline
                      else 4 * CAPTURE_CALLS)
        c.sync()
    res["idle_gaps"] = idle_gaps(prof)
    return res


def card():
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return q.stdout.strip() or torch.cuda.get_device_name(0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cells", nargs="*")
    ap.add_argument("--seed", type=int, default=2_718_281_828)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rounds", type=int, default=1,
                    help="times the four stretches are run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("port_spans: no CUDA card")
    build.load_library()
    names = args.cells or [w["name"] for w in json.loads(
        (REPO / "BENCHMARK.json").read_text())["workloads"]]
    gpu = card()
    ok = True
    for name in names:
        try:
            res = measure(Cell(name, args.seed), args.seconds, args.rounds)
        except Exception as e:  # report the cell, go on with the next
            ok = False
            res = {"cell": name, "error": f"{type(e).__name__}: {e}"}
        res["card"] = gpu
        print(json.dumps(res), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""One run of one cell: set-up, the measured window, the traced stretch
after it (``--trace 1``), the check of the outputs against the reference.

The system under test is ``diffvit_tpu_torch`` served as its users serve
it: an int-model artifact saved once in the run's ``TMPDIR`` and loaded
with ``engine.load_int_model`` (with the mix's ``load`` arguments), then
driven by the mix's mode (``benchmark/modes/<mode>.py``): offline
through ``engine.validate``, online by one closed-loop client.

Set-up is everything from the process's start to the first timed call:
the import of torch and the program, the kernels' libraries (built once
in the checkout, ``csrc/build/``: the run that builds them reports the
build's seconds apart, as ``build_s``), the bake, the artifact's round
trip, the K-major copies and K6's packing at the first calls, and the
warm-up over the cell's own shapes."""
from __future__ import annotations

import dataclasses
import gc
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from . import cells, check, models
from .trace import SPAN, Trace, Tracer, Window

REPO = Path(__file__).resolve().parents[2]


def process_age_s() -> float:
    """Seconds since this process started (``/proc``, 10 ms steps)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def _import_program():
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from diffvit_tpu_torch import engine
    from diffvit_tpu_torch.config import QuantConfig
    from diffvit_tpu_torch.data.imagenet import DevicePrefetcher
    from diffvit_tpu_torch.models.swin import SwinSpec
    from diffvit_tpu_torch.models.vit import ViTSpec
    return engine, QuantConfig, DevicePrefetcher, ViTSpec, SwinSpec


class Client:
    """The caller of ``IntModel``: the host span of every call (from the
    call to its return, not synchronized), the logits of every
    ``keep_every``-th call (the device tensor the call returned), and,
    once a tracer is set, its start and stop between calls."""

    def __init__(self, model, keep_every, keep_offset):
        self.model, self.tracer = model, None
        self.keep_every, self.keep_offset = keep_every, keep_offset
        self.calls = 0
        self.enqueue_s = []
        self.kept = {}

    def __call__(self, x, **kw):
        import torch

        k = self.calls
        self.calls += 1
        if self.tracer is not None:
            self.tracer.before(k)
            with torch.profiler.record_function(SPAN + "enqueue"):
                t0 = time.perf_counter()
                out = self.model(x, **kw)
                t1 = time.perf_counter()
        else:
            t0 = time.perf_counter()
            out = self.model(x, **kw)
            t1 = time.perf_counter()
        self.enqueue_s.append(t1 - t0)
        if k % self.keep_every == self.keep_offset:
            self.kept[k] = out
        return out


@dataclasses.dataclass
class Run:
    """What a mode's module drives: the program's ``engine`` and
    ``DevicePrefetcher``, the loaded ``model``, the mix, the pool in the
    seed's order (``seq``; ``labels`` in the same order, ``order`` its
    rows of the unordered pool), the device, and a ``cache`` for the
    module's own state."""
    engine: object
    DevicePrefetcher: object
    model: object
    traffic: dict
    seq: np.ndarray
    labels: np.ndarray
    order: np.ndarray
    device: str
    cuda: bool
    cache: dict = dataclasses.field(default_factory=dict)


def _per_layer(cell, tracer, window):
    """The per-layer metrics, ``busy_s``, the stretch's seconds and the
    breakdown of a traced run."""
    if tracer.captured is None:
        raise RuntimeError(
            f"the profiler saw no device time in {tracer.tries} "
            "captures: no per-layer metric is read from another clock")
    dev, stretch, stretch_s = tracer.captured
    b = cell.traffic["batch"]
    names = lambda n: cells.kernel_names(cell.bench_dir, n)  # noqa: E731
    t = Trace(items=dev, host=[], forwards=len(stretch),
              images_per_forward=[b] * len(stretch), window=window,
              spec=cell.spec, names=names)
    metrics = {}
    for m in cell.per_layer:
        v = cells.reader(cell, m["name"])(t)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    labelled = t if tracer.labelled is None else Trace(
        items=tracer.labelled[0], host=tracer.labelled[1], forwards=0,
        images_per_forward=[], window=window, spec=cell.spec,
        names=names)
    breakdown = {"device_ops": t.device_ops(),
                 "idle_gaps": labelled.idle_gaps()}
    return metrics, t.busy_s(), stretch_s, breakdown


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", fault=None, log=None) -> dict:
    """One run of ``cell``: the result line as a dict.  ``fault`` (the
    tests' planted faults) wraps the loaded model."""
    import torch

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    engine, QuantConfig, DevicePrefetcher, ViTSpec, SwinSpec = \
        _import_program()
    spec, tr = cell.spec, cell.traffic
    rng_model, rng_pixels, rng_order, rng_check = models.streams(seed)
    cuda = device == "cuda"
    build_s = 0.0
    if cuda:
        from diffvit_tpu_torch.ops.kernels import build

        t_build = time.perf_counter()
        build.load_library()
        build_s = time.perf_counter() - t_build
    ip = models.int_model(spec, rng_model)
    pspec = (SwinSpec if cell.config["family"] == "swin" else ViTSpec)(
        **spec.program_fields())
    tmp = tempfile.mkdtemp(prefix="bench-artifact-")
    try:
        path = os.path.join(tmp, "int_model.npz")
        engine.save_int_model(path, ip, pspec,
                              QuantConfig.from_dict(spec.quant.as_dict()))
        model = engine.load_int_model(path, device, **tr["load"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if fault is not None:
        model = fault(model)
    pool = models.codes_pool(spec, ip, tr["pool_images"], rng_pixels)
    labels = rng_order.integers(0, spec.num_classes, len(pool))
    order = rng_order.permutation(len(pool))
    # the pool in the seed's order, once: call k takes rows [k*b, (k+1)*b)
    # of it, cycled
    r = Run(engine=engine, DevicePrefetcher=DevicePrefetcher, model=model,
            traffic=tr, seq=np.ascontiguousarray(pool[order]),
            labels=labels[order], order=order, device=device, cuda=cuda)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cell.mode.warm(r)
    sync()
    setup_s = process_age_s()

    client = Client(model, tr["keep_every"],
                    int(rng_check.integers(0, tr["keep_every"])))
    window_s, rows, latencies = cell.mode.window(r, client, seconds)
    window = Window(seconds=window_s, calls=client.calls,
                    images=client.calls * tr["batch"], latencies_s=latencies,
                    enqueue_s=list(client.enqueue_s), setup_s=setup_s)
    if trace:
        tracer = Tracer(start=client.calls + 2,
                        forwards=tr["trace_forwards"], sync=sync)
        client.tracer = tracer
        cell.mode.traced(r, client, tracer)
        tracer.stop()
    mem_peak = torch.cuda.max_memory_allocated() if cuda else 0
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(mem_peak)}
    breakdown = None
    if trace:
        metrics, busy_s, stretch_s, breakdown = _per_layer(cell, tracer,
                                                           window)
        dev_info.update(busy_s=busy_s, window_s=stretch_s)
    else:
        metrics = {m["name"]: {"value": cells.end_to_end(cell, m["name"])(
                                   window),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}

    # the check: a sample, drawn from the seed, of the window's kept
    # outputs, against the reference, once the program's state is freed
    kept = {k: v.float().cpu() for k, v in client.kept.items()
            if k < window.calls}
    del client, model, r
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    pick = sorted(rng_check.choice(sorted(kept), min(tr["check_batches"],
                                                     len(kept)),
                                   replace=False).tolist())
    numbers = check.compare(cell, ip, pool, [(rows[k], kept[k]) for k in pick],
                            device, log)
    result = {"correct": check.passes(numbers, cell.limits),
              "attempted": window.calls, "failed": 0, "metrics": metrics,
              "device": dev_info, "build_s": build_s}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": v, "limit": cell.limits[k]}
                       for k, v in numbers.items()}
    return result

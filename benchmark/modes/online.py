"""Online serving: one client in a closed loop, each request ``batch``
images of int8 codes in pinned host memory, ``model(x)`` and its logits
read to the host before the next request is sent."""
from __future__ import annotations

import time

import numpy as np

from harness.trace import SPAN

KEYS = ("batch", "warm_batches")


def _host(run):
    """The pool in the seed's order as one host tensor (pinned on a card),
    made once a run."""
    if "host" not in run.cache:
        import torch

        host = torch.from_numpy(run.seq)
        run.cache["host"] = host.pin_memory() if run.cuda else host
    return run.cache["host"]


def _request(run, k):
    """Request k: rows [j*b, (j+1)*b) of the ordered pool, j = k cycled;
    (the host tensor, its rows of the unordered pool)."""
    b = run.traffic["batch"]
    j = k % (len(run.seq) // b)
    return (_host(run)[j * b:(j + 1) * b],
            run.order[j * b + np.arange(b)])


def warm(run):
    """The cell's one shape, ``warm_batches`` requests, before the clock."""
    for k in range(run.traffic["warm_batches"]):
        run.model(_request(run, k)[0]).cpu()


def window(run, client, seconds):
    """The measured window: (its seconds, each request's pool rows, each
    request's seconds from the call to the logits on the host).  A kept
    request's output is its host copy."""
    latencies, rows = [], []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    k = client.calls
    while time.perf_counter() < deadline:
        x, r = _request(run, k)
        t_req = time.perf_counter()
        logits = client(x).cpu()
        latencies.append(time.perf_counter() - t_req)
        if k in client.kept:
            client.kept[k] = logits
        rows.append(r)
        k += 1
    return time.perf_counter() - t0, rows, latencies


def traced(run, client, tracer):
    """After the window: requests until the tracer has its captures."""
    import torch

    k = client.calls
    while not tracer.done and k < tracer.last_call:
        out = client(_request(run, k)[0])
        with torch.profiler.record_function(SPAN + "readback"):
            out.cpu()
        k += 1

"""Offline scoring, as the CLI's ``--load-int`` path scores a dataset:
``engine.validate(model, DevicePrefetcher(loader, prefetch_depth),
print_freq=0)`` over batches of ``batch`` int8-code images from the
pool, batch i+1 issued before batch i's logits are read.  The window's
loader stops at the deadline; the batches already fetched drain and
count."""
from __future__ import annotations

import time

from harness.trace import SPAN

KEYS = ("batch", "prefetch_depth", "warm_batches")


def _quiet(*a):
    return None


class Batches:
    """The loader: batch k is rows [k*b, (k+1)*b) of the pool in the seed's
    order (a view, cycled from row ``first``), with its labels; it stops
    once ``stop()`` says so (asked before each batch) or after ``limit``
    batches.  ``rows[k]`` holds batch k's rows of the unordered pool."""

    def __init__(self, run, first=0, stop=None, limit=None):
        self.run, self.first = run, first
        self.stop, self.limit = stop, limit
        self.rows = []

    def __len__(self):
        # validate asks only for its progress line, which print_freq=0
        # turns off; a window's loader has no length in advance
        return self.limit if self.limit is not None else 0

    def __iter__(self):
        b, seq = self.run.traffic["batch"], self.run.seq
        n = len(seq) // b
        k = 0
        while (self.limit is None or k < self.limit) \
                and not (self.stop is not None and self.stop()):
            j = (self.first + k) % n
            rows = slice(j * b, (j + 1) * b)
            self.rows.append(self.run.order[rows])
            k += 1
            yield seq[rows], self.run.labels[rows]


class Spanned:
    """An iterable whose every ``next`` is the harness span ``name`` (the
    traced stretch's label of the wait for a batch)."""

    def __init__(self, inner, name):
        self.inner, self.name = inner, name

    def __len__(self):
        return len(self.inner)

    def __iter__(self):
        import torch

        it = iter(self.inner)
        while True:
            with torch.profiler.record_function(SPAN + self.name):
                item = next(it, None)
            if item is None:
                return
            yield item


def _validate(run, model, loader, span=None):
    feed = run.DevicePrefetcher(loader, run.traffic["prefetch_depth"],
                                device=run.device)
    if span is not None:
        feed = Spanned(feed, span)
    run.engine.validate(model, feed, print_freq=0, log=_quiet)


def warm(run):
    """The cell's one shape, ``warm_batches`` times, before the clock."""
    _validate(run, run.model, Batches(run,
                                      limit=run.traffic["warm_batches"]))


def window(run, client, seconds):
    """The measured window: (its seconds, each call's pool rows, no
    latencies)."""
    t0 = time.perf_counter()
    deadline = t0 + seconds
    loader = Batches(run, stop=lambda: time.perf_counter() >= deadline)
    _validate(run, client, loader)
    return time.perf_counter() - t0, loader.rows, []


def traced(run, client, tracer):
    """After the window: ``validate`` again until the tracer has its
    captures (a bound on the batches in case it never has)."""
    loader = Batches(run, first=client.calls, stop=lambda: tracer.done,
                     limit=tracer.last_call - client.calls)
    _validate(run, client, loader, span="next_batch")

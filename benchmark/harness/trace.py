"""What the metrics read.

:class:`Window` is the measured window, the same in a traced run as in
an untraced one: its host seconds, its calls and images, each request's
latency, each call's host span, the run's set-up.  The end-to-end
metrics read it, and so do the per-layer metrics that need the
untraced pace.

The traced stretch of a ``--trace 1`` run comes after the window:
``torch.profiler`` over a few tens of steady forwards, bounded by a
synchronize at each end so that the stretch holds exactly the device
work of its forwards (and the copies that ran beside them).  The
profiler slows the host, so no metric reads the stretch's host time.
A capture that saw no device time is taken again on later forwards, up
to ``TRIES`` times; after that the run fails.  No other clock stands in
for the device's.

:class:`Trace` is what the per-layer readers read: the device items
(name, start, end), the harness's host spans, the forwards and images of
the stretch, and the window."""
from __future__ import annotations

import bisect
import dataclasses
import time

TRIES = 5  # torch.profiler now and then records no device activity
SPAN = "bench."  # the harness's own host spans (record_function labels)


@dataclasses.dataclass
class Window:
    """The measured window: its host ``seconds``, its ``calls`` and
    ``images``, each request's seconds from the call to the logits on the
    host (``latencies_s``, online), each call's host span from the call to
    its return, not synchronized (``enqueue_s``), and the run's
    ``setup_s``."""
    seconds: float
    calls: int
    images: int
    latencies_s: list
    enqueue_s: list
    setup_s: float


@dataclasses.dataclass
class Trace:
    """One traced stretch: ``items`` the device items as (name, start_s,
    end_s); ``host`` the host events as (name, start_s, end_s); the
    stretch's forwards and images; ``window`` the run's measured window;
    ``spec`` and ``names`` (a kernel list's name fragments, by list) for
    the readers."""
    items: list
    host: list
    forwards: int
    images_per_forward: list
    window: Window
    spec: object
    names: object

    def busy_s(self) -> float:
        """Seconds in which some device item ran (their union)."""
        total, end = 0.0, None
        for _, s, e in sorted(self.items, key=lambda r: r[1]):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total

    def time_of(self, listname: str) -> float:
        """Summed device seconds of the items whose names hold one of the
        list's fragments."""
        frags = self.names(listname)
        return sum(e - s for n, s, e in self.items
                   if any(f in n for f in frags))

    def device_ops(self, top: int = 10) -> list:
        """The device items that took most time, summed by name."""
        by = {}
        for n, s, e in self.items:
            by[n] = by.get(n, 0.0) + (e - s)
        return [[n, t] for n, t in sorted(by.items(), key=lambda r: -r[1])
                [:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest stretches with no device item running, each named
        by what the host was doing at its middle: the innermost harness
        span and the innermost host event there."""
        ivs = sorted((s, e) for _, s, e in self.items)
        gaps, end = [], None
        for s, e in ivs:
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        host = sorted(self.host, key=lambda r: r[1])
        starts = [h[1] for h in host]
        out = []
        for length, g0, g1 in gaps[:top]:
            mid = 0.5 * (g0 + g1)
            covering = [h for h in host[:bisect.bisect_right(starts, mid)]
                        if h[2] >= mid]
            span = min((h for h in covering if h[0].startswith(SPAN)),
                       key=lambda h: h[2] - h[1], default=None)
            op = min((h for h in covering if not h[0].startswith(SPAN)),
                     key=lambda h: h[2] - h[1], default=None)
            label = " > ".join(h[0] for h in (span, op) if h is not None)
            out.append([label or "no host event", length])
        return out


def events(prof) -> tuple[list, list]:
    """(device items, host events) of a stopped profiler, each as (name,
    start_s, end_s) on the trace's own clock.  The device-side copies of
    the harness's own spans (the profiler's GPU user annotations, which
    cover the kernels that a span launched) are not device items."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        row = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(SPAN):
                dev.append(row)
        elif e.device_type == DeviceType.CPU:
            host.append(row)
    return dev, host


class Tracer:
    """Two captures after the window, each bounded by a synchronize of the
    card.  The first, of the device alone (CUPTI's kernels and copies),
    over ``forwards`` calls from call ``start``: the per-layer metrics read
    its device items.  It is taken again on later calls while it holds no
    device time, up to :data:`TRIES` captures.  The second, of host and
    device, over ``label_forwards`` calls after it: its idle gaps are
    named by what the host was doing.  ``done`` once both are taken or
    the tries are spent; ``last_call`` bounds the calls a caller makes
    for it."""

    def __init__(self, start: int, forwards: int, sync,
                 label_forwards: int = 5):
        self.next_start, self.sync = start, sync
        self.sizes = {"device": forwards, "labels": label_forwards}
        self.last_call = start + TRIES * (forwards + 2) + label_forwards + 4
        self.phase = "device"
        self.prof = None
        self.tries = 0
        self.captured = None     # (device items, call indices, seconds)
        self.labelled = None     # (device items, host events)
        self.calls = []
        self.t0 = None
        self.done = False

    def before(self, k: int):
        """Called before call ``k``: start or stop a capture."""
        if self.done:
            return
        if self.prof is None and k == self.next_start:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CUDA]
            if self.phase == "labels":
                acts.append(ProfilerActivity.CPU)
            self.prof = profile(activities=acts)
            self.sync()
            self.prof.start()
            self.t0 = time.perf_counter()
            self.calls = []
        elif self.prof is not None \
                and len(self.calls) == self.sizes[self.phase]:
            self.stop()
        if self.prof is not None:
            self.calls.append(k)

    def stop(self):
        """End the open capture (also where the calls end first)."""
        if self.prof is None:
            self.done = True
            return
        self.sync()
        seconds = time.perf_counter() - self.t0
        self.prof.stop()
        dev, host = events(self.prof)
        self.prof = None
        if self.phase == "labels":
            self.labelled = (dev, host)
            self.done = True
            return
        self.tries += 1
        if dev:
            self.captured = (dev, list(self.calls), seconds)
            self.phase = "labels"
        elif self.tries >= TRIES:
            self.done = True
        self.next_start = self.calls[-1] + 2

"""Spans and counters inside the port, kept in memory while a recording is
on, and nothing at all while none is.

    from diffvit_tpu_torch.utils import tracing
    with tracing.recording() as rec:
        engine.validate(model, loader, print_freq=0)
    [s.ms for s in rec.named("dvt.validate.score")]

``span(name)`` is the only call the hot path makes.  While nothing
records it returns one shared null context: no allocation, no torch
call.  While a recording is on, each span keeps its name, its
``time.perf_counter_ns()`` start and end, its parent span, its thread and
its ``key``: a root span given no key opens a new one (the id of an
``IntModel`` call), a child takes its parent's, and a caller may pass its
own (``validate``'s batch index).  Where a ``torch.profiler`` capture is
also on, the span is a ``torch.profiler.record_function(name)`` too, so
it lands in the capture on the clock of the CUPTI device items.  A span
opened with ``launches=True`` records, as counters, the kernel launches
made inside it by wrapper: the differences of the wrappers' ``.launches``
attributes (``ops/kernels``).

The served K6 launch writes its barrier stamps while a recording is on
(``ops/kernels/serve.resident_codes``): the recording keeps the stamp
buffers on the card and decodes them (``serve.step_times``) when it ends,
into ``rec.k6`` and the ``k6.<kind>`` counters (block 0's ms) of the span
that made the launch.

The program's spans, all named ``dvt.<...>``, on the thread that calls
the model:

    dvt.call               IntModel.__call__, to its return (unsynchronized);
                           counters: images, launches by wrapper
    dvt.call.input         its mesh slice, uint8 encode, copy, normalize
    dvt.embed              the patch embed and its glue (vit_int, swin_int)
    dvt.encoder            every block (K6's chunks, Swin's stages); counter
                           (ViT): attn_key_tiles, the passes a row's scores
                           make over its keys in the attention core of K1,
                           K5 or K6 (attn_plan.key_tiles: 1 up to 256 keys,
                           3 past)
    dvt.head               the final norm, pooling and head, to the logits
    dvt.validate.readback  validate: the host waiting for batch i's logits
    dvt.validate.score     validate: loss, accuracy, meters, progress line
    dvt.feed.wait          DevicePrefetcher: the wait for the feeder thread

:func:`write_chrome_trace` writes a recording as a Chrome trace
(readable in Perfetto); the CLI's ``--trace-out`` uses it."""
from __future__ import annotations

import array
import contextlib
import json
import os
import threading
import time
from typing import NamedTuple

import torch

# the open Recording, or None; the hot path reads it and nothing else
current = None
_NULL = contextlib.nullcontext()
_ident = threading.get_ident
_now = time.perf_counter_ns
_profiling = torch._C._autograd._profiler_enabled
STAMP_ROWS = 256  # K6 launches a block of stamp buffers serves


class Span(NamedTuple):
    """One recorded span: ``parent`` is the index of its parent in the
    recording's ``spans`` (None for a root), ``thread`` the thread's
    ident, ``end_ns`` None where the recording ended first, ``counters``
    None or a dict."""
    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None
    thread: int
    key: int
    counters: dict | None

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class OpenSpan:
    """A span while it is open (:func:`span`): the caller may add to its
    ``counters`` (a dict where the span counts launches, else None); it
    is a :class:`Span` of the recording once the recording ends."""
    __slots__ = ("rec", "name", "key", "index", "thread", "counters",
                 "_before", "_annotation")

    def __init__(self, rec, name, key, launches):
        self.rec, self.name, self.key = rec, name, key
        self._before = launches

    def __enter__(self) -> OpenSpan:
        rec = self.rec
        self.thread = _ident()
        stack = rec._stacks.get(self.thread)
        if stack is None:
            stack = rec._stacks[self.thread] = []
        parent = stack[-1] if stack else None
        if self.key is None:
            if parent is None:
                self.key = rec._keys
                rec._keys += 1
            else:
                self.key = parent.key
        self.counters = None
        if self._before:
            self.counters = {}
            self._before = [fn.launches for fn in rec._wrappers]
        self._annotation = None
        if _profiling():
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        self.index = len(rec._names)
        rec._names.append(self.name)
        stack.append(self)
        rec._ints.extend((_now(), -1, -1 if parent is None else parent.index,
                          self.thread, self.key))
        return self

    def count(self, name: str, value) -> None:
        """Sets this span's counter ``name`` to ``value``."""
        if self.counters is None:
            self.counters = {}
        self.counters[name] = value

    def __exit__(self, *exc):
        rec = self.rec
        rec._ints[5 * self.index + 1] = _now()
        rec._stacks[self.thread].pop()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        if self._before:
            for fn, n in zip(rec._wrappers, self._before):
                if fn.launches != n:
                    self.counters[fn.__name__] = fn.launches - n
        if self.counters is not None:
            rec._counters[self.index] = self.counters
        return False


class Recording:
    """What one :func:`recording` keeps, complete when it ends: ``spans``
    (:class:`Span`) in the order they were opened, and ``k6``, one (index
    of the span that made the launch, or None; block 0's ms by step kind)
    a stamped K6 launch."""

    def __init__(self):
        from ..ops.kernels import (attention, linear, mlp, serve,
                                   swin_attention)

        self.spans: list[Span] = []
        self.k6: list[tuple] = []
        # while recording, the spans in columns: names, then (start, end,
        # parent, thread, key) a span in one int64 array, -1 for none; so a
        # long recording keeps nothing the garbage collector walks
        self._names: list[str] = []
        self._ints = array.array("q")
        self._counters: dict[int, dict] = {}
        self._stacks: dict[int, list[OpenSpan]] = {}
        self._keys = 0
        self._stamp_blocks = []  # the K6 stamp blocks, in order
        self._stamps = array.array("q")  # (block, row, depth, span) a launch
        self._stamp_open = {}  # (length, device) -> [block no, rows used]
        # the kernel wrappers whose ``.launches`` a span with launches=True
        # counts
        self._wrappers = (
            attention.fused_qkv_attention_v2, attention.fused_qkv_attention,
            attention.fused_qkv_attention_v3,
            attention.fused_qkv_attention_v4,
            attention.fused_qkv_attention_v5, attention.fused_int_attention,
            attention.fused_attention_block, mlp.fused_int_mlp,
            mlp.fused_int_mlp_block, linear.fused_int_linear,
            swin_attention.fused_swin_attention,
            swin_attention.fused_swin_attention_v2, serve.resident_codes)

    def named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def k6_stamps(self, length: int, depth: int, device) -> int:
        """The device address of a zeroed int64 buffer of ``length``
        stamps on ``device`` for one K6 launch of ``depth`` blocks
        (``serve.resident_codes``), kept to be decoded when the recording
        ends: a row of a block of :data:`STAMP_ROWS` zeroed at once, so a
        launch adds no kernel."""
        block = self._stamp_open.get((length, device))
        if block is None or block[1] == STAMP_ROWS:
            block = [len(self._stamp_blocks), 0]
            self._stamp_blocks.append(torch.zeros(
                (STAMP_ROWS, length), dtype=torch.int64, device=device))
            self._stamp_open[(length, device)] = block
        no, row = block
        block[1] += 1
        stack = self._stacks.get(_ident())
        self._stamps.extend((no, row, depth, stack[-1].index if stack else -1))
        buf = self._stamp_blocks[no]
        return buf.data_ptr() + row * length * buf.element_size()

    def _finish(self):
        from ..ops.kernels.serve import step_times

        for i, name in enumerate(self._names):
            start, end, parent, thread, key = self._ints[5 * i:5 * i + 5]
            # a span still open (on another thread) keeps end_ns None
            self.spans.append(Span(name, start, None if end < 0 else end,
                                   None if parent < 0 else parent, thread,
                                   key, self._counters.get(i)))
        hosts = [b.cpu().tolist() for b in self._stamp_blocks]
        st = self._stamps
        for k in range(0, len(st), 4):
            no, row, depth, at = st[k:k + 4]
            steps = step_times(hosts[no][row], depth)
            self.k6.append((None if at < 0 else at, steps))
            if at >= 0:
                c = self.spans[at].counters
                if c is None:
                    c = {}
                    self.spans[at] = self.spans[at]._replace(counters=c)
                for kind, ms in steps.items():
                    c["k6." + kind] = c.get("k6." + kind, 0.0) + ms
        self._names, self._ints, self._counters = [], array.array("q"), {}
        self._stamp_blocks, self._stamps = [], array.array("q")
        self._stamp_open = {}


def span(name: str, key: int | None = None, *, launches: bool = False):
    """A context manager over the work named ``name``: while a recording
    is on it records the span and yields its :class:`OpenSpan` (whose
    ``counters`` dict, with ``launches``, the caller may add to);
    otherwise it is one shared null context that yields None."""
    rec = current
    if rec is None:
        return _NULL
    return OpenSpan(rec, name, key, launches)


@contextlib.contextmanager
def recording():
    """Record every span and K6 launch of this process while open; yields
    the :class:`Recording`, complete once the block has ended (the K6
    stamps are read from the card then).  A recording opened inside
    another takes the spans until it ends."""
    global current
    rec, outer = Recording(), current
    current = rec
    try:
        yield rec
    finally:
        current = outer
        rec._finish()


def write_chrome_trace(rec: Recording, path) -> None:
    """Write the recording to ``path`` as a Chrome trace (``traceEvents``,
    microseconds from its first span; one complete event a span, with its
    key and counters in ``args``), which Perfetto and chrome://tracing
    read."""
    t0 = min((s.start_ns for s in rec.spans), default=0)
    pid = os.getpid()
    events = [{"name": s.name, "ph": "X", "pid": pid, "tid": s.thread,
               "ts": (s.start_ns - t0) / 1e3,
               "dur": (s.end_ns - s.start_ns) / 1e3,
               "args": {"key": s.key, **(s.counters or {})}}
              for s in rec.spans if s.end_ns is not None]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)

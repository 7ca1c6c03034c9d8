"""The port's spans and counters (``diffvit_tpu_torch/utils/tracing.py``) on
the CPU: nothing recorded and no torch call while no recording is on;
``IntModel``'s call, input, embed, encoder and head spans, nested under
the call's key, for a tiny ViT per kernel, resident (K6's plain version)
and a tiny Swin; ``validate``'s readback and score and the prefetcher's
wait, one a batch; the logits unchanged by a recording; the call's launch
counters; K6's stamps read when the recording ends; and the CLI's
``--trace-out`` Chrome trace."""
import ctypes
import json

import numpy as np
import pytest
import torch

from diffvit_tpu_torch import QuantConfig, cli, engine
from diffvit_tpu_torch.data import imagenet
from diffvit_tpu_torch.data.synthetic import make_fake_imagefolder
from diffvit_tpu_torch.models import vit_int
from diffvit_tpu_torch.models.swin import SwinSpec
from diffvit_tpu_torch.models.vit import ViTSpec
from diffvit_tpu_torch.ops.kernels import attention, mlp
from diffvit_tpu_torch.testing import random_int_model, random_swin_int_model
from diffvit_tpu_torch.utils import tracing

TINY = ViTSpec("trace_tiny", embed_dim=64, depth=2, num_heads=2,
               num_classes=10)
SWIN = SwinSpec("trace_swin", embed_dim=32, depths=(2, 1), num_heads=(2, 4),
                img_size=56, num_classes=10)
MODELS = ["vit", "vit-resident", "swin"]
PARTS = ["dvt.call.input", "dvt.embed", "dvt.encoder", "dvt.head"]


def _model(kind):
    if kind == "swin":
        return engine.IntModel(random_swin_int_model(SWIN, seed=0), SWIN,
                               QuantConfig(), "cpu")
    return engine.IntModel(random_int_model(TINY, seed=0), TINY,
                           QuantConfig(), "cpu",
                           resident=kind == "vit-resident")


def _codes(model, b=2, seed=1):
    size = model.spec.img_size
    return np.random.default_rng(seed).integers(
        -60, 60, (b, 3, size, size)).astype(np.int8)


class _ListLoader:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def test_span_is_one_null_context_while_nothing_records(monkeypatch):
    """No recording: ``span`` hands out the same object every time, and
    neither it nor a served call touches ``record_function``."""
    def refuse(*a, **k):
        raise AssertionError("record_function called with no recording")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert tracing.current is None
    nulls = {id(tracing.span(n)) for n in ("dvt.call", "dvt.embed", "x")}
    nulls.add(id(tracing.span("dvt.call", 3, launches=True)))
    assert len(nulls) == 1
    with tracing.span("dvt.call") as sp:
        assert sp is None
    model = _model("vit")
    model(_codes(model))
    with tracing.recording() as rec:  # recording, but no profiler capture
        model(_codes(model))
    assert rec.named("dvt.call")


def test_spans_are_profiler_ranges_under_a_capture():
    """With a ``torch.profiler`` capture on as well, each recorded span is
    also a host range of the capture, by the same name."""
    from torch.profiler import ProfilerActivity, profile

    model = _model("vit")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.recording() as rec:
            model(_codes(model))
    names = [e.name for e in prof.events()]
    assert sorted(n for n in names if n.startswith("dvt.")) == \
        sorted(s.name for s in rec.spans)


@pytest.mark.parametrize("kind", MODELS)
def test_call_spans_nest_under_the_call(kind):
    """One ``IntModel`` call: ``dvt.call`` with its input, embed, encoder
    and head inside it, in that order, on one thread, sharing the call's
    key; two calls take two keys."""
    model = _model(kind)
    x = _codes(model)
    with tracing.recording() as rec:
        model(x)
        model(x)
    calls = rec.named("dvt.call")
    assert len(calls) == 2 and calls[0].key != calls[1].key
    for call in calls:
        at = rec.spans.index(call)
        assert call.parent is None and call.counters["images"] == 2
        kids = [s for s in rec.spans if s.parent == at]
        assert [s.name for s in kids] == PARTS
        assert all(s.key == call.key and s.thread == call.thread
                   for s in kids)
        assert all(call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns
                   for s in kids)
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    assert {s.name for s in rec.spans} == {"dvt.call", *PARTS}


def test_validate_spans_one_a_batch():
    """``validate`` over a ``DevicePrefetcher``: one readback, one score
    and one feed wait a batch, keyed by the batch's index (and one last
    wait, for the loader's end), all on the calling thread."""
    model = _model("vit")
    rng = np.random.default_rng(2)
    batches = [(_codes(model, 2, seed=i), rng.integers(0, 10, 2))
               for i in range(3)]
    feed = imagenet.DevicePrefetcher(_ListLoader(batches), device="cpu")
    with tracing.recording() as rec:
        res = engine.validate(model, feed, print_freq=0, log=lambda *a: None)
    assert res == engine.validate(model, _ListLoader(batches), print_freq=0,
                                  log=lambda *a: None)
    for name in ("dvt.validate.readback", "dvt.validate.score"):
        assert [s.key for s in rec.named(name)] == [0, 1, 2]
    assert [s.key for s in rec.named("dvt.feed.wait")] == [0, 1, 2, 3]
    assert len(rec.named("dvt.call")) == 3
    assert len({s.thread for s in rec.spans}) == 1
    for i in range(3):
        rb, sc = (rec.named(n)[i] for n in ("dvt.validate.readback",
                                            "dvt.validate.score"))
        assert rb.end_ns <= sc.start_ns


@pytest.mark.parametrize("kind", MODELS)
def test_recording_leaves_the_logits_alone(kind):
    """The logits with a recording on equal those with none, bit for bit."""
    model = _model(kind)
    x = _codes(model, 3)
    off = model(x)
    with tracing.recording():
        on = model(x)
    assert torch.equal(on, off)


def test_call_counts_the_launches_it_makes(monkeypatch):
    """``dvt.call``'s launch counters are the differences of the wrappers'
    ``.launches`` over the call: K1 and K2 counted as a card would, one a
    block each (the CPU's plain versions count none by themselves)."""
    def counted(fn, wrapper):
        def call(*a, **k):
            wrapper.launches += 1
            return fn(*a, **k)
        return call
    monkeypatch.setattr(vit_int, "fused_qkv_attention_v2", counted(
        vit_int.fused_qkv_attention_v2, attention.fused_qkv_attention_v2))
    monkeypatch.setattr(vit_int, "fused_int_mlp", counted(
        vit_int.fused_int_mlp, mlp.fused_int_mlp))
    model = _model("vit")
    x = _codes(model)
    counts = []
    with tracing.recording() as rec:
        for _ in range(2):
            before = (attention.fused_qkv_attention_v2.launches,
                      mlp.fused_int_mlp.launches)
            model(x)
            counts.append({
                "fused_qkv_attention_v2":
                    attention.fused_qkv_attention_v2.launches - before[0],
                "fused_int_mlp": mlp.fused_int_mlp.launches - before[1]})
    assert counts[0] == {"fused_qkv_attention_v2": TINY.depth,
                         "fused_int_mlp": TINY.depth}
    for call, want in zip(rec.named("dvt.call"), counts):
        assert call.counters == {"images": 2, **want}


def test_k6_stamps_are_read_when_the_recording_ends():
    """K6 stamp buffers handed out while a span is open (zeroed rows of
    a block, more blocks as launches go on) are decoded when the
    recording ends (``serve.step_times``): into ``rec.k6`` and into the
    span's ``k6.<kind>`` counters, summed over its launches."""
    from diffvit_tpu_torch.ops.kernels.serve import STEPS, step_times
    depth = 2
    n = 1 + 2 * len(STEPS) * depth
    launches = tracing.STAMP_ROWS + 2
    with tracing.recording() as rec:
        with tracing.span("dvt.encoder"):
            addrs = [rec.k6_stamps(n, depth, torch.device("cpu"))
                     for _ in range(launches)]
            bufs = [(ctypes.c_int64 * n).from_address(a) for a in addrs]
            assert all(not any(b) for b in bufs)
            assert len(set(addrs)) == launches
            for j, b in enumerate(bufs):  # the launches write their stamps
                b[:] = [k * (1000 + 250 * j) + 7 for k in range(n)]
            stamps = [list(b) for b in bufs]
        assert rec.k6 == []  # nothing read before the end
    want = [step_times(b, depth) for b in stamps]
    assert rec.k6 == [(0, w) for w in want]
    counters = rec.spans[0].counters
    for kind in want[0]:
        assert counters["k6." + kind] == pytest.approx(
            sum(w[kind] for w in want))


def test_cli_trace_out_writes_a_chrome_trace(tmp_path, capsys):
    """``--load-int ... --trace-out``: a Chrome trace that parses, with a
    ``dvt.validate.score`` for every batch and the call spans inside
    their calls."""
    path = str(tmp_path / "tiny.npz")
    engine.save_int_model(path, random_int_model(TINY, seed=0), TINY,
                          QuantConfig())
    make_fake_imagefolder(str(tmp_path / "val"), num_classes=3, per_class=2,
                          size=(80, 60), seed=3)
    out = tmp_path / "trace.json"
    cli.main(["deit_tiny", str(tmp_path), "--load-int", path, "--device",
              "cpu", "--val-batchsize", "4", "--num-workers", "1",
              "--trace-out", str(out)])
    capsys.readouterr()
    events = json.loads(out.read_text())["traceEvents"]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    scores = [e for e in events if e["name"] == "dvt.validate.score"]
    assert sorted(e["args"]["key"] for e in scores) == [0, 1]  # 6 images
    calls = [e for e in events if e["name"] == "dvt.call"]
    assert len(calls) == 2 and all(c["args"]["images"] in (4, 2)
                                   for c in calls)
    heads = [e for e in events if e["name"] == "dvt.head"]
    assert [h["args"]["key"] for h in heads] == \
        [c["args"]["key"] for c in calls]

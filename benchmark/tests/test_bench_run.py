"""Whole runs of tiny cells on the CPU (the program's plain paths), past
the harness's look for a card: a sound run comes out correct, and each
fault that a served cell can have, and the control in the program's
place, come out not correct."""
from __future__ import annotations

import json

import pytest
import torch

from bench_tiny import (OFFLINE, ONLINE, TINY_SWIN, TINY_VIT, make_root)
from harness import cells, check, drive, reference
from harness.trace import TRIES

CELLS = {
    "vit.resident.offline": ("tiny_vit", "off_res"),
    "vit.kernels.offline": ("tiny_vit", "off_ker"),
    "vit.resident.online": ("tiny_vit", "on_res"),
    "swin.kernels.offline": ("tiny_swin", "off_ker"),
}
MIXES = {"off_res": OFFLINE,
         "off_ker": dict(OFFLINE, load={"resident": False}),
         "on_res": ONLINE}
CONFIGS = {"tiny_vit": TINY_VIT, "tiny_swin": TINY_SWIN}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("checkout"), CELLS, CONFIGS,
                     MIXES)


def _run(root, name, fault=None, seed=2**31 + 7):
    cell = cells.load(root, name, root / "benchmark")
    return drive.run(cell, seed, 0.3, False, device="cpu", fault=fault,
                     log=lambda *a: None)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct(root, name):
    torch.set_num_threads(2)
    r = _run(root, name)
    assert r["correct"] is True, r["check"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "check"
    assert set(r["check"]) == {"gap_steps", "mismatch_pct"}
    assert all(v["value"] == 0.0 for v in r["check"].values())
    want = {m["name"] for m in cells.load(root, name, root / "benchmark")
            .end_to_end}
    assert set(r["metrics"]) == want
    assert all(v["value"] > 0 for v in r["metrics"].values())
    json.dumps(r)


class _Wrapped:
    """A served model whose logits ``edit`` changes after the call."""

    def __init__(self, model, edit):
        self.model, self.edit = model, edit

    def __call__(self, x, **kw):
        return self.edit(self.model(x, **kw), x)


def _half_left_out(out, x):
    # the second half of the batch is never computed: its rows repeat the
    # first half's logits
    h = out.shape[0] // 2
    out = out.clone()
    out[h:2 * h] = out[:h]
    return out


def _answer_altered(out, x):
    # one image's answer is changed where it is produced: it is given the
    # next image's logits
    out = out.clone()
    out[0] = out[1]
    return out


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("edit", [_half_left_out, _answer_altered],
                         ids=["half_left_out", "answer_altered"])
def test_fault_is_not_correct(root, name, edit):
    torch.set_num_threads(2)
    r = _run(root, name, fault=lambda m: _Wrapped(m, edit))
    assert r["correct"] is False, r["check"]


@pytest.mark.parametrize("name", ["vit.resident.offline",
                                  "swin.kernels.offline"])
def test_control_in_programs_place_is_not_correct(root, name, monkeypatch):
    torch.set_num_threads(2)
    cell = cells.load(root, name, root / "benchmark")
    made = {}
    real = drive.models.int_model

    def keep(spec, rng):
        made["ip"] = real(spec, rng)
        return made["ip"]

    monkeypatch.setattr(drive.models, "int_model", keep)

    def fault(model):
        def call(x, **kw):
            ar = reference.Arith("cpu", control=True)
            return reference.forward(cell.spec, made["ip"], x, ar)
        return call

    r = _run(root, name, fault=fault)
    assert r["correct"] is False, r["check"]
    assert r["check"]["mismatch_pct"]["value"] > 0


def test_numbers_of_a_shape_mismatch_fail():
    spec = cells.specs.from_config(TINY_VIT)
    ip = {"act_out": {"scale": 0.0625}}
    n = check.numbers(spec, ip, torch.zeros(2, 3), torch.zeros(3, 3))
    assert not check.passes(n, {"gap_steps": 4.0, "mismatch_pct": 5.0})
    n = check.numbers(spec, ip, torch.full((2, 3), float("nan")),
                      torch.zeros(2, 3))
    assert not check.passes(n, {"gap_steps": 4.0, "mismatch_pct": 5.0})


class _HostOnlyProfile:
    """A profiler whose every capture holds host events and no device
    item."""
    captures = 0

    def __init__(self, activities):
        pass

    def start(self):
        type(self).captures += 1

    def stop(self):
        pass

    def events(self):
        from types import SimpleNamespace

        from torch.autograd import DeviceType

        return [SimpleNamespace(name="aten::mm", device_type=DeviceType.CPU,
                                time_range=SimpleNamespace(start=0, end=1))]


def test_a_trace_without_device_time_fails(root, monkeypatch):
    # every capture is taken again, then the run fails rather than read
    # another clock
    torch.set_num_threads(2)
    monkeypatch.setattr(torch.profiler, "profile", _HostOnlyProfile)
    cell = cells.load(root, "vit.resident.online", root / "benchmark")
    with pytest.raises(RuntimeError, match="no device time"):
        drive.run(cell, 11, 0.2, True, device="cpu", log=lambda *a: None)
    assert _HostOnlyProfile.captures == TRIES


class _DeviceProfile(_HostOnlyProfile):
    """A profiler whose captures hold one K6 launch and one glue kernel."""

    def events(self):
        from types import SimpleNamespace

        from torch.autograd import DeviceType

        def ev(name, kind, s, e):
            return SimpleNamespace(name=name, device_type=kind,
                                   time_range=SimpleNamespace(start=s, end=e))

        return [ev("resident_kernel<2>", DeviceType.CUDA, 0, 900),
                ev("elementwise_kernel", DeviceType.CUDA, 1000, 1100),
                ev("bench.enqueue", DeviceType.CUDA, 0, 1100),
                ev("bench.enqueue", DeviceType.CPU, 850, 1050)]


def test_a_traced_run_reads_the_per_layer_metrics(root, monkeypatch):
    torch.set_num_threads(2)
    monkeypatch.setattr(torch.profiler, "profile", _DeviceProfile)
    cell = cells.load(root, "vit.resident.online", root / "benchmark")
    r = drive.run(cell, 12, 0.2, True, device="cpu", log=lambda *a: None)
    assert r["correct"] is True
    want = {m["name"] for m in cell.per_layer}
    assert set(r["metrics"]) == want
    # the harness's own span is no device item: busy is the two kernels
    assert r["device"]["busy_s"] == pytest.approx(1e-3)
    assert r["metrics"]["glue_ms.lat"]["value"] == pytest.approx(
        0.1 / cell.traffic["trace_forwards"])
    assert r["breakdown"]["idle_gaps"] == [["bench.enqueue",
                                            pytest.approx(1e-4)]]

"""The cells as data found by name: the repository's BENCHMARK.json and
its files, a cell added by new files alone, the JAX guard, the reduction
of a trace."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from bench_tiny import BENCH, REPO, TINY_SWIN
from harness import cells, guard
from harness.trace import Trace, Window

BENCHMARK = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("w", BENCHMARK["workloads"],
                         ids=lambda w: w["name"])
def test_each_cell_loads_and_reports(w):
    cell = cells.load(REPO, w["name"])
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.end_to_end:
        assert callable(cells.end_to_end(cell, m["name"]))
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(cells.reader(cell, m["name"]))
    assert set(cell.limits) == {"gap_steps", "mismatch_pct"}
    assert len(w["why"]) <= 200


def test_benchmark_json_keeps_its_forms():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    metrics = b["end_to_end"] + b["per_layer"]
    names = [x["name"] for x in b["configs"] + b["workloads"] + metrics]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert all(0.01 <= m["bound"] <= 0.25 for m in b["end_to_end"])
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/")
        assert (REPO / c["file"]).exists()
    for m in b["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(b)) < 64 * 1024


def test_a_cell_is_new_files_alone(tmp_path):
    # a configuration, a mix of a new mode, and an end-to-end and a
    # per-layer metric of their own, each added as files and entries only
    root = tmp_path
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "benchmark").rglob("*") if p.is_file()}
    b = json.loads(json.dumps(BENCHMARK))
    (root / "benchmark/configs/tiny_swin.json").write_text(
        json.dumps(TINY_SWIN))
    (root / "benchmark/checks/tiny_swin.json").write_text(json.dumps(
        {"limits": {"gap_steps": {"limit": 1.0},
                    "mismatch_pct": {"limit": 2.0}}}))
    (root / "benchmark/modes/burst.py").write_text(
        (BENCH / "modes/online.py").read_text()
        .replace('KEYS = ("batch", "warm_batches")',
                 'KEYS = ("batch", "warm_batches", "burst")'))
    (root / "benchmark/traffic/burst_b4_kernels.json").write_text(
        json.dumps({"mode": "burst", "load": {"resident": False},
                    "batch": 4, "burst": 8, "pool_images": 16,
                    "warm_batches": 1, "keep_every": 2, "check_batches": 2,
                    "trace_forwards": 4}))
    (root / "benchmark/end_to_end/img_per_s_burst.py").write_text(
        "def read(window):\n    return window.images / window.seconds\n")
    (root / "benchmark/metrics/calls_per_s.py").write_text(
        "def read(trace):\n"
        "    return trace.window.calls / trace.window.seconds\n")
    b["configs"].append({"name": "tiny_swin", "source": "https://x.org",
                         "file": "benchmark/configs/tiny_swin.json",
                         "reduced": [], "why": "tiny"})
    b["workloads"].append({"name": "tiny_swin.kernels.b4",
                           "config": "tiny_swin",
                           "traffic": "burst_b4_kernels", "chips": 1,
                           "why": "tiny"})
    b["end_to_end"].append({"name": "img_per_s_burst", "unit": "img/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["tiny_swin.kernels.b4"]})
    b["per_layer"].append({"name": "calls_per_s", "unit": "1/s",
                           "better": "higher", "source": "host_clock",
                           "layer": "engine", "moves": "img_per_s_burst",
                           "workloads": ["tiny_swin.kernels.b4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = cells.load(root, "tiny_swin.kernels.b4", root / "benchmark")
    assert cell.spec.depths == (2, 1) and cell.traffic["burst"] == 8
    assert cell.mode.KEYS[-1] == "burst"
    assert {m["name"] for m in cell.end_to_end} == {"img_per_s_burst",
                                                   "setup_s"}
    assert [m["name"] for m in cell.per_layer] == ["calls_per_s"]
    window = Window(seconds=2.0, calls=5, images=20, latencies_s=[],
                    enqueue_s=[], setup_s=1.0)
    assert cells.end_to_end(cell, "img_per_s_burst")(window) == 10.0
    assert cells.reader(cell, "calls_per_s")(
        Trace(items=[], host=[], forwards=0, images_per_forward=[],
              window=window, spec=None, names=None)) == 2.5
    for p, data in before.items():
        assert (root / p).read_bytes() == data
    # a mix that lacks a key its mode names is refused
    (root / "benchmark/traffic/burst_b4_kernels.json").write_text(
        json.dumps({"mode": "burst", "load": {}, "batch": 4,
                    "pool_images": 16, "warm_batches": 1, "keep_every": 2,
                    "check_batches": 2, "trace_forwards": 4}))
    with pytest.raises(ValueError, match="burst"):
        cells.load(root, "tiny_swin.kernels.b4", root / "benchmark")


def test_guard_compares_whole_top_level_names():
    assert guard.jax_modules(["diffvit_tpu_torch", "diffvit_tpu_torch.engine",
                              "jaxtyping", "numpy"]) == []
    assert guard.jax_modules(["diffvit_tpu.models", "jax.numpy", "flax",
                              "jaxlib.xla_client"]) == ["diffvit_tpu", "flax",
                                                        "jax", "jaxlib"]


def test_trace_reduction():
    items = [("resident_kernel", 0.0, 1.0), ("aten::add", 0.5, 1.5),
             ("void dvt::wg::wgmma_gemm_kernel<Fc1Hidden>", 3.0, 4.0)]
    host = [("bench.enqueue", 1.6, 2.5), ("cudaLaunchKernel", 1.8, 2.4),
            ("aten::copy_", 2.6, 2.9)]
    names = {"k6": ["resident_kernel"], "k2": ["Fc1Hidden", "Fc2Out"],
             "port": ["resident_kernel", "wgmma_gemm_kernel"]}
    window = Window(seconds=10.0, calls=4, images=32, latencies_s=[],
                    enqueue_s=[0.001, 0.003], setup_s=1.0)
    t = Trace(items=items, host=host, forwards=2, images_per_forward=[8, 8],
              window=window, spec=None, names=names.__getitem__)
    assert t.busy_s() == pytest.approx(2.5)
    assert t.time_of("k6") == 1.0 and t.time_of("k2") == 1.0
    assert t.time_of("port") == 2.0
    assert t.idle_gaps() == [["bench.enqueue > cudaLaunchKernel",
                              pytest.approx(1.5)]]
    assert t.device_ops()[0][1] == 1.0
    # the readers that need the pace read the untraced window: 2.5 s
    # busy over 2 forwards against 2.5 s a call there, the enqueue mean
    # over the window's calls
    idle = cells._module(BENCH / "metrics/idle_pct.py", "idle").read
    enqueue = cells._module(BENCH / "metrics/enqueue_ms.py", "enq").read
    assert idle(t) == pytest.approx(50.0)
    assert enqueue(t) == pytest.approx(2.0)

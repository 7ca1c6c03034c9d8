"""A cell's definition, found by name: ``BENCHMARK.json`` at the root of
the checkout names the cell's configuration and traffic mix; the
configuration's file, the mix's file (``benchmark/traffic/<mix>.json``),
the module of the mix's mode (``benchmark/modes/<mode>.py``), the check's
limits (``benchmark/checks/<configuration>.json``), each end-to-end
metric's reader (``benchmark/end_to_end/<metric>.py``), each per-layer
metric's reader (``benchmark/metrics/<metric>.py``) and the kernel-name
lists they read (``benchmark/kernels/<list>.json``) are data and small
files of their own.  A new cell, mix, mode, configuration or metric is
new files and new entries in ``BENCHMARK.json``; no file here changes."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

from . import specs

HERE = Path(__file__).resolve().parent.parent  # benchmark/
# every mix has these; its mode's module names the rest (``KEYS``), and
# ``load`` holds the keyword arguments of ``engine.load_int_model``
TRAFFIC_KEYS = {"mode", "load", "pool_images", "keep_every",
                "check_batches", "trace_forwards"}


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    spec: object
    traffic_name: str
    traffic: dict
    mode: object          # the mode's module (benchmark/modes/<mode>.py)
    chips: int
    end_to_end: list      # the entries of BENCHMARK.json this cell reports
    per_layer: list
    limits: dict          # check number -> limit
    bench_dir: Path


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _module(path: Path, name: str):
    if not path.exists():
        raise FileNotFoundError(f"{path}: no such file")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _traffic(path: Path, bench_dir: Path) -> dict:
    t = json.loads(path.read_text())
    missing = TRAFFIC_KEYS - set(t)
    if missing:
        raise ValueError(f"{path}: missing {sorted(missing)}")
    need = set(mode_of(bench_dir, t["mode"]).KEYS) - set(t)
    if need:
        raise ValueError(f"{path}: a {t['mode']} mix needs {sorted(need)}")
    return t


def mode_of(bench_dir: Path, mode: str):
    """The module of a mix's mode: ``benchmark/modes/<mode>.py`` (``KEYS``,
    ``warm(run)``, ``window(run, client, seconds)``, ``traced(run,
    client, tracer)``)."""
    return _module(bench_dir / "modes" / f"{mode}.py", f"bench_mode_{mode}")


def load(root: Path, name: str, bench_dir: Path = HERE) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; its files under
    ``bench_dir`` (``root/benchmark`` by default)."""
    bench = json.loads((Path(root) / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((Path(root) / conf["file"]).read_text())
    checks = json.loads((bench_dir / "checks" /
                         f"{w['config']}.json").read_text())
    traffic = _traffic(bench_dir / "traffic" / f"{w['traffic']}.json",
                       bench_dir)
    return Cell(
        name=name, config_name=w["config"], config=config,
        spec=specs.from_config(config), traffic_name=w["traffic"],
        traffic=traffic, mode=mode_of(bench_dir, traffic["mode"]),
        chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        limits={k: float(v["limit"]) for k, v in checks["limits"].items()},
        bench_dir=bench_dir)


def reader(cell: Cell, metric: str):
    """The ``read(trace)`` function of ``benchmark/metrics/<metric>.py``,
    or where there is none, of the file named by the metric's name up to
    its first dot (one reader for ``mfu.tput`` and ``mfu.lat``)."""
    path = cell.bench_dir / "metrics" / f"{metric}.py"
    if not path.exists():
        path = cell.bench_dir / "metrics" / f"{metric.split('.')[0]}.py"
    return _module(path, "bench_metric_" + metric.replace(".", "_")).read


def end_to_end(cell: Cell, metric: str):
    """The ``read(window)`` function of
    ``benchmark/end_to_end/<metric>.py``."""
    return _module(cell.bench_dir / "end_to_end" / f"{metric}.py",
                   "bench_e2e_" + metric.replace(".", "_")).read


def kernel_names(bench_dir: Path, listname: str) -> list[str]:
    """The name fragments of ``benchmark/kernels/<listname>.json``: a
    device item belongs to the list where its name holds one of them."""
    return json.loads((bench_dir / "kernels" / f"{listname}.json")
                      .read_text())["names"]

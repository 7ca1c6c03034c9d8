"""Tiny cells for the benchmark's CPU tests: a checkout root in a temporary
directory whose ``BENCHMARK.json`` names tiny configurations and mixes
written beside it, the harness's own checks and readers copied in, so a
whole run drives the program's plain CPU paths in seconds."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (str(REPO), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

QUANT = json.loads((BENCH / "configs" / "deit_small_p2vit_w4a8.json")
                   .read_text())["quant"]
TINY_VIT = dict(family="vit", name="tiny_vit", embed_dim=64, depth=2,
                num_heads=2, patch_size=16, img_size=224, mlp_ratio=4,
                num_classes=10, input_quant=True, ln_eps=1e-6, quant=QUANT)
TINY_SWIN = dict(family="swin", name="tiny_swin", embed_dim=32,
                 depths=[2, 1], num_heads=[2, 4], window=7, patch_size=4,
                 img_size=56, mlp_ratio=4, num_classes=10, input_quant=True,
                 patch_norm=True, ln_eps=1e-5, quant=QUANT)
OFFLINE = dict(mode="offline", load={"resident": True}, batch=5,
               prefetch_depth=2, pool_images=20, warm_batches=1,
               keep_every=2, check_batches=3, trace_forwards=4)
ONLINE = dict(mode="online", load={"resident": True}, batch=2,
              pool_images=8, warm_batches=1, keep_every=2, check_batches=3,
              trace_forwards=4)


def _reports(metric: str, mix: dict) -> bool:
    """Whether a cell of ``mix`` reports ``metric``, as the repository's
    cells do."""
    online = mix["mode"] == "online"
    resident = mix["load"].get("resident", False)
    if metric == "setup_s":
        return True
    if metric.startswith("request_ms") or metric.endswith(".lat"):
        return online and (not metric.startswith("k6") or resident)
    if metric.startswith("k6"):
        return not online and resident
    if metric.startswith("k2"):
        return not online and not resident
    return not online


# the tiny configurations' check limits, from their CPU readings as the
# repository's are set from the card's: the program reads 0 and 0, the
# control at least 1 step and 1% (test_bench_reference.py)
TINY_LIMITS = {"gap_steps": {"limit": 0.5}, "mismatch_pct": {"limit": 0.5}}


def make_root(tmp: Path, cells: dict, configs: dict, mixes: dict) -> Path:
    """A checkout root at ``tmp``: ``cells`` {name: (config, mix)},
    ``configs`` {name: config dict}, ``mixes`` {name: mix dict}; the
    benchmark's own modes, metrics and kernel lists copied, and every
    configuration's check limits :data:`TINY_LIMITS`."""
    bench = tmp / "benchmark"
    for sub in ("modes", "end_to_end", "metrics", "kernels"):
        shutil.copytree(BENCH / sub, bench / sub)
    for sub in ("configs", "traffic", "checks"):
        (bench / sub).mkdir(parents=True)
    for name, conf in configs.items():
        (bench / "configs" / f"{name}.json").write_text(json.dumps(conf))
        (bench / "checks" / f"{name}.json").write_text(json.dumps(
            {"limits": TINY_LIMITS}))
    for name, mix in mixes.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    bench_json = json.loads((REPO / "BENCHMARK.json").read_text())
    bench_json["configs"] = [
        {"name": n, "source": "https://example.org", "reduced": [],
         "file": f"benchmark/configs/{n}.json", "why": "tiny"}
        for n in configs]
    bench_json["workloads"] = [
        {"name": n, "config": c, "traffic": m, "chips": 1, "why": "tiny"}
        for n, (c, m) in cells.items()]
    for m in bench_json["end_to_end"] + bench_json["per_layer"]:
        m["workloads"] = [n for n, (_, mix) in cells.items()
                          if _reports(m["name"], mixes[mix])]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench_json))
    return tmp

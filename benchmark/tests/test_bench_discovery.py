"""Adding a configuration, a cell or a per-layer metric is adding files
(and entries in ``BENCHMARK.json``): dropped into a temporary copy of the
benchmark, they are found with no edit to any existing file."""

import json
import os
import shutil
import time

import nano
from harness import cell, spec

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

READER = '''"""A test metric: files completed in the window."""


def read(ctx):
    return float(len(ctx.requests)) if ctx.requests else None
'''


def test_new_config_cell_and_metric_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json"), root / "BENCHMARK.json")
    before = {p: open(p, "rb").read() for p in map(str, root.rglob("*")) if os.path.isfile(p)}
    bench_dir = str(root / "benchmark")

    (root / "benchmark" / "configs" / "nano.json").write_text(json.dumps(nano.config()))
    w = nano.workload("offline")
    w["config"] = "nano"
    (root / "benchmark" / "workloads" / "nano.offline.json").write_text(json.dumps(w))
    (root / "benchmark" / "metrics" / "files_done.offline.py").write_text(READER)
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "nano", "source": "test", "file": "benchmark/configs/nano.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "nano.offline", "config": "nano", "traffic": "offline", "chips": 1,
                           "why": "test"})
    b["per_layer"].append({"name": "files_done.offline", "unit": "files", "better": "higher",
                           "source": "program_counter", "layer": "pipeline", "moves": "audio_s_per_s",
                           "workloads": ["nano.offline"]})
    for m in b["end_to_end"]:
        if "workloads" in m and "large-v3.offline_long" in m["workloads"]:
            m["workloads"].append("nano.offline")
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    assert spec.chips(spec.benchmark(bench_dir), "nano.offline") == 1
    names = [m["name"] for m in spec.per_layer(spec.benchmark(bench_dir), "nano.offline")]
    assert names == ["files_done.offline"]
    out, _ = cell.run("nano.offline", 3, 3.0, True, t_start=time.perf_counter(), device="cpu",
                      bench_dir=bench_dir, log=lambda s: None)
    assert out["correct"], out["checks"]
    assert out["metrics"]["files_done.offline"]["value"] >= 1
    out, _ = cell.run("nano.offline", 3, 3.0, False, t_start=time.perf_counter(), device="cpu",
                      bench_dir=bench_dir, log=lambda s: None)
    assert set(out["metrics"]) == {"audio_s_per_s", "peak_mem_gib", "setup_s"}
    for p, data in before.items():  # nothing that was there was edited
        if not p.endswith("BENCHMARK.json"):
            assert open(p, "rb").read() == data, p

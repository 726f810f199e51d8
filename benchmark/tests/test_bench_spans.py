"""The per-layer metrics that read the port's spans and counters
(``harness/spans.py``): a traced test-nano run of an offline and of a serve
cell on the CPU, in a copy of the benchmark as ``test_bench_discovery.py``
makes one, reads a value for each metric of the cell whose reader is there,
and edits no file of the copy. In serving the drain and bucket waits add
up to the queue wait; no step graph is built on the CPU."""

import os
import shutil
import time

import pytest

import nano
from harness import cell, spec

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _span_metrics(bench_dir: str, cell_name: str) -> list:
    names = []
    for m in spec.per_layer(spec.benchmark(bench_dir), cell_name):
        with open(os.path.join(bench_dir, "metrics", m["name"] + ".py")) as f:
            if "harness.spans" in f.read():
                names.append(m["name"])
    return names


@pytest.mark.parametrize("kind", ["offline", "serve"])
def test_span_metrics_read_a_value(tmp_path, kind):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json"), root / "BENCHMARK.json")
    before = {p: open(p, "rb").read() for p in map(str, root.rglob("*")) if os.path.isfile(p)}
    bench_dir = str(root / "benchmark")
    name = nano.CELLS[kind]
    names = _span_metrics(bench_dir, name)
    assert len(names) == {"offline": 5, "serve": 7}[kind]

    # serving: a window long enough that calls end before its slice opens
    seconds = {"offline": 3.0, "serve": 8.0}[kind]
    out, jax_like = cell.run(name, 2**31 + 777, seconds, True, t_start=time.perf_counter(), device="cpu",
                             bench_dir=bench_dir, workload=nano.workload(kind), config=nano.config(),
                             log=lambda s: None)
    assert not jax_like and out["correct"], out["checks"]
    got = {n: out["metrics"].get(n, {}).get("value") for n in names}
    assert None not in got.values(), got
    assert got[f"graph_builds.{kind}"] == 0
    assert 0 <= got[f"step_gap.{kind}"] < 100
    assert got[f"encoder_ms.{kind}"] > 0 and got[f"step_replay_ms.{kind}"] > 0
    if kind == "serve":
        queue = out["metrics"]["queue_wait_ms.serve"]["value"]
        assert got["drain_wait_ms.serve"] + got["bucket_wait_ms.serve"] == pytest.approx(queue, rel=1e-6)
    for p, data in before.items():  # the run edited nothing that was there
        assert open(p, "rb").read() == data, p

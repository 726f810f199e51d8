"""Finds every part of a cell by name, so that a new configuration, traffic
mix, cell or per-layer metric is a new file and an entry in
``BENCHMARK.json``, never an edit:

- ``configs/<config>.json``: a configuration (sizes, precision, options);
- ``workloads/<cell>.json``: a cell: its configuration, its traffic kind
  and that kind's parameters;
- ``traffic/<kind>.py``: the driver of one traffic kind (``warm(ctx)`` and
  ``window(ctx)``);
- ``metrics/<metric>.py``: the reader of one per-layer metric
  (``read(ctx)``, None where it finds nothing to read).

Which metrics a cell reports is read from ``BENCHMARK.json``: every
end-to-end metric and every per-layer metric whose ``workloads`` list names
the cell, or that has no such list.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def root() -> str:
    """The checkout: the directory that holds ``BENCHMARK.json``."""
    return os.path.dirname(BENCH_DIR)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str) -> ModuleType:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(bench_dir: str = BENCH_DIR) -> dict:
    return _json(os.path.join(os.path.dirname(bench_dir), "BENCHMARK.json"))


def workload(name: str, bench_dir: str = BENCH_DIR) -> dict:
    w = _json(os.path.join(bench_dir, "workloads", f"{name}.json"))
    w.setdefault("name", name)
    return w


def config(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _json(os.path.join(bench_dir, "configs", f"{name}.json"))


def traffic(kind: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    return _module(os.path.join(bench_dir, "traffic", f"{kind}.py"), f"bench_traffic_{kind}")


def metric_reader(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    return _module(os.path.join(bench_dir, "metrics", f"{name}.py"),
                   "bench_metric_" + name.replace(".", "_").replace("-", "_"))


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def end_to_end(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if _applies(m, cell)]


def per_layer(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["per_layer"] if _applies(m, cell)]


def chips(bench: dict, cell: str) -> int:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return int(w["chips"])
    raise KeyError(f"no cell {cell!r} in BENCHMARK.json")

"""Finds every part of a cell by name, so that a new configuration, traffic
mix, cell or per-layer metric is a new file and an entry in
``BENCHMARK.json``, never an edit:

- ``configs/<config>.json``: a configuration (sizes, precision, options).
  An optional ``align`` section gives it WhisperX's forced alignment:
  ``name`` (the model's published name, under which its converted checkpoint
  is written and loaded), ``source`` (its public ``config.json``),
  ``hf_config`` (that file's ``hidden_size``, ``num_hidden_layers``,
  ``num_attention_heads``, ``intermediate_size``, ``conv_dim``,
  ``conv_kernel``, ``conv_stride``, ``feat_extract_norm``,
  ``do_stable_layer_norm``, ``num_conv_pos_embeddings``,
  ``num_conv_pos_embedding_groups``, ``vocab_size``, ``conv_bias``),
  ``dictionary`` (the CTC label set) and ``interpolate_method``. With it
  the run draws seeded wav2vec2 weights (``reference/params.py``), loads the aligner through the port's
  ``alignment.load_align_model`` (``program.aligner``), installs a
  vocabulary whose text the aligner can time (``vocab.py``) and checks the
  aligned words against ``reference/wav2vec2.py`` and ``reference/ctc.py``
  (``check.compare_alignment``); a cell of traffic ``offline_words``
  aligns each file. A configuration that aligns is therefore a new
  configuration file, a new cell file with the ``align_*`` limits, their
  entries in ``BENCHMARK.json``, and any per-layer readers of its own;
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

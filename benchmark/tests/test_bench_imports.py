"""What a run imports: no module of the JAX side (``jax``, ``jaxlib``,
``flax``, ``whisperx_tpu``; top-level names compared whole, so the port
``whisperx_tpu_torch`` is not ``whisperx_tpu``), and a reference that
imports nothing of the program."""

import ast
import glob
import json
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
JAX_SIDE = {"jax", "jaxlib", "flax", "whisperx_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": ""}, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_imports_nothing_of_the_jax_side():
    """Every module a run imports: the harness, the reference, every
    traffic driver and metric reader, and the program's modules the
    set-up and the traffic reach."""
    code = f"""
import json, sys, glob
sys.path.insert(0, {BENCH!r})
sys.path.insert(0, {ROOT!r})
from harness import cell, check, program, spec, readers, stats, flops, trace, audio, vocab
from reference import ctc, frontend, params, rules, wav2vec2, whisper
for kind in ("offline", "offline_words", "serve"):
    spec.traffic(kind)
for path in glob.glob({os.path.join(BENCH, 'metrics', '*.py')!r}):
    spec.metric_reader(path.rsplit('/', 1)[1][:-3])
import whisperx_tpu_torch.asr, whisperx_tpu_torch.serve, whisperx_tpu_torch.convert.checkpoint
import whisperx_tpu_torch.vad, whisperx_tpu_torch.ops.flash_attention, whisperx_tpu_torch.utils.metrics
import whisperx_tpu_torch.alignment
import torch.profiler
print(json.dumps(sorted({{m.split('.', 1)[0] for m in sys.modules}})))
"""
    tops = _loaded(code)
    assert "whisperx_tpu_torch" in tops
    assert not tops & JAX_SIDE, tops & JAX_SIDE


def test_reference_imports_nothing_of_the_program():
    code = f"""
import json, sys
sys.path.insert(0, {BENCH!r})
from reference import ctc, frontend, params, rules, wav2vec2, whisper
print(json.dumps(sorted({{m.split('.', 1)[0] for m in sys.modules}})))
"""
    tops = _loaded(code)
    assert not tops & (JAX_SIDE | {"whisperx_tpu_torch", "harness"}), tops
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in JAX_SIDE | {"whisperx_tpu_torch", "harness"}, (path, n)

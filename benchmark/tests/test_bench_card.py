"""On the card only: one short run of each cell through ``run.py``, whose
last line must be a correct result on the device it names. Without a CUDA
device the test skips; it decides so inside the test."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.card
@pytest.mark.parametrize("cell", ["large-v3.offline_long", "large-v3-turbo.serve_short",
                                  "large-v3-turbo.offline_long"])
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(2**31 + 7),
                          "--seconds", "5", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu", res

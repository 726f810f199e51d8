"""The benchmark's own tests (``python -m pytest benchmark/tests``): on the
CPU at the test-nano size, and one test marked ``card`` that runs only
where a CUDA device is present (it decides inside the test)."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")

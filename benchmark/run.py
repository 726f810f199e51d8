"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the chips the cell asks for.
Set-up (weights from the seed, the pipeline, the audio pool, one warm-up
pass over the cell's shapes) is timed as ``setup_s``; then the cell's
traffic runs for ``--seconds``. With ``--trace 0`` the last line of standard
output reports the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics read from a profiled slice of the window. Then the
outputs are checked against the plain reference; the numbers compared are
printed, each beside its limit, as the last lines of standard error and
under ``checks`` in the result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from harness import spec  # noqa: E402


def _finite(x):
    """JSON has no infinity: a missing request's latency prints as 1e30."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return 1e30 if isinstance(x, float) and not math.isfinite(x) else x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec.benchmark()
    chips = spec.chips(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from harness import cell

    out, jax_like = cell.run(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START,
                             log=lambda s: print(s, flush=True))
    if jax_like:
        print(f"modules of the JAX side loaded in the benchmark's process: {jax_like}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(_finite(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

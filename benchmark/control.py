"""The readings the limits of ``correct`` are set from, on the chip.

    python3 benchmark/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...] [--control 0|1|2]

For each seed, one run of the cell at its own load, then the check. With
``--control 1`` the control (``reference/whisper.py`` in fp8 e4m3) takes
the program's place: at each position of the served tokens its own choice
is judged, ``max_gap`` is its widest gap (the upper reading) and ``correct``
must come out false; the program's own widest gap over the same tokens is
printed beside it as ``program_gap`` (a lower reading). With ``--control 2``
(a configuration that aligns) the aligner's control, ``reference/wav2vec2.py``
in bfloat16, takes the aligner's place, the Whisper half as the program
served it: ``align_score_gap`` and ``align_path_gap`` are its readings, the
program's own beside them as ``program_align_score_gap`` and
``program_align_path_gap``. With ``--control 0`` the run is the benchmark's
own. One JSON line per seed. Not run by the benchmark's own runs.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, choices=(0, 1, 2), default=1)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from harness import cell

    for seed in args.seeds:
        t0 = time.perf_counter()
        out, _ = cell.run(args.workload, seed, args.seconds, False, t_start=t0, control=args.control)
        row = {"seed": seed, "correct": out["correct"], "metrics": {k: v["value"] for k, v in out["metrics"].items()},
               **{k: v["value"] for k, v in out["checks"].items()}, **out["extra"],
               "wall_s": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())

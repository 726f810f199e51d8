"""The offered-load sweep of a serving cell, on the chip: one set-up, then
one window at each rate, in the order given.

    python3 benchmark/sweep.py --workload <cell> --seed <n> --seconds <s> --rates <r> [<r> ...]

Per rate, one JSON line: the latencies' median and 95th percentile over all
requests due in the window, the backlog (the time from the window's close
to the last result; it grows with the window once the rate passes what the
system sustains), requests per call, and the generator's lateness.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from harness import program, spec  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from harness import audio, cell, stats, vocab
    from reference.params import make_weights

    w = spec.workload(args.workload)
    cfg = spec.config(w["config"])
    drive = spec.traffic(w["traffic"])
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp, vocab.installed(tmp) as vocab_path:
        ctx = cell.Ctx(args.workload, w, cfg, args.seed, args.seconds, False, dev)
        ctx.pipeline = program.build(cfg, w, make_weights(cfg, args.seed, dev), dev, vocab_path)
        ctx.pool = audio.pool(w["params"]["pool_s"], args.seed, dev)
        for rate in args.rates:
            ctx.workload = {**w, "params": {**w["params"], "rate_per_s": rate}}
            ctx.requests, ctx.batcher_after = [], None
            drive.warm(ctx)
            t0 = time.perf_counter()
            e2e = drive.window(ctx)
            lat = stats.latencies(ctx.requests)
            close = min(r["due"] for r in ctx.requests) + args.seconds
            last = max((r["done"] for r in ctx.requests if "done" in r), default=close)
            b, a = ctx.batcher_before, ctx.batcher_after
            print(json.dumps({
                "rate_per_s": rate, "requests": len(ctx.requests), **e2e,
                "latency_mean_s": sum(lat) / len(lat),
                "backlog_s": last - close,
                "requests_per_call": (a["requests"] - b["requests"]) / max(1, a["batches"] - b["batches"]),
                "lateness_max_s": ctx.lateness_s, "failed": sum(1 for x in lat if x == float("inf")),
                "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

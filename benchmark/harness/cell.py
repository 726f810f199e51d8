"""One run of one cell: set-up, the measured window, the readers, the check.

``run`` returns the result line's object; ``run.py`` prints it. The device
is CUDA on the chip; the CPU tests pass ``device="cpu"`` and a small
configuration to drive the same code.
"""

from __future__ import annotations

import gc
import tempfile
import time
from typing import Dict, List, Optional

from harness import audio, check, program, spec, trace, vocab


class Ctx:
    """What the traffic drivers and the metric readers see."""

    def __init__(self, cell: str, workload: dict, config: dict, seed: int, seconds: float,
                 trace_on: bool, device):
        self.cell, self.workload, self.config = cell, workload, config
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace_on, device
        self.requests: List[dict] = []
        self.window_s: Optional[float] = None
        self.pipeline = self.pool = None
        self.aligner = None  # (aligner, metadata) of a configuration that aligns
        self.trace_summary: Optional[Dict] = None
        self.k1_launches = 0
        self.tracker: Dict = {}
        self.batcher_before = self.batcher_after = None
        self.counters_end: Optional[dict] = None
        self.counters_s: Optional[float] = None
        self.lateness_s: Optional[float] = None
        self.traced = _CountedSlice(self) if trace_on else None
        self._handed = False

    @property
    def dims(self) -> dict:
        from reference.params import dims_of

        return dims_of(self.config)

    def audio(self, req: dict):
        return self.pool[req["offset"]:req["offset"] + req["n"]]

    def close_counters(self) -> None:
        """The per-layer metrics' counters (the tracker's, the batcher's)
        are read from the window's start to here: in a traced run, where
        its profiled slice opens, since starting the profiler stalls the
        process for seconds and the slice's own work runs slower."""
        if self.counters_end is None:
            batcher = getattr(self, "batcher", None)
            self.counters_end = {"t": time.perf_counter(), "tracker": _tracker_snapshot()}
            if batcher is not None:
                self.batcher_after = batcher.stats_snapshot()

    def slice(self, on: bool) -> trace.Slice:
        """The traced run's profiled slice, readied in the set-up (a run
        profiles one slice): off unless ``on`` and the run is traced. Its
        K1 launches are counted from the port's counter."""
        if on and self.traced is not None and not self._handed:
            self._handed = True
            return self.traced
        return trace.Slice(False)


class _CountedSlice(trace.Slice):
    def __init__(self, ctx: Ctx):
        super().__init__(True)
        self.ctx = ctx

    def __enter__(self):
        self.ctx.close_counters()
        super().__enter__()
        from whisperx_tpu_torch.ops.flash_attention import flash_attention

        self._k1 = flash_attention.launches
        return self

    def __exit__(self, *exc):
        import torch
        from whisperx_tpu_torch.ops.flash_attention import flash_attention

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.ctx.k1_launches += flash_attention.launches - self._k1
        return super().__exit__(*exc)


def _tracker_snapshot() -> dict:
    from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER

    return {"stages": GLOBAL_TRACKER.report(), "counters": dict(GLOBAL_TRACKER.counters)}


def _delta(before: dict, after: dict) -> dict:
    stages = {}
    for name, s in after["stages"].items():
        b = before["stages"].get(name, {"calls": 0, "total_s": 0.0, "audio_s": 0.0})
        stages[name] = {k: s[k] - b[k] for k in ("calls", "total_s", "audio_s")}
    counters = {k: v - before["counters"].get(k, 0.0) for k, v in after["counters"].items()}
    return {"stages": stages, "counters": counters}


def _device_info(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_reserved())}


def run(cell: str, seed: int, seconds: float, trace_on: bool, *, t_start: float, device: str = "cuda",
        bench_dir: str = spec.BENCH_DIR, workload: Optional[dict] = None, config: Optional[dict] = None,
        control: int = 0, log=print):
    """One run: (the result line's object, the JAX-side modules loaded).
    ``workload``/``config`` override the files (tests). With ``control`` 1
    the fp8 control is judged in the program's place (``check.compare``),
    with 2 the bfloat16 aligner control (``check.compare_alignment``), and
    ``correct`` must come out false."""
    import torch

    from reference.params import make_weights

    seed = int(seed) % 2**63  # numpy's seeds are unsigned: the same seed, the same inputs
    bench = spec.benchmark(bench_dir)
    w = workload or spec.workload(cell, bench_dir)
    cfg = config or spec.config(w["config"], bench_dir)
    drive = spec.traffic(w["traffic"], bench_dir)
    dev = torch.device(device)
    ctx = Ctx(cell, w, cfg, seed, seconds, trace_on, dev)
    with tempfile.TemporaryDirectory() as tmp, vocab.installed(tmp, vocab.alphabet(cfg)) as vocab_path:
        weights = make_weights(cfg, seed, dev)
        ctx.pipeline = program.build(cfg, w, weights, dev, vocab_path)
        if "align" in cfg:
            ctx.aligner = program.aligner(cfg, seed, dev, tmp)
        ctx.pool = audio.pool(w["params"]["pool_s"], seed, dev)
        drive.warm(ctx)
        if trace_on:  # the process's first profiled block starts the tracer, in seconds
            with trace.Slice(True):
                pass
        if dev.type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        t0, before = time.perf_counter(), _tracker_snapshot()
        e2e = drive.window(ctx)
        if ctx.counters_end is None:
            ctx.tracker, ctx.counters_s = _delta(before, _tracker_snapshot()), ctx.window_s
        else:
            ctx.tracker = _delta(before, ctx.counters_end["tracker"])
            ctx.counters_s = ctx.counters_end["t"] - t0
        device_info = _device_info(dev)
        e2e["setup_s"] = setup_s
        e2e["peak_mem_gib"] = device_info["memory_peak_bytes"] / 2**30
        ctx.trace_summary = ctx.traced.finish() if ctx.traced is not None else None
        if trace_on and dev.type == "cuda" and not (ctx.trace_summary or {}).get("busy_s", 0.0) > 0:
            got = ctx.trace_summary or {}
            raise RuntimeError(f"the profiled slice holds no device work: busy {got.get('busy_s')} s "
                               f"of {got.get('window_s')} s")
        steps = ctx.tracker["counters"].get("decode_steps", 0.0)
        calls = ctx.tracker["stages"].get("decode", {}).get("calls", 0)
        log(f"decode steps per batch: {steps / calls if calls else 0:.2f} over {calls} batches; "
            f"requests {len(ctx.requests)}; window "
            + ", ".join(f"{k} {v:.4f}" for k, v in e2e.items() if v is not None)
            + (f"; generator lateness max {ctx.lateness_s:.4f} s" if ctx.lateness_s is not None else ""))
        metrics: Dict[str, dict] = {}
        if trace_on:
            for m in spec.per_layer(bench, cell):
                value = spec.metric_reader(m["name"], bench_dir).read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            for m in spec.end_to_end(bench, cell):
                if e2e.get(m["name"]) is not None:
                    metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
        requests, pool = ctx.requests, ctx.pool
        ctx.pipeline = ctx.aligner = None
        ctx.__dict__.pop("batcher", None)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        failed = sum(1 for r in requests if r.get("error") or "done" not in r)
        chk = w["check"]
        sampled = check.sample(requests, seed, chk["requests"], chk["audio_s"])

        def audio_of(r):
            return pool[r["offset"]:r["offset"] + r["n"]]

        numbers = check.compare(sampled, audio_of, cfg, seed, dev, int(w["params"]["sample_len"]),
                                control=control == 1)
        if "align" in cfg:
            numbers.update(check.compare_alignment(sampled, audio_of, cfg, seed, dev, control=control == 2))
    numbers["failed"] = float(failed)
    jax_like = program.loaded_top_level()
    limits = dict(w["limits"])
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    compared = numbers["tokens"] > 0 and numbers.get("align_chars", 1.0) > 0
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and compared
    out = {"correct": bool(correct), "attempted": len(requests), "failed": failed, "metrics": metrics,
           "device": device_info}
    if trace_on and ctx.trace_summary is not None:
        s = ctx.trace_summary
        out["device"].update(busy_s=s["busy_s"], window_s=s["window_s"])
        out["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
    out["extra"] = {k: v for k, v in numbers.items() if k not in checks}
    out["checks"] = checks  # last: the numbers compared, each beside its limit
    return out, jax_like

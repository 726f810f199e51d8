#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``whisperx_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which passes or raises (the script then exits non-zero):

  1. card: the device name and ``nvidia-smi``'s name and power limit;
  2. build: the CUDA kernel of the main path, from the source in this
     checkout;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes the main path gives it, with stated tolerances; times of the
     kernel, the plain version and one PyTorch library call (the yardstick,
     never used by the port), and the bound for the same work;
  4. main path: ``whisperx_tpu_torch.load_model("large-v3", ...)`` at full
     width with random weights, ``.transcribe`` of ~120 s of synthetic
     speech; the kernel launch counts are reset just before and read just
     after, and every kernel of the path must have launched;
  5. decode profile: the main path's model decodes one batch of 8 chunks
     greedily for 48 steps, timed on the host clock over 5 runs, then once
     under ``torch.profiler`` (device busy share, kernels by device time);
  6. small model: f32 ``test-nano`` through the same pipeline on CUDA and on
     the CPU with the same weights; segments and greedy tokens must match.

The second-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA GPU, or without the
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet), for the bound columns
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float32": 67e12}

MAIN_AUDIO_S = 120.0
PROFILE_BATCH, PROFILE_STEPS, PROFILE_RUNS = 8, 48, 5


def synth_speech(duration_s: float, sr: int = 16000, seed: int = 0):
    """Synthetic speech-like audio: AM-modulated harmonics + silence gaps
    (the same generator as the test suite's)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(duration_s * sr)) / sr
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.5 * t)
    sig = sum(
        (0.5 / k) * np.sin(2 * np.pi * k * np.cumsum(f0) / sr) for k in range(1, 6)
    )
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.1 * t))
    gaps = (np.sin(2 * np.pi * 0.21 * t) > -0.6).astype(np.float64)
    out = sig * env * gaps + 0.005 * rng.standard_normal(len(t))
    return (0.3 * out / np.abs(out).max()).astype(np.float32)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_card() -> str:
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    print(smi)  # name, power limit: as nvidia-smi prints them
    return name


def phase_build() -> None:
    from whisperx_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load("flash_attention")
    print(f"[build] flash_attention.cu in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log("flash_attention").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] flash_attention: {line.strip()}")


def attention_case(bh, t, d, dtype, seed=0):
    """Seeded q/k/v [bh, t, d]. q is scaled by 3 so the softmax is peaked
    (a flat one would average v to ~0) and v by 1/4 so the outputs are of
    magnitude ≲ 1, where one bf16 ulp is ≤ 3.9e-3: the 1e-2 tolerance then
    allows about two ulps of rounding-order difference."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (
        torch.randn((bh, t, d), generator=g, device="cuda", dtype=torch.float32)
        for _ in range(3)
    )
    return (q * 3.0).to(dtype), k.to(dtype), (v * 0.25).to(dtype)


def phase_kernels() -> dict:
    """K1 against its plain version at the main-path shape (large-v3, batch
    8: [160, 1500, 64] bf16) and the variants the kernel takes."""
    import torch
    import torch.nn.functional as F

    from whisperx_tpu_torch.ops.flash_attention import (
        _attention_reference,
        wholek_attention,
    )

    cases = [
        # (label, bh, t, d, dtype, skip_max, tol)
        ("main bf16", 160, 1500, 64, torch.bfloat16, False, 1e-2),
        ("skip_max bf16", 160, 1500, 64, torch.bfloat16, True, 1e-2),
        ("ragged T=1000 bf16", 40, 1000, 64, torch.bfloat16, False, 1e-2),
        ("f32", 40, 1500, 64, torch.float32, False, 1e-4),
        ("D=32 bf16", 16, 1500, 32, torch.bfloat16, False, 1e-2),
        ("D=32 f32", 16, 1500, 32, torch.float32, False, 1e-4),
    ]
    main = None
    for label, bh, t, d, dtype, skip_max, tol in cases:
        q, k, v = attention_case(bh, t, d, dtype)
        out = wholek_attention(q, k, v, skip_max=skip_max)
        torch.cuda.synchronize()
        ref = _attention_reference(q, k, v, skip_max=skip_max)
        err = (out.float() - ref.float()).abs().max().item()
        mag = ref.float().abs().max().item()
        ok = math.isfinite(err) and err <= tol and out.shape == q.shape
        print(
            f"[kernels] K1 {label}: [{bh},{t},{d}] max_abs_err {err:.3e} "
            f"(tol {tol:g}, |ref| max {mag:.3f}) {'ok' if ok else 'FAIL'}"
        )
        if not ok:
            raise AssertionError(f"K1 {label}: max_abs_err {err} > {tol}")
        if main is None:
            ms = cuda_ms(lambda: wholek_attention(q, k, v))
            plain_ms = cuda_ms(lambda: _attention_reference(q, k, v), iters=5)
            # [1, BH, T, D]: 4-D so PyTorch can pick its flash backend
            library_ms = cuda_ms(
                lambda: F.scaled_dot_product_attention(q[None], k[None], v[None])
            )
            esize = q.element_size()
            bytes_ms = 4 * bh * t * d * esize / PEAK_BYTES_PER_S * 1e3
            ops_ms = 4 * bh * t * t * d / PEAK_OPS_PER_S[str(dtype)] * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            main = {
                "name": "K1 wholek_attention",
                "route": "cuda",
                "source": "whisperx_tpu_torch/ops/csrc/flash_attention.cu",
                "replaces": "whisperx_tpu/ops/flash_attention.py:125",
                "launches": None,
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "library_ms": library_ms,
            }
            print(
                f"[kernels] K1 main timing: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"(ops {ops_ms:.4f}, bytes {bytes_ms:.4f})"
            )
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    return main


def phase_main_path(k1: dict):
    """large-v3 at full width, batch 8, through the user's entry points;
    returns the model for the decode profile."""
    import torch

    import whisperx_tpu_torch
    from whisperx_tpu_torch.asr import DEFAULT_ASR_OPTIONS
    from whisperx_tpu_torch.ops.flash_attention import flash_attention
    from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER

    t0 = time.perf_counter()
    pipe = whisperx_tpu_torch.load_model(
        "large-v3", vad_method="energy", batch_size=8, compute_type="bfloat16"
    )
    torch.cuda.synchronize()
    print(f"[main] load_model large-v3 (random weights) {time.perf_counter() - t0:.2f} s")
    params = list(pipe.model.parameters())
    assert all(p.is_cuda and p.dtype == torch.bfloat16 for p in params)
    print(f"[main] {sum(p.numel() for p in params)} parameters on cuda in bfloat16")

    audio = synth_speech(MAIN_AUDIO_S, seed=1)
    temps = DEFAULT_ASR_OPTIONS["temperatures"]
    print(f"[main] temperatures {temps} (the defaults)")

    GLOBAL_TRACKER.reset()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    result = pipe.transcribe(audio, language="en")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention.launches

    report = GLOBAL_TRACKER.report()
    counters = dict(GLOBAL_TRACKER.counters)
    encoder_passes = report["decode"]["calls"]
    n_layer = pipe.model.dims.n_audio_layer
    assert launches == n_layer * encoder_passes > 0, (launches, encoder_passes)
    k1["launches"] = launches
    assert set(result) == {"segments", "language"} and result["language"] == "en"
    for seg in result["segments"]:
        assert 0.0 <= seg["start"] < seg["end"] <= MAIN_AUDIO_S + 1e-6, seg
        assert isinstance(seg["text"], str)
    for stage, s in report.items():
        print(
            f"[main] stage {stage}: calls {s['calls']} total {s['total_s']:.4f} s "
            f"min {s['min_s']:.4f} s max {s['max_s']:.4f} s"
        )
    print(
        f"[main] {MAIN_AUDIO_S:.0f} s audio in {wall:.3f} s: RTF {MAIN_AUDIO_S / wall:.2f}x; "
        f"{len(result['segments'])} segments; encoder passes {encoder_passes}; "
        f"K1 launches {launches} (= {n_layer} x {encoder_passes}); "
        f"decode steps {int(counters.get('decode_steps', 0))}; "
        f"batch fill {counters.get('batch_used', 0):.0f}/{counters.get('batch_slots', 0):.0f}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )
    return pipe.model


def phase_decode_profile(model) -> None:
    """Where one batched decode spends its time: PROFILE_BATCH 30 s mels of
    the pipeline's warm-up signal, decoded greedily for PROFILE_STEPS tokens
    (encoder and prefill included) with the main path's options."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from whisperx_tpu_torch.asr import warmup_audio
    from whisperx_tpu_torch.audio import log_mel_batch
    from whisperx_tpu_torch.decoding import DecodingOptions
    from whisperx_tpu_torch.decoding.decode import decode_dispatch

    audio = np.stack([warmup_audio(30.0)] * PROFILE_BATCH)
    mels = log_mel_batch(audio, model.dims.n_mels, device="cuda")
    opts = DecodingOptions(language="en", sample_len=PROFILE_STEPS, kv_quant=True)

    def run():
        h = decode_dispatch(model, mels, opts)
        torch.cuda.synchronize()
        return h["steps"]

    run()  # warm-up: allocator, cuBLAS handles
    per_step_ms = []
    for _ in range(PROFILE_RUNS):
        t0 = time.perf_counter()
        steps = run()
        per_step_ms.append((time.perf_counter() - t0) / steps * 1e3)
    q1, med, q3 = np.percentile(per_step_ms, [25, 50, 75])
    print(
        f"[profile] batch {PROFILE_BATCH}, {steps} steps, {PROFILE_RUNS} runs: "
        f"ms per step (wall, encoder and prefill included) "
        f"{' '.join(f'{x:.3f}' for x in per_step_ms)}; median {med:.3f}, "
        f"quartiles {q1:.3f} / {q3:.3f}"
    )
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_s = sum(e.self_device_time_total for e in events) / 1e6
    print(
        f"[profile] one decode under the profiler: wall {wall:.4f} s, CUDA "
        f"kernels {device_s:.4f} s, device busy {device_s / wall:.1%}"
    )
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(
            f"[profile] {e.self_device_time_total / 1e3:10.3f} ms "
            f"{e.count:7d} calls  {e.key[:90]}"
        )


def phase_small_model() -> None:
    """f32 test-nano on CUDA and on the CPU with the same weights: the
    pipeline's segments and each chunk's greedy tokens must be identical."""
    import torch

    import whisperx_tpu_torch
    from whisperx_tpu_torch.audio.device_chunk import chunk_mels, upload_audio
    from whisperx_tpu_torch.convert.checkpoint import params_from_numpy
    from whisperx_tpu_torch.decoding import DecodingOptions
    from whisperx_tpu_torch.decoding.decode import decode

    pipes = {
        dev: whisperx_tpu_torch.load_model(
            "test-nano", device=dev, vad_method="energy", compute_type="float32"
        )
        for dev in ("cpu", "cuda")
    }
    # the CUDA model takes the CPU model's weights, through the bridge
    flat = {
        k.replace(".", "/"): t.cpu().numpy()
        for k, t in pipes["cpu"].model.state_dict().items()
    }
    pipes["cuda"].model = params_from_numpy(
        flat, pipes["cpu"].model.dims, torch.float32, "cuda"
    )
    audio = synth_speech(35.0, seed=0)
    results = {
        dev: p.transcribe(audio, language="en", temperatures=(0.0,))
        for dev, p in pipes.items()
    }
    assert results["cpu"] == results["cuda"], results
    chunks = pipes["cpu"]._segment_with_vad(upload_audio(audio, "cpu"), 30)
    mels = chunk_mels(upload_audio(audio, "cpu"), chunks, 80)
    opts = DecodingOptions(language="en", kv_quant=True)
    toks = {
        dev: [r.tokens for r in decode(p.model, mels.to(dev), opts)]
        for dev, p in pipes.items()
    }
    assert toks["cpu"] == toks["cuda"], toks
    print(
        f"[small] test-nano f32: {len(results['cuda']['segments'])} identical segments; "
        f"{len(chunks)} chunks with identical greedy tokens "
        f"({sum(len(t) for t in toks['cuda'])} tokens) on cuda and cpu"
    )


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "whisperx_tpu_torch")):
        print("chip_smoke: whisperx_tpu_torch/ not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    name = phase_card()
    phase_build()
    k1 = phase_kernels()
    model = phase_main_path(k1)
    phase_decode_profile(model)
    del model
    torch.cuda.empty_cache()
    phase_small_model()
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1]}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

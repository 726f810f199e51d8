#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``whisperx_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which passes or raises (the script then exits non-zero):

  1. card: the device name and ``nvidia-smi``'s name and power limit;
  2. build: the CUDA kernels of the main paths, from the sources in this
     checkout, one nvcc per source, all started together;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes the main paths give it, with stated tolerances; times of the
     kernel, the plain version and one PyTorch library call (the yardstick,
     never used by the port), and the bound for the same work;
  4. main path: ``whisperx_tpu_torch.load_model("large-v3", ...)`` at full
     width with random weights, ``.transcribe`` of ~120 s of synthetic
     speech; the kernel launch counts are reset just before and read just
     after, and every kernel of the path must have launched;
  5. decode profile: the main path's model decodes one batch of 8 chunks
     greedily for 48 steps, timed on the host clock over 5 runs, then once
     under ``torch.profiler`` (device busy share, kernels by device time);
  6. CLI path: ``python -m whisperx_tpu_torch clip.wav --model large-v3
     --compute_type int8 --vad_method energy --language en --no_align -f all``
     (beam 5, the CLI default, at one temperature), driven in-process through
     ``build_parser`` and ``transcribe_task`` so that the launch counts can be
     read: every int8 decoder linear must have gone through K4; then the
     decode profile of phase 5 for that int8 model with 5 beams;
  7. small model: f32 ``test-nano`` through the same pipeline on CUDA and on
     the CPU with the same weights; segments and greedy tokens must match;
     then quantized to int8, its greedy and beam-2 tokens must match too.

The second-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA GPU, or without the
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet), for the bound columns
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float32": 67e12}

L2_BYTES = 50 * 2**20
KERNEL_SOURCES = ("flash_attention", "quant_matmul")

MAIN_AUDIO_S = 120.0
PROFILE_BATCH, PROFILE_STEPS, PROFILE_RUNS = 8, 48, 5
CLI_AUDIO_S = 60.0


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
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(_build.load, KERNEL_SOURCES))
    print(f"[build] {', '.join(f'{n}.cu' for n in KERNEL_SOURCES)} in {time.perf_counter() - t0:.2f} s")
    for name in KERNEL_SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


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


def quant_case(m, k, n, dtype, group_size=64, seed=0):
    """Seeded x ~ N(0, 1) [m, k] in ``dtype`` and w ~ N(0, 1)/√k [k, n],
    quantized to int8 by the port's ``quantize_weight``."""
    import torch

    from whisperx_tpu_torch.quant import quantize_weight

    g = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=g)
    w = torch.randn((k, n), generator=g) / math.sqrt(k)
    q = quantize_weight(w.numpy(), "int8", group_size)
    return x.to(dtype).cuda(), q["qw"].cuda(), q["scale"].cuda()


def phase_k4() -> dict:
    """K4 against its plain version at the shapes of the int8 CLI path
    (large-v3, group 64): decode steps at 8 rows (greedy) and 40 (beam 5,
    batch 8) for the (1280, 5120) and (5120, 1280) weights, the cross-KV
    projection at 12000 rows (batch 8 × 1500 frames), a ragged 13-row case,
    and f32 (test-sized models run K4 in f32); untimed, groups 32 and 16 (a
    checkpoint quantized with another group size) at an N that is not a
    multiple of 16, which take the kernel's other K chunks and its scalar
    weight loads. Timed with enough copies of
    the weights cycled to overflow the 50 MB L2, as the decode step (240
    different weights) finds them cold."""
    import torch

    from whisperx_tpu_torch.ops.quant_matmul import _quant_matmul_reference, int8_matmul
    from whisperx_tpu_torch.quant import QuantizedLinear, dequantize

    # bf16: one bf16 ulp of the output at its largest magnitude, 2⁻⁷·max|ref|
    # (both sum exact products in f32, in different orders, and round once);
    # f32: 1e-4·max|ref| (order of the f32 sums only)
    tol = {torch.bfloat16: 2.0**-7, torch.float32: 1e-4}
    cases = [
        # (label, m, k, n, dtype, group, timed)
        ("decode beam 5, mlp1", 40, 1280, 5120, torch.bfloat16, 64, True),
        ("decode greedy, mlp1", 8, 1280, 5120, torch.bfloat16, 64, False),
        ("decode beam 5, mlp2", 40, 5120, 1280, torch.bfloat16, 64, False),
        ("cross-KV batch 8", 12000, 1280, 1280, torch.bfloat16, 64, True),
        ("ragged", 13, 1280, 1280, torch.bfloat16, 64, False),
        ("f32", 40, 1280, 5120, torch.float32, 64, False),
        ("group 32, ragged N", 13, 256, 100, torch.bfloat16, 32, False),
        ("group 16, ragged N", 13, 256, 100, torch.bfloat16, 16, False),
        ("group 32", 40, 256, 128, torch.bfloat16, 32, False),
        ("f32 group 32, ragged N", 13, 256, 100, torch.float32, 32, False),
    ]
    main = None
    for label, m, k, n, dtype, group, timed in cases:
        x, qw, scale = quant_case(m, k, n, dtype, group)
        out = int8_matmul(x, qw, scale, group)
        torch.cuda.synchronize()
        ref = _quant_matmul_reference(x, qw, scale, group)
        err = (out.float() - ref.float()).abs().max().item()
        mag = ref.float().abs().max().item()
        limit = tol[dtype] * mag
        ok = math.isfinite(err) and err <= limit and out.shape == (m, n) and out.dtype == dtype
        print(
            f"[kernels] K4 {label}: M={m} K={k} N={n} group {group} {str(dtype)[6:]} max_abs_err "
            f"{err:.3e} (tol {limit:.3e} = {tol[dtype]:g}·max|ref| {mag:.3f}) "
            f"{'ok' if ok else 'FAIL'}"
        )
        if not ok:
            raise AssertionError(f"K4 {label}: max_abs_err {err} > {limit}")
        if timed:
            copies = max(1, math.ceil(2 * L2_BYTES / (qw.numel() + scale.numel() * 4)))
            weights = [(qw.clone(), scale.clone()) for _ in range(copies)]
            cycle = itertools.cycle(weights)
            ms = cuda_ms(lambda: int8_matmul(x, *next(cycle), group))
            plain_ms = cuda_ms(lambda: _quant_matmul_reference(x, *next(cycle), group), iters=5)
            # the yardstick: one bf16 GEMM on a weight dequantized beforehand
            # (no single PyTorch call computes grouped-scale int8 x bf16)
            dense = [
                dequantize(QuantizedLinear(q, sc, bits=8, group_size=group), dtype)
                for q, sc in weights[: max(1, math.ceil(2 * L2_BYTES / (2 * k * n)))]
            ]
            dense_cycle = itertools.cycle(dense)
            library_ms = cuda_ms(lambda: torch.matmul(x, next(dense_cycle)))
            es = x.element_size()
            bytes_ms = (k * n + 4 * (k // group) * n + es * m * k + es * m * n) / PEAK_BYTES_PER_S * 1e3
            ops_ms = 2 * m * n * k / PEAK_OPS_PER_S[str(dtype)] * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
            print(
                f"[kernels] K4 {label} timing ({copies} weight copies cycled): kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bf16 GEMM yardstick "
                f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
                f"(ops {ops_ms:.4f}, bytes {bytes_ms:.4f})"
            )
            if main is None:
                main = {
                    "name": "K4 int8_matmul",
                    "route": "cuda",
                    "source": "whisperx_tpu_torch/ops/csrc/quant_matmul.cu",
                    "replaces": "whisperx_tpu/ops/quant_matmul.py:52",
                    "launches": None,
                    "max_abs_err": err,
                    "ms": ms,
                    "plain_ms": plain_ms,
                    "bound_ms": bound_ms,
                    "bound_by": bound_by,
                    "library_ms": library_ms,
                }
            del weights, dense
        del x, qw, scale, out, ref
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


def phase_decode_profile(model, tag: str = "profile", beam_size=None) -> None:
    """Where one batched decode spends its time: PROFILE_BATCH 30 s mels of
    the pipeline's warm-up signal, decoded for PROFILE_STEPS tokens (encoder
    and prefill included) with the main path's options: greedily, or with
    ``beam_size`` beams (the CLI's default of 5)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from whisperx_tpu_torch.asr import warmup_audio
    from whisperx_tpu_torch.audio import log_mel_batch
    from whisperx_tpu_torch.decoding import DecodingOptions
    from whisperx_tpu_torch.decoding.decode import decode_dispatch

    audio = np.stack([warmup_audio(30.0)] * PROFILE_BATCH)
    mels = log_mel_batch(audio, model.dims.n_mels, device="cuda")
    opts = DecodingOptions(
        language="en", sample_len=PROFILE_STEPS, kv_quant=True, beam_size=beam_size
    )

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
        f"[{tag}] batch {PROFILE_BATCH}, beam {beam_size or 1}, {steps} steps, {PROFILE_RUNS} runs: "
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
        f"[{tag}] one decode under the profiler: wall {wall:.4f} s, CUDA "
        f"kernels {device_s:.4f} s, device busy {device_s / wall:.1%}"
    )
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(
            f"[{tag}] {e.self_device_time_total / 1e3:10.3f} ms "
            f"{e.count:7d} calls  {e.key[:90]}"
        )


def phase_cli(k4: dict):
    """The int8 CLI at full large-v3 width with random weights, through the
    port's own parser and orchestrator. The K4 count the code implies: per
    decode call, 2 launches per quantized block in ``precompute_cross_kv``
    (cross key, value) and 8 per quantized block in every
    ``decoder_forward`` (self q/k/v/out, cross q/out, mlp1, mlp2), which
    runs once for the prefill and once per step."""
    import torch

    from whisperx_tpu_torch import quant
    from whisperx_tpu_torch.__main__ import build_parser
    from whisperx_tpu_torch.audio import save_wav
    from whisperx_tpu_torch.ops.flash_attention import flash_attention
    from whisperx_tpu_torch.ops.quant_matmul import quant_matmul
    from whisperx_tpu_torch.quant import QuantizedLinear
    from whisperx_tpu_torch.transcribe import transcribe_task
    from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER

    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "clip.wav")
        save_wav(wav, synth_speech(CLI_AUDIO_S, seed=2))
        out_dir = os.path.join(tmp, "out")
        argv = [
            wav, "--model", "large-v3", "--compute_type", "int8",
            "--vad_method", "energy", "--language", "en", "--no_align", "-f", "all",
            "--batch_size", "8", "--temperature_increment_on_fallback", "None",
            "-o", out_dir,
        ]
        print(f"[cli] python -m whisperx_tpu_torch {' '.join(argv[1:])}")
        parser = build_parser()
        args = parser.parse_args(argv).__dict__
        GLOBAL_TRACKER.reset()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        quant_matmul.launches = 0
        # the host quantization of the decoder, timed around the call that
        # load_model makes
        real_quantize, quantize_s = quant.quantize_model, []

        def timed_quantize(*a, **kw):
            t = time.perf_counter()
            out = real_quantize(*a, **kw)
            torch.cuda.synchronize()
            quantize_s.append(time.perf_counter() - t)
            return out

        quant.quantize_model = timed_quantize
        t0 = time.perf_counter()
        try:
            pipe = transcribe_task(args, parser)
            torch.cuda.synchronize()
        finally:
            quant.quantize_model = real_quantize
        wall = time.perf_counter() - t0
        assert len(quantize_s) == 1, quantize_s
        k4_launches, k1_launches = quant_matmul.launches, flash_attention.launches

        model = pipe.model
        quantized = {
            name: mod for name, mod in model.named_modules() if isinstance(mod, QuantizedLinear)
        }
        assert all(p.is_cuda and p.dtype == torch.bfloat16 for p in model.parameters())
        assert all(m.qw.is_cuda and m.qw.dtype == torch.int8 and m.bits == 8 for m in quantized.values())
        q_blocks = {name.split(".")[2] for name in quantized}
        n_layer = model.dims.n_text_layer
        assert len(quantized) == 10 * len(q_blocks) and len(q_blocks) == n_layer - 2, q_blocks
        assert str(n_layer - 1) not in q_blocks and "0" not in q_blocks

        report = GLOBAL_TRACKER.report()
        counters = dict(GLOBAL_TRACKER.counters)
        n_dec = report["decode"]["calls"]
        steps = int(counters["decode_steps"])
        expected = len(q_blocks) * (2 * n_dec + 8 * (n_dec + steps))
        assert k4_launches == expected > 0, (k4_launches, expected, n_dec, steps)
        assert k1_launches == model.dims.n_audio_layer * n_dec > 0, (k1_launches, n_dec)
        k4["launches"] = k4_launches

        for ext in ("txt", "srt", "vtt", "tsv", "json"):
            assert os.path.getsize(os.path.join(out_dir, f"clip.{ext}")) >= 0
        with open(os.path.join(out_dir, "clip.json")) as f:
            result = json.load(f)
        assert result["language"] == "en" and isinstance(result["segments"], list)
        for seg in result["segments"]:
            assert 0.0 <= seg["start"] < seg["end"] <= CLI_AUDIO_S + 1e-6, seg
    for stage, st in report.items():
        print(
            f"[cli] stage {stage}: calls {st['calls']} total {st['total_s']:.4f} s "
            f"min {st['min_s']:.4f} s max {st['max_s']:.4f} s"
        )
    busy = sum(st["total_s"] for st in report.values())
    print(
        f"[cli] {CLI_AUDIO_S:.0f} s audio: transcription {busy:.3f} s, RTF "
        f"{CLI_AUDIO_S / busy:.2f}x; whole CLI (load, host quantization "
        f"{quantize_s[0]:.2f} s, transcription, writers) {wall:.3f} s; "
        f"{len(result['segments'])} segments; {n_dec} decodes, {steps} decode steps "
        f"(beam 5, {counters.get('batch_used', 0):.0f}/{counters.get('batch_slots', 0):.0f} "
        f"batch slots); K4 launches {k4_launches} (= {len(q_blocks)} x (2 x {n_dec} + "
        f"8 x ({n_dec} + {steps}))); K1 launches {k1_launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )

    # the beam step's self-KV reorder at this run's shape: every layer's
    # cache [B·K, cache_len, H, Dh] gathered by source beam, once per step
    rows, dims = 8 * 5, model.dims
    shape = (rows, 256, dims.n_text_head, dims.n_text_state // dims.n_text_head)
    caches = [torch.zeros(shape, dtype=torch.bfloat16, device="cuda") for _ in range(2 * n_layer)]
    idx = torch.randint(0, rows, (rows,), device="cuda")
    reorder_ms = cuda_ms(lambda: [c.index_select(0, idx) for c in caches], iters=5, warmup=1)
    gb = sum(c.numel() * c.element_size() for c in caches) / 1e9
    print(
        f"[cli] self-KV reorder per beam step: {gb:.3f} GB read and written "
        f"({2 * n_layer} x {list(shape)} bf16) in {reorder_ms:.3f} ms"
    )
    # K3 (not ported yet) would read one layer's int8 cross K and V per
    # step: 2·B·T·H·Dh bytes at batch 8 (the beams share the untiled K/V)
    k3_bytes = 2 * 8 * 1500 * dims.n_text_state
    print(
        f"[cli] K3's bound at this decode step: {k3_bytes / 1e6:.2f} MB of int8 "
        f"K/V per layer, {k3_bytes / PEAK_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s"
    )
    del caches, pipe
    torch.cuda.empty_cache()
    return model


def phase_small_model() -> None:
    """f32 test-nano on CUDA and on the CPU with the same weights: the
    pipeline's segments and each chunk's greedy tokens must be identical;
    then the same model quantized to int8: greedy and beam-2 tokens too."""
    import torch

    import whisperx_tpu_torch
    from whisperx_tpu_torch.audio.device_chunk import chunk_mels, upload_audio
    from whisperx_tpu_torch.convert.checkpoint import flatten_tree, params_from_numpy
    from whisperx_tpu_torch.decoding import DecodingOptions
    from whisperx_tpu_torch.decoding.decode import decode
    from whisperx_tpu_torch.ops.quant_matmul import quant_matmul
    from whisperx_tpu_torch.quant import QuantizedLinear, quantize_model

    pipes = {
        dev: whisperx_tpu_torch.load_model(
            "test-nano", device=dev, vad_method="energy", compute_type="float32"
        )
        for dev in ("cpu", "cuda")
    }
    # the CUDA model takes the CPU model's weights, through the bridge
    pipes["cuda"].model = params_from_numpy(
        flatten_tree(pipes["cpu"].model), pipes["cpu"].model.dims, torch.float32, "cuda"
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

    # int8: every decoder linear at depth 2 quantized on the CPU, the same
    # codes bridged to cuda, where they run K4's f32 kernel
    cpu_q = quantize_model(pipes["cpu"].model, mode="int8")
    models = {"cpu": cpu_q, "cuda": params_from_numpy(flatten_tree(cpu_q), cpu_q.dims, torch.float32, "cuda")}
    assert sum(isinstance(m, QuantizedLinear) for m in models["cuda"].modules()) == 20
    quant_matmul.launches = 0
    for label, opts in (
        ("greedy", DecodingOptions(language="en", kv_quant=True)),
        ("beam 2", DecodingOptions(language="en", kv_quant=True, beam_size=2)),
    ):
        toks = {dev: [r.tokens for r in decode(m, mels.to(dev), opts)] for dev, m in models.items()}
        assert toks["cpu"] == toks["cuda"], (label, toks)
        print(
            f"[small] test-nano int8 {label}: {len(chunks)} chunks with identical tokens "
            f"({sum(len(t) for t in toks['cuda'])} tokens) on cuda and cpu"
        )
    assert quant_matmul.launches > 0
    print(f"[small] K4 (f32) launched {quant_matmul.launches} times on cuda")


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
    k4 = phase_k4()
    model = phase_main_path(k1)
    phase_decode_profile(model)
    del model
    torch.cuda.empty_cache()
    model = phase_cli(k4)
    phase_decode_profile(model, "profile int8", beam_size=5)
    del model
    torch.cuda.empty_cache()
    phase_small_model()
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k4]}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

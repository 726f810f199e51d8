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
     never used by the port), and the bound for the same work: K1, K1b and
     K2 (``flash_attention.cu``), K4 (``quant_matmul.cu``, at every shape
     of the int8 CLI path), K3, K3kt and K3i8
     (``cross_attention_decode.cu``, at the decode step of batch 16, the
     benchmark's, of batch 8 and of batch 1, all timed, and at three other
     shapes), then the decoder's default route at batch 16 (a bf16 query
     over the int8 cache: K3): its op against the plain version, with the
     f32-query control outside, and the route against the widened einsum,
     both timed; every case of every
     kernel is called twice and must give the same bits; K1's f32 route
     (error-compensated TF32 on the tensor cores) is timed at
     [160, 1500, 64] against its floor (3 x its f32 work at the TF32 rate)
     and the CUDA cores' f32 bound, and its error against f64 at
     [40, 1500, 64] (and K2 causal f32 at D 32) must stay within
     F32_WITNESS_FACTOR x the plain f32 version's, with plain TF32 as a
     control that must fall outside;
  4. main path: ``whisperx_tpu_torch.load_model("large-v3", ...)`` at full
     width with random weights, ``.transcribe`` of ~120 s of synthetic
     speech; the kernel launch counts are reset just before and read just
     after, and every kernel of the path must have launched; every decode
     step after a prefill replays a captured CUDA graph (``[graph]`` lines:
     captures, replays, cache entries, static bytes);
  5. decode profile: the main path's model decodes one batch of 8 chunks
     greedily for 48 steps, each step a replay of its captured graph and,
     in turns, uncaptured (the yardstick), timed on the host clock over 3
     runs each, then once each for 24 steps under ``torch.profiler``
     (device busy share, kernels by device time); the two must give the
     same bits and launch counts, and the profiled kernels must be found
     inside the replays; the bf16 greedy steps take K3 by default, which
     must launch once per decoder layer per sampled step, and one step's
     logits must agree with the einsum route's (``einsum_route``);
  5d. eviction gate (after 5's greedy profile, on its model): a bf16
     greedy and a beam-5 decode of the profile's batch captured; the
     cache of ``filters._id_mask`` cleared where it has one, the garbage
     collected, and [V] bool tensors of True allocated on the current and
     the capture stream until the small pool's free bytes are spent; both
     decodes again, every step a replay, must give the uncaptured decode's
     bits: a replay reads nothing its entry does not own;
  5b. ``transcribe_many`` of three requests through the main path's
     pipeline: one result per request, segments inside
     their own audio, K3 launched n_text_layer × the sampled steps, K1
     32 × the encoder passes;
  4b. word timing: the main path's pipeline with ``word_timestamps=True``
     (greedy) over the same 120 s: the ``word_timing`` stage, peak memory,
     and K1 launched 32 × the decodes + 32 × the teacher-forced captures;
  4c. alignment: wav2vec2 BASE_CONFIG (12 layers, d 768) with weights from a
     seeded ``torch.Generator``, written with the port's ``save_checkpoint``
     into a temporary ``WHISPERX_TPU_ALIGN_DIR`` and loaded through
     ``load_align_model``, aligns the main path's segments over its audio:
     emission time per bucket (CUDA events), trellis and backtrack host
     time, the stage's wall time, words inside their segments with
     monotone starts; CUDA against CPU emissions on one segment (TF32 off,
     as the aligner always runs; tolerance EMISSION_TOL) and the same words
     once both are given the CPU emissions;
  5c. sequential path: ``load_model("large-v3", vad_method="none")``, the
     seek loop over ~40 s; K1 launched 32 × the window decodes; then the
     seek loop with ``word_timestamps=True`` and
     ``hallucination_silence_threshold=2.0`` (greedy, SEQ_WORDS_SAMPLE_LEN
     tokens a window): K1 32 × (decodes + captures);
  6. CLI path: ``python -m whisperx_tpu_torch clip.wav --model large-v3
     --compute_type int8 --vad_method energy --language en -f all
     --highlight_words True`` (beam 5, the CLI default, at one temperature;
     alignment on, with phase 4c's checkpoint), driven in-process through
     ``build_parser`` and ``transcribe_task`` so that the launch counts can be
     read: every int8 decoder linear must have gone through K4, as often
     per shape as the code implies; K4's device time per CLI run (Σ
     launches × ms per shape) against its floor (Σ launches × bound); then
     the decode profile of phase 5 for that int8 model with 5 beams;
     the six formats: ``-f all``'s five, and ``aud`` from the CLI's JSON;
  6b. CLI int4 (after 8b, the int8 model freed): phase 6's command with
     ``--compute_type int4``, which has no kernel in either package
     (dequantize, then one product): K4 launched 0 times, K1 32 per encoder
     pass; every int4 linear's ``dequantize`` on the card bit-identical to
     the CPU's; phase 5's profile with 5 beams, captured against
     uncaptured (bits and launches equal); ms per step, wall and peak
     memory beside phase 6's int8 figures;
  6c. float32 (after 6b): ``load_model("large-v3",
     compute_type="float32", vad_method="energy", batch_size=8)
     .transcribe`` of 60 s of the main path's speech: every K1 launch on
     its f32 route, 32 per encoder pass, and no K3 launch (an f32 query
     keeps the einsum); phase 5's greedy profile in f32, captured against
     uncaptured, with no K3 launch; wall, ms per step, peak memory;
  8. speculative decoding (after 5b, on the main path's model and 120 s):
     ``transcribe(..., draft_model="self:4", spec_gamma=4)`` at one
     temperature, each iteration a replay of a captured CUDA graph, three
     times in turns: captured, uncaptured (``_eager``, the yardstick),
     captured; the three must give the same bits (tokens, n, sum_logprob,
     proposed, accepted, target passes); then a ``zero_tail_model(model,
     4)`` target (acceptance ≈ 1), and a plain greedy decode with
     ``kv_quant=False``: decode wall time, target passes, proposed,
     accepted, tokens emitted, ms per emitted token and per iteration;
     ``[graph]`` lines (captures, replays, static bytes), the phase's peak
     memory; K1 32 × the decodes (the draft shares the encoder); the share
     of rows equal to greedy's is printed;
  8b. speculative int8 (after 6, on its int8 model and the CLI's 60 s,
     48 tokens a row): ``self:4``, captured, then uncaptured: the same
     bits; K4's launches per shape as the code implies in both (draft steps
     at M 8, verify passes at M 40; a replay adds what its capture
     recorded), Σ launches × ms against the bound;
  11. serving (after 8, on the main path's model, its weights shared; one
     temperature, as ``serve --temperature_increment_on_fallback 0``):
     first two threads decode batches of one shape on the model at once,
     and each must get a lone run's bits (their steps replay captured
     graphs, on cache entries of their own); (a) ``TranscriptionServer(max_batch_size=3, max_wait_ms=500)`` with
     ``start_background(port=0)``, ``/healthz`` 200; (b) three clients POST
     at once over ``urllib``: a 21 s WAV, a 25 s body of raw PCM i16 at
     44.1 kHz, a 29 s multipart upload with ``response_format=verbose_json``
     (seeds 7-9, one (20, 30] s duration bucket): all 200, segments inside
     their audio, 3 requests in 1 batch, K1 32 × the encoder passes; each
     request's wall time, the batch's, ``throughput_rtf``, ``/metrics``
     lines, peak memory; (c) a POST with ``?align=true&diarize=true`` (phase
     4c's aligner): words inside their segments, every segment with a
     speaker; (d) two WebSocket sessions, one after the other, of speech
     in 0.5 s frames at real time, then ``{"op": "end"}``: 8 s with
     ``partial_interval=2`` (a partial before its first final), 20 s with
     ``diarize=true`` (at least 3 finals: the first ends on a pause,
     before the 5 s cap, then the cap and the tail; every segment carries
     a speaker, and a diarization warning fails the phase); finals
     contiguous over each stream; K1 32 × (final + partial decodes); the
     time to the first partial and to each final, the finals' latency p50
     / p95; then ``IncrementalUtteranceDecoder`` (budget 64) over 3, 3 and
     4 s of one utterance: the third replays the committed tokens, K1 32 ×
     3; and ``warmup_streaming`` at a 0 s cap and a budget of 64: 4 calls,
     one of them a chunk decoded with a 32-token prompt, K1 32 × (chunk
     decodes + 2 partials); (e) the precision flags as before the
     phase. Random weights decode every token of the budget (longer than
     the 5 s latency cap), so a session gives at most one partial, and each
     latency is a worst case;
  9. VADs: Silero (2 × LSTM 64) and PyanNet (the default config) with
     seeded random weights written by ``save_checkpoint`` and loaded with
     ``load_vad_model`` by path, over 120 s: device time of each forward
     (CUDA events), CUDA against CPU (Silero's probabilities within 1e-5,
     PyanNet's log-scores within 1e-4, TF32 off), the same segments; and
     ``BatchVADProcessor`` over ``transcribe_many``'s three requests in one
     call;
  10. diarization (after 9): 120 s of two harmonic voices (f0 110 and
     260 Hz) in alternating turns of 3-8 s with pauses, from a fixed seed.
     (a) the weightless default (energy VAD → SpectralEmbedding → AHC) on
     CUDA and on the CPU: wall time, device time of the embedding (CUDA
     events), windows, DER against the known turns; the same turns and
     labels on both, embeddings within 1e-5; (b) the neural path: PyanNet
     at the default config and the ResNet34 at ``ResNetSpeakerConfig()``
     with seeded random weights, written with ``save_checkpoint`` and loaded
     through ``WHISPERX_TPU_SEGMENTATION_CKPT`` and
     ``WHISPERX_TPU_SPEAKER_CKPT``: device time of the segmentation and of
     the embedding, the items (window × local speaker), peak memory; CUDA
     against CPU embeddings within 1e-4 (TF32 off), the same activity and
     turns; (c) ``assign_word_speakers`` over phase 4's transcript with
     (a)'s turns on phase 4's 120 s; (d) the ResNet34 alone on 240 windows
     of 2 s: device time beside its operation count;
  12. conversion (after 10): the port's own converter on sources at the
     published widths, random weights from fixed seeds, no download. An HF
     ``WhisperForConditionalGeneration`` directory of large-v3 (config of
     openai/whisper-large-v3; F16 ``model.safetensors`` written by
     ``write_safetensors``; seeded alignment heads; a synthetic vocabulary
     of 50257 ranked tokens) goes through ``python -m
     whisperx_tpu_torch.convert whisper --quantize int8`` as a subprocess,
     wav2vec2 base (an HF ``Wav2Vec2ForCTC`` directory), PyanNet and the
     ResNet34 (pyannote's and wespeaker's state dicts) beside it. On the
     host: every converted tensor equals its F16 source after the
     converter's transposes, to the bit; the alignment heads and
     ``vocab.tiktoken`` carried. On the card: the checkpoint transcribes 30
     s (24 tokens a row, one temperature) with K1 32 × the encoder passes and
     the converted alignment heads, then again under ``profiler_trace``,
     whose Chrome trace must hold one K1 kernel event per launch; the int8
     copy transcribes with K4's launches per shape as
     ``k4_launches_per_shape`` derives them (greedy), and decoder block 1's
     int8 codes and scales equal ``quantize_weight`` on the CPU of the bf16
     weights; the converted wav2vec2 aligns the segments through
     ``WHISPERX_TPU_ALIGN_DIR``, the converted PyanNet and ResNet34 diarize
     the 30 s through ``WHISPERX_TPU_SEGMENTATION_CKPT`` /
     ``WHISPERX_TPU_SPEAKER_CKPT``; conversion, load and transcription
     times beside the card's name and power limit. Silero's routes need
     ``onnx`` or the network: not run here;
  7. small model: f32 ``test-nano`` through the same pipeline on CUDA and on
     the CPU with the same weights; segments and greedy tokens must match,
     and the seek loop's segments and tokens too, and the words of word
     timing (text, start, end); speculative tokens (``self:1``, γ 2) equal
     the CUDA greedy ones and the CPU's; the pyannote and hybrid VADs give
     the same segments on both; ``WHISPERX_TPU_FLASH=0`` raises on CUDA;
     then quantized to int8, its greedy and beam-2 tokens must match too,
     and ``WHISPERX_TPU_NO_PALLAS_QUANT`` raises on CUDA; the CLI with
     ``--diarize`` (and ``--diarize_clustering spectral``) writes the same
     files on both devices, and ``load_pipeline(..., diarize=True)`` gives
     the same result dict; the f32 test-nano server over the CUDA pipeline
     and over the CPU one gives the same body for a WAV POST and the same
     finals for a long-poll stream, and ``python -m
     whisperx_tpu_torch.serve --model <nano dir> --device cuda`` as a
     subprocess answers ``/healthz`` and one POST, then exits 0 within 10 s
     of SIGTERM.
  13. scale-out (after 11, on the main path's model; one card, whose
     device repeats in every mesh): ``DataParallelPipeline`` over two
     replicas on 60 s at 48 tokens a row, each replica's steps replays of
     a captured graph on a cache entry of its own (replays on at least two
     entries; the wall beside the plain pipeline's; segments equal to the
     plain pipeline's at each replica's batch; K1 32 × 2 per decode); the model
     split ``n_model=2``: bf16 encoder output and first-step logits within
     2x the whole model's own bf16-vs-f32 error, K1 64 per encoder pass; the
     f32 copy's greedy tokens (4 windows, 24 steps, TF32 off) identical to
     the whole f32 model's; test-nano with int8 weights split the same,
     tokens identical, K4 launched; two ``python -m whisperx_tpu_torch``
     processes with torchrun's ``RANK`` / ``WORLD_SIZE`` owning disjoint,
     covering slices of three files.
  14. trainers (last; ``whisperx_tpu_torch/train/``): (a) one step of each
     trainer's loss at test-nano (micro ``loss_active`` / ``loss_full``,
     ctc ``loss_fn``, align ``loss_a`` / ``loss_b``, online
     ``loss_compact``), CUDA against the CPU on copies of the same weights
     and windows, TF32 off: the loss within TRAIN_LOSS_RTOL, each gradient
     within TRAIN_GRAD_RTOL (CTC: TRAIN_CTC_GRAD_RTOL, placed by two
     witnesses: the CTC in f64 within TRAIN_GRAD_RTOL, a TF32 control
     outside the limit) of its largest CPU entry, K1 2 per encoder pass, and ``loss_b``'s encoder gradients
     through K1's gradient rule non-zero and the CPU's; (b)
     ``train_micro()`` on the card to its certificate, whose checkpoint
     transcribes two ``build_files`` recordings exactly through
     ``load_model(path, device="cuda")``; (c) full width: large-v3 f32
     online-trainer steps (8 fresh windows, K1 32 a step), one ``loss_b``
     step at 2 windows (K1 and its gradient rule 32 each), wav2vec2
     BASE_CONFIG CTC steps (16 rows of 4.8 s): ms per step, peak memory,
     K1's share of a profiled step's kernel time; (d) K1 in f32 at
     [160, 1500, 64] beside its gradient rule, SDPA and the bound.

The second-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA GPU, or without the
package beside this file, it exits non-zero and prints no result.

    python3 chip_smoke.py --kernels

runs phases 1-3 only; ``--parallel`` phases 1, 2 and 13, the latter on a
freshly loaded large-v3; ``--spec`` phases 1, 2, 8 and 8b on freshly
loaded bf16 and int8 large-v3 models (8b's K4 times not looked up: phase
3 does not run); ``--train`` phases 1, 2 and 14; ``--decode``
phases 1, 2, the decode profiles of 5 and 6 (captured against uncaptured),
5d's eviction gate and phase 11's two threads, on freshly loaded large-v3
models; ``--precisions`` phases 1, 2, 6 (without phase 3's K4 times),
its int8 profile, 6b and 6c. ``--kernels``: every kernel's checks, determinism and per-shape
times (K1, K1 f32, K1b, K2, K4, K3, K3kt, K3i8), and prints their entries. Copied
into a checkout of another commit, it times that commit's kernels the same
way: run both in one call to compare two versions on one card.
"""

from __future__ import annotations

import importlib
import itertools
import json
import math
import os
import re
import struct
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet), for the bound columns
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
# dense TF32 on the tensor cores: K1's f32 route takes each f32 product as
# three TF32 ones (error-compensated), so its floor is 3x its f32 work here
PEAK_TF32_OPS_PER_S = 494.7e12
# K1's f32 accuracy witness: the kernel's max error against an f64
# evaluation within this factor of the plain f32 version's own; plain TF32
# (10 mantissa bits) must fall outside it, so every run shows it can fail
F32_WITNESS_FACTOR = 8.0

L2_BYTES = 50 * 2**20
KERNEL_SOURCES = ("flash_attention", "quant_matmul", "cross_attention_decode")
CROSS_DECODE_FLAG = "WHISPERX_TPU_CROSS_DECODE"

MAIN_AUDIO_S = 120.0
PROFILE_BATCH, PROFILE_STEPS, PROFILE_RUNS = 8, 48, 3
# the decode under the profiler: its trace's export and parse grow with the
# steps (~23,800 events a step) and took most of each profile phase at 48
PROFILE_TRACE_STEPS = 24
CLI_AUDIO_S = 60.0
F32_AUDIO_S = 60.0  # --compute_type float32 at large-v3: the main path's speech, cut to 60 s
MANY_AUDIO_S = (20.0, 33.0, 47.0)  # transcribe_many's three requests
SEQ_AUDIO_S = 40.0  # the seek loop: two windows
# the ladders of the new phases: two temperatures keep the fallback path
# (and its sampling) in the run while bounding random weights' decodes,
# which never emit EOT
SHORT_LADDER = (0.0, 0.2)
# one decode step's logits, K3 against the einsum route: they differ by the
# query's bf16 rounding and where P is rounded (by ~0.035 on large-v3's
# random bf16 weights); a wrong tile max or a lost tile moves them by more
STEP_LOGIT_TOL = 0.1
# wav2vec2 base log-probs, CUDA against the CPU, both in full f32 (the
# aligner turns TF32 off for its products and cuDNN's convolutions): only
# the order of f32 sums differs, ~1e-5 after 12 layers; TF32 would give ~1e-3
EMISSION_TOL = 1e-3
SEQ_WORDS_SAMPLE_LEN = 48  # tokens a window, for the seek loop with words
# tokens a row in the speculative int8 phase: every K4 shape and count of
# the path at a fifth of the full decode's time
SPEC_INT8_SAMPLE_LEN = 48
# an aligned char ends one emission frame (duration / (frames - 1) s, ~0.02)
# after its last frame, so an aligned segment may end that much after its
# transcript segment, and after the audio, as in JAX
ALIGN_END_SLACK_S = 0.05
DIAR_AUDIO_S = 120.0
# diarization embeddings, CUDA against the CPU, both in full f32: the
# spectral statistics only reorder f32 sums (~1e-7); the ResNet34's 36
# convolutions in cuDNN's and the CPU's algorithms, with TF32 off, ~1e-6
SPECTRAL_TOL = 1e-5
RESNET_TOL = 1e-4
RESNET_WINDOWS = 240  # phase 10(d): 2 s windows, as the pipeline cuts them
# phase 11: three requests of one (20, 30] s duration bucket (one serving
# batch), one aligned and diarized request, two WebSocket streams: one with
# partials, ended while its partial decodes; one diarized, long enough that
# its first chunk's decode (8-12 s on random weights) ends before the
# stream does, so it flushes on a pause, then by the latency cap, then the
# tail
SERVE_AUDIO_S = (21.0, 25.0, 29.0)
SERVE_ALIGN_S = 12.0
SERVE_STREAM_S = {"partials": 8.0, "diarize": 20.0}
# phase 11's two threads decoding one shape at once: steps a decode
SERVE_THREAD_STEPS = 32
# phase 12: the converted checkpoints transcribe 30 s (one window) for 24
# tokens a row: every kernel launch and shape of the path, and a profiler
# trace small enough to read back (~1.1 M events, 315 MB at 48 tokens)
CONVERT_AUDIO_S = 30.0
CONVERT_SAMPLE_LEN = 24
# phase 13 (scale-out on one card): DP over 60 s of the main path's audio
# and TP decodes, each bounded to a few tokens a row to fit its ~90 s
PARALLEL_AUDIO_S = 60.0
PARALLEL_SAMPLE_LEN = 48
TP_BATCH, TP_SAMPLE_LEN = 4, 24
# the split bf16 model's encoder output and first-step logits may differ from
# the whole model's, and from f32 arithmetic, by this factor times the whole
# bf16 model's own max error against f32 on the same weights: the split's
# f32 partial sums round like the whole product, and a one-ulp change then
# grows through the layers as rounding does (measured: ~1.0x the yardstick)
TP_BF16_FACTOR = 2.0
# openai/whisper-large-v3's published config.json (the HF source's widths)
LARGE_V3_HF = {
    "d_model": 1280, "encoder_layers": 32, "decoder_layers": 32,
    "encoder_attention_heads": 20, "decoder_attention_heads": 20, "num_mel_bins": 128,
    "vocab_size": 51866, "max_source_positions": 1500, "max_target_positions": 448,
}


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
    """Mean device time of ``fn()`` over ``iters`` calls, by CUDA events.
    A sleep kernel (about 1 ms per call) holds the stream while the host
    enqueues every call, so the calls run back to back and a kernel shorter
    than its Python wrapper's host time is timed by the device, not by the
    host."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000 * iters)  # cycles: ~1 ms each at ~2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_entry(name, source, replaces, err, ms, plain_ms, bytes_moved, ops, peak, library_ms):
    """One entry of the ``kernels`` line; the bound is the larger of the
    bytes over the memory rate and the operations over ``peak``."""
    bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / peak * 1e3
    return {
        "name": name,
        "route": "cuda",
        "source": f"whisperx_tpu_torch/ops/csrc/{source}",
        "replaces": replaces,
        "launches": None,  # set from the main path's run
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms,
    }


class einsum_route:
    """Inside: the decoder's cross-attention takes the einsum over the cache
    widened to f32 on every pass (the route of f32 models and of beams),
    through a shim around the model module's ``cross_decode_route``: the
    yardstick of one bf16 step's logits, never a path of the package."""

    def __enter__(self):
        from whisperx_tpu_torch.models.whisper import model as tm

        self.tm, self.real = tm, tm.cross_decode_route
        tm.cross_decode_route = lambda *args: False

    def __exit__(self, *exc):
        self.tm.cross_decode_route = self.real


class k4_by_shape:
    """Inside: K4's launches counted by shape, ``.counts()`` → {(M, K, N):
    n}, through a shim around ``int8_matmul`` that counts with
    ``ops.count_launch``. A decode step captured in a CUDA graph runs no
    Python when it is replayed, so a plain counter in the shim would see
    only the capture; ``count_launch`` records the capture's launches and
    adds them again at every replay, as it does for the kernels' own
    counts."""

    def __getattr__(self, name):  # a shape not launched yet
        if name.startswith("shape "):
            return 0
        raise AttributeError(name)

    def counts(self) -> dict:
        return {tuple(int(v) for v in k.split()[1:]): n for k, n in vars(self).items()
                if k.startswith("shape ")}

    def __enter__(self):
        from whisperx_tpu_torch.ops import count_launch
        from whisperx_tpu_torch.ops import quant_matmul as qm

        self.qm, self.real = qm, qm.int8_matmul

        def counted(x, qw, scale, group_size):
            count_launch(self, f"shape {x.shape[0]} {x.shape[1]} {qw.shape[1]}")
            return self.real(x, qw, scale, group_size)

        qm.int8_matmul = counted
        return self

    def __exit__(self, *exc):
        self.qm.int8_matmul = self.real


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def phase_card() -> str:
    import torch

    name = torch.cuda.get_device_name(0)
    print(f"[card] {REPO}: torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    print(card_line())
    return name


def kernel_name(line: str) -> str:
    """``name<template args>`` of the kernel on a ptxas line (mangled: the
    length-prefixed identifier that ends in ``_kernel``) or in a profiler's
    key (demangled)."""
    for digits in re.finditer(r"(?=(\d+))", line):
        start = digits.start() + len(digits.group(1))
        name = line[start : start + int(digits.group(1))]
        if name.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*", name):
            targs = re.match(r"(I(?:L[ib]\d+E)+E)?", line[start + len(name):]).group(0)
            args = re.findall(r"L[ib](\d+)E", targs)
            return name + (f"<{','.join(args)}>" if args else "")
    demangled = re.search(r"(\w+_kernel)(<[^<>()]*>)?", line)  # a profiler's key
    return demangled.group(0) if demangled else line.strip()[:60]


def phase_build() -> None:
    from whisperx_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(_build.load, KERNEL_SOURCES))
    print(f"[build] {', '.join(f'{n}.cu' for n in KERNEL_SOURCES)} in {time.perf_counter() - t0:.2f} s")
    # ptxas per kernel: registers, barriers, static shared memory, spills
    for name in KERNEL_SOURCES:
        kernel = spill = None
        for line in _build.build_log(name).splitlines():
            if "entry function" in line:
                kernel = kernel_name(line)
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line and kernel:
                print(f"[build] {name}: {kernel}: {line.split(':', 1)[-1].strip()}; {spill}")
                kernel = spill = None


def attention_case(bh, t, d, dtype, seed=0, tk=None):
    """Seeded q [bh, t, d] and k/v [bh, tk or t, d]. q is scaled by 3 so the
    softmax is peaked (a flat one would average v to ~0) and v by 1/4 so
    the outputs are of magnitude ≲ 1, where one bf16 ulp is ≤ 3.9e-3: the
    1e-2 tolerance then allows about two ulps of rounding-order
    difference."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (
        torch.randn((bh, n, d), generator=g, device="cuda", dtype=torch.float32)
        for n in (t, tk or t, tk or t)
    )
    return (q * 3.0).to(dtype), k.to(dtype), (v * 0.25).to(dtype)


def check_attention(label, out, ref, tol, shape):
    import torch

    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    mag = ref.float().abs().max().item()
    ok = math.isfinite(err) and err <= tol and out.shape == shape
    print(
        f"[kernels] {label}: {list(shape)} max_abs_err {err:.3e} "
        f"(tol {tol:g}, |ref| max {mag:.3f}) {'ok' if ok else 'FAIL'}"
    )
    if not ok:
        raise AssertionError(f"{label}: max_abs_err {err} > {tol}")
    return err


def attention_f64(q, k, v, causal=False):
    """``_attention_reference`` (or, causal, ``_flash_reference``)
    evaluated in f64: q scaled and rounded to f32 as the function defines
    it, then scores, exp2, the weighted sum and the normalisation in f64."""
    import torch

    from whisperx_tpu_torch.ops.flash_attention import _causal_keep, _scaled_q

    s = _scaled_q(q).double() @ k.double().transpose(-1, -2)
    if causal:
        s = s.masked_fill(~_causal_keep(q.shape[1], k.shape[1], q.device), float("-inf"))
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    return (p @ v.double()) / p.sum(dim=-1, keepdim=True)


def f32_witness(label, out, q, k, v, causal=False) -> float:
    """The kernel's f32 ``out`` against f64 within F32_WITNESS_FACTOR x the
    plain f32 version's own error (TF32 off), and the plain version with
    TF32 on (restored after) outside that limit."""
    import torch

    from whisperx_tpu_torch.ops.flash_attention import K2_BLOCK_KEYS, _attention_reference, _flash_reference

    def plain():
        if causal:
            return _flash_reference(q, k, v, causal=True, bk=K2_BLOCK_KEYS)
        return _attention_reference(q, k, v)

    exact = attention_f64(q, k, v, causal)
    gap = lambda x: (x.double() - exact).abs().max().item()  # noqa: E731
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    try:
        matmul.allow_tf32 = False
        err_kernel, err_f32 = gap(out), gap(plain())
        matmul.allow_tf32 = True
        err_tf32 = gap(plain())
    finally:
        matmul.allow_tf32 = saved
    limit = F32_WITNESS_FACTOR * err_f32
    ok = err_kernel <= limit < err_tf32
    print(
        f"[kernels] {label} witness against f64: kernel {err_kernel:.3e}, plain f32 {err_f32:.3e} "
        f"(limit {F32_WITNESS_FACTOR:g}x = {limit:.3e}; kernel {err_kernel / err_f32:.2f}x), control "
        f"plain TF32 {err_tf32:.3e} ({err_tf32 / err_f32:.1f}x, must be outside) {'ok' if ok else 'FAIL'}"
    )
    if not ok:
        raise AssertionError(f"{label}: f32 witness kernel {err_kernel} f32 {err_f32} tf32 {err_tf32}")
    return err_kernel


def phase_kernels() -> list:
    """K1 against its plain version at the main-path shape (large-v3, batch
    8: [160, 1500, 64] bf16) and the variants the kernel takes; K1b (its
    ``mxu_sum`` mode) at K1's shape; K2 causal at the same shape in bf16
    and f32, with fewer queries than keys, and non-causal over 3000 keys
    ([20, 3000, 64], past the whole-K kernel's 2048). K1b and K2 have no
    caller in the package: these are their shapes had they one. Every case
    is called twice and must give the same bits."""
    import torch
    import torch.nn.functional as F

    from whisperx_tpu_torch.ops.flash_attention import (
        K2_BLOCK_KEYS,
        _attention_reference,
        _flash_reference,
        flash_attention_tiled,
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
    entries = []

    def timed(name, source_line, fn, plain, library, bytes_moved, ops, dtype, err, peak=None):
        ms = cuda_ms(fn)
        plain_ms = cuda_ms(plain, iters=5)
        library_ms = cuda_ms(library)
        e = kernel_entry(
            name, "flash_attention.cu", f"whisperx_tpu/ops/flash_attention.py:{source_line}",
            err, ms, plain_ms, bytes_moved, ops, peak or PEAK_OPS_PER_S[str(dtype)], library_ms,
        )
        print(
            f"[kernels] {name} timing: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {library_ms:.4f} ms, bound {e['bound_ms']:.4f} ms by {e['bound_by']}"
        )
        return e

    for label, bh, t, d, dtype, skip_max, tol in cases:
        q, k, v = attention_case(bh, t, d, dtype)
        out = wholek_attention(q, k, v, skip_max=skip_max)
        ref = _attention_reference(q, k, v, skip_max=skip_max)
        err = check_attention(f"K1 {label}", out, ref, tol, q.shape)
        same_bits(f"K1 {label}", out, wholek_attention(q, k, v, skip_max=skip_max))
        if not entries:
            esize = q.element_size()
            # [1, BH, T, D]: 4-D so PyTorch can pick its flash backend
            entries.append(timed(
                "K1 wholek_attention", 125, lambda: wholek_attention(q, k, v),
                lambda: _attention_reference(q, k, v),
                lambda: F.scaled_dot_product_attention(q[None], k[None], v[None]),
                4 * bh * t * d * esize, 4 * bh * t * t * d, dtype, err,
            ))
        del q, k, v, out, ref

    # K1 in f32 at the main path's shape: the trainers' encoder and
    # --compute_type float32's; held to its design's floor, three TF32
    # products for each f32 one (the CUDA cores' f32 bound printed beside)
    bh, t, d = 160, 1500, 64
    q, k, v = attention_case(bh, t, d, torch.float32, seed=4)
    out = wholek_attention(q, k, v)
    err = check_attention("K1 f32 main shape", out, _attention_reference(q, k, v), 1e-4, q.shape)
    same_bits("K1 f32 main shape", out, wholek_attention(q, k, v))
    ops = 4 * bh * t * t * d
    k1_f32 = timed(
        "K1 wholek_attention (f32)", 125, lambda: wholek_attention(q, k, v),
        lambda: _attention_reference(q, k, v),
        lambda: F.scaled_dot_product_attention(q[None], k[None], v[None]),
        4 * bh * t * d * 4, 3 * ops, torch.float32, err, peak=PEAK_TF32_OPS_PER_S,
    )
    print(
        f"[kernels] K1 f32 bounds: {k1_f32['bound_ms']:.4f} ms as 3 x {ops / 1e9:.2f} GFLOP of TF32 "
        f"at {PEAK_TF32_OPS_PER_S / 1e12:.1f} TFLOP/s (the design's floor, held to), "
        f"{ops / PEAK_OPS_PER_S['torch.float32'] * 1e3:.4f} ms as {ops / 1e9:.2f} GFLOP of f32 on the "
        f"CUDA cores at {PEAK_OPS_PER_S['torch.float32'] / 1e12:.0f} TFLOP/s; kernel "
        f"{k1_f32['bound_ms'] / k1_f32['ms']:.1%} of its floor, {k1_f32['library_ms'] / k1_f32['ms']:.2f}x "
        f"faster than SDPA-f32"
    )
    entries.append(k1_f32)
    del q, k, v, out
    # its accuracy: against f64, beside the plain f32 version and plain TF32
    q, k, v = attention_case(40, 1500, 64, torch.float32, seed=5)
    f32_witness("K1 f32 [40, 1500, 64]", wholek_attention(q, k, v), q, k, v)
    del q, k, v

    # K1b: the denominator of the rounded weights
    bh, t, d = 160, 1500, 64
    q, k, v = attention_case(bh, t, d, torch.bfloat16, seed=1)
    out = wholek_attention(q, k, v, mxu_sum=True)
    err = check_attention(
        "K1b mxu_sum bf16", out, _attention_reference(q, k, v, mxu_sum=True), 1e-2, q.shape
    )
    same_bits("K1b mxu_sum bf16", out, wholek_attention(q, k, v, mxu_sum=True))
    entries.append(timed(
        "K1b wholek_attention(mxu_sum)", 163, lambda: wholek_attention(q, k, v, mxu_sum=True),
        lambda: _attention_reference(q, k, v, mxu_sum=True),
        lambda: F.scaled_dot_product_attention(q[None], k[None], v[None]),
        4 * bh * t * d * 2, 4 * bh * t * t * d, torch.bfloat16, err,
    ))
    del q, k, v, out

    k2_cases = [
        # (label, bh, tq, tk, d, dtype, causal, tol, timed)
        ("causal bf16", 160, 1500, 1500, 64, torch.bfloat16, True, 1e-2, True),
        ("causal f32", 160, 1500, 1500, 64, torch.float32, True, 1e-4, False),
        ("Tk 3000 bf16", 20, 3000, 3000, 64, torch.bfloat16, False, 1e-2, True),
        ("causal Tq 500 < Tk 1500 bf16", 20, 500, 1500, 64, torch.bfloat16, True, 1e-2, False),
        ("causal ragged D=32 bf16", 16, 1000, 1000, 32, torch.bfloat16, True, 1e-2, False),
        ("causal D=32 f32", 16, 1000, 1000, 32, torch.float32, True, 1e-4, False),
    ]
    for label, bh, tq, tk, d, dtype, causal, tol, is_timed in k2_cases:
        q, k, v = attention_case(bh, tq, d, dtype, seed=2, tk=tk)
        out = flash_attention_tiled(q, k, v, causal=causal)
        ref = _flash_reference(q, k, v, causal=causal, bk=K2_BLOCK_KEYS)
        err = check_attention(f"K2 {label}", out, ref, tol, q.shape)
        same_bits(f"K2 {label}", out, flash_attention_tiled(q, k, v, causal=causal))
        if dtype == torch.float32 and d == 32:  # the f32 route's witness at D 32, causal
            f32_witness(f"K2 {label}", out, q, k, v, causal=causal)
        if is_timed:
            esize = q.element_size()
            ops = 2 * bh * tq * tk * d if causal else 4 * bh * tq * tk * d
            e = timed(
                f"K2 flash_attention_tiled ({label})", 33,
                lambda: flash_attention_tiled(q, k, v, causal=causal),
                lambda: _flash_reference(q, k, v, causal=causal, bk=K2_BLOCK_KEYS),
                lambda: F.scaled_dot_product_attention(q[None], k[None], v[None], is_causal=causal),
                2 * bh * (tq + tk) * d * esize, ops, dtype, err,
            )
            if causal:
                e["name"] = "K2 flash_attention_tiled"
                entries.append(e)
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    return entries


def cross_decode_case(b, t, h, dh, seed=0):
    """Seeded spread bf16 queries [B, H, D] with rows of N(0, 0.005²) (so
    the scores Σ q·k over 64 int8 values are of magnitude ~3), int8 k/v
    uniform in [-127, 127], the per-head int8 queries with their scales,
    and the packed query before its bf16 rounding [B, D] f32."""
    import torch

    from whisperx_tpu_torch.ops.cross_attention_decode import spread_queries

    g = torch.Generator(device="cuda").manual_seed(seed)
    d = h * dh
    q32 = 0.005 * torch.randn((b, d), generator=g, device="cuda")
    qs = spread_queries(q32.to(torch.bfloat16), h)
    k8, v8 = (
        torch.randint(-127, 128, (b, t, d), generator=g, device="cuda", dtype=torch.int8)
        for _ in range(2)
    )
    sq = torch.clamp(qs.float().abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-10)
    qs8 = torch.clamp(torch.round(qs.float() / sq), -127, 127).to(torch.int8)
    return qs, k8, v8, qs8, sq, q32


# K3's shapes: (B, T, H, Dh). The large-v3 decode step at the benchmark's
# batch of 16, at the pipeline's of 8 and at B 1 (timed); a tile that
# overhangs; test-nano's head size; past 8 tiles (blocks walk two whole
# tiles) with T % 4 != 0 (K3kt's rows then start at any byte)
K3_SHAPES = ((16, 1500, 20, 64), (8, 1500, 20, 64), (1, 1500, 20, 64), (1, 300, 20, 64),
             (2, 1500, 2, 32), (1, 4999, 4, 64))
K3_TIMED = ((16, 1500), (8, 1500), (1, 1500))
K3_ENTRY_B = 16  # the kernels line's K3 family entries: the benchmark's batch


def phase_k3():
    """K3, K3kt and K3i8 against their plain versions at K3_SHAPES.
    Tolerance: atol 1e-2 (|out| ≲ 120). The kernel rounds P against the
    plain version's running max of each 512-key tile, so only f32 sum
    orders differ, which moves the outputs by ~1e-4. A kernel that left
    out the bf16 rounding of the query or of P would be off by ~0.05 to
    0.4: the control (the plain version on the unrounded f32 query) must
    fail the same tolerance. Every case is called twice and must give the
    same bits. Timed at K3_TIMED with enough copies of K/V cycled to pass
    the 50 MB L2 (a decode step reads 32 layers' K/V, each once).
    Yardstick: one ``scaled_dot_product_attention`` on K/V widened to bf16
    beforehand. Returns the kernels-line entries (B K3_ENTRY_B) and one
    record per timed shape. Uses only functions that every version of the port has,
    so a copy of this script times an older commit's kernel the same way."""
    import torch
    import torch.nn.functional as F

    from whisperx_tpu_torch.ops import cross_attention_decode as cad
    from whisperx_tpu_torch.ops.cross_attention_decode import (
        _cross_decode_reference,
        cross_decode,
        cross_decode_i8,
        cross_decode_kt,
        spread_queries,
    )

    tol = 1e-2
    variants = {
        "K3": (cross_decode, 57, lambda qs, k8, v8, qs8, sq, q32: (qs, k8, v8), {}),
        "K3kt": (
            cross_decode_kt, 148,
            lambda qs, k8, v8, qs8, sq, q32: (qs, k8.transpose(1, 2).contiguous(), v8),
            {"k_transposed": True},
        ),
        "K3i8": (cross_decode_i8, 232, lambda qs, k8, v8, qs8, sq, q32: (qs8, sq, k8, v8), None),
    }
    entries, shapes = [], []
    for b, t, h, dh in K3_SHAPES:
        case = cross_decode_case(b, t, h, dh, seed=t + b)
        plan = getattr(cad, "launch_plan", None)
        if plan is not None:
            print(f"[kernels] K3 B={b} T={t} H={h} Dh={dh}: launch plan {plan(b, t, h, dh)}")
        for name, (fn, line, args_of, ref_kw) in variants.items():
            args = args_of(*case)
            out = fn(*args)
            torch.cuda.synchronize()
            if ref_kw is None:  # K3i8: qs8, sq, k8, v8
                ref = _cross_decode_reference(args[0], args[2], args[3], sq=args[1])
            else:
                ref = _cross_decode_reference(args[0], args[1], args[2], **ref_kw)
            err = (out - ref).abs().max().item()
            mag = ref.abs().max().item()
            ok = math.isfinite(err) and err <= tol and out.shape == (b, 1, h * dh)
            print(
                f"[kernels] {name} B={b} T={t} H={h} Dh={dh}: max_abs_err {err:.3e} "
                f"(tol {tol:g}, |ref| max {mag:.3f}) {'ok' if ok else 'FAIL'}"
            )
            if not ok:
                raise AssertionError(f"{name} B={b} T={t}: max_abs_err {err} > {tol}")
            same_bits(f"{name} B={b} T={t} H={h} Dh={dh}", out, fn(*args))
            if name == "K3":
                control = _cross_decode_reference(spread_queries(case[5], h), case[1], case[2])
                c_err = (out - control).abs().max().item()
                print(
                    f"[kernels] K3 B={b} T={t} control (plain version on the f32 query): "
                    f"max_abs_err {c_err:.3e}, must exceed tol {tol:g} "
                    f"{'ok' if c_err > tol else 'FAIL'}"
                )
                if not c_err > tol:
                    raise AssertionError(f"K3 control {c_err} within {tol}: the check cannot tell")
                del control
            if (b, t) not in K3_TIMED:
                continue
            kv_bytes = 2 * b * t * h * dh
            copies = math.ceil(2 * L2_BYTES / kv_bytes)
            sets = [  # fresh copies of K and V; the queries are shared
                tuple(a.clone() if a.numel() == b * t * h * dh else a for a in args)
                for _ in range(copies)
            ]
            cycle = itertools.cycle(sets)
            ms = cuda_ms(lambda: fn(*next(cycle)))
            if ref_kw is None:
                plain = lambda: (lambda a: _cross_decode_reference(a[0], a[2], a[3], sq=a[1]))(next(cycle))
            else:
                plain = lambda: (lambda a: _cross_decode_reference(*a, **ref_kw))(next(cycle))
            plain_ms = cuda_ms(plain, iters=5)
            # the yardstick: [B, H, 1, Dh] queries over [B, H, T, Dh] bf16 K/V
            widened = [
                tuple(x.reshape(b, t, h, dh).transpose(1, 2).to(torch.bfloat16).contiguous()
                      for x in (case[1], case[2]))
                for _ in range(max(1, math.ceil(2 * L2_BYTES / (2 * kv_bytes))))
            ]
            qh = case[0].float().sum(1).reshape(b, 1, h, dh).transpose(1, 2).to(torch.bfloat16)
            wcycle = itertools.cycle(widened)
            library_ms = cuda_ms(
                lambda: F.scaled_dot_product_attention(qh, *next(wcycle), scale=1.0)
            )
            # what the function needs: int8 K and V, each head's own query
            # slice (B·D elements, not the [B, H, D] spread), the K3i8
            # query scales
            in_bytes = kv_bytes + b * h * dh * args[0].element_size()
            if ref_kw is None:
                in_bytes += b * h * 4
            moved = in_bytes + out.numel() * 4
            peak = 1979e12 if name == "K3i8" else PEAK_OPS_PER_S["torch.bfloat16"]
            e = kernel_entry(
                f"{name} cross_attention_decode", "cross_attention_decode.cu",
                f"whisperx_tpu/ops/cross_attention_decode.py:{line}", err, ms, plain_ms,
                moved, 4 * b * t * h * dh, peak, library_ms,
            )
            print(
                f"[kernels] {name} B={b} T={t} timing ({copies} K/V copies cycled): kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa on bf16 K/V {library_ms:.4f} ms, "
                f"bound {e['bound_ms']:.4f} ms by {e['bound_by']} "
                f"({moved / 1e6:.4f} MB moved, {kv_bytes / 1e6:.2f} MB of it int8 K/V)"
            )
            shapes.append({"name": name, "b": b, "t": t, "h": h, "dh": dh, "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": e["bound_ms"],
                           "library_ms": library_ms, "max_abs_err": err})
            if b == K3_ENTRY_B:
                entries.append(e)
            del sets, widened
        del case
    torch.cuda.empty_cache()
    return entries, shapes


def phase_k3_route() -> None:
    """The decoder's default route at the benchmark's step, B 16, T 1500,
    H 20, Dh 64 (the first of K3_SHAPES). (a) Its op,
    ``cross_attention_decode`` on the packed [B, 1, H, Dh] query (the
    layout the decoder hands it, unlike phase_k3's spread queries), against
    K3's plain version within the family's 1e-2 (|out| ≲ 120), the same
    bits twice; the control as in phase_k3: the plain version on the
    unrounded f32 query must fall outside. (b) ``_cross_attention`` of a
    bf16 query over a ``QuantizedKV`` of N(0, 1) bf16 K/V with
    ``cross_decode_route``'s answer (K3, one launch), against the widened
    einsum (``use_kernel=False``, the route of f32 queries): within 1e-2
    of the einsum's largest |output| (they differ where P is rounded to
    bf16 and in the output's bf16 rounding). (c) Both routes timed, K/V
    cycled past the L2: one layer's cross-attention of a step. Skipped on a
    port without ``cross_decode_route``."""
    import torch

    from whisperx_tpu_torch.models.whisper import model as tm
    from whisperx_tpu_torch.ops import cross_attention_decode as cad

    route = getattr(cad, "cross_decode_route", None)
    if route is None:
        print("[kernels] K3 route: no cross_decode_route in this version; skipped")
        return
    tol = 1e-2
    b, t, h, dh = K3_SHAPES[0]
    d = h * dh
    _, k8, v8, _, _, q32 = cross_decode_case(b, t, h, dh, seed=t + b + 1)
    q_eff = q32.to(torch.bfloat16).reshape(b, 1, h, dh)
    k4, v4 = k8.reshape(b, t, h, dh), v8.reshape(b, t, h, dh)
    out = cad.cross_attention_decode(q_eff, k4, v4)
    same_bits(f"K3 op B={b} T={t}", out, cad.cross_attention_decode(q_eff, k4, v4))
    ref = cad._cross_decode_reference(cad.spread_queries(q_eff.reshape(b, d), h), k8, v8)
    err = (out.reshape(b, 1, d) - ref).abs().max().item()
    control = cad._cross_decode_reference(cad.spread_queries(q32, h), k8, v8)
    c_err = (out.reshape(b, 1, d) - control).abs().max().item()
    ok = math.isfinite(err) and err <= tol < c_err
    print(
        f"[kernels] K3 op (packed query) B={b} T={t} H={h} Dh={dh}: max_abs_err {err:.3e} (tol {tol:g}, "
        f"|ref| max {ref.abs().max().item():.3f}); control (plain version on the f32 query) {c_err:.3e} "
        f"must exceed tol {'ok' if ok else 'FAIL'}"
    )
    if not ok:
        raise AssertionError(f"K3 op: max_abs_err {err}, control {c_err}, tol {tol}")
    del ref, control

    g = torch.Generator(device="cuda").manual_seed(b + t)
    sets = [
        tuple(tm.quantize_kv(torch.randn((b, t, h, dh), generator=g, device="cuda").to(torch.bfloat16))
              for _ in range(2))
        for _ in range(max(2, math.ceil(2 * L2_BYTES / (2 * b * t * d))))
    ]
    cq = torch.randn((b, 1, h, dh), generator=g, device="cuda").to(torch.bfloat16)
    use = route(cq.device, cq.dtype, dh, True, 1)
    assert use is True, use
    launches = cad.cross_attention_decode.launches
    got = tm._cross_attention(cq, *sets[0], use)
    assert cad.cross_attention_decode.launches == launches + 1
    einsum = tm._cross_attention(cq, *sets[0], False)
    gap = (got.float() - einsum.float()).abs().max().item()
    mag = einsum.float().abs().max().item()
    ok = got.dtype == torch.bfloat16 and math.isfinite(gap) and gap <= tol * mag
    cycle = itertools.cycle(sets)
    route_ms = cuda_ms(lambda: tm._cross_attention(cq, *next(cycle), use))
    einsum_ms = cuda_ms(lambda: tm._cross_attention(cq, *next(cycle), False), iters=10)
    print(
        f"[kernels] K3 route B={b} T={t} H={h} Dh={dh}: the default route (K3) against the widened einsum: "
        f"max_abs_gap {gap:.3e}, {gap / mag:.2%} of |einsum| max {mag:.4f} (within {tol:g} of it) "
        f"{'ok' if ok else 'FAIL'}; one layer's cross-attention {route_ms:.4f} ms (K3 route) against "
        f"{einsum_ms:.4f} ms (einsum route), {len(sets)} K/V sets cycled"
    )
    if not ok:
        raise AssertionError(f"K3 route against the einsum: {gap} > {tol} x {mag}")
    del sets
    torch.cuda.empty_cache()


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


# K4's shapes on the int8 CLI path (large-v3, group 64): the weights (K, N)
# of a quantized decoder block (self q/k/v/out and cross q/out; mlp1; mlp2)
# at the rows of each call: a greedy or beam-5 decode step over 8 slots (the
# speculative draft's one-token passes and its verify passes of γ+1 = 5
# tokens have the same rows), the beam-5 prefill of the 3-token prompt, the
# cross-KV projection of 8 × 1500 frames (cross key and value only)
K4_WEIGHTS = ((1280, 1280), (1280, 5120), (5120, 1280))
K4_ROWS = (
    ("decode greedy, speculative draft step", 8), ("decode beam 5, speculative verify", 40),
    ("prefill beam 5", 120), ("cross-KV", 12000),
)


def same_bits(label, a, b) -> None:
    """Two calls of a kernel on the same inputs must agree bit for bit."""
    import torch

    ok = torch.equal(a, b)
    print(f"[kernels] {label}: two calls bit-identical {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: two calls on the same inputs differ")


def phase_k4():
    """K4 against its plain version at every shape of the int8 CLI path
    (K4_ROWS × K4_WEIGHTS; the cross-KV rows only at (1280, 1280)), a
    ragged 13-row case, f32 (test-sized models run K4 in f32), and,
    untimed, groups 32 and 16 (a checkpoint quantized with another group
    size) at an N that is not a multiple of 16, which take the plain tiled
    path. Every case is called twice and must give the same bits. Each
    CLI shape is timed with enough copies of the weights cycled to overflow
    the 50 MB L2, as the decode step (240 different weights) finds them
    cold. Returns the kernels-line entry (M 40 × (1280, 5120), as before)
    and one record per timed shape."""
    import torch

    from whisperx_tpu_torch.ops import quant_matmul as qm
    from whisperx_tpu_torch.ops.quant_matmul import _quant_matmul_reference, int8_matmul
    from whisperx_tpu_torch.quant import QuantizedLinear, dequantize

    # bf16: one bf16 ulp of the output at its largest magnitude, 2⁻⁷·max|ref|
    # (both sum exact products in f32, in different orders, and round once);
    # f32: 1e-4·max|ref| (order of the f32 sums only)
    tol = {torch.bfloat16: 2.0**-7, torch.float32: 1e-4}
    timed = [
        (f"{label}, K {k} N {n}", m, k, n, torch.bfloat16, 64, True)
        for label, m in K4_ROWS
        for k, n in K4_WEIGHTS
        if m != 12000 or (k, n) == (1280, 1280)
    ]
    cases = timed + [
        # (label, m, k, n, dtype, group, timed)
        ("ragged", 13, 1280, 1280, torch.bfloat16, 64, False),
        ("f32", 40, 1280, 5120, torch.float32, 64, False),
        ("group 32, ragged N", 13, 256, 100, torch.bfloat16, 32, False),
        ("group 16, ragged N", 13, 256, 100, torch.bfloat16, 16, False),
        ("group 32", 40, 256, 128, torch.bfloat16, 32, False),
        ("f32 group 32, ragged N", 13, 256, 100, torch.float32, 32, False),
    ]
    plan_of = getattr(qm, "launch_plan", None)  # absent before the split-K design
    main, shapes = None, []
    for label, m, k, n, dtype, group, is_timed in cases:
        x, qw, scale = quant_case(m, k, n, dtype, group)
        out = int8_matmul(x, qw, scale, group)
        torch.cuda.synchronize()
        ref = _quant_matmul_reference(x, qw, scale, group)
        err = (out.float() - ref.float()).abs().max().item()
        mag = ref.float().abs().max().item()
        limit = tol[dtype] * mag
        ok = math.isfinite(err) and err <= limit and out.shape == (m, n) and out.dtype == dtype
        plan = plan_of(m, k, n, group, dtype) if plan_of else {"regime": "64 x 64 tiles", "grid": None}
        print(
            f"[kernels] K4 {label}: M={m} K={k} N={n} group {group} {str(dtype)[6:]} "
            f"({plan['regime']}, grid {plan['grid']}) max_abs_err "
            f"{err:.3e} (tol {limit:.3e} = {tol[dtype]:g}·max|ref| {mag:.3f}) "
            f"{'ok' if ok else 'FAIL'}"
        )
        if not ok:
            raise AssertionError(f"K4 {label}: max_abs_err {err} > {limit}")
        same_bits(f"K4 {label}", out, int8_matmul(x, qw, scale, group))
        if is_timed:
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
            shapes.append({"m": m, "k": k, "n": n, "regime": plan["regime"], "ms": ms,
                           "bound_ms": bound_ms, "library_ms": library_ms})
            if (m, k, n) == (40, 1280, 5120):
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
    return main, shapes


def phase_main_path(k1: dict):
    """large-v3 at full width, batch 8, through the user's entry points;
    returns the pipeline (for the later phases) and the transcript (for
    the alignment phase)."""
    import torch

    import whisperx_tpu_torch
    from whisperx_tpu_torch.asr import DEFAULT_ASR_OPTIONS
    from whisperx_tpu_torch.decoding.step_graph import graph_cache
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
    graphs = graph_cache(pipe.model.decoder).stats()
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
    graph_line("main", pipe.model, graphs)
    return pipe, result


class count_captures:
    """Inside: each teacher-forced capture of word timing is counted, with
    the K1 launches made inside it."""

    def __enter__(self):
        from whisperx_tpu_torch import timing
        from whisperx_tpu_torch.ops.flash_attention import flash_attention

        self.timing, self.real = timing, timing._capture_cross_qk
        self.calls, self.k1, self.rows = 0, 0, []

        def counted(model, tokens, mels, eot):
            before = flash_attention.launches
            out = self.real(model, tokens, mels, eot)
            self.calls += 1
            self.k1 += flash_attention.launches - before
            self.rows.append(tuple(tokens.shape))
            return out

        timing._capture_cross_qk = counted
        return self

    def __exit__(self, *exc):
        self.timing._capture_cross_qk = self.real


def phase_word_timing(pipe) -> None:
    """The main path's pipeline and audio with ``word_timestamps=True``,
    greedy (one temperature: random weights fail every gate, and the ladder
    is the main path's cost, not word timing's). Words come from one
    teacher-forced capture per group of 8 windows (``WHISPERX_TPU_ALIGN_BATCH``);
    random weights never emit EOT, so each window has ~224 tokens."""
    import torch

    from whisperx_tpu_torch.ops.flash_attention import flash_attention
    from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER

    audio = synth_speech(MAIN_AUDIO_S, seed=1)
    GLOBAL_TRACKER.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    with count_captures() as cap:
        t0 = time.perf_counter()
        result = pipe.transcribe(audio, language="en", word_timestamps=True, temperatures=(0.0,))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = flash_attention.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    report = GLOBAL_TRACKER.report()
    n_layer = pipe.model.dims.n_audio_layer
    n_dec = report["decode"]["calls"]
    assert cap.calls >= 1 and cap.k1 == n_layer * cap.calls, (cap.k1, cap.calls)
    assert launches == n_layer * (n_dec + cap.calls), (launches, n_dec, cap.calls)
    words = [w for seg in result["segments"] for w in seg["words"]]
    assert words, result["segments"][:2]
    for seg in result["segments"]:
        assert 0.0 <= seg["start"] <= seg["end"] <= MAIN_AUDIO_S + 1e-6, seg
        for w in seg["words"]:
            assert 0.0 <= w["start"] <= w["end"] <= MAIN_AUDIO_S + 1e-6, w
            assert math.isfinite(w["probability"]), w
    stage = report["word_timing"]
    print(
        f"[words] transcribe(word_timestamps=True, temperatures=(0.0,)) of {MAIN_AUDIO_S:.0f} s: "
        f"{wall:.3f} s; word_timing stage {stage['total_s']:.4f} s ({stage['calls']} call); "
        f"decode {report['decode']['total_s']:.4f} s; {cap.calls} captures of [rows, tokens] "
        f"{cap.rows}; {len(words)} words in {len(result['segments'])} segments; K1 launches "
        f"{launches} (= {n_layer} x ({n_dec} decodes + {cap.calls} captures), {cap.k1} on the "
        f"word-timing path); peak memory {peak:.2f} GiB"
    )

    # the capture's worst case: 8 windows of 220 text tokens each (random
    # weights rarely decode that much text, a real 30 s window can), one
    # group, timed with its host post-processing and DTW
    import numpy as np

    from whisperx_tpu_torch.audio import log_mel_batch
    from whisperx_tpu_torch.timing import find_alignment_batch

    tokenizer = pipe._tokenizer(language="en", task="transcribe")
    rng = np.random.default_rng(7)
    texts = [[int(t) for t in rng.integers(220, 10000, 220)] for _ in range(8)]
    mels = log_mel_batch(
        np.stack([audio[i * 12 * 16000 : (i * 12 + 30) * 16000] for i in range(8)]),
        pipe.model.dims.n_mels, device="cuda",
    )
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    with count_captures() as cap:
        t0 = time.perf_counter()
        aligned = find_alignment_batch(pipe.model, tokenizer, texts, mels, [3000] * 8)
        wall = time.perf_counter() - t0
    assert cap.calls == 1 and cap.k1 == flash_attention.launches == n_layer, (cap.calls, cap.k1)
    assert all(len(a) > 0 for a in aligned)
    print(
        f"[words] worst case: find_alignment_batch of 8 windows x 220 tokens (capture {cap.rows}, "
        f"{len(pipe.model.alignment_heads)} alignment heads): {wall:.3f} s with DTW; K1 launches "
        f"{cap.k1}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )


def make_align_checkpoint(root: str) -> str:
    """wav2vec2 BASE_CONFIG weights from a seeded ``torch.Generator``, written
    with the port's ``save_checkpoint`` as ``<root>/en`` with the base-960h
    dictionary; returns ``root`` (for ``WHISPERX_TPU_ALIGN_DIR``)."""
    import dataclasses

    import torch

    from whisperx_tpu_torch.alignment import DEFAULT_EN_VOCAB
    from whisperx_tpu_torch.convert.checkpoint import save_checkpoint
    from whisperx_tpu_torch.models.wav2vec2 import BASE_CONFIG, init_params

    t0 = time.perf_counter()
    model = init_params(BASE_CONFIG, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    save_checkpoint(
        os.path.join(root, "en"), model,
        {"family": "wav2vec2", "name": "base-random-seed0",
         "config": dataclasses.asdict(BASE_CONFIG), "dictionary": DEFAULT_EN_VOCAB},
    )
    print(
        f"[align] wav2vec2 BASE_CONFIG ({n_params} parameters, from torch.Generator seed 0) "
        f"written with save_checkpoint in {time.perf_counter() - t0:.2f} s"
    )
    return root


def phase_alignment(segments) -> None:
    """Forced alignment of the main path's segments over its audio on the
    card, through ``load_align_model`` (from ``WHISPERX_TPU_ALIGN_DIR``) and
    ``align``; then CUDA against the CPU on the shortest segment."""
    import numpy as np
    import torch

    import whisperx_tpu_torch
    from whisperx_tpu_torch import alignment
    from whisperx_tpu_torch.alignment.aligner import bucket_of
    from whisperx_tpu_torch.models.wav2vec2 import forward, output_lengths

    audio = synth_speech(MAIN_AUDIO_S, seed=1)
    t0 = time.perf_counter()
    aligner, meta = whisperx_tpu_torch.load_align_model("en", device="cuda")
    torch.cuda.synchronize()
    assert meta["random_weights"] is False and meta["type"] == "torch", meta
    assert aligner.device.type == "cuda" and aligner.config.num_layers == 12
    print(f"[align] load_align_model('en') from WHISPERX_TPU_ALIGN_DIR in {time.perf_counter() - t0:.2f} s")

    # device time of each emission forward by CUDA events, per bucket
    buckets, real_forward = [], aligner._forward

    def timed_forward(batch):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        x = torch.from_numpy(batch).to(aligner.device)
        start.record()
        ems = forward(aligner.model, x)
        end.record()
        torch.cuda.synchronize()
        buckets.append((batch.shape, start.elapsed_time(end)))
        return ems.cpu().numpy()

    aligner._forward = timed_forward
    host = {"get_trellis": 0.0, "backtrack_beam": 0.0}
    real = {name: getattr(alignment, name) for name in host}

    def timed(name):
        def run(*a, **kw):
            t = time.perf_counter()
            out = real[name](*a, **kw)
            host[name] += time.perf_counter() - t
            return out
        return run

    for name in host:
        setattr(alignment, name, timed(name))
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        result = alignment.align(segments, aligner, meta, audio, "cuda")
        wall = time.perf_counter() - t0
    finally:
        for name in host:
            setattr(alignment, name, real[name])
        aligner._forward = real_forward
    words = result["word_segments"]
    assert words and len(result["segments"]) >= 1, result
    # every aligned segment lies in its transcript segment, in order (one
    # emission frame of slack at the end: a char's end is its last frame +
    # 1, at duration / (frames - 1) seconds a frame); its words inside it,
    # their starts monotone
    spans = []
    for s in segments:
        n = int(s["end"] * 16000) - int(s["start"] * 16000)
        frames = output_lengths(aligner.config, max(n, 400))
        spans.append((s["start"], s["end"] + (s["end"] - s["start"]) / max(frames - 1, 1) + 5e-4))
    k = 0
    for seg in result["segments"]:
        while not (spans[k][0] <= seg["start"] and seg["end"] <= spans[k][1]):
            k += 1
            assert k < len(spans), ("aligned segment outside the transcript's", seg)
        starts = [w["start"] for w in seg["words"] if "start" in w]
        assert starts == sorted(starts), seg
        for w in seg["words"]:
            assert seg["start"] - 1e-6 <= w["start"] <= w["end"] <= seg["end"] + 1e-6, (w, seg)
    emit_ms = sum(ms for _, ms in buckets)
    print(
        f"[align] align() of {len(segments)} segments over {MAIN_AUDIO_S:.0f} s: wall {wall:.3f} s; "
        f"emissions {emit_ms:.3f} ms device in {len(buckets)} buckets "
        + "; ".join(f"[{b} x {n}] {ms:.3f} ms" for (b, n), ms in buckets)
        + f"; host trellis {host['get_trellis']:.4f} s, backtrack {host['backtrack_beam']:.4f} s; "
        f"{len(words)} words in {len(result['segments'])} sentence segments; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )

    # CUDA against the CPU on the shortest segment with text
    seg = min((s for s in segments if s["text"].strip()), key=lambda s: s["end"] - s["start"])
    wave = audio[int(seg["start"] * 16000) : int(seg["end"] * 16000)]
    cpu_aligner, cpu_meta = whisperx_tpu_torch.load_align_model("en", device="cpu")
    cuda_em = aligner.emissions_batch([wave])[0]
    cpu_em = cpu_aligner.emissions_batch([wave])[0]
    err = float(np.abs(cuda_em - cpu_em).max())
    ok = cuda_em.shape == cpu_em.shape and math.isfinite(err) and err <= EMISSION_TOL
    same_words = alignment.align([seg], aligner, meta, audio) == alignment.align(
        [seg], cpu_aligner, cpu_meta, audio
    )
    aligner.emissions_batch = lambda waves: [cpu_em]  # the CPU's emissions on both
    try:
        fed = alignment.align([seg], aligner, meta, audio) == alignment.align(
            [seg], cpu_aligner, cpu_meta, audio
        )
    finally:
        del aligner.emissions_batch
    print(
        f"[align] CUDA vs CPU on one segment ({seg['end'] - seg['start']:.2f} s, bucket "
        f"{bucket_of(len(wave))}): emissions {list(cuda_em.shape)} max_abs_err {err:.3e} "
        f"(tol {EMISSION_TOL:g}, TF32 off); words {'identical' if same_words else 'differ'} from "
        f"each device's emissions; identical given the CPU emissions: {fed} {'ok' if ok and fed else 'FAIL'}"
    )
    if not (ok and fed):
        raise AssertionError(f"alignment CUDA vs CPU: err {err}, same given CPU emissions {fed}")
    del aligner, cpu_aligner
    torch.cuda.empty_cache()


DEVICE_TRACE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(prof) -> list:
    """The device's kernels, copies and fills in a finished ``torch.profiler``
    block, summed by name: ``[(name, ms, calls)]``, the largest first. They
    are read from the Chrome trace the profiler writes in C++:
    ``key_averages()`` builds a Python object for each of a batched decode's
    ~10^6 host and device events, which takes minutes."""
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)["traceEvents"]
    totals = {}
    for e in trace:
        if e.get("cat") in DEVICE_TRACE_CATS:
            ms, n = totals.get(e["name"], (0.0, 0))
            totals[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    return sorted(((name, ms, n) for name, (ms, n) in totals.items()), key=lambda e: -e[1])


def decode_outputs(handle) -> list:
    """A ``decode_dispatch`` handle's results as tensors: tokens, lengths,
    sum_logprobs and no-speech probabilities (a beam decode's banks, live
    beams and scores), and the step count."""
    import torch

    parts = handle["beam_device"] if "beam_device" in handle else handle["device"][:4]
    return [p if torch.is_tensor(p) else torch.tensor(p) for p in parts] + [torch.tensor(handle["steps"])]


def graph_line(tag: str, model, before: dict, attr: str = "_step_graphs") -> dict:
    """The ``[graph]`` line: the decoder's graph cache since ``before``
    (``attr=SPEC_GRAPHS``: its speculative decodes' cache)."""
    import torch

    from whisperx_tpu_torch.decoding.step_graph import graph_cache

    now = graph_cache(model.decoder, attr).stats()
    print(
        f"[graph] {tag}: captures {now['captures'] - before['captures']}, replays "
        f"{now['replays'] - before['replays']}; cache entries {now['entries']}, static buffers "
        f"{now['static_bytes'] / 2**20:.1f} MiB, graph pools {now['pool_bytes'] / 2**20:.1f} MiB; "
        f"device memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB"
    )
    return now


def phase_decode_profile(model, tag: str = "profile", beam_size=None, k3=None) -> None:
    """Where one batched decode spends its time: PROFILE_BATCH 30 s mels of
    the pipeline's warm-up signal, decoded for PROFILE_STEPS tokens (encoder
    and prefill included) with the main path's options: greedily, or with
    ``beam_size`` beams (the CLI's default of 5). Each decode runs twice
    over: each step a replay of its captured CUDA graph (the path every
    single-card decode takes) and uncaptured (``_eager``, the yardstick),
    timed in turns; every run's tokens, lengths and scores must equal the
    first captured run's bits and every kernel's launches must be equal.
    ``k3``: the K3 kernel entry, for a decode whose steps take K3 (bf16
    greedy over the int8 cache, the default route); every run must launch
    it once per decoder layer per sampled step, and its device time is
    printed; without it (beams, f32) no run may launch K3. The kernels named in each profile (K3, K4) must be
    found in the captured decode's trace, inside its replays. Returns the
    median ms per step of each mode and the launches of a 48-step decode."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from whisperx_tpu_torch.asr import warmup_audio
    from whisperx_tpu_torch.audio import log_mel_batch
    from whisperx_tpu_torch.decoding import DecodingOptions
    from whisperx_tpu_torch.decoding.decode import decode_dispatch
    from whisperx_tpu_torch.decoding.step_graph import graph_cache
    from whisperx_tpu_torch.ops.cross_attention_decode import cross_attention_decode
    from whisperx_tpu_torch.ops.flash_attention import flash_attention
    from whisperx_tpu_torch.ops.quant_matmul import quant_matmul
    from whisperx_tpu_torch.quant import QuantizedLinear

    audio = np.stack([warmup_audio(30.0)] * PROFILE_BATCH)
    mels = log_mel_batch(audio, model.dims.n_mels, device="cuda")
    opts = DecodingOptions(
        language="en", sample_len=PROFILE_STEPS, kv_quant=True, beam_size=beam_size
    )
    counted = {"K1": flash_attention, "K3": cross_attention_decode, "K4": quant_matmul}
    modes = {"captured": False, "uncaptured": True}  # name → _eager
    first = {}

    def run(mode, opts=opts):
        for fn in counted.values():
            fn.launches = 0
        h = decode_dispatch(model, mels, opts, _eager=modes[mode])
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counted.items()}
        want = model.dims.n_text_layer * h["steps"] if k3 is not None else 0
        assert launches["K3"] == want, (mode, launches, want)
        out = decode_outputs(h)
        key = (mode, opts.sample_len)
        ref = first.setdefault(opts.sample_len, (out, launches, mode))
        same = all(torch.equal(a, b) for a, b in zip(out, ref[0]))
        assert same and launches == ref[1], (f"[{tag}] {mode} run differs from the {ref[2]} one", key,
                                             launches, ref[1])
        return h["steps"], launches

    cache_before = graph_cache(model.decoder).stats()
    for mode in ("captured", "uncaptured"):  # warm-up: captures, allocator, cuBLAS
        run(mode)
    per_step_ms = {mode: [] for mode in modes}
    for i in range(PROFILE_RUNS):  # in turns: c u, u c, c u
        for mode in (("captured", "uncaptured") if i % 2 == 0 else ("uncaptured", "captured")):
            t0 = time.perf_counter()
            steps, launches = run(mode)
            per_step_ms[mode].append((time.perf_counter() - t0) / steps * 1e3)
    medians = {}
    for mode, ms in per_step_ms.items():
        q1, med, q3 = np.percentile(ms, [25, 50, 75])
        medians[mode] = med
        print(
            f"[{tag}] {mode}: batch {PROFILE_BATCH}, beam {beam_size or 1}, {steps} steps, {PROFILE_RUNS} "
            f"runs: ms per step (wall, encoder and prefill included) {' '.join(f'{x:.3f}' for x in ms)}; "
            f"median {med:.3f}, quartiles {q1:.3f} / {q3:.3f}"
        )
    print(
        f"[{tag}] captured and uncaptured: tokens, lengths and scores bit-identical over "
        f"{2 * PROFILE_RUNS + 2} runs; launches per decode equal: {launches}"
    )
    traced_opts = dataclasses.replace(opts, sample_len=PROFILE_TRACE_STEPS)
    # K4 serves int8 weights only: int4 dequantizes, then one product
    int8 = any(isinstance(m, QuantizedLinear) and m.bits == 8 for m in model.decoder.modules())
    for mode in modes:
        run(mode, traced_opts)  # the traced shape's capture, outside the trace
    k4_traced = {}
    for mode in modes:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            traced, _ = run(mode, traced_opts)
            wall = time.perf_counter() - t0
        events = device_events(prof)
        assert events, f"[{tag}] the profiler recorded no device activity"
        device_s = sum(ms for _, ms, _ in events) / 1e3
        print(
            f"[{tag}] {mode}: one decode of {traced} steps under the profiler: wall {wall:.4f} s, CUDA "
            f"kernels {device_s:.4f} s, device busy {device_s / wall:.1%}"
        )
        for name, ms, n in events[: 10 if mode == "captured" else 5]:
            print(f"[{tag}] {mode} {ms:10.3f} ms {n:7d} calls  {name[:90]}")
        k4_events = [e for e in events if "int8_matmul" in e[0] or "splitk_reduce" in e[0]]
        assert bool(k4_events) == int8, (f"[{tag}] {mode}: K4's kernels in the trace", k4_events)
        if k4_events:  # K4: its kernels (a split-K call launches two), by name
            k4_ms = sum(ms for _, ms, _ in k4_events)
            k4_calls = k4_traced[mode] = sum(n for name, _, n in k4_events if "reduce" not in name)
            print(
                f"[{tag}] {mode} K4 device time per decode {k4_ms:.3f} ms over {k4_calls} calls "
                f"({k4_ms / max(k4_calls, 1):.4f} ms a call, {k4_ms / device_s / 1e3:.1%} of the "
                f"kernel time): " + "; ".join(
                    f"{kernel_name(name)} {n} x {ms / n:.4f} ms" for name, ms, n in k4_events
                )
            )
        if k3 is not None:
            k3_events = [e for e in events if "cross_decode_kernel" in e[0]]
            k3_ms = sum(ms for _, ms, _ in k3_events)
            k3_calls = sum(n for _, _, n in k3_events)
            assert k3_calls == model.dims.n_text_layer * traced, (f"[{tag}] {mode}: K3 in the trace", k3_calls)
            print(
                f"[{tag}] {mode} K3 launched {model.dims.n_text_layer} x {traced} times per decode; "
                f"its device time {k3_ms:.3f} ms over {k3_calls} launches "
                f"({k3_ms / max(k3_calls, 1):.4f} ms each, {k3_ms / wall / 1e3:.1%} of the decode's wall)"
            )
    # the replays' K4 kernels are in the captured trace: as many as eagerly
    assert len(set(k4_traced.values())) <= 1, (f"[{tag}] K4 calls in the traces", k4_traced)
    graph_line(tag, model, cache_before)
    return {**medians, "launches": launches}


# the eviction gate's vocab-sized fillers, at least this many on each stream
GATE_FILLERS = 300


def phase_eviction_gate(model) -> None:
    """A captured step must own every tensor it reads that its capture did
    not allocate: a CUDA graph reads by address and keeps nothing alive.
    A bf16 greedy decode and a beam-5 decode of the profile's batch are
    captured (or replay the profile's entry); then the masks' shared cache
    is cleared (``filters._id_mask.cache_clear``, where ``_id_mask`` has
    one), the garbage collected, and [V] bool tensors filled
    with True are allocated on the current stream and on the decoder's
    capture stream, as many as the small pool's free bytes could hold
    (at least GATE_FILLERS): a freed tensor's bytes go to a filler. Both
    decodes then run again on their entries, every step a replay, and
    must give the uncaptured decode's bits."""
    import gc
    import math

    import numpy as np
    import torch

    from whisperx_tpu_torch.asr import warmup_audio
    from whisperx_tpu_torch.audio import log_mel_batch
    from whisperx_tpu_torch.decoding import DecodingOptions
    from whisperx_tpu_torch.decoding import filters
    from whisperx_tpu_torch.decoding.decode import decode_dispatch
    from whisperx_tpu_torch.decoding.step_graph import graph_cache

    mels = log_mel_batch(np.stack([warmup_audio(30.0)] * PROFILE_BATCH), model.dims.n_mels, device="cuda")
    cases = {
        "greedy": DecodingOptions(language="en", sample_len=PROFILE_STEPS, kv_quant=True),
        "beam 5": DecodingOptions(language="en", sample_len=PROFILE_STEPS, kv_quant=True, beam_size=5),
    }
    cache = graph_cache(model.decoder)

    def decode(opts, eager=False):
        out = decode_outputs(decode_dispatch(model, mels, opts, _eager=eager))
        torch.cuda.synchronize()
        return out

    want = {label: decode(opts, eager=True) for label, opts in cases.items()}
    for opts in cases.values():
        decode(opts)  # a new entry's warm-up and capture, or a replay of the profile's
    clear = getattr(filters._id_mask, "cache_clear", None)
    if clear is not None:
        clear()
    gc.collect()
    stats = torch.cuda.memory_stats()
    free_small = stats["reserved_bytes.small_pool.current"] - stats["allocated_bytes.small_pool.current"]
    vocab = model.dims.n_vocab
    block = -(-vocab // 512) * 512  # the allocator rounds a small block up to 512 bytes
    per_stream = max(GATE_FILLERS, math.ceil(free_small / block) + 1)
    fillers = []
    for stream in (torch.cuda.current_stream(), cache._stream):
        with torch.cuda.stream(stream):
            fillers += [torch.ones(vocab, dtype=torch.bool, device="cuda") for _ in range(per_stream)]
    torch.cuda.synchronize()
    before = cache.stats()
    verdicts, steps = {}, 0
    for label, opts in cases.items():
        got = decode(opts)
        steps += int(got[-1])
        verdicts[label] = all(torch.equal(a, b) for a, b in zip(got, want[label]))
        verdict = "the uncaptured decode's bits" if verdicts[label] else "BITS DIFFER"
        print(
            f"[gate] {label}: {int(got[-1])} steps replayed after the mask cache was cleared and "
            f"{len(fillers)} [{vocab}] fillers of True were allocated ({per_stream} on each of 2 "
            f"streams; {free_small / 2**20:.1f} MiB free in the small pool): {verdict}"
        )
    now = cache.stats()
    assert now["captures"] == before["captures"], ("[gate] the decodes captured again", before, now)
    assert now["replays"] - before["replays"] == steps > 0, (before, now, steps)
    del fillers
    assert all(verdicts.values()), ("[gate] a replay read memory its entry does not own", verdicts)


def phase_cross_decode_step(model) -> None:
    """One decode step's logits through K3 (the default route of a bf16
    step) against the einsum route (``einsum_route``), on the profile's
    batch: the same prefill, then one t_new = 1 pass each way. The routes differ in where P is rounded to bf16 (each
    512-key tile's running max against the full row's max) and in the
    kernel's query rounding to bf16 (the model is bf16 already); both then
    go through 32 bf16 layers. Tolerance: STEP_LOGIT_TOL."""
    import numpy as np
    import torch

    from whisperx_tpu_torch.asr import warmup_audio
    from whisperx_tpu_torch.audio import log_mel_batch
    from whisperx_tpu_torch.models.whisper.model import (
        KVCache,
        decoder_forward,
        encoder_forward,
        precompute_cross_kv,
        quantize_kv,
    )
    from whisperx_tpu_torch.ops.cross_attention_decode import cross_attention_decode

    dims = model.dims
    mels = log_mel_batch(np.stack([warmup_audio(30.0)] * PROFILE_BATCH), dims.n_mels, device="cuda")
    with torch.inference_mode():
        feats = encoder_forward(model.encoder, mels.to(model.dtype), dims.n_audio_head)
        ck, cv = precompute_cross_kv(model.decoder, feats, dims.n_text_head)
        shape = (PROFILE_BATCH, 64, dims.n_text_head, dims.n_text_state // dims.n_text_head)
        cache = KVCache(
            [torch.zeros(shape, dtype=model.dtype, device="cuda") for _ in range(dims.n_text_layer)],
            [torch.zeros(shape, dtype=model.dtype, device="cuda") for _ in range(dims.n_text_layer)],
            [quantize_kv(x) for x in ck], [quantize_kv(x) for x in cv],
        )
        prefix = torch.tensor([[50258, 50259, 50360]] * PROFILE_BATCH, device="cuda")
        decoder_forward(model.decoder, prefix, cache, 0, dims.n_text_head)
        step = torch.full((PROFILE_BATCH, 1), 50365, device="cuda")
        cross_attention_decode.launches = 0
        with einsum_route():
            einsum = decoder_forward(model.decoder, step, cache, 3, dims.n_text_head)
        torch.cuda.synchronize()
        assert cross_attention_decode.launches == 0
        kernel = decoder_forward(model.decoder, step, cache, 3, dims.n_text_head)
        torch.cuda.synchronize()
        assert cross_attention_decode.launches == dims.n_text_layer
    err = (kernel - einsum).abs().max().item()
    same = (kernel.argmax(-1) == einsum.argmax(-1)).float().mean().item()
    spread = einsum.std().item()
    ok = math.isfinite(err) and err <= STEP_LOGIT_TOL
    print(
        f"[profile cross-decode] one step's logits, K3 vs einsum: max_abs_err {err:.4f} "
        f"(tol {STEP_LOGIT_TOL:g}; logit std {spread:.3f}); same argmax in {same:.0%} of rows; "
        f"K3 launches {dims.n_text_layer} {'ok' if ok else 'FAIL'}"
    )
    if not ok:
        raise AssertionError(f"K3 step logits: max_abs_err {err} > {STEP_LOGIT_TOL}")


def phase_transcribe_many(pipe, k3: dict) -> None:
    """``transcribe_many`` of three requests of synthetic speech (lengths
    MANY_AUDIO_S, seeds 3-5, the second's language detected) through the
    main path's large-v3 pipeline (bf16, whose greedy steps take K3), with
    the ladder SHORT_LADDER. The counts are reset just before and read just
    after: K3 once per decoder layer per sampled step (the prefills, with
    t_new > 1, stay on the einsum), K1 32 × the encoder passes (the decodes
    and the one batched language detection)."""
    import torch

    from whisperx_tpu_torch.ops.cross_attention_decode import cross_attention_decode
    from whisperx_tpu_torch.ops.flash_attention import flash_attention
    from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER

    audios = [synth_speech(s, seed=3 + i) for i, s in enumerate(MANY_AUDIO_S)]
    saved = pipe.asr_options
    pipe.asr_options = {**saved, "temperatures": SHORT_LADDER}
    GLOBAL_TRACKER.reset()
    try:
        cross_attention_decode.launches = 0
        flash_attention.launches = 0
        t0 = time.perf_counter()
        results = pipe.transcribe_many(audios, batch_size=8, language=["en", None, "en"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k3_launches, k1_launches = cross_attention_decode.launches, flash_attention.launches
    finally:
        pipe.asr_options = saved
    report = GLOBAL_TRACKER.report()
    counters = dict(GLOBAL_TRACKER.counters)
    n_dec = report["decode"]["calls"]
    steps = int(counters["decode_steps"])
    dims = pipe.model.dims
    assert len(results) == len(audios)
    for r, (audio_s, res) in enumerate(zip(MANY_AUDIO_S, results)):
        assert set(res) == {"segments", "language"}, res
        for seg in res["segments"]:
            assert 0.0 <= seg["start"] < seg["end"] <= audio_s + 1e-6, (r, seg)
    assert k3_launches == dims.n_text_layer * steps > 0, (k3_launches, steps)
    assert k1_launches == dims.n_audio_layer * (n_dec + 1), (k1_launches, n_dec)
    k3["launches"] = k3_launches
    total = sum(MANY_AUDIO_S)
    print(
        f"[many] transcribe_many of {len(audios)} requests ({'/'.join(f'{s:.0f}' for s in MANY_AUDIO_S)} s, "
        f"languages {[r['language'] for r in results]}): {wall:.3f} s, RTF {total / wall:.2f}x; "
        f"segments per request {[len(r['segments']) for r in results]}; {n_dec} decodes, "
        f"{steps} sampled steps; batch fill {counters.get('batch_used', 0):.0f}/"
        f"{counters.get('batch_slots', 0):.0f}; K3 launches {k3_launches} "
        f"(= {dims.n_text_layer} x {steps}); K1 launches {k1_launches} "
        f"(= {dims.n_audio_layer} x ({n_dec} decodes + 1 language detection))"
    )


def phase_sequential() -> None:
    """``load_model("large-v3", vad_method="none")``: the seek loop over
    SEQ_AUDIO_S of synthetic speech at full width, with the ladder
    SHORT_LADDER. Each window's decode is counted (and its steps) through
    ``decode_dispatch``; K1 must have launched 32 × the decodes, and K3
    never (the seek loop keeps the cross-KV in bf16)."""
    import torch

    import whisperx_tpu_torch
    from whisperx_tpu_torch.ops.cross_attention_decode import cross_attention_decode
    from whisperx_tpu_torch.ops.flash_attention import flash_attention

    # the module itself: the package's ``decoding.decode`` is the function
    decode_module = importlib.import_module("whisperx_tpu_torch.decoding.decode")
    pipe = whisperx_tpu_torch.load_model(
        "large-v3", vad_method="none", compute_type="bfloat16",
        asr_options={"temperatures": SHORT_LADDER},
    )
    assert pipe.vad_model is None
    steps = []
    real = decode_module.decode_dispatch

    def counted(*a, **kw):
        h = real(*a, **kw)
        steps.append(h["steps"])
        return h

    decode_module.decode_dispatch = counted
    audio = synth_speech(SEQ_AUDIO_S, seed=6)
    try:
        flash_attention.launches = 0
        cross_attention_decode.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = pipe.transcribe(audio, language="en")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        decode_module.decode_dispatch = real
    k1_launches = flash_attention.launches
    assert k1_launches == pipe.model.dims.n_audio_layer * len(steps) > 0, (k1_launches, steps)
    assert cross_attention_decode.launches == 0
    # as in the JAX package (and OpenAI Whisper), the seek loop does not
    # clamp the last window's timestamps to the audio: segments come in
    # order, and lie inside a 30 s window that starts inside the audio
    starts = [seg["start"] for seg in result["segments"]]
    assert starts == sorted(starts), starts
    for seg in result["segments"]:
        assert 0.0 <= seg["start"] < seg["end"] <= SEQ_AUDIO_S + 30.0, seg
    windows = -(-int(SEQ_AUDIO_S * 100) // 3000)
    print(
        f"[sequential] load_model(large-v3, vad_method=none): {SEQ_AUDIO_S:.0f} s in {wall:.3f} s, "
        f"RTF {SEQ_AUDIO_S / wall:.2f}x; at least {windows} windows; {len(steps)} decodes "
        f"(ladder {SHORT_LADDER}), steps {steps}; {len(result['segments'])} segments; "
        f"K1 launches {k1_launches} (= {pipe.model.dims.n_audio_layer} x {len(steps)})"
    )

    # the seek loop with word timing and the hallucination-silence skip:
    # random weights' segments are anomalous, so evictions re-seek the loop
    # about a second at a time; SEQ_WORDS_SAMPLE_LEN tokens a window bound it
    from whisperx_tpu_torch.decoding.transcribe import transcribe as seq_transcribe

    steps.clear()
    decode_module.decode_dispatch = counted
    flash_attention.launches = 0
    try:
        with count_captures() as cap:
            t0 = time.perf_counter()
            result = seq_transcribe(
                pipe.model, audio, language="en", temperature=0.0, word_timestamps=True,
                hallucination_silence_threshold=2.0, sample_len=SEQ_WORDS_SAMPLE_LEN,
            )
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        decode_module.decode_dispatch = real
    n_layer = pipe.model.dims.n_audio_layer
    assert flash_attention.launches == n_layer * (len(steps) + cap.calls), (flash_attention.launches, steps, cap.calls)
    assert cap.k1 == n_layer * cap.calls and cap.calls <= len(steps)
    # re-seeks after evictions overlap windows, so segments need not come
    # in order here; each lies in a window that starts inside the audio
    for seg in result["segments"]:
        assert seg["seek"] / 100 <= seg["start"] <= seg["end"] <= SEQ_AUDIO_S + 30.0, seg
        for w in seg["words"]:
            assert w["start"] <= w["end"], w
    print(
        f"[sequential] seek loop with word_timestamps=True, hallucination_silence_threshold=2.0, "
        f"sample_len {SEQ_WORDS_SAMPLE_LEN}, greedy: {SEQ_AUDIO_S:.0f} s in {wall:.3f} s; "
        f"{len(steps)} window decodes, {cap.calls} captures; {len(result['segments'])} segments "
        f"kept, {sum(len(seg['words']) for seg in result['segments'])} words; K1 launches "
        f"{flash_attention.launches} (= {n_layer} x ({len(steps)} + {cap.calls}))"
    )
    del pipe
    torch.cuda.empty_cache()


def k4_launches_per_shape(q_blocks, n_dec, steps, batch=8, beams=5, prompt=3, frames=1500, d=1280):
    """K4's launches per shape (M, K, N) in one int8 CLI run, as the code
    implies them: per decode call, 2 per quantized block in
    ``precompute_cross_kv`` (cross key, value) over batch × frames rows, and
    8 per quantized block in every ``decoder_forward`` (self q/k/v/out and
    cross q/out at (d, d), mlp1 at (d, 4d), mlp2 at (4d, d)), which runs once
    for the prefill (batch × beams × prompt rows) and once per step (batch ×
    beams rows)."""
    counts = {(batch * frames, d, d): 2 * q_blocks * n_dec}
    for rows, calls in ((batch * beams * prompt, n_dec), (batch * beams, steps)):
        counts[(rows, d, d)] = 6 * q_blocks * calls
        counts[(rows, d, 4 * d)] = q_blocks * calls
        counts[(rows, 4 * d, d)] = q_blocks * calls
    return counts


def cli_run(compute_type: str, tmp: str) -> dict:
    """``python -m whisperx_tpu_torch clip.wav --model large-v3
    --compute_type <compute_type> ... -f all --highlight_words True`` (beam
    5, one temperature, alignment on where ``WHISPERX_TPU_ALIGN_DIR`` names a
    checkpoint) on CLI_AUDIO_S of seed 2, in-process through the port's own
    parser and orchestrator so that the launch counts can be read. Checks
    the five files of ``-f all`` and the segments, writes the sixth format
    (``aud``) with the port's writer from the CLI's JSON, and returns the
    run's figures."""
    import torch

    from whisperx_tpu_torch import quant
    from whisperx_tpu_torch.__main__ import build_parser
    from whisperx_tpu_torch.audio import save_wav
    from whisperx_tpu_torch.ops.flash_attention import flash_attention
    from whisperx_tpu_torch.ops.quant_matmul import quant_matmul
    from whisperx_tpu_torch.quant import QuantizedLinear
    from whisperx_tpu_torch.transcribe import transcribe_task
    from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER
    from whisperx_tpu_torch.utils.writers import get_writer

    wav = os.path.join(tmp, "clip.wav")
    save_wav(wav, synth_speech(CLI_AUDIO_S, seed=2))
    out_dir = os.path.join(tmp, "out")
    argv = [
        wav, "--model", "large-v3", "--compute_type", compute_type,
        "--vad_method", "energy", "--language", "en", "-f", "all",
        "--highlight_words", "True",
        "--batch_size", "8", "--temperature_increment_on_fallback", "None",
        "-o", out_dir,
    ]
    tag = "cli" if compute_type == "int8" else f"cli {compute_type}"
    print(f"[{tag}] python -m whisperx_tpu_torch {' '.join(argv[1:])}")
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
    # K4's launches by shape, counted around the wrapper
    t0 = time.perf_counter()
    try:
        with k4_by_shape() as shapes:
            pipe = transcribe_task(args, parser)
            torch.cuda.synchronize()
    finally:
        quant.quantize_model = real_quantize
    wall = time.perf_counter() - t0
    assert len(quantize_s) == 1, quantize_s

    model = pipe.model
    quantized = {
        name: mod for name, mod in model.named_modules() if isinstance(mod, QuantizedLinear)
    }
    bits = int(compute_type[3:])
    assert all(p.is_cuda and p.dtype == torch.bfloat16 for p in model.parameters())
    assert all(m.qw.is_cuda and m.qw.dtype == torch.int8 and m.bits == bits for m in quantized.values())
    q_blocks = {name.split(".")[2] for name in quantized}
    n_layer = model.dims.n_text_layer
    assert len(quantized) == 10 * len(q_blocks) and len(q_blocks) == n_layer - 2, q_blocks
    assert str(n_layer - 1) not in q_blocks and "0" not in q_blocks

    report = GLOBAL_TRACKER.report()
    counters = dict(GLOBAL_TRACKER.counters)
    n_dec = report["decode"]["calls"]
    k1_launches = flash_attention.launches
    assert k1_launches == model.dims.n_audio_layer * n_dec > 0, (k1_launches, n_dec)

    for ext in ("txt", "srt", "vtt", "tsv", "json"):
        assert os.path.getsize(os.path.join(out_dir, f"clip.{ext}")) >= 0
    with open(os.path.join(out_dir, "clip.json")) as f:
        result = json.load(f)
    get_writer("aud", out_dir)(result, wav, {})
    assert os.path.isfile(os.path.join(out_dir, "clip.aud"))
    assert result["language"] == "en" and isinstance(result["segments"], list)
    # alignment ran (phase 4c's checkpoint): words, and highlighted SRT
    assert result["segments"] and result["word_segments"], result
    with open(os.path.join(out_dir, "clip.srt")) as f:
        assert "<u>" in f.read()
    for seg in result["segments"]:
        assert 0.0 <= seg["start"] <= seg["end"] <= CLI_AUDIO_S + ALIGN_END_SLACK_S, seg
    for stage, st in report.items():
        print(
            f"[{tag}] stage {stage}: calls {st['calls']} total {st['total_s']:.4f} s "
            f"min {st['min_s']:.4f} s max {st['max_s']:.4f} s"
        )
    figures = {
        "pipe": pipe, "quantized": quantized, "q_blocks": len(q_blocks), "n_dec": n_dec,
        "steps": int(counters["decode_steps"]), "k1": k1_launches, "k4": quant_matmul.launches,
        "k4_by_shape": shapes.counts(), "wall": wall, "quantize_s": quantize_s[0],
        "transcription": sum(st["total_s"] for st in report.values()),
        "peak": torch.cuda.max_memory_allocated(),
    }
    print(
        f"[{tag}] {CLI_AUDIO_S:.0f} s audio: transcription {figures['transcription']:.3f} s, RTF "
        f"{CLI_AUDIO_S / figures['transcription']:.2f}x; whole CLI (load, host quantization "
        f"{figures['quantize_s']:.2f} s, transcription, writers) {wall:.3f} s; "
        f"{len(result['segments'])} aligned segments, {len(result['word_segments'])} words; "
        f"{n_dec} decodes, {figures['steps']} decode steps "
        f"(beam 5, {counters.get('batch_used', 0):.0f}/{counters.get('batch_slots', 0):.0f} "
        f"batch slots); six formats written; K1 launches {k1_launches} "
        f"(= {model.dims.n_audio_layer} x {n_dec}); peak memory {figures['peak'] / 2**30:.2f} GiB"
    )
    return figures


def phase_cli(k4: dict, k4_shapes: list):
    """The int8 CLI at full large-v3 width with random weights (``cli_run``).
    K4's launches, counted per shape, must be what ``k4_launches_per_shape``
    derives from the code; with ``k4_shapes`` (phase 3's time per shape),
    K4's device time per CLI run against its floor, Σ launches × ms beside
    Σ launches × bound. Returns the int8 model and the run's figures."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        run = cli_run("int8", tmp)
    n_dec, steps, q_blocks = run["n_dec"], run["steps"], run["q_blocks"]
    k4_launches, by_shape = run["k4"], run["k4_by_shape"]
    expected = q_blocks * (2 * n_dec + 8 * (n_dec + steps))
    assert k4_launches == expected > 0, (k4_launches, expected, n_dec, steps)
    per_shape = k4_launches_per_shape(q_blocks, n_dec, steps)
    assert by_shape == per_shape and sum(per_shape.values()) == expected, (by_shape, per_shape)
    k4["launches"] = k4_launches
    print(
        f"[cli] K4 launches {k4_launches} (= {q_blocks} x (2 x {n_dec} + 8 x ({n_dec} + {steps}))), "
        "every int8 decoder linear's"
    )

    times = {(r["m"], r["k"], r["n"]): r for r in k4_shapes}
    if times:  # phase 3's time per shape (not run by the sub-runs)
        device_ms = floor_ms = 0.0
        for shape, n_launch in sorted(per_shape.items()):
            r = times[shape]
            device_ms += n_launch * r["ms"]
            floor_ms += n_launch * r["bound_ms"]
            print(
                f"[cli] K4 M={shape[0]} K={shape[1]} N={shape[2]} ({r['regime']}): {n_launch} launches "
                f"x {r['ms']:.4f} ms = {n_launch * r['ms']:.3f} ms (bound {n_launch * r['bound_ms']:.3f} ms)"
            )
        print(
            f"[cli] K4 per CLI run: sum of launches x ms {device_ms:.3f} ms against sum of launches x "
            f"bound {floor_ms:.3f} ms ({device_ms / floor_ms:.1f}x its floor)"
        )

    # the beam step's self-KV reorder at this run's shape: every layer's
    # cache [B·K, cache_len, H, Dh] gathered by source beam, once per step
    model = run.pop("pipe").model
    rows, dims = 8 * 5, model.dims
    shape = (rows, 256, dims.n_text_head, dims.n_text_state // dims.n_text_head)
    caches = [torch.zeros(shape, dtype=torch.bfloat16, device="cuda") for _ in range(2 * dims.n_text_layer)]
    idx = torch.randint(0, rows, (rows,), device="cuda")
    reorder_ms = cuda_ms(lambda: [c.index_select(0, idx) for c in caches], iters=5, warmup=1)
    gb = sum(c.numel() * c.element_size() for c in caches) / 1e9
    print(
        f"[cli] self-KV reorder per beam step: {gb:.3f} GB read and written "
        f"({2 * dims.n_text_layer} x {list(shape)} bf16) in {reorder_ms:.3f} ms"
    )
    del caches, run["quantized"]
    torch.cuda.empty_cache()
    return model, run


def phase_cli_int4(int8: dict) -> None:
    """The CLI's ``--compute_type int4`` at full large-v3 width
    (``cli_run``): int4 has no kernel in either package (each product
    dequantizes, then multiplies), so K4 must launch 0 times, and K1 32
    times per encoder pass; (a) every int4 ``QuantizedLinear``'s
    ``dequantize`` on the card equals the same codes' and scales' on the
    CPU, bit for bit; (b) the decode profile of phase 6 with 5 beams,
    captured against uncaptured: the same bits, equal launches, K4 at 0;
    (c) ms per step, the CLI's wall and peak memory printed beside the int8
    run's (``int8``: ``phase_cli``'s figures and its profile's)."""
    import torch

    from whisperx_tpu_torch.quant import QuantizedLinear, dequantize

    with tempfile.TemporaryDirectory() as tmp:
        run = cli_run("int4", tmp)
    assert run["k4"] == 0 and run["k4_by_shape"] == {}, ("[cli int4] K4 launched", run["k4"])
    t0 = time.perf_counter()
    for name, m in run["quantized"].items():
        on_cpu = QuantizedLinear(m.qw.cpu(), m.scale.cpu(), bits=4, group_size=m.group_size)
        assert torch.equal(dequantize(m).cpu(), dequantize(on_cpu)), f"[cli int4] dequantize of {name}"
    print(
        f"[cli int4] dequantize of all {len(run['quantized'])} int4 decoder linears (bf16, as the "
        f"products take them): the card's bits equal the CPU's ({time.perf_counter() - t0:.1f} s); "
        f"K4 launches 0"
    )
    model = run.pop("pipe").model
    del run["quantized"]
    profile = phase_decode_profile(model, "profile int4", beam_size=5)
    assert profile["launches"]["K4"] == 0, profile
    print(
        f"[cli int4] against int8 in this run: CLI wall {run['wall']:.3f} s (int8 {int8['wall']:.3f}), "
        f"transcription {run['transcription']:.3f} s (int8 {int8['transcription']:.3f}), host "
        f"quantization {run['quantize_s']:.2f} s (int8 {int8['quantize_s']:.2f}), peak memory "
        f"{run['peak'] / 2**30:.2f} GiB (int8 {int8['peak'] / 2**30:.2f}); beam-5 ms per step captured "
        f"{profile['captured']:.3f} (int8 {int8['captured']:.3f}), uncaptured "
        f"{profile['uncaptured']:.3f} (int8 {int8['uncaptured']:.3f})"
    )
    del model
    torch.cuda.empty_cache()


def phase_float32() -> None:
    """``load_model("large-v3", compute_type="float32", vad_method="energy",
    batch_size=8).transcribe`` of F32_AUDIO_S of the main path's synthetic
    speech (seed 1) at the default temperatures: (a) every K1 launch is on
    its f32 route (the wrapper's inputs are f32: a shim around
    ``wholek_attention`` records their dtype) and there are 32 per encoder
    pass, and K3 never launches (an f32 query keeps the einsum); (b) the
    decode profile of phase 5 for the f32 model, greedy, captured against
    uncaptured: the same bits and launches, K3 none; (c) wall, ms per step
    and peak memory printed."""
    import torch

    import whisperx_tpu_torch
    from whisperx_tpu_torch.ops import flash_attention as fa
    from whisperx_tpu_torch.ops.cross_attention_decode import cross_attention_decode
    from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER

    t0 = time.perf_counter()
    pipe = whisperx_tpu_torch.load_model("large-v3", compute_type="float32", vad_method="energy", batch_size=8)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    assert all(p.is_cuda and p.dtype == torch.float32 for p in pipe.model.parameters())
    audio = synth_speech(F32_AUDIO_S, seed=1)
    real, dtypes = fa.wholek_attention, []

    def recorded(q, *args, **kwargs):
        dtypes.append(q.dtype)
        return real(q, *args, **kwargs)

    GLOBAL_TRACKER.reset()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = 0
    cross_attention_decode.launches = 0
    fa.wholek_attention = recorded
    t0 = time.perf_counter()
    try:
        result = pipe.transcribe(audio, language="en")
        torch.cuda.synchronize()
    finally:
        fa.wholek_attention = real
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    report, counters = GLOBAL_TRACKER.report(), dict(GLOBAL_TRACKER.counters)
    passes, launches = report["decode"]["calls"], fa.flash_attention.launches
    assert launches == pipe.model.dims.n_audio_layer * passes > 0, (launches, passes)
    assert len(dtypes) == launches and set(dtypes) == {torch.float32}, (len(dtypes), set(dtypes))
    # an f32 query keeps the einsum: K3 would round it to bf16
    assert cross_attention_decode.launches == 0, cross_attention_decode.launches
    for seg in result["segments"]:
        assert 0.0 <= seg["start"] < seg["end"] <= F32_AUDIO_S + 1e-6, seg
    steps = int(counters.get("decode_steps", 0))
    print(
        f"[f32] load_model large-v3 float32 {load_s:.2f} s; {F32_AUDIO_S:.0f} s audio in {wall:.3f} s: RTF "
        f"{F32_AUDIO_S / wall:.2f}x; {len(result['segments'])} segments; encoder passes {passes}; K1 launches "
        f"{launches} (= {pipe.model.dims.n_audio_layer} x {passes}), every one on the f32 route; K3 launches "
        f"{cross_attention_decode.launches}; decode steps "
        f"{steps} ({wall / max(steps, 1) * 1e3:.3f} ms of wall a step); peak memory {peak / 2**30:.2f} GiB"
    )
    profile = phase_decode_profile(pipe.model, "profile f32")
    print(
        f"[f32] greedy batch {PROFILE_BATCH} ms per step captured {profile['captured']:.3f}, uncaptured "
        f"{profile['uncaptured']:.3f}"
    )
    del pipe
    torch.cuda.empty_cache()


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
    from whisperx_tpu_torch.decoding.speculative import SpeculativeDecoder, truncated_self_draft
    from whisperx_tpu_torch.decoding.transcribe import transcribe as seq_transcribe
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
    # the seek loop over the whole file (no VAD), greedy
    keys = ("id", "seek", "start", "end", "text", "tokens", "temperature")
    seq = {
        dev: [
            {k: seg[k] for k in keys}
            for seg in seq_transcribe(p.model, audio, language="en", temperature=0.0)["segments"]
        ]
        for dev, p in pipes.items()
    }
    assert seq["cpu"] == seq["cuda"] and seq["cuda"], seq
    print(
        f"[small] test-nano f32 seek loop: {len(seq['cuda'])} identical segments "
        f"({sum(len(s['tokens']) for s in seq['cuda'])} tokens, windows at seeks "
        f"{sorted({s['seek'] for s in seq['cuda']})}) on cuda and cpu"
    )
    # word timing: the same words, starts and ends (probabilities from two
    # devices' softmax, within 1e-5)
    words, probs = {}, {}
    for dev, p in pipes.items():
        out = p.transcribe(audio, language="en", temperatures=(0.0,), word_timestamps=True)
        words[dev] = [[(w["word"], w["start"], w["end"]) for w in s["words"]] for s in out["segments"]]
        probs[dev] = [w["probability"] for s in out["segments"] for w in s["words"]]
    assert words["cpu"] == words["cuda"] and any(words["cuda"]), words
    prob_err = max(abs(a - b) for a, b in zip(probs["cpu"], probs["cuda"]))
    assert prob_err <= 1e-5, prob_err
    print(
        f"[small] test-nano f32 word timing: {sum(map(len, words['cuda']))} identical words "
        f"(text, start, end) on cuda and cpu; probabilities within {prob_err:.2e}"
    )
    # the JAX package's XLA-route switches raise on CUDA (no such route here)
    os.environ["WHISPERX_TPU_FLASH"] = "0"
    try:
        pipes["cuda"].transcribe(audio[:16000 * 5], language="en", temperatures=(0.0,))
        raise AssertionError("WHISPERX_TPU_FLASH=0 did not raise on CUDA")
    except ValueError as e:
        assert "WHISPERX_TPU_FLASH" in str(e), e
    finally:
        del os.environ["WHISPERX_TPU_FLASH"]

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
    # speculative decoding: a self:1 draft (γ 2) gives the greedy tokens of
    # the same device with the cross-KV unquantized, as the speculative
    # path keeps it. Across devices that greedy decode may differ at an f32
    # near-tie of random weights (the int8 cross-KV's above does not), so
    # cuda against cpu is printed
    spec_toks, rates = {}, {}
    for dev, p in pipes.items():
        spec = SpeculativeDecoder(p.model, truncated_self_draft(p.model, 1), gamma=2)
        opts = DecodingOptions(language="en")
        spec_toks[dev] = [r.tokens for r in spec.decode_batch_finalize(spec.decode_batch_dispatch(mels.to(dev), opts))]
        greedy = [r.tokens for r in decode(p.model, mels.to(dev), DecodingOptions(language="en", kv_quant=False))]
        assert spec_toks[dev] == greedy, (dev, spec_toks[dev], greedy)
        rates[dev] = spec.stats.acceptance_rate
    print(
        f"[small] test-nano f32 speculative (self:1, gamma 2): {len(chunks)} chunks with the greedy "
        f"tokens of the same device ({sum(map(len, spec_toks['cuda']))} tokens on cuda; acceptance "
        f"{rates['cuda']:.3f} cuda, {rates['cpu']:.3f} cpu); cuda tokens equal the cpu's: "
        f"{spec_toks['cuda'] == spec_toks['cpu']} (printed, not asserted)"
    )
    # the pyannote VAD (energy scores: no segmentation checkpoint) and the
    # hybrid one (the energy fallback): the same segments on both devices
    for method in ("pyannote", "hybrid"):
        vad_pipes = {}
        for dev in ("cpu", "cuda"):
            vad_pipes[dev] = whisperx_tpu_torch.load_model(
                "test-nano", device=dev, vad_method=method, compute_type="float32"
            )
            vad_pipes[dev].model = pipes[dev].model
        out = {dev: p.transcribe(audio, language="en", temperatures=(0.0,)) for dev, p in vad_pipes.items()}
        assert out["cpu"] == out["cuda"] and out["cuda"]["segments"], (method, out)
        print(f"[small] test-nano f32 vad_method={method}: {len(out['cuda']['segments'])} identical segments on cuda and cpu")

    os.environ["WHISPERX_TPU_NO_PALLAS_QUANT"] = "1"
    try:
        decode(models["cuda"], mels.to("cuda")[:1], DecodingOptions(language="en", sample_len=4))
        raise AssertionError("WHISPERX_TPU_NO_PALLAS_QUANT did not raise on CUDA")
    except ValueError as e:
        assert "WHISPERX_TPU_NO_PALLAS_QUANT" in str(e), e
    finally:
        del os.environ["WHISPERX_TPU_NO_PALLAS_QUANT"]
    print("[small] WHISPERX_TPU_FLASH=0 and WHISPERX_TPU_NO_PALLAS_QUANT raise ValueError on cuda")
    phase_small_diarization(pipes["cpu"].model, audio)
    phase_small_serving({dev: p.model for dev, p in pipes.items()})


def phase_small_diarization(model, audio) -> None:
    """test-nano f32 (the CPU model's weights, written with
    ``save_checkpoint``) with diarization on both devices: the CLI with
    ``--diarize`` and with ``--diarize --diarize_clustering spectral`` writes
    the same files, and its encoder passes launch K1 n_audio_layer times
    each; ``load_pipeline(..., diarize=True)`` gives the same result dict."""
    import dataclasses

    import whisperx_tpu_torch
    from whisperx_tpu_torch.__main__ import build_parser
    from whisperx_tpu_torch.audio import save_wav
    from whisperx_tpu_torch.convert.checkpoint import save_checkpoint
    from whisperx_tpu_torch.ops.flash_attention import flash_attention
    from whisperx_tpu_torch.transcribe import transcribe_task
    from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER

    clip = audio[: 16000 * 20]
    with tempfile.TemporaryDirectory() as root:
        ckpt = os.path.join(root, "nano")
        save_checkpoint(ckpt, model, {"name": "test-nano", "family": "whisper",
                                      "dims": dataclasses.asdict(model.dims)})
        wav = os.path.join(root, "clip.wav")
        save_wav(wav, clip)
        for extra in (["--diarize"], ["--diarize", "--diarize_clustering", "spectral"]):
            files = {}
            for dev in ("cuda", "cpu"):
                out = os.path.join(root, f"{dev}_{len(extra)}")
                argv = [wav, "--model", ckpt, "--device", dev, "--compute_type", "float32",
                        "--vad_method", "energy", "--language", "en", "--no_align", "-f", "all",
                        "--temperature_increment_on_fallback", "None", "-o", out, *extra]
                parser = build_parser()
                GLOBAL_TRACKER.reset()
                flash_attention.launches = 0
                transcribe_task(parser.parse_args(argv).__dict__, parser)
                if dev == "cuda":
                    passes = GLOBAL_TRACKER.report()["decode"]["calls"]
                    k1 = flash_attention.launches
                    assert k1 == model.dims.n_audio_layer * passes > 0, (k1, passes)
                files[dev] = {f: open(os.path.join(out, f), "rb").read() for f in sorted(os.listdir(out))}
            assert files["cuda"] == files["cpu"] and len(files["cuda"]) == 5, sorted(files["cuda"])
            tagged = json.loads(files["cuda"]["clip.json"])["segments"]
            assert tagged and all("speaker" in seg for seg in tagged), tagged
            print(
                f"[small] test-nano f32 CLI {' '.join(extra)}: the same {len(files['cuda'])} files on cuda "
                f"and cpu; {len(tagged)} segments, speakers {sorted({seg['speaker'] for seg in tagged})}; "
                f"K1 launches {k1} (= {model.dims.n_audio_layer} x {passes} encoder passes)"
            )
        results = {
            dev: whisperx_tpu_torch.load_pipeline(
                ckpt, device=dev, compute_type="float32", vad_method="energy", language="en",
                align=False, diarize=True, asr_options={"temperatures": (0.0,)},
            )(clip)
            for dev in ("cuda", "cpu")
        }
    assert results["cuda"] == results["cpu"] and results["cuda"]["segments"], results
    assert all("speaker" in seg for seg in results["cuda"]["segments"])
    print(
        f"[small] test-nano f32 load_pipeline(diarize=True): the same result on cuda and cpu "
        f"({len(results['cuda']['segments'])} segments with speakers)"
    )


def spec_run(pipe, audio, label, eager: bool = False, **options):
    """One greedy transcription of ``audio`` through ``pipe.transcribe``
    (one temperature, the per-call ``options``): the decode stage's wall
    time, the tracker's counters, each real row's tokens and the K1
    launches. Speculative with a ``draft_model`` in ``options``: then also
    each batch's device outputs (tokens, n, sum_logprob, no-speech
    probability, proposed, accepted, target passes), and ``eager`` runs its
    iterations uncaptured (``decode_batch_dispatch(..., _eager=True)``, the
    yardstick); otherwise each iteration replays a captured graph."""
    import functools

    import torch

    from whisperx_tpu_torch import asr
    from whisperx_tpu_torch.decoding import speculative
    from whisperx_tpu_torch.ops.flash_attention import flash_attention
    from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER

    spec = options.get("draft_model") is not None
    # each batch's results, kept around the finalize the pipeline calls (a
    # function of ``asr``, or the decoder's method: the handle comes last)
    owner, name = (
        (speculative.SpeculativeDecoder, "decode_batch_finalize") if spec else (asr, "decode_finalize")
    )
    real, results, outputs = getattr(owner, name), [], []

    def kept(*a):
        out = real(*a)
        results.extend(out)
        if spec:
            outputs.append([t.cpu() for t in a[-1]["device"]])
        return out

    Spec = speculative.SpeculativeDecoder
    dispatch = Spec.decode_batch_dispatch
    GLOBAL_TRACKER.reset()
    flash_attention.launches = 0
    setattr(owner, name, kept)
    if eager:
        Spec.decode_batch_dispatch = functools.partialmethod(dispatch, _eager=True)
    try:
        t0 = time.perf_counter()
        result = pipe.transcribe(audio, language="en", temperatures=(0.0,), **options)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        setattr(owner, name, real)
        Spec.decode_batch_dispatch = dispatch
    report, counters = GLOBAL_TRACKER.report(), dict(GLOBAL_TRACKER.counters)
    rows = int(counters["batch_used"])  # the zero rows padding the last batch come last
    tokens = [r.tokens for r in results][:rows]
    decode_s = report["decode"]["total_s"]
    emitted = sum(len(t) + 1 for t in tokens)  # + the EOT or the cut
    out = {
        "wall": wall, "decode_s": decode_s, "decodes": report["decode"]["calls"],
        "steps": int(counters.get("decode_steps", 0)), "tokens": tokens, "rows": rows,
        "emitted": emitted, "k1": flash_attention.launches, "result": result,
        "ms_per_token": decode_s / (emitted / rows) * 1e3, "outputs": outputs,
        "ms_per_iteration": decode_s / max(int(counters.get("decode_steps", 0)), 1) * 1e3,
        "proposed": int(counters.get("spec_proposed", 0)),
        "accepted": int(counters.get("spec_accepted", 0)),
        "passes": int(counters.get("spec_target_passes", 0)),
    }
    acc = out["accepted"] / out["proposed"] if out["proposed"] else float("nan")
    print(
        f"[spec] {label}: decode {decode_s:.3f} s over {out['decodes']} decode(s) of {rows} real rows "
        f"({out['steps']} {'iterations' if spec else 'steps'}); tokens emitted {emitted} "
        f"({emitted / rows:.1f} a row); ms per emitted token (decode wall / tokens a row) "
        f"{out['ms_per_token']:.3f}; "
        + (f"ms per iteration {out['ms_per_iteration']:.3f} ({'uncaptured' if eager else 'captured'}); " if spec else "")
        + (
            f"target passes {out['passes']}, proposed {out['proposed']}, accepted "
            f"{out['accepted']} (acceptance {acc:.4f}); "
            if spec else ""
        )
        + f"transcribe wall {wall:.3f} s; K1 launches {out['k1']}"
    )
    return out


def same_spec_bits(label: str, runs: list) -> None:
    """Every run's batches give the first run's bits: tokens, n,
    sum_logprob, no-speech probability, proposed, accepted, target passes."""
    import torch

    ref = runs[0]["outputs"]
    for run in runs[1:]:
        assert len(run["outputs"]) == len(ref) and all(
            torch.equal(a, b) for got, want in zip(run["outputs"], ref) for a, b in zip(got, want)
        ), f"[spec] {label}: a run's outputs differ from the first run's"


def phase_speculative(pipe) -> None:
    """Speculative decoding at full large-v3 width (bf16, random weights,
    seed 0) on the main path's 120 s (seed 1), batch 8, one temperature:
    ``draft_model="self:4"``, ``spec_gamma=4`` through ``transcribe``,
    each iteration a replay of a captured graph (the target's speculative
    graph cache), three times in turns: captured, uncaptured (``_eager``,
    the yardstick), captured; the three must give the same bits (every
    batch's tokens, n, sum_logprob, proposed, accepted, target passes).
    Then the same with a ``zero_tail_model(model, 4)`` target (its
    ``self:4`` draft agrees exactly: acceptance ≈ 1, the mechanism's upper
    bound), captured; and a plain greedy decode of the same batch with
    ``kv_quant=False`` (the cross-KV the speculative path keeps). K1
    launches 32 × the decodes (the ``self:N`` draft shares the target's
    encoder). ``[graph]`` lines: captures, replays, static bytes; the
    phase's peak memory. The share of rows whose bf16 tokens equal
    greedy's is printed, not asserted: random weights flip bf16 ties."""
    import torch

    from whisperx_tpu_torch.asr import TranscriptionPipeline
    from whisperx_tpu_torch.decoding.speculative import SPEC_GRAPHS, zero_tail_model
    from whisperx_tpu_torch.decoding.step_graph import graph_cache

    audio = synth_speech(MAIN_AUDIO_S, seed=1)
    model = pipe.model
    n_layer = model.dims.n_audio_layer
    torch.cuda.reset_peak_memory_stats()
    before = graph_cache(model.decoder, SPEC_GRAPHS).stats()
    runs = []
    for mode in ("captured", "uncaptured", "captured"):
        runs.append(spec_run(pipe, audio, f"self:4, gamma 4, {mode}", eager=mode == "uncaptured",
                             draft_model="self:4", spec_gamma=4))
    same_spec_bits("self:4 captured and uncaptured", runs)
    graphs = graph_line("spec self:4 (two captured runs)", model, before, SPEC_GRAPHS)
    assert graphs["replays"] - before["replays"] > 0 and graphs["captures"] - before["captures"] == 1
    spec, eager = runs[2], runs[1]
    greedy = spec_run(pipe, audio, "plain greedy, kv_quant=False", kv_quant=False)
    zt_pipe = TranscriptionPipeline(
        model=zero_tail_model(model, 4), vad_model=pipe.vad_model, batch_size=8
    )
    zero = spec_run(zt_pipe, audio, "zero-tail target, self:4, gamma 4, captured", draft_model="self:4",
                    spec_gamma=4)
    zt_graphs = graph_line("spec zero-tail", zt_pipe.model, {"captures": 0, "replays": 0}, SPEC_GRAPHS)
    assert zt_graphs["replays"] > 0
    print(f"[spec] phase peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; a speculative "
          f"entry's static buffers {graphs['static_bytes'] / max(graphs['entries'], 1) / 2**30:.3f} GiB")
    del zt_pipe
    torch.cuda.empty_cache()
    for run in (*runs, zero):
        assert run["k1"] == n_layer * run["decodes"] > 0, (run["k1"], run["decodes"])
        assert run["passes"] > 0 and run["proposed"] == 4 * run["passes"], run
        for seg in run["result"]["segments"]:
            assert 0.0 <= seg["start"] < seg["end"] <= MAIN_AUDIO_S + 1e-6, seg
    assert greedy["k1"] == n_layer * greedy["decodes"] > 0
    assert zero["accepted"] >= 0.9 * zero["proposed"], zero  # exact agreement, up to the budget
    same = sum(a == b for a, b in zip(spec["tokens"], greedy["tokens"]))
    print(
        f"[spec] self:4 captured and uncaptured: the same bits over {len(runs)} runs (tokens, n, "
        f"sum_logprob, proposed, accepted, target passes); ms per emitted token captured "
        f"{runs[0]['ms_per_token']:.3f} and {spec['ms_per_token']:.3f}, uncaptured {eager['ms_per_token']:.3f} "
        f"({eager['ms_per_token'] / spec['ms_per_token']:.3f}x); ms per iteration captured "
        f"{spec['ms_per_iteration']:.3f}, uncaptured {eager['ms_per_iteration']:.3f}"
    )
    print(
        f"[spec] rows whose bf16 tokens equal greedy's (printed, not asserted): {same}/{spec['rows']}; "
        f"ms per emitted token: self:4 {spec['ms_per_token']:.3f}, zero-tail {zero['ms_per_token']:.3f}, "
        f"greedy {greedy['ms_per_token']:.3f} (speculative / greedy: {spec['ms_per_token'] / greedy['ms_per_token']:.3f}x "
        f"and {zero['ms_per_token'] / greedy['ms_per_token']:.3f}x); ms per iteration "
        f"{spec['ms_per_iteration']:.3f} and {zero['ms_per_iteration']:.3f} "
        f"against {greedy['decode_s'] / max(greedy['steps'], 1) * 1e3:.3f} per greedy step; {card_line()}"
    )


def spec_k4_launches(q_target, q_draft, n_dec, iterations, n_init, gamma=4, batch=8, frames=1500, d=1280):
    """K4's launches per shape (M, K, N) in one speculative int8 run, as the
    code implies them: per decode, the target's cross-KV (2 per quantized
    block over batch × frames rows; the ``self:N`` draft reads the target's,
    computing none), the target's prefill (batch × n_init rows) and the
    draft's (batch × (n_init - 1)); per iteration, γ + 1 draft passes of
    one token (γ drafts and the extra write of the last one's K/V) and one
    verify pass of γ + 1 tokens. Each ``decoder_forward`` makes 8 launches
    per quantized block: 6 at (d, d), one at (d, 4d), one at (4d, d)."""
    import collections

    counts = collections.Counter({(batch * frames, d, d): 2 * q_target * n_dec})
    for rows, calls in (
        (batch * n_init, q_target * n_dec),
        (batch * (n_init - 1), q_draft * n_dec),
        (batch, q_draft * (gamma + 1) * iterations),
        (batch * (gamma + 1), q_target * iterations),
    ):
        counts[(rows, d, d)] += 6 * calls
        counts[(rows, d, 4 * d)] += calls
        counts[(rows, 4 * d, d)] += calls
    return dict(counts)


def phase_speculative_int8(model, k4_shapes: list) -> None:
    """Phase 6's int8 large-v3 with a ``self:4`` draft (γ 4) on the CLI's
    60 s (seed 2), one temperature, SPEC_INT8_SAMPLE_LEN tokens a row,
    through ``transcribe``, each iteration a replay of a captured graph,
    then once uncaptured (``_eager``): the same bits; every quantized
    linear through K4, as often per shape as ``spec_k4_launches`` derives
    from the code (draft steps at M = 8, a shape the beam CLI never runs;
    verify passes at M = 40) in both runs, a replay adding what its
    capture recorded; Σ launches × ms over the shapes phase 3 timed against
    Σ launches × bound."""
    from whisperx_tpu_torch.asr import TranscriptionPipeline
    from whisperx_tpu_torch.decoding.speculative import SPEC_GRAPHS
    from whisperx_tpu_torch.decoding.step_graph import graph_cache
    from whisperx_tpu_torch.ops.quant_matmul import quant_matmul
    from whisperx_tpu_torch.quant import QuantizedLinear
    from whisperx_tpu_torch.vad import EnergyVAD

    pipe = TranscriptionPipeline(model=model, vad_model=EnergyVAD(), batch_size=8)
    q_blocks = sorted(
        {int(n.split(".")[2]) for n, m in model.named_modules() if isinstance(m, QuantizedLinear)}
    )
    q_target, q_draft = len(q_blocks), sum(1 for b in q_blocks if b < 4)
    n_init = 3  # <|startoftranscript|><|en|><|transcribe|>
    before = graph_cache(model.decoder, SPEC_GRAPHS).stats()
    runs = []
    for mode in ("captured", "uncaptured"):
        quant_matmul.launches = 0
        with k4_by_shape() as shapes:
            run = spec_run(pipe, synth_speech(CLI_AUDIO_S, seed=2), f"int8, self:4, gamma 4, {mode}",
                           eager=mode == "uncaptured", draft_model="self:4", spec_gamma=4,
                           sample_len=SPEC_INT8_SAMPLE_LEN)
        by_shape = shapes.counts()
        want = spec_k4_launches(q_target, q_draft, run["decodes"], run["steps"], n_init)
        assert dict(by_shape) == want, (mode, dict(by_shape), want)
        assert quant_matmul.launches == sum(want.values()) > 0, mode
        assert run["k1"] == model.dims.n_audio_layer * run["decodes"]
        runs.append(run)
        if mode == "captured":
            graphs = graph_line("spec int8 self:4", model, before, SPEC_GRAPHS)
            assert graphs["replays"] - before["replays"] > 0
    same_spec_bits("int8 self:4 captured and uncaptured", runs)
    captured, eager = runs
    print(
        f"[spec int8] captured and uncaptured: the same bits and K4 launches per shape; ms per emitted "
        f"token {captured['ms_per_token']:.3f} captured, {eager['ms_per_token']:.3f} uncaptured; ms per "
        f"iteration {captured['ms_per_iteration']:.3f} and {eager['ms_per_iteration']:.3f}; {card_line()}"
    )
    times = {(r["m"], r["k"], r["n"]): r for r in k4_shapes}
    device_ms = floor_ms = 0.0
    for shape, n in sorted(want.items()):
        r = times.get(shape)
        timed = f"x {r['ms']:.4f} ms = {n * r['ms']:.3f} ms (bound {n * r['bound_ms']:.3f} ms)" if r else "(shape not timed)"
        if r:
            device_ms += n * r["ms"]
            floor_ms += n * r["bound_ms"]
        print(f"[spec int8] K4 M={shape[0]} K={shape[1]} N={shape[2]}: {n} launches {timed}")
    print(
        f"[spec int8] K4 launches {quant_matmul.launches} (= the code's, per shape; {q_target} "
        f"quantized target blocks, {q_draft} in the draft); over the timed shapes sum of launches x ms "
        f"{device_ms:.3f} ms against sum of launches x bound {floor_ms:.3f} ms"
    )


def make_vad_checkpoints(root: str) -> dict:
    """Silero at ``init_params``' published size (2 × LSTM 64 over 512
    samples) and PyanNet at the default ``PyanNetConfig`` (SincNet 80/60/60,
    4 × biLSTM 128, linears 128/128, 7 classes), random weights from seeded
    ``torch.Generator``s with ``init_params``' distributions, written with
    the port's ``save_checkpoint``; and the same Silero with its head
    sharpened (×300, bias -1), whose probabilities swing across the
    thresholds (the published head's stay within ~0.01 of 0.5), for
    segments that mean something. Returns the paths by name."""
    import dataclasses

    import torch

    from whisperx_tpu_torch.convert.checkpoint import save_checkpoint
    from whisperx_tpu_torch.models import pyannote, silero_vad

    paths = {name: os.path.join(root, name) for name in ("silero", "silero sharp", "pyannote")}
    silero = silero_vad.init_params(torch.Generator("cuda").manual_seed(0))
    save_checkpoint(paths["silero"], silero, {"family": "silero_vad", "name": "seeded"})
    with torch.no_grad():
        silero.head.w.mul_(300.0)
        silero.head.b.sub_(1.0)
    save_checkpoint(paths["silero sharp"], silero, {"family": "silero_vad", "name": "seeded, sharp"})
    cfg = pyannote.PyanNetConfig()
    net = pyannote.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    config = {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(cfg).items()}
    save_checkpoint(
        paths["pyannote"], net,
        {"family": "pyannote_segmentation", "name": "seeded", "config": config},
    )
    return paths


def same_segments(label, got, want, probs, err, thresholds) -> None:
    """CUDA's segments must be the CPU's. A difference is accepted only
    where a score lies within the measured error of a threshold (a flip of
    rounding, printed); any other raises."""
    import numpy as np

    spans = lambda segs: [(round(s.start, 6), round(s.end, 6)) for s in segs]  # noqa: E731
    if spans(got) == spans(want):
        return
    margin = min(float(np.abs(np.asarray(probs) - t).min()) for t in thresholds)
    print(f"[vad] {label}: segments differ; the nearest score is {margin:.3e} from a threshold (error {err:.3e})")
    assert margin <= err, (label, spans(got), spans(want))


def phase_vads() -> None:
    """Both networks over the main path's 120 s (seed 1) on the card:
    device time of the forward by CUDA events; CUDA against CPU (TF32
    off in both): Silero's probabilities within 1e-5, PyanNet's log-scores
    within 1e-4; the same segments; then ``BatchVADProcessor`` over
    ``transcribe_many``'s three requests in one call, against each stream
    alone."""
    import numpy as np
    import torch

    from whisperx_tpu_torch.models.pyannote import forward
    from whisperx_tpu_torch.models.silero_vad import frame_audio, speech_probs
    from whisperx_tpu_torch.vad import BatchVADProcessor, load_vad_model

    audio = synth_speech(MAIN_AUDIO_S, seed=1)
    with tempfile.TemporaryDirectory() as root:
        paths = make_vad_checkpoints(root)
        vads = {
            (name, dev): load_vad_model(
                name.split()[0], model_path=path, device=dev, chunk_size=30.0
            )
            for name, path in paths.items()
            for dev in ("cuda", "cpu")
        }
    # Silero: one stream of 3750 windows; the published head is held to
    # 1e-5, the sharpened one (logits ×300) gives the segments
    for name in ("silero", "silero sharp"):
        models = {dev: vads[(name, dev)].model for dev in ("cuda", "cpu")}
        windows = {dev: frame_audio(torch.from_numpy(audio).to(dev)) for dev in ("cuda", "cpu")}
        ms = cuda_ms(lambda: speech_probs(models["cuda"], windows["cuda"]), iters=5, warmup=2)
        probs = {dev: speech_probs(models[dev], windows[dev]).cpu().numpy() for dev in ("cuda", "cpu")}
        err = float(np.abs(probs["cuda"] - probs["cpu"]).max())
        segs = {dev: vads[(name, dev)]({"waveform": audio}) for dev in ("cuda", "cpu")}
        same_segments(name, segs["cuda"], segs["cpu"], probs["cpu"], err, (0.5, 0.35))
        print(
            f"[vad] {name} (2 x LSTM 64, {windows['cuda'].shape[1]} windows of 512): forward {ms:.3f} ms "
            f"of device time; CUDA against CPU max_abs_err {err:.3e}"
            + (" (tol 1e-5)" if name == "silero" else " (logits x300: printed)")
            + f"; {len(segs['cuda'])} segments on both; probs {probs['cuda'].min():.4f}..{probs['cuda'].max():.4f}"
        )
        assert err <= 1e-5 if name == "silero" else segs["cuda"], (name, err)
    # PyanNet: every 10 s window at a 1 s step in one forward
    vad = vads[("pyannote", "cuda")]
    starts, chunks = vad.windows(audio)
    x = {dev: torch.from_numpy(chunks).to(dev) for dev in ("cuda", "cpu")}
    ms_p = cuda_ms(lambda: forward(vad._model, x["cuda"]), iters=3, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    logs = {dev: forward(vads[("pyannote", dev)]._model, x[dev]).cpu().numpy() for dev in ("cuda", "cpu")}
    peak = torch.cuda.max_memory_allocated() / 2**30
    err_p = float(np.abs(logs["cuda"] - logs["cpu"]).max())
    scores = {dev: vads[("pyannote", dev)]._frame_scores(audio) for dev in ("cuda", "cpu")}
    segs_p = {dev: vads[("pyannote", dev)]({"waveform": audio}) for dev in ("cuda", "cpu")}
    # speech = 1 - exp(log P(silence)): its error is at most the log-score's
    same_segments("pyannote", segs_p["cuda"], segs_p["cpu"], scores["cpu"][0], err_p, (0.5, 0.363))
    print(
        f"[vad] pyannote (PyanNet default: SincNet 80/60/60, 4 x biLSTM 128, linears 128/128, 7 classes): "
        f"{len(starts)} windows of 10 s in one forward, {logs['cuda'].shape[1]} frames each: "
        f"{ms_p:.3f} ms of device time, peak {peak:.2f} GiB; CUDA against CPU log-scores max_abs_err "
        f"{err_p:.3e} (tol 1e-4); {len(segs_p['cuda'])} segments on both; speech scores "
        f"{scores['cuda'][0].min():.3f}..{scores['cuda'][0].max():.3f}"
    )
    assert err_p <= 1e-4 and segs_p["cuda"], err_p
    # the batch processor: transcribe_many's three requests in one call
    streams = [synth_speech(s, seed=3 + i) for i, s in enumerate(MANY_AUDIO_S)]
    proc = BatchVADProcessor(vads[("silero sharp", "cuda")])
    proc.process_batch(streams)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batched = proc.process_batch(streams)
    wall = time.perf_counter() - t0
    sharp = vads[("silero sharp", "cuda")]
    alone = [sharp({"waveform": a}) for a in streams]
    # the rows of the padded batch against each stream alone: cuDNN's
    # recurrence may order its sums by batch size
    t_max = max(-(-len(a) // 512) for a in streams)
    padded = torch.stack([torch.nn.functional.pad(frame_audio(torch.from_numpy(a).cuda())[0],
                                                  (0, 0, 0, t_max - -(-len(a) // 512))) for a in streams])
    rows = speech_probs(sharp.model, padded).cpu().numpy()
    for i, (b, a) in enumerate(zip(batched, alone)):
        p = sharp.speech_probs(streams[i])
        err_b = float(np.abs(rows[i, : len(p)] - p).max())
        same_segments(f"batch row {i}", b, a, p, err_b, (0.5, 0.35))
    print(
        f"[vad] BatchVADProcessor over {len(streams)} streams ({'/'.join(f'{s:.0f}' for s in MANY_AUDIO_S)} s) "
        f"in one call: {wall * 1e3:.3f} ms wall; segments per stream {[len(b) for b in batched]}, "
        f"each stream's as when alone"
    )
    del vads, models, windows, x
    torch.cuda.empty_cache()



def voice(f0: float, duration_s: float, bright: float = 1.0, seed: int = 0, sr: int = 16000):
    """A synthetic voice: a harmonic series with a speaker-specific spectrum
    (the recipe of the test suite's diarization tests)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(duration_s * sr)) / sr
    f = f0 * (1 + 0.02 * np.sin(2 * np.pi * 0.7 * t))
    phase = 2 * np.pi * np.cumsum(f) / sr
    sig = sum((bright ** k / k) * np.sin(k * phase) for k in range(1, 8))
    sig = sig + 0.01 * rng.standard_normal(len(t))
    return (0.3 * sig / np.abs(sig).max()).astype(np.float32)


def two_voices(duration_s: float, seed: int = 0, sr: int = 16000):
    """Two voices (f0 110 and 260 Hz) taking alternating turns of 3-8 s with
    pauses of 0.3-1.0 s: the audio and its turns (start, end, voice)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    parts, truth, t, i = [], [], 0.0, 0
    while duration_s - t >= 3.0:
        dur = float(min(rng.uniform(3.0, 8.0), duration_s - t))
        f0, bright = (110.0, 0.95) if i % 2 == 0 else (260.0, 1.05)
        parts.append(voice(f0, dur, bright, seed=seed * 1000 + i))
        truth.append((t, t + len(parts[-1]) / sr, f"V{i % 2}"))
        t += len(parts[-1]) / sr
        gap = np.zeros(int(min(rng.uniform(0.3, 1.0), duration_s - t) * sr), np.float32)
        parts.append(gap)
        t += len(gap) / sr
        i += 1
    audio = np.concatenate(parts)
    return np.pad(audio, (0, int(duration_s * sr) - len(audio))), truth


class recorded:
    """Inside: a diarization pipeline's embedding backend keeps the windows
    it was given (``.inputs``) and the embeddings it returned."""

    def __init__(self, pipe):
        self.backend, self.inputs, self.outputs = pipe.embedding, None, None

    def __enter__(self):
        real = self.backend.embed

        def embed(windows):
            self.inputs, self.outputs = windows, real(windows)
            return self.outputs

        self.backend.embed = embed  # the instance's attribute shadows the method
        return self

    def __exit__(self, *exc):
        del self.backend.embed


def same_turns(label, got, want) -> None:
    keys = ("start", "end", "speaker")
    rows = lambda table: [tuple(r[k] for k in keys) for r in table]  # noqa: E731
    assert rows(got) == rows(want), (label, rows(got)[:8], rows(want)[:8])


def resnet_ops(cfg, frames: int) -> int:
    """Multiply-adds × 2 of one ResNet window of ``frames`` 10 ms frames: every
    convolution (stem, 3×3 pairs, 1×1 shortcuts) at its output size, and the
    projection."""
    h, w = frames, cfg.n_mels
    macs = h * w * 9 * cfg.channels[0]  # stem, one input channel
    c_in = cfg.channels[0]
    for stage, (c, n) in enumerate(zip(cfg.channels, cfg.blocks)):
        for b in range(n):
            stride = 2 if stage > 0 and b == 0 else 1
            h, w = -(-h // stride), -(-w // stride)
            macs += h * w * 9 * (c_in * c + c * c)
            if stride != 1 or c_in != c:
                macs += h * w * c_in * c
            c_in = c
    macs += 2 * c_in * w * cfg.embed_dim
    return 2 * macs


def make_diarization_checkpoints(root: str) -> dict:
    """PyanNet at the default ``PyanNetConfig`` (segmentation-3.0's shape: 7
    powerset classes) and the ResNet34 at ``ResNetSpeakerConfig()``
    (wespeaker-voxceleb-resnet34-LM's: channels 32/64/128/256, blocks
    3/4/6/3, 80 mels, embedding 256), random weights from seeded
    ``torch.Generator``s with ``init_params``' distributions, written with
    the port's ``save_checkpoint``."""
    import dataclasses

    import torch

    from whisperx_tpu_torch.convert.checkpoint import save_checkpoint
    from whisperx_tpu_torch.models import pyannote, resnet_speaker

    def config(cfg):
        return {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(cfg).items()}

    paths = {"segmentation": os.path.join(root, "seg"), "speaker": os.path.join(root, "spk")}
    cfg = pyannote.PyanNetConfig()
    save_checkpoint(
        paths["segmentation"], pyannote.init_params(cfg, torch.Generator("cuda").manual_seed(0)),
        {"family": "pyannote_segmentation", "name": "seeded", "config": config(cfg)},
    )
    cfg = resnet_speaker.ResNetSpeakerConfig()
    save_checkpoint(
        paths["speaker"], resnet_speaker.init_params(cfg, torch.Generator("cuda").manual_seed(1)),
        {"family": "resnet_speaker", "name": "seeded", "config": config(cfg)},
    )
    return paths


def phase_diarization(main_result) -> None:
    """Phase 10: the weightless default and the neural path at full width
    on two voices, CUDA against the CPU; speaker assignment over the main
    path's transcript; the ResNet34 alone on 240 windows."""
    import numpy as np
    import torch

    from whisperx_tpu_torch.audio import SAMPLE_RATE
    from whisperx_tpu_torch.diarize import DiarizationPipeline, assign_word_speakers
    from whisperx_tpu_torch.models.pyannote import forward
    from whisperx_tpu_torch.models.resnet_speaker import ResNetSpeakerConfig, embed
    from whisperx_tpu_torch.utils import diarization_error_rate

    for flag in ("WHISPERX_TPU_SPEAKER_CKPT", "WHISPERX_TPU_SEGMENTATION_CKPT",
                 "WHISPERX_TPU_PLDA_CKPT", "WHISPERX_TPU_DIARIZE_CLUSTERING"):
        os.environ.pop(flag, None)
    audio, truth = two_voices(DIAR_AUDIO_S, seed=0)
    devs = ("cuda", "cpu")

    # (a) the weightless default: energy VAD → SpectralEmbedding → AHC
    pipes = {dev: DiarizationPipeline(device=dev) for dev in devs}
    pipes["cuda"](audio)  # warm-up
    out, rec = {}, {}
    for dev in devs:
        with recorded(pipes[dev]) as rec[dev]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[dev] = pipes[dev](audio, return_embeddings=True)
            torch.cuda.synchronize()
            out[dev + " wall"] = time.perf_counter() - t0
    same_turns("weightless", out["cuda"][0], out["cpu"][0])
    assert np.array_equal(rec["cuda"].inputs, rec["cpu"].inputs)
    err = float(np.abs(rec["cuda"].outputs - rec["cpu"].outputs).max())
    assert err <= SPECTRAL_TOL, err
    emb = pipes["cuda"].embedding
    x = torch.from_numpy(rec["cuda"].inputs).cuda()
    ms = cuda_ms(lambda: emb.features(x), iters=10, warmup=2)
    der = diarization_error_rate(truth, out["cuda"][0])
    turns = out["cuda"][0]
    print(
        f"[diarize] weightless (energy VAD, SpectralEmbedding, AHC) over {DIAR_AUDIO_S:.0f} s of two voices "
        f"({len(truth)} turns): {out['cuda wall']:.3f} s wall on cuda ({out['cpu wall']:.3f} s on cpu); "
        f"{len(x)} windows of 2 s, embedding {ms:.3f} ms of device time; {len(turns)} turns, "
        f"{len(set(turns['speaker']))} speakers; DER {der['der']:.4f} (miss {der['miss']:.3f} s, false alarm "
        f"{der['false_alarm']:.3f} s, confusion {der['confusion']:.3f} s of {der['total']:.3f} s; collar 0.25); "
        f"CUDA against CPU: the same turns and labels, embeddings max_abs_err {err:.3e} (tol {SPECTRAL_TOL:g})"
    )

    # (b) the neural path at full width, checkpoints through the switches
    with tempfile.TemporaryDirectory() as root:
        paths = make_diarization_checkpoints(root)
        os.environ["WHISPERX_TPU_SEGMENTATION_CKPT"] = paths["segmentation"]
        os.environ["WHISPERX_TPU_SPEAKER_CKPT"] = paths["speaker"]
        try:
            neural = {dev: DiarizationPipeline(device=dev) for dev in devs}
        finally:
            del os.environ["WHISPERX_TPU_SEGMENTATION_CKPT"], os.environ["WHISPERX_TPU_SPEAKER_CKPT"]
    assert neural["cuda"].vad_model is None and neural["cuda"].embedding.dim == 256
    neural["cuda"](audio)  # warm-up
    acts = {dev: neural[dev].segmenter.activity(audio) for dev in devs}
    assert np.array_equal(acts["cuda"][0], acts["cpu"][0]) and acts["cuda"][2] == acts["cpu"][2]
    torch.cuda.reset_peak_memory_stats()
    for dev in devs:
        with recorded(neural[dev]) as rec[dev]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[dev] = neural[dev](audio, return_embeddings=True)
            torch.cuda.synchronize()
            out[dev + " wall"] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert np.array_equal(rec["cuda"].inputs, rec["cpu"].inputs)
    err_n = float(np.abs(rec["cuda"].outputs - rec["cpu"].outputs).max())
    assert err_n <= RESNET_TOL, err_n
    same_turns("neural", out["cuda"][0], out["cpu"][0])
    seg = neural["cuda"].segmenter
    chunks = torch.from_numpy(seg.windows(audio)[0]).cuda()
    ms_seg = cuda_ms(lambda: forward(seg.model, chunks), iters=3, warmup=1)
    items = torch.from_numpy(rec["cuda"].inputs).cuda()
    model = neural["cuda"].embedding.model
    ms_emb = cuda_ms(lambda: embed(model, items), iters=3, warmup=1)
    act = acts["cuda"][0]
    print(
        f"[diarize] neural (PyanNet default, 7 powerset classes; ResNet34 at ResNetSpeakerConfig(), "
        f"seeded random weights through WHISPERX_TPU_SEGMENTATION_CKPT / WHISPERX_TPU_SPEAKER_CKPT): "
        f"{act.shape[0]} windows of 10 s at a 5 s step, {act.shape[1]} frames each: segmentation "
        f"{ms_seg:.3f} ms of device time; {len(items)} items (window x local speaker) embedded in "
        f"{ms_emb:.3f} ms of device time; {out['cuda wall']:.3f} s wall on cuda ({out['cpu wall']:.3f} s on "
        f"cpu); peak {peak:.2f} GiB; {len(out['cuda'][0])} turns; CUDA against CPU: the same activity and "
        f"turns, embeddings max_abs_err {err_n:.3e} (tol {RESNET_TOL:g}, TF32 off)"
    )

    # (c) speaker assignment over the main path's transcript and audio
    main_audio = synth_speech(MAIN_AUDIO_S, seed=1)
    t0 = time.perf_counter()
    main_turns = pipes["cuda"](main_audio)
    torch.cuda.synchronize()
    t_diar = time.perf_counter() - t0
    segments = [dict(seg) for seg in main_result["segments"]]
    t0 = time.perf_counter()
    assigned = assign_word_speakers(main_turns, {"segments": segments})
    t_assign = time.perf_counter() - t0
    tagged = [s for s in assigned["segments"] if "speaker" in s]
    assert assigned["segments"] and tagged, (len(main_turns), assigned["segments"][:3])
    assert set(s["speaker"] for s in tagged) <= set(main_turns["speaker"])
    print(
        f"[diarize] main path's {MAIN_AUDIO_S:.0f} s: weightless diarization {t_diar:.3f} s wall, "
        f"{len(main_turns)} turns; assign_word_speakers over its {len(segments)} segments "
        f"{t_assign * 1e3:.3f} ms, {len(tagged)} tagged ({len(set(s['speaker'] for s in tagged))} speakers)"
    )

    # (d) the ResNet34 alone: 240 windows of 2 s
    windows = torch.from_numpy(
        np.stack([audio[i * 7200 :][: 2 * SAMPLE_RATE] for i in range(RESNET_WINDOWS)])  # 0.45 s hop
    ).cuda()
    torch.cuda.reset_peak_memory_stats()
    ms_d = cuda_ms(lambda: embed(model, windows), iters=3, warmup=1)
    peak_d = torch.cuda.max_memory_allocated() / 2**30
    cfg = ResNetSpeakerConfig()
    ops = resnet_ops(cfg, windows.shape[1] // 160)
    print(
        f"[diarize] ResNet34 on {RESNET_WINDOWS} windows of 2 s: {ms_d:.3f} ms of device time; "
        f"{ops / 1e9:.3f} GFLOP a window, {ops * RESNET_WINDOWS / 1e12:.3f} TFLOP in all: "
        f"{ops * RESNET_WINDOWS / (ms_d * 1e-3) / 1e12:.2f} TFLOP/s against {PEAK_OPS_PER_S['torch.float32'] / 1e12:.0f} "
        f"(f32, TF32 off); peak {peak_d:.2f} GiB"
    )
    del pipes, neural, model, windows, items, chunks
    torch.cuda.empty_cache()


def write_safetensors(path: str, tensors: dict) -> int:
    """A ``model.safetensors`` of numpy arrays (the format's 8-byte header
    length, its JSON header, the data in order); returns its size."""
    import numpy as np

    codes = {np.dtype(np.float16): "F16", np.dtype(np.float32): "F32"}
    header, offset = {}, 0
    for name, arr in tensors.items():
        header[name] = {"dtype": codes[arr.dtype], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)) + blob)
        for arr in tensors.values():
            np.ascontiguousarray(arr).tofile(f)
    return 8 + len(blob) + offset


def hf_whisper_name(key: str):
    """The HF ``WhisperForConditionalGeneration`` name of a Whisper weight
    in the JAX layout, and whether the converter transposes it (linear
    [out, in] → [in, out], conv1d [O, I, W] → [W, I, O]: both a full
    reversal of the axes)."""
    parts, leaf = key.split("/"), key.rsplit("/", 1)[1]
    side, kind = parts[0], parts[1]
    if kind in ("pos_emb", "tok_emb"):
        return f"model.{side}.{'embed_positions' if kind == 'pos_emb' else 'embed_tokens'}.weight", False
    suffix = {"w": "weight", "g": "weight", "b": "bias"}[leaf]
    if kind in ("conv1", "conv2"):
        return f"model.{side}.{kind}.{suffix}", leaf == "w"
    if kind in ("ln_post", "ln"):
        return f"model.{side}.layer_norm.{suffix}", False
    prefix, mod = f"model.{side}.layers.{parts[2]}", parts[3]
    if mod in ("attn", "cross_attn"):
        proj = {"query": "q_proj", "key": "k_proj", "value": "v_proj", "out": "out_proj"}[parts[4]]
        name = f"{prefix}.{'self_attn' if mod == 'attn' else 'encoder_attn'}.{proj}"
    else:
        name = f"{prefix}." + {
            "attn_ln": "self_attn_layer_norm", "cross_attn_ln": "encoder_attn_layer_norm",
            "mlp1": "fc1", "mlp2": "fc2", "mlp_ln": "final_layer_norm",
        }[mod]
    return f"{name}.{suffix}", leaf == "w"


def synthetic_vocab(n_ranked: int = 50257) -> dict:
    """An HF ``vocab.json`` of ``n_ranked`` ranked tokens in GPT-2's byte
    alphabet (the 256 bytes, then lowercase letter strings with and
    without a leading space) and two special tokens: the multilingual
    layout's size, so the tokenizer's special ids are large-v3's."""
    bs = list(range(33, 127)) + list(range(161, 173)) + list(range(174, 256))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    tokens = [chr(c) for _, c in sorted(zip(bs, cs))]
    space = tokens[32]
    words = ("".join(w) for k in (2, 3, 4) for w in itertools.product("abcdefghijklmnopqrstuvwxyz", repeat=k))
    for word in words:
        tokens += [space + word, word]
        if len(tokens) >= n_ranked:
            break
    vocab = {t: i for i, t in enumerate(tokens[:n_ranked])}
    vocab.update({"<|endoftext|>": n_ranked, "<|startoftranscript|>": n_ranked + 1})
    return vocab


def make_hf_whisper(root: str, model, heads) -> tuple:
    """``model`` (large-v3's width, random weights) as an HF
    ``WhisperForConditionalGeneration`` directory: ``model.safetensors`` in
    F16 (as published), ``config.json`` of its dims, ``generation_config.json``
    with ``heads`` as the alignment heads, and a synthetic ``vocab.json`` +
    ``merges.txt``. Returns the directory, its F16 tensors by HF name, each
    JAX name's (HF name, whether the converter transposes it) and the
    file's size."""
    import torch

    d = model.dims
    config = {
        "architectures": ["WhisperForConditionalGeneration"], "model_type": "whisper",
        "d_model": d.n_audio_state, "encoder_layers": d.n_audio_layer, "decoder_layers": d.n_text_layer,
        "encoder_attention_heads": d.n_audio_head, "decoder_attention_heads": d.n_text_head,
        "num_mel_bins": d.n_mels, "vocab_size": d.n_vocab, "max_source_positions": d.n_audio_ctx,
        "max_target_positions": d.n_text_ctx, "encoder_ffn_dim": 4 * d.n_audio_state,
        "decoder_ffn_dim": 4 * d.n_text_state, "torch_dtype": "float16",
    }
    assert {k: config[k] for k in LARGE_V3_HF} == LARGE_V3_HF, config
    src = os.path.join(root, "hf-large-v3")
    os.makedirs(src)
    tensors, expected = {}, {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            key = name.replace(".", "/")
            hf, transposed = hf_whisper_name(key)
            t = p.detach().to(torch.float16)
            if transposed:  # every axis reversed, as the converter's .T
                t = t.permute(*reversed(range(t.ndim)))
            tensors[hf] = t.contiguous().cpu().numpy()
            expected[key] = (hf, transposed)
    size = write_safetensors(os.path.join(src, "model.safetensors"), tensors)
    with open(os.path.join(src, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    with open(os.path.join(src, "generation_config.json"), "w") as f:
        json.dump({"alignment_heads": [list(h) for h in heads]}, f)
    with open(os.path.join(src, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(synthetic_vocab(), f)
    with open(os.path.join(src, "merges.txt"), "w") as f:
        f.write("#version: 0.2\nĠ a\n")
    return src, tensors, expected, size


def make_hf_wav2vec2(root: str) -> str:
    """wav2vec2 BASE_CONFIG with make_align_checkpoint's weights (seed 0) as
    an HF ``Wav2Vec2ForCTC`` directory: F32 ``model.safetensors`` under HF's
    names (a plain positional-conv weight), ``config.json`` and the
    base-960h ``vocab.json``."""
    import numpy as np
    import torch

    from whisperx_tpu_torch.alignment import DEFAULT_EN_VOCAB
    from whisperx_tpu_torch.convert.checkpoint import flatten_tree
    from whisperx_tpu_torch.models.wav2vec2 import BASE_CONFIG, init_params

    model = init_params(BASE_CONFIG, torch.Generator(device="cuda").manual_seed(0))
    leaf = {"w": "weight", "g": "weight", "b": "bias"}
    names = {"attn_ln": "layer_norm", "mlp1": "feed_forward.intermediate_dense",
             "mlp2": "feed_forward.output_dense", "mlp_ln": "final_layer_norm"}
    tensors = {}
    for key, arr in flatten_tree(model).items():
        parts = key.split("/")
        if parts[0] == "feature_extractor":
            name = f"feature_extractor.conv_layers.{parts[1]}." + ("conv" if len(parts) == 3 else "layer_norm")
        elif parts[0] == "feature_projection":
            name = "feature_projection." + {"ln": "layer_norm", "proj": "projection"}[parts[1]]
        elif parts[0] == "pos_conv":
            name = "encoder.pos_conv_embed.conv"
        elif parts[0] == "encoder_ln":
            name = "encoder.layer_norm"
        elif parts[0] == "lm_head":
            name = "lm_head"
        elif parts[2] == "attn":
            name = f"encoder.layers.{parts[1]}.attention." + {
                "query": "q_proj", "key": "k_proj", "value": "v_proj", "out": "out_proj"}[parts[3]]
        else:
            name = f"encoder.layers.{parts[1]}.{names[parts[2]]}"
        prefix = "" if name == "lm_head" else "wav2vec2."
        tensors[f"{prefix}{name}.{leaf[parts[-1]]}"] = np.ascontiguousarray(arr.T if parts[-1] == "w" else arr)
    src = os.path.join(root, "hf-wav2vec2-base")
    os.makedirs(src)
    write_safetensors(os.path.join(src, "model.safetensors"), tensors)
    c = BASE_CONFIG
    with open(os.path.join(src, "config.json"), "w") as f:
        json.dump({
            "architectures": ["Wav2Vec2ForCTC"], "vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
            "num_hidden_layers": c.num_layers, "num_attention_heads": c.num_heads,
            "intermediate_size": c.intermediate_size, "conv_dim": list(c.conv_dim),
            "conv_kernel": list(c.conv_kernel), "conv_stride": list(c.conv_stride),
            "num_conv_pos_embeddings": c.num_conv_pos_embeddings,
            "num_conv_pos_embedding_groups": c.num_conv_pos_embedding_groups,
            "do_stable_layer_norm": c.do_stable_layer_norm, "feat_extract_norm": c.feat_extract_norm,
        }, f)
    with open(os.path.join(src, "vocab.json"), "w") as f:
        json.dump(DEFAULT_EN_VOCAB, f)
    return src


def make_pyannote_bin(root: str) -> str:
    """PyanNet at the default config (seeded ``init_params``) as pyannote's
    ``pytorch_model.bin``: a state dict under ``state_dict`` with the
    ``model.`` prefix, torch's LSTM layout (the JAX bias as ``bias_ih``, a
    zero ``bias_hh``) and SincNet's band edges (``low_hz_``, ``band_hz_``,
    mel-spaced as SincNet starts them) in place of the first convolution."""
    import numpy as np
    import torch

    from whisperx_tpu_torch.convert.checkpoint import pyannote_to_numpy
    from whisperx_tpu_torch.models import pyannote

    cfg = pyannote.PyanNetConfig()
    flat = pyannote_to_numpy(pyannote.init_params(cfg, torch.Generator("cuda").manual_seed(0)))
    sd = {"sincnet.wav_norm1d.weight": flat["wav_norm/g"], "sincnet.wav_norm1d.bias": flat["wav_norm/b"]}
    mel = np.linspace(2595 * np.log10(1 + 30 / 700), 2595 * np.log10(1 + 7950 / 700), cfg.sincnet_filters[0] + 1)
    hz = 700 * (10 ** (mel / 2595) - 1)
    sd["sincnet.conv1d.0.low_hz_"] = (hz[:-1] - 50.0).astype(np.float32)[:, None]
    sd["sincnet.conv1d.0.band_hz_"] = np.diff(hz).astype(np.float32)[:, None]
    for i in range(len(cfg.sincnet_filters)):
        sd[f"sincnet.norm1d.{i}.weight"] = flat[f"sincnet/{i}/norm/g"]
        sd[f"sincnet.norm1d.{i}.bias"] = flat[f"sincnet/{i}/norm/b"]
        if i:
            sd[f"sincnet.conv1d.{i}.weight"] = flat[f"sincnet/{i}/w"].transpose(2, 1, 0)
    for i in range(cfg.lstm_layers):
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            node = f"lstm/{i}/{direction}"
            sd[f"lstm.weight_ih_l{i}{suffix}"] = flat[f"{node}/wx"].T
            sd[f"lstm.weight_hh_l{i}{suffix}"] = flat[f"{node}/wh"].T
            sd[f"lstm.bias_ih_l{i}{suffix}"] = flat[f"{node}/b"]
            sd[f"lstm.bias_hh_l{i}{suffix}"] = np.zeros_like(flat[f"{node}/b"])
    for i in range(len(cfg.linear_dims)):
        sd[f"linear.{i}.weight"], sd[f"linear.{i}.bias"] = flat[f"linear/{i}/w"].T, flat[f"linear/{i}/b"]
    sd["classifier.weight"], sd["classifier.bias"] = flat["classifier/w"].T, flat["classifier/b"]
    src = os.path.join(root, "pyannote-segmentation")
    os.makedirs(src)
    torch.save(
        {"state_dict": {f"model.{k}": torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}},
        os.path.join(src, "pytorch_model.bin"),
    )
    return src


def make_wespeaker_pt(root: str) -> str:
    """The ResNet34 at ``ResNetSpeakerConfig()`` (seeded ``init_params``) as
    a wespeaker state dict: ``conv1``/``bn1``, ``layer<s>.<b>.*`` with
    ``downsample.{0,1}``, the ``seg_1`` embedding; convolutions OIHW."""
    import numpy as np
    import torch

    from whisperx_tpu_torch.convert.checkpoint import resnet_speaker_to_numpy
    from whisperx_tpu_torch.models import resnet_speaker

    cfg = resnet_speaker.ResNetSpeakerConfig()
    flat = resnet_speaker_to_numpy(resnet_speaker.init_params(cfg, torch.Generator("cuda").manual_seed(1)))
    bn = {"g": "weight", "b": "bias", "mean": "running_mean", "var": "running_var"}
    sd = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == "proj":
            sd[f"seg_1.{'weight' if parts[1] == 'w' else 'bias'}"] = arr.T if parts[1] == "w" else arr
            continue
        if parts[0] == "stem":
            conv, norm, rest = "conv1", "bn1", parts[1:]
        else:
            block = f"layer{int(parts[1]) + 1}.{parts[2]}"
            if parts[3] == "down":
                conv, norm, rest = f"{block}.downsample.0", f"{block}.downsample.1", parts[4:]
            else:
                conv = norm = f"{block}.{parts[3]}"
                rest = ["w"] if parts[3].startswith("conv") else ["bn", *parts[4:]]
        if rest == ["w"]:
            sd[f"{conv}.weight"] = arr.transpose(3, 2, 0, 1)  # HWIO → OIHW
        else:
            sd[f"{norm.replace('conv1', 'bn1') if parts[0] == 'stem' else norm}.{bn[rest[-1]]}"] = arr
    path = os.path.join(root, "wespeaker.pt")
    torch.save({f"model.{k}": torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    return path


def convert_cli(*argv) -> subprocess.Popen:
    """``python -m whisperx_tpu_torch.convert <argv>`` from this checkout."""
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "whisperx_tpu_torch.convert", *argv],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def converted(proc: subprocess.Popen, what: str, timeout: float = 900.0) -> str:
    out, _ = proc.communicate(timeout=timeout)
    if proc.returncode != 0 or f"converted {what}" not in out:
        raise AssertionError(f"convert {what}: exit {proc.returncode}\n{out[-3000:]}")
    return out


def phase_convert() -> None:
    """Phase 12: real-checkpoint bring-up through the port's own converter.
    HF sources are written at the published widths (large-v3 in F16, from a
    random large-v3 of seed 0; wav2vec2 base; PyanNet; the ResNet34), each
    converted by ``python -m whisperx_tpu_torch.convert`` (Whisper with
    ``--quantize int8``), checked on the host, and run on the card on the
    path it serves."""
    import numpy as np
    import torch

    import whisperx_tpu_torch
    from whisperx_tpu_torch import alignment
    from whisperx_tpu_torch.convert.checkpoint import read_checkpoint
    from whisperx_tpu_torch.diarize import DiarizationPipeline
    from whisperx_tpu_torch.models.whisper import load_model as load_whisper
    from whisperx_tpu_torch.ops.flash_attention import flash_attention
    from whisperx_tpu_torch.ops.quant_matmul import quant_matmul
    from whisperx_tpu_torch.quant.core import quantize_weight
    from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER, profiler_trace

    card = card_line()
    audio = synth_speech(CONVERT_AUDIO_S, seed=10)
    rng = np.random.default_rng(10)
    heads = sorted(
        (int(layer), int(head)) for layer, head in
        {(int(rng.integers(16, 32)), int(rng.integers(0, 20))) for _ in range(10)}
    )
    for flag in ("WHISPERX_TPU_SPEAKER_CKPT", "WHISPERX_TPU_SEGMENTATION_CKPT",
                 "WHISPERX_TPU_PLDA_CKPT", "WHISPERX_TPU_DIARIZE_CLUSTERING"):
        os.environ.pop(flag, None)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        # 1. the sources
        t0 = time.perf_counter()
        source = load_whisper("large-v3", device="cuda", seed=0)
        src, tensors, expected, src_bytes = make_hf_whisper(root, source, heads)
        del source
        torch.cuda.empty_cache()
        w2v_src = make_hf_wav2vec2(root)
        seg_src, spk_src = make_pyannote_bin(root), make_wespeaker_pt(root)
        t_sources = time.perf_counter() - t0

        # 2. convert: Whisper with --quantize int8, the small families beside it
        ck = os.path.join(root, "large-v3")
        align_root = os.path.join(root, "align")
        t0 = time.perf_counter()
        whisper = convert_cli("whisper", "--src", src, "--out", ck, "--quantize", "int8")
        small = {
            "wav2vec2": convert_cli("wav2vec2", "--src", w2v_src, "--out", os.path.join(align_root, "en")),
            "pyannote segmentation": convert_cli("pyannote", "--src", seg_src, "--out", os.path.join(root, "seg")),
            "wespeaker embedding": convert_cli("wespeaker", "--src", spk_src, "--out", os.path.join(root, "spk")),
        }
        log = converted(whisper, "whisper")
        t_convert = time.perf_counter() - t0
        assert f"quantized (int8) → {ck}-int8" in log, log
        for what, proc in small.items():
            converted(proc, what)
        t_small = time.perf_counter() - t0
        sizes = {name: os.path.getsize(os.path.join(path, "weights.npz")) / 1e9
                 for name, path in (("bf16", ck), ("int8", ck + "-int8"))}

        # 3. the weights on the host: each tensor is its source's, after the
        # converter's transposes, to the bit
        t0 = time.perf_counter()
        flat, config = read_checkpoint(ck)
        assert set(flat) == set(expected), sorted(set(flat) ^ set(expected))[:5]
        for key, (hf, transposed) in expected.items():
            want = (tensors[hf].T if transposed else tensors[hf]).view(np.uint16)
            got = flat[key]
            assert got.dtype == np.float16 and np.array_equal(got.view(np.uint16), want), key
        assert [tuple(h) for h in config["alignment_heads"]] == heads, config["alignment_heads"]
        with open(os.path.join(ck, "vocab.tiktoken")) as f:
            ranks = f.read().splitlines()
        assert len(ranks) == 50257 and ranks[-1].endswith(" 50256"), (len(ranks), ranks[-1])
        n_params = sum(a.size for a in flat.values())
        t_check = time.perf_counter() - t0
        del tensors
        print(
            f"[convert] {card}: HF large-v3 source (F16 model.safetensors, {src_bytes / 1e9:.3f} GB, "
            f"written in {t_sources:.2f} s with the wav2vec2, PyanNet and ResNet34 sources); python -m "
            f"whisperx_tpu_torch.convert whisper --quantize int8 {t_convert:.2f} s wall (read "
            f"{src_bytes / 1e9:.3f} GB + {sizes['bf16']:.3f} GB, wrote weights.npz {sizes['bf16']:.3f} GB "
            f"and {sizes['int8']:.3f} GB), the three small conversions beside it done at {t_small:.2f} s; "
            f"{len(flat)} tensors, {n_params} parameters equal their F16 source to the bit "
            f"({t_check:.2f} s); alignment heads {len(heads)} and vocab.tiktoken {len(ranks)} ranks carried"
        )
        del flat

        # 4. the converted checkpoint on the card, then (7) traced
        kw = dict(device="cuda", vad_method="energy", batch_size=8, compute_type="bfloat16",
                  asr_options={"temperatures": (0.0,)})
        options = dict(language="en", sample_len=CONVERT_SAMPLE_LEN)
        t0 = time.perf_counter()
        pipe = whisperx_tpu_torch.load_model(ck, **kw)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        assert pipe.model.alignment_heads == heads and pipe.model.name == "hf-large-v3"
        assert all(p.is_cuda and p.dtype == torch.bfloat16 for p in pipe.model.parameters())

        def run(p, trace_dir=None):
            GLOBAL_TRACKER.reset()
            before = flash_attention.launches
            torch.cuda.synchronize()
            t = time.perf_counter()
            if trace_dir is None:
                result = p.transcribe(audio, **options)
            else:
                with profiler_trace(trace_dir):
                    result = p.transcribe(audio, **options)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            passes = GLOBAL_TRACKER.report()["decode"]["calls"]
            k1 = flash_attention.launches - before
            assert k1 == p.model.dims.n_audio_layer * passes > 0, (k1, passes)
            assert result["segments"], result
            for seg in result["segments"]:
                assert 0.0 <= seg["start"] < seg["end"] <= CONVERT_AUDIO_S + 1e-6, seg
            return result, wall, passes, k1, int(GLOBAL_TRACKER.counters["decode_steps"])

        result, t_bf16, passes, k1, steps = run(pipe)
        trace_dir = os.path.join(root, "trace")
        _, t_traced, _, _, _ = run(pipe, trace_dir)
        (trace,) = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        k1_events = [e for e in events if e.get("cat") == "kernel" and "wholek_attention_bf16_kernel" in e.get("name", "")]
        assert len(k1_events) == k1, (len(k1_events), k1)
        text = " | ".join(s["text"] for s in result["segments"])[:80]
        print(
            f"[convert] {card}: load_model(<converted>) {t_load:.2f} s; transcribe {CONVERT_AUDIO_S:.0f} s "
            f"({CONVERT_SAMPLE_LEN} tokens a row, one temperature) {t_bf16:.3f} s: {len(result['segments'])} "
            f"segments ({text!r}), {passes} encoder passes, K1 {k1} (= 32 x {passes}), {steps} decode steps; "
            f"alignment heads from the converted config; under profiler_trace {t_traced:.3f} s, a Chrome trace of {os.path.getsize(trace) / 1e6:.1f} MB with {len(events)} events, "
            f"{len(k1_events)} of them K1's kernel (wholek_attention_bf16_kernel)"
        )
        del events, k1_events

        # 5. the int8 copy: K4 per shape as the code implies, codes as the CPU's
        t0 = time.perf_counter()
        pipe8 = whisperx_tpu_torch.load_model(ck + "-int8", **kw)
        torch.cuda.synchronize()
        t_load8 = time.perf_counter() - t0
        q_blocks = sorted({int(n.split(".")[2]) for n, m in pipe8.model.named_modules() if hasattr(m, "qw")})
        assert q_blocks == list(range(1, 31)), q_blocks
        before = quant_matmul.launches
        with k4_by_shape() as shapes:
            result8, t_int8, passes8, k1_8, steps8 = run(pipe8)
        by_shape = shapes.counts()
        k4 = quant_matmul.launches - before
        want = k4_launches_per_shape(len(q_blocks), passes8, steps8, beams=1)
        assert dict(by_shape) == want and k4 == sum(want.values()), (dict(by_shape), want, k4)
        bf16_flat, _ = read_checkpoint(ck)
        int8_flat, _ = read_checkpoint(ck + "-int8")
        block = pipe8.model.decoder.blocks[1]
        n_same = 0
        for name, mod in block.named_modules():
            if not hasattr(mod, "qw"):
                continue
            key = f"decoder/blocks/1/{name.replace('.', '/')}"
            w = torch.tensor(bf16_flat[f"{key}/w"]).to(torch.bfloat16).float().numpy()
            q = quantize_weight(w, "int8", 64)
            for leaf in ("qw", "scale"):
                cpu = q[leaf].numpy()
                assert cpu.tobytes() == int8_flat[f"{key}/__quantized_linear__/{leaf}"].tobytes(), (key, leaf)
                assert cpu.tobytes() == getattr(mod, leaf).cpu().numpy().tobytes(), (key, leaf)
            n_same += 1
        assert n_same == 10, n_same
        del bf16_flat, int8_flat
        print(
            f"[convert] {card}: load_model(<converted>-int8) {t_load8:.2f} s; transcribe {t_int8:.3f} s: "
            f"{len(result8['segments'])} segments, K1 {k1_8} (= 32 x {passes8}), K4 {k4} launches over "
            + ", ".join(f"M={m} K={k} N={n}: {c}" for (m, k, n), c in sorted(by_shape.items()))
            + f" (= k4_launches_per_shape(30 blocks, {passes8} passes, {steps8} steps, greedy)); decoder "
            f"block 1's 10 int8 linears: codes and scales equal quantize_weight on the CPU of the bf16 weights, "
            f"in the file and on the card"
        )
        del pipe8
        torch.cuda.empty_cache()

        # 6. the small families on the paths they serve
        os.environ["WHISPERX_TPU_ALIGN_DIR"] = align_root
        try:
            t0 = time.perf_counter()
            aligner, meta = whisperx_tpu_torch.load_align_model("en", device="cuda")
            assert meta["random_weights"] is False and aligner.config.num_layers == 12, meta
            aligned = alignment.align(result["segments"], aligner, meta, audio, "cuda")
            torch.cuda.synchronize()
            t_align = time.perf_counter() - t0
        finally:
            del os.environ["WHISPERX_TPU_ALIGN_DIR"]
        words = aligned["word_segments"]
        for seg in aligned["segments"]:
            for w in seg["words"]:
                assert "start" not in w or seg["start"] - 1e-6 <= w["start"] <= w["end"] <= seg["end"] + 1e-6, w
        os.environ["WHISPERX_TPU_SEGMENTATION_CKPT"] = os.path.join(root, "seg")
        os.environ["WHISPERX_TPU_SPEAKER_CKPT"] = os.path.join(root, "spk")
        try:
            diarizer = DiarizationPipeline(device="cuda")
        finally:
            del os.environ["WHISPERX_TPU_SEGMENTATION_CKPT"], os.environ["WHISPERX_TPU_SPEAKER_CKPT"]
        assert diarizer.vad_model is None and diarizer.embedding.dim == 256
        assert next(diarizer.embedding.model.parameters()).is_cuda
        t0 = time.perf_counter()
        turns = diarizer(audio)
        torch.cuda.synchronize()
        t_diar = time.perf_counter() - t0
        for start, end in zip(turns["start"], turns["end"]):
            assert 0.0 <= start <= end <= CONVERT_AUDIO_S + 1e-6, (start, end)
        print(
            f"[convert] {card}: converted wav2vec2 base through WHISPERX_TPU_ALIGN_DIR aligns the "
            f"{len(result['segments'])} segments on cuda in {t_align:.3f} s ({len(words)} words); converted "
            f"PyanNet + ResNet34 through WHISPERX_TPU_SEGMENTATION_CKPT / WHISPERX_TPU_SPEAKER_CKPT "
            f"diarize the {CONVERT_AUDIO_S:.0f} s on cuda in {t_diar:.3f} s ({len(turns)} turns); Silero's "
            f"routes need onnx or the network, which this machine lacks: not run here (the CPU tests hold "
            f"them against JAX)"
        )
        del pipe, aligner, diarizer
        torch.cuda.empty_cache()
    print(f"[convert] {card}: phase {time.perf_counter() - t_phase:.1f} s, temporary files deleted")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wav_bytes(audio, sr: int = 16000) -> bytes:
    """16-bit mono WAV bytes of float samples in [-1, 1]."""
    import io
    import wave

    import numpy as np

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.asarray(audio) * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def multipart(fields: dict):
    """A multipart/form-data body (name → bytes for a file, str for a field)
    and its Content-Type, as the OpenAI SDK sends it."""
    boundary = "smokeboundary7"
    out = b""
    for name, val in fields.items():
        out += f"--{boundary}\r\n".encode()
        if isinstance(val, bytes):
            out += (f'Content-Disposition: form-data; name="{name}"; filename="clip.wav"\r\n'
                    "Content-Type: application/octet-stream\r\n\r\n").encode() + val + b"\r\n"
        else:
            out += f'Content-Disposition: form-data; name="{name}"\r\n\r\n{val}\r\n'.encode()
    return out + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def http(url: str, body=None, headers=None, timeout: float = 600.0):
    """(status, Content-Type, body bytes) of one request over urllib."""
    import urllib.request

    req = urllib.request.Request(url, data=body, headers=headers or {}, method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read()


class WSClient:
    """A minimal RFC 6455 client (masked frames, as the RFC requires of
    clients). A reader thread keeps every text message with its arrival
    time, so results pushed while audio is still being sent are seen."""

    def __init__(self, port: int, path: str, timeout: float = 600.0):
        import base64
        import socket
        import threading

        self.sock = socket.create_connection(("127.0.0.1", port), timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall(
            (f"GET {path} HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\nUpgrade: websocket\r\n"
             f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n").encode()
        )
        self.buf = b""
        while b"\r\n\r\n" not in self.buf:
            chunk = self.sock.recv(4096)
            assert chunk, "connection closed during the handshake"
            self.buf += chunk
        head, _, self.buf = self.buf.partition(b"\r\n\r\n")
        status = int(head.split(b" ", 2)[1])
        assert status == 101, head
        self.messages = []  # (monotonic time, message)
        self.closed = threading.Event()
        self.error = None
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _exact(self, n: int) -> bytes:
        while len(self.buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("server closed the socket")
            self.buf += chunk
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def _read(self):
        import struct

        try:
            while True:
                b1, b2 = self._exact(2)
                op, n = b1 & 0x0F, b2 & 0x7F
                if n == 126:
                    (n,) = struct.unpack(">H", self._exact(2))
                elif n == 127:
                    (n,) = struct.unpack(">Q", self._exact(8))
                payload = self._exact(n)
                if op == 0x8:
                    return
                if op == 0x1:
                    self.messages.append((time.monotonic(), json.loads(payload)))
        except Exception as e:  # kept and raised by the caller
            self.error = e
        finally:
            self.closed.set()

    def send(self, opcode: int, payload: bytes) -> None:
        import struct

        header = bytearray([0x80 | opcode])
        n = len(payload)
        if n < 126:
            header.append(0x80 | n)
        elif n < 1 << 16:
            header += bytes([0x80 | 126]) + struct.pack(">H", n)
        else:
            header += bytes([0x80 | 127]) + struct.pack(">Q", n)
        mask = os.urandom(4)
        import numpy as np

        data = np.frombuffer(payload, np.uint8) ^ np.frombuffer((mask * (n // 4 + 1))[:n], np.uint8)
        self.sock.sendall(bytes(header) + mask + data.tobytes())


def same_shape_threads(model) -> None:
    """Two threads decoding the same shape on one model at once, as the
    server's batcher and stream workers may: each gets the bits of a lone
    run of its own batch. Their steps replay captured graphs, each decode
    on a cache entry of its own (the second thread captures while the
    first replays)."""
    import threading

    import numpy as np
    import torch

    from whisperx_tpu_torch.audio import log_mel_batch
    from whisperx_tpu_torch.decoding import DecodingOptions
    from whisperx_tpu_torch.decoding.decode import decode_dispatch
    from whisperx_tpu_torch.decoding.step_graph import graph_cache

    mels = [
        log_mel_batch(np.stack([synth_speech(30.0, seed=s) for s in seeds]), model.dims.n_mels, device="cuda")
        for seeds in ((20, 21), (22, 23))
    ]
    opts = DecodingOptions(language="en", sample_len=SERVE_THREAD_STEPS, kv_quant=True)
    lone = [decode_outputs(decode_dispatch(model, m, opts)) for m in mels]
    before = graph_cache(model.decoder).stats()
    barrier = threading.Barrier(len(mels))
    got, errors = [None] * len(mels), []

    def worker(i):
        try:
            barrier.wait(60)
            got[i] = decode_outputs(decode_dispatch(model, mels[i], opts))
        except Exception as e:  # raised below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(mels))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    assert not errors and not any(t.is_alive() for t in threads), errors
    for i, (a, b) in enumerate(zip(got, lone)):
        assert all(torch.equal(x, y) for x, y in zip(a, b)), f"thread {i}: not a lone run's bits"
    print(
        f"[serve] two threads decoding batches of 2 x 30 s ({SERVE_THREAD_STEPS} steps) on one model at once: "
        f"each got a lone run's tokens, lengths and scores, bit for bit; {wall:.3f} s for both"
    )
    graph_line("serve, two threads", model, before)


def phase_serving(pipe) -> None:
    """Phase 11: the HTTP and WebSocket server over the main path's
    large-v3 bf16 model (its weights shared, not reloaded), one temperature
    (``serve --temperature_increment_on_fallback 0``)."""
    import threading
    import warnings

    import numpy as np
    import torch

    from whisperx_tpu_torch.asr import TranscriptionPipeline
    from whisperx_tpu_torch.ops.flash_attention import flash_attention
    from whisperx_tpu_torch.serve import BatchConfig, TranscriptionServer
    from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER

    t_phase = time.perf_counter()
    same_shape_threads(pipe.model)
    m, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    flags = lambda: (m.allow_tf32, m.allow_bf16_reduced_precision_reduction, cudnn.allow_tf32)  # noqa: E731
    flags_before = flags()
    serve_pipe = TranscriptionPipeline(
        model=pipe.model, vad_model=pipe.vad_model, asr_options={"temperatures": (0.0,)},
        language="en", batch_size=8,
    )
    assert serve_pipe.model is pipe.model
    n_layer = pipe.model.dims.n_audio_layer
    server = TranscriptionServer(
        serve_pipe, model_name="large-v3", batch_config=BatchConfig(max_batch_size=3, max_wait_ms=500),
    )
    port = server.start_background(port=0)
    base = f"http://127.0.0.1:{port}"
    try:
        # (a) liveness
        status, _, body = http(base + "/healthz")
        assert status == 200 and json.loads(body)["status"] == "ok", body
        print(f"[serve] TranscriptionServer(large-v3 bf16, max_batch_size 3, max_wait_ms 500) on port {port}: /healthz 200")

        # (b) three concurrent requests of the (20, 30] s bucket: one batch
        a21 = synth_speech(SERVE_AUDIO_S[0], seed=7)
        a25_44k = synth_speech(SERVE_AUDIO_S[1], sr=44100, seed=8)
        a29 = synth_speech(SERVE_AUDIO_S[2], seed=9)
        body29, ctype29 = multipart({"file": wav_bytes(a29), "model": "whisper-1", "response_format": "verbose_json"})
        url = base + "/v1/audio/transcriptions"
        requests = [
            ("wav 21 s", url, wav_bytes(a21), {"Content-Type": "audio/wav"}),
            ("pcm i16 44.1 kHz 25 s", url, (a25_44k * 32767).astype(np.int16).tobytes(),
             {"Content-Type": "audio/x-raw-pcm", "X-Format": "i16", "X-Sample-Rate": "44100"}),
            ("multipart verbose_json 29 s", url, body29, {"Content-Type": ctype29}),
        ]
        answers, errors = {}, []

        def client(label, u, b, h):
            t0 = time.perf_counter()
            try:
                answers[label] = (*http(u, b, h), time.perf_counter() - t0)
            except Exception as e:  # raised below
                errors.append((label, e))

        # the handler resamples the 44.1 kHz body with scipy: import it now,
        # so that its first import does not outlast the straggler window
        from whisperx_tpu_torch.audio.io import _resample

        _resample(np.zeros(441, np.float32), 44100, 16000)
        GLOBAL_TRACKER.reset()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        threads = [threading.Thread(target=client, args=r) for r in requests]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        k1 = flash_attention.launches
        assert not errors, errors
        passes = GLOBAL_TRACKER.report()["decode"]["calls"]
        stats = server.batcher.stats_snapshot()
        for (label, *_), audio_s in zip(requests, SERVE_AUDIO_S):
            status, ctype, body, _ = answers[label]
            assert status == 200 and ctype.startswith("application/json"), (label, status, ctype)
            payload = json.loads(body)
            assert payload["segments"], (label, payload)
            for seg in payload["segments"]:
                assert 0.0 <= seg["start"] < seg["end"] <= audio_s + 1e-6, (label, seg)
        assert stats["requests"] == 3 and stats["batches"] == 1 and stats["errors"] == 0, stats
        assert k1 == n_layer * passes > 0, (k1, passes)
        _, _, metrics = http(base + "/metrics")
        walls = {label: json.loads(answers[label][2]).get("wall_s") for label, *_ in requests}
        print(
            f"[serve] 3 concurrent POSTs ({'/'.join(f'{s:.0f}' for s in SERVE_AUDIO_S)} s: WAV, raw PCM i16 at "
            f"44.1 kHz, multipart verbose_json): all 200, {stats['requests']} requests in "
            f"{stats['batches']} batch; client wall {wall:.3f} s, per request "
            f"{[round(answers[label][3], 3) for label, *_ in requests]} s; server wall_s {walls}; "
            f"batch wall {stats['total_wall_s']:.3f} s; throughput_rtf {server.batcher.throughput_rtf:.2f}x; "
            f"encoder passes {passes}, K1 launches {k1} (= {n_layer} x {passes}); /metrics "
            f"{len(metrics.decode().splitlines())} lines; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (random weights: every decode runs "
            f"its 224 steps, a worst case)"
        )

        # (c) align and diarize over HTTP (phase 4c's aligner checkpoint)
        audio = synth_speech(SERVE_ALIGN_S, seed=10)
        t0 = time.perf_counter()
        status, _, body = http(url + "?align=true&diarize=true", wav_bytes(audio), {"Content-Type": "audio/wav"})
        align_wall = time.perf_counter() - t0
        payload = json.loads(body)
        assert status == 200 and payload["segments"] and payload["word_segments"], payload
        assert server._aligners["en"][1]["random_weights"] is False
        assert server._diarizer.device.type == "cuda"
        for seg in payload["segments"]:
            assert str(seg.get("speaker", "")).startswith("SPEAKER_"), seg
            for w in seg["words"]:
                if "start" in w:
                    assert seg["start"] <= w["start"] <= w["end"] <= seg["end"] + ALIGN_END_SLACK_S, (seg, w)
        n_words = sum(len(s["words"]) for s in payload["segments"])
        print(
            f"[serve] POST ?align=true&diarize=true of {SERVE_ALIGN_S:.0f} s: 200 in {align_wall:.3f} s "
            f"(server wall_s {payload['wall_s']}); {len(payload['segments'])} segments, each with a speaker "
            f"({sorted({s['speaker'] for s in payload['segments']})}), {n_words} words inside their segments"
        )

        # (d) two WebSocket sessions, one after the other, each paced at
        # real time in 0.5 s binary frames: one with partials, one
        # diarized online. Random weights decode every token of the budget
        # (8-12 s a decode on this model), longer than the 5 s latency cap,
        # so after a session's first flush every tick is forced: a session
        # yields at most one partial (the first, before any flush). (Run at
        # once, the two sessions' decode loops slowed each other so far
        # that a partial outlasted a 16 s stream.)
        sessions = {
            "partials": ("/v1/ws?format=i16&partial_interval=2",
                         synth_speech(SERVE_STREAM_S["partials"], seed=11)),
            "diarize": ("/v1/ws?format=i16&diarize=true", synth_speech(SERVE_STREAM_S["diarize"], seed=12)),
        }
        GLOBAL_TRACKER.reset()
        flash_attention.launches = 0
        summary = {}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for name, (path, audio) in sessions.items():
                pcm = (audio * 32767).astype(np.int16)
                ws = WSClient(port, path)
                t0 = time.monotonic()
                for n, i in enumerate(range(0, len(pcm), 8000)):
                    ws.send(0x2, pcm[i:i + 8000].tobytes())
                    time.sleep(max(0.0, t0 + 0.5 * (n + 1) - time.monotonic()))
                ws.send(0x1, json.dumps({"op": "end"}).encode())
                assert ws.closed.wait(600), f"{name}: the session did not close"
                ws.sock.close()
                assert ws.error is None, ws.error
                results = [(t - t0, msg) for t, msg in ws.messages if msg["op"] == "result"]
                ends = [msg for _, msg in ws.messages if msg["op"] == "end"]
                assert len(ends) == 1 and ends[0]["result_count"] == len(results), (name, ends, len(results))
                partials = [(t, r) for t, r in results if r["provisional"]]
                finals = [(t, r) for t, r in results if not r["provisional"]]
                summary[name] = (partials, finals)
                lat = np.array([r["latency_s"] for _, r in finals])
                print(
                    f"[serve] WebSocket session '{name}' of {SERVE_STREAM_S[name]:.0f} s (i16 frames of 0.5 s at real "
                    f"time): {len(partials)} partials at {[round(t, 3) for t, _ in partials]} s, {len(finals)} "
                    f"finals at {[round(t, 3) for t, _ in finals]} s covering "
                    f"{[(r['start'], r['end']) for _, r in finals]} s, "
                    f"{sum(r['prompted'] for _, r in finals)} prompted; finals' latency_s p50 "
                    f"{np.percentile(lat, 50):.3f} s, p95 {np.percentile(lat, 95):.3f} s; server latency_stats "
                    f"{ends[0]['latency']}"
                    + (f"; speakers {[[seg.get('speaker') for seg in r['segments']] for _, r in finals]}"
                       if name == "diarize" else "")
                )
        # a chunk whose diarization failed only warns in the server: here
        # that is a failure, as is a final without a speaker
        failed = [str(w.message) for w in caught if "diarization failed" in str(w.message)]
        assert not failed, failed
        k1 = flash_attention.launches
        passes = GLOBAL_TRACKER.report().get("decode", {"calls": 0})["calls"]
        for name, (partials, finals) in summary.items():
            bounds = [(r["start"], r["end"]) for _, r in finals]
            assert bounds and bounds[0][0] == 0.0, (name, bounds)
            assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:])), (name, bounds)
            assert abs(bounds[-1][1] - SERVE_STREAM_S[name]) < 1e-6, (name, bounds)
        partials, finals = summary["partials"]
        assert partials and partials[0][0] < finals[0][0], [(t, r["provisional"]) for t, r in partials + finals]
        _, dfinals = summary["diarize"]
        # the synthetic speech pauses from 2.87 s: the first chunk ends on
        # that silence, before the 5 s cap could force it; then a flush by
        # the cap and the tail
        assert dfinals[0][1]["end"] <= 4.0, dfinals[0][1]
        assert len(dfinals) >= 3, [(round(t, 3), r["start"], r["end"]) for t, r in dfinals]
        labelled = [r for _, r in dfinals if r["segments"]]
        assert labelled and all(
            str(seg.get("speaker", "")).startswith("SPEAKER_") for r in labelled for seg in r["segments"]
        ), [[seg.get("speaker") for seg in r["segments"]] for _, r in dfinals]
        n_partials = sum(len(p) for p, _ in summary.values())
        assert k1 == n_layer * (passes + n_partials) > 0, (k1, passes, n_partials)
        print(
            f"[serve] K1 launches over both sessions {k1} (= {n_layer} x ({passes} final decodes + "
            f"{n_partials} partial decodes)); worst case: random weights decode every token of the budget"
        )

        # repeated partials of one utterance at full width: the second,
        # of the same audio, agrees with the first, so the third replays
        # the committed tokens as its decode prefix
        from whisperx_tpu_torch.serve.streaming import IncrementalUtteranceDecoder

        utterance = synth_speech(4.0, seed=13)
        dec = IncrementalUtteranceDecoder(pipe.model, language="en", token_budget=64)
        flash_attention.launches = 0
        t0 = time.perf_counter()
        infos = [dec.partial(utterance[: int(e * 16000)]) for e in (3.0, 3.0, 4.0)]
        inc_wall = time.perf_counter() - t0
        prev = []
        for info in infos:
            stable = info["stable_tokens"]
            assert stable == info["tokens"][: len(stable)] and stable[: len(prev)] == prev, infos
            prev = stable
        assert infos[2]["replayed"] >= IncrementalUtteranceDecoder.PREFIX_BUCKET, infos[2]
        assert flash_attention.launches == n_layer * len(infos), flash_attention.launches
        print(
            f"[serve] IncrementalUtteranceDecoder (budget 64) over 3/3/4 s of one utterance: "
            f"{[len(i['stable_tokens']) for i in infos]} committed tokens, replayed "
            f"{[i['replayed'] for i in infos]}, generated {[i['generated'] for i in infos]}; "
            f"{inc_wall:.3f} s for the three; K1 launches {flash_attention.launches} (= {n_layer} x 3)"
        )

        # the entry point's --warmup_streaming on this model, at a 0 s cap
        # (every tick flushes) and a partial budget of 64: the 1 s chunk
        # bucket, one chunk decoded with a PROMPT_TOKENS prompt (random
        # weights' text is too short for a stream to reach one), a first
        # partial and one replayed prefix bucket
        from whisperx_tpu_torch.serve import warmup_streaming

        GLOBAL_TRACKER.reset()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        calls = warmup_streaming(serve_pipe, max_latency_seconds=0.0, partial_token_budget=64, language="en")
        warm_wall = time.perf_counter() - t0
        passes = GLOBAL_TRACKER.report().get("decode", {"calls": 0})["calls"]
        assert calls == 4, calls
        assert flash_attention.launches == n_layer * (passes + 2) and passes >= 2, (flash_attention.launches, passes)
        print(
            f"[serve] warmup_streaming(max_latency_seconds=0, partial_token_budget=64): {calls} calls "
            f"(1 chunk bucket, 1 prompted, 2 partials) in {warm_wall:.3f} s; K1 launches "
            f"{flash_attention.launches} (= {n_layer} x ({passes} chunk decodes + 2 partial decodes))"
        )
    finally:
        server.shutdown()
    # (e) the precision flags are the caller's again
    assert flags() == flags_before, (flags(), flags_before)
    print(f"[serve] precision flags after the phase as before it: {flags_before}; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")


def phase_parallel(pipe) -> None:
    """Phase 13: scale-out (``whisperx_tpu_torch.parallel``) on one card,
    whose device repeats in every mesh. (a) ``DataParallelPipeline`` over
    ``make_mesh(n_data=2, devices=[cuda:0, cuda:0])`` (two replicas, one
    model, two worker threads) on 60 s of the main path's audio at one
    temperature: its segments equal the plain pipeline's at the replicas'
    batch (each replica decodes 4 of the 8 rows), K1 32 × 2 per decode.
    (b) ``n_model=2`` on the main path's model: the bf16 encoder output and
    the first decode step's logits within TP_BF16_FACTOR × the whole
    model's own bf16 error against f32 arithmetic on the same weights, of
    the whole model's and of f32's; K1 64 per encoder pass; then the f32 copy of those weights,
    TF32 off, whose greedy tokens on 4 windows over 24 steps must be the
    whole f32 model's; and test-nano with int8 weights (f32 activations):
    its tokens unchanged by the split, K4 launched. (c) two ``python -m
    whisperx_tpu_torch`` processes with torchrun's variables (RANK 0 and
    1, WORLD_SIZE 2, both on cuda:0) transcribe three test-nano clips: the
    files each owns are disjoint and cover the list, each output is written
    by its owner. The main path's model is left split: the phase runs last
    on it."""
    import copy
    import warnings

    import numpy as np
    import torch
    import torch.nn.functional as F

    from whisperx_tpu_torch.audio import log_mel_batch, save_wav
    from whisperx_tpu_torch.decoding import DecodingOptions, decode
    from whisperx_tpu_torch.decoding.decode import decode_dispatch
    from whisperx_tpu_torch.models.whisper import load_model as load_whisper
    from whisperx_tpu_torch.models.whisper.model import (
        KVCache,
        SplitLinear,
        decoder_forward,
        encoder_forward,
        new_self_cache,
        precompute_cross_kv,
    )
    from whisperx_tpu_torch.ops.cross_attention_decode import cross_attention_decode
    from whisperx_tpu_torch.ops.flash_attention import (
        _attention_reference,
        flash_attention,
        wholek_attention,
    )
    from whisperx_tpu_torch.ops.quant_matmul import quant_matmul
    from whisperx_tpu_torch.parallel import DataParallelPipeline, make_mesh, shard_params_tp
    from whisperx_tpu_torch.quant import quantize_model
    from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER

    from whisperx_tpu_torch.decoding.step_graph import StepGraph

    model = pipe.model
    dims = model.dims
    n_layer = dims.n_audio_layer
    cuda0 = torch.device("cuda", 0)
    main_audio = synth_speech(MAIN_AUDIO_S, seed=1)

    # the whole model's f32 twin (the bf16 weights, widened), taken first
    t0 = time.perf_counter()
    m32 = copy.deepcopy(model).float()
    torch.cuda.synchronize()
    print(f"[parallel] f32 copy of the main path's weights {time.perf_counter() - t0:.2f} s")

    # (a) data parallelism: two replicas on one card
    audio = main_audio[: int(PARALLEL_AUDIO_S * 16000)]
    opts = dict(language="en", temperatures=(0.0,), sample_len=PARALLEL_SAMPLE_LEN)
    plain, plain_s = {}, {}
    for bs in (8, 4):
        t0 = time.perf_counter()
        plain[bs] = pipe.transcribe(audio, batch_size=bs, **opts)
        torch.cuda.synchronize()
        plain_s[bs] = time.perf_counter() - t0
        print(f"[parallel] plain pipeline, batch {bs}: {len(plain[bs]['segments'])} segments in "
              f"{plain_s[bs]:.3f} s")
    mesh = make_mesh(n_data=2, devices=[cuda0, cuda0])
    dp = DataParallelPipeline(pipe, mesh=mesh)
    assert model._dp_replicas == [model, model], "rows of one device share one replica"
    # each replica's steps replay a captured graph, on an entry of its own:
    # replays counted per (worker thread, entry)
    real_step, replays = StepGraph.step, {}

    def step(self, body):
        if self.graph is not None:
            key = (threading.get_ident(), id(self))
            replays[key] = replays.get(key, 0) + 1
        real_step(self, body)

    GLOBAL_TRACKER.reset()
    flash_attention.launches = 0
    StepGraph.step = step
    try:
        t0 = time.perf_counter()
        got = dp.transcribe(audio, batch_size=8, **opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        StepGraph.step = real_step
    decodes = GLOBAL_TRACKER.report()["decode"]["calls"]
    k1 = flash_attention.launches
    assert k1 == n_layer * 2 * decodes > 0, (k1, decodes)
    assert got["segments"] == plain[4]["segments"] and got["segments"], (got, plain[4])
    threads = {t for t, _ in replays}
    entries = {e for _, e in replays}
    assert len(entries) >= 2 and len(threads) >= 2, replays  # both replicas' entries replayed
    print(
        f"[parallel] DataParallelPipeline over {mesh}: {PARALLEL_AUDIO_S:.0f} s in {wall:.3f} s against "
        f"the plain pipeline's {plain_s[8]:.3f} s at batch 8 and {plain_s[4]:.3f} s at batch 4 "
        f"({wall / plain_s[8]:.3f}x); {len(got['segments'])} segments equal to the plain pipeline's at "
        f"batch 4 (each replica's rows); equal to batch 8's: {got['segments'] == plain[8]['segments']}; "
        f"{decodes} decodes, K1 launches {k1} (= {n_layer} x 2 replicas x {decodes}); replays "
        f"{sum(replays.values())} on {len(entries)} cache entries from {len(threads)} worker threads "
        f"(each replica's decode its own entry); {card_line()}"
    )

    # (b) tensor parallelism over two shards of one card
    windows = np.stack(np.split(main_audio, TP_BATCH))  # 4 windows of 30 s
    mel32 = log_mel_batch(windows, dims.n_mels, device="cuda")
    mel16 = mel32.to(torch.bfloat16)
    prefix = torch.tensor([[50258, 50259, 50360]] * 2, device="cuda")

    @torch.inference_mode()
    def first_step(m, mel):
        """The encoder output and the first decode step's logits (the
        prefill of the SOT sequence) of two windows, in f32."""
        feats = encoder_forward(m.encoder, mel[:2], dims.n_audio_head)
        ck, cv = precompute_cross_kv(m.decoder, feats, dims.n_text_head)
        cache = KVCache(*new_self_cache(m.decoder, 2, 64, dims.n_text_head), ck, cv)
        logits = decoder_forward(m.decoder, prefix, cache, 0, dims.n_text_head)[:, -1]
        return feats.float(), logits.float()

    tp_opts = DecodingOptions(language="en", sample_len=TP_SAMPLE_LEN, kv_quant=True)
    enc16, log16 = first_step(model, mel16)
    enc32, log32 = first_step(m32, mel32)
    t0 = time.perf_counter()
    want32 = decode(m32, mel32, tp_opts)
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    mesh_tp = make_mesh(n_data=1, n_model=2, devices=[cuda0, cuda0])
    for m in (model, m32):
        shard_params_tp(m, mesh_tp)
    blk = model.encoder.blocks[0]
    assert isinstance(blk.attn.query, SplitLinear) and [h1 - h0 for _, h0, h1 in blk.tp.heads] == [10, 10]
    # K1 at a shard's shape: batch 8 of the main path, 10 of the 20 heads
    bh, t, d = PROFILE_BATCH * 10, 1500, 64
    q, k, v = attention_case(bh, t, d, torch.bfloat16, seed=3)
    err_k1 = check_attention("K1 TP shard", wholek_attention(q, k, v), _attention_reference(q, k, v),
                             1e-2, q.shape)
    e = kernel_entry("K1 TP shard", "flash_attention.cu", "whisperx_tpu/ops/flash_attention.py:125",
                     err_k1, cuda_ms(lambda: wholek_attention(q, k, v)),
                     cuda_ms(lambda: _attention_reference(q, k, v), iters=5),
                     4 * bh * t * d * 2, 4 * bh * t * t * d, PEAK_OPS_PER_S["torch.bfloat16"],
                     cuda_ms(lambda: F.scaled_dot_product_attention(q[None], k[None], v[None])))
    print(f"[parallel] K1 at a TP shard's shape [{bh}, {t}, {d}] bf16: kernel {e['ms']:.4f} ms, plain "
          f"{e['plain_ms']:.4f} ms, sdpa {e['library_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms by "
          f"{e['bound_by']}; {card_line()}")
    del q, k, v
    flash_attention.launches = 0
    enc_tp, log_tp = first_step(model, mel16)
    torch.cuda.synchronize()
    assert flash_attention.launches == 2 * n_layer, flash_attention.launches  # 64 per encoder pass
    # the tolerance: TP_BF16_FACTOR × the whole bf16 model's own error
    # against f32 arithmetic on the same weights (its rounding); the split
    # may move a value by that much from the whole model and from f32
    for what, tp, whole, f32 in (("encoder", enc_tp, enc16, enc32), ("logits", log_tp, log16, log32)):
        e_split, e_f32, e_bf16 = ((a - b).abs() for a, b in ((tp, whole), (tp, f32), (whole, f32)))
        tol = TP_BF16_FACTOR * e_bf16.max().item()
        print(
            f"[parallel] TP bf16 {what}: max |split - whole| {e_split.max().item():.6f} (mean "
            f"{e_split.mean().item():.2e}), max |split - f32| {e_f32.max().item():.6f}, whole bf16 "
            f"vs f32 {e_bf16.max().item():.6f} (mean {e_bf16.mean().item():.2e}); tolerance {tol:.6f}"
        )
        assert e_split.max().item() <= tol and e_f32.max().item() <= tol, what
    flash_attention.launches = 0
    t0 = time.perf_counter()
    got32 = decode(m32, mel32, tp_opts)
    torch.cuda.synchronize()
    split_s = time.perf_counter() - t0
    assert flash_attention.launches == 2 * n_layer, flash_attention.launches
    assert [r.tokens for r in got32] == [r.tokens for r in want32], "TP f32 tokens"
    assert all(len(r.tokens) == TP_SAMPLE_LEN for r in got32)
    lp = max(abs(a.avg_logprob - b.avg_logprob) for a, b in zip(got32, want32))
    print(
        f"[parallel] TP f32 (TF32 off), batch {TP_BATCH}, {TP_SAMPLE_LEN} steps: tokens identical "
        f"to the whole f32 model's; max |avg_logprob diff| {lp:.2e}; decode {split_s:.3f} s split, "
        f"{whole_s:.3f} s whole; K1 {2 * n_layer} per encoder pass"
    )
    del m32, want32, got32
    torch.cuda.empty_cache()

    # K3 on the split model, the default route of its bf16 steps: each
    # shard's one-token cross-attention over its own heads' int8 cache
    cross_attention_decode.launches = 0
    h = decode_dispatch(model, mel16, DecodingOptions(language="en", sample_len=8, kv_quant=True))
    torch.cuda.synchronize()
    want = dims.n_text_layer * 2 * h["steps"]
    assert cross_attention_decode.launches == want > 0, (cross_attention_decode.launches, want)
    print(f"[parallel] K3, bf16 split over 2, batch {TP_BATCH}: launched {want} times "
          f"(= {dims.n_text_layer} layers x 2 shards x {h['steps']} steps) on [{TP_BATCH}, 1, 10, 64] "
          f"head slices")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the partial vocabulary's notice
        nano = quantize_model(load_whisper("test-nano", dtype=torch.float32, device="cuda"), "int8")
        mel_nano = log_mel_batch(windows, nano.dims.n_mels, device="cuda")
        want = decode(nano, mel_nano, tp_opts)
        shard_params_tp(nano, mesh_tp)
        quant_matmul.launches = 0
        got = decode(nano, mel_nano, tp_opts)
    assert [r.tokens for r in got] == [r.tokens for r in want], "TP int8 test-nano tokens"
    assert quant_matmul.launches > 0
    print(f"[parallel] test-nano int8 (f32 activations) split over 2: tokens identical to the whole "
          f"model's; K4 launched {quant_matmul.launches} times on the whole quantized linears")

    # (c) two processes, torchrun's variables, one card
    with tempfile.TemporaryDirectory() as root:
        wavs = []
        for i in range(3):
            wavs.append(os.path.join(root, f"clip{i}.wav"))
            save_wav(wavs[-1], synth_speech(2.0, seed=20 + i))
        env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
        env.update(PYTHONPATH=REPO, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
        t0 = time.perf_counter()
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "whisperx_tpu_torch", *wavs, "--device", "cuda",
                 "--model", "test-nano", "--vad_method", "energy", "--language", "en", "--no_align",
                 "--beam_size", "1", "--temperature_increment_on_fallback", "None", "-f", "json",
                 "-o", os.path.join(root, f"out{rank}")],
                env={**env, "RANK": str(rank), "LOCAL_RANK": str(rank)}, cwd=root,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for rank in (0, 1)
        ]
        try:
            outs = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for p, (so, se) in zip(procs, outs):
            assert p.returncode == 0, (p.returncode, so[-2000:], se[-3000:])
        owned = [sorted(os.listdir(os.path.join(root, f"out{rank}"))) for rank in (0, 1)]
        assert ">>Host 0/2: 2 of 3 files" in outs[0][0] and ">>Host 1/2: 1 of 3 files" in outs[1][0]
        assert owned == [["clip0.json", "clip2.json"], ["clip1.json"]], owned
    print(f"[parallel] two processes (RANK 0, 1 of WORLD_SIZE 2) on cuda:0: files {owned[0]} and "
          f"{owned[1]}, disjoint and covering, each written by its owner; {wall:.1f} s")


def phase_small_serving(models: dict) -> None:
    """Phase 7's serving checks: the f32 test-nano server over the CUDA
    pipeline and over the CPU pipeline (the same weights) gives the same
    body for one WAV POST and the same finals for one long-poll stream;
    then ``python -m whisperx_tpu_torch.serve --device cuda`` as a
    subprocess answers /healthz and one POST, and exits 0 on SIGTERM.

    The stream's max-latency flush is a wall-clock cut: a chunk decode that
    outlasts it on the CPU and not on the card splits the stream at other
    places, so the comparison sets it out of reach (as the CPU tests do)
    and the stream is cut at its silences only."""
    import dataclasses
    import functools
    import signal
    import urllib.error

    import numpy as np

    import whisperx_tpu_torch.serve.server as server_module
    from whisperx_tpu_torch.asr import TranscriptionPipeline
    from whisperx_tpu_torch.convert.checkpoint import save_checkpoint
    from whisperx_tpu_torch.serve import BatchConfig, StreamingConfig, TranscriptionServer
    from whisperx_tpu_torch.vad import EnergyVAD

    clip = synth_speech(12.0, seed=12)
    gap = np.zeros(16000, np.float32)
    stream = np.concatenate([synth_speech(3.0, seed=13), gap, synth_speech(2.5, seed=14), gap])
    pcm = {"Content-Type": "audio/x-raw-pcm", "X-Format": "f32"}
    got = {}
    server_module.StreamingConfig = functools.partial(StreamingConfig, max_latency_seconds=1e9)
    try:
        for dev, model in models.items():
            server = TranscriptionServer(
                TranscriptionPipeline(model=model, vad_model=EnergyVAD(), asr_options={"temperatures": (0.0,)}),
                model_name="test-nano", batch_config=BatchConfig(max_wait_ms=5),
            )
            base = f"http://127.0.0.1:{server.start_background(port=0)}"
            try:
                _, _, body = http(base + "/v1/audio/transcriptions?language=en", wav_bytes(clip),
                                  {"Content-Type": "audio/wav"})
                post = json.loads(body)
                post.pop("request_id"), post.pop("wall_s")
                sid = json.loads(http(base + "/v1/stream/start?language=en", b"")[2])["stream_id"]
                for i in range(0, len(stream), 8000):
                    http(base + f"/v1/stream/{sid}/audio", stream[i:i + 8000].tobytes(), pcm)
                end = json.loads(http(base + f"/v1/stream/{sid}/end", b"")[2])
                finals = [{k: v for k, v in r.items() if k != "latency_s"} for r in end["all_results"]]
                got[dev] = (post, finals)
            finally:
                server.shutdown()
    finally:
        server_module.StreamingConfig = StreamingConfig
    assert got["cuda"] == got["cpu"], got
    assert got["cuda"][0]["segments"] and got["cuda"][1], got["cuda"]
    print(
        f"[small] test-nano f32 server: the same POST body ({len(got['cuda'][0]['segments'])} segments) "
        f"and the same {len(got['cuda'][1])} stream finals on cuda and cpu"
    )

    with tempfile.TemporaryDirectory() as root:
        ckpt = os.path.join(root, "nano")
        model = models["cpu"]
        save_checkpoint(ckpt, model, {"name": "test-nano", "family": "whisper",
                                      "dims": dataclasses.asdict(model.dims)})
        port = free_port()
        proc = subprocess.Popen(
            [sys.executable, "-m", "whisperx_tpu_torch.serve", "--model", ckpt, "--device", "cuda",
             "--port", str(port), "--no_warmup", "--temperature_increment_on_fallback", "0"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": REPO},
        )
        try:
            t0 = time.perf_counter()
            while True:
                try:
                    status, _, body = http(f"http://127.0.0.1:{port}/healthz", timeout=5)
                    break
                except (urllib.error.URLError, ConnectionError):
                    assert proc.poll() is None, proc.stdout.read().decode()
                    assert time.perf_counter() - t0 < 180, "serve did not come up in 180 s"
                    time.sleep(0.5)
            up = time.perf_counter() - t0
            assert status == 200 and json.loads(body)["status"] == "ok", body
            status, _, body = http(
                f"http://127.0.0.1:{port}/v1/audio/transcriptions?language=en", wav_bytes(clip),
                {"Content-Type": "audio/wav"},
            )
            assert status == 200 and json.loads(body)["language"] == "en", body
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=10)
            down = time.perf_counter() - t1
            said = proc.stdout.read().decode()
            assert rc == 0, (rc, said)
            assert "serving" in said and "on cuda" in said, said
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(
        f"[small] python -m whisperx_tpu_torch.serve --device cuda (test-nano checkpoint): /healthz 200 "
        f"after {up:.1f} s, one POST 200, exit 0 {down:.2f} s after SIGTERM"
    )


# phase 14 (the trainers): one step of each loss, CUDA against the CPU, is
# held to these: the loss within TRAIN_LOSS_RTOL relative; each gradient
# tensor within TRAIN_GRAD_RTOL of its largest CPU entry (TF32 off on both;
# the order of f32 sums differs, and the CUDA embedding and CTC backwards
# sum with atomics)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
# the CTC loss's gradients: its forward-backward adds log-probabilities in
# f32 over 239 frames to a row NLL of ~317 (random weights), whose f32 ulp
# (3e-5) is already ~1e-4 of the terms exp(alpha + beta - NLL). Held
# between two readings that `ctc_gate_witnesses` takes in every run: with
# the CTC's sums in f64 the devices agree within TRAIN_GRAD_RTOL, and the
# same step with TF32 on (a precision leak) must fall outside this limit.
# On an H100 80GB HBM3 at 700 W: f32 1.30e-4, f64 CTC 3.22e-6, TF32 1.20e-3
TRAIN_CTC_GRAD_RTOL = 3e-4
TRAIN_WINDOWS = 4  # test-nano windows of the CUDA-against-CPU steps
FULL_ONLINE_WINDOWS, FULL_B_WINDOWS, FULL_STEPS = 8, 2, 3
CTC_ROWS = 16  # wav2vec2 BASE_CONFIG rows of 4.8 s


def train_step_at(device: str, loss_name: str, whisper, w2v, batch: dict, ctc_rows: tuple):
    """One loss of the trainers and its gradients on ``device``, from copies
    of the same weights: (loss, {name: gradient on the CPU}, K1 launches).
    The data are numpy arrays, moved to ``device``."""
    import copy

    import torch

    from whisperx_tpu_torch.audio.mel import _log_mel_batch_body
    from whisperx_tpu_torch.ops.flash_attention import flash_attention
    from whisperx_tpu_torch.train import align_micro as am, align_online as ao, ctc_micro as cm
    from whisperx_tpu_torch.train import micro as mi
    from whisperx_tpu_torch.models.whisper.model import precompute_cross_kv

    dev = torch.device(device)
    t = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    heads = am.alignment_heads_of(whisper.dims)
    k1_before = flash_attention.launches
    if loss_name.startswith("ctc loss_fn"):
        model = copy.deepcopy(w2v).to(dev)
        named = [(n, p.requires_grad_(True)) for n, p in model.named_parameters()]
        fn = ctc_loss_f64 if loss_name.endswith("in f64") else cm.loss_fn
        loss = fn(model, *(torch.from_numpy(x).to(dev) for x in ctc_rows))
    else:
        model = copy.deepcopy(whisper).to(dev)
        dims, dec = model.dims, model.decoder
        feats = ao.features(model.encoder, t["a16"], dims.n_mels, dims.n_audio_head)
        view = None
        if loss_name in ("micro loss_active", "micro loss_full"):
            body = mi.decoder_params(dec)
        elif loss_name != "align loss_b":
            body = mi.decoder_params(dec, frozen=())
        if loss_name in ("micro loss_active", "align loss_a", "online loss_compact"):
            small = mi.gather_rows(dec.tok_emb, t["active"])
            view = mi.compact_decoder(dec, small)
            named = [("tok_emb (compact)", small)]
        elif loss_name == "micro loss_full":
            named = [("tok_emb", dec.tok_emb.requires_grad_(True))]
        if loss_name == "align loss_b":
            named = [(n, p.requires_grad_(True)) for n, p in model.named_parameters()]
        else:
            named += [(n, p) for n, p in dec.named_parameters() if any(p is b for b in body)]
        rows = [t[n] for n in ("tsk", "tsm", "ntk", "ntm", "at", "aw")]
        if loss_name == "micro loss_active":
            with torch.no_grad():
                ck, cv = precompute_cross_kv(dec, feats, dims.n_text_head)
            tsk, tsm = t["tsk"], t["tsm"]
            loss = mi.loss_active(view, tsk, t["remap"][tsk[:, 1:]], tsm, t["remap"], ck, cv)
        elif loss_name == "micro loss_full":
            with torch.no_grad():
                ck, cv = precompute_cross_kv(dec, feats, dims.n_text_head)
            loss = mi.loss_full(dec, t["tsk"], t["tsm"], ck, cv)
        elif loss_name == "align loss_a":
            r = t["remap"]
            tsk, tsm, ntk, ntm, at, aw = rows
            loss = am.loss_a(view, feats, tsk, r[tsk[:, 1:]], tsm, ntk, r[ntk[:, 1:]], ntm, at, aw, r, heads)
        elif loss_name == "align loss_b":
            mel = _log_mel_batch_body(t["a16"].float() / 32768.0, dims.n_mels)
            loss, _ = am.loss_b(model, mel, *rows, heads)
        else:
            loss = ao.loss_compact(view, feats, *rows, t["remap"], heads)
    loss.backward()
    grads = {n: p.grad.detach().cpu() for n, p in named}
    return float(loss.detach()), grads, flash_attention.launches - k1_before


def ctc_loss_f64(model, batch, logit_pad, lab, lab_pad) -> "torch.Tensor":
    """``ctc_micro.loss_fn`` with the model's f32 log-probs widened to f64
    before ``F.ctc_loss``: the same forward, the CTC's own sums in f64."""
    import torch.nn.functional as F

    from whisperx_tpu_torch.models.wav2vec2.model import forward

    logp = forward(model, batch).double()
    in_len = (1 - logit_pad).sum(1).long()
    tgt_len = (1 - lab_pad).sum(1).long()
    return F.ctc_loss(logp.transpose(0, 1), lab.long(), in_len, tgt_len, blank=0, reduction="none").mean()


def grad_gap(g0: dict, g1: dict):
    """The worst ``max |g1 - g0|`` over the gradient tensors, each over the
    largest entry of its ``g0``, and that tensor's name. An attention key
    bias shifts a query's scores alike: its exact gradient is 0 and both
    sides give rounding noise, held to the largest gradient of the model."""
    assert set(g0) == set(g1)
    largest = max(float(g.abs().max()) for g in g0.values())
    worst, worst_name = 0.0, ""
    for name, g in g0.items():
        scale = largest if name.endswith("attn.key.b") else float(g.abs().max())
        err = float((g1[name] - g).abs().max()) / scale
        if math.isnan(err):
            return err, name
        if err > worst:
            worst, worst_name = err, name
    return worst, worst_name


def same_step(label: str, cpu, cuda, grad_rtol: float = TRAIN_GRAD_RTOL) -> None:
    """A loss and its gradients, CUDA against the CPU (``train_step_at``)."""
    (l0, g0, _), (l1, g1, _) = cpu, cuda
    rel = abs(l1 - l0) / abs(l0)
    assert math.isfinite(l1) and rel <= TRAIN_LOSS_RTOL, (label, l0, l1)
    worst, worst_name = grad_gap(g0, g1)
    assert worst <= grad_rtol, (label, worst_name, worst, grad_rtol)
    print(
        f"[train] {label}: loss cpu {l0:.7f} cuda {l1:.7f} (rel {rel:.2e}); {len(g0)} gradient "
        f"tensors, worst |cuda - cpu| / max|cpu| {worst:.2e} ({worst_name}; tol {grad_rtol:g}); ok"
    )


def ctc_gate_witnesses(cpu, cuda, *args) -> None:
    """The two readings that place TRAIN_CTC_GRAD_RTOL, taken beside the
    CTC gate on the same weights and rows (``args`` as ``train_step_at``'s
    after the loss's name): with the CTC's sums in f64 (``ctc_loss_f64``)
    on both devices, the gradients must agree within TRAIN_GRAD_RTOL, so
    the f32 gap is the CTC's own rounding (the CPU's f32 step against its
    f64 one, and the card's, are printed beside it); and the f32 step on the card with TF32
    on for the matmuls and cuDNN (forward and backward), a control, must
    fall outside TRAIN_CTC_GRAD_RTOL."""
    import torch

    cpu64 = train_step_at("cpu", "ctc loss_fn, CTC in f64", *args)
    cuda64 = train_step_at("cuda", "ctc loss_fn, CTC in f64", *args)
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = m.allow_tf32, c.allow_tf32
    m.allow_tf32 = c.allow_tf32 = True
    try:
        tf32 = train_step_at("cuda", "ctc loss_fn", *args)
        torch.cuda.synchronize()
    finally:
        m.allow_tf32, c.allow_tf32 = saved
    sound, f64, rounding, card_rounding, control = (
        grad_gap(cpu[1], cuda[1]), grad_gap(cpu64[1], cuda64[1]), grad_gap(cpu64[1], cpu[1]),
        grad_gap(cuda64[1], cuda[1]), grad_gap(cpu[1], tf32[1]),
    )
    print(
        "[train] ctc loss_fn, the gate's witnesses (worst |g - g_ref| / max|g_ref|): CUDA against the "
        f"CPU in f32 {sound[0]:.2e} ({sound[1]}); with the CTC in f64 {f64[0]:.2e} ({f64[1]}; tol "
        f"{TRAIN_GRAD_RTOL:g}); f32 CTC against f64 on the CPU {rounding[0]:.2e} ({rounding[1]}), "
        f"on the card {card_rounding[0]:.2e} ({card_rounding[1]}); "
        f"control, TF32 on, CUDA against the CPU {control[0]:.2e} ({control[1]}; must exceed "
        f"{TRAIN_CTC_GRAD_RTOL:g}); losses f32 cpu {cpu[0]:.7f} cuda {cuda[0]:.7f} tf32 {tf32[0]:.7f}, "
        f"f64 cpu {cpu64[0]:.7f} cuda {cuda64[0]:.7f}"
    )
    assert f64[0] <= TRAIN_GRAD_RTOL, ("the CTC gate's f64 witness", f64)
    assert control[0] > TRAIN_CTC_GRAD_RTOL, ("the CTC gate's TF32 control passes the limit", control)


def profiled_step(step, label: str) -> str:
    """One more ``step()``, under ``torch.profiler``: its wall, the device's
    kernel time and K1's share of it, as a phrase of a ``[train]`` line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    assert events, f"[train] {label}: the profiler recorded no device activity"
    total = sum(ms for _, ms, _ in events)
    k1 = [(ms, n) for name, ms, n in events if "wholek_attention" in name]
    k1_ms, k1_n = sum(ms for ms, _ in k1), sum(n for _, n in k1)
    return (
        f"; a further step under the profiler: wall {wall:.1f} ms, {total:.1f} ms of kernels "
        f"(device busy {total / wall:.1%}), K1 {k1_ms:.1f} ms over {k1_n} launches "
        f"({k1_ms / total:.1%} of the kernel time)"
    )


def phase_train(k1_f32=None) -> None:
    """The trainers (``whisperx_tpu_torch/train/``) on the card: (a) one step
    of each trainer's loss at test-nano, CUDA against the CPU on copies of
    the same weights and the same 4 windows (K1 2 per encoder pass; in
    ``loss_b`` the encoder's gradients through K1's gradient rule, non-zero
    and the CPU's); (b) ``train_micro()`` to its certificate, whose
    checkpoint must transcribe a ``build_files`` recording exactly through
    ``load_model(path, device="cuda")``; (c) full width: large-v3 f32 steps
    of the online trainer (8 fresh windows, the encoder through K1) and of
    ``loss_b`` (2 windows, K1 and its gradient rule 32 each), wav2vec2
    BASE_CONFIG CTC steps (16 rows of 4.8 s): ms per step, peak memory, K1's
    share of the step's device time; (d) K1 in f32 at the online step's
    shape beside its gradient rule, SDPA and the bound."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    import whisperx_tpu_torch
    from whisperx_tpu_torch.audio.mel import _log_mel_batch_body
    from whisperx_tpu_torch.models.wav2vec2 import BASE_CONFIG, init_params as w2v_init
    from whisperx_tpu_torch.models.whisper import get_dims, load_model as load_whisper
    from whisperx_tpu_torch.ops import flash_attention as fa
    from whisperx_tpu_torch.train import align_micro as am, align_online as ao, ctc_micro as cm
    from whisperx_tpu_torch.train import micro as mi
    from whisperx_tpu_torch.train.optim import Adam
    from whisperx_tpu_torch.utils.precision import no_tf32_cudnn, reference_matmul

    # (a) CUDA against the CPU, test-nano
    nano = load_whisper("test-nano", dtype=torch.float32, device="cpu", seed=0)
    tok = mi.english_tokenizer(nano.dims)
    lex = mi._lexicon(mi.PHRASES)
    _, a16, tsk, tsm, ntk, ntm, at, aw = ao.make_batch(
        np.random.default_rng(2), TRAIN_WINDOWS, tok, lex, mi.PHRASES
    )
    active, remap = mi.active_remap(ao.active_ids(tok, mi.PHRASES))
    batch = dict(a16=a16, tsk=tsk, tsm=tsm, ntk=ntk, ntm=ntm, at=at, aw=aw, active=active, remap=remap)
    w2v = w2v_init(cm.micro_ctc_config(), torch.Generator().manual_seed(0))
    ctc_rows = cm.sample_rows(np.random.default_rng(7), TRAIN_WINDOWS, cm.micro_ctc_config(), cm.default_vocab())[:4]
    calls = {"n": 0}
    rule = fa.attention_backward

    def counted_rule(*args):
        calls["n"] += 1
        return rule(*args)

    fa.attention_backward = counted_rule
    try:
        with reference_matmul(), no_tf32_cudnn():
            for name in ("micro loss_active", "micro loss_full", "ctc loss_fn", "align loss_a",
                         "align loss_b", "online loss_compact"):
                cpu = train_step_at("cpu", name, nano, w2v, batch, ctc_rows)
                calls["n"] = 0
                cuda = train_step_at("cuda", name, nano, w2v, batch, ctc_rows)
                torch.cuda.synchronize()
                same_step(name, cpu, cuda, TRAIN_CTC_GRAD_RTOL if name == "ctc loss_fn" else TRAIN_GRAD_RTOL)
                if name == "ctc loss_fn":
                    ctc_gate_witnesses(cpu, cuda, nano, w2v, batch, ctc_rows)
                want_k1 = 0 if name == "ctc loss_fn" else nano.dims.n_audio_layer * (2 if name == "align loss_b" else 1)
                want_rule = nano.dims.n_audio_layer if name == "align loss_b" else 0
                assert cuda[2] == want_k1 and calls["n"] == want_rule, (name, cuda[2], calls["n"])
                if name == "align loss_b":
                    enc = {n: g for n, g in cuda[1].items() if n.startswith("encoder.blocks") and "attn.query" in n}
                    assert enc and all(float(g.abs().max()) > 0 for g in enc.values()), name
                    print(
                        f"[train] align loss_b: K1 {cuda[2]} launches (the features' encoder pass and "
                        f"loss_b's, {nano.dims.n_audio_layer} each), K1's gradient rule {calls['n']} "
                        f"calls; the encoder's attention gradients non-zero and the CPU's: max |g| "
                        + ", ".join(f"{n} {float(g.abs().max()):.3e}" for n, g in sorted(enc.items()))
                    )
    finally:
        fa.attention_backward = rule

    # (b) the whole micro trainer on the card
    fa.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, dims, report = mi.train_micro(device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = report["steps"] + report["full_steps"] + 95 * report["certify_rounds"]
    print(
        f"[train] train_micro(device='cuda'): {wall:.2f} s wall, {steps} optimizer steps "
        f"({steps / wall:.1f} steps/s), final loss {report['final_loss']:.6f}, min margin "
        f"{report['min_margin']} after {report['certify_rounds']} certify rounds (stops at 2.0 or 6), "
        f"{report['examples']} windows, K1 {fa.flash_attention.launches} launches"
    )
    assert fa.flash_attention.launches == dims.n_audio_layer, fa.flash_attention.launches
    assert report["final_loss"] < 0.05 and report["min_margin"] > 0.3, report
    with tempfile.TemporaryDirectory() as root:
        mi.save_micro_checkpoint(root, model, dims, report)
        pipe = whisperx_tpu_torch.load_model(
            root, device="cuda", language="en", vad_method="energy", task="transcribe"
        )
        for fi, (audio, events) in enumerate(mi.build_files()[:2]):
            spoken = " ".join(text.strip() for _, text in events)
            got = " ".join(
                s["text"].strip()
                for s in pipe.transcribe(audio, batch_size=8, chunk_size=mi.DEFAULT_CHUNK_SIZE)["segments"]
            )
            print(f"[train] the card-trained checkpoint, bf16 on cuda, file {fi}: {got!r}")
            assert got == spoken, (got, spoken)
    del model, pipe
    torch.cuda.empty_cache()

    # (c) full width: large-v3 f32 and wav2vec2 base
    large = load_whisper("large-v3", dtype=torch.float32, device="cuda", seed=0)
    dims = large.dims
    tok = mi.english_tokenizer(dims)
    heads = am.alignment_heads_of(dims)
    active, remap = (torch.from_numpy(x).cuda() for x in mi.active_remap(ao.active_ids(tok, mi.PHRASES)))
    dec = large.decoder
    rng = np.random.default_rng(0)
    fa.flash_attention.launches = 0  # K1's f32 route over the large-v3 steps, read after loss_b

    def online_batch(n):
        _, a16, *rows = ao.make_batch(rng, n, tok, lex, mi.PHRASES)
        return torch.from_numpy(a16).cuda(), [torch.from_numpy(x).cuda() for x in rows]

    def report_steps(label, ms, k1_each, extra=""):
        print(
            f"[train] {label}: ms per step {' '.join(f'{x:.1f}' for x in ms)} (host clock, synchronised; "
            f"median {float(np.median(ms)):.1f}); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; K1 {k1_each} launches a step{extra}"
        )

    with reference_matmul(), no_tf32_cudnn():
        body = mi.decoder_params(dec, frozen=())
        small = mi.gather_rows(dec.tok_emb, active)
        view = mi.compact_decoder(dec, small)
        opt = Adam([small, *body], 1.2e-3)

        def online_step(data):
            a16, rows = data
            feats = ao.features(large.encoder, a16, dims.n_mels, dims.n_audio_head)
            loss = ao.loss_compact(view, feats, *rows, remap, heads)
            loss.backward()
            opt.step()
            return float(loss.detach())

        torch.cuda.reset_peak_memory_stats()
        ms, host_ms = [], []
        for _ in range(FULL_STEPS):
            t0 = time.perf_counter()
            data = online_batch(FULL_ONLINE_WINDOWS)
            host_ms.append((time.perf_counter() - t0) * 1e3)
            before = fa.flash_attention.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = online_step(data)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            assert math.isfinite(loss) and fa.flash_attention.launches - before == dims.n_audio_layer, loss
        data = online_batch(FULL_ONLINE_WINDOWS)
        profiled = profiled_step(lambda: online_step(data), "online")
        report_steps(
            f"large-v3 f32 online step ({FULL_ONLINE_WINDOWS} fresh windows, loss_compact, Adam over the "
            f"decoder and {len(active)} compact rows; batch built on the host in "
            f"{float(np.median(host_ms)):.1f} ms, not in the step), last loss {loss:.4f}",
            ms, dims.n_audio_layer, profiled,
        )
        del opt, small, view, body
        for p in large.parameters():
            p.grad = None
        torch.cuda.empty_cache()

        # loss_b at 2 windows: the encoder trained through K1's gradient rule
        every = [p.requires_grad_(True) for p in large.parameters()]
        opt = Adam(every, 3e-4)
        calls["n"] = 0
        fa.attention_backward = counted_rule
        try:
            def b_step():
                a16, (tsk, tsm, ntk, ntm, at, aw) = online_batch(FULL_B_WINDOWS)
                mel = _log_mel_batch_body(a16.float() / 32768.0, dims.n_mels)
                loss, _ = am.loss_b(large, mel, tsk, tsm, ntk, ntm, at, aw, heads)
                loss.backward()
                enc_g = float(large.encoder.blocks[0].attn.query.w.grad.abs().max())
                opt.step()
                return float(loss.detach()), enc_g

            torch.cuda.reset_peak_memory_stats()
            before = fa.flash_attention.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, enc_g = b_step()
            torch.cuda.synchronize()
            b_ms = [(time.perf_counter() - t0) * 1e3]
            launches, rules = fa.flash_attention.launches - before, calls["n"]
            assert math.isfinite(loss) and enc_g > 0, (loss, enc_g)
            assert launches == dims.n_audio_layer and rules == dims.n_audio_layer, (launches, rules)
            profiled = profiled_step(b_step, "loss_b")
        finally:
            fa.attention_backward = rule
        report_steps(
            f"large-v3 f32 align loss_b step ({FULL_B_WINDOWS} windows, every parameter, Adam; the "
            f"first, which allocates Adam's moments), loss {loss:.4f}, encoder block 0 max |dL/dWq| "
            f"{enc_g:.3e}, K1's gradient rule {rules} calls",
            b_ms, launches, profiled,
        )
        del opt, every, large
        torch.cuda.empty_cache()
        f32_launches = fa.flash_attention.launches
        print(
            f"[train] K1 (f32 route) launches over the large-v3 f32 steps: {f32_launches} "
            f"(= {dims.n_audio_layer} x {FULL_STEPS + 3} steps, timed and profiled)"
        )
        assert f32_launches == dims.n_audio_layer * (FULL_STEPS + 3), f32_launches
        if k1_f32 is not None:
            k1_f32["launches"] = f32_launches

        # CTC at wav2vec2 base
        w2v = w2v_init(BASE_CONFIG, torch.Generator(device="cuda").manual_seed(0))
        params = [p.requires_grad_(True) for p in w2v.parameters()]
        opt = Adam(params, 2.5e-4)
        vocab = cm.default_vocab()

        def ctc_step():
            rows = cm.sample_rows(rng, CTC_ROWS, BASE_CONFIG, vocab)[:4]
            loss = cm.loss_fn(w2v, *(torch.from_numpy(x).cuda() for x in rows))
            loss.backward()
            opt.step()
            return float(loss.detach())

        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(FULL_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = ctc_step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            assert math.isfinite(loss), loss
        report_steps(
            f"wav2vec2 BASE_CONFIG CTC step ({CTC_ROWS} rows of 4.8 s, F.ctc_loss, Adam; rows drawn on "
            f"the host inside the step), last loss {loss:.4f}", ms, 0, profiled_step(ctc_step, "ctc"),
        )
        del opt, params, w2v
        torch.cuda.empty_cache()

        # (d) K1 in f32 at the online step's shape, and its gradient rule
        bh, t, d = FULL_ONLINE_WINDOWS * dims.n_audio_head, 1500, dims.n_audio_state // dims.n_audio_head
        q, k, v = attention_case(bh, t, d, torch.float32, seed=4)
        err = check_attention("K1 f32, training shape", fa.wholek_attention(q, k, v),
                              fa._attention_reference(q, k, v), 1e-4, q.shape)
        dout = torch.randn_like(q)
        k1_ms = cuda_ms(lambda: fa.wholek_attention(q, k, v))
        plain_ms = cuda_ms(lambda: fa._attention_reference(q, k, v), iters=5)
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q[None], k[None], v[None]))
        rule_ms = cuda_ms(lambda: fa.attention_backward(q, k, v, dout), iters=5)
        qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
        out = F.scaled_dot_product_attention(qg[None], kg[None], vg[None])
        sdpa_bwd_ms = cuda_ms(
            lambda: torch.autograd.grad(out, (qg, kg, vg), dout[None], retain_graph=True), iters=5
        )
        peak = PEAK_OPS_PER_S["torch.float32"]
        bound = max(4 * bh * t * d * 4 / PEAK_BYTES_PER_S, 4 * bh * t * t * d / peak) * 1e3
        floor = 3 * 4 * bh * t * t * d / PEAK_TF32_OPS_PER_S * 1e3
        rule_bound = max(8 * bh * t * d * 4 / PEAK_BYTES_PER_S, 10 * bh * t * t * d / peak) * 1e3
        print(
            f"[train] K1 f32 at [{bh}, {t}, {d}] (the online step's encoder): kernel {k1_ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa {sdpa_ms:.4f} ms, bound {bound:.4f} ms by operations at "
            f"{peak / 1e12:.0f} TFLOP/s ({floor:.4f} ms as three TF32 products, the kernel's floor), "
            f"max_abs_err {err:.2e}; its gradient rule (attention_backward, "
            f"plain torch) {rule_ms:.4f} ms, SDPA's backward {sdpa_bwd_ms:.4f} ms, bound "
            f"{rule_bound:.4f} ms (10·BH·T²·D operations)"
        )
        del q, k, v, dout, qg, kg, vg, out
    torch.cuda.empty_cache()


def timed(phase, *args, label: str = "", **kwargs):
    """Run one phase and print its wall time: the script has 1200 s for
    every phase, the kernels' build included."""
    t0 = time.perf_counter()
    out = phase(*args, **kwargs)
    print(f"[time] {phase.__name__}{label}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "whisperx_tpu_torch")):
        print("chip_smoke: whisperx_tpu_torch/ not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    # the JAX package's opt-in reaches only CPU tensors: its force would move
    # the [small] phases' CPU routes
    os.environ.pop(CROSS_DECODE_FLAG, None)
    # the aligner is the checkpoint phase 4c writes; random weights are skipped
    for flag in ("WHISPERX_TPU_ALIGN_DIR", "WHISPERX_TPU_ALLOW_RANDOM_ALIGN"):
        os.environ.pop(flag, None)
    t_start = time.perf_counter()
    name = phase_card()
    timed(phase_build)
    if sys.argv[1:] == ["--train"]:  # phase 14 alone
        timed(phase_train)
        print(f"[done] {REPO}: phase 14 passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["--parallel"]:  # phase 13 alone, on a fresh large-v3
        import whisperx_tpu_torch

        pipe = whisperx_tpu_torch.load_model(
            "large-v3", vad_method="energy", batch_size=8, compute_type="bfloat16"
        )
        timed(phase_parallel, pipe)
        print(f"[done] {REPO}: phase 13 passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["--spec"]:  # phases 8 and 8b alone, on fresh models
        import whisperx_tpu_torch

        pipe = whisperx_tpu_torch.load_model("large-v3", vad_method="energy", batch_size=8,
                                             compute_type="bfloat16")
        timed(phase_speculative, pipe)
        del pipe
        torch.cuda.empty_cache()
        pipe = whisperx_tpu_torch.load_model("large-v3", vad_method="energy", batch_size=8,
                                             compute_type="int8")
        timed(phase_speculative_int8, pipe.model, [])
        print(f"[done] {REPO}: speculative phases passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["--decode"]:  # the decode phases alone, on fresh models
        import whisperx_tpu_torch

        pipe = whisperx_tpu_torch.load_model("large-v3", vad_method="energy", batch_size=8,
                                             compute_type="bfloat16")
        timed(phase_decode_profile, pipe.model, k3={})
        timed(phase_eviction_gate, pipe.model)
        timed(phase_cross_decode_step, pipe.model)
        timed(same_shape_threads, pipe.model)
        del pipe
        torch.cuda.empty_cache()
        pipe = whisperx_tpu_torch.load_model("large-v3", vad_method="energy", batch_size=8,
                                             compute_type="int8")
        timed(phase_decode_profile, pipe.model, "profile int8", beam_size=5, label=" (int8)")
        print(f"[done] {REPO}: decode phases passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["--precisions"]:  # phases 6 (without K4's times), 6b and 6c alone
        with tempfile.TemporaryDirectory() as align_root:
            os.environ["WHISPERX_TPU_ALIGN_DIR"] = make_align_checkpoint(align_root)
            model, cli8 = timed(phase_cli, {}, [])
            cli8.update(timed(phase_decode_profile, model, "profile int8", beam_size=5, label=" (int8)"))
            del model
            torch.cuda.empty_cache()
            timed(phase_cli_int4, cli8)
            del os.environ["WHISPERX_TPU_ALIGN_DIR"]
        timed(phase_float32)
        print(f"[done] {REPO}: precision phases passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    k1, k1_f32, k1b, k2 = timed(phase_kernels)
    k4, k4_shapes = timed(phase_k4)
    (k3, k3kt, k3i8), k3_shapes = timed(phase_k3)
    timed(phase_k3_route)
    if sys.argv[1:] == ["--kernels"]:  # phases 1-3 only
        print(f"[done] {REPO}: kernel phases passed in {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": [k1, k1_f32, k1b, k2, k3, k3kt, k3i8, k4],
                          "k4_shapes": k4_shapes, "k3_shapes": k3_shapes}))
        return 0
    # the kernels with no caller in the package, counted over every path
    # below: each must stay at 0 (a path that reached one would show here)
    from whisperx_tpu_torch.ops.cross_attention_decode import cross_decode_i8, cross_decode_kt
    from whisperx_tpu_torch.ops.flash_attention import flash_attention_tiled, wholek_attention

    unused = {
        "K1b": (k1b, wholek_attention, "mxu_sum_launches"),
        "K2": (k2, flash_attention_tiled, "launches"),
        "K3kt": (k3kt, cross_decode_kt, "launches"),
        "K3i8": (k3i8, cross_decode_i8, "launches"),
    }
    for _, fn, attr in unused.values():
        setattr(fn, attr, 0)
    pipe, main_result = timed(phase_main_path, k1)
    timed(phase_word_timing, pipe)
    # the aligner's checkpoint, for the alignment phase and the CLI's
    with tempfile.TemporaryDirectory() as align_root:
        os.environ["WHISPERX_TPU_ALIGN_DIR"] = make_align_checkpoint(align_root)
        timed(phase_alignment, main_result["segments"])
        timed(phase_decode_profile, pipe.model, k3=k3)
        timed(phase_eviction_gate, pipe.model)
        timed(phase_cross_decode_step, pipe.model)
        timed(phase_transcribe_many, pipe, k3)
        timed(phase_speculative, pipe)
        timed(phase_serving, pipe)
        timed(phase_parallel, pipe)
        del pipe
        torch.cuda.empty_cache()
        timed(phase_sequential)
        model, cli8 = timed(phase_cli, k4, k4_shapes)
        cli8.update(timed(phase_decode_profile, model, "profile int8", beam_size=5, label=" (int8)"))
        timed(phase_speculative_int8, model, k4_shapes)
        del model
        torch.cuda.empty_cache()
        timed(phase_cli_int4, cli8)
        del os.environ["WHISPERX_TPU_ALIGN_DIR"]
    timed(phase_float32)
    timed(phase_vads)
    timed(phase_diarization, main_result)
    timed(phase_convert)
    timed(phase_small_model)
    timed(phase_train, k1_f32)
    for label, (entry, fn, attr) in unused.items():
        entry["launches"] = getattr(fn, attr)
        print(f"[paths] {label} launches over every path: {entry['launches']}")
        assert entry["launches"] == 0, (label, entry["launches"])
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card_line())  # again here: a long log's head may be cut off
    print(json.dumps({"kernels": [k1, k1_f32, k1b, k2, k3, k3kt, k3i8, k4]}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""CLI orchestrator: VAD and ASR over every input file, forced alignment,
diarization and speaker assignment, then the writers.

Counterpart of ``whisperx_tpu/transcribe.py`` (reference
whisperx/transcribe.py:17-250). ``--data_parallel on`` wraps the pipeline in
``parallel.DataParallelPipeline`` over the devices of ``--device`` (every
visible GPU for ``cuda``); ``auto`` does so on CUDA when more than one GPU is
visible. Under several processes (torchrun's ``RANK`` / ``WORLD_SIZE``, or a
joined process group) each transcribes and writes its strided slice of the
files (``parallel.shard_files``).
"""

from __future__ import annotations

import argparse
import os
import time
import warnings

import numpy as np

from whisperx_tpu_torch.utils import LANGUAGES, TO_LANGUAGE_CODE, get_writer

# ASR options assembled straight out of same-named CLI flags; the one
# rename maps flag spelling -> TranscriptionOptions field spelling.
_ASR_FLAG_FIELDS = (
    "beam_size", "best_of", "patience", "length_penalty",
    "compression_ratio_threshold", "no_speech_threshold",
    "condition_on_previous_text", "initial_prompt", "suppress_numerals",
    "hallucination_silence_threshold", "draft_model", "spec_gamma",
)
_ASR_FLAG_RENAMES = {"logprob_threshold": "log_prob_threshold"}
_SUBTITLE_FLAGS = ("highlight_words", "max_line_count", "max_line_width")

def _canonical_language(code, model_name: str):
    """Lowercase + alias-resolve a user language code; apply .en override."""
    if code is not None:
        code = code.lower()
        code = TO_LANGUAGE_CODE.get(code, code)
        if code not in LANGUAGES:
            raise ValueError(f"Unsupported language: {code}")
    if model_name.endswith(".en") and code != "en":
        if code is not None:
            warnings.warn(
                f"dropping --language {code!r}: {model_name} only "
                "understands English"
            )
        code = "en"
    return code


def _fallback_temperatures(t0: float, step) -> tuple:
    """Temperature ladder for quality-gate retries: t0, t0+step, ... <= 1.0."""
    if step is None:
        return (t0,)
    return tuple(np.arange(t0, 1.0 + 1e-6, step))


def _torch_device(device: str, index: int) -> str:
    """``--device cuda`` + ``--device_index N`` → ``cuda:N``."""
    return f"cuda:{index}" if device == "cuda" else device


def transcribe_task(args: dict, parser: argparse.ArgumentParser):
    """Run the CLI's phases on parsed flags (``vars(parser.parse_args())``)
    and return the pipeline it built, so an in-process caller can inspect
    the model and its kernels' launch counts."""
    from whisperx_tpu_torch.alignment import align, load_align_model
    from whisperx_tpu_torch.asr import load_model
    from whisperx_tpu_torch.audio import load_audio
    from whisperx_tpu_torch.diarize import DiarizationPipeline, assign_word_speakers
    from whisperx_tpu_torch.parallel import DataParallelPipeline, make_mesh, maybe_data_parallel
    from whisperx_tpu_torch.parallel.multihost import process_index_count, shard_files

    take = args.pop  # every consumed flag leaves `args`; the remainder
    # (language + subtitle flags) is validated below

    model_name = take("model")
    backend = take("backend")
    batch_size = take("batch_size")
    model_dir = take("model_dir")
    take("model_cache_only")  # the port never fetches anything
    output_dir = take("output_dir")
    output_format = take("output_format")
    device, device_index = take("device"), take("device_index")
    compute_type = take("compute_type")
    verbose = take("verbose")
    word_timestamps = take("word_timestamps")
    log_json = take("log_json", None)
    trace_spans = take("trace_spans", None)
    if trace_spans:
        from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER

        GLOBAL_TRACKER.record_spans()

    os.makedirs(output_dir, exist_ok=True)

    align_model_name = take("align_model")
    interpolate_method = take("interpolate_method")
    no_align = take("no_align")
    task = take("task")
    no_align = no_align or task == "translate"  # translations can't align
    return_char_alignments = take("return_char_alignments")
    hf_token = take("hf_token")
    data_parallel = take("data_parallel")
    vad_options = {
        "chunk_size": take("chunk_size"),
        "vad_onset": take("vad_onset"),
        "vad_offset": take("vad_offset"),
    }
    vad_method = take("vad_method")

    diarize = take("diarize")
    min_speakers, max_speakers = take("min_speakers"), take("max_speakers")
    diarize_model_name = take("diarize_model")
    diarize_clustering = take("diarize_clustering", None)
    print_progress = take("print_progress")
    return_speaker_embeddings = take("speaker_embeddings")
    for ignored in ("fp16", "segment_resolution", "threads"):
        take(ignored, None)  # accepted for CLI parity, no-ops as in JAX

    if return_speaker_embeddings and not diarize:
        warnings.warn("ignoring --speaker_embeddings: requires --diarize")

    args["language"] = _canonical_language(args["language"], model_name)
    align_language = args["language"] or "en"

    asr_options = {f: take(f) for f in _ASR_FLAG_FIELDS}
    asr_options.update(
        (field, take(flag)) for flag, field in _ASR_FLAG_RENAMES.items()
    )
    asr_options["temperatures"] = _fallback_temperatures(
        take("temperature"), take("temperature_increment_on_fallback")
    )
    asr_options["suppress_tokens"] = [
        int(t) for t in take("suppress_tokens").split(",")
    ]
    asr_options["word_timestamps"] = word_timestamps

    writer = get_writer(output_format, output_dir)
    if no_align:
        for flag in _SUBTITLE_FLAGS:
            if args[flag]:
                parser.error(f"--{flag} requires alignment (drop --no_align)")
    if args["max_line_count"] and not args["max_line_width"]:
        warnings.warn("--max_line_count does nothing unless --max_line_width is set")
    writer_args = {flag: take(flag) for flag in _SUBTITLE_FLAGS}

    # Part 1: VAD & ASR over every input file.
    model_path = (
        model_name if model_dir is None else os.path.join(model_dir, model_name)
    )
    t0 = time.perf_counter()
    torch_device = _torch_device(device, device_index)
    model = load_model(
        model_path,
        device=torch_device, compute_type=compute_type,
        language=args["language"], task=task, asr_options=asr_options,
        vad_method=vad_method, vad_options=vad_options,
        backend=backend, batch_size=batch_size,
    )
    if verbose:
        print(
            f">>Loaded {model.model.name} on {model.device} ({compute_type}) in "
            f"{time.perf_counter() - t0:.2f} s"
        )
    chunk_size = vad_options["chunk_size"]

    if data_parallel == "on" or (data_parallel == "auto" and maybe_data_parallel(model)):
        # every visible GPU for --device cuda, else the one device named
        mesh = make_mesh(devices=None if device == "cuda" else [model.device])
        model = DataParallelPipeline(model, mesh=mesh)
        if verbose:
            print(f">>Data-parallel decode over {mesh.shape['data']} devices")

    # duplicates (shell-glob overlap, scripted lists) would transcribe
    # twice and write the same output files twice — process each once
    audio_paths = list(dict.fromkeys(take("audio")))
    pid, n_proc = process_index_count()
    if n_proc > 1:
        # several processes: whole files shard over them, each transcribes
        # and writes its own slice with its own devices
        total = len(audio_paths)
        audio_paths = shard_files(audio_paths, pid, n_proc)
        print(f">>Host {pid}/{n_proc}: {len(audio_paths)} of {total} files")
    results = {}
    for audio_path in audio_paths:
        print(">>Performing transcription...")
        results[audio_path] = model.transcribe(
            load_audio(audio_path),
            batch_size=batch_size, chunk_size=chunk_size,
            print_progress=print_progress, verbose=verbose,
        )

    # Part 2: forced alignment, on the same device.
    if not no_align:
        align_model, align_metadata = load_align_model(
            align_language, torch_device, model_name=align_model_name
        )
        if align_metadata.get("random_weights") and not os.environ.get(
            "WHISPERX_TPU_ALLOW_RANDOM_ALIGN"
        ):
            # garbage timings are worse than none: skip instead of emitting
            print(
                ">>Skipping alignment: no converted wav2vec2 checkpoint for "
                f"language {align_language!r} (convert one with python -m "
                "whisperx_tpu_torch.convert wav2vec2 --src <HF dir> --out "
                f"<dir>/{align_language} and set WHISPERX_TPU_ALIGN_DIR=<dir>, or "
                "set WHISPERX_TPU_ALLOW_RANDOM_ALIGN=1 to force)."
            )
            align_model = None
        for audio_path, result in results.items():
            if align_model is None or not result["segments"]:
                continue
            if result.get("language", "en") != align_metadata["language"]:
                print(
                    f"New language found ({result['language']})! Previous was "
                    f"({align_metadata['language']}), loading new alignment model..."
                )
                # the NEW language's default model (an --align_model pinned
                # for the first language would be wrong here), as in JAX
                align_model, align_metadata = load_align_model(
                    result["language"], torch_device
                )
            print(">>Performing alignment...")
            results[audio_path] = align(
                result["segments"], align_model, align_metadata,
                audio_path, torch_device,
                interpolate_method=interpolate_method,
                return_char_alignments=return_char_alignments,
                print_progress=print_progress,
            )

    # Part 3: diarization + speaker assignment, on the same device.
    if diarize:
        print(">>Performing diarization...")
        print(">>Using model:", diarize_model_name)
        diarize_model = DiarizationPipeline(
            model_name=diarize_model_name, use_auth_token=hf_token,
            device=torch_device, clustering=diarize_clustering,
        )
        for audio_path, result in results.items():
            diarize_out = diarize_model(
                audio_path,
                min_speakers=min_speakers, max_speakers=max_speakers,
                return_embeddings=return_speaker_embeddings,
            )
            turns, spk_emb = (
                diarize_out if return_speaker_embeddings else (diarize_out, None)
            )
            results[audio_path] = assign_word_speakers(turns, result, spk_emb)

    # Part 4: write outputs.
    for audio_path, result in results.items():
        result = dict(result)
        result.setdefault("language", align_language)
        writer(result, audio_path, writer_args)

    if log_json:
        from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER

        GLOBAL_TRACKER.emit_jsonl(log_json, extra={"files": len(results)})
        print(f">>Metrics written to {log_json}")
    if trace_spans:
        n = GLOBAL_TRACKER.write_spans(trace_spans)
        print(f">>{n} spans written to {trace_spans}")
    return model

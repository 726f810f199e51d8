"""Serve a Whisper transcription HTTP endpoint with the PyTorch/CUDA port.

Usage:
    python -m whisperx_tpu_torch.serve --model large-v3 --port 9090
    curl -s -X POST --data-binary @clip.wav \
        http://127.0.0.1:9090/v1/audio/transcriptions | jq .

The flags of ``python -m whisperx_tpu.serve``, with ``--device`` defaulting
to ``cuda`` (``cpu`` for smoke tests). ``--data_parallel on`` (or ``auto``
on CUDA with more than one GPU visible) serves through
``parallel.DataParallelPipeline`` over the devices of ``--device``, each
data row's replica split ``--n_model`` ways. One flag is the port's own:
``--trace_spans PATH`` writes the tracker's span records
(``utils/metrics.py``) as a Chrome trace when the server exits.
"""

import argparse


def build_parser() -> argparse.ArgumentParser:
    # fmt: off
    parser = argparse.ArgumentParser(
        prog="whisperx_tpu_torch.serve",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--model", default="small", help="Whisper model name or converted checkpoint dir")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=9090)
    parser.add_argument("--device", default="cuda", help="cuda (default; cuda:N picks a card) or cpu")
    parser.add_argument("--compute_type", default="bfloat16", choices=["bfloat16", "float16", "float32", "int8", "int4"])
    parser.add_argument("--language", default=None, help="pin the transcription language (default: auto-detect)")
    parser.add_argument("--task", default="transcribe", choices=["transcribe", "translate"])
    parser.add_argument("--vad_method", default="silero", help="silero | pyannote | energy | none")
    parser.add_argument("--batch_size", type=int, default=16, help="device decode batch size")
    parser.add_argument("--max_batch_size", type=int, default=8, help="max requests coalesced per serving batch")
    parser.add_argument("--max_wait_ms", type=float, default=100.0, help="max time to wait for batch stragglers")
    parser.add_argument("--max_queue_depth", type=int, default=1024, help="shed requests with 503 past this many pending (0 = unbounded)")
    parser.add_argument("--max_body_mb", type=int, default=256, help="reject request bodies over this size with 413")
    parser.add_argument("--max_streams", type=int, default=64, help="cap concurrent streaming sessions (429 past this)")
    parser.add_argument("--word_timestamps", action="store_true", help="attach cross-attention DTW word timings to every segment")
    parser.add_argument("--temperature", type=float, default=0.0, help="initial sampling temperature")
    parser.add_argument("--temperature_increment_on_fallback", type=float, default=0.2, help="quality-gate retry temperature step; 0 disables the retry ladder (random-weight benches MUST disable it: gates always fail and every chunk would cascade through all 6 temperatures with best_of tiling)")
    parser.add_argument("--no_warmup", action="store_true", help="skip the warm-up transcription at startup (the first request then builds the CUDA kernels)")
    parser.add_argument("--warmup_streaming", action="store_true", help="also drive every streaming decode shape at startup (chunk-length buckets, prompted decode, partial prefix buckets)")
    parser.add_argument("--align_model", type=str, default=None, help="wav2vec2 checkpoint/name for per-request ?align=true (default: per-language registry)")
    parser.add_argument("--diarize_model", type=str, default=None, help="diarization checkpoint/name for per-request ?diarize=true")
    parser.add_argument("--draft_model", type=str, default=None, help="enable speculative decoding: draft checkpoint/name or 'self:N'")
    parser.add_argument("--spec_gamma", type=int, default=4, help="speculative draft length per verify step")
    parser.add_argument("--data_parallel", type=str, default="auto", choices=["auto", "on", "off"], help="shard decode batches over all local devices (auto: when >1 device)")
    parser.add_argument("--n_model", type=int, default=1, help="tensor-parallel width within the device mesh")
    parser.add_argument("--trace_spans", type=str, default=None, help="keep a record of every span of the pipeline and the batcher (stages, the decode's parts, each request's waits) and write them to this path as one Chrome trace JSON when the server exits, on the clock of torch.profiler's traces")
    # fmt: on
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.trace_spans:
        from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER

        GLOBAL_TRACKER.record_spans()

    from whisperx_tpu_torch.asr import load_model
    from whisperx_tpu_torch.serve.batching import BatchConfig
    from whisperx_tpu_torch.serve.server import TranscriptionServer
    from whisperx_tpu_torch.transcribe import _fallback_temperatures

    # an unknown or absent device raises here, as load_model does
    pipeline = load_model(
        args.model,
        device=args.device,
        compute_type=args.compute_type,
        language=args.language,
        vad_method=args.vad_method,
        task=args.task,
        batch_size=args.batch_size,
        asr_options={
            **({"word_timestamps": True} if args.word_timestamps else {}),
            **(
                {"draft_model": args.draft_model, "spec_gamma": args.spec_gamma}
                if args.draft_model
                else {}
            ),
            # same ladder as the transcription CLI; step 0 disables retries
            "temperatures": _fallback_temperatures(
                args.temperature,
                args.temperature_increment_on_fallback or None,
            ),
        },
    )
    from whisperx_tpu_torch.parallel import DataParallelPipeline, make_mesh, maybe_data_parallel

    if args.data_parallel == "on" or (args.data_parallel == "auto" and maybe_data_parallel(pipeline)):
        # every visible GPU for --device cuda, else the one device named
        devices = None if args.device == "cuda" else [pipeline.device]
        mesh = make_mesh(n_model=args.n_model, devices=devices)
        pipeline = DataParallelPipeline(pipeline, mesh=mesh)
        print(
            f"data-parallel serving over {mesh.shape['data'] * args.n_model} devices "
            f"(data={mesh.shape['data']} x model={args.n_model})"
        )

    server = TranscriptionServer(
        pipeline,
        model_name=args.model,
        batch_config=BatchConfig(
            max_batch_size=args.max_batch_size,
            max_wait_ms=args.max_wait_ms,
            max_queue_depth=args.max_queue_depth,
        ),
        max_body_bytes=args.max_body_mb * 1024 * 1024,
        max_streams=args.max_streams,
        align_model=args.align_model,
        diarize_model=args.diarize_model,
    )
    if not args.no_warmup:
        # drive the path BEFORE binding the port (kernel builds, cuDNN and
        # allocator warm-up), so the first client request doesn't absorb them
        import time as _time

        t0 = _time.monotonic()
        print("warming up (the first call builds the CUDA kernels)…")
        pipeline.warmup()
        if args.warmup_streaming:
            from whisperx_tpu_torch.serve.streaming import warmup_streaming

            n = warmup_streaming(pipeline, language=args.language)
            print(f"streaming warmup: {n} calls")
        print(f"warmup done in {_time.monotonic() - t0:.1f}s")

    import signal
    import threading

    def _term(signum, frame):
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)

    print(f"whisperx-tpu-torch serving {args.model} on {pipeline.device} at "
          f"http://{args.host}:{args.port}", flush=True)
    try:
        server.serve_forever(args.host, args.port)
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        if args.trace_spans:
            n = GLOBAL_TRACKER.write_spans(args.trace_spans)
            print(f"{n} spans written to {args.trace_spans}", flush=True)


if __name__ == "__main__":
    main()

"""whisperx-tpu-torch CLI: the flags of ``whisperx_tpu/__main__.py`` (flag
parity with reference whisperx/__main__.py:17-95), run by the PyTorch/CUDA
port.

Three differences: ``--device`` defaults to ``cuda`` (the card given by
``--device_index``) and takes ``cpu``; ``--version`` names the port; one flag
is the port's own, ``--trace_spans PATH``, which writes the tracker's span
records (``utils/metrics.py``) as a Chrome trace at the end. Flags of
stages the port does not run yet raise ``NotImplementedError`` naming the
ROADMAP.md item that brings them (``transcribe.py``).

    python -m whisperx_tpu_torch audio.wav --model large-v3 --compute_type int8 \\
        --vad_method energy --language en -f all
"""

import argparse
import platform

from whisperx_tpu_torch import __version__
from whisperx_tpu_torch.utils import (
    LANGUAGES,
    TO_LANGUAGE_CODE,
    optional_float,
    optional_int,
    str2bool,
)


def build_parser() -> argparse.ArgumentParser:
    # fmt: off
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("audio", nargs="+", type=str, help="path(s) of the audio to process")
    parser.add_argument("--model", default="small", help="Whisper variant (tiny/small/medium/large-v3/distil-large-v3/...) or a converted-checkpoint directory")
    parser.add_argument("--backend", default="auto", choices=["auto", "batched", "sequential"], help="decode path: 'batched' = VAD-chunk batching (fast), 'sequential' = 30s seek loop with full quality gates")
    parser.add_argument("--model_cache_only", type=str2bool, default=False, help="never fetch anything: resolve models solely from the local cache / --model_dir")
    parser.add_argument("--model_dir", type=str, default=None, help="where converted checkpoints live")
    parser.add_argument("--device", default="cuda", help="which device runs the models ('cuda', the card --device_index picks; 'cpu' for smoke tests)")
    parser.add_argument("--data_parallel", default="auto", choices=["auto", "on", "off"], help="shard decode batches over all local devices (auto: when >1 device is visible)")
    parser.add_argument("--device_index", default=0, type=int, help="which device of that type to pick")
    parser.add_argument("--batch_size", default=8, type=int, help="how many VAD chunks decode together per dispatch")
    parser.add_argument("--compute_type", default="bfloat16", type=str, choices=["float16", "bfloat16", "float32", "int8", "int4"], help="numeric precision for weights/activations")

    parser.add_argument("--word_timestamps", type=str2bool, default=False, help="per-word times from cross-attention DTW (works without the wav2vec2 aligner)")

    parser.add_argument("--output_dir", "-o", type=str, default=".", help="where transcripts are written")
    parser.add_argument("--output_format", "-f", type=str, default="all", choices=["all", "srt", "vtt", "txt", "tsv", "json", "aud", "rttm"], help="which transcript format to emit ('all' writes every one)")
    parser.add_argument("--verbose", type=str2bool, default=True, help="chatty mode: echo segments and status as they are produced")

    parser.add_argument("--task", type=str, default="transcribe", choices=["transcribe", "translate"], help="'transcribe' keeps the source language; 'translate' renders it in English")
    parser.add_argument("--language", type=str, default=None, choices=sorted(LANGUAGES.keys()) + sorted([k.title() for k in TO_LANGUAGE_CODE.keys()]), help="ISO code (or English name) of the spoken language; omit to auto-detect")

    # alignment params
    parser.add_argument("--align_model", default=None, help="phoneme-recognition model used for forced alignment")
    parser.add_argument("--interpolate_method", default="nearest", choices=["nearest", "linear", "ignore"], help="how unalignable words get times: copy a neighbour's ('nearest'), interpolate, or drop")
    parser.add_argument("--no_align", action="store_true", help="skip the wav2vec2 forced-alignment phase")
    parser.add_argument("--return_char_alignments", action="store_true", help="also emit per-character times in the JSON output")

    # vad params
    parser.add_argument("--vad_method", type=str, default="silero", choices=["pyannote", "silero", "hybrid", "energy", "none"], help="voice-activity detector backbone")
    parser.add_argument("--vad_onset", type=float, default=0.500, help="speech-start probability threshold (lower it when speech is missed)")
    parser.add_argument("--vad_offset", type=float, default=0.363, help="speech-end probability threshold (lower it when speech is missed)")
    parser.add_argument("--chunk_size", type=int, default=30, help="target seconds per merged VAD chunk")

    # diarization params
    parser.add_argument("--diarize", action="store_true", help="run speaker diarization and tag segments/words with speakers")
    parser.add_argument("--min_speakers", default=None, type=int, help="lower bound on distinct speakers")
    parser.add_argument("--max_speakers", default=None, type=int, help="upper bound on distinct speakers")
    parser.add_argument("--diarize_model", default="pyannote-tpu", type=str, help="diarization model name or checkpoint path")
    parser.add_argument("--speaker_embeddings", action="store_true", help="attach speaker embedding vectors to the JSON output (needs --diarize)")
    parser.add_argument("--diarize_clustering", default=None, choices=["ahc", "spectral", "plda"], help="speaker clustering: cosine AHC (default), spectral, or PLDA log-likelihood-ratio scoring")

    parser.add_argument("--temperature", type=float, default=0, help="initial sampling temperature (0 = deterministic)")
    parser.add_argument("--best_of", type=optional_int, default=5, help="samples drawn per segment once temperature goes above zero")
    parser.add_argument("--beam_size", type=optional_int, default=5, help="beam width for search at temperature 0")
    parser.add_argument("--patience", type=float, default=1.0, help="beam-search patience factor (keep exploring after the first finished beams)")
    parser.add_argument("--length_penalty", type=float, default=1.0, help="alpha for length-normalized beam scoring")
    parser.add_argument("--draft_model", type=str, default=None, help="enables speculative decoding: name or checkpoint path of a draft Whisper model, or 'self:N' to draft from the target's own first N decoder layers; greedy batched decode only, token-identical to non-speculative greedy decoding")
    parser.add_argument("--spec_gamma", type=int, default=4, help="tokens drafted per speculative verify pass (only with --draft_model)")

    parser.add_argument("--suppress_tokens", type=str, default="-1", help="token ids (comma-separated) to forbid during decoding; '-1' = the standard special-character blocklist")
    parser.add_argument("--suppress_numerals", action="store_true", help="forbid digits/currency symbols (wav2vec2 cannot time-align them)")

    parser.add_argument("--initial_prompt", type=str, default=None, help="text prepended as context before the first decoding window")
    parser.add_argument("--condition_on_previous_text", type=str2bool, default=False, help="feed each window's output as context into the next (sequential backend)")
    parser.add_argument("--fp16", type=str2bool, default=True, help="accepted but ignored: the precision is --compute_type")

    parser.add_argument("--temperature_increment_on_fallback", type=optional_float, default=0.2, help="step added to the temperature on each quality-gate retry")
    parser.add_argument("--compression_ratio_threshold", type=optional_float, default=2.4, help="gate: a segment whose text gzips better than this ratio is retried (likely looping)")
    parser.add_argument("--logprob_threshold", type=optional_float, default=-1.0, help="gate: retry segments whose mean token log-prob falls below this")
    parser.add_argument("--no_speech_threshold", type=optional_float, default=0.6, help="gate: with a failed logprob gate, a <|nospeech|> probability above this marks the window as silence")
    parser.add_argument("--hallucination_silence_threshold", type=optional_float, default=None, help="(with --word_timestamps True) when a segment looks hallucinated, jump over silences longer than this many seconds and evict low-confidence segments stranded in silence")

    parser.add_argument("--max_line_width", type=optional_int, default=None, help="(aligned output) wrap subtitle lines at this many characters")
    parser.add_argument("--max_line_count", type=optional_int, default=None, help="(aligned output) cap on subtitle lines per cue")
    parser.add_argument("--highlight_words", type=str2bool, default=False, help="(aligned output) karaoke-style per-word underlining in srt/vtt")
    parser.add_argument("--segment_resolution", type=str, default="sentence", choices=["sentence", "chunk"], help="(aligned output) emit aligned cues per sentence or per chunk")

    parser.add_argument("--threads", type=optional_int, default=0, help="host-side worker threads for audio decode/preprocessing")
    parser.add_argument("--hf_token", type=str, default=None, help="accepted for compatibility; converters handle gated-model auth themselves")

    parser.add_argument("--print_progress", type=str2bool, default=False, help="print percent-complete lines inside the transcribe/align phases")
    parser.add_argument("--log_json", type=str, default=None, help="write structured JSON-lines stage metrics (per-stage RTF, tokens/s, batch fill) to this path")
    parser.add_argument("--trace_spans", type=str, default=None, help="keep a record of every span of the pipeline (stages, the decode's parts) and write them to this path as one Chrome trace JSON at the end, on the clock of torch.profiler's traces")
    parser.add_argument("--version", "-V", action="version", version=f"whisperx-tpu-torch {__version__}", help="Show version information and exit")
    parser.add_argument("--python-version", "-P", action="version", version=f"Python {platform.python_version()} ({platform.python_implementation()})", help="Show python version information and exit")
    # fmt: on
    return parser


def cli():
    parser = build_parser()
    args = parser.parse_args().__dict__

    from whisperx_tpu_torch.transcribe import transcribe_task

    transcribe_task(args, parser)


if __name__ == "__main__":
    cli()

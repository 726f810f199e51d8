"""Batched autoregressive decoding for Whisper.

Counterpart of ``whisperx_tpu/decoding/decode.py`` (greedy, temperature
sampling and beam search, ``decoding/beam.py``; speculative decoding is
``decoding/speculative.py``). One decode is
encoder → cross-KV (int8 when ``kv_quant``) → prefill → a step loop with the
logit filters in f32, over static shapes: a token buffer [B, sample_len], a
self-attention cache sized to the decode budget, and finished rows that keep
"decoding" EOT instead of being gathered out.

The JAX package runs the loop as one ``lax.while_loop`` on the device. Here
the host keeps the loop and reads ``finished.all()`` back once per step,
and on one CUDA device each step after the prefill is one replay of a
captured CUDA graph (``step_graph.py``): the step's body reads and writes
static buffers in place (``_SampleBuffers``: the token index, offset and
filter step are device tensors; a sampled step's uniform draw is made
before the replay, into a buffer). The CPU runs the same body uncaptured,
as do tensor-parallel decodes on the card (a block split over devices:
``step_graph.graphable`` is False).

With a mesh active (``parallel.use_mesh``) whose data axis divides the
batch (after ``best_of`` tiling), ``decode_dispatch`` cuts the rows into one
contiguous slice per data row and decodes each on its row's model replica,
on a worker thread of its own (JAX's meshed ``_decode_jit``, ``_shard_data``).
Each replica's steps replay a captured graph as a single-card decode's do,
on a cache entry of its own; replicas on one device share one decoder and
its cache. A sampled split reads its rows of the whole batch's draws
(``_SharedNoise``), copied into its entry's noise buffer before each replay,
so it samples the unsplit decode's tokens.

Inside the pipeline's ``decode`` stage each decode times its parts as spans
of ``utils/metrics.py::GLOBAL_TRACKER``, on the device clock too:
``decode.encoder`` (the encoder pass), ``decode.prefill`` (the cross-KV and
its int8 quantize, the buffers' start, the eager prefill pass and the
no-speech probabilities) and ``decode.steps`` (the step loop); then
``decode.readback`` (``decode_finalize``: the copies back and the text),
after which the device times are read.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from whisperx_tpu_torch.decoding import filters as F
from whisperx_tpu_torch.decoding.step_graph import load_cache, step_runner
from whisperx_tpu_torch.models.whisper.model import (
    KVCache,
    decoder_forward,
    encoder_forward,
    new_self_cache,
    precompute_cross_kv,
    quantize_kv,
)
from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER as _tracker
from whisperx_tpu_torch.utils.text import compression_ratio


@dataclass(frozen=True)
class DecodingOptions:
    """Parity with mlx_whisper / OpenAI Whisper DecodingOptions."""

    task: str = "transcribe"
    language: Optional[str] = None
    temperature: float = 0.0
    sample_len: Optional[int] = None
    best_of: Optional[int] = None
    beam_size: Optional[int] = None
    patience: Optional[float] = None
    length_penalty: Optional[float] = None
    prompt: Optional[Union[str, Sequence[int]]] = None
    prefix: Optional[Union[str, Sequence[int]]] = None
    suppress_tokens: Optional[Union[str, Sequence[int]]] = "-1"
    suppress_blank: bool = True
    suppress_numerals: bool = False
    kv_quant: bool = False  # int8 cross-KV cache
    without_timestamps: bool = False
    max_initial_timestamp: Optional[float] = 1.0
    fp16: bool = True


@dataclass
class DecodingResult:
    audio_features: Optional[torch.Tensor]
    language: str
    language_probs: Optional[dict] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    text: str = ""
    avg_logprob: float = np.nan
    no_speech_prob: float = np.nan
    temperature: float = np.nan
    compression_ratio: float = np.nan


@dataclass(frozen=True)
class _StaticConfig:
    """The decode configuration resolved from options + tokenizer."""

    n_head: int
    n_head_audio: int
    n_text_ctx: int
    eot: int
    sot_index: int
    no_speech_token: int
    timestamp_begin: int
    no_timestamps: int
    sample_len: int
    max_initial_timestamp_index: Optional[int]
    suppress_blank: bool
    blank_tokens: Tuple[int, ...]
    suppress: Tuple[int, ...]
    without_timestamps: bool
    greedy: bool
    kv_quant: bool = False


def _filter_masks(cfg: _StaticConfig, n_vocab: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cfg``'s suppress mask and its blank-and-EOT mask, [V] bool each:
    new tensors that the caller owns. A captured step reads them by
    address, so its static buffers hold them for as long as its graph
    lives; an uncaptured decode builds them once."""
    return (
        F._id_mask(n_vocab, cfg.suppress, device),
        F._id_mask(n_vocab, cfg.blank_tokens + (cfg.eot,), device),
    )


def _apply_filters(logits, state, cfg: _StaticConfig, suppress_mask, blank_mask):
    """The filter chain over ``logits`` [B, V] in f32, with the masks of
    ``_filter_masks(cfg, ...)``."""
    logits = logits.float()
    if cfg.suppress_blank:
        # upstream SuppressBlank masks blank openings AND EOT at the first
        # sampled step, only when the filter is enabled
        logits = F.suppress_blank(logits, state, blank_mask)
    logits = F.suppress_tokens(logits, suppress_mask)
    if not cfg.without_timestamps:
        logits = F.apply_timestamp_rules(
            logits,
            state,
            timestamp_begin=cfg.timestamp_begin,
            eot=cfg.eot,
            no_timestamps=cfg.no_timestamps,
            max_initial_timestamp_index=cfg.max_initial_timestamp_index,
        )
    return logits


def _step_config(cfg: _StaticConfig) -> _StaticConfig:
    """The part of ``cfg`` a step reads, for a graph's key: the SOT token's
    index, which moves with the prompt's length, is the prefill's alone."""
    return dataclasses.replace(cfg, sot_index=-1)


def _cache_len(cfg: _StaticConfig, n_init: int) -> int:
    """The self-attention cache's length: the decode budget (prefix +
    sample_len) rounded up to 64, not the full n_text_ctx — every step
    reads the whole cache, so unused slots cost memory bandwidth."""
    budget = n_init + cfg.sample_len + 1
    return min(cfg.n_text_ctx, -(-budget // 64) * 64)


def init_kv_cache_like(model, batch: int, cfg: _StaticConfig, n_init: int = 0):
    """Self-attention cache sized to the decode budget (``_cache_len``)."""
    return new_self_cache(model.decoder, batch, _cache_len(cfg, n_init), cfg.n_head)


def _cross_kv(model, audio_features: torch.Tensor, cfg: _StaticConfig):
    """Per-layer cross-attention K/V lists, int8 ``QuantizedKV`` when
    ``cfg.kv_quant``."""
    cross_k, cross_v = precompute_cross_kv(model.decoder, audio_features, cfg.n_head)
    if cfg.kv_quant:
        cross_k = [quantize_kv(x) for x in cross_k]
        cross_v = [quantize_kv(x) for x in cross_v]
    return cross_k, cross_v


def _state_buffers(rows: int, device) -> F.FilterState:
    i64 = dict(dtype=torch.int64, device=device)
    return F.FilterState(
        *(torch.empty((rows,), **i64) for _ in range(3)),
        has_timestamp=torch.empty((rows,), dtype=torch.bool, device=device),
        step=torch.empty((rows,), **i64),
    )


def _reset_state(state: F.FilterState, initial_tokens: torch.Tensor) -> None:
    """A decode's start on a state of [B] tensors: ``init_filter_state``."""
    init = F.init_filter_state(initial_tokens)
    for dst, src in zip(state[:4], init[:4]):
        dst.copy_(src)
    state.step.zero_()


@dataclass
class _SampleBuffers:
    """What a greedy or sampled step reads and writes, in place: the
    static buffers of a captured step (``step_graph``). ``noise`` holds the
    step's uniform draw (sampled decodes only), made before the step."""

    cache: KVCache
    state: F.FilterState  # of [B] tensors: ``step`` counts sampled tokens
    last_logits: torch.Tensor  # [B, V] f32
    tokens: torch.Tensor  # [B, sample_len] int64
    finished: torch.Tensor  # [B] bool
    sum_logprobs: torch.Tensor  # [B] f32
    offset: torch.Tensor  # [B] int64: the next token's position
    temperature: torch.Tensor  # [] f32
    noise: Optional[torch.Tensor]  # [B, V] f32
    suppress_mask: torch.Tensor  # [V] bool
    blank_mask: torch.Tensor  # [V] bool: the blank tokens and EOT

    @classmethod
    def allocate(cls, dec, cross_k, cross_v, rows: int, cache_len: int, cfg: _StaticConfig):
        """Buffers for ``rows`` rows around this decode's cross-KV."""
        device = dec.tok_emb.device
        vocab = dec.tok_emb.shape[0]
        f32 = dict(dtype=torch.float32, device=device)
        suppress_mask, blank_mask = _filter_masks(cfg, vocab, device)
        return cls(
            cache=KVCache(*new_self_cache(dec, rows, cache_len, cfg.n_head), list(cross_k), list(cross_v)),
            state=_state_buffers(rows, device),
            last_logits=torch.empty((rows, vocab), **f32),
            tokens=torch.empty((rows, cfg.sample_len), dtype=torch.int64, device=device),
            finished=torch.empty((rows,), dtype=torch.bool, device=device),
            sum_logprobs=torch.empty((rows,), **f32),
            offset=torch.empty((rows,), dtype=torch.int64, device=device),
            temperature=torch.empty((), **f32),
            noise=None if cfg.greedy else torch.empty((rows, vocab), **f32),
            suppress_mask=suppress_mask,
            blank_mask=blank_mask,
        )

    def start(self, cross_k, cross_v, initial_tokens, temperature: float, eot: int) -> None:
        load_cache(self.cache, cross_k, cross_v)
        _reset_state(self.state, initial_tokens)
        self.tokens.fill_(eot)
        self.finished.zero_()
        self.sum_logprobs.zero_()
        self.offset.fill_(initial_tokens.shape[1])
        self.temperature.fill_(temperature)


def _sample_step(dec, s: _SampleBuffers, cfg: _StaticConfig) -> None:
    """One greedy or sampled step over ``s``, in place: filter, pick, bank
    the log-probability, write the token at the state's ``step``, advance
    the state, and run the decoder on the token at ``s.offset``. Reads no
    value back to the host (a captured step's body)."""
    logits = _apply_filters(s.last_logits, s.state, cfg, s.suppress_mask, s.blank_mask)
    if cfg.greedy:
        sampled = torch.argmax(logits, dim=-1)
    else:
        # Gumbel-max draw from softmax(logits / T): tokens the filters set
        # to -inf are never drawn
        u = s.noise
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        sampled = torch.argmax(logits / s.temperature + gumbel, dim=-1)
    logprobs = torch.log_softmax(logits, dim=-1)
    step_lp = torch.gather(logprobs, 1, sampled[:, None])[:, 0]
    s.sum_logprobs.add_(torch.where(s.finished, 0.0, step_lp))
    sampled = torch.where(s.finished, cfg.eot, sampled)
    s.tokens.scatter_(1, s.state.step[:, None], sampled[:, None])
    s.finished.logical_or_(sampled == cfg.eot)
    F.advance_filter_state_(s.state, sampled, cfg.timestamp_begin)
    logits = decoder_forward(dec, sampled[:, None], s.cache, s.offset, cfg.n_head)
    s.last_logits.copy_(logits[:, -1])
    s.offset.add_(1)


@torch.inference_mode()
def _decode(
    model,
    audio_in: torch.Tensor,
    initial_tokens: torch.Tensor,
    temperature: float,
    cfg: _StaticConfig,
    generator: Optional[torch.Generator],
    audio_is_features: bool,
    noise: Optional[Callable[[int, tuple], torch.Tensor]] = None,
    capture: bool = True,
):
    """Full batched decode. Returns (tokens [B, sample_len], lengths [B],
    sum_logprobs [B], no_speech_probs [B], audio_features, steps run).
    ``noise(step, shape)``: the uniform draw of a sampled step, by default
    from ``generator`` (a data-parallel slice reads its rows of the whole
    batch's draw instead, ``_SharedNoise``), made on the host's order of
    steps before each step. ``capture``: each step after the prefill is a
    replay of a captured graph (``step_graph``) where the model allows it
    (CUDA, no tensor-parallel block); False runs the same body uncaptured."""
    b = audio_in.shape[0]
    n_init = initial_tokens.shape[1]
    device = audio_in.device
    if noise is None:
        noise = lambda step, shape: torch.rand(shape, generator=generator, device=device)

    if audio_is_features:
        audio_features = audio_in
    else:
        with _tracker.span("decode.encoder", device=device):
            audio_features = encoder_forward(model.encoder, audio_in, cfg.n_head_audio)
    dec = model.decoder
    cache_len = _cache_len(cfg, n_init)
    shape = ("sample", b, cache_len, audio_features.shape[1], _step_config(cfg))
    with contextlib.ExitStack() as runner:
        with _tracker.span("decode.prefill", device=device):
            cross_k, cross_v = _cross_kv(model, audio_features, cfg)
            make = lambda: _SampleBuffers.allocate(dec, cross_k, cross_v, b, cache_len, cfg)
            s, run = runner.enter_context(step_runner((model,), capture, shape, make))
            s.start(cross_k, cross_v, initial_tokens, temperature, cfg.eot)
            del cross_k, cross_v
            # the prefill: one eager pass at offset 0
            logits = decoder_forward(dec, initial_tokens, s.cache, 0, cfg.n_head)
            probs_at_sot = torch.softmax(logits[:, cfg.sot_index].float(), dim=-1)
            no_speech_probs = probs_at_sot[:, cfg.no_speech_token]
            s.last_logits.copy_(logits[:, -1])
            del logits

        n_sampled = 0
        with _tracker.span("decode.steps", device=device):
            # one host read per step: the loop stops once every row has emitted EOT
            while n_sampled < cfg.sample_len and not bool(s.finished.all()):
                if s.noise is not None:
                    s.noise.copy_(noise(n_sampled, tuple(s.noise.shape)))
                run(lambda: _sample_step(dec, s, cfg))
                n_sampled += 1
        tokens_buf, sum_logprobs = s.tokens.clone(), s.sum_logprobs.clone()

    is_eot = tokens_buf == cfg.eot
    # rows that never emitted EOT ran the full sample_len
    lengths = torch.where(
        is_eot.any(dim=-1), is_eot.int().argmax(dim=-1), cfg.sample_len
    )
    return tokens_buf, lengths, sum_logprobs, no_speech_probs, audio_features, n_sampled


class _SharedNoise:
    """The uniform draws of one sampled decode split over data-parallel
    replicas: step t's draw is the whole batch's [B, V], made from the
    generator in step order as the unsplit decode makes it, and each slice
    reads its own rows, so the split samples the unsplit decode's tokens.
    A draw is dropped once every slice still running has read it."""

    def __init__(self, generator, b: int, device, n_slices: int):
        self.generator, self.b, self.device = generator, b, device
        self.lock = threading.Lock()
        self.draws = {}  # step → [B, V]
        self.made = 0  # steps drawn so far
        self.next_step = [0] * n_slices  # per slice; None once it finished

    def rows(self, j: int, lo: int, hi: int, step: int, shape: tuple) -> torch.Tensor:
        with self.lock:
            while self.made <= step:
                self.draws[self.made] = torch.rand(
                    (self.b, shape[-1]), generator=self.generator, device=self.device
                )
                self.made += 1
            out = self.draws[step][lo:hi]
            self.next_step[j] = step + 1
            self._trim()
        return out

    def finish(self, j: int) -> None:
        with self.lock:
            self.next_step[j] = None
            self._trim()

    def _trim(self) -> None:
        live = [t for t in self.next_step if t is not None]
        low = min(live) if live else self.made
        for t in [t for t in self.draws if t < low]:
            del self.draws[t]


def _data_replicas(model, rows: int):
    """The model replicas of the active mesh's data rows when its data axis
    (> 1) divides ``rows``, else None: the decode then runs whole, as JAX's
    ``_shard_data`` leaves it without a mesh or on a batch the axis does
    not divide."""
    from whisperx_tpu_torch.parallel.sharding import DATA_AXIS, get_mesh

    mesh = get_mesh()
    if mesh is None or mesh.shape[DATA_AXIS] == 1 or rows % mesh.shape[DATA_AXIS]:
        return None
    if getattr(model, "_dp_mesh", None) != mesh:
        raise ValueError(
            "the active mesh splits this decode, but the model is not placed on "
            "it: place it with parallel.shard_params_tp(model, mesh)"
        )
    return model._dp_replicas


def _split_rows(replicas, tensors: Sequence[torch.Tensor], run, device) -> tuple:
    """Cut the rows of ``tensors`` into one contiguous slice per replica and
    call ``run(j, replica, *slices)`` for each on a worker thread of its own,
    the slices on the replica's device and that device current. Returns the
    outputs joined in row order on ``device``: tensors concatenated, step
    counts by their maximum."""
    n = len(replicas)
    per = tensors[0].shape[0] // n

    def one(j):
        rep = replicas[j]
        dev = rep.device
        scope = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        with scope:
            return run(j, rep, *(t[j * per : (j + 1) * per].to(dev) for t in tensors))

    # each thread runs in a copy of the caller's context: its spans are the
    # caller's span's parts
    contexts = [contextvars.copy_context() for _ in range(n)]
    with ThreadPoolExecutor(max_workers=n) as pool:
        outs = list(pool.map(lambda j: contexts[j].run(one, j), range(n)))
    return tuple(
        torch.cat([o[i].to(device) for o in outs]) if torch.is_tensor(outs[0][i])
        else max(o[i] for o in outs)
        for i in range(len(outs[0]))
    )


@torch.inference_mode()
def _detect_language_features(model, audio_features, n_head, sot, lang_tokens):
    b = audio_features.shape[0]
    dec = model.decoder
    cross_k, cross_v = precompute_cross_kv(dec, audio_features, n_head)
    # one-token forward: an 8-slot self cache suffices (the mask is positional)
    cache = KVCache(*new_self_cache(dec, b, 8, n_head), cross_k, cross_v)
    tokens = torch.full((b, 1), sot, dtype=torch.int64, device=audio_features.device)
    logits = decoder_forward(dec, tokens, cache, 0, n_head)[:, 0].float()
    mask = torch.full((logits.shape[-1],), float("-inf"), device=logits.device)
    mask[list(lang_tokens)] = 0.0
    return torch.softmax(logits + mask, dim=-1)


def detect_language(
    model, mel: Optional[torch.Tensor], tokenizer, *, features=None
) -> Tuple[list, list]:
    """Language id per batch row: (codes, prob dicts). ``features``:
    pre-encoded audio features to reuse (skips the encoder)."""
    lang_tokens = tuple(tokenizer.all_language_tokens)
    n_head = model.dims.n_audio_head
    if features is None:
        if mel.dim() == 2:
            mel = mel[None]
        with torch.inference_mode():
            features = encoder_forward(model.encoder, mel.to(model.dtype), n_head)
    probs = _detect_language_features(
        model, features, n_head, tokenizer.sot, lang_tokens
    ).cpu().numpy()
    codes, prob_dicts = [], []
    for row in probs:
        best = int(row.argmax())
        codes.append(tokenizer.language_code_of(best))
        prob_dicts.append(
            {tokenizer.language_code_of(t): float(row[t]) for t in lang_tokens}
        )
    return codes, prob_dicts


def _build_initial_tokens(
    tokenizer,
    options: DecodingOptions,
    n_text_ctx: int = 448,
    sample_len: Optional[int] = None,
) -> List[int]:
    tokens = list(tokenizer.sot_sequence)
    if options.without_timestamps:
        tokens = list(tokenizer.sot_sequence_including_notimestamps)
    if options.prefix is not None:
        prefix = (
            tokenizer.encode(" " + options.prefix.strip())
            if isinstance(options.prefix, str)
            else list(options.prefix)
        )
        # upstream whisper trims the prefix to n_ctx//2 - sample_len; never
        # keep more than half the context either, so a huge prefix can't
        # drive the sample budget to zero
        max_prefix = n_text_ctx // 2 - (sample_len or 0)
        if max_prefix <= 0:
            max_prefix = n_text_ctx // 2
        if len(prefix) > max_prefix:
            prefix = prefix[-max_prefix:]
        tokens = tokens + prefix
    if options.prompt is not None:
        prompt = (
            tokenizer.encode(" " + options.prompt.strip())
            if isinstance(options.prompt, str)
            else list(options.prompt)
        )
        n_ctx_half = n_text_ctx // 2 - 1
        tokens = [tokenizer.sot_prev] + prompt[-n_ctx_half:] + tokens
    return tokens


def decode(
    model,
    mel: torch.Tensor,
    options: DecodingOptions = DecodingOptions(),
    *,
    tokenizer=None,
    generator: Optional[torch.Generator] = None,
    keep_audio_features: bool = False,
) -> Union[DecodingResult, List[DecodingResult]]:
    """Decode 30 s mel segment(s). ``mel``: [T, n_mels] or [B, T, n_mels]."""
    return decode_finalize(
        decode_dispatch(
            model,
            mel,
            options,
            tokenizer=tokenizer,
            generator=generator,
            keep_audio_features=keep_audio_features,
        )
    )


def decode_dispatch(
    model,
    mel: torch.Tensor,
    options: DecodingOptions = DecodingOptions(),
    *,
    tokenizer=None,
    generator: Optional[torch.Generator] = None,
    keep_audio_features: bool = False,
    _eager: bool = False,
) -> dict:
    """Run the decode and return a handle of device tensors, not yet read
    back; ``decode_finalize`` converts them. Sampling at temperature > 0
    draws from ``generator`` (a ``torch.Generator`` on the model's
    device), which the caller must pass.

    On a CUDA device each step after the prefill replays a captured graph
    (``step_graph``), each data-parallel replica's too; a tensor-parallel
    model's decode and every CPU decode run the same step body uncaptured.
    ``_eager`` runs it uncaptured on the card too: the yardstick the
    captured decode is held against, and nothing else."""
    if options.temperature > 0 and generator is None:
        raise ValueError(
            "temperature > 0 samples: pass generator=torch.Generator(device)"
        )
    single = mel.dim() == 2
    if single:
        mel = mel[None]
    b = mel.shape[0]

    if tokenizer is None:
        from whisperx_tpu_torch.decoding.tokenizer import get_tokenizer

        tokenizer = get_tokenizer(
            model.is_multilingual,
            num_languages=model.dims.num_languages,
            language=options.language or "en",
            task=options.task,
        )

    mel = mel.to(model.dtype)
    language = options.language
    language_probs = [None] * b
    shared_features = None
    if model.is_multilingual and language is None:
        # encode ONCE and share the features between detection and decode
        with torch.inference_mode(), _tracker.span("decode.encoder", device=mel.device):
            shared_features = encoder_forward(
                model.encoder, mel, model.dims.n_audio_head
            )
        codes, probs = detect_language(
            model, None, tokenizer, features=shared_features
        )
        # one language per batch (whisper semantics: the majority)
        language = max(set(codes), key=codes.count)
        language_probs = probs
        # replace() re-runs __post_init__, rebuilding the SOT sequence
        tokenizer = dataclasses.replace(tokenizer, language=language)
    language = language or "en"

    n_ctx = model.dims.n_text_ctx
    sample_len = options.sample_len or n_ctx // 2
    initial = _build_initial_tokens(
        tokenizer, options, n_text_ctx=n_ctx, sample_len=options.sample_len
    )
    if len(initial) >= n_ctx:
        raise ValueError(
            f"prompt+prefix occupy {len(initial)} of {n_ctx} context slots; "
            "no room left to generate"
        )
    max_initial_ts_index = None
    if options.max_initial_timestamp is not None:
        max_initial_ts_index = round(options.max_initial_timestamp / 0.02)

    blank = tuple(tokenizer.encode(" "))
    cfg = _StaticConfig(
        n_head=model.dims.n_text_head,
        n_head_audio=model.dims.n_audio_head,
        n_text_ctx=n_ctx,
        eot=tokenizer.eot,
        sot_index=initial.index(tokenizer.sot),
        no_speech_token=tokenizer.no_speech,
        timestamp_begin=tokenizer.timestamp_begin,
        no_timestamps=tokenizer.no_timestamps,
        sample_len=min(sample_len, n_ctx - len(initial)),
        max_initial_timestamp_index=max_initial_ts_index,
        suppress_blank=options.suppress_blank,
        blank_tokens=blank if options.suppress_blank else (),
        suppress=F.build_suppress_list(
            tokenizer,
            options.suppress_tokens,
            suppress_numerals=options.suppress_numerals,
        ),
        without_timestamps=options.without_timestamps,
        greedy=options.temperature == 0,
        # WHISPERX_TPU_KV_QUANT=int8 forces the int8 cross-KV cache, as in JAX
        kv_quant=options.kv_quant
        or os.environ.get("WHISPERX_TPU_KV_QUANT") == "int8",
    )

    audio_in = shared_features if shared_features is not None else mel
    handle = {
        "b": b,
        "single": single,
        "tokenizer": tokenizer,
        "language": language,
        "language_probs": language_probs,
        "options": options,
        "keep_audio_features": keep_audio_features,
    }

    if options.beam_size is not None and options.temperature == 0:
        from whisperx_tpu_torch.decoding.beam import _beam_decode

        k = int(options.beam_size)
        # upstream: patience multiplies how many finished sequences are
        # collected before the search stops (patience=1 → beam_size)
        max_candidates = max(k, round(k * (options.patience or 1.0)))
        initial_arr = torch.tensor([initial] * b, dtype=torch.int64, device=mel.device)
        replicas = _data_replicas(model, b)
        if replicas is None:
            beam_device = _beam_decode(
                model, audio_in, initial_arr, cfg, k, max_candidates,
                audio_is_features=shared_features is not None, capture=not _eager,
            )
        else:
            beam_device = _split_rows(
                replicas, (audio_in, initial_arr),
                lambda j, rep, audio, init: _beam_decode(
                    rep, audio, init, cfg, k, max_candidates,
                    audio_is_features=shared_features is not None, capture=not _eager,
                ),
                mel.device,
            )
        return {**handle, "beam_device": beam_device, "steps": beam_device[6]}

    # best_of: at temperature > 0, n independent candidates per row (the
    # batch tiled), keeping the one with the best length-normalized score
    n_cand = 1
    if options.temperature > 0 and options.best_of and int(options.best_of) > 1:
        n_cand = int(options.best_of)
        audio_in = audio_in.repeat_interleave(n_cand, dim=0)
    initial_arr = torch.tensor(
        [initial] * (b * n_cand), dtype=torch.int64, device=mel.device
    )
    temperature = max(options.temperature, 1e-6)
    replicas = _data_replicas(model, b * n_cand)
    if replicas is None:
        out = _decode(
            model, audio_in, initial_arr, temperature, cfg, generator,
            audio_is_features=shared_features is not None, capture=not _eager,
        )
    else:
        shared = _SharedNoise(generator, b * n_cand, mel.device, len(replicas))
        per = b * n_cand // len(replicas)

        def run(j, rep, audio, init):
            try:
                return _decode(
                    rep, audio, init, temperature, cfg, None,
                    audio_is_features=shared_features is not None, capture=not _eager,
                    noise=lambda step, shape: shared.rows(
                        j, j * per, (j + 1) * per, step, shape
                    ).to(audio.device),
                )
            finally:
                shared.finish(j)

        out = _split_rows(replicas, (audio_in, initial_arr), run, mel.device)
    tokens_buf, lengths, sum_logprobs, no_speech_probs, audio_features, steps = out
    return {
        **handle,
        "device": (tokens_buf, lengths, sum_logprobs, no_speech_probs, audio_features),
        "steps": steps,
        "n_cand": n_cand,
    }


def _finalize_beam(handle: dict) -> Union[DecodingResult, List[DecodingResult]]:
    from whisperx_tpu_torch.decoding.beam import rank_beams

    (bank_toks, bank_lens, bank_scores, bank_count, live_toks, live_scores,
     n_sampled, no_speech_probs, audio_features) = handle["beam_device"]
    b = handle["b"]
    tokenizer = handle["tokenizer"]
    options = handle["options"]
    keep_audio_features = handle["keep_audio_features"]
    bank_toks, bank_lens, bank_scores, bank_count, live_toks, live_scores, nsp = (
        t.cpu().numpy()
        for t in (bank_toks, bank_lens, bank_scores, bank_count, live_toks,
                  live_scores, no_speech_probs)
    )
    k = live_toks.shape[1]
    results = []
    for i in range(b):
        # upstream finalize: the banked finished sequences; rows that banked
        # fewer than beam_size fill up from the in-flight beams
        n_bank = int(bank_count[i])
        toks_list = [bank_toks[i, s] for s in range(n_bank)]
        lens_list = [int(bank_lens[i, s]) for s in range(n_bank)]
        scores_list = [float(bank_scores[i, s]) for s in range(n_bank)]
        if n_bank < k:
            for j in np.argsort(-live_scores[i]):
                if len(toks_list) >= k:
                    break
                toks_list.append(live_toks[i, j])
                lens_list.append(n_sampled)
                scores_list.append(float(live_scores[i, j]))
        cand_toks = np.stack(toks_list)
        cand_lens = np.asarray(lens_list)
        cand_scores = np.asarray(scores_list)
        best, avg_lp = rank_beams(
            cand_toks, cand_lens, cand_scores, options.length_penalty
        )
        toks = cand_toks[best, : cand_lens[best]].tolist()
        text = tokenizer.decode(toks).strip()
        results.append(
            DecodingResult(
                audio_features=audio_features[i] if keep_audio_features else None,
                language=handle["language"],
                language_probs=handle["language_probs"][i],
                tokens=toks,
                text=text,
                avg_logprob=avg_lp,
                no_speech_prob=float(nsp[i]),
                temperature=0.0,
                compression_ratio=compression_ratio(text) if text else np.nan,
            )
        )
    return results[0] if handle["single"] else results


def decode_finalize(handle: dict) -> Union[DecodingResult, List[DecodingResult]]:
    """Read a ``decode_dispatch`` handle back into ``DecodingResult``s (the
    span ``decode.readback``); then the device times of the decode's spans
    are read, since the copies back followed them."""
    with _tracker.span("decode.readback"):
        out = _finalize_beam(handle) if "beam_device" in handle else _finalize_rows(handle)
        _tracker.settle()
    return out


def _finalize_rows(handle: dict) -> Union[DecodingResult, List[DecodingResult]]:
    tokens_buf, lengths, sum_logprobs, no_speech_probs, audio_features = handle[
        "device"
    ]
    b = handle["b"]
    n_cand = handle["n_cand"]
    tokenizer = handle["tokenizer"]
    options = handle["options"]
    keep_audio_features = handle["keep_audio_features"]

    tokens_np = tokens_buf.cpu().numpy()
    lengths_np = lengths.cpu().numpy()
    sum_lp = sum_logprobs.cpu().numpy()
    nsp = no_speech_probs.cpu().numpy()

    if n_cand > 1:
        # upstream MaximumLikelihoodRanker: sum_logprob / penalty, with
        # penalty ((5+len)/6)**length_penalty when set, else len + 1
        lp = options.length_penalty
        if lp is not None:
            penalty = ((5.0 + lengths_np) / 6.0) ** lp
        else:
            penalty = lengths_np + 1
        pick = (sum_lp / penalty).reshape(b, n_cand).argmax(axis=-1)
        sel = np.arange(b) * n_cand + pick
        tokens_np, lengths_np = tokens_np[sel], lengths_np[sel]
        sum_lp, nsp = sum_lp[sel], nsp[sel]
        if keep_audio_features:
            audio_features = audio_features[torch.as_tensor(sel)]

    results = []
    for i in range(b):
        toks = tokens_np[i, : lengths_np[i]].tolist()
        text = tokenizer.decode(toks).strip()
        results.append(
            DecodingResult(
                audio_features=audio_features[i] if keep_audio_features else None,
                language=handle["language"],
                language_probs=handle["language_probs"][i],
                tokens=toks,
                text=text,
                avg_logprob=float(sum_lp[i] / (lengths_np[i] + 1)),
                no_speech_prob=float(nsp[i]),
                temperature=options.temperature,
                compression_ratio=compression_ratio(text) if text else np.nan,
            )
        )
    return results[0] if handle["single"] else results

"""Trainable micro-Whisper: learned weights with no download.

Counterpart of ``whisperx_tpu/train/micro.py``. A test-nano Whisper is
trained to transcribe a tone-coded corpus (each lexicon word a pure tone
at its own frequency, so a clip's mel spectrogram encodes its transcript
and its time extent):

  - the decoder is trained by teacher forcing against full Whisper targets
    ``sot lang task <|t0|> text <|t1|> eot``, noise clips against
    ``sot <|nospeech|> eot``;
  - the encoder and the cross-attention key/value projections stay at their
    random initialization (a frozen featurizer), so the per-layer cross-KV
    of the fixed corpus is computed once, through K1;
  - phase 1 trains against only the token ids that occur in the targets,
    through a compact [n_active, d] embedding (``compact_decoder``); phase 2
    fine-tunes with the full-vocabulary softmax; then the certificate loop
    alternates the two until the worst-position margin clears 2.0.

The corpus functions are numpy and give the JAX package's arrays bit for
bit. Training runs on ``device`` (default ``"cuda"``; raises without a GPU
unless the caller passes ``"cpu"``), in f32 with TF32 off, forward and
backward (``utils.precision.reference_matmul``). Initial weights come from
a ``torch.Generator``, so a trained checkpoint is the port's own, not
JAX's; the tests hold single steps against JAX's from bridged weights.
"""

from __future__ import annotations

import dataclasses
import math
import types
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from whisperx_tpu_torch.audio.constants import N_SAMPLES, SAMPLE_RATE

# ---------------------------------------------------------------------------
# Tone-coded corpus
# ---------------------------------------------------------------------------

# Every token round-trips through the recovered partial vocabulary
# (assets/gold_vocab_en.json) and none is in the standard suppress list, so
# decoded text is byte-exact against these strings.
PHRASES: Tuple[str, ...] = (
    " Hello world.",
    " The quick brown fox.",
    " This is a test.",
    " Thank you very much.",
    " See you tomorrow.",
    " How are you today?",
    " The weather is nice.",
    " We are almost done.",
)

TONE_SECONDS = 0.28
GAP_SECONDS = 0.07
_PRECISION = 0.02  # whisper timestamp grid


def _lexicon(phrases: Sequence[str]) -> Dict[str, float]:
    """word -> tone frequency (Hz), log-spaced well inside the mel range."""
    words = sorted({w for p in phrases for w in _words(p)})
    lo, hi = 320.0, 3800.0
    n = max(len(words), 2)
    return {w: lo * (hi / lo) ** (i / (n - 1)) for i, w in enumerate(words)}


def _words(text: str) -> List[str]:
    return [
        "".join(ch for ch in w.lower() if ch.isalpha())
        for w in text.split()
        if any(ch.isalpha() for ch in w)
    ]


def phrase_duration(text: str) -> float:
    n = len(_words(text))
    return n * TONE_SECONDS + max(0, n - 1) * GAP_SECONDS


def render_phrase(
    text: str,
    lexicon: Optional[Dict[str, float]] = None,
    lead_s: float = 0.0,
    sr: int = SAMPLE_RATE,
) -> np.ndarray:
    """Render a phrase as its tone code, preceded by ``lead_s`` of silence."""
    if lexicon is None:
        lexicon = _lexicon(PHRASES)
    tone_n = int(TONE_SECONDS * sr)
    gap_n = int(GAP_SECONDS * sr)
    ramp = np.minimum(np.arange(tone_n) / (0.01 * sr), 1.0)
    ramp = np.minimum(ramp, ramp[::-1]).astype(np.float32)  # de-click
    parts = [np.zeros(int(lead_s * sr), np.float32)]
    for w in _words(text):
        t = np.arange(tone_n) / sr
        tone = 0.35 * np.sin(2 * math.pi * lexicon[w] * t).astype(np.float32)
        parts.append(tone * ramp)
        parts.append(np.zeros(gap_n, np.float32))
    parts = parts[:-1] if len(parts) > 1 else parts
    return np.concatenate(parts)


@dataclasses.dataclass
class Example:
    audio: np.ndarray  # padded to N_SAMPLES
    events: List[Tuple[float, str]]  # (onset_s, text) per phrase; [] = noise
    is_noise: bool = False

    @property
    def text(self) -> str:
        return "".join(t for _, t in self.events)


def compose_file(
    events: Sequence[Tuple[float, str]], lex=None, tail_s: float = 1.0
) -> np.ndarray:
    """Arbitrary-length recording with phrases at the given onsets."""
    if lex is None:
        lex = _lexicon(PHRASES)
    end = max(t + phrase_duration(x) for t, x in events) + tail_s
    a = np.zeros(int(end * SAMPLE_RATE), np.float32)
    for onset, text in events:
        r = render_phrase(text, lex)
        i = int(onset * SAMPLE_RATE)
        a[i : i + len(r)] += r
    return a


DEFAULT_CHUNK_SIZE = 8.0  # seconds; pass the same value to transcribe()


def build_files(
    phrases: Sequence[str] = PHRASES,
    n_files: int = 12,
    seed: int = 0,
) -> List[Tuple[np.ndarray, List[Tuple[float, str]]]]:
    """Synthetic recordings: every phrase once per file, in shuffled order,
    with continuously varying gaps, so each phrase occurs at many onsets and
    in both 'more speech follows' and 'window ends here' contexts."""
    lex = _lexicon(phrases)
    rng = np.random.default_rng(seed)
    files = []
    for _ in range(n_files):
        t = 0.8 + 0.6 * float(rng.random())
        events: List[Tuple[float, str]] = []
        for pi in rng.permutation(len(phrases)):
            text = phrases[int(pi)]
            events.append((round(t, 2), text))
            t += phrase_duration(text) + 0.9 + 1.4 * float(rng.random())
        files.append((compose_file(events, lex), events))
    return files


def chunk_examples(
    files: Sequence[Tuple[np.ndarray, List[Tuple[float, str]]]],
    chunk_size: float = DEFAULT_CHUNK_SIZE,
    device: Union[str, torch.device] = "cuda",
) -> List[Example]:
    """Slice files into decode windows with the pipeline's own chunker (the
    energy VAD + ``merge_chunks``), so the model trains on the chunk
    geometry inference hands it. The VAD reads the numpy audio on the host;
    ``device`` is the one ``load_vad_model`` checks."""
    from whisperx_tpu_torch.vad import load_vad_model, merge_chunks

    vad_model = load_vad_model("energy", device=device)
    onset = getattr(vad_model, "vad_onset", 0.5)
    offset = getattr(vad_model, "vad_offset", 0.363)
    out: List[Example] = []
    for audio, events in files:
        segs = vad_model(
            {"waveform": audio, "sample_rate": SAMPLE_RATE},
            max_speech_duration_s=chunk_size,
        )
        for ch in merge_chunks(segs, chunk_size, onset=onset, offset=offset):
            s = int(ch["start"] * SAMPLE_RATE)
            e = min(int(ch["end"] * SAMPLE_RATE), len(audio))
            seg = audio[s : min(e, s + N_SAMPLES)]
            seg = np.pad(seg, (0, N_SAMPLES - len(seg)))
            # clamp at 0: an event admitted up to 0.05 s before the chunk
            # start would otherwise give a negative onset, and
            # timestamp_begin - 2 is <|nospeech|>
            rel = [
                (max(0.0, round(t - s / SAMPLE_RATE, 4)), x)
                for t, x in events
                if ch["start"] - 0.05 <= t < ch["end"]
            ]
            if rel:
                out.append(Example(seg, rel))
    return out


def build_corpus(
    phrases: Sequence[str] = PHRASES,
    n_files: int = 12,
    chunk_size: float = DEFAULT_CHUNK_SIZE,
    n_noise: int = 2,
    seed: int = 0,
    device: Union[str, torch.device] = "cuda",
) -> List[Example]:
    """VAD-chunked multi-phrase windows (``merge_chunks`` packs adjacent
    speech into one window, so targets hold several timestamped phrases)
    plus noise clips, which train the no-speech head."""
    rng = np.random.default_rng(seed + 1)
    out = chunk_examples(build_files(phrases, n_files, seed), chunk_size, device)
    for _ in range(n_noise):
        a = (0.006 * rng.standard_normal(N_SAMPLES)).astype(np.float32)
        out.append(Example(a, [], is_noise=True))
    return out


def target_tokens(tokenizer, ex: Example) -> List[int]:
    """Full Whisper training target for one example."""
    if ex.is_noise:
        return [tokenizer.sot, tokenizer.no_speech, tokenizer.eot]
    seq = list(tokenizer.sot_sequence)
    for onset, text in ex.events:
        ts0 = tokenizer.timestamp_begin + round(onset / _PRECISION)
        ts1 = tokenizer.timestamp_begin + round(
            (onset + phrase_duration(text)) / _PRECISION
        )
        seq += [ts0] + tokenizer.encode(text) + [ts1]
    return seq + [tokenizer.eot]


def pad_rows(seqs: Sequence[Sequence[int]], length: int, fill: int) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens [N, length] padded with ``fill``, mask [N, length - 1] with 1
    where position j + 1 is a real target of row i)."""
    tokens = np.full((len(seqs), length), fill, np.int64)
    mask = np.zeros((len(seqs), length - 1), np.float32)
    for i, s in enumerate(seqs):
        tokens[i, : len(s)] = s
        mask[i, : len(s) - 1] = 1.0
    return tokens, mask


def active_remap(ids) -> Tuple[np.ndarray, np.ndarray]:
    """(active: the sorted ids, remap: id -> its row among them)."""
    active = np.asarray(sorted(ids), np.int64)
    remap = np.zeros(int(active.max()) + 1, np.int64)
    remap[active] = np.arange(len(active))
    return active, remap


# ---------------------------------------------------------------------------
# Losses (module level: the trainer and the tests call the same code)
# ---------------------------------------------------------------------------


def compact_decoder(dec, tok_emb: torch.Tensor):
    """A view of the ``TextDecoder`` ``dec`` whose blocks, positions and
    final norm are ``dec``'s own parameters and whose token embedding is
    ``tok_emb``: the [n_active, d] rows of the ids in play, read by the
    input gather (with remapped ids) and by the logits product."""
    return types.SimpleNamespace(
        tok_emb=tok_emb, pos_emb=dec.pos_emb, blocks=dec.blocks, ln=dec.ln, n_head=dec.n_head
    )


def decoder_logits(dec, tokens: torch.Tensor, cross_k, cross_v, capture_heads=None):
    """The production decoder teacher-forced over whole rows at offset 0,
    over a fresh zero self-cache of this call's own (autograd records the
    in-place cache writes, so a cache shared by two passes of one loss
    would fail its version check). With ``capture_heads`` also the
    pre-softmax cross-attention scores of those (layer, head) pairs,
    [A, B, T, 1500]."""
    from whisperx_tpu_torch.models.whisper.model import KVCache, decoder_forward, new_self_cache

    b, t = tokens.shape
    self_k, self_v = new_self_cache(dec, b, t, dec.n_head)
    cache = KVCache(self_k, self_v, list(cross_k), list(cross_v))
    if capture_heads is None:
        return decoder_forward(dec, tokens, cache, 0, dec.n_head)
    return decoder_forward(
        dec, tokens, cache, 0, dec.n_head, capture_cross_qk=True, capture_heads=capture_heads
    )


def cross_entropy(logits: torch.Tensor, tgt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean next-token NLL: ``logits[:, :-1]`` against ``tgt``."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_active(dec_small, tokens, tgt_small, mask, remap, cross_k, cross_v) -> torch.Tensor:
    """Phase 1 (JAX ``micro.py:393-400``): the compact decoder over the
    remapped ids, CE over the active vocabulary."""
    return cross_entropy(decoder_logits(dec_small, remap[tokens], cross_k, cross_v), tgt_small, mask)


def loss_full(dec, tokens, mask, cross_k, cross_v) -> torch.Tensor:
    """Phase 2 (``micro.py:402-407``): the full-vocabulary CE."""
    return cross_entropy(decoder_logits(dec, tokens, cross_k, cross_v), tokens[:, 1:], mask)


def _target_margins(logits: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Target logit minus the best competitor's, per position, and the
    competitors' logits with the target's set to -inf."""
    tgt_logit = logits.gather(-1, tgt[..., None])[..., 0]
    masked = logits.scatter(-1, tgt[..., None], float("-inf"))
    return tgt_logit, masked


@torch.no_grad()
def min_margin(dec, tokens, mask, cross_k, cross_v) -> float:
    """The exactness certificate (``micro.py:472-484``): the worst
    teacher-forced position's target logit minus its best competitor over
    the full vocabulary. Greedy decoding reproduces every target iff it is
    positive."""
    logits = decoder_logits(dec, tokens, cross_k, cross_v)[:, :-1]
    tgt_logit, masked = _target_margins(logits, tokens[:, 1:])
    margin = tgt_logit - masked.amax(-1)
    return float(torch.where(mask > 0, margin, float("inf")).min())


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def english_tokenizer(dims):
    from whisperx_tpu_torch.decoding.tokenizer import get_tokenizer

    return get_tokenizer(
        dims.is_multilingual, num_languages=dims.num_languages, language="en", task="transcribe"
    )


def decoder_params(dec, frozen=("cross_attn.key", "cross_attn.value")):
    """The decoder's parameters a trainer updates besides the token
    embedding (which it trains whole or as a compact copy), without the
    ``frozen`` projections; ``requires_grad_`` set on each."""
    return [
        p.requires_grad_(True)
        for name, p in dec.named_parameters()
        if name != "tok_emb" and not any(f in name for f in frozen)
    ]


def gather_rows(table: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """A trainable copy of ``table``'s ``active`` rows."""
    return table.detach()[active].requires_grad_(True)


@torch.no_grad()
def scatter_rows(table: torch.Tensor, active: torch.Tensor, rows: torch.Tensor) -> None:
    """``table[active] = rows`` (JAX: ``.at[active].set``)."""
    table[active] = rows.detach()


def train_micro(
    model_name: str = "test-nano",
    phrases: Sequence[str] = PHRASES,
    steps: int = 600,
    full_steps: int = 40,
    lr: float = 7e-3,
    seed: int = 0,
    log_every: int = 0,
    device: Union[str, torch.device] = "cuda",
):
    """Overfit the decoder on the tone corpus. Returns (model, dims,
    report): the whole f32 ``Whisper`` (random encoder, trained decoder) on
    ``device``, ready for ``save_micro_checkpoint``."""
    from whisperx_tpu_torch.audio.mel import log_mel_batch
    from whisperx_tpu_torch.models.whisper import get_dims, load_model, resolve_device
    from whisperx_tpu_torch.models.whisper.model import encoder_forward, precompute_cross_kv
    from whisperx_tpu_torch.train.optim import Adam, warmup_cosine_decay_schedule
    from whisperx_tpu_torch.utils.precision import reference_matmul

    dev = resolve_device(device)
    dims = get_dims(model_name)
    tokenizer = english_tokenizer(dims)
    corpus = build_corpus(phrases, seed=seed, device=dev)
    model = load_model(model_name, dtype=torch.float32, device=dev, seed=seed)
    dec = model.decoder
    n_head = dims.n_text_head

    # features and cross-KV once: the encoder and the cross K/V projections
    # are frozen. [L][B, 1500, H, Dh] f32
    with torch.no_grad():
        mels = log_mel_batch(np.stack([ex.audio for ex in corpus]), dims.n_mels, device=dev)
        feats = encoder_forward(model.encoder, mels, dims.n_audio_head)
        cross_k, cross_v = precompute_cross_kv(dec, feats, n_head)
        del feats, mels

    seqs = [target_tokens(tokenizer, ex) for ex in corpus]
    t_max = max(len(s) for s in seqs)
    tokens_np, mask_np = pad_rows(seqs, t_max, tokenizer.eot)
    active_np, remap_np = active_remap({t for s in seqs for t in s})
    tokens = torch.from_numpy(tokens_np).to(dev)
    mask = torch.from_numpy(mask_np).to(dev)
    active = torch.from_numpy(active_np).to(dev)
    remap = torch.from_numpy(remap_np).to(dev)
    tgt_small = remap[tokens[:, 1:]]

    body = decoder_params(dec)
    tok_emb = dec.tok_emb.requires_grad_(True)

    def run_active(learning_rate, n):
        """``n`` compact-embedding steps from fresh moments, then the
        trained rows scattered back into the full table."""
        small = gather_rows(tok_emb, active)
        opt = Adam([small, *body], learning_rate)
        view = compact_decoder(dec, small)
        loss = None
        for i in range(n):
            loss = loss_active(view, tokens, tgt_small, mask, remap, cross_k, cross_v)
            loss.backward()
            opt.step()
            loss = loss.detach()
            if log_every and (i + 1) % log_every == 0:
                print(f"[active] step {i + 1}/{n} loss {float(loss):.4f}")
        scatter_rows(tok_emb, active, small)
        return loss

    def run_full(opt, n):
        loss = None
        for i in range(n):
            loss = loss_full(dec, tokens, mask, cross_k, cross_v)
            loss.backward()
            opt.step()
            loss = loss.detach()
            if log_every and (i + 1) % log_every == 0:
                print(f"[full] step {i + 1}/{n} loss {float(loss):.4f}")
        return loss

    with reference_matmul():
        # warmup + cosine decay: full-batch overfitting tolerates a high peak
        # once past the noisy first steps
        schedule = warmup_cosine_decay_schedule(
            init_value=lr / 20, peak_value=lr, warmup_steps=30,
            decay_steps=steps + full_steps, end_value=lr / 60,
        )
        loss = run_active(schedule, steps)
        # phase 2: a fine-tune at a small constant rate with fresh moments,
        # pushing the untrained tokens' logits below the learned ones
        loss = run_full(Adam([tok_emb, *body], 6e-4), full_steps)

        # the certificate: greedy decoding reproduces the targets iff the
        # target wins the full-vocabulary argmax at every position; train
        # until the worst margin clears a buffer for bf16 inference
        target_margin = 2.0
        extra_rounds = 0
        margin = min_margin(dec, tokens, mask, cross_k, cross_v)
        while margin < target_margin and extra_rounds < 6:
            extra_rounds += 1
            loss = run_active(1.5e-3, 80)
            loss = run_full(Adam([tok_emb, *body], 6e-4), 15)
            margin = min_margin(dec, tokens, mask, cross_k, cross_v)
            if log_every:
                print(f"[certify] round {extra_rounds}: min margin {margin:.2f} (target {target_margin})")

    for p in model.parameters():
        p.requires_grad_(False)
    report = {
        "final_loss": float(loss),
        "steps": steps,
        "full_steps": full_steps,
        "examples": len(corpus),
        "t_max": t_max,
        "active_vocab": int(len(active_np)),
        "min_margin": round(margin, 3),
        "certify_rounds": extra_rounds,
    }
    return model, dims, report


def cache_dir(cache_root: Optional[str], name: str, sources: Sequence[str], device) -> str:
    """``<root>/<name>_<key>``: the key hashes the trainers' sources and the
    device type (a CUDA-trained and a CPU-trained model differ); the root is
    ``~/.cache/whisperx_tpu_torch`` unless given."""
    import hashlib
    import os

    from whisperx_tpu_torch.models.whisper import resolve_device

    h = hashlib.sha256()
    for path in sources:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(resolve_device(device).type.encode())
    root = cache_root or os.path.expanduser("~/.cache/whisperx_tpu_torch")
    return os.path.join(root, f"{name}_{h.hexdigest()[:16]}")


def cached_report(path: str) -> Optional[dict]:
    """The training report of a cached checkpoint at ``path``, or None."""
    import json
    import os

    report_path = os.path.join(path, "train_report.json")
    if os.path.exists(os.path.join(path, "weights.npz")) and os.path.exists(report_path):
        with open(report_path) as f:
            return json.load(f)
    return None


def write_report(path: str, report: dict) -> None:
    import json
    import os

    with open(os.path.join(path, "train_report.json"), "w") as f:
        json.dump(report, f)


def micro_checkpoint_cached(
    cache_root: Optional[str] = None, device: Union[str, torch.device] = "cuda"
) -> Tuple[str, dict]:
    """Train once, then reuse: the checkpoint lives under a key of this
    module's source (training is deterministic given the code and the
    device). Returns (checkpoint_dir, train_report)."""
    path = cache_dir(cache_root, "micro_ckpt", [__file__], device)
    report = cached_report(path)
    if report is not None:
        return path, report
    model, dims, report = train_micro(device=device)
    save_micro_checkpoint(path, model, dims, report)
    write_report(path, report)
    return path, report


def save_micro_checkpoint(
    path: str, model, dims, report: Optional[dict] = None, alignment_heads=None,
) -> str:
    """Write ``model`` as a checkpoint directory (``weights.npz`` +
    ``config.json``, the JAX package's layout) that either package's
    ``load_model`` and CLI ``--model`` accept. ``alignment_heads``:
    [(layer, head)] to pin for the word-timing path."""
    from whisperx_tpu_torch.convert.checkpoint import save_checkpoint

    config = {
        "name": "micro-learned",
        "family": "whisper",
        "dims": dataclasses.asdict(dims),
        "alignment_heads": [list(x) for x in alignment_heads] if alignment_heads else None,
        "micro_train": report or {},
    }
    save_checkpoint(path, model, config)
    return path

"""Learned word timing: a micro-Whisper whose cross-attention attends where
the words are.

Counterpart of ``whisperx_tpu/train/align_micro.py``. Starting from the
trained micro checkpoint (``train/micro.py``), it fine-tunes

  - the timestamped CE objective (keeps greedy decoding exact, certified by
    the worst-position argmax margin), and
  - a cross-attention supervision loss at the alignment heads on
    teacher-forced no-timestamps rows, the regime word timing runs: row r
    of the DTW estimator's matrix must put its attention mass on the frames
    of the word the estimator reads it against.

Phases: A, the encoder frozen (its features through K1, once), the decoder
trained with a compact-vocabulary CE plus the attention loss; B (off by
default, ``steps_b=0``; measured in JAX to overfit the fixed layouts), the
encoder unfrozen: its attention runs K1 forward and K1's gradient rule
backward on CUDA; A2, a full-vocabulary CE repair; C, the certificate loop
(compact steps with the attention term, then a short full-vocabulary
fine-tune) until the margin and the attention hit clear their gates.
Training runs on ``device`` (default ``"cuda"``) in f32 with TF32 off.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from whisperx_tpu_torch.audio.constants import TOKENS_PER_SECOND
from whisperx_tpu_torch.train.micro import (
    GAP_SECONDS,
    PHRASES,
    TONE_SECONDS,
    Example,
    _target_margins,
    _words,
    active_remap,
    build_corpus,
    compact_decoder,
    cross_entropy,
    decoder_logits,
    gather_rows,
    pad_rows,
    save_micro_checkpoint,
    scatter_rows,
    target_tokens,
)

# frames are encoder-output frames (50 fps; the DTW time unit)
_TONE_F = TONE_SECONDS * TOKENS_PER_SECOND
_GAP_F = GAP_SECONDS * TOKENS_PER_SECOND


def word_frame_spans(events: Sequence[Tuple[float, str]]) -> List[Tuple[float, float]]:
    """Flattened (start_frame, end_frame) per word, chunk-relative: word k
    of a phrase at onset t spans [t + k·(TONE+GAP), … + TONE] seconds, by
    construction of ``render_phrase``."""
    spans = []
    for onset, text in events:
        f = onset * TOKENS_PER_SECOND
        for _ in _words(text):
            spans.append((f, f + _TONE_F))
            f += _TONE_F + _GAP_F
    return spans


def notimestamps_row(tokenizer, ex: Example) -> List[int]:
    """The teacher-forced row word timing builds (``timing``'s
    ``_teacher_forced_rows``)."""
    text_tokens = [t for _, x in ex.events for t in tokenizer.encode(x)]
    return [*tokenizer.sot_sequence, tokenizer.no_timestamps] + text_tokens + [tokenizer.eot]


def attention_targets(tokenizer, ex: Example, n_frames: int = 1500) -> Tuple[np.ndarray, np.ndarray]:
    """Per-query-position supervision for one example: (target [L_row,
    n_frames] f32, rows summing to 1 where supervised; weight [L_row] f32,
    1 on supervised positions), L_row = len(notimestamps_row(ex)). Query
    position sot_len + r is matrix row r of the DTW estimator: a word's
    rows share its tone frames uniformly, the last row before a gap extends
    through it, punctuation rows pin to the previous word's end, and the
    final row gets the last word's end."""
    text_tokens = [t for _, x in ex.events for t in tokenizer.encode(x)]
    n = len(text_tokens)
    words, word_tokens = tokenizer.split_to_word_tokens(text_tokens + [tokenizer.eot])
    boundaries = np.pad(np.cumsum([len(t) for t in word_tokens[:-1]]), (1, 0))  # [K+1]
    spans = word_frame_spans(ex.events)

    n_rows = n + 1  # matrix rows: [notimestamps, text...]
    lo = np.zeros(n_rows, np.float64)
    hi = np.zeros(n_rows, np.float64)
    ri = 0
    prev_end = 0.0
    for k in range(len(words) - 1):  # skip the trailing eot "word"
        b0, b1 = int(boundaries[k]), int(boundaries[k + 1])
        if any(ch.isalpha() for ch in words[k]):
            f0, f1 = spans[ri]
            ri += 1
            m = b1 - b0
            for i in range(m):
                lo[b0 + i] = f0 + i * (f1 - f0) / m
                hi[b0 + i] = f0 + (i + 1) * (f1 - f0) / m
            prev_end = f1
        else:  # punctuation: zero width at the previous word's end
            lo[b0:b1] = prev_end
            hi[b0:b1] = prev_end + 1.0
    if ri != len(spans):
        raise ValueError(f"{ri} word rows for {len(spans)} word spans: {words}")
    # the final row's entry time is the DTW estimate of the last word's end
    lo[n] = prev_end
    hi[n] = prev_end + _GAP_F
    # each row extends to the next row's start, so the DTW path enters row
    # r + 1 exactly at lo[r + 1]
    for r in range(n_rows - 1):
        hi[r] = max(hi[r], lo[r + 1])

    sot_len = len(tokenizer.sot_sequence)
    l_row = sot_len + 1 + n + 1  # == len(notimestamps_row)
    target = np.zeros((l_row, n_frames), np.float32)
    weight = np.zeros(l_row, np.float32)
    for r in range(n_rows):
        a = int(round(lo[r]))
        b = max(int(round(hi[r])), a + 1)
        b = min(b, n_frames)
        a = min(a, b - 1)
        q = sot_len + r  # query position of matrix row r
        target[q, a:b] = 1.0 / (b - a)
        weight[q] = 1.0
    return target, weight


def _noisy(audio: np.ndarray, rng, noise_amp: float = 0.02) -> np.ndarray:
    return (audio + noise_amp * rng.standard_normal(len(audio))).astype(np.float32)


def alignment_heads_of(dims) -> Tuple[Tuple[int, int], ...]:
    """Head 0 of each upper decoder layer: the pairs the trainers supervise
    and pin in the checkpoint (supervising every upper head fought the CE
    objective in JAX's measurements; one free head per layer carries the
    content)."""
    return tuple((layer, 0) for layer in range(dims.n_text_layer // 2, dims.n_text_layer))


# ---------------------------------------------------------------------------
# Losses (JAX ``align_micro.py:300-360``, at module level)
# ---------------------------------------------------------------------------


def run_decoder(dec, feats: torch.Tensor, tokens: torch.Tensor, capture_heads=None):
    """The decoder over ``tokens`` with the cross-KV projected from
    ``feats`` by ``dec``'s own (trained) key/value weights; with
    ``capture_heads``, (logits, [A, B, T, 1500] pre-softmax scores)."""
    from whisperx_tpu_torch.models.whisper.model import precompute_cross_kv

    ck, cv = precompute_cross_kv(dec, feats, dec.n_head)
    return decoder_logits(dec, tokens, ck, cv, capture_heads)


def attention_ce(cqk: torch.Tensor, at: torch.Tensor, aw: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of the alignment heads' attention (``cqk`` [A, B, T,
    F], the scores word timing softmaxes) against the row targets ``at``
    [B, T, F] with weights ``aw`` [B, T], averaged over supervised rows and
    heads."""
    logp = torch.log_softmax(cqk.transpose(0, 1).float(), dim=-1)  # [B, A, T, F]
    row_ce = -(at.float()[:, None] * logp).sum(-1)  # [B, A, T]
    return (row_ce * aw[:, None]).sum() / torch.clamp(aw.sum() * cqk.shape[0], min=1.0)


def loss_a(dec_small, feats, tsk, tss, tsm, ntk, nts, ntm, at, aw, remap, heads,
           attn_weight: float = 1.0) -> torch.Tensor:
    """Phase A: frozen encoder features, the compact decoder over remapped
    ids (timestamped CE + half the no-timestamps CE) plus the attention
    loss."""
    ts_logits = run_decoder(dec_small, feats, remap[tsk])
    nt_logits, cqk = run_decoder(dec_small, feats, remap[ntk], heads)
    ce = cross_entropy(ts_logits, tss, tsm) + 0.5 * cross_entropy(nt_logits, nts, ntm)
    return ce + attn_weight * attention_ce(cqk, at, aw)


def loss_b(model, mel, tsk, tsm, ntk, ntm, at, aw, heads, attn_weight: float = 1.0):
    """Phase B: the whole model, the encoder included (K1 and its gradient
    rule on CUDA), full-vocabulary CE. Returns (loss, (ce_ts, ce_nt,
    ce_attn))."""
    from whisperx_tpu_torch.models.whisper.model import encoder_forward

    feats = encoder_forward(model.encoder, mel, model.dims.n_audio_head)
    ts_logits = run_decoder(model.decoder, feats, tsk)
    nt_logits, cqk = run_decoder(model.decoder, feats, ntk, heads)
    ce_ts = cross_entropy(ts_logits, tsk[:, 1:], tsm)
    ce_nt = cross_entropy(nt_logits, ntk[:, 1:], ntm)
    ce_at = attention_ce(cqk, at, aw)
    return ce_ts + 0.5 * ce_nt + attn_weight * ce_at, (ce_ts, ce_nt, ce_at)


def loss_a2(dec, feats, tsk, tsm, ntk, ntm) -> torch.Tensor:
    """The full-vocabulary CE repair (no attention term)."""
    ts_logits = run_decoder(dec, feats, tsk)
    nt_logits = run_decoder(dec, feats, ntk)
    return cross_entropy(ts_logits, tsk[:, 1:], tsm) + 0.5 * cross_entropy(nt_logits, ntk[:, 1:], ntm)


def timestamp_margins(logits_full, tsk, tsm, ts_begin: int, nt_id: int) -> torch.Tensor:
    """Per-position margins of the timestamped rows, without counting as
    competitors of a timestamp target its ±1-grid neighbours (0.02 s onset
    quantization) and <|notimestamps|> (which the decode's logit filters
    suppress); padded positions are +inf. Text tokens stay certified
    exactly."""
    logits = logits_full[:, :-1]
    tgt = tsk[:, 1:]
    tgt_logit, masked = _target_margins(logits, tgt)
    is_ts = tgt >= ts_begin
    for nb in (
        torch.clamp(tgt - 1, min=ts_begin),
        torch.clamp(tgt + 1, max=logits.shape[-1] - 1),
        torch.full_like(tgt, nt_id),
    ):
        cur = masked.gather(-1, nb[..., None])[..., 0]
        masked = masked.scatter(-1, nb[..., None], torch.where(is_ts, float("-inf"), cur)[..., None])
    margin = tgt_logit - masked.amax(-1)
    return torch.where(tsm > 0, margin, float("inf"))


def attention_hits(cqk, at, aw) -> Tuple[torch.Tensor, torch.Tensor]:
    """(supervised rows whose mean-over-heads attention peak lies within 2
    frames of their target span, supervised rows): DTW reads the plateaus'
    structure, so a peak just outside the span still enters the right
    row."""
    mean_attn = torch.softmax(cqk.float(), dim=-1).mean(0)  # [B, T, F]
    peak = mean_attn.argmax(-1)
    dil = at.float() > 0
    for _ in range(2):
        dil = (
            dil
            | torch.nn.functional.pad(dil[..., 1:], (0, 1))
            | torch.nn.functional.pad(dil[..., :-1], (1, 0))
        )
    in_span = dil.float().gather(-1, peak[..., None])[..., 0]
    return (in_span * aw).sum(), aw.sum()


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def train_micro_aligned(
    model_name: str = "test-nano",
    phrases: Sequence[str] = PHRASES,
    steps_a: int = 800,
    steps_b: int = 0,
    minibatch: int = 8,
    lr_a: float = 1.5e-3,
    lr_b: float = 3e-4,
    attn_weight: float = 1.0,
    seed: int = 0,
    log_every: int = 0,
    init_checkpoint: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
):
    """Attention-supervised fine-tune. Returns (model f32, dims, report).
    ``init_checkpoint`` defaults to the port's cached micro checkpoint, so
    decode exactness is reused and this only teaches the cross-attention
    where to look. ``model_name`` must match the checkpoint's dims."""
    from whisperx_tpu_torch.audio.mel import log_mel_batch
    from whisperx_tpu_torch.convert.checkpoint import load_checkpoint
    from whisperx_tpu_torch.models.whisper import get_dims, resolve_device
    from whisperx_tpu_torch.models.whisper.model import encoder_forward
    from whisperx_tpu_torch.train.micro import decoder_params, english_tokenizer
    from whisperx_tpu_torch.train.optim import Adam, warmup_cosine_decay_schedule
    from whisperx_tpu_torch.utils.precision import reference_matmul

    dev = resolve_device(device)
    dims = get_dims(model_name)
    tokenizer = english_tokenizer(dims)
    if init_checkpoint is None:
        from whisperx_tpu_torch.train.micro import micro_checkpoint_cached

        init_checkpoint, _ = micro_checkpoint_cached(device=dev)
    model, _cfg = load_checkpoint(init_checkpoint, torch.float32, dev)
    if model.dims != dims:
        raise ValueError(f"{init_checkpoint!r} holds {model.dims}, not {model_name}'s dims")
    dec = model.decoder

    rng = np.random.default_rng(seed + 17)
    base = [ex for ex in build_corpus(phrases, seed=seed, device=dev) if not ex.is_noise]
    corpus = base + [Example(_noisy(ex.audio, rng), ex.events) for ex in base]
    n_ex = len(corpus)
    mels = log_mel_batch(np.stack([ex.audio for ex in corpus]), dims.n_mels, device=dev)

    # timestamped rows (decode exactness) and no-timestamps rows (attention
    # supervision), each padded to a multiple of 8
    ts_seqs = [target_tokens(tokenizer, ex) for ex in corpus]
    t1 = -(-max(len(s) for s in ts_seqs) // 8) * 8
    ts_tokens, ts_mask = pad_rows(ts_seqs, t1, tokenizer.eot)
    nt_seqs = [notimestamps_row(tokenizer, ex) for ex in corpus]
    t2 = -(-max(len(s) for s in nt_seqs) // 8) * 8
    nt_tokens, nt_mask = pad_rows(nt_seqs, t2, tokenizer.eot)
    attn_t = np.zeros((n_ex, t2, 1500), np.float32)
    attn_w = np.zeros((n_ex, t2), np.float32)
    for i, ex in enumerate(corpus):
        tgt, w = attention_targets(tokenizer, ex)
        attn_t[i, : tgt.shape[0]] = tgt
        attn_w[i, : len(w)] = w
    active_np, remap_np = active_remap(
        {int(t) for s in ts_seqs for t in s} | {int(t) for s in nt_seqs for t in s}
    )
    ts_small = remap_np[ts_tokens[:, 1:]]
    nt_small = remap_np[nt_tokens[:, 1:]]
    data = {
        name: torch.from_numpy(arr).to(dev)
        for name, arr in dict(
            tsk=ts_tokens, tss=ts_small, tsm=ts_mask, ntk=nt_tokens, nts=nt_small,
            ntm=nt_mask, at=attn_t, aw=attn_w,
        ).items()
    }
    active = torch.from_numpy(active_np).to(dev)
    remap = torch.from_numpy(remap_np).to(dev)
    heads = alignment_heads_of(dims)

    order = rng.permutation(n_ex)
    cursor = 0

    def next_idx() -> torch.Tensor:
        nonlocal order, cursor
        if cursor + minibatch > n_ex:
            order = rng.permutation(n_ex)
            cursor = 0
        idx = np.sort(order[cursor : cursor + minibatch])
        cursor += minibatch
        return torch.from_numpy(idx).to(dev)

    def rows(idx, *names):
        return [data[n][idx] for n in names]

    def frozen_features():
        with torch.no_grad():
            return encoder_forward(model.encoder, mels, dims.n_audio_head)

    body = decoder_params(dec, frozen=())
    tok_emb = dec.tok_emb.requires_grad_(True)

    def compact_steps(learning_rate, n, batch, tag):
        """``n`` phase-A steps of the compact decoder; ``batch()`` gives
        each step's (features, rows); the rows scattered back after."""
        small = gather_rows(tok_emb, active)
        opt = Adam([small, *body], learning_rate)
        view = compact_decoder(dec, small)
        for i in range(n):
            feats, r = batch()
            loss = loss_a(view, feats, *r, remap, heads, attn_weight)
            loss.backward()
            opt.step()
            if log_every and (i + 1) % log_every == 0:
                print(f"[{tag}] step {i + 1}/{n} loss {float(loss.detach()):.4f}")
        scatter_rows(tok_emb, active, small)

    a_names = ("tsk", "tss", "tsm", "ntk", "nts", "ntm", "at", "aw")
    a2_names = ("tsk", "tsm", "ntk", "ntm")
    aux = (float("nan"),) * 3
    with reference_matmul():
        # ---- phase A: the decoder only, on frozen features
        feats_all = frozen_features()

        def minibatch_a():
            idx = next_idx()
            return feats_all[idx], rows(idx, *a_names)

        compact_steps(
            warmup_cosine_decay_schedule(
                init_value=lr_a / 20, peak_value=lr_a,
                warmup_steps=min(20, max(1, steps_a // 4)),
                decay_steps=steps_a, end_value=lr_a / 30,
            ),
            steps_a, minibatch_a, "align A",
        )

        # ---- phase B: joint, full vocabulary (the encoder through K1)
        if steps_b:
            every = [p.requires_grad_(True) for p in model.parameters()]
            opt_b = Adam(every, lr_b)
            for i in range(steps_b):
                idx = next_idx()
                loss, aux = loss_b(model, mels[idx], *rows(idx, "tsk", "tsm", "ntk", "ntm", "at", "aw"),
                                   heads, attn_weight)
                loss.backward()
                opt_b.step()
                aux = tuple(float(x.detach()) for x in aux)
                if log_every and (i + 1) % log_every == 0:
                    print(f"[align B] step {i + 1}/{steps_b} loss {float(loss.detach()):.4f} "
                          f"(ts {aux[0]:.4f} nt {aux[1]:.4f} attn {aux[2]:.4f})")
            for p in model.encoder.parameters():
                p.requires_grad_(False)
            feats_all = frozen_features()  # the encoder moved

        # ---- phase A2: full-vocabulary CE repair
        opt_a2 = Adam([tok_emb, *body], 5e-4)
        for _ in range(60):
            idx = next_idx()
            loss_a2(dec, feats_all[idx], *rows(idx, *a2_names)).backward()
            opt_a2.step()

        # ---- phase C: certify (compact overfitting with the attention term,
        # then a short full-vocabulary repair over the two halves)
        ts_begin, nt_id = tokenizer.timestamp_begin, tokenizer.no_timestamps

        @torch.no_grad()
        def metrics(group: int = 8):
            mm, hit, tot = float("inf"), 0.0, 0.0
            for base_i in range(0, n_ex, group):
                sl = slice(base_i, min(base_i + group, n_ex))
                if group - (sl.stop - sl.start):  # JAX keeps one shape
                    sl = slice(n_ex - group, n_ex)
                feats = encoder_forward(model.encoder, mels[sl], dims.n_audio_head)
                tsk, tsm, ntk, at, aw = (data[n][sl] for n in ("tsk", "tsm", "ntk", "at", "aw"))
                mm = min(mm, float(timestamp_margins(run_decoder(dec, feats, tsk), tsk, tsm, ts_begin, nt_id).min()))
                _, cqk = run_decoder(dec, feats, ntk, heads)
                h, t = attention_hits(cqk, at, aw)
                hit, tot = hit + float(h), tot + float(t)
            return mm, hit / max(tot, 1.0)

        halves = [torch.arange(0, n_ex // 2, device=dev), torch.arange(n_ex // 2, n_ex, device=dev)]
        everything = torch.arange(n_ex, device=dev)
        min_margin, attn_hit = metrics()
        extra_rounds = 0
        while (min_margin < 0.5 or attn_hit < 0.97) and extra_rounds < 8:
            extra_rounds += 1
            compact_steps(1.5e-3, 80, lambda: (feats_all, rows(everything, *a_names)), "certify C")
            opt_full = Adam([tok_emb, *body], 6e-4)
            for _ in range(8):
                for sel in halves:
                    loss_a2(dec, feats_all[sel], *rows(sel, *a2_names)).backward()
                    opt_full.step()
            min_margin, attn_hit = metrics()
            if log_every:
                print(f"[certify C] round {extra_rounds}: margin {min_margin:.2f} attn_hit {attn_hit:.3f}")

    for p in model.parameters():
        p.requires_grad_(False)

    def _f(v):
        return round(v, 4) if np.isfinite(v) else None

    report = {
        "steps_a": steps_a,
        "steps_b": steps_b,
        "examples": n_ex,
        "ce_ts": _f(aux[0]),
        "ce_nt": _f(aux[1]),
        "ce_attn": _f(aux[2]),
        "min_margin": round(min_margin, 3),
        "attn_hit": round(attn_hit, 4),
        "certify_rounds": extra_rounds,
        "init_checkpoint": init_checkpoint,
        "alignment_heads": [list(x) for x in heads],
    }
    return model, dims, report


def aligned_checkpoint_cached(
    cache_root: Optional[str] = None, device: Union[str, torch.device] = "cuda"
) -> Tuple[str, dict]:
    """Train once, then reuse, keyed on this module's and
    ``train/micro.py``'s sources (as ``micro_checkpoint_cached``)."""
    from whisperx_tpu_torch.train import micro as _micro
    from whisperx_tpu_torch.train.micro import cache_dir, cached_report, write_report

    path = cache_dir(cache_root, "micro_aligned_ckpt", [__file__, _micro.__file__], device)
    report = cached_report(path)
    if report is not None:
        return path, report
    model, dims, report = train_micro_aligned(device=device)
    save_micro_checkpoint(path, model, dims, report, alignment_heads=report["alignment_heads"])
    write_report(path, report)
    return path, report

"""Online attention-supervised micro-Whisper: learned timing that
generalises.

Counterpart of ``whisperx_tpu/train/align_online.py``. The fixed-corpus
trainers certify their own windows but memorise them; here every step
samples fresh decode windows with the pipeline chunker's geometry (1-3
phrases, random gaps, mixed noise floors), so the only fit is one that
reads the audio. The encoder stays frozen at its random initialization and
runs at every step, through K1, without a gradient (JAX's
``stop_gradient``); the decoder trains with the compact-vocabulary CE over
timestamped and no-timestamps rows plus the attention supervision of
``align_micro``, then a full-vocabulary phase; the certificate (margin with
the timestamp carve-out, attention hit) is taken on held-out windows.

One deliberate difference from JAX: a sampled row longer than the 64
token slots raises ``ValueError`` (JAX's ``make_batch`` cuts it silently).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from whisperx_tpu_torch.audio.constants import N_SAMPLES, SAMPLE_RATE
from whisperx_tpu_torch.train.align_micro import (
    alignment_heads_of,
    attention_ce,
    attention_hits,
    attention_targets,
    notimestamps_row,
    run_decoder,
    timestamp_margins,
)
from whisperx_tpu_torch.train.micro import (
    DEFAULT_CHUNK_SIZE,
    PHRASES,
    Example,
    active_remap,
    compact_decoder,
    cross_entropy,
    gather_rows,
    phrase_duration,
    render_phrase,
    save_micro_checkpoint,
    scatter_rows,
    target_tokens,
)

_T1 = 64  # timestamped rows' token slots
_T2 = 64  # no-timestamps rows' token slots
_NOISE_AMPS = (0.0, 0.01, 0.02, 0.005, 0.0, 0.015)


def sample_window(rng, lex, phrases: Sequence[str]) -> Example:
    """One fresh decode window with the pipeline chunker's geometry."""
    n_ph = int(rng.choice([1, 2, 3], p=[0.2, 0.4, 0.4]))
    lead = 0.02 + 0.08 * float(rng.random())
    t = lead
    events = []
    for _ in range(n_ph):
        text = phrases[int(rng.integers(len(phrases)))]
        if t + phrase_duration(text) > DEFAULT_CHUNK_SIZE - 0.3:
            break
        events.append((round(t, 4), text))
        t += phrase_duration(text) + 0.9 + 1.4 * float(rng.random())
    if not events:
        text = phrases[int(rng.integers(len(phrases)))]
        events = [(round(lead, 4), text)]
    audio = np.zeros(N_SAMPLES, np.float32)
    for onset, text in events:
        clip = render_phrase(text, lex)
        i = int(onset * SAMPLE_RATE)
        audio[i : i + len(clip)] += clip
    amp = _NOISE_AMPS[int(rng.integers(len(_NOISE_AMPS)))]
    end = int((events[-1][0] + phrase_duration(events[-1][1]) + 0.15) * SAMPLE_RATE)
    if amp:
        audio[:end] += (amp * rng.standard_normal(end)).astype(np.float32)
    return Example(audio, events)


def _fits(row, slots: int, what: str, ex: Example):
    if len(row) > slots:
        raise ValueError(
            f"a sampled window's {what} row has {len(row)} tokens, more than its "
            f"{slots} slots (window {ex.text!r}); use shorter phrases"
        )
    return row


def make_batch(rng, n: int, tokenizer, lex, phrases: Sequence[str]):
    """A fresh minibatch of ``n`` windows (JAX ``align_online.py:153-181``,
    the same draws): (examples, audio int16 [n, N_SAMPLES], timestamped
    tokens [n, 64] and mask [n, 63], no-timestamps tokens and mask,
    attention targets [n, 64, 1500] f16, weights [n, 64]). A row longer
    than its 64 slots raises ``ValueError`` where JAX cuts it."""
    exs = [sample_window(rng, lex, phrases) for _ in range(n)]
    audio = np.stack([ex.audio for ex in exs])
    a16 = np.clip(np.round(audio * 32768.0), -32768, 32767).astype(np.int16)
    ts_tok = np.full((n, _T1), tokenizer.eot, np.int64)
    ts_mask = np.zeros((n, _T1 - 1), np.float32)
    nt_tok = np.full((n, _T2), tokenizer.eot, np.int64)
    nt_mask = np.zeros((n, _T2 - 1), np.float32)
    attn_t = np.zeros((n, _T2, 1500), np.float16)
    attn_w = np.zeros((n, _T2), np.float32)
    for i, ex in enumerate(exs):
        s = _fits(target_tokens(tokenizer, ex), _T1, "timestamped", ex)
        ts_tok[i, : len(s)] = s
        ts_mask[i, : len(s) - 1] = 1.0
        r = _fits(notimestamps_row(tokenizer, ex), _T2, "no-timestamps", ex)
        nt_tok[i, : len(r)] = r
        nt_mask[i, : len(r) - 1] = 1.0
        tg, w = attention_targets(tokenizer, ex)
        attn_t[i, : tg.shape[0]] = tg.astype(np.float16)
        attn_w[i, : len(w)] = w
    return exs, a16, ts_tok, ts_mask, nt_tok, nt_mask, attn_t, attn_w


def features(encoder, a16: torch.Tensor, n_mels: int, n_head: int) -> torch.Tensor:
    """The frozen encoder's features of int16 audio, without a gradient
    (JAX's ``stop_gradient``): log-mel, then the encoder through K1."""
    from whisperx_tpu_torch.audio.mel import _log_mel_batch_body
    from whisperx_tpu_torch.models.whisper.model import encoder_forward

    with torch.no_grad():
        mel = _log_mel_batch_body(a16.float() / 32768.0, n_mels)
        return encoder_forward(encoder, mel, n_head)


def loss_compact(dec_small, feats, tsk, tsm, ntk, ntm, at, aw, remap, heads,
                 attn_weight: float = 1.0) -> torch.Tensor:
    """The compact-vocabulary loss of one minibatch's features."""
    ts_logits = run_decoder(dec_small, feats, remap[tsk])
    nt_logits, cqk = run_decoder(dec_small, feats, remap[ntk], heads)
    ce = cross_entropy(ts_logits, remap[tsk][:, 1:], tsm) + 0.5 * cross_entropy(
        nt_logits, remap[ntk][:, 1:], ntm
    )
    return ce + attn_weight * attention_ce(cqk, at, aw)


def loss_full(dec, feats, tsk, tsm, ntk, ntm, at, aw, heads, attn_weight: float = 1.0) -> torch.Tensor:
    """The full-vocabulary loss of one minibatch's features."""
    ts_logits = run_decoder(dec, feats, tsk)
    nt_logits, cqk = run_decoder(dec, feats, ntk, heads)
    ce = cross_entropy(ts_logits, tsk[:, 1:], tsm) + 0.5 * cross_entropy(nt_logits, ntk[:, 1:], ntm)
    return ce + attn_weight * attention_ce(cqk, at, aw)


def active_ids(tokenizer, phrases: Sequence[str]) -> set:
    """Every id an online window can need: the phrases' tokens, the special
    tokens and each timestamp up to the chunk size plus 1 s."""
    text_ids = {t for p in phrases for t in tokenizer.encode(p)}
    specials = {tokenizer.eot, tokenizer.no_timestamps, tokenizer.no_speech, *tokenizer.sot_sequence}
    max_ts = tokenizer.timestamp_begin + int((DEFAULT_CHUNK_SIZE + 1.0) / 0.02)
    return text_ids | specials | set(range(tokenizer.timestamp_begin, max_ts + 1))


def train_micro_aligned_online(
    model_name: str = "test-nano",
    phrases: Sequence[str] = PHRASES,
    steps: int = 3000,
    full_steps: int = 300,
    minibatch: int = 8,
    lr: float = 1.2e-3,
    attn_weight: float = 1.0,
    seed: int = 0,
    log_every: int = 0,
    device: Union[str, torch.device] = "cuda",
):
    """Returns (model f32, dims, report)."""
    from whisperx_tpu_torch.models.whisper import get_dims, load_model, resolve_device
    from whisperx_tpu_torch.train.micro import _lexicon, decoder_params, english_tokenizer
    from whisperx_tpu_torch.train.optim import Adam, warmup_cosine_decay_schedule
    from whisperx_tpu_torch.utils.precision import reference_matmul

    dev = resolve_device(device)
    dims = get_dims(model_name)
    tokenizer = english_tokenizer(dims)
    lex = _lexicon(phrases)
    rng = np.random.default_rng(seed)
    model = load_model(model_name, dtype=torch.float32, device=dev, seed=seed)
    dec = model.decoder
    active_np, remap_np = active_remap(active_ids(tokenizer, phrases))
    active = torch.from_numpy(active_np).to(dev)
    remap = torch.from_numpy(remap_np).to(dev)
    heads = alignment_heads_of(dims)
    ts_begin, nt_id = tokenizer.timestamp_begin, tokenizer.no_timestamps

    def batch(r):
        """A fresh minibatch on the device: (features, rows)."""
        _, a16, *rows = make_batch(r, minibatch, tokenizer, lex, phrases)
        feats = features(model.encoder, torch.from_numpy(a16).to(dev), dims.n_mels, dims.n_audio_head)
        return feats, [torch.from_numpy(x).to(dev) for x in rows]

    body = decoder_params(dec, frozen=())
    tok_emb = dec.tok_emb.requires_grad_(True)
    loss = None

    @torch.no_grad()
    def heldout_metrics(n_groups: int = 6):
        ev_rng = np.random.default_rng(seed + 99_000)
        mm, hit, tot = float("inf"), 0.0, 0.0
        for _ in range(n_groups):
            feats, (tsk, tsm, ntk, _ntm, at, aw) = batch(ev_rng)
            mm = min(mm, float(timestamp_margins(run_decoder(dec, feats, tsk), tsk, tsm, ts_begin, nt_id).min()))
            _, cqk = run_decoder(dec, feats, ntk, heads)
            h, t = attention_hits(cqk, at, aw)
            hit, tot = hit + float(h), tot + float(t)
        return mm, hit / max(tot, 1.0)

    with reference_matmul():
        small = gather_rows(tok_emb, active)
        opt = Adam(
            [small, *body],
            warmup_cosine_decay_schedule(
                init_value=lr / 15, peak_value=lr, warmup_steps=min(60, max(1, steps // 5)),
                decay_steps=steps, end_value=lr / 15,
            ),
        )
        view = compact_decoder(dec, small)
        for i in range(steps):
            feats, rows = batch(rng)
            loss = loss_compact(view, feats, *rows, remap, heads, attn_weight)
            loss.backward()
            opt.step()
            loss = loss.detach()
            if log_every and (i + 1) % log_every == 0:
                print(f"[online] step {i + 1}/{steps} loss {float(loss):.4f}")
        scatter_rows(tok_emb, active, small)

        opt_full = Adam([tok_emb, *body], 5e-4)

        def full_steps_of(n, tag):
            nonlocal loss
            for i in range(n):
                feats, rows = batch(rng)
                loss = loss_full(dec, feats, *rows, heads, attn_weight)
                loss.backward()
                opt_full.step()
                loss = loss.detach()
                if log_every and (i + 1) % log_every == 0:
                    print(f"[{tag}] step {i + 1}/{n} loss {float(loss):.4f}")

        full_steps_of(full_steps, "online full")
        min_margin, attn_hit = heldout_metrics()
        extra_rounds = 0
        while (min_margin < 0.3 or attn_hit < 0.97) and extra_rounds < 6:
            extra_rounds += 1
            full_steps_of(250, "online certify")  # the same optimizer state
            min_margin, attn_hit = heldout_metrics()
            if log_every:
                print(f"[online certify] round {extra_rounds}: HELD-OUT margin {min_margin:.2f} "
                      f"attn_hit {attn_hit:.3f} loss {float(loss):.4f}")

    for p in model.parameters():
        p.requires_grad_(False)
    report = {
        "steps": steps,
        "full_steps": full_steps,
        "final_loss": round(float(loss), 4),
        "heldout_min_margin": round(min_margin, 3),
        "heldout_attn_hit": round(attn_hit, 4),
        "min_margin": round(min_margin, 3),
        "attn_hit": round(attn_hit, 4),
        "certify_rounds": extra_rounds,
        "alignment_heads": [list(x) for x in heads],
        "online": True,
    }
    return model, dims, report


def online_checkpoint_cached(
    cache_root: Optional[str] = None, device: Union[str, torch.device] = "cuda"
) -> Tuple[str, dict]:
    """Train once, then reuse, keyed on this module's source and those of
    the modules that make its targets."""
    from whisperx_tpu_torch.train import align_micro as _am
    from whisperx_tpu_torch.train import micro as _micro
    from whisperx_tpu_torch.train.micro import cache_dir, cached_report, write_report

    path = cache_dir(cache_root, "micro_online_ckpt", [__file__, _am.__file__, _micro.__file__], device)
    report = cached_report(path)
    if report is not None:
        return path, report
    model, dims, report = train_micro_aligned_online(device=device)
    save_micro_checkpoint(path, model, dims, report, alignment_heads=report["alignment_heads"])
    write_report(path, report)
    return path, report

"""Trainable micro wav2vec2-CTC: forced alignment with learned weights.

Counterpart of ``whisperx_tpu/train/ctc_micro.py``. Every character of the
CTC vocabulary is rendered as a pure tone at its own frequency and word
separators as silence, so a clip's waveform encodes its character sequence
and each character's onset. A small wav2vec2 (``micro_ctc_config``) is
trained with the CTC objective on freshly sampled minibatches, so the only
fit is a per-frame tone classifier; the certificate is greedy exactness on
a held-out set the optimizer never saw. The saved checkpoint loads through
``alignment.load_align_model(model_dir=...)``.

The corpus functions are numpy and give the JAX package's arrays bit for
bit. ``optax.ctc_loss`` becomes ``F.ctc_loss`` (no Pallas kernel: the
library call stays), lengths taken from the paddings; training runs on
``device`` (default ``"cuda"``) in f32 with TF32 off in the products and in
cuDNN's convolutions, forward and backward.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from whisperx_tpu_torch.audio.constants import SAMPLE_RATE

# ---------------------------------------------------------------------------
# Char-tone corpus
# ---------------------------------------------------------------------------

CHAR_SECONDS = 0.10
CHAR_GAP_SECONDS = 0.02
WORD_GAP_SECONDS = 0.16

# the micro-Whisper corpus's lexicon, so the two can share recordings
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

MB = 16  # rows of an online minibatch
N_SAMP = 76800  # 4.8 s rows
L_MAX = 40  # label slots a row


def char_lexicon(vocab: Dict[str, int]) -> Dict[str, float]:
    """char -> tone frequency (Hz) for every single-char label, log-spaced."""
    chars = sorted(k for k in vocab if len(k) == 1 and k != "|")
    lo, hi = 260.0, 4200.0
    n = max(len(chars), 2)
    return {c: lo * (hi / lo) ** (i / (n - 1)) for i, c in enumerate(chars)}


def clean_words(text: str, vocab: Dict[str, int]) -> List[str]:
    """Lowercased words keeping only chars the CTC vocabulary knows."""
    words = []
    for w in text.split():
        kept = "".join(c for c in w.lower() if c in vocab and c != "|")
        if kept:
            words.append(kept)
    return words


def render_chars(
    text: str,
    vocab: Dict[str, int],
    lexicon: Optional[Dict[str, float]] = None,
    lead_s: float = 0.0,
    sr: int = SAMPLE_RATE,
    augment_rng=None,
) -> Tuple[np.ndarray, List[Tuple[str, float]]]:
    """Render a phrase char by char. Returns (audio, [(word, onset_s)]).

    Each in-vocabulary character is a CHAR_SECONDS tone at its lexicon
    frequency; characters inside a word are CHAR_GAP_SECONDS apart, words
    WORD_GAP_SECONDS. A word's onset is its first character's. With
    ``augment_rng`` (training), each tone's phase and amplitude are drawn:
    the convolutional front end reads raw samples, and a model trained on
    fixed phases keys on them."""
    if lexicon is None:
        lexicon = char_lexicon(vocab)
    tone_n = int(CHAR_SECONDS * sr)
    ramp = np.minimum(np.arange(tone_n) / (0.008 * sr), 1.0)
    ramp = np.minimum(ramp, ramp[::-1]).astype(np.float32)
    parts = [np.zeros(int(lead_s * sr), np.float32)]
    onsets: List[Tuple[str, float]] = []
    t = lead_s
    for wi, word in enumerate(clean_words(text, vocab)):
        if wi > 0:
            parts.append(np.zeros(int(WORD_GAP_SECONDS * sr), np.float32))
            t += WORD_GAP_SECONDS
        onsets.append((word, t))
        for ci, ch in enumerate(word):
            if ci > 0:
                parts.append(np.zeros(int(CHAR_GAP_SECONDS * sr), np.float32))
                t += CHAR_GAP_SECONDS
            tt = np.arange(tone_n) / sr
            phase = 0.0
            amp = 0.4
            if augment_rng is not None:
                phase = 2 * math.pi * float(augment_rng.random())
                amp = 0.25 + 0.3 * float(augment_rng.random())
            parts.append(
                (amp * np.sin(2 * math.pi * lexicon[ch] * tt + phase)).astype(np.float32)
                * ramp
            )
            t += CHAR_SECONDS
    return np.concatenate(parts), onsets


def labels_for(text: str, vocab: Dict[str, int]) -> List[int]:
    """CTC label ids: word chars joined by the '|' separator label."""
    return [vocab[c] for c in "|".join(clean_words(text, vocab))]


def default_vocab() -> Dict[str, int]:
    from whisperx_tpu_torch.alignment.aligner import DEFAULT_EN_VOCAB

    return dict(DEFAULT_EN_VOCAB)


def micro_ctc_config():
    """TEST_CONFIG scale with the JAX trainer's three robustness changes,
    each a measured failure of the unmodified config on this corpus: a
    per-frame layer-norm feature extractor (group norm over time made the
    emissions depend on the padding), a local positional convolution
    (k 16: a 128-wide one leaks absolute position at these lengths), and a
    25 ms first convolution (k 400, stride 320: a learnable filter bank;
    the deep narrow stack memorised waveforms). The frame rate stays
    ~50 fps (stride product 320)."""
    from whisperx_tpu_torch.models.wav2vec2 import TEST_CONFIG

    return dataclasses.replace(
        TEST_CONFIG,
        conv_dim=(64, 64),
        conv_kernel=(400, 3),
        conv_stride=(320, 1),
        feat_extract_norm="layer",
        num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=8,
    )


def build_ctc_corpus(
    phrases: Sequence[str] = PHRASES,
    variants: int = 12,
    seed: int = 0,
):
    """(waves, labels, metas): random character strings (so context is
    useless and only a per-frame tone classifier fits them) plus the
    canonical phrases, over mixed noise floors including clean ones."""
    vocab = default_vocab()
    lex = char_lexicon(vocab)
    rng = np.random.default_rng(seed)
    noise_amps = [0.0, 0.01, 0.005, 0.02, 0.0, 0.01, 0.002, 0.015]
    chars = sorted(lex)
    waves, labels, metas = [], [], []

    def _add(text, v, augment):
        lead = 0.6 * float(rng.random())
        audio, onsets = render_chars(
            text, vocab, lex, lead_s=lead, augment_rng=rng if augment else None,
        )
        amp = noise_amps[v % len(noise_amps)]
        if amp:
            audio = audio + (amp * rng.standard_normal(len(audio))).astype(np.float32)
        waves.append(audio)
        labels.append(labels_for(text, vocab))
        metas.append(onsets)

    n_random = variants * len(phrases)
    for v in range(n_random):
        words = []
        for _ in range(int(rng.integers(2, 5))):
            n = int(rng.integers(2, 8))
            words.append("".join(chars[int(i)] for i in rng.integers(0, len(chars), n)))
        _add(" " + " ".join(words), v, augment=v % 3 != 0)
    for v, text in enumerate(phrases):
        _add(text, v, augment=False)
    return waves, labels, metas


def sample_rows(rng, n: int, cfg, vocab: Dict[str, int], phrases: Sequence[str] = PHRASES,
                canonical_frac: float = 0.25):
    """A fresh minibatch (JAX ``ctc_micro.py:275-317``, the same numpy draws
    in the same order): (batch [n, N_SAMP], logit_pad [n, frames] 1 on
    padded frames, lab [n, L_MAX], lab_pad [n, L_MAX] 1 on empty slots,
    frame_n [n], labels)."""
    from whisperx_tpu_torch.models.wav2vec2.model import output_lengths

    waves, labels = [], []
    chars = sorted(char_lexicon(vocab))
    lex = char_lexicon(vocab)
    noise_amps = [0.0, 0.01, 0.005, 0.02]
    for _ in range(n):
        if rng.random() < canonical_frac:
            text = phrases[int(rng.integers(len(phrases)))]
        else:
            words = [
                "".join(
                    chars[int(c)]
                    for c in rng.integers(0, len(chars), int(rng.integers(2, 8)))
                )
                for _ in range(int(rng.integers(2, 5)))
            ]
            text = " " + " ".join(words)
        lead = 0.6 * float(rng.random())
        audio, _ = render_chars(
            text, vocab, lex, lead_s=lead,
            augment_rng=rng if rng.random() < 0.67 else None,
        )
        amp = noise_amps[int(rng.integers(len(noise_amps)))]
        if amp:
            audio = audio + (amp * rng.standard_normal(len(audio))).astype(np.float32)
        waves.append(audio[:N_SAMP])
        labels.append(labels_for(text, vocab)[:L_MAX])
    batch = np.zeros((n, N_SAMP), np.float32)
    frame_n = np.zeros(n, np.int32)
    lab = np.zeros((n, L_MAX), np.int32)
    lab_pad = np.ones((n, L_MAX), np.float32)
    for i, (w, x) in enumerate(zip(waves, labels)):
        batch[i, : len(w)] = w
        frame_n[i] = output_lengths(cfg, len(w))
        lab[i, : len(x)] = x
        lab_pad[i, : len(x)] = 0.0
    t_frames = output_lengths(cfg, N_SAMP)
    logit_pad = (np.arange(t_frames)[None, :] >= frame_n[:, None]).astype(np.float32)
    return batch, logit_pad, lab, lab_pad, frame_n, labels


def loss_fn(model, batch, logit_pad, lab, lab_pad, blank_id: int = 0) -> torch.Tensor:
    """Mean CTC negative log-likelihood over the rows (JAX
    ``ctc_micro.py:319-324``, ``optax.ctc_loss(...).mean()``): the model's
    log-probs [B, T, C] through ``F.ctc_loss`` with each row's frame and
    label counts read from the paddings."""
    from whisperx_tpu_torch.models.wav2vec2.model import forward

    logp = forward(model, batch)
    in_len = (1 - logit_pad).sum(1).long()
    tgt_len = (1 - lab_pad).sum(1).long()
    per = F.ctc_loss(
        logp.transpose(0, 1), lab.long(), in_len, tgt_len, blank=blank_id, reduction="none"
    )
    return per.mean()


def greedy_exact(model, batch, frames, labels, blank_id: int = 0) -> int:
    """Rows whose greedy CTC decode (collapse repeats, drop blanks) equals
    their labels."""
    from whisperx_tpu_torch.models.wav2vec2.model import forward

    with torch.no_grad():
        best = forward(model, batch).argmax(-1).cpu().numpy()
    exact = 0
    for i in range(len(labels)):
        seq, prev = [], -1
        for t in range(int(frames[i])):
            c = int(best[i, t])
            if c != prev and c != blank_id:
                seq.append(c)
            prev = c
        exact += int(seq == list(labels[i]))
    return exact


def train_ctc_micro(
    phrases: Sequence[str] = PHRASES,
    steps: int = 2200,
    lr: float = 2.5e-3,
    variants: int = 12,
    seed: int = 0,
    log_every: int = 0,
    device: Union[str, torch.device] = "cuda",
):
    """Train the micro CTC model online. Returns (model f32, config, vocab,
    report). ``variants`` is unused, as in JAX's ``train_ctc_micro``
    (``whisperx_tpu/train/ctc_micro.py:237``), which samples its rows online
    too: it stays so that both trainers take the same arguments
    (``build_ctc_corpus`` uses it)."""
    from whisperx_tpu_torch.models.wav2vec2 import init_params
    from whisperx_tpu_torch.models.whisper import resolve_device
    from whisperx_tpu_torch.train.optim import Adam, warmup_cosine_decay_schedule
    from whisperx_tpu_torch.utils.precision import no_tf32_cudnn, reference_matmul

    dev = resolve_device(device)
    vocab = default_vocab()
    cfg = micro_ctc_config()
    blank_id = vocab["<pad>"]
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    params = [p.requires_grad_(True) for p in model.parameters()]

    def to_dev(*arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    rng = np.random.default_rng(seed)

    def run(opt, n, tag):
        loss = None
        for i in range(n):
            batch, logit_pad, lab, lab_pad, _, _ = sample_rows(rng, MB, cfg, vocab, phrases)
            loss = loss_fn(model, *to_dev(batch, logit_pad, lab, lab_pad), blank_id=blank_id)
            loss.backward()
            opt.step()
            loss = loss.detach()
            if log_every and (i + 1) % log_every == 0:
                print(f"[{tag}] step {i + 1}/{n} loss {float(loss):.4f}")
        return loss

    # the held-out certificate: a fresh rng stream the optimizer never
    # consumed, canonical phrases included
    eval_rng = np.random.default_rng(seed + 10_000)
    ev_batch, _, _, _, ev_frames, ev_labels = sample_rows(
        eval_rng, 48, cfg, vocab, phrases, canonical_frac=0.3
    )
    ev_batch = torch.from_numpy(ev_batch).to(dev)

    with reference_matmul(), no_tf32_cudnn():
        schedule = warmup_cosine_decay_schedule(
            init_value=lr / 10, peak_value=lr, warmup_steps=50,
            decay_steps=steps, end_value=lr / 20,
        )
        loss = run(Adam(params, schedule), steps, "ctc")
        exact = greedy_exact(model, ev_batch, ev_frames, ev_labels, blank_id)
        # >= 90% held-out exactness at low loss; the residual misses are
        # greedy-CTC edge cases, benign for forced alignment
        target_exact = int(np.ceil(0.9 * len(ev_labels)))
        extra_rounds = 0
        opt_extra = None
        while (exact < target_exact or float(loss) > 0.1) and extra_rounds < 5:
            extra_rounds += 1
            if opt_extra is None:  # one optimizer state across the rounds
                opt_extra = Adam(params, lr / 5)
            loss = run(opt_extra, 300, "ctc extra")
            exact = greedy_exact(model, ev_batch, ev_frames, ev_labels, blank_id)
            if log_every:
                print(
                    f"[ctc certify] round {extra_rounds}: HELD-OUT {exact}/{len(ev_labels)} "
                    f"exact, loss {float(loss):.4f}"
                )

    for p in params:
        p.requires_grad_(False)
    report = {
        "final_loss": round(float(loss), 4),
        "steps": steps,
        "online_minibatch": MB,
        "heldout_exact": exact,
        "heldout_total": len(ev_labels),
        "greedy_exact": exact,
        "greedy_total": len(ev_labels),
        "certify_rounds": extra_rounds,
    }
    return model, cfg, vocab, report


def save_ctc_checkpoint(path: str, model, cfg, vocab, report=None) -> str:
    """Write the converted-checkpoint layout ``load_align_model`` reads:
    config.json holds the wav2vec2 config under "config" and the CTC
    dictionary."""
    from whisperx_tpu_torch.convert.checkpoint import save_checkpoint

    save_checkpoint(
        path,
        model,
        {
            "name": "micro-ctc",
            "family": "wav2vec2",
            "config": dataclasses.asdict(cfg),
            "dictionary": vocab,
            "micro_train": report or {},
        },
    )
    return path


def ctc_checkpoint_cached(
    cache_root: Optional[str] = None, language: str = "en",
    device: Union[str, torch.device] = "cuda",
) -> Tuple[str, dict]:
    """Train once, then reuse. Returns (align_model_dir, report): pass
    ``model_dir=align_model_dir`` to ``load_align_model`` (the checkpoint
    is ``<dir>/<language>``)."""
    import os

    from whisperx_tpu_torch.train.micro import cache_dir, cached_report, write_report

    base = cache_dir(cache_root, "micro_ctc", [__file__], device)
    path = os.path.join(base, language)
    report = cached_report(path)
    if report is not None:
        return base, report
    model, cfg, vocab, report = train_ctc_micro(device=device)
    save_ctc_checkpoint(path, model, cfg, vocab, report)
    write_report(path, report)
    return base, report

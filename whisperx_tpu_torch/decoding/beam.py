"""Batched beam-search decoding for Whisper.

Counterpart of ``whisperx_tpu/decoding/beam.py``, with upstream whisper's
BeamSearchDecoder semantics:

  state per (batch, beam): token buffer, cumulative logprob, filter state,
  self-attention cache rows. Each step: logits → filter chain → the 2K best
  of the K·V scores per batch row; EOT candidates ranked above the K-th
  surviving continuation are BANKED (``max_candidates = round(K·patience)``
  slots per row, best-first; EOTs below that cut are dropped) and the K best
  non-EOT candidates continue as the live beams, their self-attention cache
  rows gathered along the batch axis. The search ends when every row's bank
  is full or the sample budget is spent. ``rank_beams`` picks the final
  sequence with the length penalty ((5+L)/6)^α, or score/L when α is None.

As in the JAX package, candidates come from the global top-2K of the merged
K·V scores, and the cross-attention K/V stay untiled ([B, 1500, H, Dh]):
``decoder_forward(..., beam_groups=K)`` folds the beams into the query axis.

Differences of form, not of result: the JAX package runs the loop as one
``lax.while_loop``; here the host keeps the loop and reads the bank counts
back once per step, and on one CUDA device each step is one replay of a
captured CUDA graph (``step_graph.py``) over static buffers
(``_BeamBuffers``; the banks' ``n_sampled`` is a device scalar), as in the
port's greedy loop, each data-parallel replica's too; the CPU, and
tensor-parallel decodes, run the same body uncaptured. The self-attention
cache is reordered in place: each layer's tensor is overwritten with its
``index_select`` (two copies of the cache per step). The 2K candidates are chosen with ties broken toward the
lower index, the order of ``jax.lax.top_k`` (``torch.topk`` promises no
order among ties). The decode's parts are timed as the greedy loop's are
(``decode.encoder``, ``decode.prefill``, ``decode.steps``).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from whisperx_tpu_torch.decoding import filters as F
from whisperx_tpu_torch.decoding.decode import (
    _apply_filters,
    _cache_len,
    _cross_kv,
    _filter_masks,
    _reset_state,
    _state_buffers,
    _step_config,
)
from whisperx_tpu_torch.decoding.step_graph import load_cache, step_runner
from whisperx_tpu_torch.models.whisper.model import (
    HeadShards,
    KVCache,
    decoder_forward,
    encoder_forward,
    new_self_cache,
)
from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER as _tracker

NEG_INF = float("-inf")


def _bank_writes(
    is_eot: torch.Tensor,  # [B, M] EOT flag per descending-score candidate
    bank_count: torch.Tensor,  # [B] finished sequences banked so far
    k: int,  # beam width
    c: int,  # bank capacity (round(K·patience))
):
    """Which candidates get banked this step, and into which slot.

    Upstream BeamSearchDecoder walks the candidates in descending score and
    stops once beam_size continuations are saved, so an EOT ranked below the
    K-th surviving continuation is never banked. Returns (write [B, M] mask,
    slot [B, M]: dropped writes go to the dummy slot ``c``)."""
    not_eot = (~is_eot).long()
    non_eot_before = torch.cumsum(not_eot, dim=-1) - not_eot  # exclusive
    bankable = is_eot & (non_eot_before < k)
    eot_rank = torch.cumsum(bankable.long(), dim=-1) - 1  # rank among bankable
    slot = bank_count[:, None] + eot_rank
    write = bankable & (slot < c)
    return write, torch.where(write, slot, torch.full_like(slot, c))


def _gather_beams_(
    tensors: Sequence[torch.Tensor], src_beam: torch.Tensor, b: int, k: int
) -> None:
    """Reorder, in place, tensors whose leading (flattened) dim is B·K by
    per-row source beams [B, K]: each is overwritten with its
    ``index_select`` (a ``HeadShards`` shard by shard). Beam-invariant state
    (the cross-KV) must not be passed: it is [B, ...] and gathering it would
    copy gigabytes per step."""
    flat_idx = (
        torch.arange(b, device=src_beam.device)[:, None] * k + src_beam
    ).reshape(-1)
    for x in tensors:
        for part in x if isinstance(x, HeadShards) else (x,):
            part.copy_(part.index_select(0, flat_idx.to(part.device)))


def _top_candidates(cand: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``m`` best entries of each row of ``cand`` [B, N], best first,
    ties toward the lower index (``jax.lax.top_k``'s order). Returns
    (scores [B, m], indices [B, m])."""
    kth = torch.topk(cand, m, dim=-1).values[:, -1:]  # the m-th best score
    above = cand > kth
    tie = cand == kth
    room = m - above.sum(dim=-1, keepdim=True)
    keep = above | (tie & (torch.cumsum(tie, dim=-1) <= room))
    # exactly m entries per row are kept; weighting them by n - index (all
    # distinct, > 0) picks them in ascending index order without a host sync
    n = cand.shape[1]
    rank = keep * (n - torch.arange(n, device=cand.device))
    idx = torch.topk(rank, m, dim=-1).indices  # ascending per row
    vals = cand.gather(1, idx)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    return vals.gather(1, order), idx.gather(1, order)


@dataclass
class _BeamBuffers:
    """What a beam step reads and writes, in place: the static buffers of a
    captured step (``step_graph``). Rows are B·K beams; the banks are per
    batch row, with a dummy slot C that absorbs the dropped writes."""

    cache: KVCache
    state: F.FilterState  # of [B·K] tensors
    last_logits: torch.Tensor  # [B·K, V] f32
    tokens: torch.Tensor  # [B·K, sample_len] int64
    scores: torch.Tensor  # [B·K] f32: each beam's sum of log-probabilities
    offset: torch.Tensor  # [B·K] int64: the next token's position
    bank_tokens: torch.Tensor  # [B, C + 1, sample_len] int64
    bank_scores: torch.Tensor  # [B, C + 1] f32
    bank_lengths: torch.Tensor  # [B, C + 1] int64
    bank_count: torch.Tensor  # [B] int64
    n_sampled: torch.Tensor  # [] int64
    suppress_mask: torch.Tensor  # [V] bool
    blank_mask: torch.Tensor  # [V] bool: the blank tokens and EOT

    @classmethod
    def allocate(cls, dec, cross_k, cross_v, b: int, k: int, c: int, cache_len: int, cfg):
        device = dec.tok_emb.device
        bk = b * k
        i64 = dict(dtype=torch.int64, device=device)
        suppress_mask, blank_mask = _filter_masks(cfg, dec.tok_emb.shape[0], device)
        return cls(
            cache=KVCache(*new_self_cache(dec, bk, cache_len, cfg.n_head), list(cross_k), list(cross_v)),
            state=_state_buffers(bk, device),
            last_logits=torch.empty((bk, dec.tok_emb.shape[0]), dtype=torch.float32, device=device),
            tokens=torch.empty((bk, cfg.sample_len), **i64),
            scores=torch.empty((bk,), dtype=torch.float32, device=device),
            offset=torch.empty((bk,), **i64),
            bank_tokens=torch.empty((b, c + 1, cfg.sample_len), **i64),
            bank_scores=torch.empty((b, c + 1), dtype=torch.float32, device=device),
            bank_lengths=torch.empty((b, c + 1), **i64),
            bank_count=torch.empty((b,), **i64),
            n_sampled=torch.empty((), **i64),
            suppress_mask=suppress_mask,
            blank_mask=blank_mask,
        )

    def start(self, cross_k, cross_v, init_bk: torch.Tensor, k: int, eot: int) -> None:
        load_cache(self.cache, cross_k, cross_v)
        _reset_state(self.state, init_bk)
        self.tokens.fill_(eot)
        # only beam 0 is live at first (identical prefixes would collapse)
        rows = torch.arange(self.scores.shape[0], device=self.scores.device)
        self.scores.copy_(torch.where(rows % k == 0, 0.0, NEG_INF))
        self.offset.fill_(init_bk.shape[1])
        self.bank_tokens.fill_(eot)
        self.bank_scores.fill_(NEG_INF)
        self.bank_lengths.zero_()
        self.bank_count.zero_()
        self.n_sampled.zero_()


def _beam_step(dec, s: _BeamBuffers, cfg, k: int, c: int) -> None:
    """One beam step over ``s``, in place: the 2K best of the K·V scores per
    batch row, EOT candidates banked, the K best others continuing with
    their tokens, filter state and self-KV rows gathered, and the decoder
    run on the new tokens. Reads no value back to the host (a captured
    step's body)."""
    b = s.bank_count.shape[0]
    logits = _apply_filters(s.last_logits, s.state, cfg, s.suppress_mask, s.blank_mask)  # [B·K, V]
    logprobs = torch.log_softmax(logits, dim=-1)
    vocab = logprobs.shape[-1]
    cand = (s.scores[:, None] + logprobs).reshape(b, k * vocab)
    # at most one EOT per beam, so the 2K best hold ≥ K non-EOT
    top_scores, top_idx = _top_candidates(cand, 2 * k)  # [B, 2K], best first
    src_beam = top_idx // vocab
    token = top_idx % vocab
    is_eot = token == cfg.eot

    # bank the EOT candidates (finished sequences), best first
    write, slot_c = _bank_writes(is_eot, s.bank_count, k, c)
    b_idx = torch.arange(b, device=s.bank_count.device)[:, None]
    # the source beam's sequence at EOT time: [B, 2K, L]
    s.bank_tokens[b_idx, slot_c] = s.tokens.reshape(b, k, -1)[b_idx, src_beam]
    s.bank_scores[b_idx, slot_c] = torch.where(write, top_scores, NEG_INF)
    s.bank_lengths[b_idx, slot_c] = torch.where(write, s.n_sampled, 0)
    s.bank_count.add_(write.sum(dim=-1))

    # the K best non-EOT candidates continue as the live beams; a stable
    # sort on the EOT flag keeps score order within each class
    sel = torch.argsort(is_eot.int(), dim=-1, stable=True)[:, :k]
    token_flat = token.gather(1, sel).reshape(-1)
    _gather_beams_(
        [s.tokens, *s.state[:4], *s.cache.self_k, *s.cache.self_v],
        src_beam.gather(1, sel), b, k,
    )
    s.scores.copy_(top_scores.gather(1, sel).reshape(-1))
    s.tokens.scatter_(1, s.state.step[:, None], token_flat[:, None])
    F.advance_filter_state_(s.state, token_flat, cfg.timestamp_begin)
    logits = decoder_forward(
        dec, token_flat[:, None], s.cache, s.offset, cfg.n_head, beam_groups=k
    )
    s.last_logits.copy_(logits[:, -1])
    s.offset.add_(1)
    s.n_sampled.add_(1)


@torch.inference_mode()
def _beam_decode(
    model,
    audio_in: torch.Tensor,
    initial_tokens: torch.Tensor,  # [B, n_init]
    cfg,
    beam_size: int,
    max_candidates: int,
    audio_is_features: bool,
    capture: bool = True,
):
    """Returns (bank_tokens [B, C, L], bank_lengths [B, C], bank_scores
    [B, C], bank_count [B], live_tokens [B, K, L], live_scores [B, K],
    n_sampled, no_speech_probs [B], audio_features) with C =
    ``max_candidates``. ``capture`` as in ``decode._decode``."""
    b = audio_in.shape[0]
    k = beam_size
    c = max_candidates or k  # finished-sequence bank slots per batch row
    n_init = initial_tokens.shape[1]

    device = audio_in.device
    if audio_is_features:
        audio_features = audio_in
    else:
        with _tracker.span("decode.encoder", device=device):
            audio_features = encoder_forward(model.encoder, audio_in, cfg.n_head_audio)
    dec = model.decoder
    cache_len = _cache_len(cfg, n_init)
    shape = ("beam", b, k, c, cache_len, audio_features.shape[1], _step_config(cfg))
    init_bk = initial_tokens.repeat_interleave(k, dim=0)  # same prefix everywhere
    with contextlib.ExitStack() as runner:
        with _tracker.span("decode.prefill", device=device):
            cross_k, cross_v = _cross_kv(model, audio_features, cfg)
            make = lambda: _BeamBuffers.allocate(dec, cross_k, cross_v, b, k, c, cache_len, cfg)
            s, run = runner.enter_context(step_runner((model,), capture, shape, make))
            s.start(cross_k, cross_v, init_bk, k, cfg.eot)
            del cross_k, cross_v
            # the prefill: one eager pass at offset 0
            logits = decoder_forward(dec, init_bk, s.cache, 0, cfg.n_head, beam_groups=k)
            probs_at_sot = torch.softmax(logits[::k, cfg.sot_index].float(), dim=-1)
            no_speech_probs = probs_at_sot[:, cfg.no_speech_token]
            s.last_logits.copy_(logits[:, -1])  # [B·K, V]
            del logits

        n_sampled = 0
        with _tracker.span("decode.steps", device=device):
            # one host read per step: the loop stops once every row's bank is full
            while n_sampled < cfg.sample_len and not bool((s.bank_count >= c).all()):
                run(lambda: _beam_step(dec, s, cfg, k, c))
                n_sampled += 1
        out = (
            s.bank_tokens[:, :c].clone(),
            s.bank_lengths[:, :c].clone(),
            s.bank_scores[:, :c].clone(),
            s.bank_count.clamp(max=c),
            s.tokens.reshape(b, k, -1).clone(),
            s.scores.reshape(b, k).clone(),
        )
    return (*out, n_sampled, no_speech_probs, audio_features)


def rank_beams(
    tokens: np.ndarray,  # [K, L]
    lengths: np.ndarray,  # [K]
    scores: np.ndarray,  # [K]
    length_penalty,
) -> Tuple[int, float]:
    """Pick the best beam; returns (beam index, avg_logprob-style score)."""
    penalties = np.empty(len(scores))
    for i, (ln, sc) in enumerate(zip(lengths, scores)):
        ln = max(int(ln), 1)
        if length_penalty is None:
            penalties[i] = sc / ln
        else:
            penalties[i] = sc / (((5.0 + ln) / 6.0) ** length_penalty)
    best = int(np.argmax(penalties))
    return best, float(scores[best] / (int(lengths[best]) + 1))

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
``lax.while_loop``; here it is a Python loop that reads the bank counts back
once per step, like the port's greedy loop. The self-attention cache is
reordered by replacing each layer's tensor in the cache with its
``index_select`` (one copy of the cache per step). The 2K candidates are
chosen with ties broken toward the lower index, the order of
``jax.lax.top_k`` (``torch.topk`` promises no order among ties).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from whisperx_tpu_torch.decoding import filters as F
from whisperx_tpu_torch.models.whisper.model import (
    KVCache,
    decoder_forward,
    encoder_forward,
    precompute_cross_kv,
    quantize_kv,
)

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


def _gather_beams(
    tensors: Sequence[torch.Tensor], src_beam: torch.Tensor, b: int, k: int
) -> list:
    """Reorder tensors whose leading (flattened) dim is B·K by per-row source
    beams [B, K]. Beam-invariant state (the cross-KV) must not be passed: it
    is [B, ...] and gathering it would copy gigabytes per step."""
    flat_idx = (
        torch.arange(b, device=src_beam.device)[:, None] * k + src_beam
    ).reshape(-1)
    return [x.index_select(0, flat_idx) for x in tensors]


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


@torch.inference_mode()
def _beam_decode(
    model,
    audio_in: torch.Tensor,
    initial_tokens: torch.Tensor,  # [B, n_init]
    cfg,
    beam_size: int,
    max_candidates: int,
    audio_is_features: bool,
):
    """Returns (bank_tokens [B, C, L], bank_lengths [B, C], bank_scores
    [B, C], bank_count [B], live_tokens [B, K, L], live_scores [B, K],
    n_sampled, no_speech_probs [B], audio_features) with C =
    ``max_candidates``."""
    from whisperx_tpu_torch.decoding.decode import _apply_filters, init_kv_cache_like

    b = audio_in.shape[0]
    k = beam_size
    bk = b * k
    n_init = initial_tokens.shape[1]
    device = audio_in.device

    if audio_is_features:
        audio_features = audio_in
    else:
        audio_features = encoder_forward(model.encoder, audio_in, cfg.n_head_audio)
    cross_k, cross_v = precompute_cross_kv(model.decoder, audio_features, cfg.n_head)
    if cfg.kv_quant:
        cross_k = [quantize_kv(x) for x in cross_k]
        cross_v = [quantize_kv(x) for x in cross_v]
    self_k, self_v = init_kv_cache_like(model, bk, cfg, n_init=n_init)
    cache = KVCache(self_k, self_v, cross_k, cross_v)

    init_bk = initial_tokens.repeat_interleave(k, dim=0)  # same prefix everywhere
    logits = decoder_forward(
        model.decoder, init_bk, cache, 0, cfg.n_head, beam_groups=k
    )
    probs_at_sot = torch.softmax(logits[::k, cfg.sot_index].float(), dim=-1)
    no_speech_probs = probs_at_sot[:, cfg.no_speech_token]
    last_logits = logits[:, -1]  # [B·K, V]

    state = F.init_filter_state(init_bk)
    tokens_buf = torch.full((bk, cfg.sample_len), cfg.eot, dtype=torch.int64, device=device)
    # only beam 0 is live at first (identical prefixes would collapse)
    scores = torch.where(
        torch.arange(bk, device=device) % k == 0, 0.0, NEG_INF
    ).float()

    c = max_candidates or k  # finished-sequence bank slots per batch row
    # +1 dummy slot absorbs the dropped writes
    bank_tokens = torch.full(
        (b, c + 1, cfg.sample_len), cfg.eot, dtype=torch.int64, device=device
    )
    bank_scores = torch.full((b, c + 1), NEG_INF, dtype=torch.float32, device=device)
    bank_lengths = torch.zeros((b, c + 1), dtype=torch.int64, device=device)
    bank_count = torch.zeros((b,), dtype=torch.int64, device=device)

    vocab = last_logits.shape[-1]
    m = 2 * k  # at most one EOT per beam, so the 2K best hold ≥ K non-EOT
    b_idx = torch.arange(b, device=device)[:, None]
    n_layer = len(cache.self_k)
    n_sampled = 0
    # one host read per step: the loop stops once every row's bank is full
    while n_sampled < cfg.sample_len and not bool((bank_count >= c).all()):
        logits = _apply_filters(last_logits, state, cfg)  # [B·K, V]
        logprobs = torch.log_softmax(logits, dim=-1)
        cand = (scores[:, None] + logprobs).reshape(b, k * vocab)
        top_scores, top_idx = _top_candidates(cand, m)  # [B, M], best first
        src_beam = top_idx // vocab
        token = top_idx % vocab
        is_eot = token == cfg.eot

        # bank the EOT candidates (finished sequences), best first
        write, slot_c = _bank_writes(is_eot, bank_count, k, c)
        # the source beam's sequence at EOT time: [B, M, L]
        bank_tokens[b_idx, slot_c] = tokens_buf.reshape(b, k, -1)[b_idx, src_beam]
        bank_scores[b_idx, slot_c] = torch.where(write, top_scores, NEG_INF)
        bank_lengths[b_idx, slot_c] = torch.where(write, n_sampled, 0)
        bank_count = bank_count + write.sum(dim=-1)

        # the K best non-EOT candidates continue as the live beams; a stable
        # sort on the EOT flag keeps score order within each class
        order = torch.argsort(is_eot.int(), dim=-1, stable=True)
        sel = order[:, :k]
        new_scores = top_scores.gather(1, sel)
        new_src = src_beam.gather(1, sel)
        new_tok = token.gather(1, sel)

        gathered = _gather_beams(
            [tokens_buf, *state[:4], *cache.self_k, *cache.self_v], new_src, b, k
        )
        tokens_buf = gathered[0]
        state = F.FilterState(*gathered[1:5], step=state.step)
        cache.self_k[:] = gathered[5 : 5 + n_layer]
        cache.self_v[:] = gathered[5 + n_layer :]
        del gathered

        token_flat = new_tok.reshape(-1)
        scores = new_scores.reshape(-1)
        tokens_buf[:, n_sampled] = token_flat
        state = F.update_filter_state(state, token_flat, cfg.timestamp_begin)
        last_logits = decoder_forward(
            model.decoder, token_flat[:, None], cache, n_init + n_sampled,
            cfg.n_head, beam_groups=k,
        )[:, -1]
        n_sampled += 1

    return (
        bank_tokens[:, :c],
        bank_lengths[:, :c],
        bank_scores[:, :c],
        bank_count.clamp(max=c),
        tokens_buf.reshape(b, k, -1),
        scores.reshape(b, k),
        n_sampled,
        no_speech_probs,
        audio_features,
    )


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

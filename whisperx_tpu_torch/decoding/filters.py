"""Batched logit filters for Whisper decoding.

Counterpart of ``whisperx_tpu/decoding/filters.py``: SuppressBlank /
SuppressTokens / ApplyTimestampRules as ``[B, V] -> [B, V]`` maps over f32
logits, driven by a small ``FilterState``. The state's ``step`` is a [B]
tensor in the decode loops (``decode.py``, ``beam.py``: a captured step
may hold no Python value that changes from step to step; the speculative
decode's rows advance at their own pace), or a Python int where every row
has sampled as many tokens and the caller branches on it on the host.

SuppressBlank and SuppressTokens take their [V] masks as arguments, built
by ``_id_mask``. JAX compiles its masks into the program; a captured step
here reads them by address, so the step's static buffers own them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

NEG_INF = float("-inf")


class FilterState(NamedTuple):
    """Per-sequence token-history summary carried through the decode loop."""

    last_token: torch.Tensor  # [B] int64
    penult_token: torch.Tensor  # [B] int64
    last_timestamp: torch.Tensor  # [B] int64 (token id; 0 if none)
    has_timestamp: torch.Tensor  # [B] bool
    step: Union[int, torch.Tensor]  # tokens sampled so far: int, or [B] int64


def init_filter_state(initial_tokens: torch.Tensor) -> FilterState:
    """``initial_tokens``: [B, n_init] — the shared SOT/prompt prefix."""
    b = initial_tokens.shape[0]
    device = initial_tokens.device
    return FilterState(
        last_token=initial_tokens[:, -1],
        penult_token=(
            initial_tokens[:, -2]
            if initial_tokens.shape[1] >= 2
            else torch.full((b,), -1, dtype=torch.int64, device=device)
        ),
        last_timestamp=torch.zeros((b,), dtype=torch.int64, device=device),
        has_timestamp=torch.zeros((b,), dtype=torch.bool, device=device),
        step=0,
    )


def update_filter_state(
    state: FilterState, sampled: torch.Tensor, timestamp_begin: int
) -> FilterState:
    is_ts = sampled >= timestamp_begin
    return FilterState(
        last_token=sampled,
        penult_token=state.last_token,
        last_timestamp=torch.where(is_ts, sampled, state.last_timestamp),
        has_timestamp=state.has_timestamp | is_ts,
        step=state.step + 1,
    )


def advance_filter_state_(
    state: FilterState, sampled: torch.Tensor, timestamp_begin: int
) -> None:
    """``update_filter_state`` in place, on a state of [B] tensors: the
    decode loops' static buffers, which a captured step rewrites."""
    is_ts = sampled >= timestamp_begin
    state.penult_token.copy_(state.last_token)
    state.last_token.copy_(sampled)
    state.last_timestamp.copy_(torch.where(is_ts, sampled, state.last_timestamp))
    state.has_timestamp.logical_or_(is_ts)
    state.step.add_(1)


def _id_mask(n_vocab: int, ids: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """A new boolean vocab mask, True at ``ids``. Each call builds its own
    tensor, which the caller owns: a captured decode step reads its masks
    by address, so they live in the step's buffers
    (``decode.py::_filter_masks``), never in a shared cache."""
    mask = torch.zeros((n_vocab,), dtype=torch.bool)
    if ids:
        mask[list(ids)] = True
    return mask.to(device)


def suppress_blank(
    logits: torch.Tensor, state: FilterState, mask: torch.Tensor
) -> torch.Tensor:
    """At the first sampled position, forbid the tokens of ``mask`` [V]:
    the blank openings and EOT."""
    if not torch.is_tensor(state.step) and state.step != 0:
        return logits
    if torch.is_tensor(state.step):
        return logits.masked_fill((state.step == 0)[:, None] & mask[None], NEG_INF)
    return logits.masked_fill(mask[None], NEG_INF)


def suppress_tokens(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Forbid the tokens of ``mask`` [V] at every position."""
    return logits.masked_fill(mask[None], NEG_INF)


def apply_timestamp_rules(
    logits: torch.Tensor,
    state: FilterState,
    *,
    timestamp_begin: int,
    eot: int,
    no_timestamps: int,
    max_initial_timestamp_index: Optional[int],
) -> torch.Tensor:
    """Whisper's timestamp grammar, vectorized over the batch.

    Per row: <|notimestamps|> is never sampled; timestamps come in pairs
    (after an unpaired timestamp only a timestamp/EOT may follow; after a
    completed pair the next token must be text); timestamps are
    non-decreasing; the first sampled token must be a timestamp, capped at
    ``max_initial_timestamp``; and when the total timestamp probability beats
    every text token, text is masked out.
    """
    v = logits.shape[-1]
    vocab_ids = torch.arange(v, device=logits.device)[None, :]  # [1, V]
    is_ts_col = vocab_ids >= timestamp_begin  # [1, V]

    logits = logits.clone()
    logits[:, no_timestamps] = NEG_INF

    last_was_ts = (state.last_token >= timestamp_begin)[:, None]  # [B, 1]
    # "penultimate was a timestamp" counts sampled tokens only: with fewer
    # than 2 sampled it is vacuously true (Whisper's `len(seq) < 2 or ...`),
    # so the token after the forced initial timestamp must be text
    per_row = torch.is_tensor(state.step)
    step = state.step[:, None] if per_row else state.step  # [B, 1] or int
    penult_was_ts = (state.penult_token >= timestamp_begin)[:, None] | (step < 2)
    # pair grammar, from the first sampled token on: after an unpaired
    # timestamp mask text (ids < eot); after a pair mask timestamps
    grammar_mask = (last_was_ts & ~penult_was_ts & (vocab_ids < eot)) | (
        last_was_ts & penult_was_ts & is_ts_col
    )
    if per_row:
        grammar_mask = grammar_mask & (step > 0)
    elif step == 0:
        grammar_mask = torch.zeros_like(is_ts_col)

    # monotonicity: never below the latest timestamp (exclusive only while a
    # pair is open — the closing timestamp may equal the opening one)
    open_pair = (last_was_ts & ~penult_was_ts)[:, 0]
    lower = torch.where(
        state.has_timestamp,
        torch.where(open_pair, state.last_timestamp, state.last_timestamp + 1),
        torch.full_like(state.last_timestamp, timestamp_begin),
    )  # [B]
    mono_mask = is_ts_col & (vocab_ids < lower[:, None])
    logits = logits.masked_fill(grammar_mask | mono_mask, NEG_INF)

    if per_row or step == 0:
        # the first sampled token must be a timestamp, bounded by max_initial
        init_mask = ~is_ts_col
        if max_initial_timestamp_index is not None:
            last_allowed = timestamp_begin + max_initial_timestamp_index
            init_mask = init_mask | (vocab_ids > last_allowed)
        if per_row:
            init_mask = init_mask & (step == 0)
        logits = logits.masked_fill(init_mask, NEG_INF)

    # sample a timestamp whenever its total probability outweighs any single
    # text token
    logprobs = torch.log_softmax(logits, dim=-1)
    ts_logprob = torch.logsumexp(logprobs.masked_fill(~is_ts_col, NEG_INF), dim=-1)
    max_text = logprobs.masked_fill(is_ts_col, NEG_INF).amax(dim=-1)
    force_ts = (ts_logprob > max_text)[:, None]
    return logits.masked_fill(force_ts & ~is_ts_col, NEG_INF)


def numeral_tokens(tokenizer) -> Tuple[int, ...]:
    """Token ids whose text contains digits or currency symbols — the
    ``suppress_numerals`` option. Scanned once per tokenizer and memoized
    on the instance."""
    cached = getattr(tokenizer, "_numeral_tokens", None)
    if cached is None:
        bad = set("0123456789%$£€¥₹")
        out = []
        for t in range(tokenizer.eot):
            try:
                text = tokenizer.decode([t])
            except (KeyError, ValueError, UnicodeDecodeError):
                continue
            if any(c in bad for c in text):
                out.append(t)
        cached = tuple(out)
        tokenizer._numeral_tokens = cached
    return cached


def build_suppress_list(
    tokenizer,
    suppress_tokens_option,
    *,
    suppress_numerals: bool = False,
) -> Tuple[int, ...]:
    """Resolve the user-facing ``suppress_tokens`` option (reference
    semantics: "-1" → non-speech set; always add task/special markers)."""
    if isinstance(suppress_tokens_option, str):
        suppress = [int(t) for t in suppress_tokens_option.split(",") if t]
    elif suppress_tokens_option is None:
        suppress = []
    else:
        suppress = list(suppress_tokens_option)
    if -1 in suppress:
        suppress = [t for t in suppress if t >= 0]
        suppress.extend(tokenizer.non_speech_tokens)
    if suppress_numerals:
        suppress.extend(numeral_tokens(tokenizer))
    suppress.extend(
        [
            tokenizer.transcribe,
            tokenizer.translate,
            tokenizer.sot,
            tokenizer.sot_prev,
            tokenizer.sot_lm,
        ]
    )
    if tokenizer.no_speech is not None:
        suppress.append(tokenizer.no_speech)
    suppress.extend(tokenizer.all_language_tokens)
    return tuple(sorted(set(suppress)))

"""Whisper's logit filters over a teacher-forced sequence, and the gap by
which each served token lies below the reference's choice.

At sampled position j the filters see the tokens before it: the token
suppression list at every position; at j = 0 the blank tokens and EOT.
With timestamps, also <|notimestamps|> never, the timestamp grammar
(timestamps in pairs, never decreasing, the first token a timestamp no later
than ``max_initial_timestamp``) and the soft rule that masks every text token
when the timestamps' total probability beats the best text token's. Without
them (``without_timestamps``), the prompt ends in <|notimestamps|> and no
rule reads the tokens before j but the first-position one.

The soft rule is a comparison of two computed numbers, so the program and
the reference may decide it differently near its threshold. ``gaps`` takes
either decision, charging the one the reference did not take with its
margin, and keeps the smaller: the served token's gap is the least change of
the reference's logits, in logit units, that makes it the filters' choice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

NEG_INF = float("-inf")


@dataclass(frozen=True)
class Specials:
    eot: int
    timestamp_begin: int
    no_timestamps: int
    suppress: Tuple[int, ...]
    blank: Tuple[int, ...]
    max_initial_index: int
    timestamps: bool = True

    @property
    def initial(self) -> Tuple[int, ...]:
        """<|startoftranscript|><|en|><|transcribe|>, then <|notimestamps|>
        where the decode runs without timestamps."""
        sot = (self.eot + 1, self.eot + 2, self.no_timestamps - 4)
        return sot if self.timestamps else sot + (self.no_timestamps,)

    @classmethod
    def of(cls, config: dict) -> "Specials":
        """The ids of the multilingual layout (base vocabulary 50257) and
        the configuration's suppression lists: ``suppress_ids``, with
        ``suppress_byte_tokens`` the ids 0-255 too, and with
        ``suppress_timestamp_tokens`` <|notimestamps|> and every timestamp
        token."""
        eot = 50257
        n_lang = config["n_vocab"] - 51765 - 1
        no_ts = eot + 1 + 1 + n_lang + 5  # sot, languages, translate … no_speech
        suppress = list(config["suppress_ids"])
        if config.get("suppress_byte_tokens"):
            suppress += range(256)
        if config.get("suppress_timestamp_tokens"):
            suppress += range(no_ts, config["n_vocab"])
        return cls(
            eot=eot,
            timestamp_begin=no_ts + 1,
            no_timestamps=no_ts,
            suppress=tuple(sorted(set(suppress))),
            blank=tuple(config["blank_ids"]),
            max_initial_index=round(config["asr_options"]["max_initial_timestamp"] / 0.02),
            timestamps=not config["asr_options"]["without_timestamps"],
        )


def hard_masked(logits: torch.Tensor, seq: Sequence[int], n_init: int, sp: Specials) -> torch.Tensor:
    """``logits`` [n, V] predicting ``seq[n_init + j]`` for j < n, with
    every rule but the soft one applied (masked entries -inf)."""
    n, v = logits.shape
    dev = logits.device
    seq_t = torch.as_tensor(list(seq), device=dev)
    j = torch.arange(n, device=dev)
    last = seq_t[n_init + j - 1]
    penult = seq_t[n_init + j - 2]
    sampled = seq_t[n_init:n_init + n]
    is_ts_tok = sampled >= sp.timestamp_begin
    # the latest timestamp sampled before position j (0 if none)
    at = torch.where(is_ts_tok, j, torch.full_like(j, -1))
    before = torch.cat([torch.full((1,), -1, dtype=at.dtype, device=dev), torch.cummax(at, 0).values[:-1]])
    has_ts = before >= 0
    prev_ts = torch.where(has_ts, sampled[before.clamp(min=0)], torch.zeros_like(sampled))
    ids = torch.arange(v, device=dev)[None]
    is_ts_col = ids >= sp.timestamp_begin

    out = logits.clone()
    sup = torch.zeros(v, dtype=torch.bool, device=dev)
    sup[list(sp.suppress)] = True
    out[:, sup] = NEG_INF
    first = torch.zeros(v, dtype=torch.bool, device=dev)
    first[list(sp.blank) + [sp.eot]] = True
    out[0, first] = NEG_INF
    if not sp.timestamps:
        return out
    out[:, sp.no_timestamps] = NEG_INF
    last_ts = (last >= sp.timestamp_begin)[:, None]
    penult_ts = (penult >= sp.timestamp_begin)[:, None] | (j < 2)[:, None]
    grammar = (last_ts & ~penult_ts & (ids < sp.eot)) | (last_ts & penult_ts & is_ts_col)
    grammar &= (j > 0)[:, None]
    open_pair = (last_ts & ~penult_ts)[:, 0]
    lower = torch.where(has_ts, torch.where(open_pair, prev_ts, prev_ts + 1),
                        torch.full_like(prev_ts, sp.timestamp_begin))
    mono = is_ts_col & (ids < lower[:, None])
    out = out.masked_fill(grammar | mono, NEG_INF)
    init = (~is_ts_col | (ids > sp.timestamp_begin + sp.max_initial_index)) & (j == 0)[:, None]
    return out.masked_fill(init, NEG_INF)


def gaps(logits: torch.Tensor, seq: Sequence[int], n_init: int, sp: Specials,
         choose: torch.Tensor = None) -> torch.Tensor:
    """Per position, the gap (≥ 0, +inf where a hard rule forbids it) of the
    served token ``seq[n_init + j]`` — or of ``choose[j]`` when given — under
    the reference ``logits``."""
    h = hard_masked(logits, seq, n_init, sp)
    n, v = h.shape
    dev = h.device
    tok = torch.as_tensor(list(seq[n_init:n_init + n]), device=dev) if choose is None else choose
    val = h.gather(1, tok[:, None])[:, 0]
    if not sp.timestamps:
        g = torch.where(torch.isfinite(val), h.amax(dim=-1) - val, torch.full_like(val, float("inf")))
        return torch.nan_to_num(g, nan=float("inf"))
    is_ts_col = torch.arange(v, device=dev)[None] >= sp.timestamp_begin
    lp = torch.log_softmax(h, dim=-1)
    ts_lp = torch.logsumexp(lp.masked_fill(~is_ts_col, NEG_INF), dim=-1)
    max_text = lp.masked_fill(is_ts_col, NEG_INF).amax(dim=-1)
    forced = ts_lp > max_text
    margin = (ts_lp - max_text).abs()
    margin = torch.where(torch.isfinite(margin), margin, torch.full_like(margin, float("inf")))
    best_all = h.amax(dim=-1)
    best_ts = h.masked_fill(~is_ts_col, NEG_INF).amax(dim=-1)
    tok_ts = tok >= sp.timestamp_begin
    inf = torch.full_like(val, float("inf"))
    under_forced = torch.where(tok_ts, best_ts - val, inf)  # only a timestamp may be chosen
    under_free = best_all - val
    # the decision the reference took costs nothing, the other its margin
    g = torch.where(forced, torch.minimum(under_forced, torch.maximum(under_free, margin)),
                    torch.minimum(under_free, torch.maximum(under_forced, margin)))
    g = torch.where(torch.isfinite(val), g, inf)
    return torch.nan_to_num(g, nan=float("inf"))


def choices(logits: torch.Tensor, seq: Sequence[int], n_init: int, sp: Specials) -> torch.Tensor:
    """The filters' greedy choice at each position, from ``logits``."""
    h = hard_masked(logits, seq, n_init, sp)
    if not sp.timestamps:
        return h.argmax(dim=-1)
    is_ts_col = torch.arange(h.shape[1], device=h.device)[None] >= sp.timestamp_begin
    lp = torch.log_softmax(h, dim=-1)
    ts_lp = torch.logsumexp(lp.masked_fill(~is_ts_col, NEG_INF), dim=-1)
    max_text = lp.masked_fill(is_ts_col, NEG_INF).amax(dim=-1)
    forced = (ts_lp > max_text)[:, None]
    return h.masked_fill(forced & ~is_ts_col, NEG_INF).argmax(dim=-1)

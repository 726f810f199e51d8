"""Draft-model speculative decoding.

Counterpart of ``whisperx_tpu/decoding/speculative.py``. A small draft
Whisper proposes ``gamma`` tokens greedily, the target verifies them in ONE
forward pass, and the longest agreeing prefix is accepted (plus the target's
own bonus token): with greedy verification the output is token-identical to
plain greedy decoding of the target, cheaper per accepted token when the
draft agrees often.

JAX runs the batched decode as a ``jax.vmap`` of a B=1 ``lax.while_loop``
whose rows accept their own number of tokens. The port has no vmap: it runs
one batched loop whose rows carry their own positions (``decoder_forward``
with a [B] offset), filter steps and counts, all on the device; the host
reads back once per iteration whether any row is still active, as the greedy
loop reads ``finished.all()`` once per step. On one CUDA device each
iteration is one replay of a graph captured from its static body
(``_spec_step`` over ``_SpecBuffers``; ``step_graph.py``), JAX's jitted
``_spec_batch_jit``: the draft passes, the verify pass and the acceptance
are one launch from the host. The encoders, cross-KV and prefills stay
eager; the CPU runs the same body uncaptured. The host loop ``decode`` is
one, as JAX's ``decode`` is.

The cross-KV of both models is computed in the model's dtype and never
quantized, as in JAX: ``kv_quant`` does not apply on this path, so the int8
cross-attention kernel (K3) never runs on it, and the token-identity promise
is against greedy decoding with ``kv_quant=False``.

Both models must share a tokenizer/vocab (e.g. large-v3 + distil-large-v3).

A batch's parts are timed as the greedy decode's are (``decode.encoder``:
both encoders; ``decode.prefill``: both cross-KVs and prefills;
``decode.steps``; ``decode.readback``).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from whisperx_tpu_torch.decoding import filters as F
from whisperx_tpu_torch.decoding.decode import (
    DecodingOptions,
    DecodingResult,
    _StaticConfig,
    _apply_filters,
    _build_initial_tokens,
    _cache_len,
    _filter_masks,
    _reset_state,
    _state_buffers,
    _step_config,
    init_kv_cache_like,
)
from whisperx_tpu_torch.decoding.step_graph import GraphCache, graph_cache, load_cache, step_runner
from whisperx_tpu_torch.models.whisper.model import (
    KVCache,
    decoder_forward,
    encoder_forward,
    new_self_cache,
    precompute_cross_kv,
)
from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER
from whisperx_tpu_torch.utils.text import compression_ratio

# the target decoder's attribute that holds its speculative decodes' graph
# cache (``step_graph.GraphCache``), keyed on the target's and the draft's
# tensors: a reloaded draft or a ``zero_tail_model`` target misses
SPEC_GRAPHS = "_spec_graphs"


@dataclass
class SpecStats:
    proposed: int = 0
    accepted: int = 0
    target_steps: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0


def shares_cross_kv(target, draft) -> bool:
    """True when the draft's encoder is the target's and its decoder blocks
    are the target's first blocks (``truncated_self_draft``): the draft's
    cross-KV is then the first layers of the target's, the same values, and
    is not computed twice."""
    t_blocks, d_blocks = target.decoder.blocks, draft.decoder.blocks
    return (
        draft.encoder is target.encoder
        and len(d_blocks) <= len(t_blocks)
        and all(d is t for d, t in zip(d_blocks, t_blocks))
    )


@dataclass
class _SpecBuffers:
    """What a speculative iteration reads and writes, in place: the static
    buffers of a captured iteration (``step_graph``). Rows are the batch;
    every [B] tensor is per row, as each row accepts its own tokens. The
    draft's cross-KV of a ``self:N`` draft is the target's first layers,
    the same tensors (``shares_cross_kv``), never a copy."""

    t_cache: KVCache
    d_cache: KVCache
    buf: torch.Tensor  # [B, sample_len + γ + 1] int64 (γ+1 slack for a whole window)
    n: torch.Tensor  # [B] int64: tokens written
    finished: torch.Tensor  # [B] bool: EOT written
    active: torch.Tensor  # [B] bool: the rows the next iteration advances
    sum_lp: torch.Tensor  # [B] f32
    proposed: torch.Tensor  # [B] int64
    accepted: torch.Tensor  # [B] int64
    passes: torch.Tensor  # [B] int64: target passes
    last_tok: torch.Tensor  # [B] int64: the last accepted token
    state: F.FilterState  # of [B] tensors: ``step`` counts written tokens
    # constants of the body, made once with the buffers
    js: torch.Tensor  # [γ+1] int64: 0..γ
    back: torch.Tensor  # [2] int64: [1, 2], the last two written slots
    suppress_mask: torch.Tensor  # [V] bool
    blank_mask: torch.Tensor  # [V] bool: the blank tokens and EOT

    @classmethod
    def allocate(cls, target, draft, t_cross, d_cross, b: int, t_len: int, d_len: int,
                 cfg: _StaticConfig, d_cfg: _StaticConfig, gamma: int, shared: bool):
        """Buffers for ``b`` rows around this decode's cross-KV; with
        ``shared`` the draft's cross-KV lists are the target's first layers."""
        dec = target.decoder
        device = dec.tok_emb.device
        n_vocab = dec.tok_emb.shape[0]
        i64 = dict(dtype=torch.int64, device=device)
        # the draft shares the target's vocabulary, suppress list and blank
        # tokens (``_configs``): these masks are its filters' too
        suppress_mask, blank_mask = _filter_masks(cfg, n_vocab, device)
        t_cache = KVCache(*new_self_cache(dec, b, t_len, cfg.n_head), list(t_cross[0]), list(t_cross[1]))
        if shared:
            n_draft = len(draft.decoder.blocks)
            d_cross = (t_cache.cross_k[:n_draft], t_cache.cross_v[:n_draft])
        d_cache = KVCache(
            *new_self_cache(draft.decoder, b, d_len, d_cfg.n_head), list(d_cross[0]), list(d_cross[1])
        )
        return cls(
            t_cache=t_cache,
            d_cache=d_cache,
            buf=torch.empty((b, cfg.sample_len + gamma + 1), **i64),
            n=torch.empty((b,), **i64),
            finished=torch.empty((b,), dtype=torch.bool, device=device),
            active=torch.empty((b,), dtype=torch.bool, device=device),
            sum_lp=torch.empty((b,), dtype=torch.float32, device=device),
            proposed=torch.empty((b,), **i64),
            accepted=torch.empty((b,), **i64),
            passes=torch.empty((b,), **i64),
            last_tok=torch.empty((b,), **i64),
            state=_state_buffers(b, device),
            js=torch.arange(gamma + 1, **i64),
            back=torch.tensor([1, 2], **i64),
            suppress_mask=suppress_mask,
            blank_mask=blank_mask,
        )

    def start(self, t_cross, d_cross, initial_tokens, cfg: _StaticConfig) -> None:
        """A decode's start: both self caches zeroed, this decode's cross-KV
        copied in (a shared draft's with the target's), the counts zeroed."""
        load_cache(self.t_cache, *t_cross)
        if self.d_cache.cross_k[0] is self.t_cache.cross_k[0]:  # shared: loaded above
            d_cross = (self.d_cache.cross_k, self.d_cache.cross_v)
        load_cache(self.d_cache, *d_cross)
        self.buf.fill_(cfg.eot)
        for t in (self.n, self.proposed, self.accepted, self.passes, self.sum_lp):
            t.zero_()
        self.finished.zero_()
        self.active.fill_(cfg.sample_len > 0)
        self.last_tok.copy_(initial_tokens[:, -1])
        _reset_state(self.state, initial_tokens)


def _spec_step(t_dec, d_dec, s: _SpecBuffers, cfg: _StaticConfig, d_cfg: _StaticConfig,
               gamma: int, n_init: int) -> None:
    """One speculative iteration over ``s``, in place, for the rows in
    ``s.active``:

      1. drafts γ tokens whose FIRST step re-feeds the last accepted token,
         which repairs the draft cache's mismatch slot of the previous
         iteration (no conditional fix-up), and writes d_γ's K/V too;
      2. verifies ``[last_accepted, d_1..d_γ]`` in ONE target pass at the
         row's own position: the leading token likewise repairs the target
         cache, and the final position's logits give the bonus token on
         full acceptance (γ+1 tokens per verify pass);
      3. accepts the longest agreeing prefix, with a γ+1-step loop that
         carries the filter state (timestamps on), or as vector maths
         (``without_timestamps``: the filters are position-wise);

    then sets ``s.active`` for the next iteration. Every write of a row's
    outputs, counts and filter state is gated on the row being active, so
    a finished row is frozen bit for bit. Its self-attention caches are
    rewritten at its frozen slots, as JAX's body rewrites them, and never
    read for any output again. Reads no value back to the host (a captured
    iteration's body): every value that changes between iterations is a
    buffer of ``s``, written in place."""
    active, state, buf, n = s.active, s.state, s.buf, s.n
    zeros = torch.zeros_like(n)

    def t_forward(tokens, offset):
        return decoder_forward(t_dec, tokens, s.t_cache, offset, cfg.n_head)

    def d_forward(tokens, offset):
        return decoder_forward(d_dec, tokens, s.d_cache, offset, d_cfg.n_head)

    # slot of the last accepted token (first iteration: the final prompt
    # token; recomputing its K/V is idempotent)
    pos = n_init + n - 1

    # --- the draft proposes γ tokens; step 1 re-feeds last_tok -----------
    d_state, prev, draft_toks = state, s.last_tok, []
    for g in range(gamma):
        fl = _apply_filters(
            d_forward(prev[:, None], pos + g)[:, -1], d_state, d_cfg, s.suppress_mask, s.blank_mask
        )
        prev = torch.argmax(fl, -1)
        d_state = F.update_filter_state(d_state, prev, cfg.timestamp_begin)
        draft_toks.append(prev)
    draft_toks = torch.stack(draft_toks, 1)  # [B, γ]
    # also write d_γ's K/V: a full acceptance (+ bonus) advances past slot
    # pos+γ, which nothing else would write; later draft queries would
    # attend a zeroed slot, silently degrading acceptance
    d_forward(draft_toks[:, -1:], pos + gamma)

    # --- ONE target pass: repair slot + verify + bonus logits ------------
    v_logits = t_forward(torch.cat([s.last_tok[:, None], draft_toks], 1), pos)

    # --- accept the longest agreeing prefix (+ bonus token) --------------
    # position j's target choice comes from v_logits[:, j]; j == γ is the
    # bonus slot, whose sentinel never matches a draft
    sum_lp, finished = s.sum_lp, s.finished
    if cfg.without_timestamps:
        # the filters are the suppress list and the first token's blank
        # mask: one masked fill over every position
        fl = v_logits.float().masked_fill(s.suppress_mask, F.NEG_INF)
        if cfg.blank_tokens:
            first = (state.step[:, None] + s.js) == 0  # [B, γ+1]
            fl = fl.masked_fill(first[:, :, None] & s.blank_mask, F.NEG_INF)
        choices = torch.argmax(fl, -1)  # [B, γ+1]
        lps = torch.log_softmax(fl, -1).gather(2, choices[:, :, None])[:, :, 0]
        match = torch.cat(
            [choices[:, :gamma] == draft_toks, torch.zeros_like(choices[:, :1], dtype=torch.bool)], 1
        )
        is_eot = choices == cfg.eot
        # position j is written iff every earlier one matched and was not
        # EOT, and its buffer slot exists
        ok = (match & ~is_eot).long()
        prior_ok = torch.cat([torch.ones_like(ok[:, :1]), ok[:, :-1].cumprod(1)], 1).bool()
        keep = prior_ok & (n[:, None] + s.js < cfg.sample_len) & active[:, None]
        w = keep.sum(-1)
        slots = n[:, None] + s.js
        buf.scatter_(1, slots, torch.where(keep, choices, buf.gather(1, slots)))
        sum_lp = sum_lp + torch.where(keep, lps, 0.0).sum(-1)
        n_match = (keep[:, :gamma] & match[:, :gamma]).sum(-1)
        finished = finished | (keep & is_eot).any(-1)
        # the filter state after the written run (no timestamp field
        # changes in this mode): the last two tokens written
        last_two = choices.gather(1, (w[:, None] - s.back).clamp(min=0))
        last = torch.where(w >= 1, last_two[:, 0], state.last_token)
        penult = torch.where(
            w >= 2, last_two[:, 1], torch.where(w >= 1, state.last_token, state.penult_token)
        )
        state = state._replace(last_token=last, penult_token=penult, step=state.step + w)
    else:
        draft_ext = torch.cat([draft_toks, torch.full_like(draft_toks[:, :1], -1)], 1)
        writing, w, n_match = active, zeros, zeros
        for j in range(gamma + 1):
            fl = _apply_filters(v_logits[:, j], state, cfg, s.suppress_mask, s.blank_mask)
            choice = torch.argmax(fl, -1)
            lp = torch.log_softmax(fl, -1).gather(1, choice[:, None])[:, 0]
            write = writing & (n + j < cfg.sample_len)
            slot = (n + j)[:, None]
            buf.scatter_(1, slot, torch.where(write[:, None], choice[:, None], buf.gather(1, slot)))
            sum_lp = sum_lp + torch.where(write, lp, 0.0)
            new_state = F.update_filter_state(state, choice, cfg.timestamp_begin)
            state = F.FilterState(*(torch.where(write, new, old) for new, old in zip(new_state, state)))
            match = choice == draft_ext[:, j]
            is_eot = choice == cfg.eot
            w = w + write.long()
            if j < gamma:
                n_match = n_match + (write & match).long()
            finished = finished | (write & is_eot)
            writing = writing & match & ~is_eot

    # --- the loop's carry, written back into its buffers -----------------
    new_n = n + w
    last_written = buf.gather(1, (new_n - 1).clamp(min=0)[:, None])[:, 0]
    s.last_tok.copy_(torch.where(new_n >= 1, last_written, s.last_tok))
    n.copy_(new_n)
    s.sum_lp.copy_(sum_lp)
    s.finished.copy_(finished)
    for dst, src in zip(s.state, state):
        if dst is not src:
            dst.copy_(src)
    s.proposed.add_(torch.where(active, gamma, 0))
    s.accepted.add_(n_match)
    s.passes.add_(active.long())
    s.active.copy_(~s.finished & (n < cfg.sample_len))


def _cache_lens(cfg: _StaticConfig, d_cfg: _StaticConfig, n_init: int, gamma: int):
    """Both self caches' lengths: verify passes write up to γ+1 slots past
    the sampled count, so the budget is widened by as much."""
    return tuple(
        _cache_len(dataclasses.replace(c, sample_len=c.sample_len + gamma + 1), n_init)
        for c in (cfg, d_cfg)
    )


@torch.inference_mode()
def _spec_batch(target, draft, mels, initial_tokens, cfg, d_cfg, gamma, capture: bool = True):
    """The whole speculative generate loop over a batch, every row on its
    own: the encoders, cross-KV and the prefill of both models, eager; then
    iterations of ``_spec_step`` over static buffers, with one host read
    each (whether any row is still active). ``capture``: each iteration is
    a replay of a captured graph (``step_graph``) where both models allow
    it (CUDA, no tensor-parallel block); False runs the same body
    uncaptured (the CPU, the yardstick).

    Returns (tokens [B, sample_len + γ + 1], n [B], sum_logprob [B],
    no_speech_prob [B], proposed [B], accepted [B], target passes [B],
    audio features, iterations)."""
    b, n_init = initial_tokens.shape
    device = mels.device
    shared = shares_cross_kv(target, draft)
    with GLOBAL_TRACKER.span("decode.encoder", device=device):
        t_feats = encoder_forward(target.encoder, mels, cfg.n_head_audio)
        if not shared and draft.encoder is not target.encoder:
            d_feats = encoder_forward(draft.encoder, mels.to(draft.dtype), d_cfg.n_head_audio)
        else:
            d_feats = t_feats
    t_len, d_len = _cache_lens(cfg, d_cfg, n_init, gamma)
    t_dec, d_dec = target.decoder, draft.decoder
    shape = (
        "spec", b, n_init, gamma, t_len, d_len, t_feats.shape[1], cfg.without_timestamps,
        shared, _step_config(cfg), _step_config(d_cfg),
    )
    cache = graph_cache(t_dec, SPEC_GRAPHS)
    with contextlib.ExitStack() as runner:
        with GLOBAL_TRACKER.span("decode.prefill", device=device):
            t_cross = precompute_cross_kv(target.decoder, t_feats, cfg.n_head)
            if shared:
                # the same encoder and the same first blocks: the same K/V values
                n_draft = len(draft.decoder.blocks)
                d_cross = (t_cross[0][:n_draft], t_cross[1][:n_draft])
            else:
                d_cross = precompute_cross_kv(draft.decoder, d_feats, d_cfg.n_head)
            make = lambda: _SpecBuffers.allocate(
                target, draft, t_cross, d_cross, b, t_len, d_len, cfg, d_cfg, gamma, shared
            )
            s, run = runner.enter_context(step_runner((target, draft), capture, shape, make, cache))
            s.start(t_cross, d_cross, initial_tokens, cfg)
            del t_cross, d_cross
            # the prefills: one eager pass each at offset 0
            t_logits = decoder_forward(t_dec, initial_tokens, s.t_cache, 0, cfg.n_head)
            if n_init > 1:
                decoder_forward(d_dec, initial_tokens[:, :-1], s.d_cache, 0, d_cfg.n_head)
            no_speech_prob = torch.softmax(t_logits[:, cfg.sot_index].float(), -1)[:, cfg.no_speech_token]
            del t_logits

        iterations = 0
        with GLOBAL_TRACKER.span("decode.steps", device=device):
            # one host read per iteration: the loop stops once no row is active
            while bool(s.active.any()):
                run(lambda: _spec_step(t_dec, d_dec, s, cfg, d_cfg, gamma, n_init))
                iterations += 1
        out = tuple(t.clone() for t in (s.buf, s.n, s.sum_lp))
        counts = tuple(t.clone() for t in (s.proposed, s.accepted, s.passes))
    return (*out, no_speech_prob, *counts, t_feats, iterations)


# ---------------------------------------------------------------------------
# Drafts and instrumented targets built from a model's own weights
# ---------------------------------------------------------------------------


def _shallow(module: nn.Module) -> nn.Module:
    """A new module object sharing every parameter and submodule of
    ``module``; assigning a submodule to it leaves ``module`` unchanged."""
    out = copy.copy(module)
    out._modules = dict(module._modules)
    for name in [k for k, v in out.__dict__.items() if isinstance(v, GraphCache)]:
        del out.__dict__[name]  # a new decoder starts with no graphs
    return out


def _with_blocks(model, blocks, dims, name: str):
    dec = _shallow(model.decoder)
    dec.blocks = nn.ModuleList(blocks)
    out = _shallow(model)
    out.decoder = dec
    out.dims = dims
    out.name = name
    return out


def truncated_self_draft(model, n_layers: int):
    """Self-draft: the target's own first ``n_layers`` decoder blocks and
    its encoder (the same modules: nothing is copied). Pairs with
    ``zero_tail_model`` for an exact-agreement mechanism benchmark, and
    models distil-style drafts without a second checkpoint."""
    dims = dataclasses.replace(model.dims, n_text_layer=n_layers)
    out = _with_blocks(
        model, list(model.decoder.blocks[:n_layers]), dims, f"{model.name}-draft{n_layers}"
    )
    out.alignment_heads = [
        (layer, head)
        for layer in range(n_layers // 2, n_layers)
        for head in range(dims.n_text_head)
    ]
    return out


def zero_tail_model(model, keep_layers: int):
    """Zero the output projections of every decoder block past
    ``keep_layers``: with pre-LN residual blocks those layers become exact
    identities, so ``truncated_self_draft(model, keep_layers)`` agrees with
    the full model EXACTLY while the full model still pays for all its
    layers. This isolates the speculative mechanism's speedup at
    acceptance 1 (its upper bound) with random weights."""
    out = scaled_tail_model(model, keep_layers, 0.0)
    out.name = f"{model.name}-zerotail{keep_layers}"
    return out


def scaled_tail_model(model, keep_layers: int, alpha: float):
    """Scale (instead of zero) the output projections of the decoder blocks
    past ``keep_layers`` by ``alpha``: the self-attention's and
    cross-attention's ``out`` and ``mlp2``, weights and biases. The first
    blocks and everything else are shared with ``model``. A weight-only
    quantized projection scales its group scales, the same product."""
    from whisperx_tpu_torch.models.whisper.model import Linear
    from whisperx_tpu_torch.quant.core import QuantizedLinear

    def scaled(lin):
        b = None if lin.b is None else lin.b * alpha
        if isinstance(lin, QuantizedLinear):
            return QuantizedLinear(
                lin.qw, lin.scale * alpha, b, bits=lin.bits, group_size=lin.group_size
            )
        w = lin.w
        out = Linear(w.shape[0], w.shape[1], bias=b is not None, dtype=w.dtype, device=w.device)
        with torch.no_grad():
            out.w.copy_(w * alpha)
            if b is not None:
                out.b.copy_(b)
        return out

    blocks = []
    for i, blk in enumerate(model.decoder.blocks):
        if i < keep_layers:
            blocks.append(blk)
            continue
        nb = _shallow(blk)
        nb.attn = _shallow(blk.attn)
        nb.attn.out = scaled(blk.attn.out)
        if hasattr(blk, "cross_attn"):
            nb.cross_attn = _shallow(blk.cross_attn)
            nb.cross_attn.out = scaled(blk.cross_attn.out)
        nb.mlp2 = scaled(blk.mlp2)
        blocks.append(nb)
    return _with_blocks(model, blocks, model.dims, f"{model.name}-scaledtail{keep_layers}a{alpha}")


# ---------------------------------------------------------------------------
# The decoder object the pipeline holds
# ---------------------------------------------------------------------------


class SpeculativeDecoder:
    def __init__(self, target_model, draft_model, gamma: int = 4):
        assert target_model.dims.n_vocab == draft_model.dims.n_vocab, (
            "target and draft must share a vocabulary"
        )
        self.target = target_model
        self.draft = draft_model
        self.gamma = gamma
        self.stats = SpecStats()

    def decode_jit(
        self,
        mel: torch.Tensor,  # [T, n_mels]
        options: DecodingOptions = DecodingOptions(),
        tokenizer=None,
    ) -> DecodingResult:
        """The batched loop at B=1 (JAX's name: there it is one jitted
        program; here, on one CUDA device, each iteration is one replay of
        a captured graph). No host round trip per token beyond the loop's
        one read per iteration; output token-identical to plain greedy
        decoding of the target."""
        tokenizer, initial, cfg, d_cfg = self._configs(options, tokenizer)
        init = torch.tensor([initial], dtype=torch.int64, device=mel.device)
        buf, n, sum_lp, nsp, prop, acc, tp, t_feats, _ = _spec_batch(
            self.target, self.draft, mel[None].to(self.target.dtype), init, cfg, d_cfg, self.gamma
        )
        tokens = buf[0, : int(n[0])].tolist()
        # the loop writes EOT into the buffer like any other token; strip it
        if tokens and tokens[-1] == cfg.eot:
            tokens.pop()
        self.stats.proposed += int(prop[0])
        self.stats.accepted += int(acc[0])
        self.stats.target_steps += int(tp[0])
        text = tokenizer.decode(tokens).strip()
        return DecodingResult(
            audio_features=t_feats[0],
            language=options.language or "en",
            tokens=tokens,
            text=text,
            avg_logprob=float(sum_lp[0]) / (len(tokens) + 1),
            no_speech_prob=float(nsp[0]),
            temperature=0.0,
            compression_ratio=compression_ratio(text) if text else float("nan"),
        )

    def decode_batch_dispatch(
        self,
        mels: torch.Tensor,  # [B, T, n_mels]
        options: DecodingOptions = DecodingOptions(),
        tokenizer=None,
        n_real: Optional[int] = None,
        _eager: bool = False,
    ) -> dict:
        """Run the batched speculative decode and return its device tensors,
        not yet read back: the speculative twin of ``decode.decode_dispatch``
        for the pipeline's dispatch/finalize handles. ``n_real``: the rows
        that are real audio (the pipeline zero-pads ragged groups).

        On one CUDA device each iteration replays a captured graph
        (``step_graph``, an entry of the target decoder's speculative graph
        cache); the CPU and tensor-parallel models run the same body
        uncaptured. ``_eager`` runs it uncaptured on the card too: the
        yardstick the captured decode is held against, and nothing else."""
        tokenizer, initial, cfg, d_cfg = self._configs(options, tokenizer)
        b = mels.shape[0]
        init = torch.tensor([initial] * b, dtype=torch.int64, device=mels.device)
        buf, n, sum_lp, nsp, prop, acc, tp, _, iterations = _spec_batch(
            self.target, self.draft, mels.to(self.target.dtype), init, cfg, d_cfg, self.gamma,
            capture=not _eager,
        )
        return {
            "device": (buf, n, sum_lp, nsp, prop, acc, tp),
            "tokenizer": tokenizer,
            "cfg": cfg,
            "language": options.language or "en",
            "temperature": options.temperature,
            "n_real": b if n_real is None else int(n_real),
            "steps": iterations,
        }

    def decode_batch_finalize(self, handle: dict) -> list:
        """Read a ``decode_batch_dispatch`` handle back into per-row
        ``DecodingResult``s (the span ``decode.readback``, after which the
        decode's device times are read); adds the real rows' acceptance
        counts to ``self.stats`` and the global metrics tracker."""
        with GLOBAL_TRACKER.span("decode.readback"):
            results = self._finalize(handle)
            GLOBAL_TRACKER.settle()
        return results

    def _finalize(self, handle: dict) -> list:
        buf, n, sum_lp, nsp, prop, acc, tp = (t.cpu().numpy() for t in handle["device"])
        tokenizer = handle["tokenizer"]
        cfg = handle["cfg"]
        # stats count REAL rows only: padding rows would skew the rate
        n_real = handle["n_real"]
        prop_s, acc_s, tp_s = (int(x[:n_real].sum()) for x in (prop, acc, tp))
        self.stats.proposed += prop_s
        self.stats.accepted += acc_s
        self.stats.target_steps += tp_s
        GLOBAL_TRACKER.add("spec_proposed", prop_s)
        GLOBAL_TRACKER.add("spec_accepted", acc_s)
        GLOBAL_TRACKER.add("spec_target_passes", tp_s)
        results = []
        for i in range(buf.shape[0]):
            tokens = buf[i, : int(n[i])].tolist()
            if tokens and tokens[-1] == cfg.eot:
                tokens.pop()
            text = tokenizer.decode(tokens).strip()
            results.append(
                DecodingResult(
                    audio_features=None,
                    language=handle["language"],
                    tokens=tokens,
                    text=text,
                    avg_logprob=float(sum_lp[i]) / (len(tokens) + 1),
                    no_speech_prob=float(nsp[i]),
                    temperature=handle["temperature"],
                    compression_ratio=compression_ratio(text) if text else float("nan"),
                )
            )
        return results

    def _configs(self, options: DecodingOptions, tokenizer=None):
        if tokenizer is None:
            from whisperx_tpu_torch.decoding.tokenizer import get_tokenizer

            tokenizer = get_tokenizer(
                self.target.is_multilingual,
                num_languages=self.target.num_languages,
                language=options.language or "en",
                task=options.task,
                vocab_path=self.target.vocab_path,
            )
        sample_len = options.sample_len or self.target.dims.n_text_ctx // 2
        initial = _build_initial_tokens(
            tokenizer, options,
            n_text_ctx=self.target.dims.n_text_ctx,
            sample_len=options.sample_len,
        )
        cfg = _StaticConfig(
            n_head=self.target.dims.n_text_head,
            n_text_ctx=self.target.dims.n_text_ctx,
            n_head_audio=self.target.dims.n_audio_head,
            eot=tokenizer.eot,
            sot_index=initial.index(tokenizer.sot),
            no_speech_token=tokenizer.no_speech,
            timestamp_begin=tokenizer.timestamp_begin,
            no_timestamps=tokenizer.no_timestamps,
            sample_len=min(sample_len, self.target.dims.n_text_ctx - len(initial)),
            max_initial_timestamp_index=(
                round(options.max_initial_timestamp / 0.02)
                if options.max_initial_timestamp is not None
                else None
            ),
            suppress_blank=options.suppress_blank,
            blank_tokens=tuple(tokenizer.encode(" ")) if options.suppress_blank else (),
            suppress=F.build_suppress_list(
                tokenizer,
                options.suppress_tokens,
                suppress_numerals=options.suppress_numerals,
            ),
            without_timestamps=options.without_timestamps,
            greedy=True,
        )
        d_cfg = dataclasses.replace(
            cfg,
            n_head=self.draft.dims.n_text_head,
            n_text_ctx=self.draft.dims.n_text_ctx,
            n_head_audio=self.draft.dims.n_audio_head,
        )
        return tokenizer, initial, cfg, d_cfg

    @torch.inference_mode()
    def decode(
        self,
        mel: torch.Tensor,  # [T, n_mels]
        options: DecodingOptions = DecodingOptions(),
        tokenizer=None,
    ) -> DecodingResult:
        """The host loop: one row, draft and verify passes at Python int
        offsets, the acceptance on the host."""
        tokenizer, initial, cfg, d_cfg = self._configs(options, tokenizer)
        n_init = len(initial)
        target, draft = self.target, self.draft

        mel_b = mel[None]
        t_feats = encoder_forward(target.encoder, mel_b.to(target.dtype), target.dims.n_audio_head)
        d_feats = encoder_forward(draft.encoder, mel_b.to(draft.dtype), draft.dims.n_audio_head)
        t_cross = precompute_cross_kv(target.decoder, t_feats, cfg.n_head)
        d_cross = precompute_cross_kv(draft.decoder, d_feats, d_cfg.n_head)
        t_cache = KVCache(*init_kv_cache_like(target, 1, cfg, n_init=n_init), *t_cross)
        d_cache = KVCache(*init_kv_cache_like(draft, 1, d_cfg, n_init=n_init), *d_cross)

        def t_step(tokens, offset):
            toks = torch.tensor([tokens], dtype=torch.int64, device=mel.device)
            return decoder_forward(target.decoder, toks, t_cache, offset, cfg.n_head)

        def d_step(tokens, offset):
            toks = torch.tensor([tokens], dtype=torch.int64, device=mel.device)
            return decoder_forward(draft.decoder, toks, d_cache, offset, d_cfg.n_head)[:, -1]

        init_arr = torch.tensor([initial], dtype=torch.int64, device=mel.device)
        masks = _filter_masks(cfg, target.dims.n_vocab, mel.device)  # the draft's too
        t_logits = t_step(initial, 0)
        d_last_logits = d_step(initial, 0)
        no_speech_prob = float(
            torch.softmax(t_logits[0, cfg.sot_index].float(), -1)[cfg.no_speech_token]
        )

        tokens: list = []
        sum_logprob = 0.0
        state = F.init_filter_state(init_arr)
        last_target_logits = t_logits[:, -1]

        while len(tokens) < cfg.sample_len:
            # --- the draft proposes gamma tokens -------------------------
            draft_tokens = []
            d_state, d_last = state, d_last_logits
            cur = len(tokens)
            for g in range(self.gamma):
                if cur + g >= cfg.sample_len:
                    break
                tok = int(torch.argmax(_apply_filters(d_last, d_state, d_cfg, *masks)[0]))
                draft_tokens.append(tok)
                d_state = F.update_filter_state(
                    d_state, torch.tensor([tok], device=mel.device), cfg.timestamp_begin
                )
                if tok == cfg.eot:
                    break
                d_last = d_step([tok], n_init + cur + g)
            if not draft_tokens:
                break
            self.stats.proposed += len(draft_tokens)

            # --- the target verifies the whole run in one forward --------
            v_logits = t_step(draft_tokens, n_init + len(tokens))
            self.stats.target_steps += 1

            # the target's choice at position j comes from the logits at
            # j-1; position 0 uses last_target_logits
            accepted = 0
            stream = torch.cat([last_target_logits[:, None], v_logits], 1)
            for j, proposed in enumerate(draft_tokens):
                fl = _apply_filters(stream[:, j], state, cfg, *masks)
                t_choice = int(torch.argmax(fl[0]))
                tokens.append(t_choice)
                sum_logprob += float(torch.log_softmax(fl[0], -1)[t_choice])
                state = F.update_filter_state(
                    state, torch.tensor([t_choice], device=mel.device), cfg.timestamp_begin
                )
                if t_choice != proposed or t_choice == cfg.eot:
                    accepted += int(t_choice == proposed)
                    break
                accepted += 1
            self.stats.accepted += accepted

            if tokens and tokens[-1] == cfg.eot:
                tokens.pop()
                break

            # cache consistency: slots at and after a mismatch hold K/V of
            # rejected drafts; masked attention never reads past the offset,
            # and the steps below overwrite the mismatch slot itself.
            # The draft catches up on the accepted tail:
            d_last_logits = d_step([tokens[-1]], n_init + len(tokens) - 1)
            if accepted == len(draft_tokens) and tokens[-1] == draft_tokens[-1]:
                # full acceptance: the verify logits give the next step
                last_target_logits = v_logits[:, accepted - 1]
            else:
                # mismatch: re-run the target on its own choice to repair
                # the cache slot and obtain next-token logits
                last_target_logits = t_step([tokens[-1]], n_init + len(tokens) - 1)[:, -1]

        text = tokenizer.decode(tokens).strip()
        return DecodingResult(
            audio_features=t_feats[0],
            language=options.language or "en",
            tokens=tokens,
            text=text,
            avg_logprob=sum_logprob / (len(tokens) + 1),
            no_speech_prob=no_speech_prob,
            temperature=0.0,
            compression_ratio=compression_ratio(text) if text else float("nan"),
        )

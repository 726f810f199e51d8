"""The port's speculative decoding against the JAX package on the CPU, on
f32 ``test-nano`` with the same weights (carried over through the bridge):
``decoder_forward`` with per-row offsets; the batched loop against JAX's
``_spec_batch_jit`` (tokens, lengths, proposed, accepted and target passes
identical; log-probs within 1e-4, no-speech probabilities within 1e-5) on
both acceptance paths, with a ``self:1`` draft and a draft of other
weights; the host loop against JAX's; the zero-tail target's full
acceptance; and the pipeline's ``draft_model``: the plain pipeline's
segments (``kv_quant=False``) and JAX's, a decoder rebuilt for a call's own
draft, and the beam warning for a per-call draft."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synth_speech
from whisperx_tpu.audio.mel import log_mel_batch as jax_log_mel_batch
from whisperx_tpu.convert.checkpoint import flatten_tree
from whisperx_tpu.decoding import DecodingOptions as JOptions
from whisperx_tpu.decoding import speculative as jspec
from whisperx_tpu.models.whisper import Whisper as JWhisper
from whisperx_tpu.models.whisper import model as jm
from whisperx_tpu.models.whisper.config import MODEL_DIMS
from whisperx_tpu_torch.convert.checkpoint import params_from_numpy
from whisperx_tpu_torch.decoding import DecodingOptions, decode
from whisperx_tpu_torch.decoding import speculative as tspec
from whisperx_tpu_torch.decoding.decode import init_kv_cache_like, _StaticConfig
from whisperx_tpu_torch.models.whisper.model import (
    KVCache,
    decoder_forward,
    encoder_forward,
    precompute_cross_kv,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

DIMS = MODEL_DIMS["test-nano"]


def _pair(seed):
    params = jm.init_params(DIMS, jax.random.PRNGKey(seed), dtype=jnp.float32)
    jmodel = JWhisper(DIMS, params, dtype=jnp.float32, name="test-nano")
    return jmodel, params_from_numpy(flatten_tree(params), DIMS, torch.float32, "cpu")


@pytest.fixture(scope="module")
def models():
    """(JAX, port) test-nano f32 with the same weights; a draft of other
    weights (JAX's ``load_model("test-nano", seed=123)``), carried over."""
    from whisperx_tpu.models.whisper import load_model as jax_load

    jdraft = jax_load("test-nano", seed=123, dtype=jnp.float32)
    tdraft = params_from_numpy(flatten_tree(jdraft.params), DIMS, torch.float32, "cpu")
    return _pair(0), (jdraft, tdraft)


@pytest.fixture(scope="module")
def mels():
    """Two rows of synthetic speech and one of small noise (JAX's own
    speculative tests' input): the draft agrees with the target on more
    tokens of the noise row, so the rows need different numbers of passes."""
    audio = np.stack([synth_speech(30.0, seed=s) for s in (0, 1)])
    speech = np.asarray(jax_log_mel_batch(audio, DIMS.n_mels))
    noise = np.random.default_rng(0).standard_normal((1, 3000, DIMS.n_mels)) * 0.1
    return np.concatenate([speech, noise.astype(np.float32)])


def _cfg(n_head=DIMS.n_text_head):
    return _StaticConfig(
        n_head=n_head, n_head_audio=DIMS.n_audio_head, n_text_ctx=DIMS.n_text_ctx,
        eot=0, sot_index=0, no_speech_token=0, timestamp_begin=0, no_timestamps=0,
        sample_len=24, max_initial_timestamp_index=None, suppress_blank=False,
        blank_tokens=(), suppress=(), without_timestamps=True, greedy=True,
    )


@pytest.mark.parametrize("t_new", [1, 3])
def test_tensor_offset_matches_per_row_int_offsets(models, mels, t_new):
    """``decoder_forward`` with a [B] offset equals B separate calls, one at
    each row's int offset (over the whole batch, so that the products have
    the same shapes), row by row: the logits within 1e-6 and every layer's
    self-K/V cache, the written slots and the rest."""
    (_, model), _ = models
    rng = np.random.default_rng(t_new)
    b, n_prefix = 3, 6
    with torch.inference_mode():
        feats = encoder_forward(model.encoder, torch.tensor(mels), DIMS.n_audio_head)
        cross = precompute_cross_kv(model.decoder, feats, DIMS.n_text_head)
        prefix = torch.from_numpy(rng.integers(0, 50000, (b, n_prefix)))
        tokens = torch.from_numpy(rng.integers(0, 50000, (b, t_new)))
        offsets = torch.tensor([2, 5, 4])[:b]

        def primed():
            self_kv = init_kv_cache_like(model, b, _cfg(), n_init=n_prefix)
            cache = KVCache(*self_kv, *cross)
            decoder_forward(model.decoder, prefix, cache, 0, DIMS.n_text_head)
            return cache

        batched = primed()
        got = decoder_forward(model.decoder, tokens, batched, offsets, DIMS.n_text_head)
        for i in range(b):
            single = primed()
            want = decoder_forward(model.decoder, tokens, single, int(offsets[i]), DIMS.n_text_head)
            np.testing.assert_allclose(got[i].numpy(), want[i].numpy(), atol=1e-6, rtol=0)
            for layer in range(DIMS.n_text_layer):
                for a, w in ((batched.self_k, single.self_k), (batched.self_v, single.self_v)):
                    np.testing.assert_allclose(a[layer][i].numpy(), w[layer][i].numpy(), atol=1e-6, rtol=0)


def _jax_batch(spec, mels, opts):
    handle = spec.decode_batch_dispatch(jnp.asarray(mels), opts)
    buf, n, sum_lp, nsp, prop, acc, tp = (np.asarray(x) for x in handle["device"])
    return buf[:, 0], n, sum_lp, nsp, prop, acc, tp


def _port_batch(spec, mels, opts):
    handle = spec.decode_batch_dispatch(torch.tensor(mels), opts)
    return tuple(x.numpy() for x in handle["device"])


CASES = {
    # (draft, γ, without_timestamps)
    "self:1, timestamps": ("self:1", 2, False),
    "self:1, without_timestamps": ("self:1", 2, True),
    "other weights, timestamps": ("other", 3, False),
    "other weights, without_timestamps": ("other", 4, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batched_loop_matches_jax(models, mels, case):
    """The port's batched loop against JAX's ``_spec_batch_jit`` (a vmap of
    the B=1 while loop): the same tokens buffer, lengths, proposed, accepted
    and target passes per row; each row token-identical to the port's plain
    greedy decode with the cross-KV unquantized. Both acceptance paths:
    the γ+1-step filter-state loop (timestamps on) and the vectorised one."""
    ((jmodel, tmodel), (jdraft, tdraft)) = models
    draft, gamma, wt = CASES[case]
    if draft == "self:1":
        jd, td = jspec.truncated_self_draft(jmodel, 1), tspec.truncated_self_draft(tmodel, 1)
    else:
        jd, td = jdraft, tdraft
    kw = dict(language="en", sample_len=24, without_timestamps=wt)
    want = _jax_batch(jspec.SpeculativeDecoder(jmodel, jd, gamma), mels, JOptions(**kw))
    tdec = tspec.SpeculativeDecoder(tmodel, td, gamma)
    got = _port_batch(tdec, mels, DecodingOptions(**kw))
    names = ("tokens", "n", "sum_logprob", "no_speech_prob", "proposed", "accepted", "passes")
    for name, g, w in zip(names, got, want):
        if name == "sum_logprob":
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
        elif name == "no_speech_prob":
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[4].sum() > 0 and got[6].min() >= 1
    greedy = decode(tmodel, torch.tensor(mels), DecodingOptions(**kw, kv_quant=False))
    results = tdec.decode_batch_finalize(tdec.decode_batch_dispatch(torch.tensor(mels), DecodingOptions(**kw)))
    assert [r.tokens for r in results] == [r.tokens for r in greedy]


def test_rows_finish_at_different_steps(models, mels):
    """Rows that accept different counts run different numbers of target
    passes: the rows finished first are frozen while the others go on, and
    every row still equals JAX's and the greedy decode's tokens."""
    ((jmodel, tmodel), _) = models
    kw = dict(language="en", sample_len=24)
    jd, td = jspec.truncated_self_draft(jmodel, 1), tspec.truncated_self_draft(tmodel, 1)
    want = _jax_batch(jspec.SpeculativeDecoder(jmodel, jd, 2), mels, JOptions(**kw))
    got = _port_batch(tspec.SpeculativeDecoder(tmodel, td, 2), mels, DecodingOptions(**kw))
    passes = got[6]
    assert len(set(passes.tolist())) > 1, passes
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    for i in range(len(mels)):  # each row decoded alone: the same row
        alone = _port_batch(tspec.SpeculativeDecoder(tmodel, td, 2), mels[i : i + 1], DecodingOptions(**kw))
        for g, a in zip(got, alone):
            np.testing.assert_allclose(g[i], a[0], atol=1e-5, rtol=0)


def test_host_loop_and_single_row_match_jax(models, mels):
    """``decode`` (the host loop) and ``decode_jit`` (the batched loop at
    B=1) give JAX's tokens and stats."""
    ((jmodel, tmodel), (jdraft, tdraft)) = models
    kw = dict(language="en", sample_len=12)
    for method in ("decode", "decode_jit"):
        j = jspec.SpeculativeDecoder(jmodel, jdraft, 3)
        t = tspec.SpeculativeDecoder(tmodel, tdraft, 3)
        jr = getattr(j, method)(jnp.asarray(mels[1]), JOptions(**kw))
        tr = getattr(t, method)(torch.from_numpy(mels[1]), DecodingOptions(**kw))
        assert tr.tokens == jr.tokens and tr.tokens, method
        assert (t.stats.proposed, t.stats.accepted, t.stats.target_steps) == (
            j.stats.proposed, j.stats.accepted, j.stats.target_steps
        ), method
        np.testing.assert_allclose(tr.avg_logprob, jr.avg_logprob, atol=1e-5)
        np.testing.assert_allclose(tr.no_speech_prob, jr.no_speech_prob, atol=1e-5)


@pytest.mark.parametrize("without_timestamps", [False, True])
def test_zero_tail_target_accepts_every_draft(models, mels, without_timestamps):
    """``zero_tail_model`` makes the layers past the first exact identities,
    so its ``self:1`` draft agrees everywhere: with a budget of whole
    iterations (3 × (γ+1) tokens, no EOT), every proposal is accepted; the
    tokens are the zero-tail model's greedy ones and JAX's."""
    ((jmodel, tmodel), _) = models
    gamma = 4
    kw = dict(language="en", sample_len=3 * (gamma + 1), without_timestamps=without_timestamps)
    jt, tt = jspec.zero_tail_model(jmodel, 1), tspec.zero_tail_model(tmodel, 1)
    assert tt.decoder.blocks[0] is tmodel.decoder.blocks[0]
    assert tt.decoder.blocks[1] is not tmodel.decoder.blocks[1]
    assert float(tt.decoder.blocks[1].mlp2.w.abs().max()) == 0.0
    assert float(tmodel.decoder.blocks[1].mlp2.w.abs().max()) > 0.0  # untouched
    spec = tspec.SpeculativeDecoder(tt, tspec.truncated_self_draft(tt, 1), gamma)
    got = _port_batch(spec, mels, DecodingOptions(**kw))
    want = _jax_batch(jspec.SpeculativeDecoder(jt, jspec.truncated_self_draft(jt, 1), gamma), mels, JOptions(**kw))
    np.testing.assert_array_equal(got[0], want[0])
    assert (got[1] == kw["sample_len"]).all(), got[1]
    np.testing.assert_array_equal(got[5], got[4])  # accepted == proposed
    assert (got[6] == 3).all()
    greedy = decode(tt, torch.tensor(mels), DecodingOptions(**kw, kv_quant=False))
    assert [list(r[: kw["sample_len"]]) for r in got[0]] == [r.tokens for r in greedy]


def test_self_draft_shares_the_targets_cross_kv(models, mels, monkeypatch):
    """A ``self:N`` draft is the target's encoder and first N blocks (the
    same modules), so the encoder runs once and the draft reads the first N
    layers of the target's cross-KV (the same values) instead of computing
    its own; a draft of other weights computes its own."""
    ((_, tmodel), (_, tdraft)) = models
    draft = tspec.truncated_self_draft(tmodel, 1)
    assert draft.encoder is tmodel.encoder and draft.decoder.blocks[0] is tmodel.decoder.blocks[0]
    assert draft.dims.n_text_layer == 1 and tmodel.dims.n_text_layer == DIMS.n_text_layer
    calls = {"encoder": 0, "cross": 0}
    real_enc, real_cross = tspec.encoder_forward, tspec.precompute_cross_kv

    def enc(*a, **kw):
        calls["encoder"] += 1
        return real_enc(*a, **kw)

    def cross(*a, **kw):
        calls["cross"] += 1
        return real_cross(*a, **kw)

    monkeypatch.setattr(tspec, "encoder_forward", enc)
    monkeypatch.setattr(tspec, "precompute_cross_kv", cross)
    opts = DecodingOptions(language="en", sample_len=8)
    assert tspec.shares_cross_kv(tmodel, draft) and not tspec.shares_cross_kv(tmodel, tdraft)
    tspec.SpeculativeDecoder(tmodel, draft, 2).decode_batch_dispatch(torch.tensor(mels), opts)
    assert calls == {"encoder": 1, "cross": 1}
    tspec.SpeculativeDecoder(tmodel, tdraft, 2).decode_batch_dispatch(torch.tensor(mels), opts)
    assert calls == {"encoder": 3, "cross": 3}


@pytest.fixture(scope="module")
def pipelines(models):
    """JAX and port pipelines on the same weights and the energy VAD."""
    from whisperx_tpu.asr import TranscriptionPipeline as JPipeline
    from whisperx_tpu.vad import EnergyVAD as JEnergy
    from whisperx_tpu_torch.asr import TranscriptionPipeline
    from whisperx_tpu_torch.vad import EnergyVAD

    ((jmodel, tmodel), _) = models
    common = {"temperatures": (0.0,), "sample_len": 16, "kv_quant": False}
    return (
        lambda **o: JPipeline(model=jmodel, vad_model=JEnergy(), asr_options={**common, **o}, language="en"),
        lambda **o: TranscriptionPipeline(model=tmodel, vad_model=EnergyVAD(), asr_options={**common, **o}, language="en"),
    )


@pytest.mark.parametrize("draft", ["self:1", "other"])
def test_pipeline_segments_match_plain_and_jax(models, pipelines, draft):
    """``asr_options={"draft_model": ...}``: the plain pipeline's segments
    (cross-KV unquantized, as the speculative path runs it) and the JAX
    pipeline's; the acceptance counts reach the metrics tracker, real rows
    only, as JAX's."""
    from whisperx_tpu.utils.metrics import GLOBAL_TRACKER as JTRACKER
    from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER

    jpipe, tpipe = pipelines
    ((_, _), (jdraft, tdraft)) = models
    audio = synth_speech(45.0, seed=3)
    opts = {"spec_gamma": 2}
    jd, td = (draft, draft) if draft == "self:1" else (jdraft, tdraft)
    plain = tpipe().transcribe(audio, batch_size=2)
    JTRACKER.reset()
    want = jpipe(draft_model=jd, **opts).transcribe(audio, batch_size=2)
    GLOBAL_TRACKER.reset()
    pipe = tpipe(draft_model=td, **opts)
    got = pipe.transcribe(audio, batch_size=2)
    assert got == plain == want and got["segments"]
    for key in ("spec_proposed", "spec_accepted", "spec_target_passes"):
        assert GLOBAL_TRACKER.counters[key] == JTRACKER.counters[key], key
    assert GLOBAL_TRACKER.counters["spec_target_passes"] > 0


def test_per_call_draft_rebuilds_the_decoder_and_drops_beam(models, pipelines):
    """A divergence from the reference, named (ADVICE r5, asr.py:268): JAX
    caches the first SpeculativeDecoder it builds, so a later call with
    another ``draft_model`` or ``spec_gamma`` reuses a stale one, and a
    per-call draft with a configured ``beam_size`` silently never
    speculates. The port rebuilds the decoder when a call's draft or gamma
    differ, and a per-call draft gets the constructor's warning and drops
    beam for that call (the pipeline's options stay as they were)."""
    from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER

    _, tpipe = pipelines
    audio = synth_speech(12.0, seed=4)
    pipe = tpipe(draft_model="self:1", spec_gamma=2)
    first = pipe.transcribe(audio)
    spec1 = pipe._spec_decoder[1]
    assert spec1.draft.dims.n_text_layer == 1 and spec1.gamma == 2
    assert pipe.transcribe(audio) == first and pipe._spec_decoder[1] is spec1  # cached
    again = pipe.transcribe(audio, draft_model="self:2", spec_gamma=3)
    spec2 = pipe._spec_decoder[1]
    assert spec2 is not spec1 and spec2.draft.dims.n_text_layer == 2 and spec2.gamma == 3
    assert again == first  # token-identical whatever the draft

    beam = tpipe(beam_size=2)
    assert beam.asr_options["beam_size"] == 2
    GLOBAL_TRACKER.reset()
    with pytest.warns(UserWarning, match="greedy-only; ignoring beam_size=2"):
        out = beam.transcribe(audio, draft_model="self:1")
    assert GLOBAL_TRACKER.counters["spec_target_passes"] > 0  # it speculated
    assert out == first and beam.asr_options["beam_size"] == 2
    with pytest.warns(UserWarning, match="greedy-only; ignoring beam_size=5"):
        constructed = tpipe(beam_size=5, draft_model="self:1")
    assert constructed.asr_options["beam_size"] is None

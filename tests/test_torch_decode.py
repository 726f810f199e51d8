"""The port's decoding against the JAX package on the CPU: each logit filter
on random f32 logits and states, greedy decode tokens on f32 ``test-nano``
(timestamps and int8 cross-KV on and off), language detection, and
temperature sampling by its properties (the two frameworks' RNGs differ)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synth_speech
from whisperx_tpu.audio.mel import log_mel_batch as jax_log_mel_batch
from whisperx_tpu.convert.checkpoint import flatten_tree
from whisperx_tpu.decoding import DecodingOptions as JOptions
from whisperx_tpu.decoding import decode as jax_decode
from whisperx_tpu.decoding import detect_language as jax_detect
from whisperx_tpu.decoding import filters as JF
from whisperx_tpu.decoding.tokenizer import get_tokenizer as jax_tokenizer
from whisperx_tpu.models.whisper import Whisper as JWhisper
from whisperx_tpu.models.whisper import model as jm
from whisperx_tpu.models.whisper.config import MODEL_DIMS
from whisperx_tpu_torch.convert.checkpoint import params_from_numpy
from whisperx_tpu_torch.decoding import DecodingOptions, decode, detect_language
from whisperx_tpu_torch.decoding import filters as TF
from whisperx_tpu_torch.decoding.decode import decode_dispatch
from whisperx_tpu_torch.decoding.tokenizer import get_tokenizer
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

DIMS = MODEL_DIMS["test-nano"]


@pytest.fixture(scope="module")
def tokenizers():
    kw = dict(num_languages=DIMS.num_languages, language="en", vocab_path="byte-fallback")
    return jax_tokenizer(True, **kw), get_tokenizer(True, **kw)


@pytest.fixture(scope="module")
def models():
    params = jm.init_params(DIMS, jax.random.PRNGKey(0), dtype=jnp.float32)
    jmodel = JWhisper(DIMS, params, dtype=jnp.float32, name="test-nano")
    tmodel = params_from_numpy(flatten_tree(params), DIMS, torch.float32, "cpu")
    return jmodel, tmodel


@pytest.fixture(scope="module")
def mels():
    audio = np.stack([synth_speech(30.0, seed=s) for s in (0, 1)])
    return np.asarray(jax_log_mel_batch(audio, DIMS.n_mels))


def _states(rng, b, step, ts_begin):
    last = rng.integers(ts_begin - 40, ts_begin + 40, b)
    penult = rng.integers(ts_begin - 40, ts_begin + 40, b)
    last_ts = rng.integers(ts_begin, ts_begin + 60, b)
    has_ts = rng.random(b) < 0.5
    jstate = JF.FilterState(
        jnp.asarray(last, jnp.int32), jnp.asarray(penult, jnp.int32),
        jnp.asarray(last_ts, jnp.int32), jnp.asarray(has_ts), jnp.int32(step),
    )
    tstate = TF.FilterState(
        torch.from_numpy(last), torch.from_numpy(penult),
        torch.from_numpy(last_ts), torch.from_numpy(has_ts), step,
    )
    return jstate, tstate


@pytest.mark.parametrize("step", [0, 1, 2, 5])
def test_filters_match_jax(tokenizers, step):
    jtok, ttok = tokenizers
    rng = np.random.default_rng(step)
    logits = (3 * rng.standard_normal((6, DIMS.n_vocab))).astype(np.float32)
    jstate, tstate = _states(rng, 6, step, jtok.timestamp_begin)
    blank = tuple(jtok.encode(" "))
    suppress = JF.build_suppress_list(jtok, "-1")
    assert TF.build_suppress_list(ttok, "-1") == suppress
    cases = [
        (
            JF.suppress_blank(jnp.asarray(logits), jstate, blank, jtok.eot),
            TF.suppress_blank(
                torch.from_numpy(logits), tstate, TF._id_mask(DIMS.n_vocab, blank + (ttok.eot,), "cpu")
            ),
        ),
        (
            JF.suppress_tokens(jnp.asarray(logits), suppress),
            TF.suppress_tokens(torch.from_numpy(logits), TF._id_mask(DIMS.n_vocab, suppress, "cpu")),
        ),
    ]
    for max_init in (None, 50):
        kw = dict(
            timestamp_begin=jtok.timestamp_begin, eot=jtok.eot,
            no_timestamps=jtok.no_timestamps, max_initial_timestamp_index=max_init,
        )
        cases.append(
            (
                JF.apply_timestamp_rules(jnp.asarray(logits), jstate, **kw),
                TF.apply_timestamp_rules(torch.from_numpy(logits), tstate, **kw),
            )
        )
    for want, got in cases:
        want = np.asarray(want)
        got = got.numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        finite = np.isfinite(want)
        np.testing.assert_array_equal(got[finite], want[finite])


def test_filter_state_update_matches_jax(tokenizers):
    jtok, _ = tokenizers
    rng = np.random.default_rng(9)
    init = rng.integers(0, jtok.timestamp_begin + 100, (4, 3))
    js = JF.init_filter_state(jnp.asarray(init, jnp.int32))
    ts = TF.init_filter_state(torch.from_numpy(init))
    for _ in range(3):
        sampled = rng.integers(jtok.timestamp_begin - 5, jtok.timestamp_begin + 5, 4)
        js = JF.update_filter_state(js, jnp.asarray(sampled, jnp.int32), jtok.timestamp_begin)
        ts = TF.update_filter_state(ts, torch.from_numpy(sampled), jtok.timestamp_begin)
    for a, b in zip(js[:4], ts[:4]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert ts.step == int(js.step) == 3


def test_numeral_tokens_match_jax():
    jtok = jax_tokenizer(True, num_languages=DIMS.num_languages, vocab_path="gold-partial")
    ttok = get_tokenizer(True, num_languages=DIMS.num_languages, vocab_path="gold-partial")
    assert TF.numeral_tokens(ttok) == JF.numeral_tokens(jtok)
    assert len(TF.numeral_tokens(ttok)) > 0


@pytest.mark.parametrize("without_timestamps", [False, True])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_greedy_tokens_match_jax(models, mels, tokenizers, without_timestamps, kv_quant):
    """Random weights never emit EOT, so every row runs all 224 steps: a long
    run of argmax decisions, each of which must agree."""
    jmodel, tmodel = models
    jtok, ttok = tokenizers
    kw = dict(language="en", kv_quant=kv_quant, without_timestamps=without_timestamps)
    want = jax_decode(jmodel, jnp.asarray(mels), JOptions(**kw), tokenizer=jtok)
    got = decode(tmodel, torch.from_numpy(mels), DecodingOptions(**kw), tokenizer=ttok)
    for w, g in zip(want, got):
        assert g.tokens == w.tokens
        assert g.text == w.text
        np.testing.assert_allclose(g.avg_logprob, w.avg_logprob, rtol=1e-4)
        np.testing.assert_allclose(g.no_speech_prob, w.no_speech_prob, rtol=1e-4, atol=1e-7)


def test_detect_language_matches_jax(models, mels, tokenizers):
    jmodel, tmodel = models
    jtok, ttok = tokenizers
    want_codes, want_probs = jax_detect(jmodel, jnp.asarray(mels), jtok)
    got_codes, got_probs = detect_language(tmodel, torch.from_numpy(mels), ttok)
    assert got_codes == want_codes
    for w, g in zip(want_probs, got_probs):
        assert set(g) == set(w)
        np.testing.assert_allclose(
            [g[c] for c in sorted(g)], [w[c] for c in sorted(w)], atol=1e-6, rtol=1e-4
        )


def test_decode_detects_language_when_unset(models, mels, tokenizers):
    """No language: the shared-features path encodes once, detects, and the
    tokens still match JAX's."""
    jmodel, tmodel = models
    jtok, ttok = tokenizers
    want = jax_decode(jmodel, jnp.asarray(mels), JOptions(), tokenizer=jtok)
    got = decode(tmodel, torch.from_numpy(mels), DecodingOptions(), tokenizer=ttok)
    assert [g.language for g in got] == [w.language for w in want]
    assert [g.tokens for g in got] == [w.tokens for w in want]


def test_temperature_sampling_properties(models, mels, tokenizers):
    """T > 0 draws only tokens the filters allow, and a generator seed fixes
    the draw. The first token is a timestamp ≤ max_initial_timestamp; no
    suppressed token appears; timestamps never decrease."""
    _, tmodel = models
    _, ttok = tokenizers
    opts = DecodingOptions(language="en", temperature=0.8, sample_len=40)
    runs = [
        decode(
            tmodel, torch.from_numpy(mels), opts, tokenizer=ttok,
            generator=torch.Generator().manual_seed(seed),
        )
        for seed in (1, 1, 2)
    ]
    assert [r.tokens for r in runs[0]] == [r.tokens for r in runs[1]]
    assert [r.tokens for r in runs[0]] != [r.tokens for r in runs[2]]
    suppressed = set(TF.build_suppress_list(ttok, "-1"))
    ts0 = ttok.timestamp_begin
    for result in runs[0] + runs[2]:
        toks = result.tokens
        assert toks and ts0 <= toks[0] <= ts0 + 50
        assert not suppressed & set(toks)
        assert all(t < DIMS.n_vocab and t != ttok.no_timestamps for t in toks)
        stamps = [t for t in toks if t >= ts0]
        assert stamps == sorted(stamps)
        assert np.isfinite(result.avg_logprob) and result.temperature == 0.8


def test_sampling_needs_a_generator_and_beam_search_is_later(models, mels):
    """Sampling without a generator raises. Beam search, once a later item,
    now runs at temperature 0 (``decoding/beam.py``; its parity with JAX is
    in ``test_torch_beam.py``)."""
    _, tmodel = models
    mel = torch.from_numpy(mels[:1])
    with pytest.raises(ValueError, match="generator"):
        decode_dispatch(tmodel, mel, DecodingOptions(language="en", temperature=0.5))
    handle = decode_dispatch(
        tmodel, mel, DecodingOptions(language="en", beam_size=2, sample_len=4)
    )
    assert "beam_device" in handle and handle["steps"] == 4


def test_best_of_keeps_the_best_candidate_per_row(models, mels, tokenizers):
    """best_of=3 tiles each row into 3 independent samples and keeps the one
    with the highest sum_logprob / (length + 1)."""
    from whisperx_tpu_torch.decoding.decode import decode_finalize

    _, tmodel = models
    _, ttok = tokenizers
    opts = DecodingOptions(language="en", temperature=1.0, best_of=3, sample_len=16)
    handle = decode_dispatch(
        tmodel, torch.from_numpy(mels), opts, tokenizer=ttok,
        generator=torch.Generator().manual_seed(0),
    )
    toks, lengths, sum_lp = (t.numpy() for t in handle["device"][:3])
    assert toks.shape == (3 * mels.shape[0], 16)
    got = decode_finalize(handle)
    assert len(got) == mels.shape[0]
    for i, r in enumerate(got):
        rows = range(3 * i, 3 * i + 3)
        best = max(rows, key=lambda j: sum_lp[j] / (lengths[j] + 1))
        assert r.tokens == toks[best, : lengths[best]].tolist()


@pytest.fixture
def span_records():
    from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER

    GLOBAL_TRACKER.reset()
    GLOBAL_TRACKER.record_spans()
    yield GLOBAL_TRACKER
    GLOBAL_TRACKER.record_spans(None)
    GLOBAL_TRACKER.reset()


@pytest.mark.parametrize("beam_size", [None, 2], ids=["greedy", "beam"])
def test_decode_parts_are_spans_inside_decode(models, mels, tokenizers, span_records, tmp_path, beam_size):
    """``decode.encoder``, ``decode.prefill``, ``decode.steps`` and
    ``decode.readback`` are records inside the caller's ``decode`` span,
    with its id; their host time is at most the parent's and at least 90%
    of it; every step ran through the step runner (``step_replays``), whose
    pairs lie inside the loop; on the CPU the device time is the host's."""
    import json

    tracker = span_records
    _, tmodel = models
    _, ttok = tokenizers
    mel = torch.from_numpy(mels[:1])
    opts = DecodingOptions(language="en", sample_len=16, beam_size=beam_size, without_timestamps=True)
    decode(tmodel, mel, opts, tokenizer=ttok)  # first-call costs stay out of the reading
    tracker.reset()
    from whisperx_tpu_torch.decoding.decode import decode_finalize

    with tracker.track("decode"):
        handle = decode_dispatch(tmodel, mel, opts, tokenizer=ttok)
        decode_finalize(handle)
    parts = ("decode.encoder", "decode.prefill", "decode.steps", "decode.readback")
    report = tracker.report()
    assert all(report[p]["parent"] == "decode" and report[p]["calls"] == 1 for p in parts)
    assert report["decode"]["parent"] is None
    host = sum(report[p]["total_s"] for p in parts)
    assert 0.9 * report["decode"]["total_s"] <= host <= report["decode"]["total_s"]
    c = tracker.counters
    assert c["step_replays"] == handle["steps"] == 16
    assert 0 < c["step_replay_device_s"] <= c["step_loop_device_s"] <= c["decode.steps.device_s"]
    for p in parts[:3]:
        assert 0 < c[p + ".device_s"] <= report[p]["total_s"]

    path = str(tmp_path / "spans.json")
    assert tracker.write_spans(path) == 5
    events = {e["name"]: e for e in json.load(open(path))["traceEvents"]}
    outer = events["decode"]
    for p in parts:
        e = events[p]
        assert e["args"]["parent"] == outer["args"]["span"] and e["args"]["id"] == outer["args"]["id"]
        assert outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]

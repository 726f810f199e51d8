"""The port's sequential seek loop against the JAX package's on the CPU:
``decoding/transcribe.py::transcribe`` on f32 ``test-nano`` (with and without
a prompt, conditioning on and off, a temperature ladder, no-speech
skipping), the pipeline without a VAD and with ``backend="sequential"``,
``load_backend``, the learned micro checkpoint in f32 and bf16, word
timing with and without the hallucination-silence threshold, and the
hallucination helpers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synth_speech
from whisperx_tpu.convert.checkpoint import flatten_tree, save_checkpoint
from whisperx_tpu.decoding import transcribe as jt
from whisperx_tpu.models.whisper import Whisper as JWhisper
from whisperx_tpu.models.whisper import model as jm
from whisperx_tpu.models.whisper.config import MODEL_DIMS
from whisperx_tpu_torch.convert.checkpoint import params_from_numpy
from whisperx_tpu_torch.decoding import transcribe as tt
from test_torch_learned_e2e import files, micro_ckpt  # noqa: F401 (fixtures)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

DIMS = MODEL_DIMS["test-nano"]
SAME = ("id", "seek", "start", "end", "text", "tokens", "temperature")


@pytest.fixture(scope="module")
def params():
    return jm.init_params(DIMS, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def models(params):
    jmodel = JWhisper(DIMS, params, dtype=jnp.float32, name="test-nano")
    return jmodel, params_from_numpy(flatten_tree(params), DIMS, torch.float32, "cpu")


@pytest.fixture(scope="module")
def nano_ckpt(params, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("nano_seq"))
    save_checkpoint(
        path, params,
        {"name": "test-nano", "family": "whisper", "dims": dataclasses.asdict(DIMS)},
    )
    return path


@pytest.fixture(scope="module")
def speech():
    """~40 s: two windows at least, with the seek advancing mid-window."""
    return np.concatenate([synth_speech(25.0, seed=4), synth_speech(15.0, seed=5)])


def assert_same_transcript(got, want):
    assert got["language"] == want["language"]
    assert got["text"] == want["text"]
    assert len(got["segments"]) == len(want["segments"])
    for g, w in zip(got["segments"], want["segments"]):
        assert {k: g[k] for k in SAME} == {k: w[k] for k in SAME}
        np.testing.assert_allclose(g["avg_logprob"], w["avg_logprob"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(g["no_speech_prob"], w["no_speech_prob"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(g["compression_ratio"], w["compression_ratio"], rtol=1e-6)


CASES = {
    "conditioned": dict(),
    "prompt": dict(initial_prompt="hello there"),
    "prompt, not conditioned": dict(initial_prompt="hello there", condition_on_previous_text=False),
    # T = 1e-6 (the decoders' floor): sampling that both packages' samplers
    # resolve to the argmax, so the ladder's second rung is comparable;
    # random weights fail the log-prob gate, so every window climbs it
    "ladder": dict(temperature=(0.0, 1e-6)),
    "language detected": dict(language=None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_seek_loop_matches_jax(models, speech, case):
    kw = dict(language="en", sample_len=24, temperature=0.0)
    kw.update(CASES[case])
    jmodel, tmodel = models
    want = jt.transcribe(jmodel, speech, **kw)
    got = tt.transcribe(tmodel, speech, **kw)
    assert_same_transcript(got, want)
    assert got["segments"] and len({s["seek"] for s in got["segments"]}) >= 2
    if case == "ladder":
        assert {s["temperature"] for s in got["segments"]} == {1e-6}


def test_no_speech_windows_are_skipped_as_in_jax(models, speech, monkeypatch):
    """A no-speech threshold below every window's no-speech probability,
    with the log-prob gate failing (random weights): every window is
    skipped whole, by both packages, after one decode each."""
    jmodel, tmodel = models
    kw = dict(language="en", sample_len=8, temperature=(0.0, 0.5), no_speech_threshold=0.0)
    calls = []
    real = tt.decode
    monkeypatch.setattr(tt, "decode", lambda *a, **k: calls.append(k) or real(*a, **k))
    got = tt.transcribe(tmodel, speech, **kw)
    want = jt.transcribe(jmodel, speech, **kw)
    assert got == want == {"text": "", "segments": [], "language": "en"}
    n_windows = -(-len(speech) // 160 // 3000)
    assert len(calls) == n_windows  # silence never climbs the ladder
    # a threshold of 1 skips nothing
    kw["no_speech_threshold"] = 1.0
    kw["temperature"] = 0.0
    assert_same_transcript(tt.transcribe(tmodel, speech, **kw), jt.transcribe(jmodel, speech, **kw))


def test_word_timestamps_raise_and_the_silence_threshold_warns(models, speech):
    """Word timing in the seek loop is ported: the same segments, seeks and
    words (text, start, end; probabilities within 1e-6) as JAX's, also with
    the hallucination-silence threshold, whose skips and evictions re-seek
    the loop. Without word timestamps the threshold still warns and is
    ignored."""
    jmodel, tmodel = models
    for threshold in (None, 1.0):
        kw = dict(language="en", sample_len=24, temperature=0.0, word_timestamps=True,
                  hallucination_silence_threshold=threshold)
        want = jt.transcribe(jmodel, speech, **kw)
        got = tt.transcribe(tmodel, speech, **kw)
        assert_same_transcript(got, want)
        words = [[(w["word"], w["start"], w["end"]) for w in s["words"]] for s in got["segments"]]
        assert words == [
            [(w["word"], w["start"], w["end"]) for w in s["words"]] for s in want["segments"]
        ]
        np.testing.assert_allclose(
            [w["probability"] for s in got["segments"] for w in s["words"]],
            [w["probability"] for s in want["segments"] for w in s["words"]], atol=1e-6, rtol=0,
        )
        if threshold is None:
            assert any(words)
    with pytest.warns(UserWarning, match="word_timestamps"):
        tt.transcribe(tmodel, synth_speech(3.0), language="en", sample_len=4,
                      hallucination_silence_threshold=2.0)


def _pipelines(ckpt, **kw):
    import whisperx_tpu
    import whisperx_tpu_torch

    kw = dict(compute_type="float32", **kw)
    return (
        whisperx_tpu.load_model(ckpt, device="cpu", **kw),
        whisperx_tpu_torch.load_model(ckpt, device="cpu", **kw),
    )


@pytest.mark.parametrize("vad_method", ["none", None])
def test_pipeline_without_vad_matches_jax(nano_ckpt, speech, vad_method):
    jpipe, tpipe = _pipelines(nano_ckpt, vad_method=vad_method)
    assert tpipe.vad_model is None
    kw = dict(language="en", temperatures=(0.0,), sample_len=24)
    want = jpipe.transcribe(speech, **kw)
    got = tpipe.transcribe(speech, **kw)
    assert got == want and got["segments"]


def test_backend_sequential_matches_jax(nano_ckpt, speech):
    """Energy VAD, then the seek loop over each merged chunk (the JAX
    package's ``_transcribe_chunks_sequential``), with a prompt."""
    jpipe, tpipe = _pipelines(nano_ckpt, vad_method="energy", backend="sequential")
    assert tpipe.decode_mode == "sequential"
    kw = dict(language="en", temperatures=(0.0,), sample_len=24, initial_prompt="so")
    want = jpipe.transcribe(speech, **kw)
    got = tpipe.transcribe(speech, **kw)
    assert got == want and got["segments"]
    for seg in got["segments"]:
        assert 0.0 <= seg["start"] < seg["end"] <= len(speech) / 16000


@pytest.mark.parametrize("kind", ["batched", "sequential"])
def test_load_backend_matches_jax(nano_ckpt, kind):
    from whisperx_tpu.backends import load_backend as jax_load_backend
    from whisperx_tpu_torch.backends import (
        BatchedTorchBackend,
        SequentialTorchBackend,
        WhisperBackend,
        load_backend,
    )

    opts = {"temperatures": (0.0,), "condition_on_previous_text": False}
    kw = dict(model=nano_ckpt, compute_type="float32", asr_options=opts, language="en")
    jb = jax_load_backend(kind, device="cpu", **kw)
    tb = load_backend(kind, device="cpu", **kw)
    assert isinstance(tb, WhisperBackend)
    assert isinstance(tb, {"batched": BatchedTorchBackend, "sequential": SequentialTorchBackend}[kind])
    assert tb.is_multilingual == jb.is_multilingual
    assert tb.supported_languages == jb.supported_languages
    audio = synth_speech(12.0, seed=6)
    assert tb.transcribe(audio) == jb.transcribe(audio)
    with pytest.raises(ValueError, match="Unknown backend"):
        load_backend("bogus")
    # with word timestamps, both backends keep the words (the same text,
    # starts and ends; probabilities within 1e-6)
    kw["asr_options"] = {**opts, "word_timestamps": True}
    got = load_backend(kind, device="cpu", **kw).transcribe(audio)
    want = jax_load_backend(kind, device="cpu", **kw).transcribe(audio)
    probs = [[w.pop("probability") for s in r["segments"] for w in s["words"]] for r in (got, want)]
    assert got == want and probs[0]
    np.testing.assert_allclose(probs[0], probs[1], atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["batched", "sequential"])
def test_load_backend_loads_through_load_model(nano_ckpt, kind):
    """A backend's model comes from ``asr.load_model``: the same dtype for a
    compute_type, and an unknown compute_type raises there."""
    import torch

    from whisperx_tpu_torch.backends import load_backend

    tb = load_backend(kind, model=nano_ckpt, device="cpu", compute_type="float16")
    assert tb.model is tb.pipeline.model and tb.model.dtype == torch.bfloat16
    assert tb.pipeline.vad_model is None
    with pytest.raises(ValueError, match="unknown compute_type"):
        load_backend(kind, model=nano_ckpt, device="cpu", compute_type="float64")


def test_transcribe_batch_matches_jax(nano_ckpt):
    from whisperx_tpu.backends import load_backend as jax_load_backend
    from whisperx_tpu_torch.backends import load_backend

    kw = dict(model=nano_ckpt, compute_type="float32", language="en",
              asr_options={"temperatures": (0.0,), "sample_len": 16})
    jb, tb = jax_load_backend("batched", device="cpu", **kw), load_backend("batched", device="cpu", **kw)
    segs = [
        {"start": 1.0, "end": 7.0, "audio": synth_speech(6.0, seed=7)},
        {"start": 9.5, "end": 14.0, "audio": synth_speech(4.5, seed=8)},
    ]
    assert tb.transcribe_batch(segs) == jb.transcribe_batch(segs)


@pytest.mark.parametrize("compute_type", ["float32", "bfloat16"])
def test_micro_checkpoint_sequential_byte_identical(micro_ckpt, files, compute_type):
    """Learned weights (``tests/test_torch_learned_e2e.py``'s micro Whisper):
    ``backend="sequential"`` transcripts byte-identical to JAX's, and the
    spoken text."""
    import whisperx_tpu
    import whisperx_tpu_torch
    from whisperx_tpu.train.micro import DEFAULT_CHUNK_SIZE

    kw = dict(device="cpu", compute_type=compute_type, language="en",
              vad_method="energy", backend="sequential")
    jpipe = whisperx_tpu.load_model(micro_ckpt, **kw)
    tpipe = whisperx_tpu_torch.load_model(micro_ckpt, **kw)
    for fi in (0, 11):
        audio, events = files[fi]
        want = jpipe.transcribe(audio, chunk_size=DEFAULT_CHUNK_SIZE)
        got = tpipe.transcribe(audio, chunk_size=DEFAULT_CHUNK_SIZE)
        assert got == want, f"file {fi}"
        # the seek loop keeps each segment's leading space, as upstream
        assert " ".join(s["text"].strip() for s in got["segments"]) == " ".join(
            text.strip() for _, text in events
        )


def _words(rng, n, t0):
    """Seeded synthetic words: probabilities, durations from 20 ms to 3 s
    (some anomalous), punctuation-only words among them."""
    words, t = [], t0
    for _ in range(n):
        dur = float(rng.choice([0.02, 0.1, 0.3, 0.6, 2.5, 3.0]))
        words.append({
            "word": str(rng.choice([" a", " word", ",", ".", " long"])),
            "start": round(t, 2), "end": round(t + dur, 2),
            "probability": float(rng.random()),
        })
        t += dur + float(rng.choice([0.0, 0.1, 1.5, 4.0]))
    return words, t


def _segments(seed):
    rng = np.random.default_rng(seed)
    segs, t = [], float(rng.uniform(0, 5))
    for _ in range(int(rng.integers(1, 7))):
        words, end = _words(rng, int(rng.integers(0, 6)), t)
        segs.append({"start": round(t, 2), "end": round(max(end, t + 0.1), 2), "words": words})
        t = end + float(rng.choice([0.2, 3.0]))
    return segs


@pytest.mark.parametrize("seed", range(8))
def test_hallucination_helpers_match_jax(seed):
    segs = _segments(seed)
    for s in segs:
        for w in s["words"]:
            assert tt._word_anomaly_score(w) == jt._word_anomaly_score(w)
        assert tt._is_segment_anomaly(s) == jt._is_segment_anomaly(s)
    assert tt._next_words_segment(segs) == jt._next_words_segment(segs)
    assert tt._last_word_end(segs) == jt._last_word_end(segs)
    assert tt._is_segment_anomaly(None) is jt._is_segment_anomaly(None) is False
    for keep_tail in (False, True):
        kw = dict(
            threshold=1.0, time_offset=segs[0]["start"], window_end_time=segs[-1]["end"] + 1,
            segment_duration=30.0, last_speech_timestamp=0.0, keep_tail=keep_tail,
        )
        assert tt.evict_surrounded_anomalies(segs, **kw) == jt.evict_surrounded_anomalies(segs, **kw)

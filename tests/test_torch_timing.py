"""The port's word timing against the JAX package's on the CPU: DTW and the
median filter exactly; the captured cross-attention scores within 1e-4;
the same words, starts and ends on test-nano f32 for ``find_alignment``,
``find_alignment_batch`` (groups of ``WHISPERX_TPU_ALIGN_BATCH``) and the
batched attachment; ``merge_punctuations`` and the duration heuristics on
hand-made timings; and ``alignment_heads`` read from a checkpoint."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisperx_tpu.timing as jti
import whisperx_tpu_torch.timing as tti
from whisperx_tpu.convert.checkpoint import flatten_tree, save_checkpoint
from whisperx_tpu.decoding.tokenizer import get_tokenizer as jget_tokenizer
from whisperx_tpu.models.whisper import Whisper as JWhisper
from whisperx_tpu.models.whisper import model as jm
from whisperx_tpu.models.whisper.config import MODEL_DIMS
from whisperx_tpu_torch.convert.checkpoint import params_from_numpy
from whisperx_tpu_torch.decoding.tokenizer import get_tokenizer as tget_tokenizer
from whisperx_tpu_torch.models.whisper import model as tm
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

jdtw = importlib.import_module("whisperx_tpu.timing.dtw")
tdtw = importlib.import_module("whisperx_tpu_torch.timing.dtw")
DIMS = MODEL_DIMS["test-nano"]


@pytest.mark.parametrize(
    "shape", [(1, 1), (3, 1), (1, 7), (7, 13), (40, 300), (33, 257), (120, 1500)]
)
def test_dtw_identical(shape):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(
        tdtw._dtw_cost(x), np.asarray(jdtw._dtw_cost(jnp.asarray(x)))
    )
    for got, want in zip(tdtw.dtw(x), jdtw.dtw(x)):
        np.testing.assert_array_equal(got, want)


def test_dtw_ties_break_as_in_jax():
    """argmin over (diagonal, up, left): on equal costs the earlier move."""
    rng = np.random.default_rng(0)
    for x in (np.zeros((5, 9), np.float32), rng.integers(0, 3, (30, 80)).astype(np.float32)):
        for got, want in zip(tdtw.dtw(x), jdtw.dtw(x)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width", [3, 7])
@pytest.mark.parametrize("frames", [40, 3, 1])
def test_median_filter_identical(width, frames):
    """Also on fewer frames than the pad, where the reflection wraps."""
    y = np.random.default_rng(width).standard_normal((2, 5, frames)).astype(np.float32)
    want = np.asarray(jdtw.median_filter(jnp.asarray(y), width))
    np.testing.assert_array_equal(tdtw.median_filter(torch.from_numpy(y), width).numpy(), want)
    np.testing.assert_array_equal(jti._median_filter_np(y, width), want)


@pytest.fixture(scope="module")
def models():
    params = jm.init_params(DIMS, jax.random.PRNGKey(0), dtype=jnp.float32)
    jmodel = JWhisper(DIMS, params, dtype=jnp.float32, name="test-nano")
    tmodel = params_from_numpy(flatten_tree(params), DIMS, torch.float32, "cpu")
    assert tmodel.alignment_heads == [tuple(h) for h in jmodel.alignment_heads] == [(1, 0), (1, 1)]
    kw = dict(num_languages=DIMS.num_languages, language="en", task="transcribe")
    # a tokenizer warns only when it is built, and both packages memoize
    # them process-wide: build afresh, whatever an earlier module of this
    # worker left cached
    from whisperx_tpu.decoding import tokenizer as jtok
    from whisperx_tpu_torch.decoding import tokenizer as ttok

    jtok._cached_tokenizer.cache_clear()
    ttok._cached_tokenizer.cache_clear()
    with pytest.warns(UserWarning, match="partial"):
        toks = (jget_tokenizer(True, **kw), tget_tokenizer(True, **kw))
    return jmodel, tmodel, toks


def _inputs(tok, n_windows=3, seed=0):
    rng = np.random.default_rng(seed)
    mels = (rng.standard_normal((n_windows, 3000, DIMS.n_mels)) * 0.5).astype(np.float32)
    lists = [
        tok.encode(" Hello world, this is. a \"test\" (of) words!"),
        [int(t) for t in rng.integers(0, 5000, 40)],
        [],
    ][:n_windows]
    return mels, lists


def test_captured_cross_qk_within_1e4(models):
    """The teacher-forced capture: every layer's pre-softmax scores
    (``decoder_forward(capture_cross_qk=True)``) and the alignment heads'
    with P(next token), within 1e-4 of JAX's."""
    jmodel, tmodel, (jtok, ttok) = models
    mels, lists = _inputs(jtok)
    jtokens, jlen = jti._teacher_forced_rows(jtok, lists[:2])
    ttokens, tlen = tti._teacher_forced_rows(ttok, lists[:2], "cpu")
    assert tlen == jlen and ttokens.shape == (2, 64)
    np.testing.assert_array_equal(ttokens.numpy(), np.asarray(jtokens))
    jp, jq = jti._capture_cross_qk(jmodel, jtokens, jnp.asarray(mels[:2]), jtok.eot)
    tp, tq = tti._capture_cross_qk(tmodel, ttokens, torch.from_numpy(mels[:2]), ttok.eot)
    assert tuple(tq.shape) == jq.shape == (2, 2, 64, 1500)
    np.testing.assert_allclose(tq.numpy(), jq, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tp.numpy(), jp, atol=1e-6, rtol=0)

    # every layer and head, as JAX's decoder returns them
    feats = tm.encoder_forward(tmodel.encoder, torch.from_numpy(mels[:2]), DIMS.n_audio_head)
    ck, cv = tm.precompute_cross_kv(tmodel.decoder, feats, DIMS.n_text_head)
    shape = (2, DIMS.n_text_ctx, DIMS.n_text_head, DIMS.n_text_state // DIMS.n_text_head)

    def cache():
        return tm.KVCache([torch.zeros(shape) for _ in range(2)],
                          [torch.zeros(shape) for _ in range(2)], ck, cv)

    logits, qk_all = tm.decoder_forward(
        tmodel.decoder, ttokens, cache(), 0, DIMS.n_text_head, capture_cross_qk=True
    )
    assert tuple(qk_all.shape) == (2, 2, 2, 64, 1500)  # [layer, B, H, L, frames]
    np.testing.assert_allclose(qk_all[1].permute(1, 0, 2, 3).numpy(), jq, atol=1e-4, rtol=0)
    plain = tm.decoder_forward(tmodel.decoder, ttokens, cache(), 0, DIMS.n_text_head)
    torch.testing.assert_close(logits, plain, atol=0, rtol=0)


def _words(alignment):
    return [(w.word, w.tokens, w.start, w.end) for w in alignment]


@pytest.mark.parametrize("group", ["8", "1"])
def test_find_alignment_batch_identical(models, monkeypatch, group):
    """Same words, tokens, starts and ends; probabilities within 1e-6. A
    window without text gets no words. ``WHISPERX_TPU_ALIGN_BATCH=1``
    captures each window alone."""
    monkeypatch.setenv("WHISPERX_TPU_ALIGN_BATCH", group)
    jmodel, tmodel, (jtok, ttok) = models
    mels, lists = _inputs(jtok, seed=1)
    frames = [3000, 1200, 3000]
    want = jti.find_alignment_batch(jmodel, jtok, lists, jnp.asarray(mels), frames)
    got = tti.find_alignment_batch(tmodel, ttok, lists, torch.from_numpy(mels), frames)
    assert [_words(a) for a in got] == [_words(a) for a in want]
    assert len(got[0]) >= 8 and got[2] == []
    for a, b in zip(got, want):
        np.testing.assert_allclose([w.probability for w in a], [w.probability for w in b], atol=1e-6)
    one = tti.find_alignment(tmodel, ttok, lists[0], torch.from_numpy(mels[0]), 3000)
    assert _words(one) == _words(want[0])


def test_batched_attachment_identical(models):
    """``add_word_timestamps_batched`` over two chunks' segments: the same
    words with the same rounded starts and ends, and the same segment
    boundaries after the duration heuristics."""
    jmodel, tmodel, (jtok, ttok) = models
    mels, _ = _inputs(jtok, n_windows=2, seed=2)
    text = [jtok.encode(" One two three."), jtok.encode(" Four, five"), jtok.encode(" six seven!")]
    ts = jtok.timestamp_begin

    def chunks():
        return [
            [{"start": 1.0, "end": 3.2, "seek": 100, "tokens": [ts + 0, *text[0], ts + 110]},
             {"start": 3.2, "end": 6.0, "seek": 100, "tokens": [ts + 110, *text[1], ts + 250]}],
            [{"start": 12.5, "end": 20.0, "seek": 1250, "tokens": [ts, *text[2], ts + 375]}],
        ]

    want, got = chunks(), chunks()
    jti.add_word_timestamps_batched(chunk_segments=want, model=jmodel, tokenizer=jtok,
                                    mels=jnp.asarray(mels), num_frames_list=[500, 750])
    tti.add_word_timestamps_batched(chunk_segments=got, model=tmodel, tokenizer=ttok,
                                    mels=torch.from_numpy(mels), num_frames_list=[500, 750])
    strip = lambda c: [  # noqa: E731
        [(s["start"], s["end"], [(w["word"], w["start"], w["end"]) for w in s["words"]]) for s in segs]
        for segs in c
    ]
    assert strip(got) == strip(want)
    assert sum(len(s["words"]) for segs in got for s in segs) >= 6


def test_merge_punctuations_and_heuristics_identical():
    """Hand-made timings through ``merge_punctuations`` and the duration
    heuristics of ``_attach_word_timings`` (long words at sentence marks,
    the first word's anomaly fix, segment edges)."""

    def timings(mod):
        W = mod.WordTiming
        return [
            W(" \"", [1], 0.0, 0.1, 0.9), W("Hello", [2], 0.1, 2.9, 0.8), W(",", [3], 2.9, 3.0, 0.7),
            W(" world", [4], 3.0, 3.3, 0.6), W(".", [5], 3.3, 5.0, 0.5), W(" (", [6], 5.0, 5.1, 0.4),
            W("Yes", [7], 5.1, 5.4, 0.3), W(")", [8], 5.4, 5.5, 0.2), W(" no", [9], 5.5, 9.0, 0.1),
        ]

    out = {}
    for name, mod in (("jax", jti), ("torch", tti)):
        al = timings(mod)
        segs = [{"start": 0.5, "end": 3.4, "seek": 50}, {"start": 3.4, "end": 8.0, "seek": 50}]
        mod._attach_word_timings(
            segs, [[1, 2, 3, 4, 5], [6, 7, 8, 9]], al,
            tti.PREPEND_PUNCTUATIONS, tti.APPEND_PUNCTUATIONS, 0.0,
        )
        out[name] = (segs, [dataclasses.astuple(t) for t in al])
    assert out["torch"] == out["jax"]
    assert [w["word"] for w in out["torch"][0][0]["words"]] == [" \"Hello,", " world."]


def test_alignment_heads_from_the_checkpoint(tmp_path):
    """A checkpoint's ``alignment_heads`` (a converted model's published
    mask) replace the default of the decoder's upper half."""
    import whisperx_tpu_torch.models.whisper as tw

    params = jm.init_params(DIMS, jax.random.PRNGKey(1), dtype=jnp.float32)
    config = {"name": "test-nano", "family": "whisper", "dims": dataclasses.asdict(DIMS)}
    save_checkpoint(str(tmp_path / "a"), params, config)
    save_checkpoint(str(tmp_path / "b"), params, {**config, "alignment_heads": [[0, 1], [1, 0]]})
    with pytest.warns(UserWarning, match="vocab"):
        assert tw.load_model(str(tmp_path / "a"), device="cpu").alignment_heads == [(1, 0), (1, 1)]
        assert tw.load_model(str(tmp_path / "b"), device="cpu").alignment_heads == [(0, 1), (1, 0)]

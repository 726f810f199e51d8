"""The port's forced alignment against the JAX package's on the CPU: the
trellis and both backtracks exactly on the same emissions; wav2vec2
emissions (base and large layouts, ``TEST_CONFIG`` widths, JAX's
``init_params`` weights carried over through the bridge) within 1e-4 in
f32; ``align()`` end to end with identical words, starts, ends, scores and
char alignments (Punkt and the regex fallback); the padding-bucket fault of
the reference; ``load_align_model``'s search order and metadata; and
``save_checkpoint`` in the JAX package's layout."""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synth_speech
from whisperx_tpu import alignment as jal
from whisperx_tpu.alignment import trellis as jtr
from whisperx_tpu.convert.checkpoint import flatten_tree as jflatten
from whisperx_tpu.convert.checkpoint import load_checkpoint as jload
from whisperx_tpu.convert.checkpoint import save_checkpoint as jsave
from whisperx_tpu.models.wav2vec2 import model as jw2v
from whisperx_tpu_torch import alignment as tal
from whisperx_tpu_torch.alignment import trellis as ttr
from whisperx_tpu_torch.convert.checkpoint import save_checkpoint, wav2vec2_from_numpy
from whisperx_tpu_torch.models import wav2vec2 as tw2v
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

LARGE_TEST = dataclasses.replace(
    jw2v.TEST_CONFIG, do_stable_layer_norm=True, feat_extract_norm="layer"
)


def _emission(T, V, seed):
    logits = np.random.default_rng(seed).standard_normal((T, V)).astype(np.float32)
    return logits - np.log(np.exp(logits).sum(-1, keepdims=True))


TRELLIS_CASES = {
    "plain": (60, 10, [3, 5, 2, 7, 1], 0),
    "wildcards": (80, 12, [3, -1, 2, -1, 1, 4], 1),
    "tight": (9, 8, [1, 2, 3, 4, 5, 6, 7, 1, 2], 2),  # as many tokens as frames
    "one token": (20, 6, [4], 3),
    "blank 5": (50, 9, [1, 2, 2, 3, -1], 4),
}


@pytest.mark.parametrize("case", sorted(TRELLIS_CASES))
def test_trellis_and_backtracks_identical(case):
    T, V, tokens, seed = TRELLIS_CASES[case]
    blank = 5 if case == "blank 5" else 0
    em = _emission(T, V, seed)
    want = jtr.get_trellis(em, tokens, blank)
    got = ttr.get_trellis(em, tokens, blank)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ttr.wildcard_token_scores(em, np.asarray(tokens), blank),
        jtr.wildcard_token_scores(em, np.asarray(tokens), blank),
    )
    for fn in ("backtrack", "backtrack_beam"):
        jp = getattr(jtr, fn)(want, em, tokens, blank)
        tp = getattr(ttr, fn)(got, em, tokens, blank)
        assert [dataclasses.astuple(p) for p in tp] == [dataclasses.astuple(p) for p in jp], fn
    text = "abcdefghij"[: len(tokens)]
    jseg = jtr.merge_repeats(jtr.backtrack_beam(want, em, tokens, blank), text)
    tseg = ttr.merge_repeats(ttr.backtrack_beam(got, em, tokens, blank), text)
    assert [dataclasses.astuple(s) for s in tseg] == [dataclasses.astuple(s) for s in jseg]
    assert [s.length for s in tseg] == [s.length for s in jseg]


def test_trellis_has_no_jax_scan():
    """The JAX package's ``use_jax=True`` scan has no counterpart: the
    keyword is unknown to the port."""
    em = _emission(10, 5, 0)
    with pytest.raises(TypeError):
        ttr.get_trellis(em, [1, 2], 0, use_jax=True)


def _models(cfg, seed=0, conv_bias=False):
    params = jw2v.init_params(cfg, jax.random.PRNGKey(seed))
    if conv_bias:  # converted large checkpoints carry a bias on each conv
        params["feature_extractor"] = [
            dict(c, b=0.1 * jax.random.normal(jax.random.PRNGKey(10 + i), (c["w"].shape[2],)))
            for i, c in enumerate(params["feature_extractor"])
        ]
    tcfg = tw2v.Wav2Vec2Config(**dataclasses.asdict(cfg))
    return params, wav2vec2_from_numpy(jflatten(params), tcfg, device="cpu")


@pytest.mark.parametrize("layout", ["base", "large"])
def test_wav2vec2_emissions_within_1e4(layout):
    cfg = jw2v.TEST_CONFIG if layout == "base" else LARGE_TEST
    params, model = _models(cfg, seed=1, conv_bias=layout == "large")
    assert (model.feature_extractor[0].b is not None) == (layout == "large")
    audio = np.random.default_rng(2).standard_normal((2, 8192)).astype(np.float32) * 0.1
    want = np.asarray(jw2v.forward(params, cfg, jnp.asarray(audio)))
    got = tw2v.forward(model, torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape == (2, jw2v.output_lengths(cfg, 8192), cfg.vocab_size)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert tw2v.output_lengths(model.config, 8192) == jw2v.output_lengths(cfg, 8192)


def test_emissions_depend_on_the_padding_bucket():
    """A fault of the reference that the port keeps, to match it: each
    segment is zero-padded to a power-of-two bucket, and the base model's
    group norm and the unmasked attention see the padding, so the same
    segment gives other emissions in a larger bucket — in both packages
    (the upstream reference runs each segment unpadded)."""
    params, model = _models(jw2v.TEST_CONFIG, seed=3)
    vocab = dict(jal.DEFAULT_EN_VOCAB)
    jaligner = jal.Wav2Vec2Aligner(params, jw2v.TEST_CONFIG, vocab)
    taligner = tal.Wav2Vec2Aligner(model, vocab)
    w = synth_speech(0.2, seed=4)  # 3200 samples: bucket 4096
    longer = np.pad(w, (0, 6000))  # bucket 16384
    t_real = jw2v.output_lengths(jw2v.TEST_CONFIG, len(w))
    for aligner in (jaligner, taligner):
        small = aligner.emissions(w)[0]
        big = aligner.emissions(longer)[0, :t_real]
        assert small.shape == big.shape
        assert np.abs(small - big).max() > 1e-3
    for a, b in ((w, w), (longer, longer)):
        np.testing.assert_allclose(taligner.emissions(a), jaligner.emissions(b), atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def align_dir(tmp_path_factory):
    """A TEST_CONFIG aligner checkpoint written by the JAX package, with the
    base-960h dictionary, under ``<dir>/en``."""
    root = tmp_path_factory.mktemp("align")
    cfg = jw2v.TEST_CONFIG
    jsave(
        str(root / "en"), jw2v.init_params(cfg, jax.random.PRNGKey(5)),
        {"family": "wav2vec2", "name": "test", "config": dataclasses.asdict(cfg),
         "dictionary": dict(jal.DEFAULT_EN_VOCAB)},
    )
    return root


TRANSCRIPT = [
    {"start": 0.2, "end": 2.4, "text": " Hello world. Dr. Smith, this is a test!"},
    {"start": 2.6, "end": 4.6, "text": "Another segment here; 42 €uros?"},
    {"start": 4.7, "end": 4.71, "text": "x"},  # shorter than one frame
    {"start": 4.8, "end": 5.0, "text": "€€€ ☃"},  # nothing alignable
    {"start": 99.0, "end": 100.0, "text": "too late"},  # past the audio
]


def _aligned(pkg, align_dir, **kw):
    mod = jal if pkg == "jax" else tal
    device = {} if pkg == "jax" else {"device": "cpu"}
    model, metadata = mod.load_align_model("en", model_dir=str(align_dir), **device)
    assert metadata["random_weights"] is False
    return mod.align(TRANSCRIPT, model, metadata, synth_speech(5.0, seed=6), "cpu", **kw)


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(return_char_alignments=True, interpolate_method="linear"),
     dict(interpolate_method="ignore")],
    ids=["nearest", "chars, linear", "ignore"],
)
def test_align_identical_to_jax(align_dir, kw):
    want = _aligned("jax", align_dir, **kw)
    got = _aligned("torch", align_dir, **kw)
    assert got == want
    assert len(got["word_segments"]) >= 8
    # the JSON writer's bytes: the same Python types (float, np.float64)
    types = lambda r: [  # noqa: E731
        [type(s[k]).__name__ for k in ("start", "end")] for s in r["segments"]
    ]
    assert types(got) == types(want)


def test_align_regex_sentence_fallback(align_dir, monkeypatch):
    """Without nltk, both packages split sentences with the same regex."""
    monkeypatch.setitem(sys.modules, "nltk.tokenize.punkt", None)
    text = "Hello world. Dr. Smith is here! ok"
    assert tal._sentence_spans(text) == jal._sentence_spans(text)
    assert len(tal._sentence_spans(text)) == 4
    assert _aligned("torch", align_dir) == _aligned("jax", align_dir)


def test_interpolate_nans_identical():
    values = [None, 1.5, None, None, 4.25, None, 7.0, None]
    for method in ("nearest", "linear", "ignore"):
        assert tal._interpolate_nans(values, method) == jal._interpolate_nans(values, method)
    np.testing.assert_array_equal(tal._interpolate_nans([None, None], "linear"), [np.nan] * 2)


def test_load_align_model_search_order_and_metadata(align_dir, tmp_path, monkeypatch):
    """``model_dir``, then ``WHISPERX_TPU_ALIGN_DIR``, then
    ``~/.cache/whisperx_tpu/align``; ``<model name>`` before ``<language>``.
    The metadata's "type" is "torch" (JAX: "jax")."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("WHISPERX_TPU_ALIGN_DIR", raising=False)
    with pytest.warns(UserWarning, match="RANDOM weights"):
        aligner, meta = tal.load_align_model("en", device="cpu")
    assert meta["random_weights"] is True and meta["type"] == "torch"
    assert aligner.name == "WAV2VEC2_ASR_BASE_960H-random"
    assert aligner.config == tw2v.TEST_CONFIG and meta["dictionary"] == tal.DEFAULT_EN_VOCAB

    monkeypatch.setenv("WHISPERX_TPU_ALIGN_DIR", str(align_dir))
    aligner, meta = tal.load_align_model("en", device="cpu")
    assert meta == {"language": "en", "dictionary": tal.DEFAULT_EN_VOCAB, "type": "torch",
                    "random_weights": False}
    assert aligner.blank_id == 0 and aligner.device == torch.device("cpu")

    named = tmp_path / "named"
    params = jw2v.init_params(jw2v.TEST_CONFIG, jax.random.PRNGKey(9))
    jsave(str(named / "WAV2VEC2_ASR_BASE_960H"), params, {
        "family": "wav2vec2", "config": dataclasses.asdict(jw2v.TEST_CONFIG),
        "dictionary": {"<PAD>": 0, **{k: v for k, v in tal.DEFAULT_EN_VOCAB.items() if v}}})
    aligner, meta = tal.load_align_model("en", device="cpu", model_dir=str(named))
    assert "<pad>" in meta["dictionary"]  # keys lowercased
    np.testing.assert_array_equal(
        aligner.model.lm_head.w.numpy(), np.asarray(params["lm_head"]["w"])
    )
    with pytest.raises(ValueError, match="No default align-model"):
        tal.load_align_model("xx", device="cpu")


def test_align_refuses_random_weights(monkeypatch):
    """Without ``WHISPERX_TPU_ALLOW_RANDOM_ALIGN``, a random-weight aligner
    leaves the transcript unaligned, as in JAX."""
    monkeypatch.delenv("WHISPERX_TPU_ALLOW_RANDOM_ALIGN", raising=False)
    aligner = tal.Wav2Vec2Aligner(
        tw2v.init_params(tw2v.TEST_CONFIG, torch.Generator().manual_seed(0)),
        dict(tal.DEFAULT_EN_VOCAB), name="x-random",
    )
    meta = {"language": "en", "dictionary": aligner.dictionary, "random_weights": True}
    with pytest.warns(UserWarning, match="RANDOM weights"):
        out = tal.align(TRANSCRIPT[:1], aligner, meta, synth_speech(3.0), "cpu")
    assert out == {"segments": [dict(TRANSCRIPT[0], words=[])], "word_segments": []}


def test_save_checkpoint_writes_the_jax_layout(tmp_path):
    """The port's ``save_checkpoint`` of a wav2vec2 made from a
    ``torch.Generator`` is read back by the JAX package's loader (the same
    arrays) and by the port's ``load_align_model``."""
    model = tw2v.init_params(tw2v.TEST_CONFIG, torch.Generator().manual_seed(1))
    cfg = dataclasses.asdict(tw2v.TEST_CONFIG)
    save_checkpoint(str(tmp_path / "en"), model,
                    {"family": "wav2vec2", "config": cfg, "dictionary": tal.DEFAULT_EN_VOCAB})
    params, config = jload(str(tmp_path / "en"))
    assert config["config"]["conv_dim"] == list(tw2v.TEST_CONFIG.conv_dim)
    np.testing.assert_array_equal(
        np.asarray(params["layers"][1]["attn"]["query"]["w"]),
        model.layers[1].attn.query.w.numpy(),
    )
    assert set(jflatten(params)) == {k.replace(".", "/") for k, _ in model.named_parameters()}
    aligner, meta = tal.load_align_model("en", device="cpu", model_dir=str(tmp_path))
    assert not meta["random_weights"]
    for (name, p), q in zip(model.named_parameters(), aligner.model.parameters()):
        assert torch.equal(p, q), name

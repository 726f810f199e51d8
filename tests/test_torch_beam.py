"""The port's beam search against the JAX package on the CPU, f32
``test-nano`` with the same weights: tokens and ``avg_logprob`` for beam
widths 1, 2 and 5, patience 1 and 2, a batch of 2 and int8 weights; its
pieces (``_bank_writes``, the tie order of the candidate selection,
``rank_beams``, beam-folded cross-attention) one by one."""

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
from whisperx_tpu.decoding.beam import _bank_writes as jax_bank_writes
from whisperx_tpu.decoding.beam import rank_beams as jax_rank_beams
from whisperx_tpu.decoding.tokenizer import get_tokenizer as jax_tokenizer
from whisperx_tpu.models.whisper import Whisper as JWhisper
from whisperx_tpu.models.whisper import model as jm
from whisperx_tpu.models.whisper.config import MODEL_DIMS
from whisperx_tpu.quant import quantize_model as jax_quantize_model
from whisperx_tpu_torch.convert.checkpoint import params_from_numpy
from whisperx_tpu_torch.decoding import DecodingOptions, decode
from whisperx_tpu_torch.decoding.beam import _bank_writes, _top_candidates, rank_beams
from whisperx_tpu_torch.decoding.tokenizer import get_tokenizer
from whisperx_tpu_torch.models.whisper import model as tm
from whisperx_tpu_torch.quant import QuantizedLinear
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

DIMS = MODEL_DIMS["test-nano"]
SAMPLE_LEN = 48  # random weights never emit EOT: every beam runs to the budget


@pytest.fixture(scope="module")
def tokenizers():
    kw = dict(num_languages=DIMS.num_languages, language="en", vocab_path="byte-fallback")
    return jax_tokenizer(True, **kw), get_tokenizer(True, **kw)


@pytest.fixture(scope="module")
def params():
    return jm.init_params(DIMS, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def models(params):
    jmodel = JWhisper(DIMS, params, dtype=jnp.float32, name="test-nano")
    tmodel = params_from_numpy(flatten_tree(params), DIMS, torch.float32, "cpu")
    return jmodel, tmodel


@pytest.fixture(scope="module")
def mels():
    audio = np.stack([synth_speech(30.0, seed=s) for s in (0, 1)])
    return np.asarray(jax_log_mel_batch(audio, DIMS.n_mels))


def _assert_same(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.tokens == w.tokens
        assert g.text == w.text
        np.testing.assert_allclose(g.avg_logprob, w.avg_logprob, rtol=1e-5)
        np.testing.assert_allclose(g.no_speech_prob, w.no_speech_prob, rtol=1e-4, atol=1e-7)
        assert g.temperature == 0.0


def _decode_both(jmodel, tmodel, mels, tokenizers, **kw):
    jtok, ttok = tokenizers
    kw = dict(language="en", sample_len=SAMPLE_LEN, **kw)
    want = jax_decode(jmodel, jnp.asarray(mels), JOptions(**kw), tokenizer=jtok)
    got = decode(tmodel, torch.from_numpy(mels), DecodingOptions(**kw), tokenizer=ttok)
    return want, got


@pytest.mark.parametrize("beam_size", [1, 2, 5])
def test_beam_tokens_match_jax(models, mels, tokenizers, beam_size):
    """A batch of 2 mels, full budget: every step's 2K-candidate choice,
    banking and cache reorder must agree."""
    want, got = _decode_both(*models, mels, tokenizers, beam_size=beam_size)
    _assert_same(want, got)


@pytest.mark.parametrize("patience", [1.0, 2.0])
def test_beam_patience_matches_jax(models, mels, tokenizers, patience):
    want, got = _decode_both(
        *models, mels[:1], tokenizers, beam_size=2, patience=patience, kv_quant=True
    )
    _assert_same(want, got)


def test_beam_of_one_is_greedy(models, mels, tokenizers):
    _, tmodel = models
    _, ttok = tokenizers
    kw = dict(language="en", sample_len=SAMPLE_LEN)
    greedy = decode(tmodel, torch.from_numpy(mels), DecodingOptions(**kw), tokenizer=ttok)
    beam = decode(tmodel, torch.from_numpy(mels), DecodingOptions(beam_size=1, **kw), tokenizer=ttok)
    for g, b in zip(greedy, beam):
        assert b.tokens == g.tokens
        np.testing.assert_allclose(b.avg_logprob, g.avg_logprob, rtol=1e-6)


@pytest.mark.parametrize("beam_size", [2, 5])
def test_beam_int8_weights_match_jax(params, mels, tokenizers, beam_size):
    """bf16-rounded weights (as ``compute_type="int8"`` loads them),
    quantized to int8 by the JAX package and bridged to the port, decoded in
    f32: the port's K4 arithmetic and JAX's XLA dequant-dot then differ only
    by f32 rounding order, so the tokens must agree."""
    rounded = jax.tree.map(lambda a: a.astype(jnp.bfloat16).astype(jnp.float32), params)
    jmodel = jax_quantize_model(JWhisper(DIMS, rounded, dtype=jnp.float32), mode="int8")
    tmodel = params_from_numpy(flatten_tree(jmodel.params), DIMS, torch.float32, "cpu")
    # every decoder linear of both blocks: 4 self, 4 cross, 2 MLP each
    assert sum(isinstance(m, QuantizedLinear) for m in tmodel.modules()) == 20
    want, got = _decode_both(jmodel, tmodel, mels, tokenizers, beam_size=beam_size)
    _assert_same(want, got)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bank_writes_match_jax(seed):
    rng = np.random.default_rng(seed)
    k, c = 3, 5
    is_eot = rng.random((4, 2 * k)) < 0.4
    bank_count = rng.integers(0, c + 1, 4)
    want = jax_bank_writes(jnp.asarray(is_eot), jnp.asarray(bank_count, jnp.int32), k, c)
    got = _bank_writes(torch.from_numpy(is_eot), torch.from_numpy(bank_count), k, c)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1])
def test_candidate_ties_break_like_lax_top_k(seed):
    """Many exact ties (small integers and -inf): the chosen indices and
    their order equal ``jax.lax.top_k``'s (lower index first)."""
    rng = np.random.default_rng(seed)
    cand = rng.integers(-3, 3, (3, 40)).astype(np.float32)
    cand[rng.random(cand.shape) < 0.3] = -np.inf
    cand[2, :] = -np.inf  # a row of nothing but ties
    cand[2, 7] = 0.0
    want_v, want_i = jax.lax.top_k(jnp.asarray(cand), 6)
    got_v, got_i = _top_candidates(torch.from_numpy(cand), 6)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("length_penalty", [None, 1.0, 0.5])
def test_rank_beams_matches_jax(length_penalty):
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 100, (5, 12))
    lengths = np.array([3, 12, 0, 7, 7])
    scores = -rng.random(5) * 10
    assert rank_beams(tokens, lengths, scores, length_penalty) == jax_rank_beams(
        tokens, lengths, scores, length_penalty
    )


@pytest.mark.parametrize("kv_quant", [False, True])
def test_beam_folded_decoder_matches_jax(params, models, kv_quant):
    """``beam_groups=2``: 4 token rows, 2 audios, untiled cross-KV; the
    logits equal JAX's to f32 rounding."""
    _, tmodel = models
    n_head = DIMS.n_text_head
    feats = np.random.default_rng(6).standard_normal((2, 1500, DIMS.n_audio_state)).astype(np.float32)
    jk, jv = jm.precompute_cross_kv(params, jnp.asarray(feats), n_head)
    tk, tv = tm.precompute_cross_kv(tmodel.decoder, torch.from_numpy(feats), n_head)
    if kv_quant:
        jk, jv = tuple(map(jm.quantize_kv, jk)), tuple(map(jm.quantize_kv, jv))
        tk, tv = [tm.quantize_kv(x) for x in tk], [tm.quantize_kv(x) for x in tv]
    shape = (4, 64, n_head, DIMS.n_text_state // n_head)
    jcache = jm.KVCache(
        *(tuple(jnp.zeros(shape) for _ in range(DIMS.n_text_layer)) for _ in range(2)), jk, jv
    )
    tcache = tm.KVCache(
        *([torch.zeros(shape) for _ in range(DIMS.n_text_layer)] for _ in range(2)), tk, tv
    )
    tokens = np.array([[50258, 50259, 50359]] * 2 + [[50258, 50259, 50360]] * 2, np.int64)
    want, _, _ = jm.decoder_forward(
        params, jnp.asarray(tokens, jnp.int32), jcache, jnp.int32(0), n_head, beam_groups=2
    )
    got = tm.decoder_forward(
        tmodel.decoder, torch.from_numpy(tokens), tcache, 0, n_head, beam_groups=2
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)

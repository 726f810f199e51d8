"""The port's trainers (``whisperx_tpu_torch/train/``) against the JAX
package's on the CPU, without a training loop:

  - the corpus and batch functions give JAX's arrays exactly;
  - the schedule and one Adam update equal optax's;
  - one step of every trainer's loss, from JAX's initial weights carried
    over through the bridges, on the same 4 windows: the loss within 1e-5
    relative and each gradient within 1e-4 · max|g_jax| of ``jax.grad``
    of the same loss rebuilt from the JAX package's public functions (its
    trainers keep their losses in closures; each rebuild cites the lines);
  - K1's gradient rule against ``jax.grad`` of JAX's XLA attention;
  - the models can take a gradient, and the inference paths do not;
  - the online batch's 64-token rows raise where JAX cuts them;
  - a checkpoint a port trainer writes loads through JAX's loaders."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from whisperx_tpu.convert.checkpoint import flatten_tree as jflatten
from whisperx_tpu.decoding.tokenizer import get_tokenizer as jget_tokenizer
from whisperx_tpu.models.whisper import model as jm
from whisperx_tpu.models.whisper.config import MODEL_DIMS
from whisperx_tpu.models.wav2vec2 import model as jw2v
from whisperx_tpu.train import align_micro as jam
from whisperx_tpu.train import align_online as jao
from whisperx_tpu.train import ctc_micro as jctc
from whisperx_tpu.train import micro as jmicro
from whisperx_tpu_torch.convert.checkpoint import params_from_numpy, wav2vec2_from_numpy
from whisperx_tpu_torch.models.wav2vec2 import model as tw2v
from whisperx_tpu_torch.train import align_micro as tam
from whisperx_tpu_torch.train import align_online as tao
from whisperx_tpu_torch.train import ctc_micro as tctc
from whisperx_tpu_torch.train import micro as tmicro
from whisperx_tpu_torch.train import optim as toptim
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

DIMS = MODEL_DIMS["test-nano"]
N_HEAD = DIMS.n_text_head
DH = DIMS.n_text_state // N_HEAD
HEADS = ((1, 0),)  # the trainers' alignment heads at test-nano
# one step's loss: the two frameworks sum in different orders in f32
LOSS_RTOL = 1e-5
# each gradient tensor, against its largest JAX entry
GRAD_RTOL = 1e-4


def _jtok():
    return jget_tokenizer(
        DIMS.is_multilingual, num_languages=DIMS.num_languages, language="en", task="transcribe"
    )


def _ttok():
    return tmicro.english_tokenizer(DIMS)


@pytest.fixture(scope="module")
def corpora():
    return jmicro.build_corpus(), tmicro.build_corpus(device="cpu")


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(DIMS, jax.random.PRNGKey(0), dtype=jnp.float32)


def _port_model(jax_params):
    return params_from_numpy(jflatten(jax_params), DIMS, torch.float32, "cpu")


def _same_examples(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.audio, w.audio)
        assert g.events == w.events and g.is_noise == w.is_noise


# ---------------------------------------------------------------------------
# Corpus and batch functions: JAX's arrays exactly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lead_s", [0.0, 0.37])
def test_render_phrase_equals_jax(lead_s):
    for text in jmicro.PHRASES:
        np.testing.assert_array_equal(
            tmicro.render_phrase(text, lead_s=lead_s), jmicro.render_phrase(text, lead_s=lead_s)
        )


def test_build_corpus_equals_jax(corpora):
    """The energy VAD + ``merge_chunks`` windows, the noise clips and their
    events; ``build_files`` underneath."""
    _same_examples(corpora[1], corpora[0])
    for (ga, ge), (wa, we) in zip(tmicro.build_files(n_files=3, seed=4), jmicro.build_files(n_files=3, seed=4)):
        np.testing.assert_array_equal(ga, wa)
        assert ge == we


@pytest.mark.parametrize(
    "fn", ["target_tokens", "notimestamps_row", "attention_targets", "word_frame_spans"]
)
def test_row_functions_equal_jax(corpora, fn):
    jtok, ttok = _jtok(), _ttok()
    for ex in corpora[1]:
        if fn == "target_tokens":
            assert tmicro.target_tokens(ttok, ex) == jmicro.target_tokens(jtok, ex)
        elif fn == "notimestamps_row":
            assert tam.notimestamps_row(ttok, ex) == jam.notimestamps_row(jtok, ex)
        elif fn == "attention_targets" and not ex.is_noise:
            for g, w in zip(tam.attention_targets(ttok, ex), jam.attention_targets(jtok, ex)):
                np.testing.assert_array_equal(g, w)
        elif fn == "word_frame_spans":
            assert tam.word_frame_spans(ex.events) == jam.word_frame_spans(ex.events)


def test_sample_window_equals_jax():
    lex = tmicro._lexicon(tmicro.PHRASES)
    got_rng, want_rng = np.random.default_rng(5), np.random.default_rng(5)
    got = [tao.sample_window(got_rng, lex, tmicro.PHRASES) for _ in range(12)]
    want = [jao.sample_window(want_rng, lex, jmicro.PHRASES) for _ in range(12)]
    _same_examples(got, want)


@pytest.mark.parametrize("augment", [False, True])
def test_render_chars_and_labels_equal_jax(augment):
    vocab = tctc.default_vocab()
    for text in (*tctc.PHRASES, " qz'x jw"):
        g = tctc.render_chars(text, vocab, lead_s=0.3, augment_rng=np.random.default_rng(1) if augment else None)
        w = jctc.render_chars(text, vocab, lead_s=0.3, augment_rng=np.random.default_rng(1) if augment else None)
        np.testing.assert_array_equal(g[0], w[0])
        assert g[1] == w[1]
        assert tctc.labels_for(text, vocab) == jctc.labels_for(text, vocab)


def _jax_sample_rows(rng, n, canonical_frac=0.25):
    """JAX ``ctc_micro.py:275-317``'s ``sample_rows`` (a closure there),
    draw for draw through its module-level functions."""
    vocab = tctc.default_vocab()
    cfg = jctc.micro_ctc_config()
    waves, labels = [], []
    chars = sorted(jctc.char_lexicon(vocab))
    lex = jctc.char_lexicon(vocab)
    noise_amps = [0.0, 0.01, 0.005, 0.02]
    for _ in range(n):
        if rng.random() < canonical_frac:
            text = jctc.PHRASES[int(rng.integers(len(jctc.PHRASES)))]
        else:
            words = [
                "".join(chars[int(c)] for c in rng.integers(0, len(chars), int(rng.integers(2, 8))))
                for _ in range(int(rng.integers(2, 5)))
            ]
            text = " " + " ".join(words)
        lead = 0.6 * float(rng.random())
        audio, _ = jctc.render_chars(
            text, vocab, lex, lead_s=lead, augment_rng=rng if rng.random() < 0.67 else None
        )
        amp = noise_amps[int(rng.integers(len(noise_amps)))]
        if amp:
            audio = audio + (amp * rng.standard_normal(len(audio))).astype(np.float32)
        waves.append(audio[:76800])
        labels.append(jctc.labels_for(text, vocab)[:40])
    batch = np.zeros((n, 76800), np.float32)
    frame_n = np.zeros(n, np.int32)
    lab = np.zeros((n, 40), np.int32)
    lab_pad = np.ones((n, 40), np.float32)
    for i, (w, x) in enumerate(zip(waves, labels)):
        batch[i, : len(w)] = w
        frame_n[i] = jw2v.output_lengths(cfg, len(w))
        lab[i, : len(x)] = x
        lab_pad[i, : len(x)] = 0.0
    t_frames = jw2v.output_lengths(cfg, 76800)
    logit_pad = (np.arange(t_frames)[None, :] >= frame_n[:, None]).astype(np.float32)
    return batch, logit_pad, lab, lab_pad, frame_n, labels


@pytest.mark.parametrize("canonical_frac", [0.25, 0.3])
def test_sample_rows_equal_jax_draws(canonical_frac):
    got = tctc.sample_rows(
        np.random.default_rng(3), 16, tctc.micro_ctc_config(), tctc.default_vocab(),
        canonical_frac=canonical_frac,
    )
    want = _jax_sample_rows(np.random.default_rng(3), 16, canonical_frac)
    for g, w in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(g, w)
    assert got[5] == want[5]
    assert dataclasses.asdict(tctc.micro_ctc_config()) == dataclasses.asdict(jctc.micro_ctc_config())


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

SCHEDULES = {  # the trainers' (init, peak, warmup, decay, end)
    "micro": (7e-3 / 20, 7e-3, 30, 640, 7e-3 / 60),
    "ctc": (2.5e-3 / 10, 2.5e-3, 50, 2200, 2.5e-3 / 20),
    "align A": (1.5e-3 / 20, 1.5e-3, 20, 800, 1.5e-3 / 30),
    "online": (1.2e-3 / 15, 1.2e-3, 60, 3000, 1.2e-3 / 15),
    "short": (1.5e-3 / 20, 1.5e-3, 1, 3, 1.5e-3 / 30),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_equals_optax(name):
    """Every count 0..N, to within 2.5 ulp of f32: the same f32 operations
    in optax's order; XLA's f32 cosine differs from the correctly rounded
    one by up to an ulp at some counts."""
    args = SCHEDULES[name]
    got = toptim.warmup_cosine_decay_schedule(*args)
    want = optax.warmup_cosine_decay_schedule(*args)
    counts = np.arange(args[3] + 10)
    np.testing.assert_allclose(
        [got(int(c)) for c in counts], np.asarray(want(jnp.asarray(counts))), rtol=3e-7, atol=0
    )


def test_adam_updates_equal_optax():
    """Three updates from the same gradients (a schedule, so the count the
    rate is read at shows): the parameters within 1e-6 relative of
    ``optax.apply_updates`` after each."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal((5, 7)).astype(np.float32) for _ in range(3)]
    schedule = SCHEDULES["short"]
    opt = optax.adam(optax.warmup_cosine_decay_schedule(*schedule))
    jp = jnp.asarray(p0)
    state = opt.init(jp)
    tp = torch.tensor(p0, requires_grad=True)
    topt = toptim.Adam([tp], toptim.warmup_cosine_decay_schedule(*schedule))
    update = jax.jit(opt.update)
    for g in grads:
        updates, state = update(jnp.asarray(g), state)
        jp = optax.apply_updates(jp, updates)
        tp.grad = torch.from_numpy(g.copy())
        topt.step()
        assert tp.grad is None
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    assert topt.count == 3


# ---------------------------------------------------------------------------
# One step of each loss against jax.grad
# ---------------------------------------------------------------------------


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0, atol=GRAD_RTOL * max(np.abs(want).max(), 1e-30),
        err_msg=what,
    )


def _check_grads(named_port_params, jax_grad_tree, prefix, skip=()):
    """Each port parameter's gradient against JAX's of the same path; JAX's
    gradients of the parameters the port does not train must be 0. An
    attention key bias moves every score of a query row alike, which the
    softmax cancels: its exact gradient is 0 and both frameworks give
    rounding noise, held to 1e-4 of the largest gradient of the model."""
    flat = jflatten(jax_grad_tree, prefix)
    largest = max(float(np.abs(np.asarray(g)).max()) for g in flat.values())
    seen = set()
    for name, p in named_port_params:
        key = name.replace(".", "/")
        seen.add(key)
        assert p.grad is not None, key
        if key.endswith("attn/key/b"):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(flat[key]), rtol=0,
                                       atol=GRAD_RTOL * largest, err_msg=key)
        else:
            _close(p.grad.numpy(), flat[key], key)
    for key in set(flat) - seen:
        assert key in skip or not np.any(flat[key]), key


def _jax_logits(dec, tokens, ck, cv, capture=False):
    """micro.py:354-365 / align_micro.py:283-294: the decoder over a zero
    self-cache of the rows' length, at offset 0."""
    b, t = tokens.shape
    zeros = tuple(jnp.zeros((b, t, N_HEAD, DH), jnp.float32) for _ in range(DIMS.n_text_layer))
    cache = jm.KVCache(zeros, zeros, tuple(ck), tuple(cv))
    logits, _, cqk = jm.decoder_forward({"decoder": dec}, tokens, cache, jnp.int32(0), N_HEAD,
                                        capture_cross_qk=capture)
    return (logits, cqk) if capture else logits


def _jax_ce(logits, tgt, mask):  # align_micro.py:296-299 (micro.py:367-370 without the guard)
    logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), -1)
    nll = -jnp.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0]
    return (nll * mask).sum() / jnp.maximum(mask.sum(), 1.0)


def _jax_attn_ce(cqk, at, aw):  # align_micro.py:300-309
    heads = jnp.stack([cqk[l][:, h] for l, h in HEADS], axis=1)
    logp = jax.nn.log_softmax(heads.astype(jnp.float32), axis=-1)
    row_ce = -(at.astype(jnp.float32)[:, None] * logp).sum(-1)
    return (row_ce * aw[:, None]).sum() / jnp.maximum(aw.sum() * heads.shape[1], 1.0)


def _jax_cross_kv(dec, feats):  # align_micro.py:276-281
    ks = [jm._split_heads(jm.linear(b["cross_attn"]["key"], feats), N_HEAD) for b in dec["blocks"]]
    vs = [jm._split_heads(jm.linear(b["cross_attn"]["value"], feats), N_HEAD) for b in dec["blocks"]]
    return ks, vs


def _jax_value_and_grad(loss, tree, *arrays):
    """``jax.value_and_grad`` of ``loss`` in its first argument, jitted with
    the data as arguments (eager JAX compiles every primitive on its own)."""
    arrays = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in arrays]
    value, grads = jax.jit(jax.value_and_grad(loss))(tree, *arrays)
    return float(value), grads


@pytest.fixture(scope="module")
def batch():
    """One online minibatch of 4 windows (``make_batch``), the rows every
    Whisper loss below reads; its mels and the JAX encoder's features; the
    online trainer's active ids."""
    from whisperx_tpu.audio.mel import _log_mel_batch_body as j_mel_body

    tok = _ttok()
    lex = tmicro._lexicon(tmicro.PHRASES)
    _, a16, tsk, tsm, ntk, ntm, at, aw = tao.make_batch(np.random.default_rng(2), 4, tok, lex, tmicro.PHRASES)
    active, remap = tmicro.active_remap(tao.active_ids(tok, tmicro.PHRASES))
    mels = np.asarray(jax.jit(j_mel_body, static_argnums=1)(jnp.asarray(a16, jnp.float32) / 32768.0, DIMS.n_mels))
    return dict(a16=a16, tsk=tsk, tsm=tsm, ntk=ntk, ntm=ntm, at=at, aw=aw, active=active, remap=remap,
                mels=mels)


@pytest.fixture(scope="module")
def features(jax_params, batch):
    enc = jax.jit(jm.encoder_forward, static_argnums=2)
    return np.asarray(enc(jax_params, jnp.asarray(batch["mels"]), DIMS.n_audio_head))


def _t(batch, *names):
    return [torch.from_numpy(np.asarray(batch[n])) for n in names]


def _trained(dec, small, body):
    """(name, tensor) of the compact embedding and the trained body."""
    return [("tok_emb", small)] + [(n, p) for n, p in dec.named_parameters() if any(p is b for b in body)]


def test_micro_losses_one_step(jax_params, features, batch):
    """``loss_active`` (micro.py:393-400, compact embedding, precomputed
    cross-KV) and ``loss_full`` (:402-407)."""
    ck, cv = jm.precompute_cross_kv(jax_params, jnp.asarray(features), N_HEAD)
    dec = jax_params["decoder"]
    dec_small = {**dec, "tok_emb": dec["tok_emb"][jnp.asarray(batch["active"])]}
    tgt_small = batch["remap"][batch["tsk"][:, 1:]]

    def j_active(d, tsk, tgt_small, tsm, remap, ck, cv):
        return _jax_ce(_jax_logits(d, remap[tsk], ck, cv), tgt_small, tsm)

    def j_full(d, tsk, tsm, ck, cv):
        return _jax_ce(_jax_logits(d, tsk, ck, cv), tsk[:, 1:], tsm)

    for name in ("active", "full"):
        model = _port_model(jax_params)
        tdec = model.decoder
        tck, tcv = ([torch.from_numpy(np.array(x)) for x in xs] for xs in (ck, cv))
        body = tmicro.decoder_params(tdec)
        tsk, tsm, remap = _t(batch, "tsk", "tsm", "remap")
        if name == "active":
            want, jgrads = _jax_value_and_grad(j_active, dec_small, batch["tsk"], tgt_small, batch["tsm"],
                                               batch["remap"], ck, cv)
            small = tmicro.gather_rows(tdec.tok_emb, torch.from_numpy(batch["active"]))
            got = tmicro.loss_active(tmicro.compact_decoder(tdec, small), tsk, remap[tsk[:, 1:]], tsm,
                                     remap, tck, tcv)
        else:
            want, jgrads = _jax_value_and_grad(j_full, dec, batch["tsk"], batch["tsm"], ck, cv)
            small = tdec.tok_emb.requires_grad_(True)
            got = tmicro.loss_full(tdec, tsk, tsm, tck, tcv)
        got.backward()
        np.testing.assert_allclose(float(got.detach()), want, rtol=LOSS_RTOL)
        _check_grads(_trained(tdec, small, body), jgrads, "")


def test_ctc_loss_one_step():
    """``loss_fn`` (ctc_micro.py:319-324): the wav2vec2 forward and
    ``optax.ctc_loss(...).mean()`` against ``F.ctc_loss``, 4 rows."""
    jcfg = jctc.micro_ctc_config()
    jparams = jw2v.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    rows = tctc.sample_rows(np.random.default_rng(7), 4, tctc.micro_ctc_config(), tctc.default_vocab())[:4]

    def j_loss(p, b, logit_pad, lab, lab_pad):
        logp = jw2v.forward(p, jcfg, b)
        return optax.ctc_loss(logp, logit_pad, lab, lab_pad, blank_id=0).mean()

    want, jgrads = _jax_value_and_grad(j_loss, jparams, *rows)
    model = wav2vec2_from_numpy(jflatten(jparams), tctc.micro_ctc_config(), torch.float32, "cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    got = tctc.loss_fn(model, *map(torch.from_numpy, rows))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), want, rtol=LOSS_RTOL)
    _check_grads(model.named_parameters(), jgrads, "")


def test_align_loss_a_one_step(jax_params, features, batch):
    """``loss_a`` (align_micro.py:313-322): the compact decoder's cross-KV
    from its own key/value weights, both CEs and the attention term."""
    dec = jax_params["decoder"]
    dec_small = {**dec, "tok_emb": dec["tok_emb"][jnp.asarray(batch["active"])]}
    names = ("tsk", "tsm", "ntk", "ntm", "at", "aw", "remap")

    def j_loss(d, feats, tsk, tsm, ntk, ntm, at, aw, remap):
        ck, cv = _jax_cross_kv(d, feats)
        ts_logits = _jax_logits(d, remap[tsk], ck, cv)
        nt_logits, cqk = _jax_logits(d, remap[ntk], ck, cv, capture=True)
        ce = _jax_ce(ts_logits, remap[tsk[:, 1:]], tsm) + 0.5 * _jax_ce(nt_logits, remap[ntk[:, 1:]], ntm)
        return ce + _jax_attn_ce(cqk, at, aw)

    want, jgrads = _jax_value_and_grad(j_loss, dec_small, features, *(batch[n] for n in names))
    tdec = _port_model(jax_params).decoder
    body = tmicro.decoder_params(tdec, frozen=())
    small = tmicro.gather_rows(tdec.tok_emb, torch.from_numpy(batch["active"]))
    tsk, tsm, ntk, ntm, at, aw, remap = _t(batch, *names)
    got = tam.loss_a(tmicro.compact_decoder(tdec, small), torch.from_numpy(features), tsk,
                     remap[tsk[:, 1:]], tsm, ntk, remap[ntk[:, 1:]], ntm, at, aw, remap, HEADS)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), want, rtol=LOSS_RTOL)
    _check_grads(_trained(tdec, small, body), jgrads, "")


def test_align_loss_b_one_step(monkeypatch, jax_params, batch):
    """``loss_b`` (align_micro.py:324-333): the encoder inside the loss, so
    its gradients flow through the encoder's attention (JAX: XLA's, with
    ``WHISPERX_TPU_FLASH=0`` as its trainer sets; the port on the CPU: K1's
    plain version). Every parameter's gradient, the encoder's non-zero."""
    monkeypatch.setenv("WHISPERX_TPU_FLASH", "0")
    names = ("mels", "tsk", "tsm", "ntk", "ntm", "at", "aw")

    def j_loss(p, mels, tsk, tsm, ntk, ntm, at, aw):
        feats = jm.encoder_forward(p, mels, DIMS.n_audio_head)
        ck, cv = _jax_cross_kv(p["decoder"], feats)
        ts_logits = _jax_logits(p["decoder"], tsk, ck, cv)
        nt_logits, cqk = _jax_logits(p["decoder"], ntk, ck, cv, capture=True)
        return (_jax_ce(ts_logits, tsk[:, 1:], tsm) + 0.5 * _jax_ce(nt_logits, ntk[:, 1:], ntm)
                + _jax_attn_ce(cqk, at, aw))

    want, jgrads = _jax_value_and_grad(j_loss, jax_params, *(batch[n] for n in names))
    model = _port_model(jax_params)
    for p in model.parameters():
        p.requires_grad_(True)
    got, aux = tam.loss_b(model, *_t(batch, *names), HEADS)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux[0] + 0.5 * aux[1] + aux[2]), want, rtol=LOSS_RTOL)
    _check_grads(model.named_parameters(), jgrads, "")
    for layer in model.encoder.blocks:
        assert float(layer.attn.query.w.grad.abs().max()) > 0


def test_online_loss_compact_one_step(jax_params, batch):
    """``loss_compact`` (align_online.py:215-223): int16 audio →
    ``_log_mel_batch_body`` → the frozen encoder (no gradient) → the
    compact decoder."""
    from whisperx_tpu.audio.mel import _log_mel_batch_body as j_mel_body

    dec = jax_params["decoder"]
    dec_small = {**dec, "tok_emb": dec["tok_emb"][jnp.asarray(batch["active"])]}
    names = ("a16", "tsk", "tsm", "ntk", "ntm", "at", "aw", "remap")

    def j_loss(d, enc, a16, tsk, tsm, ntk, ntm, at, aw, remap):
        wav = a16.astype(jnp.float32) / 32768.0
        feats = jax.lax.stop_gradient(
            jm.encoder_forward({"encoder": enc}, j_mel_body(wav, DIMS.n_mels), DIMS.n_audio_head)
        )
        ck, cv = _jax_cross_kv(d, feats)
        tk, nk = remap[tsk], remap[ntk]
        ts_logits = _jax_logits(d, tk, ck, cv)
        nt_logits, cqk = _jax_logits(d, nk, ck, cv, capture=True)
        ce = _jax_ce(ts_logits, tk[:, 1:], tsm) + 0.5 * _jax_ce(nt_logits, nk[:, 1:], ntm)
        return ce + _jax_attn_ce(cqk, at, aw)

    want, jgrads = _jax_value_and_grad(j_loss, dec_small, jax_params["encoder"], *(batch[n] for n in names))
    model = _port_model(jax_params)
    tdec = model.decoder
    body = tmicro.decoder_params(tdec, frozen=())
    small = tmicro.gather_rows(tdec.tok_emb, torch.from_numpy(batch["active"]))
    a16, *rows, remap = _t(batch, *names)
    feats = tao.features(model.encoder, a16, DIMS.n_mels, DIMS.n_audio_head)
    assert not feats.requires_grad
    got = tao.loss_compact(tmicro.compact_decoder(tdec, small), feats, *rows, remap, HEADS)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), want, rtol=LOSS_RTOL)
    _check_grads(_trained(tdec, small, body), jgrads, "")


# ---------------------------------------------------------------------------
# K1's gradient rule; models that can be trained
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,tq,tk", [(False, 48, 48), (False, 32, 80), (True, 48, 48), (True, 32, 80)])
def test_attention_backward_matches_jax_grad(causal, tq, tk):
    """``attention_backward`` against ``jax.grad`` of JAX's XLA attention
    (``qkv_attention``) within 1e-5 in f32; causal with the mask aligned at
    the end of the keys, as the port's K2 and JAX's decoder align it."""
    from whisperx_tpu_torch.ops.flash_attention import attention_backward

    rng = np.random.default_rng(tq + tk + causal)
    b, h, d = 2, 3, 32
    q, k, v = (rng.standard_normal((b, n, h, d)).astype(np.float32) for n in (tq, tk, tk))
    dout = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    mask = None
    if causal:
        keep = np.tril(np.ones((tq, tk), bool), tk - tq)
        mask = jnp.asarray(np.where(keep, 0.0, -np.inf).astype(np.float32))

    def j_out(q, k, v, dout, mask):
        return (jm.qkv_attention(q, k, v, mask=mask)[0] * dout).sum()

    want = jax.jit(jax.grad(j_out, argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v, dout)), mask)

    def bh(x):
        return torch.from_numpy(x).transpose(1, 2).reshape(b * h, x.shape[1], d).contiguous()

    got = attention_backward(bh(q), bh(k), bh(v), bh(dout), causal)
    for g, w in zip(got, want):
        g = g.reshape(b, h, -1, d).transpose(1, 2).numpy()
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5)


@pytest.mark.parametrize("route", ["K1", "K2 causal"])
def test_kernel_output_carries_the_gradient_rule(monkeypatch, route):
    """Past the wrappers' CPU branch (tensors on the ``meta`` device stand
    in for CUDA ones, the launch replaced by the plain version), K1 and K2
    return an output with a ``grad_fn``, count one launch, and their
    gradients are ``attention_backward``'s."""
    from whisperx_tpu_torch.ops import flash_attention as fa

    monkeypatch.setattr(
        fa, "_launch",
        lambda q, k, v, mode: fa._flash_reference(q, k, v, causal=mode == fa._K2_CAUSAL)
        if mode >= fa._K2 else fa._attention_reference(q, k, v),
    )
    causal = route == "K2 causal"
    wrapper = functools.partial(fa.flash_attention_tiled, causal=True) if causal else fa.wholek_attention
    counter = fa.flash_attention_tiled if causal else fa.flash_attention
    before = counter.launches
    meta = [torch.empty((4, 40, 32), device="meta", requires_grad=True) for _ in range(3)]
    assert type(wrapper(*meta).grad_fn).__name__ == "_KernelAttentionBackward"
    assert counter.launches == before + 1

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((4, 40, 32), generator=g).requires_grad_(True) for _ in range(3))
    out = fa._KernelAttention.apply(q, k, v, fa._K2_CAUSAL if causal else fa._K1)
    dout = torch.randn(out.shape, generator=g)
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = fa.attention_backward(q.detach(), k.detach(), v.detach(), dout, causal)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)


def test_wav2vec2_forward_takes_a_gradient_and_the_aligner_does_not():
    """``forward`` is differentiable (the CTC trainer's loss); the
    aligner's emissions, its inference caller, build no graph even when
    the parameters require one, and keep their values."""
    from whisperx_tpu_torch.alignment.aligner import Wav2Vec2Aligner

    model = tw2v.init_params(tctc.micro_ctc_config(), torch.Generator().manual_seed(0))
    audio = np.random.default_rng(0).standard_normal((1, 8000)).astype(np.float32) * 0.1
    aligner = Wav2Vec2Aligner(model, tctc.default_vocab())
    before = aligner.emissions(audio[0])
    for p in model.parameters():
        p.requires_grad_(True)
    out = tw2v.forward(model, torch.from_numpy(audio))
    assert out.requires_grad and out.grad_fn is not None
    out.sum().backward()
    assert all(p.grad is not None for p in model.parameters())
    np.testing.assert_array_equal(aligner.emissions(audio[0]), before)


def test_decode_path_builds_no_graph(jax_params):
    """With every parameter requiring a gradient (as a trainer leaves them
    mid-training), ``decode`` still runs under inference mode: its audio
    features carry no graph."""
    from whisperx_tpu_torch.decoding.decode import DecodingOptions, decode

    model = _port_model(jax_params)
    for p in model.parameters():
        p.requires_grad_(True)
    mel = torch.zeros((1, 3000, DIMS.n_mels))
    res = decode(model, mel, DecodingOptions(language="en", sample_len=4, fp16=False),
                 keep_audio_features=True)[0]
    assert not res.audio_features.requires_grad and res.audio_features.grad_fn is None


# ---------------------------------------------------------------------------
# The 64-token rows; cross-package checkpoints
# ---------------------------------------------------------------------------


def test_online_rows_longer_than_64_tokens_raise():
    """A phrase set whose 3-phrase windows exceed 64 tokens: the port's
    ``make_batch`` raises; JAX's (align_online.py:178, :181) cuts each row
    at 64 without notice, dropping its end and its ``eot`` (the
    divergence this names, ADVICE r5)."""
    tok = _ttok()
    phrases = (" Zyx qwv jkp zzq xqj.", " Qxz vvk jjq pqz wxq.", " Kqz xjv qqp zxw jjk.")
    lex = tmicro._lexicon(phrases)
    rng = np.random.default_rng(0)
    window = None
    for _ in range(50):
        ex = tao.sample_window(rng, lex, phrases)
        if len(tmicro.target_tokens(tok, ex)) > 64:
            window = ex
            break
    assert window is not None
    row = jmicro.target_tokens(_jtok(), window)
    assert len(row) > 64 and row[:64][-1] != tok.eot  # JAX's cut row has no eot
    with pytest.raises(ValueError, match="64"):
        for seed in range(50):
            tao.make_batch(np.random.default_rng(seed), 4, tok, lex, phrases)


def test_port_checkpoints_load_through_jax(tmp_path, monkeypatch):
    """A checkpoint the online trainer writes after 2 compact steps (its
    certificate stubbed, as only the format is under test) loads through
    JAX's ``load_checkpoint`` with the same tensors; the CTC model's
    through JAX's ``load_align_model(model_dir=...)``."""
    from whisperx_tpu.alignment.aligner import load_align_model as jload_align
    from whisperx_tpu.convert.checkpoint import load_checkpoint as jload
    from whisperx_tpu_torch.convert.checkpoint import flatten_tree

    monkeypatch.setattr(tao, "timestamp_margins", lambda *a: torch.full((1,), float("inf")))
    monkeypatch.setattr(tao, "attention_hits", lambda *a: (torch.ones(()), torch.ones(())))
    model, dims, report = tao.train_micro_aligned_online(steps=2, full_steps=0, minibatch=2, device="cpu")
    assert report["certify_rounds"] == 0 and np.isfinite(report["final_loss"])
    path = str(tmp_path / "online")
    tmicro.save_micro_checkpoint(path, model, dims, report, alignment_heads=report["alignment_heads"])
    params, config = jload(path, dtype=jnp.float32)
    assert config["alignment_heads"] == [[1, 0]] and config["dims"] == dataclasses.asdict(dims)
    flat = flatten_tree(model)
    got = jflatten(params)
    assert set(got) == set(flat)
    for key, arr in flat.items():
        np.testing.assert_array_equal(np.asarray(got[key]), arr, err_msg=key)

    ctc = tw2v.init_params(tctc.micro_ctc_config(), torch.Generator().manual_seed(0))
    tctc.save_ctc_checkpoint(str(tmp_path / "ctc" / "en"), ctc, tctc.micro_ctc_config(), tctc.default_vocab())
    aligner, meta = jload_align("en", device="cpu", model_dir=str(tmp_path / "ctc"))
    assert not meta.get("random_weights", False)
    got = jflatten(aligner.params)
    for key, arr in flatten_tree(ctc).items():
        np.testing.assert_array_equal(np.asarray(got[key]), arr, err_msg=key)

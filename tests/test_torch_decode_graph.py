"""The decode step as a captured graph (``decoding/step_graph.py``), on the
CPU: the static step bodies read nothing back to the host; a graph cache
keys on the weights and the decode's shape, counts each replay's launches
once and hands an entry to one decode at a time; and decodes whose steps
replay an earlier decode's body (a CPU stand-in for the graph: the body
closure of the decode that captured it, called again on the same static
buffers) give the fresh decodes' tokens and JAX's ``_decode_jit`` /
``_beam_decode_jit`` results on f32 ``test-nano``."""

import dataclasses
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from conftest import synth_speech
from whisperx_tpu.audio.mel import log_mel_batch as jax_log_mel_batch
from whisperx_tpu.convert.checkpoint import flatten_tree
from whisperx_tpu.decoding import DecodingOptions as JOptions
from whisperx_tpu.decoding import decode as jax_decode
from whisperx_tpu.decoding.tokenizer import get_tokenizer as jax_tokenizer
from whisperx_tpu.models.whisper import Whisper as JWhisper
from whisperx_tpu.models.whisper import model as jm
from whisperx_tpu.models.whisper.config import MODEL_DIMS
from whisperx_tpu_torch import ops
from whisperx_tpu_torch.convert.checkpoint import params_from_numpy
from whisperx_tpu_torch.decoding import DecodingOptions, decode
from whisperx_tpu_torch.decoding import filters as TF
from whisperx_tpu_torch.decoding import step_graph
from whisperx_tpu_torch.decoding.beam import _beam_step, _BeamBuffers
from whisperx_tpu_torch.decoding.decode import (
    _cache_len,
    _cross_kv,
    _sample_step,
    _SampleBuffers,
    _StaticConfig,
    decode_dispatch,
    decode_finalize,
)
from whisperx_tpu_torch.decoding.step_graph import GraphCache, StepGraph, graph_cache
from whisperx_tpu_torch.decoding.tokenizer import get_tokenizer
from whisperx_tpu_torch.models.whisper.model import (
    KVCache,
    decoder_forward,
    new_self_cache,
    precompute_cross_kv,
)
from whisperx_tpu_torch.quant import QuantizedLinear, quantize_model
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

DIMS = MODEL_DIMS["test-nano"]
SAMPLE_LEN = 16
# sampling at this temperature picks the argmax: logits / T outweighs any
# Gumbel draw, so a sampled decode gives the greedy one's tokens
COLD = 1e-5


@pytest.fixture(scope="module")
def tokenizers():
    kw = dict(num_languages=DIMS.num_languages, language="en", vocab_path="byte-fallback")
    return jax_tokenizer(True, **kw), get_tokenizer(True, **kw)


@pytest.fixture(scope="module")
def params():
    return jm.init_params(DIMS, jax.random.PRNGKey(0), dtype=jnp.float32)


def _torch_model(params):
    return params_from_numpy(flatten_tree(params), DIMS, torch.float32, "cpu")


@pytest.fixture(scope="module")
def mels():
    audio = np.stack([synth_speech(30.0, seed=s) for s in (0, 1, 2, 3)])
    return np.asarray(jax_log_mel_batch(audio, DIMS.n_mels))


# ---------------------------------------------------------------------------
# No host read inside a step
# ---------------------------------------------------------------------------


class NoHostReads(TorchDispatchMode):
    """Raises on every op that reads a device value back to the host."""

    READS = (
        torch.ops.aten._local_scalar_dense.default,
        torch.ops.aten.nonzero.default,
        torch.ops.aten.item.default,
    )

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.READS:
            raise AssertionError(f"host read inside a step: {func}")
        return func(*args, **(kwargs or {}))


def _cfg(ttok, *, greedy=True, kv_quant=False, sample_len=SAMPLE_LEN):
    return _StaticConfig(
        n_head=DIMS.n_text_head, n_head_audio=DIMS.n_audio_head, n_text_ctx=DIMS.n_text_ctx,
        eot=ttok.eot, sot_index=0, no_speech_token=ttok.no_speech,
        timestamp_begin=ttok.timestamp_begin, no_timestamps=ttok.no_timestamps,
        sample_len=sample_len, max_initial_timestamp_index=50, suppress_blank=True,
        blank_tokens=tuple(ttok.encode(" ")), suppress=TF.build_suppress_list(ttok, "-1"),
        without_timestamps=False, greedy=greedy, kv_quant=kv_quant,
    )


def test_host_read_guard_catches_a_read():
    """The control: the guard does raise on a host read."""
    with NoHostReads(), pytest.raises(AssertionError, match="host read"):
        bool(torch.ones(2).all())


def _prefilled_step(model, ttok, kind, kv_quant):
    """A step body of ``kind`` over buffers allocated and started for two
    rows of random audio features, after the prefill: ``(buffers, body,
    rows)``, rows being B·K."""
    dec = model.decoder
    cfg = _cfg(ttok, greedy=kind != "sampled", kv_quant=kv_quant)
    b, k = 2, 3 if kind == "beam" else 1
    init = torch.tensor([list(ttok.sot_sequence)] * b)
    feats = torch.from_numpy(
        np.random.default_rng(0).standard_normal((b, 1500, DIMS.n_audio_state)).astype(np.float32)
    )
    with torch.inference_mode():
        cross_k, cross_v = _cross_kv(model, feats, cfg)
        cache_len = _cache_len(cfg, init.shape[1])
        if kind == "beam":
            s = _BeamBuffers.allocate(dec, cross_k, cross_v, b, k, k, cache_len, cfg)
            init = init.repeat_interleave(k, dim=0)
            s.start(cross_k, cross_v, init, k, cfg.eot)
            body = lambda: _beam_step(dec, s, cfg, k, k)
        else:
            s = _SampleBuffers.allocate(dec, cross_k, cross_v, b, cache_len, cfg)
            s.start(cross_k, cross_v, init, 0.7, cfg.eot)
            if s.noise is not None:
                s.noise.copy_(torch.rand(s.noise.shape, generator=torch.Generator().manual_seed(0)))
            body = lambda: _sample_step(dec, s, cfg)
        logits = decoder_forward(dec, init, s.cache, 0, cfg.n_head, beam_groups=k)
        s.last_logits.copy_(logits[:, -1])
    return s, body, b * k


@pytest.mark.parametrize("kind", ["greedy", "sampled", "beam"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_step_bodies_read_nothing_back(params, tokenizers, kind, kv_quant):
    """Three steps of each static body after a prefill, under a dispatch
    mode that raises on ``_local_scalar_dense`` (``.item()``, ``bool()``)
    and ``nonzero``: a captured step must not read the device."""
    _, ttok = tokenizers
    s, body, rows = _prefilled_step(_torch_model(params), ttok, kind, kv_quant)
    with torch.inference_mode(), NoHostReads():
        for _ in range(3):
            body()
    n_init = len(ttok.sot_sequence)
    assert s.state.step.tolist() == [3] * rows
    assert s.offset.tolist() == [n_init + 3] * rows
    assert torch.isfinite(s.last_logits).any(dim=-1).all()


@pytest.mark.parametrize("kind", ["greedy", "sampled", "beam"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_step_bodies_own_their_masks(params, tokenizers, kind, kv_quant, monkeypatch):
    """A replay reads the filter masks by address, and a graph keeps
    nothing alive: the buffers must own them. Three steps of each static
    body run with ``filters._id_mask`` patched to raise once the buffers
    are allocated (so no step builds or looks up a mask), and give the
    bits of the same steps run unpatched: tokens, filter state, scores,
    logits and caches."""
    _, ttok = tokenizers
    model = _torch_model(params)

    def raises(*args):
        raise AssertionError("a step body built a filter mask")

    runs = []
    for patched in (False, True):
        s, body, _ = _prefilled_step(model, ttok, kind, kv_quant)
        with monkeypatch.context() as m, torch.inference_mode():
            if patched:
                m.setattr(TF, "_id_mask", raises)
            for _ in range(3):
                body()
        runs.append(step_graph._leaves(s))
    assert s.state.step.tolist() == [3] * len(s.state.step)
    want, got = runs
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_per_row_cache_write_casts_like_the_slice_write(params, mels, tokenizers):
    """A converted int8 checkpoint keeps its quantized linears' biases in f32
    (as JAX's ``load_checkpoint`` leaves them), so a bf16 model's key and
    value projections return f32. The prefill's slice write into the bf16
    self-KV cache casts them; a step's per-row write at offsets [B] (every
    step since the step became a static body) raised instead. It casts the
    same way now: a step at tensor offsets gives the int offset's logits and
    cache bits, and the decode runs."""
    _, ttok = tokenizers
    model = params_from_numpy(flatten_tree(params), DIMS, torch.bfloat16, "cpu")
    quantize_model(model)
    for m in model.modules():
        if isinstance(m, QuantizedLinear) and m.b is not None:
            m.b = m.b.float()
    dec = model.decoder
    n_head = DIMS.n_text_head
    feats = torch.from_numpy(
        np.random.default_rng(1).standard_normal((2, 1500, DIMS.n_audio_state)).astype(np.float32)
    ).to(torch.bfloat16)
    init = torch.tensor([list(ttok.sot_sequence)] * 2)
    step = torch.tensor([[ttok.timestamp_begin]] * 2)
    outs = []
    with torch.inference_mode():
        for offset in (3, torch.tensor([3, 3])):
            cache = KVCache(*new_self_cache(dec, 2, 64, n_head), *precompute_cross_kv(dec, feats, n_head))
            decoder_forward(dec, init, cache, 0, n_head)
            outs.append((decoder_forward(dec, step, cache, offset, n_head), cache.self_k + cache.self_v))
    (want, want_kv), (got, got_kv) = outs
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got_kv, want_kv))
    result = decode(model, torch.from_numpy(mels[:2]).to(torch.bfloat16),
                    DecodingOptions(language="en", sample_len=4), tokenizer=ttok)
    assert all(len(r.tokens) == 4 for r in result)


# ---------------------------------------------------------------------------
# The graph cache: keys, invalidation, replay counting, exclusive checkout
# ---------------------------------------------------------------------------


class ReplayBody:
    """A stand-in for a captured graph on the CPU: replaying calls the body
    closure it was captured from, on the same static buffers."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


@pytest.fixture
def cpu_graphs(monkeypatch):
    """Decodes on the CPU take the graph route: each entry's first step runs
    its body (the warm-up), its second "captures" the body's closure, and
    every later step, in this decode or a later one, replays it."""

    def warm_up(self, body):
        body()
        self.warmed = True

    def capture(self, body):
        self.graph, self.launches = ReplayBody(body), {}
        self.captures += 1

    monkeypatch.setattr(step_graph, "graphable", lambda model: True)
    monkeypatch.setattr(StepGraph, "_warm_up", warm_up)
    monkeypatch.setattr(StepGraph, "_capture", capture)


def _keys(model):
    return [e.key for e in graph_cache(model.decoder)._idle]


def test_cache_key_follows_rows_sample_len_and_weights(params, mels, tokenizers, cpu_graphs):
    """A decode's entry is keyed on its rows and ``sample_len``; quantizing
    the decoder's linears changes the weights' fingerprint, which drops
    every entry captured on the old weights."""
    _, ttok = tokenizers
    model = _torch_model(params)
    mel = torch.from_numpy(mels)
    opts = DecodingOptions(language="en", sample_len=4)
    decode(model, mel[:2], opts, tokenizer=ttok)
    (k0,) = _keys(model)
    decode(model, mel[:2], opts, tokenizer=ttok)
    assert _keys(model) == [k0]  # the same shape reuses the entry
    decode(model, mel[:3], opts, tokenizer=ttok)
    decode(model, mel[:2], dataclasses.replace(opts, sample_len=5), tokenizer=ttok)
    keys = _keys(model)
    assert len(keys) == 3 and len(set(keys)) == 3 and keys[2] == k0
    before = step_graph.weights_fingerprint(model.decoder)
    quantize_model(model)
    after = step_graph.weights_fingerprint(model.decoder)
    assert after != before
    decode(model, mel[:2], opts, tokenizer=ttok)
    assert _keys(model) == [k0]  # same shape, new weights: a new entry alone
    assert graph_cache(model.decoder)._weights == after
    assert graph_cache(model.decoder).stats()["captures"] == 4


def test_cache_keeps_the_most_recent_entries():
    cache = GraphCache(max_entries=4)
    w = ("weights",)
    for i in range(6):
        cache.checkin(w, cache.checkout(w, ("shape", i), lambda: None, torch.device("cpu")))
    assert [e.key for e in cache._idle] == [("shape", i) for i in (5, 4, 3, 2)]
    entry = cache.checkout(w, ("shape", 3), lambda: None, torch.device("cpu"))
    assert entry.key == ("shape", 3) and len(cache._idle) == 3
    cache.checkin(w, entry)
    assert cache._idle[0] is entry
    # an entry checked out before the weights changed is not taken back
    old = cache.checkout(w, ("shape", 4), lambda: None, torch.device("cpu"))
    cache.checkout(("new",), ("shape", 9), lambda: None, torch.device("cpu"))
    cache.checkin(w, old)
    assert cache._idle == []


def test_capture_records_launches_instead_of_counting():
    fn = lambda: None
    fn.launches = 0
    with ops.recording_launches() as record:
        ops.count_launch(fn)
        ops.count_launch(fn)
    assert fn.launches == 0 and record == {(fn, "launches"): 2}
    ops.count_launch(fn)
    ops.add_launches(record)
    assert fn.launches == 3


class StubGraph:
    def replay(self):
        pass


def test_replays_from_many_threads_add_the_captured_launches():
    """8 threads replay one key's entries from one cache, N replays in all:
    each kernel's count grows by exactly N x its launches at capture."""
    k3 = lambda: None
    k4 = lambda: None
    k3.launches = k4.launches = 0
    record = {(k3, "launches"): 32, (k4, "launches"): 5}
    cache = GraphCache()
    w, key = ("weights",), ("shape",)
    per_thread, threads = 200, 8

    def worker():
        for _ in range(per_thread // 10):
            entry = cache.checkout(w, key, lambda: None, torch.device("cpu"))
            if entry.graph is None:
                entry.graph, entry.launches = StubGraph(), record
            for _ in range(10):
                entry.step(lambda: None)
            cache.checkin(w, entry)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=worker) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    n = per_thread * threads
    assert (k3.launches, k4.launches) == (32 * n, 5 * n)
    assert cache.stats()["replays"] == n


class CapturedStep:
    """A stand-in for a graph whose capture ran the step once, counts
    recorded: its first replay is that step, already done; a later one
    runs the body with its counts recorded and dropped, since a replay
    runs no Python and only the capture's record (added by
    ``StepGraph.step``) counts."""

    def __init__(self, body):
        self.body, self.fresh = body, True

    def replay(self):
        if self.fresh:
            self.fresh = False
            return
        with ops.recording_launches():
            self.body()


@pytest.mark.parametrize("flag", ["force", None])
def test_replays_add_the_captured_pass_counts(params, mels, tokenizers, monkeypatch, flag):
    """A greedy int8-cache decode whose steps replay a capture: the capture
    records one pass a layer, by route (K3's under ``force``, the einsum's
    without the opt-in), and each replay adds it once, so the tracker
    counts n_text_layer x steps, as an eager decode does, with its tokens."""
    if flag is None:
        monkeypatch.delenv("WHISPERX_TPU_CROSS_DECODE", raising=False)
    else:
        monkeypatch.setenv("WHISPERX_TPU_CROSS_DECODE", flag)
    records = []

    def warm_up(self, body):
        body()
        self.warmed = True

    def capture(self, body):
        with ops.recording_launches() as record:
            body()
        self.graph, self.launches = CapturedStep(body), record
        records.append(record)

    monkeypatch.setattr(step_graph, "graphable", lambda model: True)
    monkeypatch.setattr(StepGraph, "_warm_up", warm_up)
    monkeypatch.setattr(StepGraph, "_capture", capture)
    _, ttok = tokenizers
    model = _torch_model(params)
    opts = DecodingOptions(language="en", sample_len=SAMPLE_LEN, kv_quant=True)
    names = ("cross_decode.kernel_passes", "cross_decode.plain_passes")
    route, other = names if flag == "force" else names[::-1]
    results = []
    for eager in (True, False):
        before = {k: step_graph.GLOBAL_TRACKER.counters.get(k, 0.0) for k in names}
        handle = decode_dispatch(model, torch.from_numpy(mels[:2]), opts, tokenizer=ttok, _eager=eager)
        results.append(_results(handle))
        got = {k: step_graph.GLOBAL_TRACKER.counters.get(k, 0.0) - before[k] for k in names}
        assert got == {route: DIMS.n_text_layer * handle["steps"], other: 0}, (eager, got)
    assert results[0] == results[1]
    assert records == [{route: DIMS.n_text_layer}]
    assert graph_cache(model.decoder).stats()["replays"] == handle["steps"] - 1


def test_two_threads_never_hold_one_entry():
    """Threads asking for one key at once each get an entry of their own;
    the cache keeps at most ``max_entries`` idle ones afterwards."""
    cache = GraphCache(max_entries=2)
    w, key = ("weights",), ("shape",)
    lock = threading.Lock()
    held, seen, clashes = set(), set(), []

    def worker():
        for _ in range(50):
            entry = cache.checkout(w, key, lambda: None, torch.device("cpu"))
            with lock:
                if id(entry) in held:
                    clashes.append(entry)
                held.add(id(entry))
                seen.add(id(entry))
            time.sleep(1e-4)
            with lock:
                held.discard(id(entry))
            cache.checkin(w, entry)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        # more threads than the host has cores
        pool = [threading.Thread(target=worker) for _ in range(max(12, 2 * (os.cpu_count() or 1)))]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    assert clashes == []
    assert len(seen) > 1  # concurrent checkouts made entries of their own
    assert len(cache._idle) <= 2


# ---------------------------------------------------------------------------
# Replayed decodes: the fresh decodes' tokens, and JAX's
# ---------------------------------------------------------------------------


def _results(handle):
    return [(r.tokens, r.avg_logprob, r.no_speech_prob) for r in decode_finalize(handle)]


@pytest.mark.parametrize("kind", ["greedy", "sampled", "beam"])
def test_replayed_decodes_equal_fresh_ones(params, mels, tokenizers, cpu_graphs, kind):
    """Three decodes of one shape in a row, each with other mels, prompt
    length (n_init 3 and 6 share a cache length) and temperature: the
    second and third replay the first's step body on its buffers, and give
    what decodes on fresh buffers (``_eager``, the card's yardstick) give,
    bit for bit."""
    _, ttok = tokenizers
    model = _torch_model(params)
    mel = torch.from_numpy(mels)
    cases = [(mel[:2], None, 0.6), (mel[2:], [100, 200], 0.9), (mel[1:3], None, 0.3)]

    def run(batch, prompt, temperature, eager):
        opts = DecodingOptions(
            language="en", sample_len=SAMPLE_LEN, prompt=prompt, kv_quant=True,
            temperature=temperature if kind == "sampled" else 0.0,
            beam_size=3 if kind == "beam" else None,
        )
        gen = torch.Generator().manual_seed(7)
        handle = decode_dispatch(
            model, batch, opts, tokenizer=ttok, generator=gen, _eager=eager
        )
        return _results(handle), handle["steps"]

    fresh = [run(*c, eager=True) for c in cases]
    assert graph_cache(model.decoder).stats()["entries"] == 0
    replayed = [run(*c, eager=False) for c in cases]
    assert replayed == fresh
    stats = graph_cache(model.decoder).stats()
    # every step a replay but the first decode's first two (warm-up, capture)
    assert stats["entries"] == 1
    assert stats["replays"] == sum(steps for _, steps in replayed) - 1


@pytest.fixture(scope="module")
def jax_results(params, mels, tokenizers):
    """JAX's decodes of ``mels[:2]``, made once per options."""
    jtok, _ = tokenizers
    jmodel = JWhisper(DIMS, params, dtype=jnp.float32, name="test-nano")
    made = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in made:
            opts = JOptions(language="en", sample_len=SAMPLE_LEN, **kw)
            made[key] = jax_decode(jmodel, jnp.asarray(mels[:2]), opts, tokenizer=jtok)
        return made[key]

    return get


def _replayed_port(params, mels, tokenizers, **kw):
    """The port's decode of ``mels[:2]`` whose steps replay the body that a
    decode of other mels captured."""
    _, ttok = tokenizers
    model = _torch_model(params)
    opts = DecodingOptions(language="en", sample_len=SAMPLE_LEN, **kw)
    gen = torch.Generator().manual_seed(0)
    decode(model, torch.from_numpy(mels[2:4].copy()), opts, tokenizer=ttok, generator=gen)
    got = decode(model, torch.from_numpy(mels[:2].copy()), opts, tokenizer=ttok, generator=gen)
    assert graph_cache(model.decoder).stats()["replays"] > 0
    return got


@pytest.mark.parametrize("temperature", [0.0, COLD], ids=["greedy", "sampled"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_replayed_decode_matches_jax(params, mels, tokenizers, jax_results, cpu_graphs,
                                     temperature, kv_quant):
    """``_decode_jit``'s greedy tokens, log-probabilities and no-speech
    probabilities; the sampled body at a temperature so low that its draw
    is the argmax gives them too, which runs its every op."""
    want = jax_results(kv_quant=kv_quant)
    got = _replayed_port(params, mels, tokenizers, temperature=temperature, kv_quant=kv_quant)
    for w, g in zip(want, got):
        assert g.tokens == w.tokens and g.text == w.text
        np.testing.assert_allclose(g.avg_logprob, w.avg_logprob, rtol=1e-4)
        np.testing.assert_allclose(g.no_speech_prob, w.no_speech_prob, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_replayed_beam_decode_matches_jax(params, mels, tokenizers, jax_results, cpu_graphs,
                                         kv_quant):
    """``_beam_decode_jit``'s result, beam 3 with patience 2 (banks of 6)."""
    kw = dict(beam_size=3, patience=2.0, kv_quant=kv_quant)
    want = jax_results(**kw)
    got = _replayed_port(params, mels, tokenizers, **kw)
    for w, g in zip(want, got):
        assert g.tokens == w.tokens and g.text == w.text
        np.testing.assert_allclose(g.avg_logprob, w.avg_logprob, rtol=1e-5)
        np.testing.assert_allclose(g.no_speech_prob, w.no_speech_prob, rtol=1e-4, atol=1e-7)

"""The speculative loop and the data-parallel replicas' decodes as captured
graphs (``decoding/step_graph.py``), on the CPU, on f32 ``test-nano`` with
JAX's weights bridged through ``params_from_numpy``: the speculative
iteration body reads nothing back to the host; decodes whose iterations
replay an earlier decode's body closure (the CPU stand-in for the graph,
as in ``test_torch_decode_graph.py``) give the fresh decodes' results and
JAX's ``_spec_batch_jit``'s; the speculative cache misses when only the
draft changes; and a split over a two-row CPU mesh whose replicas replay
their steps gives the unsplit decode's tokens."""

import contextlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synth_speech
from test_torch_decode_graph import NoHostReads, cpu_graphs  # noqa: F401 (fixture)
from whisperx_tpu.convert.checkpoint import flatten_tree
from whisperx_tpu.decoding import DecodingOptions as JOptions
from whisperx_tpu.decoding import speculative as jspec
from whisperx_tpu.models.whisper import Whisper as JWhisper
from whisperx_tpu.models.whisper import model as jm
from whisperx_tpu.models.whisper.config import MODEL_DIMS
from whisperx_tpu_torch.audio import log_mel_batch
from whisperx_tpu_torch.convert.checkpoint import params_from_numpy
from whisperx_tpu_torch.decoding import DecodingOptions
from whisperx_tpu_torch.decoding.decode import decode_dispatch, decode_finalize
from whisperx_tpu_torch.decoding import speculative as tspec
from whisperx_tpu_torch.decoding.step_graph import StepGraph, graph_cache, weights_fingerprint
from whisperx_tpu_torch.parallel import make_mesh, shard_params_tp, use_mesh
from whisperx_tpu_torch.quant import quantize_model
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

DIMS = MODEL_DIMS["test-nano"]
SAMPLE_LEN = 8
NAMES = ("tokens", "n", "sum_logprob", "no_speech_prob", "proposed", "accepted", "passes")


def _bridge(params):
    return params_from_numpy(flatten_tree(params), DIMS, torch.float32, "cpu")


@pytest.fixture(scope="module")
def weights():
    """JAX's parameters of the target (seed 0) and of a draft of other
    weights: each of the target's tensors scaled entrywise by 1 + 0.3·N(0, 1)
    (numpy, seed 1)."""
    params = jm.init_params(DIMS, jax.random.PRNGKey(0), dtype=jnp.float32)
    rng = np.random.default_rng(1)
    other = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) * (1 + 0.3 * rng.standard_normal(x.shape)), x.dtype), params
    )
    return params, other


@pytest.fixture(scope="module")
def mels():
    """Four rows of synthetic speech: the decodes take rows 0-1, the decodes
    whose body they replay rows 2-3."""
    audio = np.stack([synth_speech(30.0, seed=s) for s in range(4)])
    return log_mel_batch(audio, DIMS.n_mels, device="cpu").numpy()


def _draft(target, kind, weights):
    return tspec.truncated_self_draft(target, 1) if kind == "self:1" else _bridge(weights[1])


def _port(spec, mel, wt, eager=False, sample_len=SAMPLE_LEN):
    opts = DecodingOptions(language="en", sample_len=sample_len, without_timestamps=wt)
    handle = spec.decode_batch_dispatch(torch.from_numpy(mel), opts, _eager=eager)
    return tuple(x.numpy() for x in handle["device"]), handle["steps"]


# ---------------------------------------------------------------------------
# No host read inside a speculative iteration
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def guarded_steps():
    """Inside it, every speculative iteration runs under a dispatch mode
    that raises on ``_local_scalar_dense`` and ``nonzero``: a captured
    iteration must not read the device. Yields a list that gets one entry
    per iteration."""
    real, calls = tspec._spec_step, []

    def guarded(*args):
        with NoHostReads():
            real(*args)
        calls.append(1)

    tspec._spec_step = guarded
    try:
        yield calls
    finally:
        tspec._spec_step = real


def test_spec_body_reads_nothing_back(weights, mels):
    """The iteration body of an int8 ``self:1`` decode (γ 2, K4's plain
    version) reads nothing back, in both acceptance branches; the f32 body
    is held to the same in every replay case below."""
    model = _bridge(weights[0])
    quantize_model(model, "int8")
    spec = tspec.SpeculativeDecoder(model, tspec.truncated_self_draft(model, 1), 2)
    total = 0
    with guarded_steps() as calls:
        for wt in (False, True):
            (buf, n, *_), steps = _port(spec, mels[:2], wt)
            assert steps >= 2 and (n > 0).all() and (n <= SAMPLE_LEN).all()
            total += steps
    assert len(calls) == total


@pytest.mark.parametrize("wt", [False, True], ids=["timestamps", "without_timestamps"])
def test_spec_body_owns_its_masks(weights, mels, wt):
    """A replay reads the filter masks by address, and a graph keeps nothing
    alive: ``_SpecBuffers`` must own them, for the target's filters and the
    draft's. Every iteration of a ``self:1`` decode (γ 2) runs with
    ``filters._id_mask`` patched to raise (the buffers are allocated before
    the first), and the decode gives the bits of the same decode unpatched."""
    from whisperx_tpu_torch.decoding import filters

    model = _bridge(weights[0])
    spec = tspec.SpeculativeDecoder(model, tspec.truncated_self_draft(model, 1), 2)
    want = _port(spec, mels[:2], wt, eager=True)
    real_step, real_mask, calls = tspec._spec_step, filters._id_mask, []

    def raises(*args):
        raise AssertionError("an iteration body built a filter mask")

    def no_mask_built(*args):
        filters._id_mask = raises
        try:
            real_step(*args)
        finally:
            filters._id_mask = real_mask
        calls.append(1)

    tspec._spec_step = no_mask_built
    try:
        got = _port(spec, mels[:2], wt, eager=True)
    finally:
        tspec._spec_step = real_step
    assert len(calls) == got[1] == want[1] >= 2
    for name, g, w in zip(NAMES, got[0], want[0]):
        np.testing.assert_array_equal(g, w, err_msg=name)


# ---------------------------------------------------------------------------
# Replayed speculative decodes: the fresh decodes' bits, and JAX's results
# ---------------------------------------------------------------------------


CASES = {
    # (draft, γ, without_timestamps, held against JAX): the two JAX cases
    # between them take each draft, γ and acceptance branch once
    "self:1, gamma 1, timestamps": ("self:1", 1, False, True),
    "self:1, gamma 2, without_timestamps": ("self:1", 2, True, False),
    "other weights, gamma 2, without_timestamps": ("other", 2, True, True),
    "other weights, gamma 1, timestamps": ("other", 1, False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_replayed_spec_decodes_equal_fresh_and_jax(weights, mels, cpu_graphs, case):
    """A decode of rows 2-3 captures the iteration body; a decode of rows
    0-1 replays that closure on the same buffers. Both equal decodes on
    fresh buffers (``_eager``, the card's yardstick) bit for bit, whose
    every iteration runs under ``NoHostReads`` (between them the cases
    take both acceptance branches); in two
    cases the replayed one is held against JAX's ``_spec_batch_jit`` (a
    vmap of the B=1 while loop): the same tokens, lengths, proposed,
    accepted and target passes, ``sum_logprob`` and the no-speech
    probability within 1e-5. (``test_torch_speculative.py`` holds the
    fresh decodes against JAX in every case.)"""
    kind, gamma, wt, against_jax = CASES[case]
    target = _bridge(weights[0])
    spec = tspec.SpeculativeDecoder(target, _draft(target, kind, weights), gamma)
    with guarded_steps() as calls:
        fresh = [_port(spec, m, wt, eager=True) for m in (mels[2:], mels[:2])]
    assert len(calls) == sum(steps for _, steps in fresh)
    cache = graph_cache(target.decoder, tspec.SPEC_GRAPHS)
    assert cache.stats()["entries"] == 0
    replayed = [_port(spec, m, wt) for m in (mels[2:], mels[:2])]
    for (got, got_steps), (want, want_steps) in zip(replayed, fresh):
        assert got_steps == want_steps
        for name, g, w in zip(NAMES, got, want):
            np.testing.assert_array_equal(g, w, err_msg=name)
    stats = cache.stats()
    assert stats["entries"] == 1 and stats["captures"] == 1
    # every iteration a replay but the first decode's first two
    assert stats["replays"] == sum(steps for _, steps in replayed) - 1
    assert graph_cache(target.decoder).stats()["entries"] == 0  # not the plain decodes' cache
    if not against_jax:
        return
    jtarget = JWhisper(DIMS, weights[0], dtype=jnp.float32, name="test-nano")
    if kind == "self:1":
        jdraft = jspec.truncated_self_draft(jtarget, 1)
    else:
        jdraft = JWhisper(DIMS, weights[1], dtype=jnp.float32, name="test-nano")
    handle = jspec.SpeculativeDecoder(jtarget, jdraft, gamma).decode_batch_dispatch(
        jnp.asarray(mels[:2]), JOptions(language="en", sample_len=SAMPLE_LEN, without_timestamps=wt)
    )
    want = [np.asarray(x) for x in handle["device"]]
    want[0] = want[0][:, 0]  # JAX's vmap keeps the B=1 axis
    got = replayed[1][0]
    for name, g, w in zip(NAMES, got, want):
        if name in ("sum_logprob", "no_speech_prob"):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[4].sum() > 0 and got[6].min() >= 1


def test_spec_cache_misses_when_only_the_draft_changes(weights, mels, cpu_graphs):
    """The speculative entry is keyed on the target's and the draft's
    tensors: a reloaded draft (the same values at other addresses) misses
    and drops the entry of the old pair, as a ``zero_tail_model`` target
    does; the same pair again hits. A ``self:N`` draft's decoder and a
    zero-tail target's start with no graph cache of their own."""
    target = _bridge(weights[0])
    cache = graph_cache(target.decoder, tspec.SPEC_GRAPHS)

    def run(draft, model=target):
        _port(tspec.SpeculativeDecoder(model, draft, 2), mels[:1], False, sample_len=4)
        return graph_cache(model.decoder, tspec.SPEC_GRAPHS).stats()

    draft = _bridge(weights[1])
    assert run(draft)["captures"] == 1
    (key,) = [e.key for e in cache._idle]
    assert run(draft)["captures"] == 1  # the same pair: a hit
    weights_before = cache._weights
    reloaded = _bridge(weights[1])
    stats = run(reloaded)
    assert stats["captures"] == 2 and stats["entries"] == 1  # a miss; the old entry dropped
    n_target = len(weights_fingerprint(target.decoder))  # the key's target part, then the draft's
    assert cache._weights[:n_target] == weights_before[:n_target]
    assert cache._weights[n_target:] != weights_before[n_target:]
    assert [e.key for e in cache._idle] == [key]  # the same shape, new weights

    self_draft = tspec.truncated_self_draft(target, 1)
    assert not hasattr(self_draft.decoder, tspec.SPEC_GRAPHS)
    zero_tail = tspec.zero_tail_model(target, 1)
    assert not hasattr(zero_tail.decoder, tspec.SPEC_GRAPHS)
    assert run(tspec.truncated_self_draft(zero_tail, 1), zero_tail)["captures"] == 1
    assert cache.stats()["captures"] == 2  # the target's own cache untouched


# ---------------------------------------------------------------------------
# Data-parallel replicas' decodes, replayed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["greedy", "sampled", "beam"])
def test_dp_split_replayed_equals_unsplit(weights, mels, cpu_graphs, monkeypatch, kind):
    """Two decodes of two rows split over a two-row CPU mesh (one replica
    on two worker threads, each checking out an entry of its own), the
    second replaying the first's bodies, give the unsplit decodes' tokens;
    a sampled split samples them from the whole batch's draws."""
    model = _bridge(weights[0])
    opts = DecodingOptions(
        language="en", sample_len=8, kv_quant=True,
        temperature=0.8 if kind == "sampled" else 0.0,
        beam_size=2 if kind == "beam" else None,
    )
    batches = [torch.from_numpy(mels[:2]), torch.from_numpy(mels[2:])]

    def run():
        out = []
        for mel in batches:
            gen = torch.Generator().manual_seed(5)
            handle = decode_dispatch(model, mel, opts, generator=gen)
            out.append([(r.tokens, r.avg_logprob) for r in decode_finalize(handle)])
        return out

    want = run()
    mesh = make_mesh(2, 1, devices=[torch.device("cpu")] * 2)
    shard_params_tp(model, mesh)
    assert model._dp_replicas == [model, model]
    real_step, replayed_by = StepGraph.step, set()

    def step(self, body):
        if self.graph is not None and self.key[1] == 1:  # a replica's replay: 1 row
            replayed_by.add(threading.get_ident())
        real_step(self, body)

    monkeypatch.setattr(StepGraph, "step", step)
    with use_mesh(mesh):
        got = run()
    assert [[t for t, _ in rows] for rows in got] == [[t for t, _ in rows] for rows in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([lp for _, lp in g], [lp for _, lp in w], atol=1e-5, rtol=0)
    assert len(replayed_by) >= 2  # both replicas' worker threads replayed
    assert {e.key[1] for e in graph_cache(model.decoder)._idle} == {2, 1}

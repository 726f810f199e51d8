"""The port's scale-out (``whisperx_tpu_torch/parallel/``) against the JAX
package's on the CPU: the port's mesh is ``[cpu] * 8``, JAX's the suite's 8
virtual devices (``conftest.py``). Weights are JAX's ``init_params``,
bridged with ``params_from_numpy``; everything is f32, so tokens must be
identical and ``avg_logprob`` / ``no_speech_prob`` agree within 1e-4 (the
row-split sums add the shards' partial products in another order)."""

import dataclasses
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synth_speech
from whisperx_tpu.convert.checkpoint import flatten_tree
from whisperx_tpu.models.whisper import Whisper as JWhisper
from whisperx_tpu.models.whisper import model as jm
from whisperx_tpu.models.whisper.config import MODEL_DIMS, ModelDimensions
from whisperx_tpu_torch.convert.checkpoint import params_from_numpy
from whisperx_tpu_torch.models.whisper.model import SplitLinear
from whisperx_tpu_torch.parallel import (
    DataParallelPipeline,
    data_parallel_transcribe,
    get_mesh,
    initialize_multihost,
    make_mesh,
    shard,
    shard_files,
    shard_params_tp,
    use_mesh,
    walk_params_tp,
)
from whisperx_tpu_torch.parallel.sharding import split_ranges
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

DIMS = MODEL_DIMS["test-nano"]
CPU8 = [torch.device("cpu")] * 8
TOL = 1e-4


def _pair(dims, seed=0):
    params = jm.init_params(dims, jax.random.PRNGKey(seed), dtype=jnp.float32)
    jmodel = JWhisper(dims, params, dtype=jnp.float32, name="nano")
    return jmodel, lambda: params_from_numpy(flatten_tree(params), dims, torch.float32, "cpu")


@pytest.fixture(scope="module")
def nano():
    return _pair(DIMS)


def _mels(b, seed, n_mels=80):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 3000, n_mels)) * 0.1).astype(np.float32)


def _jax_meshed(jmodel, n_data, n_model):
    """JAX's model with its parameters placed on its (n_data, n_model) mesh."""
    import copy

    from whisperx_tpu.parallel import make_mesh as jmake_mesh
    from whisperx_tpu.parallel import shard_params_tp as jshard

    mesh = jmake_mesh(n_data=n_data, n_model=n_model)
    placed = copy.copy(jmodel)
    placed.params = jshard(jmodel.params, mesh)
    return placed, mesh


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.tokens == w.tokens
        np.testing.assert_allclose(g.avg_logprob, w.avg_logprob, atol=TOL)
        np.testing.assert_allclose(g.no_speech_prob, w.no_speech_prob, atol=TOL)


def _meshed_decode_pair(jmodel, tmodel, mel, opts, n_data, n_model, devices=CPU8):
    from whisperx_tpu.decoding import DecodingOptions as JOptions
    from whisperx_tpu.decoding import decode as jdecode
    from whisperx_tpu.parallel import use_mesh as juse_mesh
    from whisperx_tpu_torch.decoding import DecodingOptions, decode

    jplaced, jmesh = _jax_meshed(jmodel, n_data, n_model)
    with juse_mesh(jmesh):
        want = jdecode(jplaced, jnp.asarray(mel), JOptions(**opts))
    mesh = make_mesh(n_data, n_model, devices=devices)
    shard_params_tp(tmodel, mesh)
    with use_mesh(mesh):
        got = decode(tmodel, torch.from_numpy(mel), DecodingOptions(**opts))
    return got, want


# ``cpu`` and ``cpu:0`` are one device to a tensor but two to a mesh: rows of
# different devices get replicas of their own, shards on different devices
# copies of their slices, as on several cards
CPU_AND_CPU0 = [torch.device("cpu"), torch.device("cpu", 0)]


def test_mesh_shapes_and_thread_local_active_mesh():
    assert make_mesh(n_data=4, n_model=2, devices=CPU8).shape == {"data": 4, "model": 2}
    assert make_mesh(devices=CPU8).shape == {"data": 8, "model": 1}
    with pytest.raises(AssertionError):
        make_mesh(n_data=3, n_model=2, devices=CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()  # no fallback to the CPU
    mesh = make_mesh(n_data=2, n_model=4, devices=CPU8)
    seen = []
    with use_mesh(mesh):
        t = threading.Thread(target=lambda: seen.append(get_mesh()))
        t.start()
        t.join()
        assert get_mesh() is mesh
    assert seen == [None] and get_mesh() is None
    x = torch.ones(2)
    assert shard(x, "data", None) is x  # no eager meaning: the input itself


def test_tp_encoder_matches_single_device(nano):
    """The (4, 2)-placed encoder: K1's plain version once per shard, each on
    one head, the out-projection and mlp2 summed over the shards; within
    1e-4 of the unsharded port (itself within 1e-4 of JAX's,
    ``test_torch_whisper_model.py``); language detection's codes and
    probabilities; and, with nonzero biases, the unsharded port's
    encoder."""
    from whisperx_tpu_torch.models.whisper.model import encoder_forward

    _, build = nano
    mel = _mels(2, 0)
    ref = encoder_forward(build().encoder, torch.from_numpy(mel), DIMS.n_audio_head)
    tmodel = shard_params_tp(build(), make_mesh(4, 2, devices=CPU8))
    blk = tmodel.encoder.blocks[0]
    assert isinstance(blk.attn.query, SplitLinear) and isinstance(blk.mlp2, SplitLinear)
    assert [(a, b) for _, a, b in blk.tp.heads] == [(0, 1), (1, 2)]
    out = encoder_forward(tmodel.encoder, torch.from_numpy(mel), DIMS.n_audio_head)
    torch.testing.assert_close(out, ref, atol=TOL, rtol=0)

    # language detection: a one-token pass over the per-shard cross-KV
    from whisperx_tpu_torch.decoding import detect_language
    from whisperx_tpu_torch.decoding.tokenizer import get_tokenizer

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the partial vocabulary's notice
        tok = get_tokenizer(True, num_languages=DIMS.num_languages, language="en")
    codes, probs = detect_language(tmodel, torch.from_numpy(mel), tok)
    want_codes, want_probs = detect_language(build(), torch.from_numpy(mel), tok)
    assert codes == want_codes
    for p, q in zip(probs, want_probs):
        np.testing.assert_allclose([p[c] for c in q], list(q.values()), atol=1e-5)

    # nonzero biases (init_params zeroes them): the column-split biases go
    # with their slices, the row-split ones are added once, after the sum
    import copy

    whole = build()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in whole.named_parameters():
            if name.endswith(".b"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    ref = encoder_forward(whole.encoder, torch.from_numpy(mel), DIMS.n_audio_head)
    split = shard_params_tp(copy.deepcopy(whole), make_mesh(1, 2, devices=CPU8[:2]))
    out = encoder_forward(split.encoder, torch.from_numpy(mel), DIMS.n_audio_head)
    torch.testing.assert_close(out, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("devices", ["one device", "two devices"])
def test_greedy_kv_quant_decode_matches_jax_on_mesh(nano, devices):
    """Greedy decode with the int8 cross-KV (each shard quantizes its own
    heads) and timestamps on the (4, 2) mesh: the batch of 4 splits into 4
    data rows, each a replica split over 2 devices. Over one device the rows
    share one model and the shards view its weights; over two, alternating
    rows, two replicas with weights of their own."""
    jmodel, build = nano
    tmodel = build()
    mesh_devices = CPU8 if devices == "one device" else (CPU_AND_CPU0 + CPU_AND_CPU0[::-1]) * 2
    got, want = _meshed_decode_pair(
        jmodel, tmodel, _mels(4, 7), dict(language="en", sample_len=12, kv_quant=True), 4, 2,
        devices=mesh_devices,
    )
    _same_results(got, want)
    reps = tmodel._dp_replicas
    q0 = reps[0].decoder.blocks[0].attn.query.parts[0].w
    if devices == "one device":
        assert all(r is tmodel for r in reps)
        assert q0.untyped_storage().data_ptr() == reps[0].decoder.blocks[0].attn.query.parts[1].w.untyped_storage().data_ptr()
    else:
        assert reps[0] is reps[2] is tmodel and reps[1] is reps[3] is not tmodel
        q1 = reps[1].decoder.blocks[0].attn.query.parts[0].w
        assert q0.untyped_storage().data_ptr() != q1.untyped_storage().data_ptr()


def test_beam_decode_matches_jax_on_mesh(nano):
    """Beam search on the (2, 4) mesh: 2 heads over 4 devices leaves two
    shards without heads (their MLP slices still run); the live beams'
    per-shard self-KV reordered with ``HeadShards.index_select``. The model
    was placed on the (4, 2) mesh first: placing it again undoes that."""
    jmodel, build = nano
    tmodel = shard_params_tp(build(), make_mesh(4, 2, devices=CPU8))  # placed again below
    got, want = _meshed_decode_pair(
        jmodel, tmodel, _mels(2, 17), dict(language="en", sample_len=8, beam_size=2), 2, 4
    )
    _same_results(got, want)
    assert len(tmodel.decoder.blocks[0].attn.query.parts) == 2  # 2 heads: 2 of the 4 shards


@pytest.mark.parametrize("n_head,d", [(4, 64), (3, 48)], ids=["4 heads", "3 heads, uneven"])
def test_token_identity_mid_and_uneven_heads(n_head, d):
    """A 4-head model and a 3-head one, whose heads split 2 + 1 over the
    model axis, on the (4, 2) mesh."""
    dims = ModelDimensions(80, 1500, d, n_head, 2, 51865, 448, d, n_head, 2)
    jmodel, build = _pair(dims, seed=3)
    tmodel = build()
    got, want = _meshed_decode_pair(
        jmodel, tmodel, _mels(4, 11), dict(language="en", sample_len=10, kv_quant=True), 4, 2
    )
    _same_results(got, want)
    shards = [h1 - h0 for _, h0, h1 in tmodel.decoder.blocks[0].tp.heads]
    assert shards == ([2, 2] if n_head == 4 else [2, 1])


@pytest.mark.parametrize("qmode", ["int8", "int4"])
def test_quantized_placement_and_decode_on_mesh(nano, qmode):
    """A quantized linear is never split: it stays whole on each row's lead
    device (JAX replicates it) and its output is sliced per shard; the
    decode on the (4, 2) mesh gives JAX's meshed tokens."""
    from whisperx_tpu.quant.core import quantize_model as jquantize
    from whisperx_tpu_torch.quant.core import QuantizedLinear, quantize_model

    jmodel, build = nano
    jq = jquantize(jmodel, qmode)
    tq = quantize_model(build(), qmode)
    got, want = _meshed_decode_pair(jq, tq, _mels(4, 5), dict(language="en", sample_len=8), 4, 2)
    _same_results(got, want)
    qls = [m for m in tq.modules() if isinstance(m, QuantizedLinear)]
    assert qls and all(q.bits == {"int8": 8, "int4": 4}[qmode] for q in qls)
    blk = tq.decoder.blocks[1]
    assert isinstance(blk.attn.query, QuantizedLinear) and blk.tp is not None


def _dp_pipelines(nano_ckpt, opts, batch_size=4):
    import whisperx_tpu
    import whisperx_tpu_torch

    kw = dict(compute_type="float32", vad_method="energy", asr_options=opts,
              language="en", batch_size=batch_size)
    return (
        whisperx_tpu.load_model(nano_ckpt, device="cpu", **kw),
        whisperx_tpu_torch.load_model(nano_ckpt, device="cpu", **kw),
    )


@pytest.fixture(scope="module")
def nano_ckpt(tmp_path_factory):
    from whisperx_tpu.convert.checkpoint import save_checkpoint

    path = str(tmp_path_factory.mktemp("nano_dp"))
    params = jm.init_params(DIMS, jax.random.PRNGKey(0), dtype=jnp.float32)
    save_checkpoint(
        path, params, {"name": "test-nano", "family": "whisper", "dims": dataclasses.asdict(DIMS)}
    )
    return path


def test_data_parallel_pipeline_matches_jax(nano_ckpt):
    """``data_parallel_transcribe`` and ``DataParallelPipeline`` on the
    (4, 2) mesh give the segments of JAX's ``data_parallel_transcribe``:
    ``transcribe``, ``transcribe_many`` (a batch of 3 rounded up to 4, so
    the decode splits over the 4 data rows) and ``warmup``; the model is
    placed once and the proxy delegates the rest."""
    from whisperx_tpu.parallel import data_parallel_transcribe as jdp_transcribe

    opts = {"temperatures": (0.0,), "sample_len": 10}
    audio = synth_speech(40.0, seed=5)
    jpipe, tpipe = _dp_pipelines(nano_ckpt, opts)
    want = jdp_transcribe(jpipe, audio, mesh=jax_mesh(4, 2), batch_size=4)
    mesh = make_mesh(4, 2, devices=CPU8)
    got = data_parallel_transcribe(tpipe, audio, mesh=mesh, batch_size=4)
    assert got["segments"] == want["segments"] and got["segments"]
    assert tpipe.model._dp_mesh is mesh and len(tpipe.model._dp_replicas) == 4

    dp = DataParallelPipeline(tpipe, mesh=mesh)
    assert dp.language == "en" and dp.model is tpipe.model  # delegation
    assert dp.transcribe(audio)["segments"] == want["segments"]
    assert dp._round(3) == 4
    many = dp.transcribe_many([audio, audio[: 16000 * 20]], batch_size=3)
    assert many[0]["segments"] == want["segments"]
    assert many[1]["segments"] == jpipe.transcribe(audio[: 16000 * 20])["segments"]
    assert isinstance(dp.warmup(duration_s=4.0)["segments"], list)


def jax_mesh(n_data, n_model):
    from whisperx_tpu.parallel import make_mesh as jmake_mesh

    return jmake_mesh(n_data=n_data, n_model=n_model)


def test_temperature_fallback_under_dp_equals_unsplit(nano_ckpt, monkeypatch):
    """Random weights fail every quality gate, so each chunk climbs the
    ladder; the sampled temperatures (best_of 2 tiles a batch of 4 into 8
    rows) split over the (4, 1) mesh and must draw the unsplit decode's
    tokens at the same batch size: each slice reads its rows of the whole
    batch's noise."""
    import importlib

    import whisperx_tpu_torch

    tdecode = importlib.import_module("whisperx_tpu_torch.decoding.decode")
    opts = {"temperatures": (0.0, 0.5, 1.0), "sample_len": 8, "best_of": 2}
    audio = synth_speech(40.0, seed=2)
    kw = dict(device="cpu", compute_type="float32", vad_method="energy",
              asr_options=opts, language="en", batch_size=4)
    want = whisperx_tpu_torch.load_model(nano_ckpt, **kw).transcribe(audio)
    dp = DataParallelPipeline(
        whisperx_tpu_torch.load_model(nano_ckpt, **kw), mesh=make_mesh(4, 1, devices=CPU8[:4])
    )
    slices = []
    real = tdecode._SharedNoise.rows

    def counted(self, j, *a):
        slices.append(j)
        return real(self, j, *a)

    monkeypatch.setattr(tdecode._SharedNoise, "rows", counted)
    got = dp.transcribe(audio, batch_size=3)  # rounded up to 4
    assert got["segments"] == want["segments"]
    assert set(slices) == {0, 1, 2, 3}  # every slice sampled


def test_shared_noise_under_thread_contention():
    """``_SharedNoise`` from 24 threads (more than the cores), the switch
    interval shortened: each slice reads exactly its rows of the draw the
    unsplit decode makes at that step, however the threads interleave, and
    slices that stop early leave no draw behind."""
    import importlib
    import sys

    tdecode = importlib.import_module("whisperx_tpu_torch.decoding.decode")
    n, steps, v = 24, 30, 7
    gen = torch.Generator().manual_seed(5)
    want = torch.stack([torch.rand((n, v), generator=gen) for _ in range(steps)])
    shared = tdecode._SharedNoise(torch.Generator().manual_seed(5), n, "cpu", n)
    got = [None] * n

    def slice_(j):
        stop = steps - (j % 5)  # some slices finish early, as decodes do
        try:
            got[j] = torch.stack([shared.rows(j, j, j + 1, t, (1, v))[0] for t in range(stop)])
        finally:
            shared.finish(j)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=slice_, args=(j,)) for j in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for j in range(n):
        torch.testing.assert_close(got[j], want[: len(got[j]), j], rtol=0, atol=0)
    assert shared.draws == {}


def test_word_timing_on_tp_model_matches_jax(nano):
    """Word timing on the (1, 2)-placed model: the alignment heads (1, 0)
    and (1, 1) sit on different shards and come back in head order; the
    same words, tokens, starts and ends as JAX's."""
    from whisperx_tpu.decoding.tokenizer import get_tokenizer as jget
    from whisperx_tpu.timing import find_alignment_batch as jfind
    from whisperx_tpu_torch.decoding.tokenizer import get_tokenizer as tget
    from whisperx_tpu_torch.timing import find_alignment_batch as tfind

    jmodel, build = nano
    tmodel = shard_params_tp(build(), make_mesh(1, 2, devices=CPU8[:2]))
    kw = dict(num_languages=DIMS.num_languages, language="en", task="transcribe")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the partial vocabulary's notice
        jtok, ttok = jget(True, **kw), tget(True, **kw)
    mels = (np.random.default_rng(1).standard_normal((2, 3000, 80)) * 0.5).astype(np.float32)
    lists = [jtok.encode(" Hello world, this is. a \"test\" (of) words!"), jtok.encode(" One two.")]
    want = jfind(jmodel, jtok, lists, jnp.asarray(mels), [3000, 1200])
    got = tfind(tmodel, ttok, lists, torch.from_numpy(mels), [3000, 1200])
    words = lambda a: [(w.word, w.tokens, w.start, w.end) for w in a]  # noqa: E731
    assert [words(a) for a in got] == [words(a) for a in want] and got[0]


def test_speculative_decode_on_tp_model_equals_whole(nano):
    """Speculative decoding on the (1, 2)-placed model: the ``self:1``
    draft shares the target's split blocks and reads its per-shard
    cross-KV; the batched loop (per-row offsets) and the host loop give the
    whole model's tokens."""
    from whisperx_tpu_torch.decoding import DecodingOptions
    from whisperx_tpu_torch.decoding.speculative import SpeculativeDecoder, truncated_self_draft

    _, build = nano
    mel = torch.from_numpy(_mels(3, 13))
    opts = DecodingOptions(language="en", sample_len=12)
    out = []
    for split in (False, True):
        model = build()
        if split:
            shard_params_tp(model, make_mesh(1, 2, devices=CPU8[:2]))
        spec = SpeculativeDecoder(model, truncated_self_draft(model, 1), gamma=2)
        batch = spec.decode_batch_finalize(spec.decode_batch_dispatch(mel, opts, n_real=3))
        out.append(([r.tokens for r in batch], spec.decode(mel[0], opts).tokens))
    assert out[1] == out[0] and out[0][1]


def test_shard_files_strided_and_covering(monkeypatch):
    paths = [f"f{i}.wav" for i in range(10)]
    slices = [shard_files(paths, process_id=p, n_processes=4) for p in range(4)]
    assert sorted(sum(slices, [])) == sorted(paths)
    assert slices[0] == ["f0.wav", "f4.wav", "f8.wav"]
    assert slices[3] == ["f3.wav", "f7.wav"]
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "3")
    assert shard_files(paths) == ["f1.wav", "f4.wav", "f7.wav"]  # torchrun's variables


def test_initialize_multihost_single_process_noop(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert initialize_multihost() == (0, 1)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("n_data,n_model", [(4, 2), (1, 8)])
def test_large_v3_placement_on_meta(n_data, n_model):
    """large-v3 (20 heads, d 1280, 32 + 32 layers, vocab 51866) built on the
    ``meta`` device and walked with the placement policy, so that every
    shard's shape is checked without allocating its 1.5 G weights: whole
    heads (10 + 10, or 3 × 4 + 2 × 4 over 8), mlp slices, row-split out
    and mlp2, everything else whole on the lead device."""
    from whisperx_tpu_torch.models.whisper import Whisper

    dims = MODEL_DIMS["large-v3"]
    model = Whisper(dims, dtype=torch.bfloat16, device="meta")
    mesh = make_mesh(n_data, n_model, devices=[torch.device("meta")] * (n_data * n_model))
    shapes = walk_params_tp(
        model, mesh,
        lambda t, pl: (pl.spec, [tuple(s.shape) for s in pl.split(t)]),
        lambda q, pl: pytest.fail("a bf16 model has no quantized linears"),
    )
    assert len(shapes) == sum(1 for _ in model.parameters())
    heads = [h1 - h0 for _, h0, h1 in split_ranges(20, mesh.devices[0])]
    assert heads == ([10, 10] if n_model == 2 else [3, 3, 3, 3, 2, 2, 2, 2])
    d, hidden = 1280, 5120
    mlp = [hidden // n_model] * n_model
    for stack in ("encoder", "decoder"):
        blk = f"/{stack}/blocks/31"
        for name in ("query", "value"):
            assert shapes[f"{blk}/attn/{name}/w"] == ("col", [(d, 64 * h) for h in heads])
            assert shapes[f"{blk}/attn/{name}/b"] == ("col", [(64 * h,) for h in heads])
        assert shapes[f"{blk}/attn/key/w"] == ("col", [(d, 64 * h) for h in heads])
        assert shapes[f"{blk}/attn/out/w"] == ("row", [(64 * h, d) for h in heads])
        assert shapes[f"{blk}/attn/out/b"] == (None, [(d,)])
        assert shapes[f"{blk}/mlp1/w"] == ("col", [(d, m) for m in mlp])
        assert shapes[f"{blk}/mlp2/w"] == ("row", [(m, d) for m in mlp])
        assert shapes[f"{blk}/mlp_ln/g"] == (None, [(d,)])
    assert shapes["/decoder/blocks/0/cross_attn/out/w"][1] == [(64 * h, d) for h in heads]
    assert shapes["/decoder/tok_emb"] == (None, [(51866, d)])
    assert shapes["/encoder/conv1/w"] == (None, [(3, 128, d)])

"""The port's VADs against the JAX package on the CPU, with the same weights
carried over through the bridge or read from checkpoints that JAX's
``save_checkpoint`` wrote: Silero's ``speech_probs`` within 1e-5; the
PyanNet forward within 1e-4 at ``TEST_CONFIG`` and at the default config on
two windows; the same segments from ``Binarize``, ``SileroVAD``,
``PyannoteVAD`` (with and without a checkpoint), ``BatchVADProcessor``
(empty and short streams too) and ``HybridVAD``; and ``load_vad_model``'s
dispatch, with CUDA refused when there is no GPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synth_speech
from whisperx_tpu.convert.checkpoint import flatten_tree, save_checkpoint
from whisperx_tpu.models.pyannote import model as jpy
from whisperx_tpu.models.silero_vad import model as jsil
from whisperx_tpu import vad as jvad
from whisperx_tpu.vad.batch import BatchVADProcessor as JBatch
from whisperx_tpu_torch import vad as tvad
from whisperx_tpu_torch.convert import checkpoint as tckpt
from whisperx_tpu_torch.models import pyannote as tpy
from whisperx_tpu_torch.models import silero_vad as tsil
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _spans(segs):
    return [(s.start, s.end) for s in segs]


@pytest.fixture(scope="module")
def audio():
    """~21 s: silence, synthetic speech, silence, speech."""
    z = np.zeros(16000, np.float32)
    return np.concatenate([z, synth_speech(8.0, seed=1), z, z, synth_speech(9.3, seed=2)])


@pytest.fixture(scope="module")
def silero_params():
    """JAX's ``init_params`` at the published size (2 × LSTM 64 over 512
    samples), its head scaled by 300 with a bias of -1 so that random
    weights give probabilities that swing across the thresholds (silence
    alone would sit at exactly 0.5 with a zero bias)."""
    params = jsil.init_params(jax.random.PRNGKey(0))
    params["head"]["w"] = params["head"]["w"] * 300.0
    params["head"]["b"] = params["head"]["b"] - 1.0
    return params


@pytest.fixture(scope="module")
def silero_ckpt(tmp_path_factory, silero_params):
    path = str(tmp_path_factory.mktemp("silero"))
    save_checkpoint(path, silero_params, {"family": "silero_vad", "name": "test"})
    return path


def test_silero_speech_probs_match_jax(silero_params, audio):
    """Two streams in one [B, T, 512] call, within 1e-5; the probabilities
    swing across the onset and stay clear of it by more than the
    tolerance, so the segments below cannot flip on rounding."""
    model = tckpt.silero_from_numpy(flatten_tree(silero_params), device="cpu")
    assert (model.lstm.num_layers, model.lstm.hidden_size, model.lstm.input_size) == (2, 64, 512)
    streams = np.stack([audio, audio[::-1].copy()])
    want = np.asarray(jsil.speech_probs(silero_params, jsil.frame_audio(jnp.asarray(streams))))
    got = tsil.speech_probs(model, tsil.frame_audio(torch.from_numpy(streams))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert want.min() < 0.2 and want.max() > 0.8
    assert np.abs(want - 0.5).min() > 1e-4 and np.abs(want - 0.35).min() > 1e-4


def test_silero_checkpoint_round_trip(silero_params, tmp_path):
    """The port's ``save_checkpoint`` writes JAX's Silero layout: JAX reads
    it back to the same probabilities (the 0-d config arrays included)."""
    model = tckpt.silero_from_numpy(flatten_tree(silero_params), device="cpu")
    tckpt.save_checkpoint(str(tmp_path), model, {"family": "silero_vad", "name": "test"})
    flat, _ = tckpt.read_checkpoint(str(tmp_path))
    assert set(flat) == set(flatten_tree(silero_params))
    assert flat["config/hidden_size"].shape == () and int(flat["config/num_layers"]) == 2
    jvad_ = jvad.SileroVAD.from_checkpoint(str(tmp_path))
    x = jnp.asarray(np.random.default_rng(0).standard_normal((1, 7, 512)).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(jsil.speech_probs(jvad_.params, x)),
        np.asarray(jsil.speech_probs(silero_params, x)), atol=0, rtol=0,
    )


@pytest.mark.parametrize("source", ["model_path", "env"])
def test_silero_vad_segments_match_jax(silero_ckpt, audio, source, monkeypatch):
    """``load_vad_model("silero")`` with a checkpoint (by path or by
    ``WHISPERX_TPU_SILERO_CKPT``): the network, on the host waveform and on
    a device-resident one (zero padded past its length), gives JAX's
    segments."""
    from whisperx_tpu_torch.audio.device_chunk import upload_audio

    kw = {"model_path": silero_ckpt} if source == "model_path" else {}
    if source == "env":
        monkeypatch.setenv("WHISPERX_TPU_SILERO_CKPT", silero_ckpt)
    want = jvad.load_vad_model("silero", vad_onset=0.5, chunk_size=6.0, **kw)
    got = tvad.load_vad_model("silero", vad_onset=0.5, chunk_size=6.0, device="cpu", **kw)
    assert isinstance(got, tvad.SileroVAD) and got.supports_device_audio
    expect = _spans(want({"waveform": audio, "sample_rate": 16000}))
    assert expect and _spans(got({"waveform": audio, "sample_rate": 16000})) == expect
    dev = upload_audio(audio, "cpu")
    assert dev.data.shape[0] > len(audio)
    payload = {"waveform": dev.data, "sample_rate": 16000, "length": dev.length}
    assert _spans(got(payload)) == expect


def test_silero_missing_checkpoint_raises_as_jax():
    """A ``model_path`` that does not exist raises JAX's error."""
    with pytest.raises(FileNotFoundError):
        jvad.load_vad_model("silero", model_path="/nonexistent/silero")
    with pytest.raises(FileNotFoundError):
        tvad.load_vad_model("silero", model_path="/nonexistent/silero", device="cpu")


def _pyannet(cfg, seed):
    params = jpy.init_params(cfg, jax.random.PRNGKey(seed))
    return params, tckpt.pyannote_from_numpy(flatten_tree(params), cfg, device="cpu")


@pytest.mark.parametrize(
    "cfg,n_samples",
    [
        pytest.param(jpy.TEST_CONFIG, 160000, id="TEST_CONFIG"),
        pytest.param(jpy.PyanNetConfig(), 160000, id="default"),
    ],
)
def test_pyannet_forward_matches_jax(cfg, n_samples):
    """Two 10 s windows through the whole network (waveform norm, the three
    VALID convs with their pools and norms, the bidirectional LSTMs, the
    tanh linears, log_softmax): log-scores within 1e-4."""
    params, model = _pyannet(cfg, seed=1)
    rng = np.random.default_rng(3)
    audio = np.stack([synth_speech(n_samples / 16000, seed=4), 0.1 * rng.standard_normal(n_samples)])
    audio = audio.astype(np.float32)
    want = np.asarray(jpy.forward(params, cfg, jnp.asarray(audio)))
    got = tpy.forward(model, torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape and got.shape[2] == cfg.num_classes
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # the port writes JAX's layout back, name for name
    assert {k: v.shape for k, v in tckpt.flatten_tree(model).items()} == {
        k: v.shape for k, v in flatten_tree(params).items()
    }


BINARIZE = {
    "hysteresis": dict(onset=0.5, offset=0.363),
    "min-cut": dict(onset=0.5, offset=0.363, max_duration=4.0),
    "padding": dict(onset=0.6, offset=0.4, pad_onset=0.2, pad_offset=0.1, min_duration_off=0.3),
    "min_duration_on": dict(onset=0.5, min_duration_on=0.5),
}


@pytest.mark.parametrize("case", list(BINARIZE))
def test_binarize_matches_jax(case):
    rng = np.random.default_rng(7)
    scores = np.clip(np.repeat(rng.random(60), 7) + 0.15 * rng.standard_normal(420), 0, 1)
    times = (np.arange(420) + 0.5) * 0.05
    want = jvad.Binarize(**BINARIZE[case])(scores, times)
    got = tvad.Binarize(**BINARIZE[case])(scores, times)
    assert _spans(got) == _spans(want) and got


@pytest.fixture(scope="module")
def pyannote_ckpt(tmp_path_factory):
    """A TEST_CONFIG PyanNet checkpoint in the converter's layout, written
    by JAX's ``save_checkpoint``; its classifier's bias favours the
    non-silence classes where the input is loud (a sharper head), so that
    the random network's scores move across the thresholds."""
    cfg = jpy.TEST_CONFIG
    params = jpy.init_params(cfg, jax.random.PRNGKey(5))
    params["classifier"]["w"] = params["classifier"]["w"] * 60.0
    path = str(tmp_path_factory.mktemp("pyannote"))
    config = {
        **dataclasses.asdict(cfg),
        "sincnet_filters": list(cfg.sincnet_filters),
        "sincnet_kernels": list(cfg.sincnet_kernels),
        "sincnet_strides": list(cfg.sincnet_strides),
        "linear_dims": list(cfg.linear_dims),
    }
    save_checkpoint(path, params, {"family": "pyannote_segmentation", "name": "test", "config": config})
    return path


@pytest.mark.parametrize("checkpoint", [False, True], ids=["energy scores", "checkpoint"])
@pytest.mark.parametrize("chunk_size", [30.0, 5.0])
def test_pyannote_vad_matches_jax(pyannote_ckpt, audio, checkpoint, chunk_size):
    """``load_vad_model("pyannote")``: without a checkpoint the energy
    scores go into Binarize (JAX's documented behaviour); with one, every
    10 s window at a 1 s step in one batched forward, averaged onto one
    frame grid. The same frame scores (1e-4) and segments as JAX's."""
    kw = dict(vad_onset=0.5, vad_offset=0.363, chunk_size=chunk_size)
    if checkpoint:
        kw["model_path"] = pyannote_ckpt
    want = jvad.load_vad_model("pyannote", **kw)
    got = tvad.load_vad_model("pyannote", device="cpu", **kw)
    assert (got._model is not None) == checkpoint
    ws, wt = want._frame_scores(audio)
    gs, gt = got._frame_scores(audio)
    np.testing.assert_array_equal(gt, wt)
    np.testing.assert_allclose(gs, ws, atol=1e-4, rtol=0)
    if checkpoint:
        margin = np.minimum(np.abs(ws - 0.5), np.abs(ws - 0.363)).min()
        assert margin > 1e-4, margin
    expect = _spans(want({"waveform": audio, "sample_rate": 16000}))
    assert expect and _spans(got({"waveform": audio, "sample_rate": 16000})) == expect


@pytest.mark.parametrize("backend", ["energy", "silero"])
def test_batch_vad_processor_matches_jax(silero_ckpt, audio, backend, monkeypatch):
    """Every stream in one call, an empty and a 0.3 s stream among them:
    with the Silero network one [B, T, 512] forward, with the energy
    fallback each row scored at its true length. JAX's segments."""
    if backend == "silero":
        monkeypatch.setenv("WHISPERX_TPU_SILERO_CKPT", silero_ckpt)
    else:
        monkeypatch.delenv("WHISPERX_TPU_SILERO_CKPT", raising=False)
    streams = [audio, np.zeros(0, np.float32), audio[: int(0.3 * 16000)], audio[16000 * 9 :]]
    with pytest.warns() if backend == "energy" else _nothing():
        want = JBatch(vad_onset=0.5, chunk_size=6.0).process_batch(streams)
        proc = tvad.BatchVADProcessor(device="cpu", vad_onset=0.5, chunk_size=6.0)
    got = proc.process_batch(streams)
    assert isinstance(proc.vad, tvad.SileroVAD if backend == "silero" else tvad.EnergyVAD)
    assert [_spans(s) for s in got] == [_spans(s) for s in want]
    assert got[1] == [] and got[0] and proc.stats == {"files": 4, "batches": 1}
    assert tvad.BatchVADProcessor(proc.vad).process_batch([]) == []


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("backend", ["energy", "silero"])
def test_hybrid_vad_matches_jax(silero_ckpt, audio, backend, monkeypatch):
    """``load_vad_model("hybrid")``: real Silero weights when a checkpoint
    is configured, else the energy VAD; the backend's attributes show
    through the wrapper (so the pipeline hands it the device audio)."""
    if backend == "silero":
        monkeypatch.setenv("WHISPERX_TPU_SILERO_CKPT", silero_ckpt)
    else:
        monkeypatch.delenv("WHISPERX_TPU_SILERO_CKPT", raising=False)
    want = jvad.load_vad_model("hybrid", vad_onset=0.4, chunk_size=7.0)
    got = tvad.load_vad_model("hybrid", vad_onset=0.4, chunk_size=7.0, device="cpu")
    assert isinstance(got, tvad.HybridVAD)
    assert isinstance(got.backend, tvad.SileroVAD if backend == "silero" else tvad.EnergyVAD)
    assert got.supports_device_audio is True and got.vad_onset == 0.4 and got.chunk_size == 7.0
    expect = _spans(want({"waveform": audio, "sample_rate": 16000}))
    assert expect and _spans(got({"waveform": audio, "sample_rate": 16000})) == expect
    assert got.stats == {"calls": 1}


@pytest.mark.parametrize("method", ["silero", "energy", "pyannote", "hybrid"])
def test_load_vad_model_refuses_cuda_without_a_gpu(method, monkeypatch):
    """No fallback to the CPU: ``device="cuda"`` (the default) without a GPU
    raises, whatever the method; an unknown method is a ``ValueError``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tvad.load_vad_model(method)
    with pytest.raises(ValueError, match="Unknown VAD method"):
        tvad.load_vad_model("webrtc", device="cpu")


def test_pipeline_runs_each_vad_as_jax(silero_ckpt, tmp_path, monkeypatch):
    """``load_model(..., vad_method=...)``, the VAD on the pipeline's device:
    silero and hybrid with the Silero checkpoint of
    ``WHISPERX_TPU_SILERO_CKPT``, and pyannote (``load_model`` passes no
    segmentation checkpoint, in either package: energy scores); the same
    f32 test-nano checkpoint gives the JAX pipeline's segments."""
    import whisperx_tpu
    import whisperx_tpu_torch
    from whisperx_tpu.models.whisper import model as jm
    from whisperx_tpu.models.whisper.config import MODEL_DIMS

    dims = MODEL_DIMS["test-nano"]
    ckpt = str(tmp_path / "nano")
    save_checkpoint(
        ckpt, jm.init_params(dims, jax.random.PRNGKey(0), dtype=jnp.float32),
        {"name": "test-nano", "family": "whisper", "dims": dataclasses.asdict(dims)},
    )
    monkeypatch.setenv("WHISPERX_TPU_SILERO_CKPT", silero_ckpt)
    audio = np.concatenate([np.zeros(16000, np.float32), synth_speech(14.0, seed=6)])
    call = dict(language="en", temperatures=(0.0,), sample_len=12)
    kinds = {"silero": tvad.SileroVAD, "hybrid": tvad.HybridVAD}
    for method in ("silero", "hybrid", "pyannote"):
        kw = dict(vad_method=method, compute_type="float32")
        want = whisperx_tpu.load_model(ckpt, device="cpu", **kw).transcribe(audio, **call)
        pipe = whisperx_tpu_torch.load_model(ckpt, device="cpu", **kw)
        assert isinstance(pipe.vad_model, kinds.get(method, object)), method
        got = pipe.transcribe(audio, **call)
        assert got == want and got["segments"], method

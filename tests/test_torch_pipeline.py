"""The port's transcription pipeline end to end on the CPU: the same
checkpoint through ``whisperx_tpu.load_model`` and
``whisperx_tpu_torch.load_model`` gives identical segments; the port runs
without JAX or the JAX package; CUDA is never silently replaced by the CPU;
options this slice does not run raise."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import synth_speech
from whisperx_tpu.convert.checkpoint import save_checkpoint
from whisperx_tpu.models.whisper.config import MODEL_DIMS
from whisperx_tpu.models.whisper.model import init_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = MODEL_DIMS["test-nano"]


@pytest.fixture(scope="module")
def nano_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("nano_f32"))
    params = init_params(DIMS, jax.random.PRNGKey(0), dtype=jnp.float32)
    save_checkpoint(
        path, params,
        {"name": "test-nano", "family": "whisper", "dims": dataclasses.asdict(DIMS)},
    )
    return path


@pytest.fixture(scope="module")
def speech35():
    return synth_speech(35.0)


def _pipelines(ckpt):
    import whisperx_tpu
    import whisperx_tpu_torch

    kw = dict(compute_type="float32", vad_method="energy")
    return (
        whisperx_tpu.load_model(ckpt, device="cpu", **kw),
        whisperx_tpu_torch.load_model(ckpt, device="cpu", **kw),
    )


@pytest.mark.parametrize("language", ["en", None])
def test_segments_identical_to_jax(nano_ckpt, speech35, language):
    """Greedy f32 transcription (one temperature): the same segment list,
    timestamps and text, as the JAX package. ``language=None`` adds language
    detection on the first chunk."""
    jpipe, tpipe = _pipelines(nano_ckpt)
    want = jpipe.transcribe(speech35, language=language, temperatures=(0.0,))
    got = tpipe.transcribe(speech35, language=language, temperatures=(0.0,))
    assert got == want
    assert len(got["segments"]) >= 2
    for seg in got["segments"]:
        assert 0.0 <= seg["start"] < seg["end"] <= 35.0


def test_fallback_temperatures_rerun_failing_chunks(nano_ckpt, speech35):
    """Random weights fail the log-prob gate, so every chunk is re-decoded
    at the next temperature; the result keeps its structure."""
    from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER

    _, tpipe = _pipelines(nano_ckpt)
    GLOBAL_TRACKER.reset()
    got = tpipe.transcribe(speech35, language="en", temperatures=(0.0, 0.5), sample_len=24)
    assert GLOBAL_TRACKER.stages["decode"].calls == 2
    assert set(got) == {"segments", "language"}
    for seg in got["segments"]:
        assert 0.0 <= seg["start"] < seg["end"] <= 35.0


def test_port_runs_without_jax(nano_ckpt):
    """A fresh interpreter imports the port (its CLI, orchestrator, backends,
    seek loop, kernels' modules and quantization too) and transcribes, with
    a VAD and without; neither jax nor any module of the JAX package is
    loaded."""
    code = textwrap.dedent(
        f"""
        import sys
        import numpy as np
        import whisperx_tpu_torch
        import whisperx_tpu_torch.__main__
        import whisperx_tpu_torch.backends
        import whisperx_tpu_torch.decoding.transcribe
        import whisperx_tpu_torch.ops.cross_attention_decode
        import whisperx_tpu_torch.ops.flash_attention
        import whisperx_tpu_torch.quant
        import whisperx_tpu_torch.transcribe
        t = np.arange(16000 * 12) / 16000
        audio = (0.3 * np.sin(2 * np.pi * 220 * t) * (np.sin(2 * np.pi * 0.3 * t) > 0)).astype(np.float32)
        pipe = whisperx_tpu_torch.load_model(
            {nano_ckpt!r}, device="cpu", compute_type="float32", vad_method="energy"
        )
        out = pipe.transcribe(audio, language="en", temperatures=(0.0,), sample_len=16)
        assert out["language"] == "en" and out["segments"], out
        seq = whisperx_tpu_torch.load_model(
            {nano_ckpt!r}, device="cpu", compute_type="float32", vad_method="none"
        )
        out = seq.transcribe(audio, language="en", temperatures=(0.0,), sample_len=16)
        assert out["language"] == "en", out
        bad = sorted(
            m for m in sys.modules
            if m == "jax" or m.startswith("jax.") or m == "jaxlib"
            or m == "whisperx_tpu" or m.startswith("whisperx_tpu.")
        )
        assert not bad, bad
        print("OK")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"  # as torch_threads.py, for the same reason
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=REPO, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


@pytest.mark.parametrize("tf32,bf16_reduced", [(True, True), (False, False)])
def test_caller_matmul_settings_kept(monkeypatch, tf32, bf16_reduced):
    """The port sets its reference numerics (no TF32, bf16 reduced in f32)
    only while its own forward passes run: the process's settings are the
    same after a transcription as before, and are off inside one."""
    import whisperx_tpu_torch
    from whisperx_tpu_torch.models.whisper import model as wmodel

    m = torch.backends.cuda.matmul
    monkeypatch.setattr(m, "allow_tf32", tf32)
    monkeypatch.setattr(m, "allow_bf16_reduced_precision_reduction", bf16_reduced)
    seen = []
    layer_norm = wmodel.layer_norm

    def spy(*args, **kwargs):
        seen.append((m.allow_tf32, m.allow_bf16_reduced_precision_reduction))
        return layer_norm(*args, **kwargs)

    monkeypatch.setattr(wmodel, "layer_norm", spy)
    pipe = whisperx_tpu_torch.load_model("test-nano", device="cpu", vad_method="energy")
    pipe.transcribe(synth_speech(8.0), language="en", temperatures=(0.0,), sample_len=4)
    assert seen and set(seen) == {(False, False)}
    assert (m.allow_tf32, m.allow_bf16_reduced_precision_reduction) == (tf32, bf16_reduced)


def test_cuda_without_a_gpu_raises(monkeypatch):
    import whisperx_tpu_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        whisperx_tpu_torch.load_model("test-nano", vad_method="energy")


@pytest.mark.parametrize(
    "kwargs",
    [
        # the sequential modes run (tests/test_torch_sequential.py); what
        # they cannot run yet still raises
        dict(backend="standard", asr_options={"word_timestamps": True}),
        dict(vad_method="none", asr_options={"draft_model": "self:1"}),
        dict(backend="sequential", vad_method="pyannote"),
        dict(vad_method=None, asr_options={"word_timestamps": True}),
        dict(vad_method="pyannote"),
        dict(vad_method="hybrid"),
        dict(asr_options={"draft_model": "self:1"}),
        dict(asr_options={"draft_model": "tiny"}),
        dict(asr_options={"word_timestamps": True}),
    ],
)
def test_unported_load_options_raise(kwargs):
    import whisperx_tpu_torch

    kw = {"device": "cpu", "vad_method": "energy", **kwargs}
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        whisperx_tpu_torch.load_model("test-nano", **kw)


@pytest.mark.parametrize(
    "option", [{"draft_model": "tiny"}, {"word_timestamps": True}, {"draft_model": "self:1"}]
)
def test_unported_call_options_raise(option):
    import whisperx_tpu_torch

    pipe = whisperx_tpu_torch.load_model("test-nano", device="cpu", vad_method="energy")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        pipe.transcribe(synth_speech(2.0), language="en", **option)
    with pytest.raises(TypeError, match="Unknown transcribe option"):
        pipe.transcribe(synth_speech(2.0), language="en", beamsize=2)


def test_sequential_decode_mode_raises():
    """The sequential mode runs now; word timing, which it would need for
    ``word_timestamps``, is not ported yet and raises."""
    from whisperx_tpu_torch.asr import TranscriptionPipeline
    from whisperx_tpu_torch.vad import EnergyVAD

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TranscriptionPipeline(
            model=None, vad_model=EnergyVAD(), decode_mode="sequential",
            asr_options={"word_timestamps": True},
        )
    assert TranscriptionPipeline(model=None, decode_mode="sequential").vad_model is None


def test_silero_without_checkpoint_falls_back_to_energy(monkeypatch):
    from whisperx_tpu_torch.vad import EnergyVAD, load_vad_model

    monkeypatch.delenv("WHISPERX_TPU_SILERO_CKPT", raising=False)
    with pytest.warns(UserWarning, match="energy"):
        vad = load_vad_model("silero")
    assert isinstance(vad, EnergyVAD)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        load_vad_model("silero", model_path="/nonexistent/silero")

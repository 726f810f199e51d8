"""The port's transcription pipeline end to end on the CPU: the same
checkpoint through ``whisperx_tpu.load_model`` and
``whisperx_tpu_torch.load_model`` gives identical segments (and words, with
``word_timestamps``); the reference's compatibility keywords are accepted;
the ``WHISPERX_TPU_*`` switches are honoured or refused as the port's rule
says; the port runs without JAX or the JAX package; CUDA is never silently
replaced by the CPU; the options that once raised (stages not ported then)
run and give JAX's results."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
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
    seek loop, kernels' modules, quantization, alignment, word timing and
    the native audio library, speculative decoding, every VAD, diarization,
    the unified pipeline, the serving layer, the converters with their
    entry point, and the trainers too), transcribes with word timestamps,
    with a VAD and without, with a ``self:1`` draft behind the pyannote VAD, runs
    the Silero network through the batch processor, aligns (random weights,
    allowed by the suite's ``WHISPERX_TPU_ALLOW_RANDOM_ALIGN``), diarizes on
    both paths (the ResNet embedding with PLDA clustering; a segmenter) and
    scores the turns, and runs ``load_pipeline`` with diarization; neither
    jax nor any module of the JAX package is loaded, nor optax, safetensors
    or transformers, nor pandas by the imports."""
    code = textwrap.dedent(
        f"""
        import sys
        import numpy as np
        import whisperx_tpu_torch
        import whisperx_tpu_torch.__main__
        import whisperx_tpu_torch.alignment
        import whisperx_tpu_torch.backends
        import whisperx_tpu_torch.decoding.transcribe
        import whisperx_tpu_torch.ops.cross_attention_decode
        import whisperx_tpu_torch.ops.flash_attention
        import whisperx_tpu_torch.native
        import whisperx_tpu_torch.quant
        import whisperx_tpu_torch.timing
        import whisperx_tpu_torch.transcribe
        import whisperx_tpu_torch.decoding.speculative
        import whisperx_tpu_torch.models.pyannote
        import whisperx_tpu_torch.models.silero_vad
        import whisperx_tpu_torch.vad.batch
        import whisperx_tpu_torch.vad.pyannote_vad
        import whisperx_tpu_torch.diarize
        import whisperx_tpu_torch.diarize.plda
        import whisperx_tpu_torch.models.resnet_speaker
        import whisperx_tpu_torch.pipeline
        import whisperx_tpu_torch.pipeline.batch_processor
        import whisperx_tpu_torch.utils.metrics
        import whisperx_tpu_torch.utils.wer
        import whisperx_tpu_torch.serve
        import whisperx_tpu_torch.serve.__main__
        import whisperx_tpu_torch.convert.__main__
        import whisperx_tpu_torch.convert.pyannote
        import whisperx_tpu_torch.convert.safetensors
        import whisperx_tpu_torch.convert.silero
        import whisperx_tpu_torch.convert.wav2vec2_hf
        import whisperx_tpu_torch.convert.wespeaker
        import whisperx_tpu_torch.convert.whisper_hf
        import whisperx_tpu_torch.parallel
        import whisperx_tpu_torch.train
        import whisperx_tpu_torch.train.align_online
        import whisperx_tpu_torch.train.ctc_micro
        import whisperx_tpu_torch.train.optim
        from whisperx_tpu_torch.convert import load_checkpoint, save_checkpoint
        # no module of the port imports pandas (alignment's optional nltk
        # may, when it runs)
        assert not [m for m in sys.modules if m == "pandas" or m.startswith("pandas.")]
        t = np.arange(16000 * 12) / 16000
        audio = (0.3 * np.sin(2 * np.pi * 220 * t) * (np.sin(2 * np.pi * 0.3 * t) > 0)).astype(np.float32)
        pipe = whisperx_tpu_torch.load_model(
            {nano_ckpt!r}, device="cpu", compute_type="float32", vad_method="energy"
        )
        out = pipe.transcribe(
            audio, language="en", temperatures=(0.0,), sample_len=16, word_timestamps=True
        )
        assert out["language"] == "en" and out["segments"], out
        assert any(seg["words"] for seg in out["segments"]), out
        aligner, meta = whisperx_tpu_torch.load_align_model("en", device="cpu")
        aligned = whisperx_tpu_torch.align(out["segments"], aligner, meta, audio, "cpu")
        assert aligned["word_segments"], aligned
        assert len(whisperx_tpu_torch.native.resample(audio, 16000, 8000)) == len(audio) // 2
        spec = whisperx_tpu_torch.load_model(
            {nano_ckpt!r}, device="cpu", compute_type="float32", vad_method="pyannote",
            asr_options={{"draft_model": "self:1", "spec_gamma": 2}},
        )
        out = spec.transcribe(audio, language="en", temperatures=(0.0,), sample_len=16)
        assert out["segments"] and spec._spec_decoder is not None, out
        sil = whisperx_tpu_torch.vad.SileroVAD(device="cpu")
        assert whisperx_tpu_torch.vad.BatchVADProcessor(sil).process_batch([audio]) is not None
        seq = whisperx_tpu_torch.load_model(
            {nano_ckpt!r}, device="cpu", compute_type="float32", vad_method="none"
        )
        out = seq.transcribe(audio, language="en", temperatures=(0.0,), sample_len=16)
        assert out["language"] == "en", out
        from whisperx_tpu_torch.diarize import DiarizationPipeline, SpeakerSegmenter
        from whisperx_tpu_torch.models.resnet_speaker import ResNetSpeakerEmbedding
        from whisperx_tpu_torch.vad import EnergyVAD
        turns = DiarizationPipeline(
            device="cpu", clustering="plda", vad_model=EnergyVAD(),
            embedding_model=ResNetSpeakerEmbedding(device="cpu"),
        )(audio)
        assert len(turns) and whisperx_tpu_torch.utils.diarization_error_rate(turns, turns)["der"] == 0.0
        seg = DiarizationPipeline(device="cpu", segmentation_model=SpeakerSegmenter(device="cpu"))
        seg(audio, num_speakers=2)
        unified = whisperx_tpu_torch.load_pipeline(
            {nano_ckpt!r}, device="cpu", vad_method="energy", compute_type="float32",
            language="en", align=False, diarize=True,
            asr_options={{"temperatures": (0.0,), "sample_len": 16}},
        )
        out = unified(audio)
        assert all("speaker" in s for s in out["segments"]) and out["segments"], out
        assert whisperx_tpu_torch.utils.metrics.device_memory_report() == {{}}
        assert whisperx_tpu_torch.utils.wer.wer("a b", "a c") == 0.5
        bad = sorted(
            m for m in sys.modules
            if m == "jax" or m.startswith("jax.") or m == "jaxlib"
            or m == "whisperx_tpu" or m.startswith("whisperx_tpu.")
            or m.split(".")[0] in ("safetensors", "transformers", "optax")
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


def _same_result(got, want):
    """Identical segments, and words with the same text, starts and ends;
    the words' probabilities (two softmax implementations) within 1e-6."""
    probs = []
    for result in (got, want):
        probs.append([w.pop("probability") for s in result["segments"] for w in s.get("words", [])])
    assert got == want
    np.testing.assert_allclose(probs[0], probs[1], atol=1e-6, rtol=0)


@pytest.mark.parametrize(
    "kwargs",
    [
        # every option of load_model is ported: each case runs and gives the
        # JAX package's result (word timing in every mode, speculative
        # decoding, the pyannote and hybrid VADs)
        dict(backend="standard", asr_options={"word_timestamps": True}),
        dict(vad_method="none", asr_options={"draft_model": "self:1"}),
        dict(backend="sequential", vad_method="pyannote"),
        dict(vad_method=None, asr_options={"word_timestamps": True}),
        dict(vad_method="pyannote"),
        dict(vad_method="hybrid"),
        dict(asr_options={"draft_model": "self:1"}),
        # one drafted token a verify pass: the random tiny draft's steps
        # (its cross-attention over 1500 frames) made these the slowest
        # cases; greedy's tokens and JAX's segments hold at any γ
        # (test_torch_speculative.py holds the other γ against JAX)
        dict(asr_options={"draft_model": "tiny", "spec_gamma": 1}),
        dict(asr_options={"word_timestamps": True}),
    ],
)
def test_unported_load_options_raise(kwargs, nano_ckpt, speech35):
    """The options of ``load_model`` that once raised (stages not ported
    then) now run, each giving the JAX package's result: word timing in the
    batched pipeline, the seek loop over each VAD chunk
    (``backend="standard"``) and over the whole file (no VAD); a
    ``draft_model`` (``self:1`` or a random ``tiny``: token-identical to
    greedy whatever its weights; the seek loop without a VAD ignores it, as
    in JAX); the pyannote VAD (energy scores without a checkpoint) and the
    hybrid one (the energy fallback), batched and sequential."""
    import whisperx_tpu
    import whisperx_tpu_torch

    kw = {"vad_method": "energy", **kwargs}
    kw.update(compute_type="float32", language="en")
    kw["asr_options"] = {**kw.get("asr_options", {}), "temperatures": (0.0,), "sample_len": 24}
    audio = speech35[: 16000 * 20]
    want = whisperx_tpu.load_model(nano_ckpt, device="cpu", **kw).transcribe(audio)
    got = whisperx_tpu_torch.load_model(nano_ckpt, device="cpu", **kw).transcribe(audio)
    assert got["segments"]
    if kw["asr_options"].get("word_timestamps"):
        assert any(s.get("words") for s in got["segments"])
    _same_result(got, want)


@pytest.mark.parametrize(
    "option",
    # γ 1 for the random tiny draft, as in test_unported_load_options_raise
    [{"draft_model": "tiny", "spec_gamma": 1}, {"word_timestamps": True}, {"draft_model": "self:1"}],
)
def test_unported_call_options_raise(option, nano_ckpt, speech35):
    """A misspelt per-call option is a ``TypeError``. The per-call options
    that once raised now run for that call and give the JAX package's
    result: ``word_timestamps=True`` its words, a ``draft_model`` its
    segments (a first call: JAX builds its speculative decoder then too)."""
    import whisperx_tpu_torch

    pipe = whisperx_tpu_torch.load_model("test-nano", device="cpu", vad_method="energy")
    with pytest.raises(TypeError, match="Unknown transcribe option"):
        pipe.transcribe(synth_speech(2.0), language="en", beamsize=2)
    jpipe, tpipe = _pipelines(nano_ckpt)
    kw = dict(language="en", temperatures=(0.0,), sample_len=24, **option)
    got = tpipe.transcribe(speech35, **kw)
    assert got["segments"]
    if "word_timestamps" in option:
        assert any(s["words"] for s in got["segments"])
    _same_result(got, jpipe.transcribe(speech35, **kw))


def test_sequential_decode_mode_raises(nano_ckpt, speech35):
    """The sequential mode (the seek loop over each VAD chunk) runs word
    timing too, with the hallucination-silence threshold: the words, shifted
    to the file's timeline and clamped to their segments, are the JAX
    package's."""
    from whisperx_tpu.asr import TranscriptionPipeline as JPipeline
    from whisperx_tpu_torch.asr import TranscriptionPipeline
    from whisperx_tpu_torch.vad import EnergyVAD

    jpipe, tpipe = _pipelines(nano_ckpt)
    options = {"word_timestamps": True, "temperatures": (0.0,)}
    results = []
    for pipe, cls in ((jpipe, JPipeline), (tpipe, TranscriptionPipeline)):
        seq = cls(model=pipe.model, vad_model=pipe.vad_model, decode_mode="sequential",
                  asr_options=options)
        results.append([
            seq.transcribe(speech35, language="en", sample_len=24, **kw)
            for kw in ({}, {"hallucination_silence_threshold": 1.0})
        ])
    assert isinstance(tpipe.vad_model, EnergyVAD)
    assert any(s.get("words") for s in results[1][0]["segments"])
    for got, want in zip(results[1], results[0]):
        _same_result(got, want)
    assert TranscriptionPipeline(model=None, decode_mode="sequential").vad_model is None


def test_reference_compat_keywords_are_accepted(nano_ckpt, speech35):
    """``load_model`` accepts and ignores ``device_index``,
    ``download_root``, ``local_files_only``, ``threads`` and any other
    keyword, and ``transcribe`` accepts ``combined_progress``, as the JAX
    package does (ADVICE r5, asr.py:261): the same transcript as JAX's with
    the same five names."""
    import whisperx_tpu
    import whisperx_tpu_torch

    kw = dict(
        device="cpu", device_index=0, download_root=str(nano_ckpt), local_files_only=True,
        threads=2, some_future_option=1, compute_type="float32", vad_method="energy",
    )
    call = dict(language="en", temperatures=(0.0,), sample_len=16, combined_progress=True)
    audio = speech35[: 16000 * 12]
    want = whisperx_tpu.load_model(nano_ckpt, **kw).transcribe(audio, **call)
    got = whisperx_tpu_torch.load_model(nano_ckpt, **kw).transcribe(audio, **call)
    assert got == want and got["segments"]


def test_per_call_options_leave_the_pipeline_options(nano_ckpt):
    """A divergence from the reference, named (ADVICE r5, asr.py:267): JAX
    swaps a call's options into ``self.asr_options`` while it runs; the port
    applies them to a copy, so ``pipe.asr_options`` is never touched, not
    even during the call (a concurrent caller sees the pipeline's own)."""
    import whisperx_tpu_torch
    from whisperx_tpu_torch import asr

    _, pipe = _pipelines(nano_ckpt)
    before = dict(pipe.asr_options)
    seen = []
    real = asr.TranscriptionPipeline._transcribe_chunks

    def spy(self, *a, **k):
        seen.append((dict(self.asr_options), a[2]["sample_len"], a[2]["word_timestamps"]))
        return real(self, *a, **k)

    asr.TranscriptionPipeline._transcribe_chunks = spy
    try:
        pipe.transcribe(synth_speech(4.0), language="en", temperatures=(0.0,),
                        sample_len=8, word_timestamps=True)
    finally:
        asr.TranscriptionPipeline._transcribe_chunks = real
    assert pipe.asr_options == before and isinstance(pipe, whisperx_tpu_torch.asr.TranscriptionPipeline)
    assert seen == [(before, 8, True)]


@pytest.mark.parametrize("budget", [None, "0.001", "0.5", "80"])
def test_kv_budget_switch_matches_jax(monkeypatch, budget):
    """``WHISPERX_TPU_KV_HBM_GB`` sets the decode-row budget with the JAX
    package's formula and default (8 GiB)."""
    from types import SimpleNamespace

    from whisperx_tpu.asr import _max_decode_rows as jax_rows
    from whisperx_tpu.models.whisper.config import get_dims
    from whisperx_tpu_torch.asr import _max_decode_rows

    if budget is None:
        monkeypatch.delenv("WHISPERX_TPU_KV_HBM_GB", raising=False)
    else:
        monkeypatch.setenv("WHISPERX_TPU_KV_HBM_GB", budget)
    for name in ("test-nano", "large-v3"):
        model = SimpleNamespace(dims=get_dims(name))
        for kv_quant, sample_len in ((True, None), (False, None), (True, 24)):
            got = _max_decode_rows(model, kv_quant=kv_quant, sample_len=sample_len)
            assert got == jax_rows(model, kv_quant=kv_quant, sample_len=sample_len), name
    if budget == "0.001":  # less than one row: still one
        assert _max_decode_rows(model, kv_quant=True, sample_len=None) == 1


def test_kv_quant_switch_forces_the_int8_cache(monkeypatch, nano_ckpt):
    """``WHISPERX_TPU_KV_QUANT=int8`` quantizes the cross-KV cache even
    where the options say ``kv_quant=False`` (the seek loop), as in JAX:
    the same tokens as the JAX seek loop under the same switch."""
    import importlib

    from whisperx_tpu.decoding.transcribe import transcribe as jax_transcribe
    from whisperx_tpu_torch.decoding.transcribe import transcribe

    # the module: the package's ``decoding.decode`` is the function
    tdec = importlib.import_module("whisperx_tpu_torch.decoding.decode")

    jpipe, tpipe = _pipelines(nano_ckpt)
    calls = []
    real = tdec.quantize_kv
    monkeypatch.setattr(tdec, "quantize_kv", lambda x: calls.append(1) or real(x))
    kw = dict(language="en", temperature=0.0, sample_len=8)
    audio = synth_speech(6.0, seed=3)  # one window
    transcribe(tpipe.model, audio, **kw)
    assert calls == []
    monkeypatch.setenv("WHISPERX_TPU_KV_QUANT", "int8")
    got = transcribe(tpipe.model, audio, **kw)
    assert len(calls) == 2 * tpipe.model.dims.n_text_layer  # K and V of each layer
    want = jax_transcribe(jpipe.model, audio, **kw)
    assert [s["tokens"] for s in got["segments"]] == [s["tokens"] for s in want["segments"]]


@pytest.mark.parametrize("switch", ["WHISPERX_TPU_FLASH", "WHISPERX_TPU_NO_PALLAS_QUANT"])
def test_xla_route_switches_raise_on_cuda_and_change_nothing_on_cpu(monkeypatch, nano_ckpt, switch):
    """JAX's ``WHISPERX_TPU_FLASH=0`` and ``WHISPERX_TPU_NO_PALLAS_QUANT``
    pick its XLA route over the Pallas kernel. The port has none (a CUDA
    tensor launches the kernel or raises): on a CUDA tensor the switch
    raises a ``ValueError`` naming it and the rule; on the CPU, where the
    plain version runs anyway, the transcript is unchanged."""
    from types import SimpleNamespace

    import whisperx_tpu_torch
    from whisperx_tpu_torch import ops
    from whisperx_tpu_torch.models.whisper import model as wmodel
    from whisperx_tpu_torch.ops import quant_matmul

    value = "0" if switch == "WHISPERX_TPU_FLASH" else "1"
    monkeypatch.setenv(switch, value)
    with pytest.raises(ValueError, match=f"{switch}='{value}'.*launches the hand-written kernel or raises"):
        ops.refuse_xla_route(switch, True, SimpleNamespace(is_cuda=True))
    ops.refuse_xla_route(switch, True, SimpleNamespace(is_cuda=False))

    asked = []
    for mod in (wmodel, quant_matmul):  # the call sites read the switch
        real = mod.refuse_xla_route
        monkeypatch.setattr(mod, "refuse_xla_route",
                            lambda name, on, t, real=real: asked.append((name, on)) or real(name, on, t))
    kw = dict(device="cpu", vad_method="energy", compute_type="int8")
    call = dict(language="en", temperatures=(0.0,), sample_len=8)
    audio = synth_speech(6.0, seed=4)
    with_switch = whisperx_tpu_torch.load_model(nano_ckpt, **kw).transcribe(audio, **call)
    assert (switch, True) in asked
    monkeypatch.delenv(switch)
    assert whisperx_tpu_torch.load_model(nano_ckpt, **kw).transcribe(audio, **call) == with_switch


def test_silero_without_checkpoint_falls_back_to_energy(monkeypatch):
    """Without a converted Silero checkpoint, the energy VAD with a warning;
    a ``model_path`` that does not exist raises JAX's error (the network is
    ported: ``tests/test_torch_vad.py``). The VAD takes the pipeline's
    device, here the CPU."""
    from whisperx_tpu_torch.vad import EnergyVAD, load_vad_model

    monkeypatch.delenv("WHISPERX_TPU_SILERO_CKPT", raising=False)
    with pytest.warns(UserWarning, match="energy"):
        vad = load_vad_model("silero", device="cpu")
    assert isinstance(vad, EnergyVAD)
    with pytest.raises(FileNotFoundError):
        load_vad_model("silero", model_path="/nonexistent/silero", device="cpu")

"""The port's unified four-stage pipeline (VAD → ASR → align → diarize in
one call) and its batch processor against the JAX package on the CPU: the
same test-nano f32 checkpoint and TEST_CONFIG aligner (written by JAX's
``save_checkpoint``) through ``load_pipeline`` give JAX's result dict, with
and without alignment and diarization; ``BatchProcessor`` chunks, batches,
pads and merges as JAX's; ``device_memory_report`` is empty without a GPU;
the façade has the JAX package's eight names."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synth_speech
from test_diarize import _voice
from whisperx_tpu import pipeline as jpipeline
from whisperx_tpu.convert.checkpoint import save_checkpoint
from whisperx_tpu.models.whisper.config import MODEL_DIMS
from whisperx_tpu.models.whisper.model import init_params
from whisperx_tpu.pipeline import batch_processor as jbp
from whisperx_tpu_torch import pipeline as tpipeline
from whisperx_tpu_torch.pipeline import batch_processor as tbp
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

DIMS = MODEL_DIMS["test-nano"]
SR = 16000


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A test-nano f32 Whisper and a wav2vec2 TEST_CONFIG aligner under
    ``<align>/en``, both written by the JAX package."""
    from whisperx_tpu.alignment import DEFAULT_EN_VOCAB
    from whisperx_tpu.models.wav2vec2 import model as w2v

    root = tmp_path_factory.mktemp("unified")
    save_checkpoint(
        str(root / "nano"), init_params(DIMS, jax.random.PRNGKey(0), dtype=jnp.float32),
        {"name": "test-nano", "family": "whisper", "dims": dataclasses.asdict(DIMS)},
    )
    save_checkpoint(
        str(root / "align" / "en"), w2v.init_params(w2v.TEST_CONFIG, jax.random.PRNGKey(3)),
        {"family": "wav2vec2", "name": "test", "dictionary": dict(DEFAULT_EN_VOCAB),
         "config": dataclasses.asdict(w2v.TEST_CONFIG)},
    )
    return root


@pytest.fixture(scope="module")
def dialogue():
    """~14 s: two harmonic voices taking turns, with pauses."""
    gap = np.zeros(SR // 2, np.float32)
    a = _voice(110.0, 3.0, bright=0.95, seed=1)
    b = _voice(260.0, 3.0, bright=1.05, seed=2)
    return np.concatenate([gap, a, gap, b, gap, a, gap, b, gap])


@pytest.fixture
def no_switches(monkeypatch, ckpts):
    for name in ("WHISPERX_TPU_SPEAKER_CKPT", "WHISPERX_TPU_SEGMENTATION_CKPT",
                 "WHISPERX_TPU_PLDA_CKPT", "WHISPERX_TPU_DIARIZE_CLUSTERING",
                 "WHISPERX_TPU_SILERO_CKPT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("WHISPERX_TPU_ALIGN_DIR", str(ckpts / "align"))


@pytest.mark.parametrize(
    "stages",
    [dict(align=False, diarize=True), dict(align=True, diarize=True), dict(align=True, diarize=False)],
    ids=["diarize", "align+diarize", "align"],
)
def test_load_pipeline_is_jaxs(ckpts, dialogue, no_switches, stages):
    """``load_pipeline(<test-nano checkpoint>, ...)`` on the CPU, f32 (random
    weights flip bf16 argmax ties), greedy at one temperature, energy VAD:
    the port's result dict is JAX's, segments, words and speakers."""
    kw = dict(language="en", vad_method="energy", batch_size=2, compute_type="float32",
              asr_options={"temperatures": (0.0,), "sample_len": 24}, **stages)
    want = jpipeline.load_pipeline(str(ckpts / "nano"), **kw)(dialogue)
    pipe = tpipeline.load_pipeline(str(ckpts / "nano"), device="cpu", **kw)
    got = pipe(dialogue)
    assert got == want
    assert got["segments"]
    if stages["diarize"]:
        assert all("speaker" in s for s in got["segments"]), got
        assert pipe.diarizer.device.type == "cpu"
    if stages["align"]:
        assert "word_segments" in got


def test_tpu_pipeline_name_and_stages(ckpts, no_switches):
    """``load_tpu_pipeline`` is ``load_pipeline`` (the JAX package's name);
    a config and overrides set the fields, ``device`` among them; the stages
    are built on first use, on the config's device."""
    pipe = tpipeline.load_tpu_pipeline(str(ckpts / "nano"), device="cpu", vad_method="energy")
    assert isinstance(pipe, tpipeline.UnifiedPipeline) and pipe._asr is None
    assert pipe.asr.device.type == "cpu" and pipe.asr is pipe.asr
    cfg = tpipeline.PipelineConfig(model_name="x")
    assert tpipeline.load_pipeline("ignored", config=cfg).config is cfg
    over = tpipeline.UnifiedPipeline(cfg, batch_size=3)
    assert over.config.batch_size == 3
    aligner, meta = pipe._get_aligner("en")
    assert pipe._get_aligner("en")[0] is aligner and meta["language"] == "en"


def test_pipeline_config_is_jaxs_plus_the_device():
    """The same fields and defaults as JAX's ``PipelineConfig``, and
    ``device`` (default ``"cuda"``)."""
    want = {f.name: f.default for f in dataclasses.fields(jpipeline.PipelineConfig)}
    got = {f.name: f.default for f in dataclasses.fields(tpipeline.PipelineConfig)}
    assert got.pop("device") == "cuda"
    assert got == want
    assert tpipeline.PipelineConfig().asr_options == {}


def test_pipeline_refuses_cuda_without_a_gpu(ckpts, monkeypatch):
    """The default device is CUDA: without a GPU, building a stage raises
    (no move to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pipe = tpipeline.load_pipeline(str(ckpts / "nano"), vad_method="energy")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        pipe.asr
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        pipe.diarizer


# -- the batch processor ---------------------------------------------------------


SEGMENTS = [
    {"start": 0.0, "end": 12.0},
    {"start": 13.0, "end": 80.5},  # longer than a chunk: overlapping windows
    {"start": 81.0, "end": 200.0},  # past the audio's end
    {"start": 95.0, "end": 95.0},
]


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.BatchProcessor(),
        lambda m: m.BatchProcessor(chunk_duration=20.0, overlap_duration=2.0, batch_size=3),
        lambda m: m.MemoryEfficientProcessor(),
    ],
    ids=["default", "20 s overlap 2", "memory-efficient"],
)
def test_batch_processor_is_jaxs(make):
    audio = synth_speech(100.0, seed=3)
    want, got = make(jbp), make(tbp)
    wc, gc = want.chunk_segments(audio, SEGMENTS), got.chunk_segments(audio, SEGMENTS)
    assert len(gc) == len(wc) > len(SEGMENTS)
    for a, b in zip(gc, wc):
        assert (a.start, a.end, a.segment_index, a.is_continuation) == (
            b.start, b.end, b.segment_index, b.is_continuation
        )
        np.testing.assert_array_equal(a.audio, b.audio)
    wb, gb = want.group_batches(wc), got.group_batches(gc)
    assert [len(b) for b in gb] == [len(b) for b in wb]
    for a, b in zip(gb, wb):
        np.testing.assert_array_equal(got.pad_batch(a), want.pad_batch(b))
    texts = ["one two three four five six", "five six seven eight", "", "nine ten"]
    conts = [False, True, True, True]
    assert tbp.BatchProcessor.merge_chunk_texts(texts, conts) == jbp.BatchProcessor.merge_chunk_texts(texts, conts)


def test_batch_processor_refuses_an_overlap_as_jax_does():
    for mod in (jbp, tbp):
        with pytest.raises(ValueError, match="overlap_duration"):
            mod.BatchProcessor(chunk_duration=1.0, overlap_duration=1.0)


def test_memory_report_is_empty_without_a_gpu(monkeypatch):
    """``device_memory_report`` (``optimize_memory``): JAX's keys per CUDA
    device; none on the CPU, as JAX's on its CPU devices."""
    from whisperx_tpu.utils.metrics import device_memory_report as jax_report
    from whisperx_tpu_torch.utils.metrics import device_memory_report

    assert device_memory_report() == {} == jax_report()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tbp.optimize_memory() == {}


def test_facade_has_the_jax_packages_names():
    import whisperx_tpu
    import whisperx_tpu_torch
    from whisperx_tpu_torch.diarize import DiarizationPipeline, assign_word_speakers

    assert sorted(whisperx_tpu_torch.__all__) == sorted(whisperx_tpu.__all__)
    assert whisperx_tpu_torch.load_pipeline is tpipeline.load_pipeline
    assert whisperx_tpu_torch.load_tpu_pipeline is tpipeline.load_tpu_pipeline
    assert whisperx_tpu_torch.DiarizationPipeline is DiarizationPipeline
    assert whisperx_tpu_torch.assign_word_speakers is assign_word_speakers

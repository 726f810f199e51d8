"""Learned weights through both packages: the micro Whisper that
``tests/test_learned_e2e.py`` trains (or reuses from its cache) is
transcribed by ``whisperx_tpu`` and by ``whisperx_tpu_torch`` on the CPU, in
bf16 and in f32. The learned logit margins make token identity a fair
demand in bf16 too (random weights' margins are ~1e-3); the transcripts must
be byte-identical, timestamps included."""

import os

import pytest

from whisperx_tpu.train.micro import DEFAULT_CHUNK_SIZE, build_files
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def micro_ckpt():
    """Resolved as tests/test_learned_e2e.py resolves it: an explicit
    WHISPERX_TPU_MICRO_CKPT, else the trainer's content-hash cache (trained
    on first use)."""
    reuse = os.environ.get("WHISPERX_TPU_MICRO_CKPT")
    if reuse and os.path.exists(os.path.join(reuse, "weights.npz")):
        return reuse
    from whisperx_tpu.train import micro_checkpoint_cached

    path, report = micro_checkpoint_cached()
    assert report["final_loss"] < 0.05, report
    assert report.get("min_margin", 0) > 0.3, report
    return path


@pytest.fixture(scope="module")
def files():
    return build_files()


@pytest.mark.parametrize("compute_type", ["bfloat16", "float32"])
def test_transcripts_byte_identical_to_jax(micro_ckpt, files, compute_type):
    import whisperx_tpu
    import whisperx_tpu_torch

    kw = dict(
        device="cpu", compute_type=compute_type, language="en",
        vad_method="energy", task="transcribe",
    )
    jpipe = whisperx_tpu.load_model(micro_ckpt, **kw)
    tpipe = whisperx_tpu_torch.load_model(micro_ckpt, **kw)
    for fi in (0, 11):
        audio, events = files[fi]
        want = jpipe.transcribe(audio, batch_size=8, chunk_size=DEFAULT_CHUNK_SIZE)
        got = tpipe.transcribe(audio, batch_size=8, chunk_size=DEFAULT_CHUNK_SIZE)
        assert got == want, f"file {fi}"
        # and the learned transcript is the spoken one
        assert " ".join(s["text"] for s in got["segments"]) == " ".join(
            text.strip() for _, text in events
        )

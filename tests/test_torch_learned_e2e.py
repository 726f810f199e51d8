"""Learned weights through both packages: the micro Whisper that
``tests/test_learned_e2e.py`` trains (or reuses from its cache) is
transcribed by ``whisperx_tpu`` and by ``whisperx_tpu_torch`` on the CPU, in
bf16 and in f32. The learned logit margins make token identity a fair
demand in bf16 too (random weights' margins are ~1e-3); the transcripts must
be byte-identical, timestamps included. With ``int8`` / ``int4`` both
packages quantize the bf16 decoder weights to the same codes; the port runs
K4's arithmetic (int8) or the dequant-dot (int4), JAX its XLA dequant-dot."""

import fcntl
import os

import pytest

from whisperx_tpu.train.micro import DEFAULT_CHUNK_SIZE, build_files
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def micro_ckpt():
    """Resolved as tests/test_learned_e2e.py resolves it: an explicit
    WHISPERX_TPU_MICRO_CKPT, else the trainer's content-hash cache (trained
    on first use). The port's files that use it (this one and
    test_torch_sequential.py) take an exclusive lock beside the cache
    around the lookup, so that on a cold cache one of them trains and the
    other waits and reads what it wrote, instead of both training at once."""
    reuse = os.environ.get("WHISPERX_TPU_MICRO_CKPT")
    if reuse and os.path.exists(os.path.join(reuse, "weights.npz")):
        return reuse
    from whisperx_tpu.train import micro_checkpoint_cached

    root = os.path.expanduser("~/.cache/whisperx_tpu")
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "micro_ckpt.torch_tests.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        path, report = micro_checkpoint_cached()
    assert report["final_loss"] < 0.05, report
    assert report.get("min_margin", 0) > 0.3, report
    return path


@pytest.fixture(scope="module")
def files():
    return build_files()


def _text(result):
    return " ".join(s["text"] for s in result["segments"])


@pytest.mark.parametrize("compute_type", ["bfloat16", "float32", "int8", "int4"])
def test_transcripts_byte_identical_to_jax(micro_ckpt, files, compute_type):
    """Quantized: where JAX's transcript is the spoken text, the port's is
    byte-identical to it. Where it is not (int4, file 11: the int4 model's
    margin at one token is under one logit, and bf16 rounding-order
    differences between the frameworks, ~0.2 logits there, decide it), the
    same quantization with f32 activations must give byte-identical
    transcripts: the arithmetic is the same, only bf16 rounding differs."""
    import whisperx_tpu
    import whisperx_tpu_torch
    from whisperx_tpu.quant import quantize_model as jax_quantize_model
    from whisperx_tpu_torch.quant import quantize_model

    quantized = compute_type in ("int8", "int4")
    kw = dict(
        device="cpu", compute_type=compute_type, language="en",
        vad_method="energy", task="transcribe",
    )
    jpipe = whisperx_tpu.load_model(micro_ckpt, **kw)
    tpipe = whisperx_tpu_torch.load_model(micro_ckpt, **kw)
    for fi in (0, 11):
        audio, events = files[fi]
        spoken = " ".join(text.strip() for _, text in events)
        want = jpipe.transcribe(audio, batch_size=8, chunk_size=DEFAULT_CHUNK_SIZE)
        got = tpipe.transcribe(audio, batch_size=8, chunk_size=DEFAULT_CHUNK_SIZE)
        if not quantized or _text(want) == spoken:
            assert got == want, f"file {fi}"
            # and the learned transcript is the spoken one
            assert _text(got) == spoken
            continue
        assert compute_type == "int4", f"file {fi}: JAX's int8 transcript is not the spoken one"
        kw32 = dict(kw, compute_type="float32")
        jpipe32 = whisperx_tpu.load_model(micro_ckpt, **kw32)
        jpipe32.model = jax_quantize_model(jpipe32.model, mode=compute_type)
        tpipe32 = whisperx_tpu_torch.load_model(micro_ckpt, **kw32)
        quantize_model(tpipe32.model, mode=compute_type)
        want = jpipe32.transcribe(audio, batch_size=8, chunk_size=DEFAULT_CHUNK_SIZE)
        got = tpipe32.transcribe(audio, batch_size=8, chunk_size=DEFAULT_CHUNK_SIZE)
        assert got == want, f"file {fi}, {compute_type} codes, f32 activations"

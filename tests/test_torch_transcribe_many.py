"""``transcribe_many`` of the port against the JAX package's on f32
``test-nano``: three requests of different lengths pooled into shared device
batches, with per-request languages (one detected) and prompts, and the
per-audio route without a VAD. Results must be identical per request."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import synth_speech
from whisperx_tpu.convert.checkpoint import save_checkpoint
from whisperx_tpu.models.whisper.config import MODEL_DIMS
from whisperx_tpu.models.whisper.model import init_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

DIMS = MODEL_DIMS["test-nano"]
OPTS = {"temperatures": (0.0,), "sample_len": 16}


@pytest.fixture(scope="module")
def nano_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("nano_many"))
    params = init_params(DIMS, jax.random.PRNGKey(0), dtype=jnp.float32)
    save_checkpoint(
        path, params,
        {"name": "test-nano", "family": "whisper", "dims": dataclasses.asdict(DIMS)},
    )
    return path


@pytest.fixture(scope="module")
def audios():
    return [synth_speech(s, seed=i) for i, s in enumerate((12.0, 35.0, 21.0))]


def _pipelines(ckpt, vad_method="energy"):
    import whisperx_tpu
    import whisperx_tpu_torch

    kw = dict(compute_type="float32", vad_method=vad_method, asr_options=OPTS)
    return (
        whisperx_tpu.load_model(ckpt, device="cpu", **kw),
        whisperx_tpu_torch.load_model(ckpt, device="cpu", **kw),
    )


CASES = {
    "one language": dict(language="en"),
    "languages, one detected": dict(language=["en", None, "de"]),
    "prompts": dict(language="en", initial_prompt=["so", None, "so"]),
    "tasks": dict(language="en", task=["transcribe", "translate", "transcribe"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pooled_results_identical_to_jax(nano_ckpt, audios, case):
    from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER

    jpipe, tpipe = _pipelines(nano_ckpt)
    want = jpipe.transcribe_many(audios, batch_size=4, **CASES[case])
    GLOBAL_TRACKER.reset()
    got = tpipe.transcribe_many(audios, batch_size=4, **CASES[case])
    assert got == want
    assert len(got) == len(audios)
    assert sum(len(r["segments"]) for r in got) > 0
    for r, audio in zip(got, audios):
        for seg in r["segments"]:
            assert 0.0 <= seg["start"] < seg["end"] <= len(audio) / 16000 + 1e-6
    if case == "one language":  # one group: all chunks pooled, then cut in 4s
        from whisperx_tpu_torch.audio.device_chunk import upload_audio

        n_chunks = sum(len(tpipe._segment_with_vad(upload_audio(a, "cpu"), 30)) for a in audios)
        counters = GLOBAL_TRACKER.counters
        assert counters["batch_used"] == n_chunks > len(audios)
        assert counters["batch_slots"] == 4 * -(-n_chunks // 4)


def test_pooled_words_identical_to_jax(nano_ckpt, audios):
    """With ``word_timestamps`` in the pipeline's options, each request's
    words come back on its own timeline: the same words, starts and ends as
    JAX's (probabilities within 1e-6)."""
    import numpy as np

    jpipe, tpipe = _pipelines(nano_ckpt)
    results = []
    for pipe in (jpipe, tpipe):
        pipe.asr_options = {**pipe.asr_options, "word_timestamps": True}
        results.append(pipe.transcribe_many(audios, batch_size=4, language="en"))
    probs = [
        [w.pop("probability") for r in res for s in r["segments"] for w in s["words"]]
        for res in results
    ]
    want, got = results
    assert got == want and probs[1]
    np.testing.assert_allclose(probs[1], probs[0], atol=1e-6, rtol=0)
    for r, audio in zip(got, audios):
        for seg in r["segments"]:
            for w in seg["words"]:
                assert 0.0 <= w["start"] <= w["end"] <= len(audio) / 16000 + 1.0


def test_pooled_equals_one_by_one(nano_ckpt, audios):
    """Pooling does not change any request's segments (f32 greedy rows are
    independent of their batch neighbours)."""
    _, tpipe = _pipelines(nano_ckpt)
    pooled = tpipe.transcribe_many(audios, batch_size=4, language="en")
    alone = [tpipe.transcribe(a, batch_size=4, language="en") for a in audios]
    assert pooled == alone


def test_without_vad_each_audio_takes_the_seek_loop(nano_ckpt, audios):
    jpipe, tpipe = _pipelines(nano_ckpt, vad_method="none")
    kw = dict(language=["en", "en", None], initial_prompt=[None, "so", None])
    want = jpipe.transcribe_many(audios, **kw)
    got = tpipe.transcribe_many(audios, **kw)
    assert got == want and len(got) == 3


def test_empty_and_mismatched_lists(nano_ckpt, audios):
    _, tpipe = _pipelines(nano_ckpt)
    assert tpipe.transcribe_many([]) == []
    with pytest.raises(ValueError, match="per-request option length"):
        tpipe.transcribe_many(audios, language=["en"])
    silent = np.zeros(16000 * 3, np.float32)
    out = tpipe.transcribe_many([silent, audios[0]], language=[None, "en"])
    assert out[0] == {"segments": [], "language": "en"}

"""The port's transcript writers against the JAX package's: for hand-made
results (plain segments; word timings, some words untimed; character
timings; speakers) and subtitle options (``highlight_words``,
``max_line_width``, ``max_line_count``), every writer writes the same bytes.
Pure Python, no model."""

import os

import pytest

from whisperx_tpu.utils import writers as jax_writers
from whisperx_tpu.utils.subtitles import SubtitlesProcessor as JaxSubtitles
from whisperx_tpu_torch.utils import get_writer
from whisperx_tpu_torch.utils.subtitles import SubtitlesProcessor

FORMATS = ("txt", "vtt", "srt", "tsv", "json", "aud", "rttm")


def _words(text, start, step):
    out = []
    for i, w in enumerate(text.split()):
        word = {"word": w, "start": round(start + i * step, 3), "end": round(start + (i + 0.8) * step, 3), "score": 0.9}
        if w.isdigit():  # unalignable: no times, as the aligner leaves them
            word = {"word": w}
        out.append(word)
    return out


def _result(kind):
    texts = [
        (0.0, 2.5, "Hello there, this is the first segment and it runs long"),
        (2.9, 6.25, "a second one with 42 numbers\tand a tab --> arrow"),
        (9.5, 3725.125, "after a long pause, the end"),
    ]
    segments = []
    for i, (s, e, text) in enumerate(texts):
        seg = {"start": s, "end": e, "text": " " + text}
        if kind != "plain":
            seg["words"] = _words(text, s, 0.21)
        if kind == "chars":
            seg["chars"] = [{"char": c, "start": s + 0.01 * j, "end": s + 0.01 * j + 0.005} for j, c in enumerate(text[:6])]
        if kind == "speakers":
            seg["speaker"] = f"SPEAKER_0{i % 2}"
            for w in seg["words"]:
                w["speaker"] = seg["speaker"]
        segments.append(seg)
    return {"segments": segments, "language": "ja" if kind == "no-spaces" else "en"}


OPTIONS = {
    "defaults": {"highlight_words": False, "max_line_width": None, "max_line_count": None},
    "highlight": {"highlight_words": True, "max_line_width": None, "max_line_count": None},
    "width": {"highlight_words": False, "max_line_width": 16, "max_line_count": None},
    "width-count": {"highlight_words": True, "max_line_width": 20, "max_line_count": 2},
}


def _written(get, result, options, out_dir):
    os.makedirs(out_dir)
    for fmt in FORMATS:
        get(fmt, out_dir)(result, "/some/where/clip.wav", options)
    return {
        name: open(os.path.join(out_dir, name), "rb").read()
        for name in sorted(os.listdir(out_dir))
    }


@pytest.mark.parametrize("kind", ["plain", "words", "chars", "speakers", "no-spaces"])
@pytest.mark.parametrize("opts", sorted(OPTIONS))
def test_writers_write_the_same_bytes(tmp_path, kind, opts):
    result, options = _result(kind), OPTIONS[opts]
    want = _written(jax_writers.get_writer, result, options, str(tmp_path / "jax"))
    got = _written(get_writer, result, options, str(tmp_path / "torch"))
    assert sorted(got) == [f"clip.{f}" for f in sorted(FORMATS)]
    for name in want:
        assert got[name] == want[name], name
    if kind == "speakers":
        assert b"SPEAKER clip 1" in got["clip.rttm"]


def test_all_writes_the_five_default_formats(tmp_path):
    result = _result("words")
    get_writer("all", str(tmp_path))(result, "clip.wav", OPTIONS["defaults"])
    assert sorted(os.listdir(tmp_path)) == [f"clip.{f}" for f in ("json", "srt", "tsv", "txt", "vtt")]


@pytest.mark.parametrize("lang,is_vtt", [("en", False), ("en", True), ("ja", False)])
@pytest.mark.parametrize("advanced", [True, False])
def test_subtitles_processor_matches_jax(tmp_path, lang, is_vtt, advanced):
    segments = _result("words")["segments"] + [{"start": 3726.0, "end": 3730.0, "text": "no words but a text to split into pieces evenly"}]
    paths = [str(tmp_path / n) for n in ("jax.srt", "torch.srt")]
    counts = [
        cls([dict(s, words=[dict(w) for w in s.get("words", [])]) if "words" in s else dict(s) for s in segments], lang, is_vtt=is_vtt).save(path, advanced)
        for cls, path in zip((JaxSubtitles, SubtitlesProcessor), paths)
    ]
    assert counts[0] == counts[1] > 0
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()

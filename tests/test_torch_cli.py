"""The port's CLI against the JAX package's on the CPU: the same flags,
choices and defaults (but ``--device`` and ``--version``); byte-identical
transcripts from the same f32 checkpoint, with the default beam search, the
int8 path, the sequential modes (``--vad_method none``, ``--backend
sequential``), word timing, forced alignment (with no aligner checkpoint,
and with one), speculative decoding, the other VADs, diarization and
``--data_parallel on``."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import synth_speech
from whisperx_tpu.__main__ import build_parser as jax_build_parser
from whisperx_tpu.convert.checkpoint import save_checkpoint
from whisperx_tpu.models.whisper.config import MODEL_DIMS
from whisperx_tpu.models.whisper.model import init_params
from whisperx_tpu_torch.__main__ import build_parser
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

DIMS = MODEL_DIMS["test-nano"]
JAX_ACTIONS = {a.dest: a for a in jax_build_parser()._actions}
OWN_DEFAULTS = {"device": ("tpu", "cuda")}  # (JAX's, the port's)
OWN_FLAGS = {"trace_spans"}  # the port's span records (utils/metrics.py)
OUTPUTS = ("json", "srt", "tsv", "txt", "vtt")


@pytest.mark.parametrize("dest", sorted(JAX_ACTIONS))
def test_parser_flag_matches_jax(dest):
    want = JAX_ACTIONS[dest]
    got = {a.dest: a for a in build_parser()._actions}[dest]
    assert got.option_strings == want.option_strings
    assert type(got) is type(want)
    assert (got.nargs, got.choices, got.required) == (want.nargs, want.choices, want.required)
    assert getattr(got.type, "__name__", got.type) == getattr(want.type, "__name__", want.type)
    if dest in OWN_DEFAULTS:
        assert (want.default, got.default) == OWN_DEFAULTS[dest]
    else:
        assert got.default == want.default


def test_parser_has_no_flag_of_its_own():
    """Every flag is JAX's, but the port's ``--trace_spans``."""
    assert {a.dest for a in build_parser()._actions} == set(JAX_ACTIONS) | OWN_FLAGS


def test_version_names_the_port(capsys):
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--version"])
    assert capsys.readouterr().out.startswith("whisperx-tpu-torch ")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A test-nano f32 checkpoint written by the JAX package, and ~8 s of
    synthetic speech as a 16-bit WAV."""
    from whisperx_tpu_torch.audio import save_wav

    root = tmp_path_factory.mktemp("cli")
    params = init_params(DIMS, jax.random.PRNGKey(0), dtype=jnp.float32)
    save_checkpoint(
        str(root / "nano"), params,
        {"name": "test-nano", "family": "whisper", "dims": dataclasses.asdict(DIMS)},
    )
    silence = np.zeros(8000, np.float32)
    save_wav(str(root / "clip.wav"), np.concatenate([silence, synth_speech(7.0), silence]))
    return root


def _run(package, argv):
    """Run one package's CLI in-process, as its ``cli()`` does."""
    if package == "jax":
        from whisperx_tpu.transcribe import transcribe_task

        parser = jax_build_parser()
    else:
        from whisperx_tpu_torch.transcribe import transcribe_task

        parser = build_parser()
    return transcribe_task(parser.parse_args(argv).__dict__, parser)


def _outputs(out_dir):
    return {f: open(os.path.join(out_dir, f"clip.{f}"), "rb").read() for f in OUTPUTS}


def _argv(workdir, out, compute_type, *extra):
    return [
        str(workdir / "clip.wav"), "--model", str(workdir / "nano"), "--device", "cpu",
        "--compute_type", compute_type, "--vad_method", "energy", "--language", "en",
        "--no_align", "-f", "all", "--temperature_increment_on_fallback", "None",
        "--batch_size", "1", "-o", str(workdir / out), *extra,
    ]


def _metrics_shape(path):
    """The ``--log_json`` lines without their timings: each line's keys,
    its event and its stage. The JAX package's "dispatch" stage (the host
    queueing its asynchronous decodes, which its "decode" stage then waits
    for) is left out: the port's decode runs in its "decode" stage alone."""
    lines = [json.loads(line) for line in open(path)]
    return [
        (sorted(d), d["event"], d.get("stage"), d.get("files"))
        for d in lines
        if d.get("stage") != "dispatch"
    ]


def test_cli_writes_the_same_files_as_jax(workdir):
    """f32, beam 5 (the CLI default) at one temperature; the ignored flags
    are accepted. Every written file is byte-identical, and the
    ``--log_json`` metrics have the same lines, keys and stages."""
    from whisperx_tpu.utils.metrics import GLOBAL_TRACKER as jax_tracker
    from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER

    extra = ("--fp16", "False", "--threads", "2", "--segment_resolution", "chunk")
    jax_tracker.reset()
    _run("jax", _argv(workdir, "jax_f32", "float32", *extra, "--log_json", str(workdir / "jax.jsonl")))
    GLOBAL_TRACKER.reset()
    pipe = _run("torch", _argv(workdir, "torch_f32", "float32", *extra, "--log_json", str(workdir / "torch.jsonl")))
    assert pipe.asr_options["beam_size"] == 5 and pipe.asr_options["temperatures"] == (0.0,)
    want, got = _outputs(workdir / "jax_f32"), _outputs(workdir / "torch_f32")
    for f in OUTPUTS:
        assert got[f] == want[f], f
    assert b'"language": "en"' in got["json"]
    metrics = _metrics_shape(workdir / "torch.jsonl")
    assert metrics == _metrics_shape(workdir / "jax.jsonl")
    assert metrics[-1][1:] == ("summary", None, 1) and len(metrics) > 1


def test_cli_int8_writes_the_same_files_as_jax(workdir):
    """``--compute_type int8``: bf16 weights, decoder linears quantized to
    int8 by each package (bit-identical codes and scales); the port runs K4's
    plain version, JAX its XLA dequant-dot. On this input the two rounding
    orders choose the same tokens, so the files are identical."""
    from whisperx_tpu_torch.quant import QuantizedLinear

    _run("jax", _argv(workdir, "jax_int8", "int8"))
    pipe = _run("torch", _argv(workdir, "torch_int8", "int8"))
    quantized = [m for m in pipe.model.modules() if isinstance(m, QuantizedLinear)]
    assert len(quantized) == 20 and all(m.qw.dtype.itemsize == 1 for m in quantized)
    want, got = _outputs(workdir / "jax_int8"), _outputs(workdir / "torch_int8")
    for f in OUTPUTS:
        assert got[f] == want[f], f


@pytest.mark.parametrize(
    "mode", [("--vad_method", "none"), ("--backend", "sequential")], ids=" ".join
)
def test_cli_sequential_modes_write_the_same_files_as_jax(workdir, mode):
    """The seek loop over the whole file (no VAD) or over each VAD chunk,
    f32, beam 5, at one temperature (the two packages sample from different
    generators above 0): every written file is byte-identical to the JAX
    CLI's."""
    out = mode[1]
    argv = _argv(workdir, f"jax_{out}", "float32", *mode, "--condition_on_previous_text", "False")
    _run("jax", argv)
    argv[argv.index("-o") + 1] = str(workdir / f"torch_{out}")
    pipe = _run("torch", argv)
    assert pipe.asr_options["temperatures"] == (0.0,) and pipe.asr_options["beam_size"] == 5
    assert (pipe.vad_model is None) == (out == "none")
    assert pipe.decode_mode == ("sequential" if out == "sequential" else "batched")
    want, got = _outputs(workdir / f"jax_{out}"), _outputs(workdir / f"torch_{out}")
    for f in OUTPUTS:
        assert got[f] == want[f], f


def _same_outputs(jax_dir, torch_dir):
    """Every written file byte-identical, but the JSON's word probabilities
    (``--word_timestamps``), which come from two softmax implementations:
    the parsed JSON is identical without them, and they agree within 1e-6."""
    want, got = _outputs(jax_dir), _outputs(torch_dir)
    for f in OUTPUTS:
        if f != "json":
            assert got[f] == want[f], f
    probs = {}
    for name, raw in (("jax", want["json"]), ("torch", got["json"])):
        result = json.loads(raw)
        probs[name] = [
            w.pop("probability") for s in result["segments"] for w in s.get("words", [])
        ]
        probs[name + " json"] = result
    assert probs["torch json"] == probs["jax json"]
    np.testing.assert_allclose(probs["torch"], probs["jax"], atol=1e-6, rtol=0)
    if not probs["torch"]:
        assert got["json"] == want["json"]
    return probs["torch json"]


# flags of stages that are not ported raise; the ported ones (alignment,
# word timing, the silence threshold, the seek loop with word timing,
# speculative decoding, the pyannote and hybrid VADs, diarization) write
# what the JAX CLI writes
WORDS = {"--word_timestamps True", "--vad_method none --word_timestamps True"}
PORTED = WORDS | {"align", "--hallucination_silence_threshold 2", "--draft_model tiny",
                  "--draft_model self:1",
                  "--vad_method pyannote", "--vad_method hybrid", "--diarize",
                  "--backend sequential --diarize", "--data_parallel on"}
# the diarization switches, unset: the weightless default models
DIARIZE_SWITCHES = ("WHISPERX_TPU_SPEAKER_CKPT", "WHISPERX_TPU_SEGMENTATION_CKPT",
                    "WHISPERX_TPU_PLDA_CKPT", "WHISPERX_TPU_DIARIZE_CLUSTERING")


@pytest.mark.parametrize(
    "extra",
    [
        ("--diarize",),
        ("--word_timestamps", "True"),
        ("--hallucination_silence_threshold", "2"),
        ("--draft_model", "tiny"),
        # a cheap draft (the model's first decoder layer, its encoder
        # shared) at the default γ
        ("--draft_model", "self:1"),
        # the sequential modes run (test_cli_sequential_modes_write_the_same_
        # files_as_jax), and with diarization after the seek loop
        pytest.param(("--backend", "sequential", "--diarize"), id="--backend sequential"),
        pytest.param(
            ("--vad_method", "none", "--word_timestamps", "True"), id="--vad_method none"
        ),
        ("--vad_method", "pyannote"),
        ("--vad_method", "hybrid"),
        ("--data_parallel", "on"),
        (),  # without --no_align: forced alignment
    ],
    ids=lambda e: " ".join(e) or "align",
)
def test_not_ported_flags_raise(workdir, extra, monkeypatch, capsys):
    """No flag is refused any more (``--data_parallel on`` was the last,
    until scale-out was ported). Every case writes what the JAX CLI writes:
    alignment with no aligner checkpoint (both skip it, with a message),
    word timing in the batched pipeline and in the seek loop, the
    hallucination-silence threshold with it, speculative decoding with a
    random ``tiny`` draft at γ 1 and a ``self:1`` draft at the default γ
    (token-identical to greedy whatever the draft's weights; the CLI's
    beam 5 is dropped with a warning in both), the
    pyannote and hybrid VADs without checkpoints (energy scores through
    Binarize; the energy fallback), and diarization with the weightless
    default (energy VAD windows, spectral embeddings, AHC) after the batched
    pipeline and after the seek loop: every segment gets a speaker; and
    ``--data_parallel on`` (the port's ``DataParallelPipeline`` over the
    CPU against the JAX CLI's ``off``)."""
    case = " ".join(extra) or "align"
    assert case in PORTED
    argv = _argv(workdir, "refused", "float32")
    if not extra:
        argv.remove("--no_align")
    if case == "--hallucination_silence_threshold 2":
        extra = ("--word_timestamps", "True", *extra)  # it needs the words
    if case == "--draft_model tiny":
        # one drafted token a verify pass: the random draft's 224 steps at
        # the default γ of 4 made this the slowest case of the file, and the
        # files are the same at any γ (test_torch_speculative.py holds the
        # other γ against JAX)
        extra = (*extra, "--spec_gamma", "1")
    # JAX on one device: its data-parallel route over the suite's 8 virtual
    # CPU devices gives the same files ~10x slower
    jax_extra = (*extra, "--data_parallel", "off")
    if case != "--data_parallel on":
        extra = jax_extra
    # no aligner checkpoint anywhere, and random weights refused
    monkeypatch.setenv("HOME", str(workdir / "home"))
    monkeypatch.delenv("WHISPERX_TPU_ALIGN_DIR", raising=False)
    monkeypatch.delenv("WHISPERX_TPU_ALLOW_RANDOM_ALIGN", raising=False)
    monkeypatch.delenv("WHISPERX_TPU_SILERO_CKPT", raising=False)
    for name in DIARIZE_SWITCHES:
        monkeypatch.delenv(name, raising=False)
    out = case.replace(" ", "_").strip("-")
    dirs = {}
    for pkg in ("jax", "torch"):
        dirs[pkg] = workdir / f"{pkg}_{out}"
        argv[argv.index("-o") + 1] = str(dirs[pkg])
        flags = list(jax_extra if pkg == "jax" else extra)
        if case.startswith("--draft_model"):
            with pytest.warns(UserWarning, match="greedy-only; ignoring beam_size=5"):
                _run(pkg, argv + flags)
        else:
            _run(pkg, argv + flags)
        if case == "align":
            assert ">>Skipping alignment" in capsys.readouterr().out, pkg
    result = _same_outputs(dirs["jax"], dirs["torch"])
    words = [w for s in result["segments"] for w in s.get("words", [])]
    # random weights: the silence threshold evicts every segment as an
    # anomaly, in both packages
    assert bool(words) == (case in WORDS)
    assert "word_segments" not in result
    for w in words:
        assert 0.0 <= w["start"] <= w["end"] <= 10.0
    if "--diarize" in extra:
        assert result["segments"] and all(s["speaker"].startswith("SPEAKER_") for s in result["segments"])


def test_data_parallel_on_writes_the_same_files_as_off(workdir, capsys):
    """``--data_parallel on --device cpu``: the pipeline is wrapped in
    ``DataParallelPipeline`` over the CPU and writes ``off``'s files."""
    from whisperx_tpu_torch.parallel import DataParallelPipeline

    dirs = {}
    for mode in ("off", "on"):
        dirs[mode] = workdir / f"torch_dp_{mode}"
        argv = _argv(workdir, f"torch_dp_{mode}", "float32", "--data_parallel", mode,
                     "--batch_size", "2", "--verbose", "True")
        pipe = _run("torch", argv)
        assert isinstance(pipe, DataParallelPipeline) == (mode == "on")
    assert ">>Data-parallel decode over 1 devices" in capsys.readouterr().out
    assert _outputs(dirs["on"]) == _outputs(dirs["off"])


def test_torchrun_variables_shard_the_files(workdir, monkeypatch, capsys):
    """Under torchrun's ``RANK`` / ``WORLD_SIZE`` the CLI transcribes and
    writes only its strided slice of the files: rank 1 of 2 owns the second
    file and writes nothing for the first."""
    from whisperx_tpu_torch.audio import save_wav

    second = workdir / "clip_b.wav"
    save_wav(str(second), synth_speech(3.0, seed=4))
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    argv = _argv(workdir, "torch_rank1", "float32", "--data_parallel", "off", "-f", "json")
    _run("torch", [argv[0], str(second), *argv[1:]])
    assert ">>Host 1/2: 1 of 2 files" in capsys.readouterr().out
    assert os.listdir(workdir / "torch_rank1") == ["clip_b.json"]


@pytest.mark.parametrize(
    "extra",
    [
        ("--diarize", "--speaker_embeddings"),
        ("--diarize", "--diarize_clustering", "spectral", "--min_speakers", "2", "--max_speakers", "3"),
        ("--diarize", "--diarize_clustering", "plda", "--max_speakers", "1"),
        ("--speaker_embeddings",),
    ],
    ids=" ".join,
)
def test_cli_diarization_options_write_the_same_files_as_jax(workdir, extra, monkeypatch):
    """The diarization flags: ``--speaker_embeddings`` adds each speaker's
    mean embedding to the JSON (compared parsed, within 1e-5: the float
    reprs of two implementations differ; every other file byte-identical);
    ``--diarize_clustering`` and the speaker bounds; ``--speaker_embeddings``
    without ``--diarize`` is ignored with JAX's warning."""
    for name in DIARIZE_SWITCHES + ("WHISPERX_TPU_SILERO_CKPT",):
        monkeypatch.delenv(name, raising=False)
    out = "_".join(a.strip("-") for a in extra)
    dirs = {}
    for pkg in ("jax", "torch"):
        dirs[pkg] = workdir / f"{pkg}_{out}"
        argv = _argv(workdir, str(dirs[pkg]), "float32", *extra, "--data_parallel", "off")
        argv[argv.index("-o") + 1] = str(dirs[pkg])
        if "--diarize" in extra:
            _run(pkg, argv)
        else:
            with pytest.warns(UserWarning, match="ignoring --speaker_embeddings: requires --diarize"):
                _run(pkg, argv)
    want, got = _outputs(dirs["jax"]), _outputs(dirs["torch"])
    for f in OUTPUTS:
        if f != "json":
            assert got[f] == want[f], f
    want, got = json.loads(want["json"]), json.loads(got["json"])
    want_emb, got_emb = want.pop("speaker_embeddings", None), got.pop("speaker_embeddings", None)
    assert got == want
    assert (got_emb is None) == (want_emb is None) == ("--speaker_embeddings" not in extra or "--diarize" not in extra)
    if want_emb is not None:
        assert sorted(got_emb) == sorted(want_emb)
        for name in want_emb:
            np.testing.assert_allclose(got_emb[name], want_emb[name], atol=1e-5, rtol=0)
    assert all(("speaker" in s) == ("--diarize" in extra) for s in got["segments"])


@pytest.fixture(scope="module")
def align_ckpt(tmp_path_factory):
    """A wav2vec2 TEST_CONFIG aligner written by the JAX package under
    ``<dir>/en``, with the base-960h dictionary."""
    from whisperx_tpu.alignment import DEFAULT_EN_VOCAB
    from whisperx_tpu.models.wav2vec2 import model as w2v

    root = tmp_path_factory.mktemp("align")
    save_checkpoint(
        str(root / "en"), w2v.init_params(w2v.TEST_CONFIG, jax.random.PRNGKey(3)),
        {"family": "wav2vec2", "name": "test", "dictionary": dict(DEFAULT_EN_VOCAB),
         "config": dataclasses.asdict(w2v.TEST_CONFIG)},
    )
    return root


@pytest.mark.parametrize("aligner", ["none", "checkpoint"])
@pytest.mark.parametrize("sr", [16000, 44100])
def test_cli_with_alignment_writes_the_same_files_as_jax(
    workdir, align_ckpt, tmp_path, monkeypatch, capsys, sr, aligner
):
    """The North-star check: ``python -m whisperx_tpu_torch clip.wav`` with
    alignment on (no ``--no_align``), ffmpeg absent, on a 16 kHz and a
    44.1 kHz WAV (decoded by the native library in both packages): every
    file byte-identical to the JAX CLI's, both with no aligner checkpoint
    (both print the skip message) and with a TEST_CONFIG checkpoint in
    ``WHISPERX_TPU_ALIGN_DIR`` (word segments written, with
    ``--highlight_words``)."""
    import whisperx_tpu.audio.io as jio
    import whisperx_tpu_torch.audio.io as tio

    monkeypatch.setattr(jio, "_FFMPEG", None)
    monkeypatch.setattr(tio, "_FFMPEG", None)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("WHISPERX_TPU_ALLOW_RANDOM_ALIGN", raising=False)
    if aligner == "checkpoint":
        monkeypatch.setenv("WHISPERX_TPU_ALIGN_DIR", str(align_ckpt))
    else:
        monkeypatch.delenv("WHISPERX_TPU_ALIGN_DIR", raising=False)
    silence = np.zeros(sr // 2, np.float32)
    wav = tmp_path / "clip.wav"
    from whisperx_tpu_torch.audio import save_wav

    save_wav(str(wav), np.concatenate([silence, synth_speech(7.0, sr=sr, seed=8), silence]), sr)
    extra = ["--data_parallel", "off"]  # JAX on one device (see above)
    if aligner == "checkpoint":
        extra += ["--highlight_words", "True"]
    for pkg in ("jax", "torch"):
        argv = _argv(workdir, "-", "float32", *extra)
        argv[0] = str(wav)
        argv.remove("--no_align")
        argv[argv.index("-o") + 1] = str(tmp_path / pkg)
        _run(pkg, argv)
        said = capsys.readouterr().out
        assert (">>Skipping alignment" in said) == (aligner == "none"), pkg
        assert (">>Performing alignment" in said) == (aligner == "checkpoint"), pkg
    want, got = _outputs(tmp_path / "jax"), _outputs(tmp_path / "torch")
    for f in OUTPUTS:
        assert got[f] == want[f], f
    result = json.loads(got["json"])
    assert ("word_segments" in result) == (aligner == "checkpoint")
    if aligner == "checkpoint":
        assert result["word_segments"] and b"<u>" in got["srt"]


def test_cli_reloads_the_aligner_for_a_new_language(workdir, align_ckpt, monkeypatch, capsys):
    """Without ``--language`` the transcript's detected language (here
    "sa", from random weights) differs from the aligner's ("en"): both CLIs
    announce the new language and reload its default aligner, which for
    "sa" does not exist, so both raise the same ``ValueError``."""
    monkeypatch.setenv("WHISPERX_TPU_ALIGN_DIR", str(align_ckpt))
    for pkg in ("jax", "torch"):
        argv = _argv(workdir, f"{pkg}_reload", "float32", "--data_parallel", "off")
        argv.remove("--no_align")
        del argv[argv.index("--language") : argv.index("--language") + 2]
        with pytest.raises(ValueError, match="No default align-model for language: sa"):
            _run(pkg, argv)
        assert "New language found (sa)! Previous was (en)" in capsys.readouterr().out, pkg

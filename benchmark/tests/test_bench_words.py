"""A configuration that aligns (``align``): the seeded wav2vec2 weights, the
alignable vocabulary, the plain references (``reference/wav2vec2.py``,
``reference/ctc.py``) against the port, and whole ``offline_words`` runs at
the test-nano sizes on the CPU: a sound run is correct, and the bfloat16
aligner control and a broken aligner are not. Besides, the configurations
that do not align draw the same weights and install the same vocabulary as
before the ``align`` section existed (hashes taken on that tree)."""

import hashlib
import json
import math
import os
import shutil
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import nano
from harness import cell, spec, vocab
from reference import ctc, params
from reference import wav2vec2 as w2v

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

# sha256 on the tree before ``align``: each full configuration's layout
# (names, shapes, kinds), test-nano's bf16 weights at two seeds, and the
# vocabulary file ``vocab.write`` gives
LAYOUT_SHA = {"large-v3": "a0a3f593080f8b4c40eb343b776930b845c4cd99a8db164e1513613fefe8e207",
              "large-v3-turbo": "6431998c9dccf3121edae72732f06c501653a1bd2a1c6bea205c84ba26b45c5e"}
NANO_WEIGHTS_SHA = {5: "7694aade75babf2c0e89e152fe76bb143682d72d378c02cca260c99c3fdb300c",
                    2**31 + 12345: "67ed23e1f708ac972ce955bce36f202c9cfee2b00af6f070ed1593c655055916"}
VOCAB_SHA = "e58d8e9eb342c5df722c2e5ce4548d9671412053cbc163551959454ec19e0790"


@pytest.mark.parametrize("name", sorted(LAYOUT_SHA))
def test_layouts_of_the_configurations_are_unchanged(name):
    layout = params.layout(params.dims_of(spec.config(name)))
    assert hashlib.sha256(json.dumps(layout).encode()).hexdigest() == LAYOUT_SHA[name]
    assert "align" not in spec.config(name)


@pytest.mark.parametrize("seed", sorted(NANO_WEIGHTS_SHA))
def test_whisper_draws_are_unchanged(seed):
    h = hashlib.sha256()
    for name, t in params.make_weights(nano.config(), seed, CPU).items():
        h.update(name.encode())
        h.update(t.view(torch.int16).numpy().tobytes())
    assert h.hexdigest() == NANO_WEIGHTS_SHA[seed]


def test_vocabulary_without_align_is_unchanged(tmp_path):
    for name in LAYOUT_SHA:
        path = vocab.write(str(tmp_path / f"{name}.json"), vocab.alphabet(spec.config(name)))
        assert hashlib.sha256(open(path, "rb").read()).hexdigest() == VOCAB_SHA


def test_aligner_weights_follow_the_published_layout():
    """Every name and shape the port's loader asks for, in both layouts;
    a stream of their own, the seed's."""
    from whisperx_tpu_torch.convert.checkpoint import wav2vec2_from_numpy
    from whisperx_tpu_torch.models.wav2vec2 import config_from_json

    for stable in (True, False):
        cfg = nano.config()
        cfg["align"] = nano.align_section(stable)
        w = params.make_align_weights(cfg, 5, CPU)
        dims = params.align_dims(cfg)
        conv_bias = dims.pop("conv_bias")
        model = wav2vec2_from_numpy({k: v.numpy() for k, v in w.items()}, config_from_json(dims), device="cpu")
        assert (model.feature_extractor[0].b is not None) == conv_bias
        assert all(v.dtype == torch.float32 for v in w.values())
        gains = torch.cat([v for k, v in w.items() if k.endswith("/g")])
        assert 0.05 < float(gains.std()) < 0.15 and abs(float(gains.mean()) - 1) < 0.02
        again = params.make_align_weights(cfg, 5, CPU)
        assert all(torch.equal(w[k], again[k]) for k in w)
        other = params.make_align_weights(cfg, 6, CPU)
        assert not torch.equal(w["lm_head/w"], other["lm_head/w"])


def test_words_vocabulary_reads_back_its_ids(tmp_path):
    """Each id decodes to a space and a word; a segment's text, its leading
    space stripped as the pipeline strips it, splits back into the ids; the
    tokenizer's suppression lists and blank are the same as under the
    private-use vocabulary."""
    from whisperx_tpu_torch.decoding import filters as F_
    from whisperx_tpu_torch.decoding.tokenizer import get_tokenizer

    from harness import program

    cfg = nano.words_config()
    letters = vocab.alphabet(cfg)
    assert sorted(letters) == list("abcdefghijklmnopqrstuvwxyz")
    words = [vocab.word(i, letters) for i in range(vocab.N_BYTES, vocab.N_BASE)]
    assert len(set(words)) == len(words) and max(map(len, words)) == 4
    toks = {}
    for name, alpha in (("plain", None), ("words", letters)):
        toks[name] = get_tokenizer(True, num_languages=99, language="en", task="transcribe",
                                   vocab_path=vocab.write(str(tmp_path / f"{name}.json"), alpha))
    ids = [256, 281, 18533, 50256, 4000, 4000]
    text = toks["words"].decode(ids)
    assert text.startswith(" ") and vocab.token_ids(text.strip(), letters) == ids
    assert vocab.token_ids(text, letters) == ids
    assert vocab.token_ids(text.strip() + "!", letters) is None and vocab.token_ids("", letters) is None
    opts = program.pipeline_options(cfg, nano.words_workload())["suppress_tokens"]
    assert F_.build_suppress_list(toks["words"], opts) == F_.build_suppress_list(toks["plain"], opts)
    assert toks["words"].encode(" ") == toks["plain"].encode(" ") == [220]


@pytest.mark.parametrize("stable", [True, False], ids=["large-layout", "base-layout"])
def test_reference_model_matches_the_ports_forward(stable):
    """The port's ``models.wav2vec2.forward`` on the seeded weights: with
    the port's GELU (the tanh approximation) put into the reference, equal
    to f32 rounding (1e-4 in log-probability); with the published exact
    GELU, the approximation's share (under 5e-3 in log-probability, 5e-4 in
    probability). The bucket padding changes the real frames."""
    from whisperx_tpu_torch.convert.checkpoint import wav2vec2_from_numpy
    from whisperx_tpu_torch.models.wav2vec2 import config_from_json, forward

    cfg = nano.config()
    cfg["align"] = nano.align_section(stable)
    w = params.make_align_weights(cfg, 2**40 + 9, CPU)
    dims = params.align_dims(cfg)
    ported = dict(dims)
    ported.pop("conv_bias")
    port = wav2vec2_from_numpy({k: v.numpy() for k, v in w.items()}, config_from_json(ported), device="cpu")
    audio = torch.from_numpy(nano.pool(2.0)[None, :16384].copy())
    ref = w2v.Model(w, dims)
    with torch.no_grad():
        got = forward(port, audio)
        exact = ref.log_probs(audio)
        gelu = F.gelu
        try:
            w2v.F.gelu = lambda x: gelu(x, approximate="tanh")
            tanh = ref.log_probs(audio)
        finally:
            w2v.F.gelu = gelu
        assert float((got - tanh).abs().max()) < 1e-4
        assert float((got - exact).abs().max()) < 5e-3
        assert float((got.exp() - exact.exp()).abs().max()) < 5e-4
        padded = ref.log_probs(torch.nn.functional.pad(audio, (0, 16384)))[:, :exact.shape[1]]
        assert float((padded - exact).abs().max()) > 1e-3
    assert w2v.bucket_of(3000) == 4096 and w2v.bucket_of(4097) == 8192 and w2v.bucket_of(480000) == 2**19
    assert w2v.frames_of(dims, 16384) == exact.shape[1] == 50


def test_ctc_reference_takes_the_ports_path():
    """On the same emissions, ``reference/ctc.py`` takes the port's trellis
    and beam backtrack's path, and its characters' scores are the port's
    ``merge_repeats`` scores; a wildcard takes the best non-blank label."""
    from whisperx_tpu_torch.alignment import trellis as T

    rng = np.random.default_rng(3)
    for n_frames, n_tok in ((200, 40), (120, 100), (50, 50), (30, 31)):
        em = torch.log_softmax(torch.from_numpy(rng.normal(size=(n_frames, 32)).astype(np.float32)), -1).numpy()
        tokens = list(rng.integers(1, 32, n_tok))
        tokens[3] = -1
        np.testing.assert_array_equal(ctc.trellis(em, tokens, 0), T.get_trellis(em, tokens, 0))
        path = T.backtrack_beam(T.get_trellis(em, tokens, 0), em, tokens, 0, beam_width=2)
        js = ctc.align(em, tokens, 0)
        if path is None:
            assert js is None
            continue
        np.testing.assert_array_equal(js, [p.token_index for p in path])
        spans = T.merge_repeats(path, "x" * n_tok)
        np.testing.assert_allclose(ctc.char_scores(em, tokens, 0, js), [s.score for s in spans], rtol=1e-6)
        scores = ctc.frame_log_probs(em, tokens, 0, js)
        np.testing.assert_allclose(np.exp(scores), [p.score for p in path], rtol=1e-6)


def _moved(js: np.ndarray, k: int):
    """``js`` with character ``k``'s first frame given to character k - 1
    (its left boundary one frame later), and that frame; None where ``k``
    holds a single frame."""
    frames = np.flatnonzero(js == k)
    if len(frames) < 2:
        return None
    out = js.copy()
    out[frames[0]] = k - 1
    return out, int(frames[0])


def test_path_margin_is_nought_on_the_backtracks_own_path_and_a_step_on_a_moved_one():
    """A path the backtrack takes reads 0. A path with one boundary moved a
    frame reads about the gap of the trellis at the frame where the two
    paths part (at least half of it, about all of it as a rule: the other
    beam can make it cost more), never 0; one that starts past token 0
    reads +inf."""
    rng = np.random.default_rng(11)
    ratios = []
    for _ in range(60):
        em = torch.log_softmax(torch.from_numpy(2 * rng.normal(size=(60, 32)).astype(np.float32)), -1).numpy()
        tokens = list(rng.integers(1, 32, 12))
        tr = ctc.trellis(em, tokens, 0)
        js = ctc.backtrack(tr)
        assert js is not None
        assert ctc.path_margin(tr, js) == 0.0
        moved = next(m for m in (_moved(js, k) for k in range(1, 12)) if m is not None)
        other, t = moved
        gap = float(tr[t, other[t] + 1] - tr[t, other[t]])
        margin = ctc.path_margin(tr, other)
        assert 0.5 * gap <= margin < math.inf
        ratios.append(margin / gap)
        wrong_start = js.copy()
        wrong_start[0] = 1
        assert ctc.path_margin(tr, wrong_start) == math.inf
    assert 0.95 < float(np.median(ratios)) < 1.05


def test_path_margin_of_a_near_tie_is_the_size_of_the_rounding():
    """Emissions all but equal (every path scores alike, to 1e-6 a frame):
    a path the backtrack did not take reads under 1e-3, far below a moved
    boundary's step on distinct emissions."""
    rng = np.random.default_rng(100)
    read = []
    for _ in range(3):
        em = (np.full((80, 32), -math.log(32)) + 1e-6 * rng.normal(size=(80, 32))).astype(np.float32)
        tokens = list(rng.integers(1, 32, 20))
        tr = ctc.trellis(em, tokens, 0)
        js = ctc.backtrack(tr)
        assert ctc.path_margin(tr, js) == 0.0
        read += [ctc.path_margin(tr, m[0]) for m in (_moved(js, k) for k in range(1, 20)) if m is not None]
    assert len(read) >= 10
    assert max(read) < 1e-3


def test_a_sound_words_run_is_correct():
    out = nano.run_words()
    assert out["correct"], out["checks"]
    for k, limit in nano.ALIGN_LIMITS.items():
        assert out["checks"][k]["limit"] == limit
    assert out["extra"]["align_chars"] > 100 and out["extra"]["align_words"] > 10


def test_the_aligner_control_reads_above_the_limits_on_three_seeds():
    """The bfloat16 aligner control in the aligner's place, the Whisper half
    as the program served it: not correct through the aligned words alone,
    while the program's own readings meet the limits in the same run."""
    for seed in (11, 2**33 + 5, 987654321):
        out = nano.run_words(seed=seed, control=2)
        assert not out["correct"], out["checks"]
        c, e = out["checks"], out["extra"]
        assert all(c[k]["value"] <= c[k]["limit"] for k in ("max_gap", "off_grid", "empty_windows", "failed"))
        assert c["align_score_gap"]["value"] > nano.ALIGN_LIMITS["align_score_gap"] >= e["program_align_score_gap"]
        assert e["program_align_path_gap"] <= nano.ALIGN_LIMITS["align_path_gap"]
        assert e["program_align_missing"] == 0


def _final_norm_skipped(mp):
    from whisperx_tpu_torch import alignment
    from whisperx_tpu_torch.models.wav2vec2 import model as m

    load, norm = alignment.load_align_model, m._layer_norm

    def loaded(*a, **kw):
        aligner, meta = load(*a, **kw)
        aligner.model.encoder_ln.skipped = True
        return aligner, meta

    mp.setattr(alignment, "load_align_model", loaded)
    mp.setattr(m, "_layer_norm", lambda p, x, eps=1e-5: x if getattr(p, "skipped", False) else norm(p, x, eps))


def _wrong_bucket(mp):
    from whisperx_tpu_torch.alignment import aligner

    bucket_of = aligner.bucket_of
    mp.setattr(aligner, "bucket_of", lambda n: 2 * bucket_of(n))


def _half_batch(mp):
    """Every second segment of an emissions batch gets its neighbour's
    emissions, as far as its frames reach."""
    from whisperx_tpu_torch.alignment import aligner

    forward = aligner.Wav2Vec2Aligner._forward

    def half(self, batch):
        ems = forward(self, batch)
        ems[1::2] = ems[0::2][: ems[1::2].shape[0]]
        return ems

    mp.setattr(aligner.Wav2Vec2Aligner, "_forward", half)


def _greedy_path(mp):
    from whisperx_tpu_torch import alignment

    mp.setattr(alignment, "backtrack_beam", lambda tr, em, tok, blank, beam_width=2: alignment.backtrack(tr, em, tok, blank))


def _unaligned(mp):
    """The aligner is taken for random weights: ``align`` returns the
    transcript with no word times."""
    from whisperx_tpu_torch import alignment

    load = alignment.load_align_model

    def loaded(*a, **kw):
        aligner, meta = load(*a, **kw)
        return aligner, {**meta, "random_weights": True}

    mp.setattr(alignment, "load_align_model", loaded)


def _word_time_altered(mp):
    """``align`` returns each segment's first word 20 ms late."""
    from whisperx_tpu_torch import alignment

    align = alignment.align

    def altered(*a, **kw):
        out = align(*a, **kw)
        for seg in out["segments"]:
            if seg["words"] and "start" in seg["words"][0]:
                seg["words"][0]["start"] = round(seg["words"][0]["start"] + 0.02, 3)
        return out

    mp.setattr(alignment, "align", altered)


@pytest.mark.parametrize("fault", [_final_norm_skipped, _wrong_bucket, _half_batch, _greedy_path, _unaligned,
                                   _word_time_altered])
def test_a_broken_aligner_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = nano.run_words()
    assert not out["correct"], out["checks"]
    c = out["checks"]
    assert all(c[k]["value"] <= c[k]["limit"] for k in ("max_gap", "off_grid", "empty_windows", "failed"))


READER = '''"""A test metric: aligned words in the window's files."""


def read(ctx):
    n = sum(len(r["result"]["aligned"]["word_segments"]) for r in ctx.requests if "result" in r)
    return float(n) if n else None
'''


def test_an_aligning_cell_is_new_files_only(tmp_path):
    """A configuration with ``align``, its ``offline_words`` cell and a
    per-layer reader of its own, dropped into a copy of the benchmark with
    their entries in ``BENCHMARK.json``: a traced and an untraced run from
    the files alone are correct, and no file that was there is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json"), root / "BENCHMARK.json")
    before = {p: open(p, "rb").read() for p in map(str, root.rglob("*")) if os.path.isfile(p)}
    bench_dir = str(root / "benchmark")
    name = "test-nano-words.offline_words"
    (root / "benchmark" / "configs" / "test-nano-words.json").write_text(json.dumps(nano.words_config()))
    (root / "benchmark" / "workloads" / f"{name}.json").write_text(json.dumps(nano.words_workload()))
    (root / "benchmark" / "metrics" / "aligned_words.offline.py").write_text(READER)
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "test-nano-words", "source": "test", "file": "benchmark/configs/test-nano-words.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": name, "config": "test-nano-words", "traffic": "offline_words", "chips": 1,
                           "why": "test"})
    b["per_layer"].append({"name": "aligned_words.offline", "unit": "words", "better": "higher",
                           "source": "program_counter", "layer": "alignment", "moves": "audio_s_per_s",
                           "workloads": [name]})
    for m in b["end_to_end"]:
        if "large-v3-turbo.offline_long" in m.get("workloads", []):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    out, _ = cell.run(name, 2**31 + 99, 3.0, True, t_start=time.perf_counter(), device="cpu", bench_dir=bench_dir,
                      log=lambda s: None)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"aligned_words.offline"} and out["metrics"]["aligned_words.offline"]["value"] > 0
    out, _ = cell.run(name, 2**31 + 99, 3.0, False, t_start=time.perf_counter(), device="cpu", bench_dir=bench_dir,
                      log=lambda s: None)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"audio_s_per_s", "peak_mem_gib", "setup_s"}
    assert {"align_score_gap", "align_path_gap", "align_missing"} <= set(out["checks"])
    for p, data in before.items():
        if not p.endswith("BENCHMARK.json"):
            assert open(p, "rb").read() == data, p

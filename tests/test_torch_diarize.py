"""The port's speaker diarization against the JAX package on the CPU, with
the same numpy inputs and the same weights (carried over through the
bridges, or read from checkpoints that JAX's ``save_checkpoint`` wrote):

- the ResNet34 speaker embedding: ``fbank`` and ``embed`` (f32, 1e-5) at
  ``TEST_CONFIG`` and at two blocks a stage, on windows whose time side is
  even and odd at the stride-2 stages (XLA's asymmetric SAME padding), and
  through ``WHISPERX_TPU_SPEAKER_CKPT``;
- ``SpectralEmbedding`` (1e-5), ``powerset_table``, ``clean_frame_masks`` and
  ``SpeakerSegmenter.activity`` (identical);
- AHC (with cannot-links, with precomputed distances), spectral clustering
  and PLDA (``fit``, ``llr_matrix``, a JAX-saved file): identical labels,
  distances within 1e-9;
- ``DiarizationPipeline`` on both paths (VAD windows and segmentation, with
  JAX's two-voice and oracle-segmenter inputs): identical turns and labels
  for every clustering and speaker-count option, embeddings within 1e-5,
  the empty table, and the table's columns equal to JAX's DataFrame's;
- ``assign_word_speakers``, DER and WER: JAX's results."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synth_speech
from test_diarize import (
    SR,
    _OracleSegmenter,
    _ThreeSpeakerOracle,
    _three_voice_audio,
    _voice,
)
from whisperx_tpu import diarize as jdiar
from whisperx_tpu.convert.checkpoint import flatten_tree, save_checkpoint, unflatten_tree
from whisperx_tpu.diarize import clustering as jclu
from whisperx_tpu.diarize import plda as jplda
from whisperx_tpu.diarize import segmentation as jseg
from whisperx_tpu.diarize.embedding import SpectralEmbedding as JSpectral
from whisperx_tpu.models.pyannote import model as jpy
from whisperx_tpu.models.resnet_speaker import model as jrs
from whisperx_tpu.utils import der as jder
from whisperx_tpu.utils import wer as jwer
from whisperx_tpu.vad import load_vad_model as jax_vad
from whisperx_tpu_torch import diarize as tdiar
from whisperx_tpu_torch.convert import checkpoint as tckpt
from whisperx_tpu_torch.diarize import clustering as tclu
from whisperx_tpu_torch.diarize import plda as tplda
from whisperx_tpu_torch.diarize import segmentation as tseg
from whisperx_tpu_torch.diarize.embedding import SpectralEmbedding as TSpectral
from whisperx_tpu_torch.models import pyannote as tpy
from whisperx_tpu_torch.models import resnet_speaker as trs
from whisperx_tpu_torch.utils import der as tder
from whisperx_tpu_torch.utils import wer as twer
from whisperx_tpu_torch.vad import load_vad_model as torch_vad
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

EMBED_TOL = 1e-5
TWO_BLOCKS = jrs.ResNetSpeakerConfig(channels=(4, 8, 8, 8), blocks=(2, 2, 2, 2), embed_dim=16)
# a small PyanNet with segmentation-3.0's 7 powerset classes (3 local
# speakers, at most 2 at once); its classifier is scaled so that random
# weights activate every local speaker
SEG_CONFIG = jpy.PyanNetConfig(
    sincnet_filters=(8, 8, 8), lstm_hidden=16, lstm_layers=1, linear_dims=(16,), num_classes=7
)
ENV = (
    "WHISPERX_TPU_SPEAKER_CKPT",
    "WHISPERX_TPU_SEGMENTATION_CKPT",
    "WHISPERX_TPU_PLDA_CKPT",
    "WHISPERX_TPU_DIARIZE_CLUSTERING",
    "WHISPERX_TPU_SILERO_CKPT",
)


@pytest.fixture(autouse=True)
def _no_switches(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


def _torch_cfg(cls, cfg):
    return cls(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _resnet_params(cfg, seed=1):
    """JAX ``init_params`` with batch norms that are not the identity (random
    affine and statistics), as a converted checkpoint has."""
    flat = flatten_tree(jrs.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for key in flat:
        leaf = key.rsplit("/", 1)[1]
        if "bn" in key.split("/")[-2]:
            v = rng.standard_normal(flat[key].shape).astype(np.float32) * 0.1
            flat[key] = {"g": 1.0 + v, "var": 0.8 + np.abs(v)}.get(leaf, v).astype(np.float32)
    return flat


def _windows(n_samples, count=3, seed=0):
    return np.stack([synth_speech(n_samples / SR + 0.1, seed=seed + i)[:n_samples] for i in range(count)])


@pytest.fixture(scope="module")
def two_voices():
    """JAX's purity input: six alternating 3 s turns of two harmonic voices
    with 0.5 s pauses (tests/test_diarize.py), and its turns."""
    a = _voice(110.0, 3.0, bright=0.95, seed=1)
    b = _voice(260.0, 3.0, bright=1.05, seed=2)
    gap = np.zeros(int(0.5 * SR), np.float32)
    parts, truth, t0 = [], [], 0.0
    for i in range(6):
        parts += [a if i % 2 == 0 else b, gap]
        truth.append((t0, t0 + 3.0, f"V{i % 2}"))
        t0 += 3.5
    return np.concatenate(parts), truth


# -- the ResNet34 speaker embedding -------------------------------------------


# samples → T frames of 10 ms: 200 (even at every stride-2 stage), 195
# (odd at the first and the last), 191 (odd at the first)
LENGTHS = (32000, 31200, 30560)


def _mel_power_f64(x):
    """The fbank's mel power before the log, in f64 with numpy's FFT:
    centre reflect padding, periodic Hann, hop 160, n_fft 400."""
    from whisperx_tpu_torch.audio.mel import mel_filters

    t = x.shape[1] // 160
    padded = np.pad(x.astype(np.float64), ((0, 0), (200, 200)), mode="reflect")
    frames = np.lib.stride_tricks.sliding_window_view(padded, 400, axis=1)[:, ::160][:, :t]
    hann = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(400) / 400))
    power = np.abs(np.fft.rfft(frames * hann, axis=-1)) ** 2
    return power @ mel_filters(80).astype(np.float64).T


@pytest.mark.parametrize("n", LENGTHS)
def test_fbank_matches_jax(n):
    """Log-mel fbank within 1e-4 where a bin holds at least 1e-4 of its
    frame's peak mel power. Further down, the log amplifies the f32 DFT's
    rounding (both packages' fbanks sit up to ~2e-4 from an f64 evaluation
    there), so those bins are held within 1e-3."""
    x = _windows(n)
    want = np.asarray(jrs.fbank(jnp.asarray(x)))
    got = trs.fbank(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, n // 160, 80)
    mel = _mel_power_f64(x)
    strong = mel >= 1e-4 * mel.max(axis=2, keepdims=True)
    err = np.abs(got - want)
    assert err[strong].max() <= 1e-4, err[strong].max()
    assert err.max() <= 1e-3, err.max()


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("cfg", [jrs.TEST_CONFIG, TWO_BLOCKS], ids=["test", "two-blocks"])
def test_embed_matches_jax(cfg, n):
    """The trunk, the statistics pooling and the projection: unit-norm
    embeddings within 1e-5 of JAX's on the same weights; the bridge writes
    back the same arrays it read."""
    flat = _resnet_params(cfg)
    model = tckpt.resnet_speaker_from_numpy(flat, _torch_cfg(trs.ResNetSpeakerConfig, cfg), device="cpu")
    back = tckpt.flatten_tree(model)
    assert set(back) == set(flat) and all(np.array_equal(back[k], flat[k]) for k in flat)
    x = _windows(n)
    want = np.asarray(jrs.embed(unflatten_tree(flat), cfg, jnp.asarray(x)))
    got = trs.embed(model, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=EMBED_TOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_same_padding_is_xlas():
    """At stride 2 on an even side XLA pads 0 before and 1 after; PyTorch's
    ``padding=1`` would shift every window: the port's embedding is JAX's,
    and the symmetric padding's is not."""
    flat = _resnet_params(jrs.TEST_CONFIG)
    model = tckpt.resnet_speaker_from_numpy(flat, trs.TEST_CONFIG, device="cpu")
    x = torch.from_numpy(_windows(32000))
    want = np.asarray(jrs.embed(unflatten_tree(flat), jrs.TEST_CONFIG, jnp.asarray(x.numpy())))

    def symmetric(x, w, stride):
        return torch.nn.functional.conv2d(x, w, stride=stride, padding=w.shape[-1] // 2)

    import whisperx_tpu_torch.models.resnet_speaker.model as mod

    mp = pytest.MonkeyPatch()
    mp.setattr(mod, "_same_conv", symmetric)
    try:
        wrong = trs.embed(model, x).numpy()
    finally:
        mp.undo()
    assert np.abs(wrong - want).max() > 100 * EMBED_TOL
    np.testing.assert_allclose(trs.embed(model, x).numpy(), want, atol=EMBED_TOL, rtol=0)


def test_resnet_checkpoint_through_the_switch(tmp_path, monkeypatch, two_voices):
    """A ResNet written by JAX's ``save_checkpoint`` and named by
    ``WHISPERX_TPU_SPEAKER_CKPT``: both pipelines embed with it, within
    1e-5, and give the same turns on the two voices."""
    cfg = TWO_BLOCKS
    path = str(tmp_path / "spk")
    save_checkpoint(
        path, unflatten_tree(_resnet_params(cfg, seed=3)),
        {"family": "resnet_speaker", "name": "test", "config": dataclasses.asdict(cfg)},
    )
    monkeypatch.setenv("WHISPERX_TPU_SPEAKER_CKPT", path)
    jpipe = jdiar.DiarizationPipeline(vad_model=jax_vad("energy"))
    tpipe = tdiar.DiarizationPipeline(device="cpu", vad_model=torch_vad("energy", device="cpu"))
    assert isinstance(tpipe.embedding, trs.ResNetSpeakerEmbedding) and tpipe.embedding.dim == 16
    x = _windows(32000, count=4, seed=9)
    np.testing.assert_allclose(tpipe.embedding.embed(x), jpipe.embedding.embed(x), atol=EMBED_TOL, rtol=0)
    (want, want_emb), (got, got_emb) = _run_both(jpipe, tpipe, two_voices[0], num_speakers=2)
    _same_table(got, want)
    _same_embeddings(got_emb, want_emb)


def test_resnet_default_weights_come_from_a_torch_generator():
    """Without a model, ``ResNetSpeakerEmbedding`` draws TEST_CONFIG weights
    from a ``torch.Generator`` seeded 0 (JAX: ``PRNGKey(0)``): deterministic
    unit-norm embeddings; a named difference from JAX's values."""
    x = _windows(32000, count=2)
    a = trs.ResNetSpeakerEmbedding(device="cpu").embed(x)
    b = trs.ResNetSpeakerEmbedding(device="cpu").embed(x)
    assert a.shape == (2, trs.TEST_CONFIG.embed_dim) and np.array_equal(a, b)
    np.testing.assert_allclose(np.linalg.norm(a, axis=1), 1.0, atol=1e-6)
    assert np.abs(a - jrs.ResNetSpeakerEmbedding().embed(x)).max() > 1e-3


# -- SpectralEmbedding, the powerset and the segmenter ---------------------------


@pytest.mark.parametrize("n", [32000, 8000, 160])
def test_spectral_embedding_matches_jax(n):
    """Log-mel mean, population std and mean |delta|, L2-normalized: within
    1e-5 (one frame: zero deltas, as in JAX); an empty batch is [0, 240]."""
    x = _windows(n, count=5, seed=4)
    want = JSpectral().embed(x)
    got = TSpectral(device="cpu").embed(x)
    assert got.dtype == np.float32 and got.shape == want.shape == (5, 240)
    np.testing.assert_allclose(got, want, atol=EMBED_TOL, rtol=0)
    assert TSpectral(device="cpu").embed(np.zeros((0, n), np.float32)).shape == (0, 240)


@pytest.mark.parametrize("classes", [2, 3, 4, 7, 8, 15])
def test_powerset_table_is_jaxs(classes):
    np.testing.assert_array_equal(tseg.powerset_table(classes), jseg.powerset_table(classes))


def test_powerset_table_refuses_what_jax_refuses():
    for mod in (jseg, tseg):
        for classes in (1, 9):
            with pytest.raises(ValueError, match="classes"):
                mod.powerset_table(classes)


@pytest.mark.parametrize("min_frames", [1, 4, 9])
def test_clean_frame_masks_are_jaxs(min_frames):
    act = (np.random.default_rng(min_frames).random((5, 40, 3)) < 0.3).astype(np.float32)
    np.testing.assert_array_equal(
        tseg.clean_frame_masks(act, min_frames), jseg.clean_frame_masks(act, min_frames)
    )


@pytest.fixture(scope="module")
def seg_params():
    params = jpy.init_params(SEG_CONFIG, jax.random.PRNGKey(2))
    params["classifier"]["w"] = params["classifier"]["w"] * 40.0
    return params


@pytest.mark.parametrize("seconds", [21.0, 7.0])
def test_segmenter_activity_is_jaxs(seg_params, two_voices, seconds):
    """The PyanNet bridged from JAX, every window in one forward: the same
    windows and starts, the same frame duration, the same powerset activity
    (a file shorter than one window is one padded window)."""
    audio = two_voices[0][: int(seconds * SR)]
    tcfg = _torch_cfg(tpy.PyanNetConfig, SEG_CONFIG)
    seg = tseg.SpeakerSegmenter(tckpt.pyannote_from_numpy(flatten_tree(seg_params), tcfg, device="cpu"))
    want = jseg.SpeakerSegmenter(seg_params, SEG_CONFIG).activity(audio)
    got = seg.activity(audio)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and seg.n_local_speakers == 3
    assert got[0].sum(axis=(0, 1)).min() > 0  # every local speaker active somewhere


# -- clustering and PLDA ----------------------------------------------------------


def _blobs(seed, k=3, per=8, d=16, spread=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d))
    return np.concatenate([c + spread * rng.standard_normal((per, d)) for c in centers])


AHC_CASES = {
    "threshold": dict(),
    "num": dict(num_clusters=2),
    "min": dict(min_clusters=4),
    "max": dict(max_clusters=2, threshold=0.9),
    "cannot-link": dict(cannot_link=[(0, 1), (2, 9), (8, 17)], threshold=0.6),
    "cannot-link num": dict(cannot_link=[(0, 1), (0, 2), (1, 2)], num_clusters=2),
}


@pytest.mark.parametrize("case", sorted(AHC_CASES))
def test_agglomerative_cluster_is_jaxs(case):
    x = _blobs(5)
    kw = AHC_CASES[case]
    got = tclu.agglomerative_cluster(x, **kw)
    np.testing.assert_array_equal(got, jclu.agglomerative_cluster(x, **kw))
    assert got.dtype == np.int32


def test_agglomerative_cluster_with_precomputed_distances_is_jaxs():
    x = _blobs(6)
    dist = 1.0 - np.corrcoef(x)
    for kw in (dict(threshold=0.5), dict(num_clusters=3, cannot_link=[(0, 3)])):
        np.testing.assert_array_equal(
            tclu.agglomerative_cluster(x, distances=dist, **kw),
            jclu.agglomerative_cluster(x, distances=dist, **kw),
        )
    np.testing.assert_allclose(
        tclu.cosine_distance_matrix(x), jclu.cosine_distance_matrix(x), atol=1e-9, rtol=0
    )
    with pytest.raises(ValueError, match="distances must be"):
        tclu.agglomerative_cluster(x, distances=dist[:3, :3])


SPECTRAL_CASES = {
    "auto": dict(max_clusters=8),
    "num": dict(num_clusters=3),
    "min": dict(min_clusters=5),
    "cannot-link": dict(num_clusters=2, cannot_link=[(0, 1), (8, 9)]),
}


@pytest.mark.parametrize("case", sorted(SPECTRAL_CASES))
def test_spectral_cluster_is_jaxs(case):
    x = _blobs(7, spread=0.5)
    kw = SPECTRAL_CASES[case]
    np.testing.assert_array_equal(tclu.spectral_cluster(x, **kw), jclu.spectral_cluster(x, **kw))


def test_clusterings_of_nothing_and_one_are_jaxs():
    for fn in ("agglomerative_cluster", "spectral_cluster"):
        for x in (np.zeros((0, 4)), np.ones((1, 4))):
            np.testing.assert_array_equal(getattr(tclu, fn)(x), getattr(jclu, fn)(x))


def test_plda_fit_score_and_files_are_jaxs(tmp_path):
    """``PLDA.fit`` (with the rank guard: fewer within-class degrees of
    freedom than dimensions), ``llr_matrix`` and the negated-LLR distances
    within 1e-9; a PLDA saved by JAX (without the ``.npz`` suffix) loads in
    the port, through ``load_plda`` and ``WHISPERX_TPU_PLDA_CKPT`` too; the
    self-trained PLDA's clustering gives the same labels."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(i, 0.3, (6, 24)) for i in range(3)])
    labels = np.repeat(np.arange(3), 6)
    for kw in (dict(), dict(length_norm=False)):
        want, got = jplda.PLDA.fit(x, labels, **kw), tplda.PLDA.fit(x, labels, **kw)
        for attr in ("mean", "transform", "psi"):
            np.testing.assert_allclose(getattr(got, attr), getattr(want, attr), atol=1e-9, rtol=0)
        np.testing.assert_allclose(got.llr_matrix(x), want.llr_matrix(x), atol=1e-9, rtol=0)
    path = str(tmp_path / "plda")
    want.save(path)
    loaded = tplda.load_plda(path)
    np.testing.assert_allclose(
        tplda.plda_distances(x, loaded), jplda.plda_distances(x, want), atol=1e-9, rtol=0
    )
    assert loaded.llr(x[0], x[1]) == pytest.approx(want.llr(x[0], x[1]), abs=1e-9)
    with pytest.raises(ValueError, match="2 classes"):
        tplda.PLDA.fit(x[:3], np.arange(3))
    y = _blobs(3, per=6, d=24, spread=0.05)  # near-duplicates to self-train on
    trained = (jplda.self_trained_plda(y), tplda.self_trained_plda(y))
    assert trained[1] is not None
    np.testing.assert_array_equal(
        tclu.agglomerative_cluster(y, distances=tplda.plda_distances(y, trained[1]), threshold=0.0),
        jclu.agglomerative_cluster(y, distances=jplda.plda_distances(y, trained[0]), threshold=0.0),
    )
    assert tplda.self_trained_plda(y[:7]) is None


# -- the pipeline ------------------------------------------------------------------


def _same_table(got, want):
    """The port's ``TurnTable`` against JAX's DataFrame, column by column."""
    assert isinstance(got, tdiar.TurnTable)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for col in got.columns:
        assert list(got[col]) == list(want[col]), col
    assert got["start"].dtype == np.float64 and got["end"].dtype == np.float64


def _same_embeddings(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=EMBED_TOL, rtol=0)


class _Recorder:
    """An embedding backend that keeps its last inputs and outputs, or
    replays given outputs."""

    def __init__(self, inner, replay=None):
        self.inner, self.replay = inner, replay
        self.inputs = self.outputs = None

    def embed(self, windows):
        self.inputs = np.array(windows)
        self.outputs = self.inner.embed(windows) if self.replay is None else self.replay
        return self.outputs


def _run_both(jpipe, tpipe, audio, **kw):
    """Both pipelines on ``audio``: the embedding inputs must be the same
    bits and the embeddings within 1e-5; the port's host path (clustering,
    turns) fed JAX's embeddings must give JAX's table exactly. Returns
    (JAX's output, the port's with its own embeddings)."""
    j_emb, t_emb = jpipe.embedding, tpipe.embedding
    try:
        jpipe.embedding, tpipe.embedding = _Recorder(j_emb), _Recorder(t_emb)
        want = jpipe(audio, return_embeddings=True, **kw)
        got = tpipe(audio, return_embeddings=True, **kw)
        if jpipe.embedding.inputs is not None:
            np.testing.assert_array_equal(tpipe.embedding.inputs, jpipe.embedding.inputs)
            np.testing.assert_allclose(
                tpipe.embedding.outputs, jpipe.embedding.outputs, atol=EMBED_TOL, rtol=0
            )
            tpipe.embedding = _Recorder(t_emb, replay=jpipe.embedding.outputs)
            _same_table(tpipe(audio, **kw), want[0])
    finally:
        jpipe.embedding, tpipe.embedding = j_emb, t_emb
    return want, got


VAD_OPTIONS = {
    "num 2": dict(num_speakers=2),
    "auto": dict(),
    "min 3": dict(min_speakers=3),
    "max 1": dict(max_speakers=1),
}
# Where the turns depend on differences far below the embeddings' f32
# rounding: two voices forced into three speakers with PLDA, self-trained on
# this file's near-duplicate windows (each voice's turns repeat one
# waveform), whose distances span ~1e5 and move by up to ~0.5 for a 2e-7
# change of an embedding; which window of one voice splits off then rests
# on that rounding, in JAX's own arithmetic as in the port's. There the
# port's host path is held to JAX's with JAX's embeddings (``_run_both``),
# and the embeddings within 1e-5, not the final labels.
ILL_CONDITIONED = {("plda", "min 3")}


@pytest.fixture(scope="module")
def vad_pipes():
    return {
        c: (
            jdiar.DiarizationPipeline(vad_model=jax_vad("energy"), clustering=c),
            tdiar.DiarizationPipeline(device="cpu", vad_model=torch_vad("energy", device="cpu"), clustering=c),
        )
        for c in tdiar.CLUSTERINGS
    }


@pytest.mark.parametrize("clustering", tdiar.CLUSTERINGS)
@pytest.mark.parametrize("option", sorted(VAD_OPTIONS))
def test_vad_path_is_jaxs(vad_pipes, two_voices, clustering, option):
    """The VAD path (energy VAD → 2 s windows → SpectralEmbedding → the
    clustering) on JAX's two voices: the same embedding inputs, embeddings
    within 1e-5, the same turns and labels (see ``ILL_CONDITIONED``), and the
    speaker embeddings within 1e-5."""
    audio, truth = two_voices
    (want, want_emb), (got, got_emb) = _run_both(*vad_pipes[clustering], audio, **VAD_OPTIONS[option])
    if (clustering, option) in ILL_CONDITIONED:
        assert len(got) and len(set(got["speaker"])) == len(set(want["speaker"])) == 3
        return
    _same_table(got, want)
    _same_embeddings(got_emb, want_emb)
    if option == "num 2":  # JAX's DER bound on this input holds for the port
        assert tder.diarization_error_rate(truth, got)["der"] <= 0.1


@pytest.mark.parametrize("clustering", tdiar.CLUSTERINGS)
@pytest.mark.parametrize(
    "oracle, option",
    [
        ("two", dict(num_speakers=2)),
        ("two", dict()),
        ("three", dict()),
        ("three", dict(max_speakers=5)),
        ("three", dict(min_speakers=4)),
        ("three", dict(num_speakers=2)),
    ],
    ids=["two num 2", "two auto", "three auto", "three max 5", "three min 4", "three num 2"],
)
def test_segmentation_path_is_jaxs(clustering, oracle, option):
    """The segmentation path with JAX's oracle segmenters (overlap, local
    indices that swap between windows): the clean-frame gather, the
    cannot-links, the clustering and the frame-grid aggregation give the
    same turns; PLDA with too few items falls back to cosine with JAX's
    warning in both."""
    if oracle == "two":
        seg = _OracleSegmenter()
        a = _voice(120.0, 12.0, bright=0.5, seed=4)
        b = _voice(300.0, 12.0, bright=1.2, seed=5)
        audio = a.copy()
        audio[4 * SR :] = b[4 * SR :]
        audio[4 * SR : 6 * SR] += a[4 * SR : 6 * SR]
    else:
        seg, audio = _ThreeSpeakerOracle(), _three_voice_audio()
    jpipe = jdiar.DiarizationPipeline(segmentation_model=seg, clustering=clustering)
    tpipe = tdiar.DiarizationPipeline(segmentation_model=seg, clustering=clustering, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        (want, want_emb), (got, got_emb) = _run_both(jpipe, tpipe, audio, **option)
    _same_table(got, want)
    _same_embeddings(got_emb, want_emb)
    fell_back = [w for w in caught if "falling back to cosine AHC" in str(w.message)]
    assert len(fell_back) == (3 if clustering == "plda" else 0)  # JAX, the port, the replay


def test_neural_path_through_the_switches_is_jaxs(tmp_path, monkeypatch, seg_params, two_voices):
    """Both checkpoints written by JAX's ``save_checkpoint`` and named by
    ``WHISPERX_TPU_SEGMENTATION_CKPT`` and ``WHISPERX_TPU_SPEAKER_CKPT``, the
    clustering by ``WHISPERX_TPU_DIARIZE_CLUSTERING``: PyanNet activity →
    ResNet embeddings of the clean frames → AHC, the same turns."""
    seg_path, spk_path = str(tmp_path / "seg"), str(tmp_path / "spk")
    save_checkpoint(
        seg_path, seg_params,
        {"family": "pyannote_segmentation", "name": "test", "config": dataclasses.asdict(SEG_CONFIG)},
    )
    save_checkpoint(
        spk_path, unflatten_tree(_resnet_params(jrs.TEST_CONFIG, seed=4)),
        {"family": "resnet_speaker", "name": "test", "config": dataclasses.asdict(jrs.TEST_CONFIG)},
    )
    monkeypatch.setenv("WHISPERX_TPU_SEGMENTATION_CKPT", seg_path)
    monkeypatch.setenv("WHISPERX_TPU_SPEAKER_CKPT", spk_path)
    monkeypatch.setenv("WHISPERX_TPU_DIARIZE_CLUSTERING", "spectral")
    jpipe = jdiar.DiarizationPipeline()
    tpipe = tdiar.DiarizationPipeline(device="cpu")
    assert tpipe.vad_model is None and tpipe.clustering == "spectral"
    assert isinstance(tpipe.segmenter, tseg.SpeakerSegmenter)
    audio = two_voices[0]
    for kw in (dict(max_speakers=4), dict(num_speakers=2)):
        (want, want_emb), (got, got_emb) = _run_both(jpipe, tpipe, audio, **kw)
        assert len(got) >= 2
        _same_table(got, want)
        _same_embeddings(got_emb, want_emb)


def test_a_checkpoint_that_fails_to_load_raises(tmp_path, monkeypatch):
    """A checkpoint directory is never replaced by the default model: one
    that does not load raises."""
    bad = tmp_path / "bad"
    bad.mkdir()
    for name in ("WHISPERX_TPU_SPEAKER_CKPT", "WHISPERX_TPU_SEGMENTATION_CKPT"):
        monkeypatch.setenv(name, str(bad))
        with pytest.raises(FileNotFoundError):
            tdiar.DiarizationPipeline(device="cpu", vad_model=torch_vad("energy", device="cpu"))
        monkeypatch.delenv(name)


def test_silence_gives_the_empty_table():
    """No speech: an empty table with the five columns (and ``None``
    embeddings), as JAX's empty DataFrame, not an error."""
    audio = np.zeros(3 * SR, np.float32)
    want = jdiar.DiarizationPipeline(vad_model=jax_vad("energy"))(audio, return_embeddings=True)
    got = tdiar.DiarizationPipeline(device="cpu", vad_model=torch_vad("energy", device="cpu"))(
        audio, return_embeddings=True
    )
    assert got[1] is None and want[1] is None
    _same_table(got[0], want[0])
    assert len(got[0]) == 0 and list(got[0]) == []
    assert list(got[0].to_pandas().columns) == list(want[0].columns)


def test_default_models_and_device(monkeypatch):
    """With no checkpoint the models are JAX's defaults: SpectralEmbedding
    and the VAD path with ``load_vad_model("silero")`` (the energy VAD, with
    its warning); every model on the pipeline's device; an unknown
    clustering raises; CUDA without a GPU raises."""
    with pytest.warns(UserWarning, match="Silero"):
        pipe = tdiar.DiarizationPipeline(device="cpu", use_auth_token="ignored")
    assert isinstance(pipe.embedding, TSpectral) and pipe.embedding.device.type == "cpu"
    assert pipe.segmenter is None and type(pipe.vad_model).__name__ == "EnergyVAD"
    assert pipe.clustering == "ahc" and pipe.model_name == "pyannote-tpu"
    with pytest.raises(ValueError, match="unknown clustering"):
        tdiar.DiarizationPipeline(device="cpu", clustering="kmeans", vad_model=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tdiar.DiarizationPipeline(vad_model=object())


def test_turn_table_is_a_column_table(two_voices):
    """The deliberate difference from JAX: a ``TurnTable`` in place of a
    DataFrame. ``len``, columns as numpy arrays, rows as dicts; the DER
    scorer and ``assign_word_speakers`` read it as they read the DataFrame;
    ``to_pandas()`` gives JAX's DataFrame."""
    audio = two_voices[0]
    want = jdiar.DiarizationPipeline(vad_model=jax_vad("energy"))(audio, num_speakers=2)
    got = tdiar.DiarizationPipeline(device="cpu", vad_model=torch_vad("energy", device="cpu"))(
        audio, num_speakers=2
    )
    rows = list(got)
    assert len(rows) == len(got) and set(rows[0]) == set(got.columns)
    assert rows[0]["segment"] == (rows[0]["start"], rows[0]["end"])
    assert isinstance(got["speaker"], np.ndarray) and "SPEAKER_00" in set(got["speaker"])
    df = got.to_pandas()
    for col in got.columns:
        assert list(df[col]) == list(want[col]), col
    ref = [(0.0, 3.0, "A"), (3.5, 6.5, "B"), (7.0, 10.0, "A")]
    assert tder.diarization_error_rate(ref, got) == jder.diarization_error_rate(ref, want)


# -- speaker assignment, DER, WER ------------------------------------------------------


def _transcript():
    return {
        "segments": [
            {"start": 1.0, "end": 4.0, "text": "a", "words": [
                {"word": "a", "start": 1.0, "end": 2.0},
                {"word": "b", "start": 6.0, "end": 7.0},
                {"word": "c"},  # no timing: left alone
                {"word": "d", "start": 20.0, "end": 21.0},
            ]},
            {"start": 6.0, "end": 9.0, "text": "b", "words": []},
            {"start": 30.0, "end": 31.0, "text": "c"},
        ]
    }


@pytest.mark.parametrize("fill_nearest", [False, True])
@pytest.mark.parametrize("embeddings", [None, {"SPEAKER_00": [0.5, 0.5]}])
def test_assign_word_speakers_is_jaxs(fill_nearest, embeddings):
    import pandas as pd

    turns = [(0.0, 5.0, "SPEAKER_00"), (4.5, 10.0, "SPEAKER_01"), (12.0, 13.0, "SPEAKER_00")]
    df = pd.DataFrame({"start": [t[0] for t in turns], "end": [t[1] for t in turns],
                       "speaker": [t[2] for t in turns]})
    want = jdiar.assign_word_speakers(df, _transcript(), embeddings, fill_nearest=fill_nearest)
    for table in (tdiar.TurnTable(turns), df):
        assert tdiar.assign_word_speakers(table, _transcript(), embeddings, fill_nearest=fill_nearest) == want
    assert tdiar.assign_word_speakers(tdiar.TurnTable(), _transcript()) == _transcript()


def _der_cases():
    """The cases of tests/test_der.py, and a shuffled one with overlap."""
    rng = np.random.default_rng(0)
    ref, hyp, t = [], [], 0.0
    for i in range(12):
        dur = float(rng.uniform(1.0, 4.0))
        ref.append((t, t + dur, f"R{i % 4}"))
        hyp.append((t + 0.05, t + dur, f"H{(i + 1) % 4}"))
        t += dur + 0.5
    return {
        "identical": ([(0.0, 10.0, "A"), (12.0, 20.0, "B")], [(0.0, 10.0, "A"), (12.0, 20.0, "B")], {}),
        "permuted": ([(0.0, 10.0, "alice"), (10.0, 20.0, "bob")],
                     [(0.0, 10.0, "SPEAKER_01"), (10.0, 20.0, "SPEAKER_00")], {}),
        "empty hyp": ([(0.0, 10.0, "A")], [], {}),
        "empty ref": ([], [(0.0, 5.0, "X")], {}),
        "both empty": ([], [], {}),
        "confusion": ([(0.0, 10.0, "A"), (10.0, 20.0, "B")], [(0.0, 20.0, "X")], {}),
        "false alarm": ([(0.0, 10.0, "A")], [(0.0, 10.0, "X"), (12.0, 15.0, "X")], {}),
        "collar": ([(0.0, 10.0, "A"), (10.0, 20.0, "B")], [(0.0, 10.2, "X"), (10.2, 20.0, "Y")],
                   {"collar": 0.25}),
        "overlap": ([(0.0, 10.0, "A"), (5.0, 15.0, "B")], [(0.0, 15.0, "X")], {}),
        "skip overlap": ([(0.0, 10.0, "A"), (5.0, 15.0, "B")], [(0.0, 15.0, "X")],
                         {"skip_overlap": True}),
        "one to one": ([(0.0, 10.0, "A"), (10.0, 12.0, "B")],
                       [(0.0, 6.0, "X"), (6.0, 10.0, "Y"), (10.0, 12.0, "Y")], {}),
        "dicts": ([{"start": 0.0, "end": 4.0, "speaker": "A"}], [{"start": 1.0, "end": 4.0, "speaker": "B"}], {}),
        "shuffled": (ref, hyp, {}),
    }


@pytest.mark.parametrize("case", sorted(_der_cases()))
def test_der_is_jaxs(case):
    ref, hyp, kw = _der_cases()[case]
    kw = {"collar": 0.0, **kw}
    assert tder.diarization_error_rate(ref, hyp, **kw) == jder.diarization_error_rate(ref, hyp, **kw)


def test_rttm_files_are_jaxs(tmp_path):
    """``save_rttm`` writes JAX's bytes; each package reads the other's."""
    turns = [(0.0, 1.5, "SPEAKER_00"), (1.5, 3.25, "SPEAKER_01"), (4.0, 4.0, "SPEAKER_00")]
    jder.save_rttm(turns, str(tmp_path / "j.rttm"), uri="clip")
    tder.save_rttm(tdiar.TurnTable(turns), str(tmp_path / "t.rttm"), uri="clip")
    assert (tmp_path / "t.rttm").read_bytes() == (tmp_path / "j.rttm").read_bytes()
    assert tder.load_rttm(str(tmp_path / "j.rttm")) == jder.load_rttm(str(tmp_path / "t.rttm"))
    from whisperx_tpu_torch.utils import diarization_error_rate, load_rttm, save_rttm

    assert (diarization_error_rate, load_rttm, save_rttm) == (
        tder.diarization_error_rate, tder.load_rttm, tder.save_rttm
    )


WER_CASES = [
    ("the cat sat on the mat", "the cat sat on the mat"),
    ("The cat, sat!", "the cat sat"),
    ("the cat sat on the mat", "a cat sat on mat today"),
    ("", "something"),
    ("hello world", ""),
    ("don't stop", "dont stop"),
]


@pytest.mark.parametrize("ref, hyp", WER_CASES)
def test_wer_is_jaxs(ref, hyp):
    for normalize in (True, False):
        assert twer.wer(ref, hyp, normalize) == jwer.wer(ref, hyp, normalize)
        assert twer.cer(ref, hyp, normalize) == jwer.cer(ref, hyp, normalize)
        assert dataclasses.asdict(twer.wer_details(ref, hyp, normalize)) == dataclasses.asdict(
            jwer.wer_details(ref, hyp, normalize)
        )
    assert twer.normalize_text(ref) == jwer.normalize_text(ref)

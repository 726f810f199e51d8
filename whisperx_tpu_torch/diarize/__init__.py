"""Speaker diarization and per-word speaker assignment.

Counterpart of ``whisperx_tpu/diarize/__init__.py`` (reference
whisperx/diarize.py, whose pyannote.audio pipeline it replaces), mirroring
pyannote/speaker-diarization-3.1's architecture:

  segmentation model (batched PyanNet, overlap-aware powerset activity)
  → embeddings per (window, local speaker) on single-speaker frames only
  → constrained cosine AHC (or spectral, or PLDA) → global labels
  → overlap-capable turn aggregation.

Without a segmentation checkpoint it runs VAD speech regions → sliding
embedding windows → clustering (no overlap handling). The networks run on
the pipeline's ``device``; clustering, PLDA and the turn bookkeeping run on
the host in numpy, as in JAX. ``assign_word_speakers`` is the reference's
max-summed-intersection rule (diarize.py:104-133).

One deliberate difference: the pipeline returns a ``TurnTable``, a small
column table of its own with the DataFrame's five columns, instead of a
``pandas.DataFrame`` (the port does not need pandas; ``to_pandas()`` makes
one on request). ``assign_word_speakers`` and the DER scorer accept either.
"""

from __future__ import annotations

import os
import warnings
from typing import Iterator, Optional, Union

import numpy as np
import torch

from whisperx_tpu_torch.audio import SAMPLE_RATE, load_audio
from whisperx_tpu_torch.diarize.clustering import agglomerative_cluster
from whisperx_tpu_torch.diarize.embedding import SpectralEmbedding
from whisperx_tpu_torch.diarize.segmentation import SpeakerSegmenter, clean_frame_masks

WINDOW_S = 2.0
HOP_S = 0.5
EMBED_WINDOW_S = 2.0  # fixed embedding input length (equal-length batching)
CLUSTERINGS = ("ahc", "spectral", "plda")


class TurnTable:
    """Speaker turns as columns: ``segment`` ((start, end) tuples), ``label``,
    ``speaker``, ``start`` and ``end`` (float64), in the order of the JAX
    package's DataFrame. ``len(table)``; ``table["start"]`` is a numpy array
    (``segment`` an object array of tuples); iteration yields one dict per
    row; ``to_pandas()`` builds the DataFrame (importing pandas only then)."""

    columns = ("segment", "label", "speaker", "start", "end")

    def __init__(self, turns=()):
        turns = list(turns)
        segment = np.empty(len(turns), object)
        segment[:] = [(s, e) for s, e, _ in turns]
        speakers = np.array([spk for _, _, spk in turns], object)
        self._cols = {
            "segment": segment,
            "label": speakers,
            "speaker": speakers.copy(),
            "start": np.array([s for s, _, _ in turns], np.float64),
            "end": np.array([e for _, e, _ in turns], np.float64),
        }

    def __len__(self) -> int:
        return len(self._cols["start"])

    def __getitem__(self, column: str) -> np.ndarray:
        return self._cols[column]

    def __iter__(self) -> Iterator[dict]:
        for i in range(len(self)):
            yield {c: self._cols[c][i] for c in self.columns}

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame({c: list(self._cols[c]) for c in self.columns}, columns=list(self.columns))


class DiarizationPipeline:
    """API of the reference's DiarizationPipeline (diarize.py:11-83): a
    callable returning a ``TurnTable`` (+ an embeddings dict on request).

    The models come from the JAX package's switches: a ResNet embedding from
    the ``WHISPERX_TPU_SPEAKER_CKPT`` directory (else ``SpectralEmbedding``),
    a segmenter from ``WHISPERX_TPU_SEGMENTATION_CKPT`` (else the VAD path,
    with ``load_vad_model("silero")``); ``clustering`` defaults to
    ``WHISPERX_TPU_DIARIZE_CLUSTERING``, else ``"ahc"``. Every model it
    builds runs on ``device`` (CUDA without a GPU raises).
    ``use_auth_token`` is accepted and ignored."""

    def __init__(
        self,
        model_name: Optional[str] = None,
        use_auth_token=None,
        device: Union[str, torch.device] = "cuda",
        embedding_model=None,
        vad_model=None,
        segmentation_model: Optional[SpeakerSegmenter] = None,
        clustering: Optional[str] = None,
    ):
        from whisperx_tpu_torch.models.whisper import resolve_device

        self.device = resolve_device(device)
        self.model_name = model_name or "pyannote-tpu"
        # "ahc" (cannot-link constrained average-linkage cosine, default),
        # "spectral" (normalized-Laplacian with connected-component count
        # estimation), or "plda" (AHC over PLDA log-likelihood-ratio
        # scores: trained params via WHISPERX_TPU_PLDA_CKPT, else
        # self-trained on the utterance; see diarize/plda.py)
        self.clustering = (
            clustering or os.environ.get("WHISPERX_TPU_DIARIZE_CLUSTERING") or "ahc"
        ).lower()
        if self.clustering not in CLUSTERINGS:
            raise ValueError(
                f"unknown clustering {self.clustering!r} (use ahc, spectral, or plda)"
            )
        self._plda = None  # loaded on first use for clustering="plda"
        if embedding_model is None:
            ckpt = os.environ.get("WHISPERX_TPU_SPEAKER_CKPT")
            if ckpt and os.path.isdir(ckpt):
                from whisperx_tpu_torch.models.resnet_speaker import ResNetSpeakerEmbedding

                embedding_model = ResNetSpeakerEmbedding.from_checkpoint(ckpt, device=self.device)
            else:
                embedding_model = SpectralEmbedding(device=self.device)
        self.embedding = embedding_model

        if segmentation_model is None:
            seg_ckpt = os.environ.get("WHISPERX_TPU_SEGMENTATION_CKPT")
            if seg_ckpt and os.path.isdir(seg_ckpt):
                segmentation_model = SpeakerSegmenter.from_checkpoint(seg_ckpt, device=self.device)
        self.segmenter = segmentation_model

        if vad_model is None and segmentation_model is None:
            from whisperx_tpu_torch.vad import load_vad_model

            vad_model = load_vad_model("silero", device=self.device)
        self.vad_model = vad_model

    def __call__(
        self,
        audio: Union[str, np.ndarray],
        num_speakers: Optional[int] = None,
        min_speakers: Optional[int] = None,
        max_speakers: Optional[int] = None,
        return_embeddings: bool = False,
    ):
        if isinstance(audio, str):
            audio = load_audio(audio)
        audio = np.asarray(audio, np.float32).reshape(-1)

        diarize = self._segmentation_diarize if self.segmenter is not None else self._vad_diarize
        turns, labels, embeds = diarize(audio, num_speakers, min_speakers, max_speakers)
        table = TurnTable(turns)
        if not return_embeddings:
            return table
        if not turns:
            return table, None
        speaker_embeddings = {
            f"SPEAKER_{lab:02d}": embeds[labels == lab].mean(axis=0).tolist()
            for lab in sorted(set(labels.tolist()))
        }
        return table, speaker_embeddings

    # clustering dispatch (shared by both diarization paths)

    def _cluster(
        self,
        embeds: np.ndarray,
        *,
        num_clusters: Optional[int],
        min_clusters: int,
        max_clusters: Optional[int],
        cannot_link=None,
    ) -> np.ndarray:
        limits = dict(
            num_clusters=num_clusters,
            min_clusters=min_clusters,
            max_clusters=max_clusters,
            cannot_link=cannot_link,
        )
        if self.clustering == "spectral":
            from whisperx_tpu_torch.diarize.clustering import spectral_cluster

            return spectral_cluster(embeds, **limits)
        if self.clustering == "plda":
            dist = self._plda_distances(embeds)
            if dist is not None:  # LLR > 0 ⇒ same speaker
                return agglomerative_cluster(embeds, distances=dist, threshold=0.0, **limits)
            # cosine when no PLDA can be had
        return agglomerative_cluster(embeds, **limits)

    def _plda_distances(self, embeds: np.ndarray):
        """Negated-LLR distance matrix for clustering="plda": converted
        params if available, else self-trained on this utterance's
        embeddings; None (→ cosine AHC) when neither works."""
        from whisperx_tpu_torch.diarize.plda import load_plda, plda_distances, self_trained_plda

        if self._plda is None:
            self._plda = load_plda()
        plda = self._plda or self_trained_plda(embeds)
        if plda is None:
            warnings.warn(
                "clustering='plda' but no WHISPERX_TPU_PLDA_CKPT and too "
                "few embeddings to self-train; falling back to cosine AHC."
            )
            return None
        return plda_distances(embeds, plda)

    # pyannote-3.1-style path: segmentation → clean-frame embeddings →
    # constrained clustering → overlap-aware aggregation

    def _segmentation_diarize(self, audio, num_speakers, min_speakers, max_speakers):
        act, starts, frame_dur = self.segmenter.activity(audio)  # [W, F, K]
        n_win, n_frames, _ = act.shape
        masks = clean_frame_masks(act)  # [W, K, F]

        # (window, speaker) items with any activity → embedding inputs
        active_frames = masks.sum(axis=2)  # [W, K]
        ws, ks = np.nonzero(active_frames > 0)
        items = list(zip(ws.tolist(), ks.tolist()))
        if not items:
            return [], np.zeros(0, np.int32), np.zeros((0, 1), np.float32)

        embed_len = int(EMBED_WINDOW_S * SAMPLE_RATE)
        spf = frame_dur * SAMPLE_RATE  # samples per segmentation frame
        win_samples = int(self.segmenter.window_s * SAMPLE_RATE)

        # each item's clean samples: its window's audio selected by the frame
        # mask at sample resolution, tiled to the embedding length
        frame_of_sample = np.minimum(
            (np.arange(win_samples) / spf).astype(np.int64), n_frames - 1
        )
        inputs = np.zeros((len(items), embed_len), np.float32)
        for i, (w, k) in enumerate(items):
            base = int(starts[w] * SAMPLE_RATE)
            win_audio = audio[base : base + win_samples]
            sample_mask = masks[w, k][frame_of_sample[: len(win_audio)]] > 0
            cat = win_audio[sample_mask]
            if len(cat) >= embed_len:
                inputs[i] = cat[:embed_len]
            elif cat.any():
                # tile speech to fill the window (see _vad_diarize)
                inputs[i] = np.pad(cat, (0, embed_len - len(cat)), mode="wrap")
            else:
                inputs[i, : len(cat)] = cat
        embeds = self.embedding.embed(inputs)  # ONE batched device call

        # two local speakers active in the SAME window are different people:
        # the max concurrent count lower-bounds the speaker count, and the
        # same-window pairs are cannot-links (items are window-major)
        concurrent = int((active_frames > 0).sum(axis=1).max())
        est_min = max(min_speakers or 1, concurrent)
        by_window: dict = {}
        for idx, (w, _k) in enumerate(items):
            by_window.setdefault(w, []).append(idx)
        cannot_link = [
            (a, b)
            for idxs in by_window.values()
            for ai, a in enumerate(idxs)
            for b in idxs[ai + 1 :]
        ]
        labels = self._cluster(
            embeds,
            num_clusters=num_speakers,
            min_clusters=est_min,
            max_clusters=max_speakers,
            cannot_link=cannot_link,
        )
        n_global = int(labels.max()) + 1 if len(labels) else 0

        # aggregate window-local activity under global labels on a shared
        # frame grid; overlapping windows average, ≥0.5 → active
        total_frames = int(np.ceil(len(audio) / SAMPLE_RATE / frame_dur)) + 1
        score = np.zeros((n_global, total_frames), np.float64)
        cover = np.zeros(total_frames, np.float64)
        for w in range(n_win):
            f0 = int(round(starts[w] / frame_dur))
            hi = min(f0 + n_frames, total_frames)
            cover[f0:hi] += 1.0
        for (w, k), g in zip(items, labels):
            f0 = int(round(starts[w] / frame_dur))
            hi = min(f0 + n_frames, total_frames)
            score[g, f0:hi] += act[w, : hi - f0, k]
        with np.errstate(invalid="ignore", divide="ignore"):
            avg = np.where(cover > 0, score / np.maximum(cover, 1e-9), 0.0)
        binary = avg >= 0.5  # [G, T]

        turns = []
        for g in range(n_global):
            on = np.flatnonzero(binary[g])
            if len(on) == 0:
                continue
            # contiguous runs → turns
            splits = np.flatnonzero(np.diff(on) > 1)
            run_starts = np.concatenate([[0], splits + 1])
            run_ends = np.concatenate([splits, [len(on) - 1]])
            for rs, re_ in zip(run_starts, run_ends):
                turns.append((on[rs] * frame_dur, (on[re_] + 1) * frame_dur, f"SPEAKER_{g:02d}"))
        turns.sort()
        return turns, labels, embeds

    # VAD path: speech regions → sliding windows → batched embeddings

    def _vad_diarize(self, audio, num_speakers, min_speakers, max_speakers):
        speech = self.vad_model({"waveform": audio, "sample_rate": SAMPLE_RATE})

        win = int(WINDOW_S * SAMPLE_RATE)
        hop = int(HOP_S * SAMPLE_RATE)
        windows = []  # (start_s, end_s, samples)
        for seg in speech:
            s = int(seg.start * SAMPLE_RATE)
            e = int(seg.end * SAMPLE_RATE)
            pos = s
            while pos < e:
                # trim at the region boundary: windows padded out of trailing
                # silence become embedding outliers that hijack a cluster
                chunk = audio[pos : min(pos + win, e)]
                if len(chunk) < win // 4:
                    break
                if len(chunk) < win:
                    # tile, don't zero-pad: silence would dominate the
                    # embedding and group short windows by length, not voice
                    chunk = np.pad(chunk, (0, win - len(chunk)), mode="wrap")
                windows.append((pos / SAMPLE_RATE, min(e, pos + win) / SAMPLE_RATE, chunk))
                pos += hop

        if not windows:
            return [], np.zeros(0, np.int32), np.zeros((0, 1), np.float32)

        embeds = self.embedding.embed(np.stack([w[2] for w in windows]))
        labels = self._cluster(
            embeds,
            num_clusters=num_speakers,
            min_clusters=min_speakers or 1,
            max_clusters=max_speakers,
        )

        turns = []
        for (start, end, _), lab in zip(windows, labels):
            name = f"SPEAKER_{lab:02d}"
            if turns and turns[-1][2] == name and start <= turns[-1][1] + HOP_S:
                turns[-1][1] = max(turns[-1][1], end)
            else:
                turns.append([start, end, name])
        return [tuple(t) for t in turns], labels, embeds


def assign_word_speakers(
    diarize_df,
    transcript_result: dict,
    speaker_embeddings: Optional[dict] = None,
    fill_nearest: bool = False,
) -> dict:
    """Attach ``speaker`` to segments and words by maximum summed time
    intersection with the diarization turns (reference diarize.py:86-139).
    ``diarize_df`` is a ``TurnTable`` or a DataFrame with ``start``, ``end``
    and ``speaker`` columns."""
    if len(diarize_df) == 0:
        return transcript_result
    starts = np.asarray(diarize_df["start"], np.float64)
    ends = np.asarray(diarize_df["end"], np.float64)
    speakers = np.asarray(diarize_df["speaker"])

    def best_speaker(t0: float, t1: float) -> Optional[str]:
        intersection = np.minimum(ends, t1) - np.maximum(starts, t0)
        if not fill_nearest:
            mask = intersection > 0
            if not mask.any():
                return None
            inter, spk = intersection[mask], speakers[mask]
        else:
            inter, spk = intersection, speakers
        totals = {}
        for s, v in zip(spk, inter):
            totals[s] = totals.get(s, 0.0) + float(v)
        return max(totals.items(), key=lambda kv: kv[1])[0]

    for seg in transcript_result["segments"]:
        speaker = best_speaker(seg["start"], seg["end"])
        if speaker is not None:
            seg["speaker"] = speaker
        for word in seg.get("words", []):
            if "start" in word:
                speaker = best_speaker(word["start"], word["end"])
                if speaker is not None:
                    word["speaker"] = speaker

    if speaker_embeddings is not None:
        transcript_result["speaker_embeddings"] = speaker_embeddings
    return transcript_result


class Segment:
    """Tiny start/end/speaker struct (reference diarize.py:142-146)."""

    def __init__(self, start, end, speaker: Optional[str] = None):
        self.start = start
        self.end = end
        self.speaker = speaker


__all__ = [
    "DiarizationPipeline",
    "Segment",
    "SpeakerSegmenter",
    "SpectralEmbedding",
    "TurnTable",
    "agglomerative_cluster",
    "assign_word_speakers",
]

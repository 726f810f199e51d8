"""The front end, written again from its published semantics: the energy
VAD's speech probabilities, the Silero-style hysteresis segmenter, WhisperX's
merge of speech segments into windows of at most 30 s, and Whisper's log-mel
spectrogram (here through ``torch.stft``).

The VAD and the merge run on the host in numpy and Python; the log-mel runs
in float32 on the tensors' device, with TF32 off (the caller sets it).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
N_SAMPLES = 30 * SAMPLE_RATE
VAD_WINDOW = 512
ENERGY_FLOOR = -7.0


def energy_probs(audio: np.ndarray) -> np.ndarray:
    """Per-512-sample-window speech probability: log10 energy of the
    first-difference pre-emphasised window, squashed around the midpoint of
    its 10th and 95th percentiles, zero under an absolute floor."""
    audio = np.asarray(audio, np.float32).reshape(-1)
    n = len(audio)
    t = -(-n // VAD_WINDOW)
    frames = np.pad(audio, (0, t * VAD_WINDOW - n)).reshape(t, VAD_WINDOW)
    emph = np.diff(frames, axis=1, prepend=frames[:, :1])
    energy = np.log10(np.mean(emph**2, axis=1) + 1e-10)
    lo, hi = np.percentile(energy, 10), np.percentile(energy, 95)
    if hi - lo < 1e-3:
        return np.zeros(t, np.float32)
    mid = 0.5 * (lo + hi)
    scale = 8.0 / max(hi - lo, 1e-3)
    probs = 0.5 * (1.0 + np.tanh(0.5 * scale * (energy - mid)))
    return np.where(energy < ENERGY_FLOOR, 0.0, probs).astype(np.float32)


def speech_segments(probs: np.ndarray, n_samples: int, *, threshold: float = 0.5,
                    max_speech_s: float = 30.0) -> List[Tuple[float, float]]:
    """Silero's ``get_speech_timestamps`` hysteresis over window
    probabilities: (start, end) in seconds."""
    sr = SAMPLE_RATE
    min_speech = sr * 250 / 1000
    pad = int(sr * 30 / 1000)
    max_speech = sr * max_speech_s - VAD_WINDOW - 2 * pad
    min_silence = sr * 100 / 1000
    min_silence_at_max = sr * 98 / 1000
    neg = max(threshold - 0.15, 0.01)
    triggered = False
    speeches: List[dict] = []
    cur: dict = {}
    temp_end = prev_end = next_start = 0
    for i, p in enumerate(np.asarray(probs).reshape(-1)):
        pos = VAD_WINDOW * i
        if p >= threshold and temp_end:
            temp_end = 0
            if next_start < prev_end:
                next_start = pos
        if p >= threshold and not triggered:
            triggered = True
            cur["start"] = pos
            continue
        if triggered and pos - cur["start"] > max_speech:
            if prev_end:
                cur["end"] = prev_end
                speeches.append(cur)
                cur = {}
                if next_start < prev_end:
                    triggered = False
                else:
                    cur["start"] = next_start
                prev_end = next_start = temp_end = 0
            else:
                cur["end"] = pos
                speeches.append(cur)
                cur = {}
                prev_end = next_start = temp_end = 0
                triggered = False
                continue
        if p < neg and triggered:
            if not temp_end:
                temp_end = pos
            if pos - temp_end > min_silence_at_max:
                prev_end = temp_end
            if pos - temp_end < min_silence:
                continue
            cur["end"] = temp_end
            if cur["end"] - cur["start"] > min_speech:
                speeches.append(cur)
            cur = {}
            prev_end = next_start = temp_end = 0
            triggered = False
    if cur and n_samples - cur["start"] > min_speech:
        cur["end"] = n_samples
        speeches.append(cur)
    for i, sp in enumerate(speeches):
        if i == 0:
            sp["start"] = int(max(0, sp["start"] - pad))
        if i != len(speeches) - 1:
            silence = speeches[i + 1]["start"] - sp["end"]
            if silence < 2 * pad:
                sp["end"] += silence // 2
                speeches[i + 1]["start"] = int(max(0, speeches[i + 1]["start"] - silence // 2))
            else:
                sp["end"] = int(min(n_samples, sp["end"] + pad))
                speeches[i + 1]["start"] = int(max(0, speeches[i + 1]["start"] - pad))
        else:
            sp["end"] = int(min(n_samples, sp["end"] + pad))
    return [(s["start"] / sr, s["end"] / sr) for s in speeches]


def merge(segments: List[Tuple[float, float]], chunk_s: float = 30.0) -> List[Tuple[float, float]]:
    """WhisperX's greedy packing: a window closes when the next segment
    would end more than ``chunk_s`` after the window's start."""
    if not segments:
        return []
    out = []
    start, end = segments[0][0], 0.0
    for s, e in segments:
        if e - start > chunk_s and end - start > 0:
            out.append((start, end))
            start = s
        end = e
    out.append((start, end))
    return out


def chunks_of(audio: np.ndarray) -> List[Tuple[float, float]]:
    """The ≤ 30 s windows of a waveform, as the configuration's front end
    cuts them (energy VAD, onset 0.5, then the merge)."""
    segs = speech_segments(energy_probs(audio), len(audio))
    return merge(segs)


def window_rows(audio: np.ndarray, chunks: List[Tuple[float, float]]) -> np.ndarray:
    """Each window's samples at the start of a zero 30 s row."""
    rows = np.zeros((len(chunks), N_SAMPLES), np.float32)
    for r, (s, e) in enumerate(chunks):
        a = int(s * SAMPLE_RATE)
        b = min(int(e * SAMPLE_RATE), len(audio))
        n = min(max(b - a, 0), N_SAMPLES)
        rows[r, :n] = audio[a:a + n]
    return rows


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    log = 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    lin = m * (200.0 / 3)
    log = 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0))
    return np.where(m >= 15.0, log, lin)


def mel_filters(n_mels: int) -> np.ndarray:
    """librosa's Slaney-normalised mel filterbank for 16 kHz, n_fft 400."""
    freqs = np.linspace(0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2), n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (hz[2:n_mels + 2] - hz[:n_mels]))[:, None]
    return w.astype(np.float32)


def log_mel(rows: torch.Tensor, n_mels: int) -> torch.Tensor:
    """[N, 480000] f32 → [N, 3000, n_mels]: Whisper's log-mel (centred
    reflect-padded STFT, last frame dropped, log10 floored at max − 8,
    then (x + 4) / 4)."""
    window = torch.hann_window(N_FFT, device=rows.device)
    spec = torch.stft(rows, N_FFT, HOP, window=window, center=True, pad_mode="reflect",
                      return_complex=True)[..., :-1]
    power = spec.abs() ** 2  # [N, F, T]
    filt = torch.from_numpy(mel_filters(n_mels)).to(rows.device)
    mel = torch.einsum("mf,nft->ntm", filt, power)
    logm = torch.log10(torch.clamp(mel, min=1e-10))
    logm = torch.maximum(logm, logm.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (logm + 4.0) / 4.0


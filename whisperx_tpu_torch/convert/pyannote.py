"""PyanNet (pyannote segmentation) conversion → the checkpoint layout the
port reads (the JAX package's).

Counterpart of ``whisperx_tpu/convert/pyannote.py``: a pyannote.audio
PyanNet state dict (SincNet front end, BLSTM, linear stack, classifier)
onto ``models/pyannote/model.py``. SincNet's learned band edges
(``low_hz_``, ``band_hz_``) are materialized into ordinary convolution
kernels here, so the runtime model has plain convolutions only.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from whisperx_tpu_torch.convert.checkpoint import save_checkpoint
from whisperx_tpu_torch.models.pyannote.model import PyanNetConfig


def materialize_sinc_filters(
    low_hz: np.ndarray,
    band_hz: np.ndarray,
    kernel_size: int = 251,
    sample_rate: int = 16000,
    min_low_hz: float = 50.0,
    min_band_hz: float = 50.0,
) -> np.ndarray:
    """SincNet's parametric band-pass filters → conv kernels [W, 1, F]:
    Hamming-windowed differences of sincs between the learned band edges
    (Ravanelli & Bengio)."""
    low = min_low_hz + np.abs(low_hz.reshape(-1))
    high = np.clip(low + min_band_hz + np.abs(band_hz.reshape(-1)), min_low_hz, sample_rate / 2)
    n_filters = len(low)

    n = (kernel_size - 1) / 2.0
    t = (np.arange(-n, n + 1)) / sample_rate  # [W]
    window = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(kernel_size) / kernel_size)

    filters = np.zeros((kernel_size, 1, n_filters), np.float32)
    for i in range(n_filters):
        with np.errstate(divide="ignore", invalid="ignore"):
            hi = 2 * high[i] * np.sinc(2 * high[i] * t)
            lo = 2 * low[i] * np.sinc(2 * low[i] * t)
        band = (hi - lo) * window
        band = band / (2 * (high[i] - low[i]) + 1e-9)
        filters[:, 0, i] = band.astype(np.float32)
    return filters


def convert_pyannote_segmentation(src: str, out: str, name: Optional[str] = None) -> None:
    """Convert a pyannote segmentation checkpoint (``pytorch_model.bin``, a
    pickle holding a PyanNet state dict, possibly under ``state_dict`` and
    a ``model.`` prefix: load only files you trust)."""
    import torch

    path = src if src.endswith(".bin") else os.path.join(src, "pytorch_model.bin")
    raw = torch.load(path, map_location="cpu", weights_only=False)
    sd_t = raw.get("state_dict", raw)
    sd: Dict[str, np.ndarray] = {
        k.removeprefix("model."): v.numpy() for k, v in sd_t.items() if hasattr(v, "numpy")
    }

    def ln(prefix):
        return {"g": sd[f"{prefix}.weight"], "b": sd[f"{prefix}.bias"]}

    # SincNet: the waveform's instance norm (affine, one channel) runs
    # before the sinc conv; an identity affine where a variant lacks it
    wav_norm = (
        ln("sincnet.wav_norm1d")
        if "sincnet.wav_norm1d.weight" in sd
        else {"g": np.ones(1, np.float32), "b": np.zeros(1, np.float32)}
    )
    convs = []
    sinc_w = materialize_sinc_filters(sd["sincnet.conv1d.0.low_hz_"], sd["sincnet.conv1d.0.band_hz_"])
    convs.append({"w": sinc_w, "norm": ln("sincnet.norm1d.0")})
    for i in (1, 2):
        w = sd[f"sincnet.conv1d.{i}.weight"]  # [O, I, W]
        convs.append(
            {"w": np.ascontiguousarray(w.transpose(2, 1, 0)), "norm": ln(f"sincnet.norm1d.{i}")}
        )

    # BLSTM: each layer's two directions, biases summed
    lstms = []
    li = 0
    while f"lstm.weight_ih_l{li}" in sd:
        layer = {}
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            layer[direction] = {
                "wx": np.ascontiguousarray(sd[f"lstm.weight_ih_l{li}{suffix}"].T),
                "wh": np.ascontiguousarray(sd[f"lstm.weight_hh_l{li}{suffix}"].T),
                "b": (
                    sd.get(f"lstm.bias_ih_l{li}{suffix}", 0)
                    + sd.get(f"lstm.bias_hh_l{li}{suffix}", 0)
                ).astype(np.float32),
            }
        lstms.append(layer)
        li += 1

    linears = []
    ji = 0
    while f"linear.{ji}.weight" in sd:
        linears.append(
            {"w": np.ascontiguousarray(sd[f"linear.{ji}.weight"].T), "b": sd[f"linear.{ji}.bias"]}
        )
        ji += 1
    classifier = {
        "w": np.ascontiguousarray(sd["classifier.weight"].T),
        "b": sd["classifier.bias"],
    }

    cfg = PyanNetConfig(
        sincnet_filters=tuple(c["w"].shape[2] for c in convs),
        sincnet_kernels=tuple(c["w"].shape[0] for c in convs),
        lstm_hidden=lstms[0]["fwd"]["wh"].shape[0] if lstms else 128,
        lstm_layers=len(lstms),
        linear_dims=tuple(lin["w"].shape[1] for lin in linears),
        num_classes=classifier["w"].shape[1],
    )

    params = {
        "wav_norm": wav_norm,
        "sincnet": convs,
        "lstm": lstms,
        "linear": linears,
        "classifier": classifier,
    }
    save_checkpoint(
        out,
        params,
        {
            "family": "pyannote_segmentation",
            "name": name or os.path.basename(str(src).rstrip("/")),
            "config": {
                **cfg.__dict__,
                "sincnet_filters": list(cfg.sincnet_filters),
                "sincnet_kernels": list(cfg.sincnet_kernels),
                "linear_dims": list(cfg.linear_dims),
            },
        },
    )

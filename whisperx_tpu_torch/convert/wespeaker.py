"""wespeaker ResNet speaker-embedding conversion → the checkpoint layout
the port reads (the JAX package's).

Counterpart of ``whisperx_tpu/convert/wespeaker.py``: a wespeaker
``ResNet34``-family state dict (the embedding model inside
pyannote/speaker-diarization-3.1) onto ``models/resnet_speaker/model.py``:
conv weights [O, I, kH, kW] → [kH, kW, I, O], batch-norm running
statistics as they are, the embedding linear transposed.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np

from whisperx_tpu_torch.convert.checkpoint import save_checkpoint


def _conv(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))  # OIHW → HWIO


def _bn(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {
        "g": sd[f"{prefix}.weight"],
        "b": sd[f"{prefix}.bias"],
        "mean": sd[f"{prefix}.running_mean"],
        "var": sd[f"{prefix}.running_var"],
    }


def convert_wespeaker_resnet(src: str, out: str, name: Optional[str] = None) -> None:
    """Convert a wespeaker ResNet checkpoint (a ``.pt``/``.bin`` pickle of a
    state dict or a module, or a directory holding one: load only files you
    trust)."""
    import torch

    path = src
    if os.path.isdir(src):
        for cand in ("pytorch_model.bin", "wespeaker.pt", "model.pt"):
            p = os.path.join(src, cand)
            if os.path.exists(p):
                path = p
                break
    raw = torch.load(path, map_location="cpu", weights_only=False)
    sd_t = raw.get("state_dict", raw) if isinstance(raw, dict) else raw.state_dict()
    sd = {
        re.sub(r"^(model|speaker_encoder)\.", "", k): v.numpy()
        for k, v in sd_t.items()
        if hasattr(v, "numpy")
    }

    stem_key = "front.conv1" if "front.conv1.weight" in sd else "conv1"
    params = {
        "stem": {"w": _conv(sd[f"{stem_key}.weight"]), "bn": _bn(sd, stem_key.replace("conv1", "bn1"))},
        "stages": [],
    }

    channels, blocks = [], []
    for stage in range(1, 5):
        layer = f"layer{stage}"
        stage_blocks = []
        b = 0
        while f"{layer}.{b}.conv1.weight" in sd:
            block = {
                "conv1": _conv(sd[f"{layer}.{b}.conv1.weight"]),
                "bn1": _bn(sd, f"{layer}.{b}.bn1"),
                "conv2": _conv(sd[f"{layer}.{b}.conv2.weight"]),
                "bn2": _bn(sd, f"{layer}.{b}.bn2"),
            }
            if f"{layer}.{b}.downsample.0.weight" in sd:
                block["down"] = {
                    "w": _conv(sd[f"{layer}.{b}.downsample.0.weight"]),
                    "bn": _bn(sd, f"{layer}.{b}.downsample.1"),
                }
            stage_blocks.append(block)
            b += 1
        if not stage_blocks:
            break
        params["stages"].append(stage_blocks)
        channels.append(stage_blocks[0]["conv1"].shape[3])
        blocks.append(len(stage_blocks))

    # the embedding head: wespeaker names it seg_1 / embed_a (stats pool → linear)
    head_key = next(
        (k for k in ("embed_a", "seg_1", "fc", "embedding") if f"{k}.weight" in sd), None
    )
    if head_key is None:
        raise KeyError("no embedding head found in wespeaker state_dict")
    params["proj"] = {
        "w": np.ascontiguousarray(sd[f"{head_key}.weight"].T),
        "b": sd.get(f"{head_key}.bias", np.zeros(sd[f"{head_key}.weight"].shape[0], np.float32)),
    }

    save_checkpoint(
        out,
        params,
        {
            "family": "resnet_speaker",
            "name": name or os.path.basename(str(src).rstrip("/")),
            "config": {
                "channels": channels,
                "blocks": blocks,
                "n_mels": 80,
                "embed_dim": int(params["proj"]["w"].shape[1]),
            },
        },
    )

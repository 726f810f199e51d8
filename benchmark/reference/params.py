"""Seeded Whisper weights in the JAX package's flat layout.

The names and shapes are those of the published architecture, written out
here from the configuration's dimensions; the distributions are the ones the
port documents for random weights (linear N(0,1)/sqrt(d_in), conv
N(0,1)/sqrt(3 d_in), sinusoidal encoder positions, token embedding
N(0, 0.02^2), decoder positions N(0, 0.01^2)), except that every bias and
layer-norm shift is N(0, 0.1^2) and every layer-norm gain 1 + N(0, 0.1^2)
rather than 0 and 1, so that a bias add or a layer norm's affine that the
program left out would change what it serves.

The draws are made on the given device with one ``torch.Generator`` seeded
from the run's seed, one ``randn`` call per group of equally shaped tensors,
in bfloat16, the type the program serves them in (so the set-up holds no
more than the weights on the device). The reference widens the same values
to float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def dims_of(config: dict) -> dict:
    """The ten Whisper dimensions of a configuration file."""
    keys = ("n_mels", "n_audio_ctx", "n_audio_state", "n_audio_head", "n_audio_layer",
            "n_vocab", "n_text_ctx", "n_text_state", "n_text_head", "n_text_layer")
    return {k: int(config[k]) for k in keys}


def _block(prefix: str, d: int, cross: bool) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of one residual block: kind is ``linear``,
    ``bias`` (biases and layer-norm shifts) or ``gain`` (layer-norm gains)."""
    out = []
    attns = ("attn", "cross_attn") if cross else ("attn",)
    for a in attns:
        for lin in ("query", "key", "value", "out"):
            out.append((f"{prefix}/{a}/{lin}/w", (d, d), "linear"))
            if lin != "key":
                out.append((f"{prefix}/{a}/{lin}/b", (d,), "bias"))
        out.append((f"{prefix}/{a}_ln/g", (d,), "gain"))
        out.append((f"{prefix}/{a}_ln/b", (d,), "bias"))
    out += [
        (f"{prefix}/mlp1/w", (d, 4 * d), "linear"),
        (f"{prefix}/mlp1/b", (4 * d,), "bias"),
        (f"{prefix}/mlp2/w", (4 * d, d), "linear"),
        (f"{prefix}/mlp2/b", (d,), "bias"),
        (f"{prefix}/mlp_ln/g", (d,), "gain"),
        (f"{prefix}/mlp_ln/b", (d,), "bias"),
    ]
    return out


def layout(dims: dict) -> List[Tuple[str, tuple, str]]:
    """Every parameter's (name, shape, kind), encoder first."""
    da, dt = dims["n_audio_state"], dims["n_text_state"]
    out = [
        ("encoder/conv1/w", (3, dims["n_mels"], da), "conv"),
        ("encoder/conv1/b", (da,), "bias"),
        ("encoder/conv2/w", (3, da, da), "conv"),
        ("encoder/conv2/b", (da,), "bias"),
        ("encoder/pos_emb", (dims["n_audio_ctx"], da), "sinusoids"),
    ]
    for i in range(dims["n_audio_layer"]):
        out += _block(f"encoder/blocks/{i}", da, cross=False)
    out += [("encoder/ln_post/g", (da,), "gain"), ("encoder/ln_post/b", (da,), "bias")]
    out += [
        ("decoder/tok_emb", (dims["n_vocab"], dt), "tok_emb"),
        ("decoder/pos_emb", (dims["n_text_ctx"], dt), "pos_emb"),
    ]
    for i in range(dims["n_text_layer"]):
        out += _block(f"decoder/blocks/{i}", dt, cross=True)
    out += [("decoder/ln/g", (dt,), "gain"), ("decoder/ln/b", (dt,), "bias")]
    return out


def sinusoids(length: int, channels: int) -> np.ndarray:
    """The encoder's fixed position embedding (the published formula)."""
    inc = math.log(10000) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def _scale(kind: str, shape: tuple) -> float:
    if kind == "linear":
        return 1.0 / math.sqrt(shape[0])
    if kind == "conv":
        return 1.0 / math.sqrt(3 * shape[1])
    return {"tok_emb": 0.02, "pos_emb": 0.01, "bias": 0.1, "gain": 0.1}[kind]


@torch.no_grad()
def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's weights from ``seed``: bfloat16 tensors on
    ``device``, keyed by the JAX layout's names."""
    dims = dims_of(config)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    entries = layout(dims)
    out: Dict[str, torch.Tensor] = {}
    groups: Dict[Tuple[tuple, str], List[str]] = {}
    for name, shape, kind in entries:
        if kind == "sinusoids":
            out[name] = torch.from_numpy(sinusoids(*shape)).to(device, torch.bfloat16)
        else:
            groups.setdefault((shape, kind), []).append(name)
    for (shape, kind), names in groups.items():
        draw = torch.randn((len(names), *shape), generator=gen, device=device, dtype=torch.bfloat16)
        draw.mul_(_scale(kind, shape))
        if kind == "gain":
            draw.add_(1.0)
        for i, name in enumerate(names):
            out[name] = draw[i]
    return {name: out[name] for name, _, _ in entries}

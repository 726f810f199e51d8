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

A configuration with an ``align`` section also has seeded wav2vec2-CTC
weights (``make_align_weights``): the names and shapes of the layout the
port's ``convert/checkpoint.py::wav2vec2_from_numpy`` reads, written out
from the section's published ``hf_config``, with the same conventions
(linear N(0,1)/sqrt(d_in), convolutions N(0,1)/sqrt(k d_in), biases and
norm shifts N(0, 0.1^2), gains 1 + N(0, 0.1^2)), drawn in float32, the type
the aligner runs in, on a generator of their own whose seed is derived from
the run's, so that the Whisper draws stay as they are.
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


def align_dims(config: dict) -> dict:
    """The wav2vec2 dimensions of a configuration's ``align`` section, under
    the port's checkpoint names, read from its published ``hf_config``;
    ``conv_bias`` says whether each feature convolution has a bias."""
    hf = config["align"]["hf_config"]
    return {
        "vocab_size": int(hf["vocab_size"]),
        "hidden_size": int(hf["hidden_size"]),
        "num_layers": int(hf["num_hidden_layers"]),
        "num_heads": int(hf["num_attention_heads"]),
        "intermediate_size": int(hf["intermediate_size"]),
        "conv_dim": [int(x) for x in hf["conv_dim"]],
        "conv_kernel": [int(x) for x in hf["conv_kernel"]],
        "conv_stride": [int(x) for x in hf["conv_stride"]],
        "num_conv_pos_embeddings": int(hf["num_conv_pos_embeddings"]),
        "num_conv_pos_embedding_groups": int(hf["num_conv_pos_embedding_groups"]),
        "do_stable_layer_norm": bool(hf["do_stable_layer_norm"]),
        "feat_extract_norm": str(hf["feat_extract_norm"]),
        "conv_bias": bool(hf.get("conv_bias", False)),
    }


def _norm(prefix: str, d: int) -> List[Tuple[str, tuple, str]]:
    return [(f"{prefix}/g", (d,), "gain"), (f"{prefix}/b", (d,), "bias")]


def _linear(prefix: str, d_in: int, d_out: int) -> List[Tuple[str, tuple, str]]:
    return [(f"{prefix}/w", (d_in, d_out), "linear"), (f"{prefix}/b", (d_out,), "bias")]


def align_layout(a: dict) -> List[Tuple[str, tuple, str]]:
    """Every wav2vec2 parameter's (name, shape, kind) from ``align_dims``:
    the feature convolutions (``w`` [k, I, O]) with their norms (each
    layer's ``ln`` for a "layer" extractor, the first layer's per-channel
    ``gn`` for a "group" one), the feature projection, the grouped
    positional convolution, the encoder's norm, the blocks and the CTC
    head."""
    out: List[Tuple[str, tuple, str]] = []
    d_in = 1
    for i, (c, k) in enumerate(zip(a["conv_dim"], a["conv_kernel"])):
        p = f"feature_extractor/{i}"
        out.append((f"{p}/w", (k, d_in, c), "conv"))
        if a["conv_bias"]:
            out.append((f"{p}/b", (c,), "bias"))
        if a["feat_extract_norm"] == "layer":
            out += _norm(f"{p}/ln", c)
        elif i == 0:
            out += _norm(f"{p}/gn", c)
        d_in = c
    d = a["hidden_size"]
    out += _norm("feature_projection/ln", d_in) + _linear("feature_projection/proj", d_in, d)
    groups = a["num_conv_pos_embedding_groups"]
    out += [("pos_conv/w", (a["num_conv_pos_embeddings"], d // groups, d), "conv"), ("pos_conv/b", (d,), "bias")]
    out += _norm("encoder_ln", d)
    for i in range(a["num_layers"]):
        p = f"layers/{i}"
        for lin in ("query", "key", "value", "out"):
            out += _linear(f"{p}/attn/{lin}", d, d)
        out += _norm(f"{p}/attn_ln", d)
        out += _linear(f"{p}/mlp1", d, a["intermediate_size"]) + _linear(f"{p}/mlp2", a["intermediate_size"], d)
        out += _norm(f"{p}/mlp_ln", d)
    return out + _linear("lm_head", d, a["vocab_size"])


def align_seed(seed: int) -> int:
    """The aligner's generator seed, derived from the run's: a stream of its
    own, so that the Whisper draws are the same with or without it."""
    state = np.random.SeedSequence([int(seed), 0xA119]).generate_state(2, np.uint32)
    return (int(state[0]) << 32 | int(state[1])) % 2**63


@torch.no_grad()
def make_align_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's aligner weights from ``seed``: float32 tensors on
    ``device``, keyed by the port's checkpoint names."""
    entries = align_layout(align_dims(config))
    gen = torch.Generator(device=device).manual_seed(align_seed(seed))
    groups: Dict[Tuple[tuple, str], List[str]] = {}
    for name, shape, kind in entries:
        groups.setdefault((shape, kind), []).append(name)
    out: Dict[str, torch.Tensor] = {}
    for (shape, kind), names in groups.items():
        draw = torch.randn((len(names), *shape), generator=gen, device=device, dtype=torch.float32)
        if kind == "linear":
            draw.mul_(1.0 / math.sqrt(shape[0]))
        elif kind == "conv":
            draw.mul_(1.0 / math.sqrt(shape[0] * shape[1]))
        else:
            draw.mul_(0.1)
        if kind == "gain":
            draw.add_(1.0)
        for i, name in enumerate(names):
            out[name] = draw[i]
    return {name: out[name] for name, _, _ in entries}

"""wav2vec2 alignment-model conversion: HF / torchaudio → the checkpoint
layout the port reads (the JAX package's).

Counterpart of ``whisperx_tpu/convert/wav2vec2_hf.py``, key for key: linear
weights to ``[in, out]``, convolutions to ``[W, I, O]``, the positional
convolution's weight norm folded in (``g · v / ‖v‖``).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

import numpy as np

from whisperx_tpu_torch.convert.checkpoint import save_checkpoint
from whisperx_tpu_torch.convert.safetensors import load_state_dict
from whisperx_tpu_torch.models.wav2vec2.model import Wav2Vec2Config


def _config_from_hf(cfg: dict) -> Wav2Vec2Config:
    return Wav2Vec2Config(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        conv_dim=tuple(cfg["conv_dim"]),
        conv_kernel=tuple(cfg["conv_kernel"]),
        conv_stride=tuple(cfg["conv_stride"]),
        num_conv_pos_embeddings=cfg["num_conv_pos_embeddings"],
        num_conv_pos_embedding_groups=cfg["num_conv_pos_embedding_groups"],
        do_stable_layer_norm=cfg.get("do_stable_layer_norm", False),
        feat_extract_norm=cfg.get("feat_extract_norm", "group"),
    )


def convert_hf_wav2vec2(src: str, out: str, name: Optional[str] = None) -> None:
    """Convert an HF ``Wav2Vec2ForCTC`` checkpoint directory."""
    with open(os.path.join(src, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg = _config_from_hf(hf_cfg)
    sd = {k.replace("wav2vec2.", ""): np.asarray(v) for k, v in load_state_dict(src).items()}

    def lin(prefix):
        return {"w": np.ascontiguousarray(sd[f"{prefix}.weight"].T), "b": sd[f"{prefix}.bias"]}

    def ln(prefix):
        return {"g": sd[f"{prefix}.weight"], "b": sd[f"{prefix}.bias"]}

    convs = []
    for i in range(len(cfg.conv_dim)):
        # torch conv [O, I, W] → ours [W, I, O]
        conv = {
            "w": np.ascontiguousarray(
                sd[f"feature_extractor.conv_layers.{i}.conv.weight"].transpose(2, 1, 0)
            )
        }
        # conv_bias=True on the large/lv60/xlsr family
        bias = sd.get(f"feature_extractor.conv_layers.{i}.conv.bias")
        if bias is not None:
            conv["b"] = bias
        if cfg.feat_extract_norm == "layer":
            conv["ln"] = ln(f"feature_extractor.conv_layers.{i}.layer_norm")
        elif i == 0:
            conv["gn"] = ln(f"feature_extractor.conv_layers.{i}.layer_norm")
        convs.append(conv)

    # the positional conv's weight norm, weight = g · v / ‖v‖, in the key
    # layout of the torch version that saved it: weight_g/weight_v, the
    # parametrizations' original0/original1, or a plain weight
    pc = "encoder.pos_conv_embed.conv"
    if f"{pc}.weight_g" in sd:
        g, v = sd[f"{pc}.weight_g"], sd[f"{pc}.weight_v"]
    elif f"{pc}.parametrizations.weight.original0" in sd:
        g = sd[f"{pc}.parametrizations.weight.original0"]
        v = sd[f"{pc}.parametrizations.weight.original1"]
    else:
        g = v = None
    if g is not None:
        norm = np.linalg.norm(v, axis=(0, 1), keepdims=True)
        pos_w = g * v / (norm + 1e-12)
    else:
        pos_w = sd[f"{pc}.weight"]
    # torch grouped conv [O, I/groups, W] → ours [W, I/groups, O]
    pos_w = np.ascontiguousarray(pos_w.transpose(2, 1, 0))

    layers = []
    for i in range(cfg.num_layers):
        p = f"encoder.layers.{i}"
        layers.append(
            {
                "attn": {
                    "query": lin(f"{p}.attention.q_proj"),
                    "key": lin(f"{p}.attention.k_proj"),
                    "value": lin(f"{p}.attention.v_proj"),
                    "out": lin(f"{p}.attention.out_proj"),
                },
                "attn_ln": ln(f"{p}.layer_norm"),
                "mlp1": lin(f"{p}.feed_forward.intermediate_dense"),
                "mlp2": lin(f"{p}.feed_forward.output_dense"),
                "mlp_ln": ln(f"{p}.final_layer_norm"),
            }
        )

    params = {
        "feature_extractor": convs,
        "feature_projection": {
            "ln": ln("feature_projection.layer_norm"),
            "proj": lin("feature_projection.projection"),
        },
        "pos_conv": {"w": pos_w, "b": sd["encoder.pos_conv_embed.conv.bias"]},
        "encoder_ln": ln("encoder.layer_norm"),
        "layers": layers,
        "lm_head": lin("lm_head"),
    }

    # the CTC vocabulary, for the aligner's dictionary
    vocab_path = os.path.join(src, "vocab.json")
    dictionary = {}
    if os.path.exists(vocab_path):
        with open(vocab_path, encoding="utf-8") as f:
            dictionary = json.load(f)

    save_checkpoint(
        out,
        params,
        {
            "family": "wav2vec2",
            "name": name or os.path.basename(str(src).rstrip("/")),
            "config": cfg.__dict__ | {
                "conv_dim": list(cfg.conv_dim),
                "conv_kernel": list(cfg.conv_kernel),
                "conv_stride": list(cfg.conv_stride),
            },
            "dictionary": dictionary,
        },
    )


def convert_torchaudio_wav2vec2(bundle_name: str, out: str) -> None:
    """Convert a torchaudio pipeline bundle (e.g. ``WAV2VEC2_ASR_BASE_960H``;
    ``torchaudio`` is needed here only, and may download the bundle's
    weights)."""
    import torch
    import torchaudio

    bundle = torchaudio.pipelines.__dict__[bundle_name]
    model = bundle.get_model()
    labels = bundle.get_labels()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}

    # torchaudio's names → the HF layout
    mapped = {}
    for k, v in sd.items():
        nk = (
            k.replace("encoder.feature_projection", "feature_projection")
            .replace("encoder.transformer.pos_conv_embed", "encoder.pos_conv_embed")
            .replace("encoder.transformer.layer_norm", "encoder.layer_norm")
            .replace("encoder.transformer.layers", "encoder.layers")
            .replace("aux", "lm_head")
        )
        mapped[nk] = v

    with tempfile.TemporaryDirectory() as tmp:
        # through the HF route, from a checkpoint written here; every
        # hyperparameter is derived from the state dict, so the large/lv60
        # bundles convert as the base family does
        hidden = mapped["feature_projection.projection.weight"].shape[0]
        n_layers = len({k.split(".")[2] for k in mapped if k.startswith("encoder.layers.")})
        n_convs = len(
            {k.split(".")[2] for k in mapped if k.startswith("feature_extractor.conv_layers.")}
        )
        # torchaudio conv weights are [O, I, W]
        conv_ws = [mapped[f"feature_extractor.conv_layers.{i}.conv.weight"] for i in range(n_convs)]
        # strides are architectural, not recoverable from weights; every
        # published wav2vec2 uses this schedule for 7 conv layers
        conv_stride = [5] + [2] * (len(conv_ws) - 1)
        # lv60/large: a layer norm on every conv layer and a pre-LN
        # transformer (group-norm models have only conv 0's norm)
        has_conv_ln = "feature_extractor.conv_layers.1.layer_norm.weight" in mapped
        pos_w_key = next(
            k
            for k in (
                "encoder.pos_conv_embed.conv.weight_v",
                "encoder.pos_conv_embed.conv.parametrizations.weight.original1",
                "encoder.pos_conv_embed.conv.weight",
            )
            if k in mapped
        )
        pos_w = mapped[pos_w_key]  # [O, I/groups, W]
        cfg = {
            "vocab_size": len(labels),
            "hidden_size": hidden,
            "num_hidden_layers": n_layers,
            # 64 per head across the published family (base 768/12, large 1024/16)
            "num_attention_heads": max(1, hidden // 64),
            "intermediate_size": mapped[
                "encoder.layers.0.feed_forward.intermediate_dense.weight"
            ].shape[0],
            "conv_dim": [w.shape[0] for w in conv_ws],
            "conv_kernel": [w.shape[2] for w in conv_ws],
            "conv_stride": conv_stride,
            "num_conv_pos_embeddings": pos_w.shape[2],
            "num_conv_pos_embedding_groups": hidden // pos_w.shape[1],
            "do_stable_layer_norm": has_conv_ln,
            "feat_extract_norm": "layer" if has_conv_ln else "group",
            "conv_bias": "feature_extractor.conv_layers.0.conv.bias" in mapped,
        }
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(cfg, f)
        with open(os.path.join(tmp, "vocab.json"), "w") as f:
            json.dump({c.lower(): i for i, c in enumerate(labels)}, f)
        torch.save(
            {k: torch.from_numpy(v) for k, v in mapped.items()},
            os.path.join(tmp, "pytorch_model.bin"),
        )
        convert_hf_wav2vec2(tmp, out, name=bundle_name)

"""Whisper weight conversion: HF / OpenAI checkpoints → the checkpoint
layout the port reads (the JAX package's: ``weights.npz`` + ``config.json``
+ ``vocab.tiktoken``).

Counterpart of ``whisperx_tpu/convert/whisper_hf.py``, key for key, dtype
for dtype: linear weights are transposed to ``[in, out]``, convolutions to
``[W, I, O]``, and every array keeps the source's type (an F16 checkpoint
converts to F16 arrays). Runs on the host, once, offline.

Sources:
  - HF ``WhisperForConditionalGeneration`` directories (``model.safetensors``
    or ``pytorch_model.bin`` + ``config.json`` + ``generation_config.json``)
  - OpenAI ``.pt`` checkpoints (``{"dims": ..., "model_state_dict": ...}``)
"""

from __future__ import annotations

import base64
import json
import os
import re
from typing import Optional

import numpy as np

from whisperx_tpu_torch.convert.checkpoint import save_checkpoint
from whisperx_tpu_torch.convert.safetensors import load_state_dict
from whisperx_tpu_torch.models.whisper.config import ModelDimensions


def _hf_dims(config: dict) -> ModelDimensions:
    return ModelDimensions(
        n_mels=config["num_mel_bins"],
        n_audio_ctx=config["max_source_positions"],
        n_audio_state=config["d_model"],
        n_audio_head=config["encoder_attention_heads"],
        n_audio_layer=config["encoder_layers"],
        n_vocab=config["vocab_size"],
        n_text_ctx=config["max_target_positions"],
        n_text_state=config["d_model"],
        n_text_head=config["decoder_attention_heads"],
        n_text_layer=config["decoder_layers"],
    )


def _lin(sd, prefix, bias=True):
    p = {"w": np.ascontiguousarray(sd[f"{prefix}.weight"].T)}
    if bias and f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"]
    return p


def _ln(sd, prefix):
    return {"g": sd[f"{prefix}.weight"], "b": sd[f"{prefix}.bias"]}


def _conv(sd, prefix):
    # torch conv1d weight [O, I, W] → ours [W, I, O]
    return {
        "w": np.ascontiguousarray(sd[f"{prefix}.weight"].transpose(2, 1, 0)),
        "b": sd[f"{prefix}.bias"],
    }


def convert_hf_whisper(src: str, out: str, name: Optional[str] = None) -> None:
    """Convert an HF Whisper checkpoint directory."""
    from whisperx_tpu_torch.models.whisper.model import sinusoids

    with open(os.path.join(src, "config.json")) as f:
        config = json.load(f)
    dims = _hf_dims(config)
    sd = {re.sub(r"^model\.", "", k): np.asarray(v) for k, v in load_state_dict(src).items()}

    def block(prefix, cross):
        p = {
            "attn": {
                "query": _lin(sd, f"{prefix}.self_attn.q_proj"),
                "key": _lin(sd, f"{prefix}.self_attn.k_proj", bias=False),
                "value": _lin(sd, f"{prefix}.self_attn.v_proj"),
                "out": _lin(sd, f"{prefix}.self_attn.out_proj"),
            },
            "attn_ln": _ln(sd, f"{prefix}.self_attn_layer_norm"),
            "mlp1": _lin(sd, f"{prefix}.fc1"),
            "mlp2": _lin(sd, f"{prefix}.fc2"),
            "mlp_ln": _ln(sd, f"{prefix}.final_layer_norm"),
        }
        if cross:
            p["cross_attn"] = {
                "query": _lin(sd, f"{prefix}.encoder_attn.q_proj"),
                "key": _lin(sd, f"{prefix}.encoder_attn.k_proj", bias=False),
                "value": _lin(sd, f"{prefix}.encoder_attn.v_proj"),
                "out": _lin(sd, f"{prefix}.encoder_attn.out_proj"),
            }
            p["cross_attn_ln"] = _ln(sd, f"{prefix}.encoder_attn_layer_norm")
        return p

    params = {
        "encoder": {
            "conv1": _conv(sd, "encoder.conv1"),
            "conv2": _conv(sd, "encoder.conv2"),
            "pos_emb": (
                sd["encoder.embed_positions.weight"]
                if "encoder.embed_positions.weight" in sd
                else sinusoids(dims.n_audio_ctx, dims.n_audio_state)
            ),
            "blocks": [
                block(f"encoder.layers.{i}", cross=False) for i in range(dims.n_audio_layer)
            ],
            "ln_post": _ln(sd, "encoder.layer_norm"),
        },
        "decoder": {
            "tok_emb": sd["decoder.embed_tokens.weight"],
            "pos_emb": sd["decoder.embed_positions.weight"],
            "blocks": [
                block(f"decoder.layers.{i}", cross=True) for i in range(dims.n_text_layer)
            ],
            "ln": _ln(sd, "decoder.layer_norm"),
        },
    }

    alignment_heads = None
    gen_path = os.path.join(src, "generation_config.json")
    if os.path.exists(gen_path):
        with open(gen_path) as f:
            alignment_heads = json.load(f).get("alignment_heads")

    save_checkpoint(
        out,
        params,
        {
            "family": "whisper",
            "name": name or os.path.basename(str(src).rstrip("/")),
            "dims": dims.__dict__,
            "alignment_heads": alignment_heads,
        },
    )
    _maybe_export_vocab(src, out)


def convert_openai_whisper(src_pt: str, out: str, name: Optional[str] = None) -> None:
    """Convert an OpenAI whisper ``.pt`` checkpoint (a pickle: load only
    files you trust)."""
    import torch

    ckpt = torch.load(src_pt, map_location="cpu", weights_only=False)
    dims = ModelDimensions(**ckpt["dims"])
    sd = {k: v.numpy() for k, v in ckpt["model_state_dict"].items()}

    def block(prefix, cross):
        p = {
            "attn": {
                "query": _lin(sd, f"{prefix}.attn.query"),
                "key": _lin(sd, f"{prefix}.attn.key", bias=False),
                "value": _lin(sd, f"{prefix}.attn.value"),
                "out": _lin(sd, f"{prefix}.attn.out"),
            },
            "attn_ln": _ln(sd, f"{prefix}.attn_ln"),
            "mlp1": _lin(sd, f"{prefix}.mlp.0"),
            "mlp2": _lin(sd, f"{prefix}.mlp.2"),
            "mlp_ln": _ln(sd, f"{prefix}.mlp_ln"),
        }
        if cross:
            p["cross_attn"] = {
                "query": _lin(sd, f"{prefix}.cross_attn.query"),
                "key": _lin(sd, f"{prefix}.cross_attn.key", bias=False),
                "value": _lin(sd, f"{prefix}.cross_attn.value"),
                "out": _lin(sd, f"{prefix}.cross_attn.out"),
            }
            p["cross_attn_ln"] = _ln(sd, f"{prefix}.cross_attn_ln")
        return p

    params = {
        "encoder": {
            "conv1": _conv(sd, "encoder.conv1"),
            "conv2": _conv(sd, "encoder.conv2"),
            "pos_emb": sd["encoder.positional_embedding"],
            "blocks": [
                block(f"encoder.blocks.{i}", cross=False) for i in range(dims.n_audio_layer)
            ],
            "ln_post": _ln(sd, "encoder.ln_post"),
        },
        "decoder": {
            "tok_emb": sd["decoder.token_embedding.weight"],
            "pos_emb": sd["decoder.positional_embedding"],
            "blocks": [
                block(f"decoder.blocks.{i}", cross=True) for i in range(dims.n_text_layer)
            ],
            "ln": _ln(sd, "decoder.ln"),
        },
    }

    save_checkpoint(
        out,
        params,
        {
            "family": "whisper",
            "name": name or os.path.basename(src_pt),
            "dims": dims.__dict__,
            "alignment_heads": None,
        },
    )


def _maybe_export_vocab(src: str, out: str) -> None:
    """Export the BPE ranks of ``vocab.json`` as ``vocab.tiktoken`` beside
    the weights (base64 of the token's bytes, then its rank), so the real
    tokenizer works offline. Needs ``merges.txt`` beside it, as an HF
    tokenizer directory has."""
    vocab_json = os.path.join(src, "vocab.json")
    merges_txt = os.path.join(src, "merges.txt")
    if not (os.path.exists(vocab_json) and os.path.exists(merges_txt)):
        return
    with open(vocab_json, encoding="utf-8") as f:
        vocab = json.load(f)

    # GPT-2's byte-level map: each byte is a printable character
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    decoder = {chr(c): b for b, c in zip(bs, cs)}

    lines = []
    for token, rank in sorted(vocab.items(), key=lambda kv: kv[1]):
        if token.startswith("<|") and token.endswith("|>"):
            continue  # special tokens are positional, not ranked
        raw = bytes(decoder[ch] for ch in token)
        lines.append(f"{base64.b64encode(raw).decode()} {rank}")
    with open(os.path.join(out, "vocab.tiktoken"), "w") as f:
        f.write("\n".join(lines) + "\n")

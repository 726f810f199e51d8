"""Whisper model family: config, modules, forward passes, loading."""

from __future__ import annotations

import os
import warnings
from typing import Union

import torch

from whisperx_tpu_torch.models.whisper.config import (
    MODEL_DIMS,
    ModelDimensions,
    get_dims,
    resolve_model_name,
)
from whisperx_tpu_torch.models.whisper.model import (
    KVCache,
    Whisper,
    decoder_forward,
    encoder_forward,
    init_weights,
    precompute_cross_kv,
)


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The torch device for ``device``; asking for CUDA without a usable GPU
    raises (the port never moves to the CPU unless asked)."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA GPU is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


def load_model(
    name_or_path: str,
    dtype: torch.dtype = torch.bfloat16,
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
) -> Whisper:
    """A Whisper from a converted checkpoint directory, or a known
    architecture with random weights drawn from a ``torch.Generator`` seeded
    with ``seed`` (hermetic mode)."""
    from whisperx_tpu_torch.convert.checkpoint import (
        is_checkpoint_dir,
        load_checkpoint,
    )

    dev = resolve_device(device)
    if is_checkpoint_dir(name_or_path):
        vocab = os.path.join(name_or_path, "vocab.tiktoken")
        if not os.path.exists(vocab):
            from whisperx_tpu_torch.decoding.tokenizer import (
                default_partial_vocab_path,
            )

            warnings.warn(
                f"Checkpoint {name_or_path!r} has no vocab.tiktoken — using "
                "the built-in PARTIAL vocabulary (~1.3k exact entries "
                "recovered from gold artifacts; rare tokens decode to �).",
                stacklevel=2,
            )
            vocab = default_partial_vocab_path()
        model, config = load_checkpoint(
            name_or_path, dtype, dev,
            vocab_path=vocab if os.path.exists(vocab) else None,
        )
        # the converter's name, else the directory's (as the JAX package)
        model.name = config.get("name", os.path.basename(name_or_path))
        if config.get("alignment_heads"):  # the published mask, when converted
            model.alignment_heads = [tuple(x) for x in config["alignment_heads"]]
        return model.eval()

    name = resolve_model_name(name_or_path)
    if not name.startswith("test-"):
        warnings.warn(
            f"No converted checkpoint found for {name_or_path!r}; "
            "initializing RANDOM weights (architecture-only mode).",
            stacklevel=2,
        )
    model = Whisper(get_dims(name), dtype=dtype, device=dev, name=name)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_weights(model, gen).eval()


__all__ = [
    "MODEL_DIMS",
    "ModelDimensions",
    "Whisper",
    "KVCache",
    "decoder_forward",
    "encoder_forward",
    "get_dims",
    "load_model",
    "precompute_cross_kv",
    "resolve_device",
    "resolve_model_name",
]

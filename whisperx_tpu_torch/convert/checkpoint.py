"""Reader for the checkpoint directories the JAX package writes, and the
weight bridge from its flat parameter names onto the port's modules.

A checkpoint directory holds (``whisperx_tpu/convert/checkpoint.py``):
  - ``weights.npz``   : flat ``{"a/b/0/w": array}`` mapping of the param tree
  - ``config.json``   : model family + dimensions + metadata
  - ``vocab.tiktoken``: optional BPE ranks file
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

_QUANT_MARKER = "__quantized_linear__"
_EMPTY_DICT = "__empty_dict__"
_EMPTY_LIST = "__empty_list__"


def _reject_quantized(flat: Dict[str, np.ndarray]) -> None:
    if any(_QUANT_MARKER in key for key in flat):
        raise NotImplementedError(
            "weight-only quantized checkpoints come with the int8 path "
            "(ROADMAP.md, Queue 1, item 7)"
        )


def unflatten_tree(flat: Dict[str, np.ndarray]):
    """``{"a/b/0/w": x}`` → nested dicts, with all-digit keys as lists
    (the inverse of the JAX package's ``flatten_tree``)."""
    _reject_quantized(flat)
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        out = {}
        for k, v in node.items():
            if k.endswith(_EMPTY_DICT):
                out[k[: -len(_EMPTY_DICT)]] = {}
            elif k.endswith(_EMPTY_LIST):
                out[k[: -len(_EMPTY_LIST)]] = []
            else:
                out[k] = listify(v)
        return out

    return listify(root)


@torch.no_grad()
def params_from_numpy(
    flat: Dict[str, np.ndarray],
    dims,
    dtype: torch.dtype,
    device: Union[str, torch.device],
    **model_kw,
):
    """Build a ``Whisper`` from the JAX package's flat parameters.

    ``flat`` maps the JAX names (``encoder/blocks/0/attn/query/w``, …, as
    ``flatten_tree`` writes them) to arrays; each lands in the module whose
    state-dict key is the same path with dots. Floating arrays are cast to
    ``dtype`` (round to nearest even, as ``jnp.asarray(v, bf16)``). A missing
    or unexpected name raises."""
    from whisperx_tpu_torch.models.whisper.model import Whisper

    model = Whisper(dims, dtype=dtype, device=device, **model_kw)
    state = model.state_dict()
    want = {k.replace(".", "/") for k in state}
    _reject_quantized(flat)
    missing, extra = want - set(flat), set(flat) - want
    if missing or extra:
        raise KeyError(
            f"checkpoint does not match {dims}: missing {sorted(missing)[:5]}, "
            f"unexpected {sorted(extra)[:5]}"
        )
    for key, tensor in state.items():
        arr = np.asarray(flat[key.replace(".", "/")])
        if tuple(arr.shape) != tuple(tensor.shape):
            raise ValueError(
                f"{key}: checkpoint shape {arr.shape}, model {tuple(tensor.shape)}"
            )
        tensor.copy_(torch.tensor(arr).to(dtype))  # a copy: arr may be read-only
    return model


def read_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """The flat weights and the config of a checkpoint directory."""
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    with np.load(os.path.join(path, "weights.npz")) as data:
        flat = {k: data[k] for k in data.files}
    return flat, config


def load_checkpoint(
    path: str, dtype: torch.dtype, device: Union[str, torch.device], **model_kw
):
    """``(Whisper, config)`` from a checkpoint directory, through
    ``params_from_numpy``."""
    from whisperx_tpu_torch.models.whisper.config import ModelDimensions

    flat, config = read_checkpoint(path)
    if config.get("family", "whisper") != "whisper":
        raise ValueError(f"{path!r} holds a {config['family']!r} checkpoint")
    dims = ModelDimensions(**config["dims"])
    return params_from_numpy(flat, dims, dtype, device, **model_kw), config


def is_checkpoint_dir(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, "weights.npz"))

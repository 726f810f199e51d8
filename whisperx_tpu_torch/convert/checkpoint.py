"""Reader and writer of the checkpoint directories the JAX package writes,
and the weight bridges from its flat parameter names onto the port's
modules (``params_from_numpy`` for Whisper, ``wav2vec2_from_numpy`` for the
aligner).

A checkpoint directory holds (``whisperx_tpu/convert/checkpoint.py``):
  - ``weights.npz``   : flat ``{"a/b/0/w": array}`` mapping of the param tree
  - ``config.json``   : model family + dimensions + metadata
  - ``vocab.tiktoken``: optional BPE ranks file

A weight-only quantized linear is stored as
``<path>/__quantized_linear__/{qw,scale,b,meta}`` (``meta`` = [bits,
group_size]); it becomes a ``quant.QuantizedLinear``.
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


def _quantized_linear(node: dict, device=None):
    """A ``QuantizedLinear`` from one ``__quantized_linear__`` node. Its
    arrays are not cast (the JAX package's ``load_checkpoint`` leaves them
    as stored: ``qw`` int8, ``scale`` and ``b`` f32)."""
    from whisperx_tpu_torch.quant.core import QuantizedLinear

    bits, group_size = (int(v) for v in node["meta"])

    def tensor(arr):
        return torch.tensor(np.asarray(arr)).to(device)  # a copy: arr may be read-only

    b = node.get("b")
    return QuantizedLinear(
        tensor(node["qw"]), tensor(node["scale"]),
        None if b is None else tensor(b),
        bits=bits, group_size=group_size,
    )


def flatten_tree(model) -> Dict[str, np.ndarray]:
    """A port model's weights in the layout of the JAX package's
    ``flatten_tree``: ``a/b/0/w`` names, quantized linears under
    ``<path>/__quantized_linear__/{qw,scale,b,meta}``, bf16 widened to f32
    (numpy has no bf16)."""
    from whisperx_tpu_torch.quant.core import QuantizedLinear

    def array(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    flat = {name.replace(".", "/"): array(p) for name, p in model.named_parameters()}
    for name, mod in model.named_modules():
        if isinstance(mod, QuantizedLinear):
            key = f"{name.replace('.', '/')}/{_QUANT_MARKER}"
            flat[f"{key}/qw"] = array(mod.qw)
            flat[f"{key}/scale"] = array(mod.scale)
            if mod.b is not None:
                flat[f"{key}/b"] = array(mod.b)
            flat[f"{key}/meta"] = np.asarray([mod.bits, mod.group_size], np.int64)
    return flat


def unflatten_tree(flat: Dict[str, np.ndarray]):
    """``{"a/b/0/w": x}`` → nested dicts, with all-digit keys as lists
    and quantized nodes as ``QuantizedLinear``s (the inverse of the JAX
    package's ``flatten_tree``)."""
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
        if _QUANT_MARKER in node:
            return _quantized_linear(node[_QUANT_MARKER])
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
    ``dtype`` (round to nearest even, as ``jnp.asarray(v, bf16)``). Names
    under ``<linear>/__quantized_linear__/`` replace that ``Linear`` with a
    ``QuantizedLinear`` whose arrays keep their stored types, as the JAX
    package's loader keeps them. A missing or unexpected name raises."""
    from whisperx_tpu_torch.models.whisper.model import Linear, Whisper

    model = Whisper(dims, dtype=dtype, device=device, **model_kw)
    marker = f"/{_QUANT_MARKER}/"
    quantized: Dict[str, dict] = {}
    for key, arr in flat.items():
        if marker in key:
            path, leaf = key.split(marker)
            quantized.setdefault(path, {})[leaf] = arr
    for path, node in quantized.items():
        name = path.replace("/", ".")
        try:
            lin = model.get_submodule(name)
        except AttributeError:
            lin = None
        if not isinstance(lin, Linear) or not {"qw", "scale", "meta"} <= set(node):
            raise KeyError(f"checkpoint has a quantized linear {path!r} the model lacks")
        qlin = _quantized_linear(node, device)
        d_in, d_out = lin.w.shape
        rows = d_in if qlin.bits == 8 else d_in // 2
        if (
            tuple(qlin.qw.shape) != (rows, d_out)
            or tuple(qlin.scale.shape) != (d_in // qlin.group_size, d_out)
            or (qlin.b is None) != (lin.b is None)
        ):
            raise ValueError(f"{path}: quantized shapes do not fit {tuple(lin.w.shape)}")
        parent, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(parent), leaf, qlin)
    # the full-precision parameters (the quantized tensors are buffers)
    _copy_params(model, {k: v for k, v in flat.items() if marker not in k}, dtype, dims)
    return model


def _copy_params(model, flat: Dict[str, np.ndarray], dtype: torch.dtype, what) -> None:
    """Copy ``flat``'s arrays into ``model``'s parameters of the same path,
    cast to ``dtype``; a missing, unexpected or misshapen name raises."""
    state = dict(model.named_parameters())
    want = {k.replace(".", "/") for k in state}
    missing, extra = want - set(flat), set(flat) - want
    if missing or extra:
        raise KeyError(
            f"checkpoint does not match {what}: missing {sorted(missing)[:5]}, "
            f"unexpected {sorted(extra)[:5]}"
        )
    for key, tensor in state.items():
        arr = np.asarray(flat[key.replace(".", "/")])
        if tuple(arr.shape) != tuple(tensor.shape):
            raise ValueError(
                f"{key}: checkpoint shape {arr.shape}, model {tuple(tensor.shape)}"
            )
        tensor.copy_(torch.tensor(arr).to(dtype))  # a copy: arr may be read-only


@torch.no_grad()
def wav2vec2_from_numpy(
    flat: Dict[str, np.ndarray],
    config,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
):
    """Build a ``Wav2Vec2`` from the JAX package's flat wav2vec2 parameters
    (``feature_extractor/0/w``, ``layers/3/attn/query/w``, …). Converted
    large checkpoints carry a bias on each feature convolution; the module
    gets one when the names have it."""
    from whisperx_tpu_torch.models.wav2vec2 import Wav2Vec2

    conv_bias = any(
        k.startswith("feature_extractor/") and k.count("/") == 2 and k.endswith("/b")
        for k in flat
    )
    model = Wav2Vec2(config, conv_bias=conv_bias, dtype=dtype, device=device)
    _copy_params(model, flat, dtype, config)
    return model.eval()


def save_checkpoint(path: str, model, config: dict) -> None:
    """Write a port module's weights and ``config`` in the JAX package's
    layout: ``weights.npz`` of ``flatten_tree`` names, and ``config.json``."""
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "weights.npz"), **flatten_tree(model))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)


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

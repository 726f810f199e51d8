"""Reader and writer of the checkpoint directories the JAX package writes,
and the weight bridges from its flat parameter names onto the port's
modules (``params_from_numpy`` for Whisper, ``wav2vec2_from_numpy`` for the
aligner, ``silero_from_numpy`` and ``pyannote_from_numpy`` for the VADs and
diarization's segmenter, ``resnet_speaker_from_numpy`` for the speaker
embedding).

A checkpoint directory holds (``whisperx_tpu/convert/checkpoint.py``):
  - ``weights.npz``   : flat ``{"a/b/0/w": array}`` mapping of the param tree
  - ``config.json``   : model family + dimensions + metadata
  - ``vocab.tiktoken``: optional BPE ranks file

A weight-only quantized linear is stored as
``<path>/__quantized_linear__/{qw,scale,b,meta}`` (``meta`` = [bits,
group_size]); it becomes a ``quant.QuantizedLinear``.

``save_checkpoint`` writes a port module or, for the converters, a numpy
tree of nested dicts and lists (``flatten_params``).
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


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _to_numpy(x) -> np.ndarray:
    """An array ``np.savez`` can hold: a type numpy has no code for (JAX's
    bfloat16 and the other ml-dtypes) is widened to f32, as the JAX
    package's ``_to_numpy`` does."""
    arr = np.asarray(x)
    if arr.dtype.kind not in "fiub":
        arr = arr.astype(np.float32)
    return arr


def flatten_params(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A numpy tree (nested dicts and lists, as the converters build it)
    flattened as the JAX package's ``flatten_tree`` flattens a parameter
    tree: ``a/b/0/w`` names, in the tree's order; an empty dict or list
    below the root becomes ``<path>__empty_dict__`` / ``__empty_list__``
    (an empty int8 array), so that it survives the round trip."""
    flat: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        if not tree and prefix:
            flat[f"{prefix[:-1]}{_EMPTY_DICT}"] = np.zeros(0, np.int8)
        for k, v in tree.items():
            flat.update(flatten_params(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        if not tree and prefix:
            flat[f"{prefix[:-1]}{_EMPTY_LIST}"] = np.zeros(0, np.int8)
        for i, v in enumerate(tree):
            flat.update(flatten_params(v, f"{prefix}{i}/"))
    else:
        flat[prefix[:-1]] = _to_numpy(tree)
    return flat


def flatten_tree(model) -> Dict[str, np.ndarray]:
    """A port model's weights in the layout of the JAX package's
    ``flatten_tree``: ``a/b/0/w`` names, quantized linears under
    ``<path>/__quantized_linear__/{qw,scale,b,meta}``, bf16 widened to f32
    (numpy has no bf16). The networks whose modules hold torch's LSTM and
    conv layouts go through ``silero_to_numpy``, ``pyannote_to_numpy`` and
    ``resnet_speaker_to_numpy``."""
    from whisperx_tpu_torch.models.pyannote.model import PyanNet
    from whisperx_tpu_torch.models.resnet_speaker.model import ResNetSpeaker
    from whisperx_tpu_torch.models.silero_vad.model import SileroVADNet
    from whisperx_tpu_torch.quant.core import QuantizedLinear

    if isinstance(model, SileroVADNet):
        return silero_to_numpy(model)
    if isinstance(model, PyanNet):
        return pyannote_to_numpy(model)
    if isinstance(model, ResNetSpeaker):
        return resnet_speaker_to_numpy(model)
    flat = {name.replace(".", "/"): _array(p) for name, p in model.named_parameters()}
    for name, mod in model.named_modules():
        if isinstance(mod, QuantizedLinear):
            key = f"{name.replace('.', '/')}/{_QUANT_MARKER}"
            flat[f"{key}/qw"] = _array(mod.qw)
            flat[f"{key}/scale"] = _array(mod.scale)
            if mod.b is not None:
                flat[f"{key}/b"] = _array(mod.b)
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


def _lstm_to_numpy(lstm: torch.nn.LSTM, layer: int, suffix: str = "") -> Dict[str, np.ndarray]:
    """One direction of one layer in the JAX layout: ``wx [in, 4H]``,
    ``wh [H, 4H]`` and one bias (torch's two summed)."""
    def get(name):
        return _array(getattr(lstm, f"{name}_l{layer}{suffix}"))

    return {
        "wx": np.ascontiguousarray(get("weight_ih").T),
        "wh": np.ascontiguousarray(get("weight_hh").T),
        "b": get("bias_ih") + get("bias_hh"),
    }


@torch.no_grad()
def _lstm_from_numpy(lstm: torch.nn.LSTM, layer: int, node: dict, suffix: str = "") -> None:
    """``weight_ih = wxᵀ``, ``weight_hh = whᵀ``, ``bias_ih = b``,
    ``bias_hh = 0`` (JAX adds one bias; torch two)."""
    for name, value in (
        ("weight_ih", np.asarray(node["wx"]).T),
        ("weight_hh", np.asarray(node["wh"]).T),
        ("bias_ih", np.asarray(node["b"])),
        ("bias_hh", np.zeros_like(np.asarray(node["b"]))),
    ):
        p = getattr(lstm, f"{name}_l{layer}{suffix}")
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"lstm {name} l{layer}{suffix}: checkpoint {value.shape}, model {tuple(p.shape)}")
        p.copy_(torch.tensor(value).to(p.dtype))


def _tree(flat: Dict[str, np.ndarray]) -> dict:
    """The flat names as nested dicts and lists, without the markers of
    empty containers."""
    return unflatten_tree(
        {k: v for k, v in flat.items() if not k.endswith((_EMPTY_DICT, _EMPTY_LIST))}
    )


def silero_to_numpy(model) -> Dict[str, np.ndarray]:
    """A ``SileroVADNet`` as the JAX package's flat Silero tree: ``lstm/<i>/
    {wx,wh,b}``, ``head/{w,b}``, and ``config/{hidden_size,num_layers}`` as
    0-d arrays."""
    lstm = model.lstm
    flat = {}
    for i in range(lstm.num_layers):
        flat.update((f"lstm/{i}/{k}", v) for k, v in _lstm_to_numpy(lstm, i).items())
    flat["head/w"] = _array(model.head.w)
    flat["head/b"] = _array(model.head.b)
    flat["config/hidden_size"] = np.asarray(lstm.hidden_size)
    flat["config/num_layers"] = np.asarray(lstm.num_layers)
    return flat


@torch.no_grad()
def silero_from_numpy(
    flat: Dict[str, np.ndarray],
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
):
    """Build a ``SileroVADNet`` from the JAX package's flat Silero tree (its
    ``init_params`` or the converter's): the sizes come from the 0-d
    ``config/hidden_size`` and ``config/num_layers`` and from ``lstm/0/wx``."""
    from whisperx_tpu_torch.models.silero_vad.model import SileroVADNet

    tree = _tree(flat)
    hidden, layers = int(tree["config"]["hidden_size"]), int(tree["config"]["num_layers"])
    if len(tree["lstm"]) != layers:
        raise ValueError(f"config/num_layers {layers}, checkpoint has {len(tree['lstm'])} layers")
    input_size = np.asarray(tree["lstm"][0]["wx"]).shape[0]
    model = SileroVADNet(input_size, hidden, layers, dtype=dtype, device=device)
    for i, node in enumerate(tree["lstm"]):
        _lstm_from_numpy(model.lstm, i, node)
    _copy_params(model.head, {k: np.asarray(v) for k, v in tree["head"].items()}, dtype, "head")
    return model.eval()


def pyannote_to_numpy(model) -> Dict[str, np.ndarray]:
    """A ``PyanNet`` as the JAX package's flat tree: ``wav_norm/{g,b}``,
    ``sincnet/<i>/w`` [K, I, O] and ``sincnet/<i>/norm/{g,b}``, ``lstm/<i>/
    {fwd,bwd}/{wx,wh,b}``, ``linear/<i>/{w,b}``, ``classifier/{w,b}``."""
    flat = {"wav_norm/g": _array(model.wav_norm.g), "wav_norm/b": _array(model.wav_norm.b)}
    for i, conv in enumerate(model.sincnet):
        flat[f"sincnet/{i}/w"] = np.ascontiguousarray(_array(conv.weight).transpose(2, 1, 0))
        flat[f"sincnet/{i}/norm/g"] = _array(conv.norm.g)
        flat[f"sincnet/{i}/norm/b"] = _array(conv.norm.b)
    for i in range(model.cfg.lstm_layers):
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            flat.update(
                (f"lstm/{i}/{direction}/{k}", v)
                for k, v in _lstm_to_numpy(model.lstm, i, suffix).items()
            )
    if not model.cfg.lstm_layers:
        flat[f"lstm{_EMPTY_LIST}"] = np.zeros(0, np.int8)
    for i, lin in enumerate(model.linear):
        flat[f"linear/{i}/w"], flat[f"linear/{i}/b"] = _array(lin.w), _array(lin.b)
    if not len(model.linear):
        flat[f"linear{_EMPTY_LIST}"] = np.zeros(0, np.int8)
    flat["classifier/w"] = _array(model.classifier.w)
    flat["classifier/b"] = _array(model.classifier.b)
    return flat


@torch.no_grad()
def pyannote_from_numpy(
    flat: Dict[str, np.ndarray],
    cfg,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
):
    """Build a ``PyanNet`` of config ``cfg`` from the JAX package's flat
    PyanNet tree: convs HIO ([K, I, O]) → torch's [O, I, K]; each LSTM
    direction through ``_lstm_from_numpy`` (``bwd`` → the reversed one). A
    tree without ``wav_norm`` (the JAX forward then skips the waveform's
    norm) is refused: the port's forward always runs it."""
    from whisperx_tpu_torch.models.pyannote.model import PyanNet

    tree = _tree(flat)
    if "wav_norm" not in tree:
        raise KeyError("checkpoint has no wav_norm (every converted PyanNet has one)")
    model = PyanNet(cfg, dtype=dtype, device=device)
    state = {"wav_norm/g": tree["wav_norm"]["g"], "wav_norm/b": tree["wav_norm"]["b"]}
    if len(tree["sincnet"]) != len(model.sincnet) or len(tree.get("lstm", [])) != cfg.lstm_layers:
        raise ValueError("checkpoint layer counts do not match the config")
    for i, node in enumerate(tree["sincnet"]):
        state[f"sincnet/{i}/weight"] = np.asarray(node["w"]).transpose(2, 1, 0)
        state[f"sincnet/{i}/norm/g"] = node["norm"]["g"]
        state[f"sincnet/{i}/norm/b"] = node["norm"]["b"]
    for i, lin in enumerate(tree.get("linear", [])):
        state[f"linear/{i}/w"], state[f"linear/{i}/b"] = lin["w"], lin["b"]
    state["classifier/w"] = tree["classifier"]["w"]
    state["classifier/b"] = tree["classifier"]["b"]
    for i, layer in enumerate(tree.get("lstm", [])):
        _lstm_from_numpy(model.lstm, i, layer["fwd"])
        _lstm_from_numpy(model.lstm, i, layer["bwd"], "_reverse")
    non_lstm = torch.nn.Module()
    for name in ("wav_norm", "sincnet", "linear", "classifier"):
        setattr(non_lstm, name, getattr(model, name))
    _copy_params(non_lstm, {k: np.asarray(v) for k, v in state.items()}, dtype, cfg)
    return model.eval()


def resnet_speaker_to_numpy(model) -> Dict[str, np.ndarray]:
    """A ``ResNetSpeaker`` as the JAX package's flat tree: ``stem/{w,bn/*}``,
    ``stages/<s>/<b>/{conv1,bn1/*,conv2,bn2/*,down/{w,bn/*}}``,
    ``proj/{w,b}``; convolutions back to HWIO ([k, k, I, O])."""
    flat = {}
    for name, p in model.named_parameters():
        arr = _array(p)
        if arr.ndim == 4:  # OIHW → HWIO
            arr = np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
        flat[name.replace(".", "/")] = arr
    return flat


@torch.no_grad()
def resnet_speaker_from_numpy(
    flat: Dict[str, np.ndarray],
    cfg,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
):
    """Build a ``ResNetSpeaker`` of config ``cfg`` from the JAX package's flat
    tree (its ``init_params`` or the wespeaker converter's): every 4-D array
    is a convolution, HWIO → torch's OIHW. A missing, unexpected or
    misshapen name raises."""
    from whisperx_tpu_torch.models.resnet_speaker.model import ResNetSpeaker

    model = ResNetSpeaker(cfg, dtype=dtype, device=device)
    state = {
        k: np.asarray(v).transpose(3, 2, 0, 1) if np.ndim(v) == 4 else np.asarray(v)
        for k, v in flat.items()
    }
    _copy_params(model, state, dtype, cfg)
    return model.eval()


def save_checkpoint(path: str, params, config: dict) -> None:
    """Write weights and ``config`` in the JAX package's layout:
    ``weights.npz`` and ``config.json``. ``params`` is a port module
    (``flatten_tree``) or a numpy tree (``flatten_params``)."""
    os.makedirs(path, exist_ok=True)
    if isinstance(params, torch.nn.Module):
        flat = flatten_tree(params)
    else:
        flat = flatten_params(params)
    np.savez(os.path.join(path, "weights.npz"), **flat)
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

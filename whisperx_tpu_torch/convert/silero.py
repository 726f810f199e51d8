"""Silero VAD conversion: ONNX file / torch.hub model → the checkpoint
layout the port reads (the JAX package's): per layer ``{"wx": [in, 4H],
"wh": [H, 4H], "b": [4H]}`` in torch's (i, f, g, o) gate order with one
summed bias, and a dense sigmoid head.

Counterpart of ``whisperx_tpu/convert/silero.py``. ``onnx`` (the ONNX
route) and ``torch.hub`` (which downloads) are needed here only.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from whisperx_tpu_torch.convert.checkpoint import save_checkpoint


def _torch_lstm_to_ours(w_ih: np.ndarray, w_hh: np.ndarray, b_ih, b_hh) -> Dict:
    """torch LSTM mats [4H, in] / [4H, H] → ours [in, 4H] / [H, 4H]."""
    bias = np.zeros(w_ih.shape[0], np.float32)
    if b_ih is not None:
        bias = bias + b_ih
    if b_hh is not None:
        bias = bias + b_hh
    return {
        "wx": np.ascontiguousarray(w_ih.T.astype(np.float32)),
        "wh": np.ascontiguousarray(w_hh.T.astype(np.float32)),
        "b": bias.astype(np.float32),
    }


def convert_silero_onnx(onnx_path: str, out: str) -> None:
    """Extract the LSTM weights and the head from a Silero VAD ONNX file."""
    import onnx
    from onnx import numpy_helper

    model = onnx.load(onnx_path)
    inits = {i.name: numpy_helper.to_array(i) for i in model.graph.initializer}

    lstm_w = sorted(k for k in inits if "lstm" in k.lower() and inits[k].ndim == 3)
    layers: List[Dict] = []
    # ONNX LSTM tensors: W [1, 4H, in], R [1, 4H, H], B [1, 8H], gates in
    # (i, o, f, c) order → torch's (i, f, g=c, o)
    ws = [k for k in lstm_w if ".W" in k or k.endswith("W")]
    rs = [k for k in lstm_w if ".R" in k or k.endswith("R")]
    bs = sorted(k for k in inits if "lstm" in k.lower() and inits[k].ndim == 2)

    def reorder(mat4h: np.ndarray, h: int) -> np.ndarray:
        i, o, f, c = (mat4h[k * h : (k + 1) * h] for k in range(4))
        return np.concatenate([i, f, c, o], axis=0)

    for li, (wk, rk) in enumerate(zip(sorted(ws), sorted(rs))):
        W = inits[wk][0]
        R = inits[rk][0]
        h = R.shape[1]
        W = reorder(W, h)
        R = reorder(R, h)
        bias = np.zeros(4 * h, np.float32)
        if li < len(bs):
            B = inits[bs[li]][0]
            bias = reorder(B[: 4 * h], h) + reorder(B[4 * h :], h)
        layers.append(
            {
                "wx": np.ascontiguousarray(W.T.astype(np.float32)),
                "wh": np.ascontiguousarray(R.T.astype(np.float32)),
                "b": bias.astype(np.float32),
            }
        )

    head_w = None
    head_b = None
    for k, v in inits.items():
        if v.ndim == 2 and v.shape[0] == 1 and "lstm" not in k.lower():
            head_w = np.ascontiguousarray(v.T.astype(np.float32))
        if v.ndim == 1 and v.shape[0] == 1 and "lstm" not in k.lower():
            head_b = v.astype(np.float32)
    if head_w is None:
        h = layers[-1]["wh"].shape[0]
        head_w = np.zeros((h, 1), np.float32)
        head_b = np.zeros((1,), np.float32)

    params = {
        "lstm": layers,
        "head": {"w": head_w, "b": head_b if head_b is not None else np.zeros(1, np.float32)},
        "config": {"hidden_size": layers[0]["wh"].shape[0], "num_layers": len(layers)},
    }
    save_checkpoint(out, params, {"family": "silero_vad", "name": os.path.basename(onnx_path)})


def convert_silero_torch(out: str, repo: str = "snakers4/silero-vad") -> None:
    """Convert the torch.hub Silero JIT model (downloads it once)."""
    import torch

    model, _ = torch.hub.load(repo, "silero_vad", onnx=False, trust_repo=True)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    # one layer per weight_ih KEY (LSTMCell's ``...rnn.weight_ih`` and
    # nn.LSTM's ``lstm.weight_ih_l{N}`` alike: replacing inside the full
    # key keeps the layer suffix); sorted = layer order
    ih_keys = sorted(k for k in sd if "weight_ih" in k)
    layers = [
        _torch_lstm_to_ours(
            sd[k],
            sd[k.replace("weight_ih", "weight_hh")],
            sd.get(k.replace("weight_ih", "bias_ih")),
            sd.get(k.replace("weight_ih", "bias_hh")),
        )
        for k in ih_keys
    ]
    head_w = next((v for k, v in sd.items() if v.ndim == 2 and v.shape[0] == 1), None)
    head_b = next((v for k, v in sd.items() if v.ndim == 1 and v.shape[0] == 1), None)
    params = {
        "lstm": layers,
        "head": {
            "w": np.ascontiguousarray(head_w.T) if head_w is not None else None,
            "b": head_b if head_b is not None else np.zeros(1, np.float32),
        },
        "config": {
            "hidden_size": layers[0]["wh"].shape[0] if layers else 64,
            "num_layers": len(layers),
        },
    }
    save_checkpoint(out, params, {"family": "silero_vad", "name": repo})

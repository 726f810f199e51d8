"""Reader of ``model.safetensors`` files and of the state dicts of HF
checkpoint directories, without the ``safetensors`` package.

A safetensors file is an 8-byte little-endian header length N, N bytes of
JSON (``{name: {"dtype", "shape", "data_offsets": [start, end]}}``, plus an
optional ``__metadata__``), then the tensors' bytes, little-endian, the
offsets counted from the end of the header. The data is memory-mapped:
each array is a read-only view of the file.

The dtypes are those ``safetensors.numpy.load_file`` reads, and BF16.
Numpy has no bfloat16; the JAX package's converters read one as
``ml_dtypes.bfloat16`` (JAX loads ml-dtypes, which registers the type with
numpy) and ``save_checkpoint`` widens it to f32. Here a BF16 tensor is
widened to f32 as it is read (exact: its 16 bits become the top half of
an f32), so the converted checkpoint is the same. Any other dtype numpy
cannot hold (the F8 types) raises ``TypeError`` naming the tensor.
"""

from __future__ import annotations

import json
import math
import os
import struct
from typing import Dict

import numpy as np

_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2",
    "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1",
    "U64": "<u8", "U32": "<u4", "U16": "<u2", "U8": "u1",
    "BOOL": "?",
}


def load_file(path: str) -> Dict[str, np.ndarray]:
    """``{name: array}`` of a safetensors file, in the order of the data
    (as ``safetensors.numpy.load_file``), BF16 widened to f32. A malformed
    header or a tensor whose offsets do not fit its shape, or lie outside
    the file, raises ``ValueError``; a dtype numpy cannot hold raises
    ``TypeError``."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
        (n,) = struct.unpack("<Q", head)
        if 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes runs past the end of the file")
        header = json.loads(f.read(n))
    base = 8 + n
    data = np.memmap(path, np.uint8, "r") if size > base else np.zeros(size, np.uint8)
    out = {}
    names = [k for k in header if k != "__metadata__"]
    for name in sorted(names, key=lambda k: (header[k]["data_offsets"], k)):
        info = header[name]
        bf16 = info["dtype"] == "BF16"
        code = "<u2" if bf16 else _DTYPES.get(info["dtype"])
        if code is None:
            raise TypeError(
                f"{path}: tensor {name!r} is {info['dtype']}, which numpy has no type for"
            )
        dtype, shape = np.dtype(code), tuple(info["shape"])
        start, end = info["data_offsets"]
        if not 0 <= start <= end or end - start != math.prod(shape) * dtype.itemsize or base + end > size:
            raise ValueError(f"{path}: tensor {name!r}: offsets {start, end} do not hold {info}")
        arr = np.asarray(data[base + start : base + end]).view(dtype).reshape(shape)
        out[name] = (arr.astype("<u4") << 16).view("<f4") if bf16 else arr
    return out


def load_state_dict(src: str) -> Dict[str, np.ndarray]:
    """The weights of an HF checkpoint directory: ``model.safetensors``,
    else ``pytorch_model.bin`` (``torch.load`` with ``weights_only``), as
    the JAX package's converters look for them."""
    st = os.path.join(src, "model.safetensors")
    if os.path.exists(st):
        return load_file(st)
    pt = os.path.join(src, "pytorch_model.bin")
    if os.path.exists(pt):
        import torch

        sd = torch.load(pt, map_location="cpu", weights_only=True)
        return {k: v.numpy() for k, v in sd.items()}
    raise FileNotFoundError(f"No model.safetensors / pytorch_model.bin in {src}")

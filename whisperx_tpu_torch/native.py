"""ctypes binding of the repo's native C++ audio library
(``native/wav_decode.cpp``): RIFF/WAVE decoding, channel downmix and the
Kaiser-windowed-sinc polyphase resampler.

Counterpart of ``whisperx_tpu/native.py``. The port compiles the source
itself with ``g++`` at first use, into ``whisperx_tpu_torch/_build/``
(listed in ``.gitignore``), and never writes beside the source. The shared
object's name carries a hash of the source and the flags, so an edited
source is rebuilt; it is compiled to a temporary file and moved into place
atomically, so a concurrent process never loads a half-written library.
Callers (``audio/io.py``) catch any exception and take the pure-Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(_HERE), "native", "wav_decode.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
GXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"wav_decode-{digest.hexdigest()[:16]}.so")


def _build(so_path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.build.{os.getpid()}"
    subprocess.run(
        ["g++", *GXX_FLAGS, "-o", tmp, SRC], check=True, capture_output=True
    )
    os.replace(tmp, so_path)


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(SRC):
            raise RuntimeError(f"native source not found: {SRC}")
        so_path = library_path()
        if not os.path.exists(so_path):
            _build(so_path)
        lib = ctypes.CDLL(so_path)
        out_ptr = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))
        lib.wxt_decode_wav.restype = ctypes.c_long
        lib.wxt_decode_wav.argtypes = [ctypes.c_char_p, ctypes.c_int, out_ptr]
        lib.wxt_resample.restype = ctypes.c_long
        lib.wxt_resample.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
            ctypes.c_int, out_ptr,
        ]
        lib.wxt_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return lib


def _take(lib, out, n: int, what: str) -> np.ndarray:
    """Copy the library's malloc'd result out and free it."""
    if n < 0:
        raise RuntimeError(f"native {what} failed (code {n})")
    if n == 0:  # empty result: out may be NULL
        return np.zeros(0, np.float32)
    try:
        return np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.wxt_free(out)


def decode_wav_file(path: str, target_sr: int = 16000) -> np.ndarray:
    """Decode, downmix and resample a WAV file natively → float32 mono."""
    lib = _get_lib()
    out = ctypes.POINTER(ctypes.c_float)()
    n = lib.wxt_decode_wav(path.encode(), target_sr, ctypes.byref(out))
    return _take(lib, out, n, f"WAV decode of {path}")


def resample(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """The native polyphase resampler."""
    lib = _get_lib()
    audio = np.ascontiguousarray(audio, np.float32)
    out = ctypes.POINTER(ctypes.c_float)()
    n = lib.wxt_resample(
        audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(audio), sr_in, sr_out, ctypes.byref(out),
    )
    return _take(lib, out, n, "resample")

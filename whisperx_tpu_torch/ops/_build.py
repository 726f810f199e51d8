"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with nvcc
into a shared library under ``_build/`` (listed in ``.gitignore``), loaded
with ``ctypes``. The library's file name carries a hash of the source and
the compiler flags, so an edited source is rebuilt and an unchanged one is
built once per checkout. Nothing is built when a module is imported: the
first ``load`` builds. Threads that make the first ``load`` of a kernel
together wait for a single build under one lock (one nvcc per source per
process).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, into the .log
)

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc"
        if os.path.exists("/usr/local/cuda/bin/nvcc")
        else None
    )
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
            "source at first use"
        )
    return found


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``) of the last build of ``name``."""
    path = f"{library_path(name)}.log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, compiled first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:  # the check, the build and the load, once per source
        lib = _loaded.get(name)
        if lib is None:
            out = library_path(name)
            if not os.path.exists(out):
                os.makedirs(BUILD_DIR, exist_ok=True)
                # unique per build: another process may build the same source
                fd, tmp = tempfile.mkstemp(prefix=f"{name}-", suffix=".tmp", dir=BUILD_DIR)
                os.close(fd)
                try:
                    with open(f"{tmp}.log", "w") as log:
                        rc = subprocess.run(
                            [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                             os.path.join(CSRC, f"{name}.cu")],
                            stdout=log, stderr=subprocess.STDOUT,
                        ).returncode
                    os.replace(f"{tmp}.log", f"{out}.log")
                    if rc != 0:
                        raise RuntimeError(f"nvcc failed for {name}.cu:\n{build_log(name)}")
                    os.replace(tmp, out)  # atomic: a reader never sees half a file
                finally:
                    for path in (tmp, f"{tmp}.log"):
                        if os.path.exists(path):
                            os.remove(path)
            lib = _loaded[name] = ctypes.CDLL(out)
    return lib

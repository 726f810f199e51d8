"""Matrix-product numerics of the JAX reference, scoped to the port's own
forward passes.

The switches are process-wide torch flags, and serving runs forwards from
several threads at once (the batcher's worker, HTTP handler threads, one
worker per stream). So a scope is shared, not nested per thread: the first
thread in saves the caller's flags and sets the strict ones, the last one
out restores them, all under one lock. Every scoped forward then runs
wholly under the reference settings, and the process always ends with the
caller's. Unscoped work in another thread that overlaps a scope runs with
the strict settings too: slower, never less exact.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_LOCK = threading.Lock()


class _SharedScope:
    """Boolean flags (``(owner, attribute)`` pairs) held False while any
    thread is inside ``held()``, restored when the last one leaves."""

    def __init__(self, *flags):
        self._flags = flags
        self._depth = 0
        self._saved = ()

    @contextlib.contextmanager
    def held(self):
        with _LOCK:
            if self._depth == 0:
                self._saved = tuple(getattr(o, a) for o, a in self._flags)
                for o, a in self._flags:
                    setattr(o, a, False)
            self._depth += 1
        try:
            yield
        finally:
            with _LOCK:
                self._depth -= 1
                if self._depth == 0:
                    for (o, a), value in zip(self._flags, self._saved):
                        setattr(o, a, value)


_MATMUL = _SharedScope(
    (torch.backends.cuda.matmul, "allow_tf32"),
    (torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction"),
)
_CUDNN = _SharedScope((torch.backends.cudnn, "allow_tf32"))


@contextlib.contextmanager
def reference_matmul():
    """Inside: f32 products in full f32 on CUDA (no TF32, as JAX's
    ``Precision.HIGHEST``) and bf16 GEMMs reduced in f32 only. The caller's
    settings come back when the last scope in the process exits, so other
    torch code keeps its own. Usable as a decorator."""
    with _MATMUL.held():
        yield


@contextlib.contextmanager
def no_tf32_cudnn():
    """cuDNN's convolutions and recurrences (``nn.LSTM``) in full f32 inside,
    the caller's setting after the last scope exits: by default cuDNN runs
    f32 as TF32, which moves a VAD's or an aligner's CUDA outputs ~1e-3 away
    from the CPU's."""
    with _CUDNN.held():
        yield

"""Matrix-product numerics of the JAX reference, scoped to the port's own
forward passes."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def reference_matmul():
    """Inside: f32 products in full f32 on CUDA (no TF32, as JAX's
    ``Precision.HIGHEST``) and bf16 GEMMs reduced in f32 only. The caller's
    settings come back on exit, so other torch code in the process keeps
    its own. Usable as a decorator."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, m.allow_bf16_reduced_precision_reduction)
    m.allow_tf32 = False
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = saved

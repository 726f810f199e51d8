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


@contextlib.contextmanager
def no_tf32_cudnn():
    """cuDNN's convolutions and recurrences (``nn.LSTM``) in full f32 inside,
    the caller's setting after: by default cuDNN runs f32 as TF32, which
    moves a VAD's or an aligner's CUDA outputs ~1e-3 away from the CPU's."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved

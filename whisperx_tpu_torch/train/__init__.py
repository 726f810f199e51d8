"""Trainers of the micro models that the learned-weight proofs use: the
port's counterpart of ``whisperx_tpu/train/``. They run on ``device``
(default ``"cuda"``) and cache their checkpoints under
``~/.cache/whisperx_tpu_torch/``."""

from whisperx_tpu_torch.train.align_micro import (
    aligned_checkpoint_cached,
    train_micro_aligned,
)
from whisperx_tpu_torch.train.micro import (
    PHRASES,
    build_corpus,
    micro_checkpoint_cached,
    render_phrase,
    save_micro_checkpoint,
    target_tokens,
    train_micro,
)

__all__ = [
    "PHRASES",
    "aligned_checkpoint_cached",
    "build_corpus",
    "micro_checkpoint_cached",
    "render_phrase",
    "save_micro_checkpoint",
    "target_tokens",
    "train_micro",
    "train_micro_aligned",
]

"""Checkpoint directories in the JAX package's layout (``weights.npz`` +
``config.json``) and the converters from published weights
(``python -m whisperx_tpu_torch.convert``).

``load_checkpoint`` builds a ``Whisper`` and raises on any other family (the
JAX package's returns the raw tree of any family); ``read_checkpoint`` gives
any family's flat weights and config."""

from whisperx_tpu_torch.convert.checkpoint import (
    is_checkpoint_dir,
    load_checkpoint,
    read_checkpoint,
    save_checkpoint,
)

__all__ = ["is_checkpoint_dir", "load_checkpoint", "read_checkpoint", "save_checkpoint"]

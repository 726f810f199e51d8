"""Data- and tensor-parallel pipeline execution over a device mesh.

Counterpart of ``whisperx_tpu/parallel/data_parallel.py``. The pipeline is
the shipped one, unchanged: with a mesh active (``use_mesh``), each decode
batch that the data axis divides is cut into one contiguous slice of rows
per data row, and each slice decodes on its row's model replica on a
worker thread of its own (``decoding/decode.py::decode_dispatch``); each
replica is split over its row's devices when ``n_model`` > 1
(``sharding.shard_params_tp``).
"""

from __future__ import annotations

from typing import Optional

import torch

from whisperx_tpu_torch.parallel.sharding import (
    DATA_AXIS,
    make_mesh,
    shard_params_tp,
    use_mesh,
)


def data_parallel_transcribe(
    pipeline,
    audio,
    *,
    mesh=None,
    n_model: int = 1,
    batch_size: Optional[int] = None,
    **kwargs,
):
    """Transcribe with chunk batches split over the mesh ``data`` axis.

    ``pipeline``: a ``TranscriptionPipeline`` (``asr.load_model``).
    ``mesh``: a (data, model) mesh, or None for one over every visible CUDA
    device with ``n_model``-way tensor parallelism. The model is placed on
    the mesh at first use; the batch size is rounded up to a multiple of
    the data axis so that every batch splits evenly.

    Returns the ordinary ``TranscriptionResult``.
    """
    if mesh is None:
        mesh = make_mesh(n_model=n_model)
    n_data = mesh.shape[DATA_AXIS]
    if getattr(pipeline.model, "_dp_mesh", None) != mesh:
        shard_params_tp(pipeline.model, mesh)
    bs = batch_size or pipeline.batch_size
    bs = -(-bs // n_data) * n_data
    with use_mesh(mesh):
        return pipeline.transcribe(audio, batch_size=bs, **kwargs)


def maybe_data_parallel(pipeline) -> bool:
    """True when the pipeline runs on CUDA and more than one GPU is
    visible: the case in which the DP path is worthwhile."""
    return pipeline.device.type == "cuda" and torch.cuda.device_count() > 1


class DataParallelPipeline:
    """Drop-in pipeline proxy that runs every decode on the mesh.

    Wraps a ``TranscriptionPipeline`` so that callers that only know the
    pipeline protocol (the CLI, ``serve.ContinuousBatcher``,
    ``serve.StreamingTranscriber``) get batches split over the ``data``
    axis (and the model split over ``model`` when ``n_model > 1``). The
    model is placed on the mesh once, on construction; batch sizes are
    rounded up to a multiple of the data axis.
    """

    def __init__(self, pipeline, mesh=None, n_model: int = 1):
        self.pipeline = pipeline
        self.mesh = mesh if mesh is not None else make_mesh(n_model=n_model)
        self._n_data = self.mesh.shape[DATA_AXIS]
        shard_params_tp(pipeline.model, self.mesh)

    def _round(self, batch_size: Optional[int]) -> int:
        bs = batch_size or self.pipeline.batch_size
        return -(-bs // self._n_data) * self._n_data

    def transcribe(self, audio, batch_size: Optional[int] = None, **kwargs):
        with use_mesh(self.mesh):
            return self.pipeline.transcribe(
                audio, batch_size=self._round(batch_size), **kwargs
            )

    def transcribe_many(self, audios, batch_size: Optional[int] = None, **kwargs):
        with use_mesh(self.mesh):
            return self.pipeline.transcribe_many(
                audios, batch_size=self._round(batch_size), **kwargs
            )

    def warmup(self, batch_size: Optional[int] = None, duration_s: float = 65.0):
        """Drive the mesh path once on synthetic speech. Not forwarded
        through ``__getattr__``: the inner pipeline's warmup would run
        unsplit batches, which DP traffic never does."""
        from whisperx_tpu_torch.asr import warmup_audio

        return self.transcribe(warmup_audio(duration_s), batch_size=batch_size)

    def __getattr__(self, name):
        # model / language / task / detect_language / model_prompt / ...
        return getattr(self.pipeline, name)

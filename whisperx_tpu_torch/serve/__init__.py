"""The serving layer of the PyTorch/CUDA port: continuous batching, live
streams (long-poll and WebSocket) and the HTTP server, as in
``whisperx_tpu.serve``; ``python -m whisperx_tpu_torch.serve`` starts it."""

from whisperx_tpu_torch.serve.batching import (
    BatchConfig,
    ContinuousBatcher,
    QueueFullError,
    RequestQueue,
    TranscriptionRequest,
    bucket_requests,
)
from whisperx_tpu_torch.serve.streaming import (
    AudioRingBuffer,
    SpeakerRegistry,
    StreamingChunker,
    StreamingConfig,
    StreamingTranscriber,
    warmup_streaming,
)
from whisperx_tpu_torch.serve.server import TranscriptionServer
from whisperx_tpu_torch.serve.ws import WebSocket, WSProtocolError

__all__ = [
    "TranscriptionServer",
    "WebSocket",
    "WSProtocolError",
    "BatchConfig",
    "ContinuousBatcher",
    "QueueFullError",
    "RequestQueue",
    "TranscriptionRequest",
    "bucket_requests",
    "AudioRingBuffer",
    "StreamingChunker",
    "SpeakerRegistry",
    "StreamingConfig",
    "StreamingTranscriber",
    "warmup_streaming",
]

"""Audio front-end hyperparameters.

Semantics parity: reference whisperx/audio.py:13-22 — all Whisper-family models
consume 16 kHz audio, 25 ms hann windows with 10 ms hop, 30 s chunks.
"""


def exact_div(x: int, y: int) -> int:
    assert x % y == 0
    return x // y


SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000 samples in a 30-second chunk
N_FRAMES = exact_div(N_SAMPLES, HOP_LENGTH)  # 3000 mel frames per chunk

N_SAMPLES_PER_TOKEN = HOP_LENGTH * 2  # encoder convs have stride 2
FRAMES_PER_SECOND = exact_div(SAMPLE_RATE, HOP_LENGTH)  # 100 frames / s
TOKENS_PER_SECOND = exact_div(SAMPLE_RATE, N_SAMPLES_PER_TOKEN)  # 50 tokens / s

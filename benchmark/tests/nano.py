"""The test-nano configuration and small cells for the CPU tests."""

import copy
import time

import numpy as np

from harness import cell, spec

LIMIT = 1e-3  # f32 on the CPU against the f32 reference: rounding only


def config(dtype: str = "float32") -> dict:
    cfg = spec.config("large-v3-turbo")
    cfg.update(name="test-nano", n_mels=80, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
               n_vocab=51865, n_text_state=64, n_text_head=2, n_text_layer=2, dtype=dtype)
    # the 99-language layout: <|nospeech|> is 50362
    cfg["suppress_ids"] = [i for i in cfg["suppress_ids"] if i < 50363]
    return cfg


def workload(kind: str) -> dict:
    if kind == "offline":
        w = copy.deepcopy(spec.workload("large-v3-turbo.offline_long"))
        w["params"].update(durations_s=[40.0, 55.0], pool_s=60, batch_size=4, sample_len=24)  # two windows or more a file
        w["check"].update(requests=3)
    else:
        w = copy.deepcopy(spec.workload("large-v3-turbo.serve_short"))
        w["params"].update(pool_s=60, rate_per_s=8.0, batch_size=4, sample_len=24)
        w["check"].update(requests=32)
    w["limits"]["max_gap"] = LIMIT
    return w


CELLS = {"offline": "large-v3-turbo.offline_long", "serve": "large-v3-turbo.serve_short"}


def run(kind: str, seed: int = 2**31 + 12345, seconds: float = 3.0, trace: bool = False,
        control: bool = False, cfg=None, w=None, **kw):
    out, jax_like = cell.run(CELLS[kind], seed, seconds, trace, t_start=time.perf_counter(), device="cpu",
                             workload=w or workload(kind), config=cfg or config(), control=control,
                             log=lambda s: None, **kw)
    assert not jax_like
    return out


def pool(seconds: float = 60.0, seed: int = 7) -> np.ndarray:
    import torch

    from harness import audio

    return audio.pool(seconds, seed, torch.device("cpu"))

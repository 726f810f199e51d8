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


# the published 32-label set of the English wav2vec2 CTC models (vocab.json)
DICTIONARY = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4,
              **{c: i + 5 for i, c in enumerate("ETAONIHSRDLUMWCFGYPBVK")}, "'": 27, "X": 28, "J": 29, "Q": 30, "Z": 31}
# f32 on the CPU against the f32 reference with the exact GELU (the port's is
# the tanh form): sound runs read under 1e-4 and 1e-3 nats, the bf16 control
# over 0.04 and 1 nat
ALIGN_LIMITS = {"align_score_gap": 2.5e-4, "align_path_gap": 0.05, "align_missing": 0}


def align_section(stable: bool = True) -> dict:
    """The port's TEST_CONFIG widths in the published configuration's keys:
    with ``stable`` the large models' layout (layer-normed convolutions
    with biases, pre-norm blocks), else the base models'."""
    return {
        "name": "test/wav2vec2-nano",
        "source": "the port's models/wav2vec2/model.py TEST_CONFIG",
        "hf_config": {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 2,
                      "intermediate_size": 128, "conv_dim": [32] * 7, "conv_kernel": [10, 3, 3, 3, 3, 2, 2],
                      "conv_stride": [5, 2, 2, 2, 2, 2, 2], "feat_extract_norm": "layer" if stable else "group",
                      "do_stable_layer_norm": stable, "num_conv_pos_embeddings": 128,
                      "num_conv_pos_embedding_groups": 16, "vocab_size": 32, "conv_bias": stable},
        "dictionary": dict(DICTIONARY),
        "interpolate_method": "nearest",
    }


def words_config() -> dict:
    cfg = config()
    cfg.update(name="test-nano-words", align=align_section())
    return cfg


def words_workload() -> dict:
    w = workload("offline")
    w.update(config="test-nano-words", traffic="offline_words")
    w["limits"].update(ALIGN_LIMITS)
    return w


def run_words(seed: int = 2**31 + 12345, seconds: float = 3.0, trace: bool = False, control: int = 0, **kw):
    out, jax_like = cell.run("test-nano-words.offline_words", seed, seconds, trace, t_start=time.perf_counter(),
                             device="cpu", workload=kw.pop("w", None) or words_workload(),
                             config=kw.pop("cfg", None) or words_config(), control=control, log=lambda s: None, **kw)
    assert not jax_like
    return out

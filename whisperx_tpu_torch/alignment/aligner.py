"""Alignment model wrapper: batched wav2vec2 emissions + the CTC dictionary.

Counterpart of ``whisperx_tpu/alignment/aligner.py`` (reference
load_align_model, alignment.py:77-110). Models load from converted
checkpoints (the JAX package's layout, read through
``convert.checkpoint.wav2vec2_from_numpy``); with none found, a
random-weight model keeps the pipeline structurally whole, and its metadata
says ``random_weights`` so that callers skip it.

Emissions pad each segment with zeros to a power-of-two bucket of at least
4096 samples, exactly as the JAX package pads them. The emissions of a
segment therefore depend on its bucket: the base model's group norm
averages over the padded frames and the attention has no padding mask (a
fault of the reference, which the upstream reference avoids by running each
segment unpadded; ROADMAP.md, Queue 3). The port keeps the padding so that
it matches the JAX package.

The metadata's ``"type"`` is ``"torch"`` (the JAX package says ``"jax"``),
and the random weights come from a ``torch.Generator`` (seed 0), not JAX's
``PRNGKey(0)``: both are deliberate differences.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from whisperx_tpu_torch.models.wav2vec2 import (
    TEST_CONFIG,
    Wav2Vec2,
    config_from_json,
    forward,
    init_params,
    output_lengths,
)

# Default per-language alignment models (conversion sources); a copy of the
# JAX package's registry (reference alignment.py:31-74).
DEFAULT_ALIGN_MODELS_TORCH = {
    "en": "WAV2VEC2_ASR_BASE_960H",
    "fr": "VOXPOPULI_ASR_BASE_10K_FR",
    "de": "VOXPOPULI_ASR_BASE_10K_DE",
    "es": "VOXPOPULI_ASR_BASE_10K_ES",
    "it": "VOXPOPULI_ASR_BASE_10K_IT",
}

DEFAULT_ALIGN_MODELS_HF = {
    "ja": "jonatasgrosman/wav2vec2-large-xlsr-53-japanese",
    "zh": "jonatasgrosman/wav2vec2-large-xlsr-53-chinese-zh-cn",
    "nl": "jonatasgrosman/wav2vec2-large-xlsr-53-dutch",
    "uk": "Yehor/wav2vec2-xls-r-300m-uk-with-small-lm",
    "pt": "jonatasgrosman/wav2vec2-large-xlsr-53-portuguese",
    "ar": "jonatasgrosman/wav2vec2-large-xlsr-53-arabic",
    "cs": "comodoro/wav2vec2-xls-r-300m-cs-250",
    "ru": "jonatasgrosman/wav2vec2-large-xlsr-53-russian",
    "pl": "jonatasgrosman/wav2vec2-large-xlsr-53-polish",
    "hu": "jonatasgrosman/wav2vec2-large-xlsr-53-hungarian",
    "fi": "jonatasgrosman/wav2vec2-large-xlsr-53-finnish",
    "fa": "jonatasgrosman/wav2vec2-large-xlsr-53-persian",
    "el": "jonatasgrosman/wav2vec2-large-xlsr-53-greek",
    "tr": "mpoyraz/wav2vec2-xls-r-300m-cv7-turkish",
    "da": "saattrupdan/wav2vec2-xls-r-300m-ftspeech",
    "he": "imvladikon/wav2vec2-xls-r-300m-hebrew",
    "vi": "nguyenvulebinh/wav2vec2-base-vi",
    "ko": "kresnik/wav2vec2-large-xlsr-korean",
    "ur": "kingabzpro/wav2vec2-large-xls-r-300m-Urdu",
    "te": "anuragshas/wav2vec2-large-xlsr-53-telugu",
    "hi": "theainerd/Wav2Vec2-large-xlsr-hindi",
    "ca": "softcatala/wav2vec2-large-xlsr-catala",
    "ml": "gvs/wav2vec2-large-xlsr-malayalam",
    "no": "NbAiLab/nb-wav2vec2-1b-bokmaal-v2",
    "nn": "NbAiLab/nb-wav2vec2-1b-nynorsk",
    "sk": "comodoro/wav2vec2-xls-r-300m-sk-cv8",
    "sl": "anton-l/wav2vec2-large-xlsr-53-slovenian",
    "hr": "classla/wav2vec2-xls-r-parlaspeech-hr",
    "ro": "gigant/romanian-wav2vec2",
    "eu": "stefan-it/wav2vec2-large-xlsr-53-basque",
    "gl": "ifrz/wav2vec2-large-xlsr-galician",
    "ka": "xsway/wav2vec2-large-xlsr-georgian",
    "lv": "jimregan/wav2vec2-large-xlsr-latvian-cv",
    "tl": "Khalsuu/filipino-wav2vec2-l-xls-r-300m-official",
}

# wav2vec2 CTC character vocabulary (the published base-960h label set):
# the random-weight model's, and the default of converted torchaudio bundles
DEFAULT_EN_VOCAB = {
    "<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4,
    "e": 5, "t": 6, "a": 7, "o": 8, "n": 9, "i": 10, "h": 11, "s": 12,
    "r": 13, "d": 14, "l": 15, "u": 16, "m": 17, "w": 18, "c": 19, "f": 20,
    "g": 21, "y": 22, "p": 23, "b": 24, "v": 25, "k": 26, "'": 27, "x": 28,
    "j": 29, "q": 30, "z": 31,
}

MIN_BUCKET = 4096  # samples
MIN_SAMPLES = 400  # one frame of the feature extractor


def bucket_of(n: int) -> int:
    """The power-of-two sample bucket (at least MIN_BUCKET) of ``n`` samples."""
    bucket = MIN_BUCKET
    while bucket < n:
        bucket *= 2
    return bucket


class Wav2Vec2Aligner:
    """Callable producing CTC log-prob emissions for audio segments."""

    def __init__(
        self,
        model: Wav2Vec2,
        dictionary: Dict[str, int],
        language: str = "en",
        name: str = "wav2vec2",
    ):
        self.model = model
        self.config = model.config
        self.dictionary = dictionary
        self.language = language
        self.name = name

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def blank_id(self) -> int:
        for tok in ("<pad>", "[pad]"):
            if tok in self.dictionary:
                return self.dictionary[tok]
        return 0

    @torch.no_grad()
    def _forward(self, batch: np.ndarray) -> np.ndarray:
        audio = torch.from_numpy(batch).to(self.device)
        return forward(self.model, audio).cpu().numpy()

    def emissions(self, audio: np.ndarray) -> np.ndarray:
        """[samples] or [B, samples] → log-prob emissions [B, T, V], with the
        sample axis zero-padded to its bucket and the frames trimmed to the
        real samples."""
        audio = np.asarray(audio, np.float32)
        if audio.ndim == 1:
            audio = audio[None]
        n = audio.shape[1]
        padded = np.zeros((audio.shape[0], bucket_of(n)), np.float32)
        padded[:, :n] = audio
        ems = self._forward(padded)
        return ems[:, : output_lengths(self.config, max(n, MIN_SAMPLES))]

    def emissions_batch(self, waves: List[np.ndarray]) -> List[np.ndarray]:
        """Emissions of many variable-length segments, one forward pass per
        length bucket, each segment's frames trimmed to its own length."""
        results: List[Optional[np.ndarray]] = [None] * len(waves)
        buckets: Dict[int, List[int]] = {}
        for i, w in enumerate(waves):
            buckets.setdefault(bucket_of(max(len(w), MIN_SAMPLES)), []).append(i)
        for bucket, idxs in buckets.items():
            batch = np.zeros((len(idxs), bucket), np.float32)
            for row, i in enumerate(idxs):
                batch[row, : len(waves[i])] = waves[i]
            ems = self._forward(batch)
            for row, i in enumerate(idxs):
                t_real = output_lengths(self.config, max(len(waves[i]), MIN_SAMPLES))
                results[i] = ems[row, :t_real]
        return results


def _find_checkpoint(language_code: str, model_name: str, model_dir: Optional[str]):
    """The checkpoint directory: ``<dir>/<model name with / as __>`` or
    ``<dir>/<language>``, for ``model_dir``, then ``WHISPERX_TPU_ALIGN_DIR``,
    then ``~/.cache/whisperx_tpu/align``."""
    search_dirs = [
        model_dir,
        os.environ.get("WHISPERX_TPU_ALIGN_DIR"),
        os.path.expanduser("~/.cache/whisperx_tpu/align"),
    ]
    for d in search_dirs:
        if not d:
            continue
        for leaf in (model_name.replace("/", "__"), language_code):
            candidate = os.path.join(d, leaf)
            if os.path.isdir(candidate):
                return candidate
    return None


def load_align_model(
    language_code: str,
    device: Union[str, torch.device] = "cuda",
    model_name: Optional[str] = None,
    model_dir: Optional[str] = None,
):
    """Returns (aligner, metadata); metadata as in the reference
    (``{"language", "dictionary", "type"}``) plus ``random_weights``.
    ``device``: "cuda" (default; raises without a GPU), "cuda:N" or "cpu"."""
    from whisperx_tpu_torch.convert.checkpoint import read_checkpoint, wav2vec2_from_numpy
    from whisperx_tpu_torch.models.whisper import resolve_device

    dev = resolve_device(device)
    if model_name is None:
        if language_code in DEFAULT_ALIGN_MODELS_TORCH:
            model_name = DEFAULT_ALIGN_MODELS_TORCH[language_code]
        elif language_code in DEFAULT_ALIGN_MODELS_HF:
            model_name = DEFAULT_ALIGN_MODELS_HF[language_code]
        else:
            raise ValueError(
                f"No default align-model for language: {language_code}. "
                "Convert a wav2vec2 checkpoint and pass --align_model."
            )

    ckpt_path = _find_checkpoint(language_code, model_name, model_dir)
    if ckpt_path is not None:
        flat, cfg_json = read_checkpoint(ckpt_path)
        model = wav2vec2_from_numpy(flat, config_from_json(cfg_json["config"]), device=dev)
        dictionary = {k.lower(): v for k, v in cfg_json["dictionary"].items()}
        aligner = Wav2Vec2Aligner(model, dictionary, language=language_code, name=model_name)
    else:
        warnings.warn(
            f"No converted wav2vec2 checkpoint for {model_name!r}; using "
            "RANDOM weights (alignment output will be structurally valid "
            "but timings meaningless). Convert one with python -m "
            "whisperx_tpu_torch.convert wav2vec2.",
            stacklevel=2,
        )
        gen = torch.Generator(device=dev).manual_seed(0)
        aligner = Wav2Vec2Aligner(
            init_params(TEST_CONFIG, gen), dict(DEFAULT_EN_VOCAB),
            language=language_code, name=f"{model_name}-random",
        )

    metadata = {
        "language": language_code,
        "dictionary": aligner.dictionary,
        "type": "torch",
        # callers (the CLI) skip alignment rather than emit garbage timings
        "random_weights": aligner.name.endswith("-random"),
    }
    return aligner, metadata

"""The system under test, set up through the port's public API: the seeded
weights handed to ``convert.checkpoint.params_from_numpy`` (the JAX
package's flat layout, as a converted checkpoint is read), the energy VAD of
``vad.load_vad_model`` and a ``TranscriptionPipeline`` with the options the
configuration states. A configuration with an ``align`` section also has
its aligner loaded as a user loads a converted one: the seeded wav2vec2
weights written with ``convert.checkpoint.save_checkpoint`` (with the
section's config and dictionary) into the run's temporary directory, then
``alignment.load_align_model`` from there."""

from __future__ import annotations

import os
import sys

from harness import spec


def _import_path() -> None:
    """The port is imported from the checkout the benchmark runs in."""
    root = spec.root()
    if root not in sys.path:
        sys.path.insert(0, root)


def pipeline_options(config: dict, workload: dict) -> dict:
    """The pipeline's ASR options: the configuration's, with the traffic's
    tokens per window; with ``suppress_byte_tokens`` the ids 0-255, and
    with ``suppress_timestamp_tokens`` <|notimestamps|> and every timestamp
    token, added to ``suppress_tokens``."""
    from reference.rules import Specials

    opts = dict(config["asr_options"])
    opts["temperatures"] = tuple(opts["temperatures"])
    opts["sample_len"] = int(workload["params"]["sample_len"])
    ids = list(range(256)) if config.get("suppress_byte_tokens") else []
    if config.get("suppress_timestamp_tokens"):
        ids += range(Specials.of(config).no_timestamps, int(config["n_vocab"]))
    if ids:
        opts["suppress_tokens"] = ",".join([str(opts["suppress_tokens"])] + [str(t) for t in ids])
    return opts


def build(config: dict, workload: dict, weights: dict, device, vocab_path: str):
    """A ``TranscriptionPipeline`` over ``weights`` (``params.make_weights``)."""
    _import_path()
    import torch

    from whisperx_tpu_torch.asr import TranscriptionPipeline
    from whisperx_tpu_torch.convert.checkpoint import params_from_numpy
    from whisperx_tpu_torch.models.whisper import ModelDimensions
    from whisperx_tpu_torch.vad import load_vad_model

    from reference.params import dims_of

    flat = {name: t.float().cpu().numpy() for name, t in weights.items()}
    weights.clear()
    model = params_from_numpy(flat, ModelDimensions(**dims_of(config)), getattr(torch, config["dtype"]),
                              device, name=config["name"], vocab_path=vocab_path)
    del flat
    vad_opts = config["vad"]
    vad = load_vad_model(vad_opts["method"], vad_onset=vad_opts["onset"], vad_offset=vad_opts["offset"],
                         chunk_size=vad_opts["chunk_size"], device=device)
    return TranscriptionPipeline(
        model=model.eval(),
        vad_model=vad,
        asr_options=pipeline_options(config, workload),
        language=config["language"],
        batch_size=int(workload["params"]["batch_size"]),
    )


def aligner(config: dict, seed: int, device, directory: str):
    """``(aligner, metadata)`` of ``alignment.load_align_model`` over the
    configuration's seeded aligner weights (``params.make_align_weights``),
    written as a converted checkpoint under ``directory``."""
    _import_path()
    from whisperx_tpu_torch import alignment
    from whisperx_tpu_torch.convert.checkpoint import save_checkpoint

    from reference.params import align_dims, make_align_weights

    a = config["align"]
    dims = align_dims(config)
    dims.pop("conv_bias")  # the loader reads it from the weights' names
    flat = {name: t.cpu().numpy() for name, t in make_align_weights(config, seed, device).items()}
    save_checkpoint(os.path.join(directory, a["name"].replace("/", "__")), flat,
                    {"family": "wav2vec2", "name": a["name"], "config": dims, "dictionary": a["dictionary"]})
    del flat
    return alignment.load_align_model(config["language"], device, model_name=a["name"], model_dir=directory)


def loaded_top_level(names=("jax", "jaxlib", "flax", "whisperx_tpu")) -> list:
    """Of ``names``, those whose top-level module is in ``sys.modules``,
    compared whole (``whisperx_tpu_torch`` is not ``whisperx_tpu``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(names))


"""The port's converters against the JAX package's on the CPU: the same
seeded source (an HF Whisper directory in F16 safetensors or a
``pytorch_model.bin``, an OpenAI ``.pt``, the ``--quantize`` copies, an HF
wav2vec2 directory, a torchaudio bundle, Silero's ONNX file and hub model,
a pyannote and a wespeaker state dict) goes through ``whisperx_tpu.convert``
and ``whisperx_tpu_torch.convert``, and the two checkpoint directories must
be the same: ``weights.npz`` key for key in dtype and bits, ``config.json``
as JSON, ``vocab.tiktoken`` as bytes. The packages that only a conversion
route needs (``onnx``, ``torchaudio``, the network behind ``torch.hub``)
are stubs here. Also: the port's safetensors reader against the
``safetensors`` package; a converted test-nano checkpoint transcribing to
JAX's segments; ``profiler_trace``."""

import glob
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from conftest import synth_speech
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

WHISPER_CONFIG = {  # test-nano's dims
    "num_mel_bins": 80, "max_source_positions": 1500, "d_model": 64,
    "encoder_attention_heads": 2, "encoder_layers": 2, "vocab_size": 51865,
    "max_target_positions": 448, "decoder_attention_heads": 2, "decoder_layers": 2,
}


def _noise(rng, *shape, scale=0.05):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _hf_whisper_sd(seed=0):
    """An HF ``WhisperForConditionalGeneration`` state dict at test-nano's
    width (as ``tests/test_convert.py`` builds one; layer norms near 1, so
    the random model speaks)."""
    rng = np.random.default_rng(seed)
    c = WHISPER_CONFIG
    d, mels, vocab = c["d_model"], c["num_mel_bins"], c["vocab_size"]
    sd = {
        "model.encoder.conv1.weight": _noise(rng, d, mels, 3),
        "model.encoder.conv1.bias": _noise(rng, d),
        "model.encoder.conv2.weight": _noise(rng, d, d, 3),
        "model.encoder.conv2.bias": _noise(rng, d),
        "model.encoder.embed_positions.weight": _noise(rng, 1500, d),
        "model.decoder.embed_tokens.weight": _noise(rng, vocab, d, scale=0.5),
        "model.decoder.embed_positions.weight": _noise(rng, 448, d),
    }

    def ln(prefix):
        sd[f"{prefix}.weight"] = 1 + _noise(rng, d)
        sd[f"{prefix}.bias"] = _noise(rng, d)

    def attn(prefix):
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{prefix}.{proj}.weight"] = _noise(rng, d, d, scale=0.2)
            if proj != "k_proj":
                sd[f"{prefix}.{proj}.bias"] = _noise(rng, d)

    ln("model.encoder.layer_norm")
    ln("model.decoder.layer_norm")
    for i in range(c["encoder_layers"]):
        for side, cross in (("encoder", False), ("decoder", True)):
            p = f"model.{side}.layers.{i}"
            attn(f"{p}.self_attn")
            ln(f"{p}.self_attn_layer_norm")
            if cross:
                attn(f"{p}.encoder_attn")
                ln(f"{p}.encoder_attn_layer_norm")
            sd[f"{p}.fc1.weight"] = _noise(rng, 4 * d, d, scale=0.2)
            sd[f"{p}.fc1.bias"] = _noise(rng, 4 * d)
            sd[f"{p}.fc2.weight"] = _noise(rng, d, 4 * d, scale=0.1)
            sd[f"{p}.fc2.bias"] = _noise(rng, d)
            ln(f"{p}.final_layer_norm")
    return sd


def _byte_tokens():
    """GPT-2's printable stand-in character of each byte."""
    bs = list(range(33, 127)) + list(range(161, 173)) + list(range(174, 256))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return [chr(c) for _, c in sorted(zip(bs, cs))]


def _hf_whisper_dir(root, fmt="bin", vocab=False):
    """An HF Whisper directory: ``fmt`` "bin" (f32 ``pytorch_model.bin``,
    without the encoder's positions: the converter's sinusoids), "f16" (F16
    ``model.safetensors``, as published) or "bf16"; ``vocab``: a small
    ``vocab.json`` + ``merges.txt`` (the bytes, some merges, the special
    tokens)."""
    from safetensors.torch import save_file

    src = root / f"hf_{fmt}"
    src.mkdir()
    sd = {k: torch.from_numpy(v) for k, v in _hf_whisper_sd().items()}
    if fmt == "bin":
        del sd["model.encoder.embed_positions.weight"]
        torch.save(sd, src / "pytorch_model.bin")
    else:
        dtype = {"f16": torch.float16, "bf16": torch.bfloat16}[fmt]
        save_file({k: v.to(dtype) for k, v in sd.items()}, str(src / "model.safetensors"))
    (src / "config.json").write_text(json.dumps(WHISPER_CONFIG))
    (src / "generation_config.json").write_text(json.dumps({"alignment_heads": [[1, 0], [1, 1]]}))
    if vocab:
        tokens = _byte_tokens()
        tokens += [tokens[i] + tokens[j] for i, j in ((72, 101), (108, 108), (32, 116))]
        table = {t: i for i, t in enumerate(tokens)}
        table.update({"<|endoftext|>": len(tokens), "<|startoftranscript|>": len(tokens) + 1})
        (src / "vocab.json").write_text(json.dumps(table))
        (src / "merges.txt").write_text("#version: 0.2\nH e\nl l\n")
    return str(src)


def _openai_pt(root):
    """An OpenAI ``.pt``: the HF weights under OpenAI's names."""
    sd = {}
    for k, v in _hf_whisper_sd(seed=1).items():
        k = k.removeprefix("model.")
        for hf, oa in (
            ("encoder.embed_positions.weight", "encoder.positional_embedding"),
            ("decoder.embed_positions.weight", "decoder.positional_embedding"),
            ("decoder.embed_tokens", "decoder.token_embedding"),
            ("encoder.layer_norm", "encoder.ln_post"), ("decoder.layer_norm", "decoder.ln"),
            (".layers.", ".blocks."), ("self_attn_layer_norm", "attn_ln"),
            ("encoder_attn_layer_norm", "cross_attn_ln"), ("self_attn.", "attn."),
            ("encoder_attn.", "cross_attn."), ("q_proj", "query"), ("k_proj", "key"),
            ("v_proj", "value"), ("out_proj", "out"), ("fc1", "mlp.0"), ("fc2", "mlp.2"),
            ("final_layer_norm", "mlp_ln"),
        ):
            k = k.replace(hf, oa)
        sd[k] = torch.from_numpy(v)
    c = WHISPER_CONFIG
    dims = {
        "n_mels": c["num_mel_bins"], "n_audio_ctx": 1500, "n_audio_state": c["d_model"],
        "n_audio_head": 2, "n_audio_layer": 2, "n_vocab": c["vocab_size"], "n_text_ctx": 448,
        "n_text_state": c["d_model"], "n_text_head": 2, "n_text_layer": 2,
    }
    path = root / "tiny.pt"
    torch.save({"dims": dims, "model_state_dict": sd}, path)
    return str(path)


def _hf_wav2vec2_sd(seed=2, d=64, inter=128, layers=2, vocab=32):
    """An HF ``Wav2Vec2ForCTC`` state dict (as ``tests/test_convert.py``),
    its positional convolution as torch's weight norm (weight_g, weight_v)."""
    rng = np.random.default_rng(seed)
    conv_dim, kernels = [32] * 7, [10, 3, 3, 3, 3, 2, 2]
    sd, d_in = {}, 1
    for i, (cd, k) in enumerate(zip(conv_dim, kernels)):
        sd[f"wav2vec2.feature_extractor.conv_layers.{i}.conv.weight"] = _noise(rng, cd, d_in, k)
        d_in = cd
    for name, n in (("feature_extractor.conv_layers.0.layer_norm", 32),
                    ("feature_projection.layer_norm", 32), ("encoder.layer_norm", d)):
        sd[f"wav2vec2.{name}.weight"] = 1 + _noise(rng, n)
        sd[f"wav2vec2.{name}.bias"] = _noise(rng, n)
    sd["wav2vec2.feature_projection.projection.weight"] = _noise(rng, d, 32)
    sd["wav2vec2.feature_projection.projection.bias"] = _noise(rng, d)
    sd["wav2vec2.encoder.pos_conv_embed.conv.weight_g"] = _noise(rng, 1, 1, 128)
    sd["wav2vec2.encoder.pos_conv_embed.conv.weight_v"] = _noise(rng, d, d // 16, 128)
    sd["wav2vec2.encoder.pos_conv_embed.conv.bias"] = _noise(rng, d)
    for i in range(layers):
        p = f"wav2vec2.encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{p}.attention.{name}.weight"] = _noise(rng, d, d)
            sd[f"{p}.attention.{name}.bias"] = _noise(rng, d)
        for name in ("layer_norm", "final_layer_norm"):
            sd[f"{p}.{name}.weight"] = 1 + _noise(rng, d)
            sd[f"{p}.{name}.bias"] = _noise(rng, d)
        sd[f"{p}.feed_forward.intermediate_dense.weight"] = _noise(rng, inter, d)
        sd[f"{p}.feed_forward.intermediate_dense.bias"] = _noise(rng, inter)
        sd[f"{p}.feed_forward.output_dense.weight"] = _noise(rng, d, inter)
        sd[f"{p}.feed_forward.output_dense.bias"] = _noise(rng, d)
    sd["lm_head.weight"] = _noise(rng, vocab, d)
    sd["lm_head.bias"] = _noise(rng, vocab)
    return sd


def _hf_wav2vec2_dir(root):
    src = root / "hf_w2v"
    src.mkdir()
    from safetensors.numpy import save_file

    save_file(_hf_wav2vec2_sd(), str(src / "model.safetensors"))
    (src / "config.json").write_text(json.dumps({
        "vocab_size": 32, "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 2,
        "intermediate_size": 128, "conv_dim": [32] * 7, "conv_kernel": [10, 3, 3, 3, 3, 2, 2],
        "conv_stride": [5, 2, 2, 2, 2, 2, 2], "num_conv_pos_embeddings": 128,
        "num_conv_pos_embedding_groups": 16, "do_stable_layer_norm": False,
        "feat_extract_norm": "group",
    }))
    (src / "vocab.json").write_text(json.dumps({"<pad>": 0, "|": 4, "e": 5}))
    return str(src)


def _stub_torchaudio(monkeypatch):
    """A ``torchaudio`` whose one bundle holds the HF wav2vec2 weights under
    torchaudio's names."""
    sd = {}
    for k, v in _hf_wav2vec2_sd(seed=3).items():
        k = k.removeprefix("wav2vec2.")
        for hf, ta in (
            ("feature_projection", "encoder.feature_projection"),
            ("encoder.pos_conv_embed", "encoder.transformer.pos_conv_embed"),
            ("encoder.layer_norm", "encoder.transformer.layer_norm"),
            ("encoder.layers", "encoder.transformer.layers"),
            ("lm_head", "aux"),
        ):
            if k.startswith(hf):
                k = ta + k[len(hf):]
                break
        sd[k] = torch.from_numpy(v)
    model = types.SimpleNamespace(state_dict=lambda: dict(sd))
    labels = tuple("-|ETAONISHRDLUMWGFCYPBVK'XJQZ") + ("1", "2", "3")
    bundle = types.SimpleNamespace(get_model=lambda: model, get_labels=lambda: labels)
    stub = types.ModuleType("torchaudio")
    stub.pipelines = types.SimpleNamespace(WAV2VEC2_STUB=bundle)
    monkeypatch.setitem(sys.modules, "torchaudio", stub)
    return "WAV2VEC2_STUB"


def _stub_onnx(monkeypatch, root):
    """An ``onnx`` that loads a Silero-shaped graph: two LSTM layers as ONNX
    W [1, 4H, in] / R [1, 4H, H] / B [1, 8H] in (i, o, f, c) gate order, and a
    [1, H] head with its [1] bias."""
    rng = np.random.default_rng(4)
    h, n_in = 16, 24
    inits = {}
    for layer, d_in in enumerate((n_in, h)):
        inits[f"lstm_{layer}.W"] = _noise(rng, 1, 4 * h, d_in)
        inits[f"lstm_{layer}.R"] = _noise(rng, 1, 4 * h, h)
        inits[f"lstm_{layer}.B"] = _noise(rng, 1, 8 * h)
    inits["decoder.weight"] = _noise(rng, 1, h)
    inits["decoder.bias"] = _noise(rng, 1)
    graph = types.SimpleNamespace(
        initializer=[types.SimpleNamespace(name=k, array=v) for k, v in inits.items()]
    )
    stub = types.ModuleType("onnx")
    stub.load = lambda path: types.SimpleNamespace(graph=graph)
    helper = types.ModuleType("onnx.numpy_helper")
    helper.to_array = lambda init: init.array
    stub.numpy_helper = helper
    monkeypatch.setitem(sys.modules, "onnx", stub)
    monkeypatch.setitem(sys.modules, "onnx.numpy_helper", helper)
    path = root / "silero_vad.onnx"
    path.write_bytes(b"")
    return str(path)


def _stub_hub(monkeypatch):
    """``torch.hub.load`` serving a Silero-shaped module: ``nn.LSTM`` of two
    layers and a [1, H] head."""
    torch.manual_seed(5)
    net = torch.nn.Module()
    net.lstm = torch.nn.LSTM(24, 16, num_layers=2)
    net.decoder = torch.nn.Linear(16, 1)
    monkeypatch.setattr(torch.hub, "load", lambda *a, **kw: (net, None))


def _pyannote_bin(root):
    """A pyannote segmentation ``pytorch_model.bin`` (as
    ``tests/test_pyannote.py`` builds one), under ``state_dict`` and the
    ``model.`` prefix."""
    rng = np.random.default_rng(6)
    h, d_lin, n_cls = 16, 16, 3
    sd = {
        "sincnet.conv1d.0.low_hz_": np.abs(_noise(rng, 8, 1, scale=2000.0)),
        "sincnet.conv1d.0.band_hz_": np.abs(_noise(rng, 8, 1, scale=500.0)),
        "sincnet.wav_norm1d.weight": 1 + _noise(rng, 1),
        "sincnet.wav_norm1d.bias": _noise(rng, 1),
    }
    for i in range(3):
        sd[f"sincnet.norm1d.{i}.weight"] = 1 + _noise(rng, 8)
        sd[f"sincnet.norm1d.{i}.bias"] = _noise(rng, 8)
    for i in (1, 2):
        sd[f"sincnet.conv1d.{i}.weight"] = _noise(rng, 8, 8, 5)
    for layer, d_in in enumerate((8, 2 * h)):
        for suffix in ("", "_reverse"):
            sd[f"lstm.weight_ih_l{layer}{suffix}"] = _noise(rng, 4 * h, d_in)
            sd[f"lstm.weight_hh_l{layer}{suffix}"] = _noise(rng, 4 * h, h)
            sd[f"lstm.bias_ih_l{layer}{suffix}"] = _noise(rng, 4 * h)
            sd[f"lstm.bias_hh_l{layer}{suffix}"] = _noise(rng, 4 * h)
    sd["linear.0.weight"], sd["linear.0.bias"] = _noise(rng, d_lin, 2 * h), _noise(rng, d_lin)
    sd["classifier.weight"], sd["classifier.bias"] = _noise(rng, n_cls, d_lin), _noise(rng, n_cls)
    src = root / "pyannote"
    src.mkdir()
    torch.save(
        {"state_dict": {f"model.{k}": torch.from_numpy(v) for k, v in sd.items()}},
        src / "pytorch_model.bin",
    )
    return str(src)


def _wespeaker_pt(root):
    """A wespeaker ResNet state dict under ``model.``: a 3×3 stem, one block
    a stage (a downsampling shortcut where the width changes), ``seg_1``."""
    rng = np.random.default_rng(7)
    sd = {}

    def bn(prefix, c):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = 1 + _noise(rng, c), _noise(rng, c)
        sd[f"{prefix}.running_mean"] = _noise(rng, c)
        sd[f"{prefix}.running_var"] = 1 + np.abs(_noise(rng, c))

    sd["conv1.weight"] = _noise(rng, 4, 1, 3, 3)
    bn("bn1", 4)
    c_in = 4
    for stage, c in enumerate((4, 8, 8, 8), start=1):
        p = f"layer{stage}.0"
        sd[f"{p}.conv1.weight"] = _noise(rng, c, c_in, 3, 3)
        bn(f"{p}.bn1", c)
        sd[f"{p}.conv2.weight"] = _noise(rng, c, c, 3, 3)
        bn(f"{p}.bn2", c)
        if c != c_in:
            sd[f"{p}.downsample.0.weight"] = _noise(rng, c, c_in, 1, 1)
            bn(f"{p}.downsample.1", c)
        c_in = c
    sd["seg_1.weight"], sd["seg_1.bias"] = _noise(rng, 16, 8 * 10 * 2), _noise(rng, 16)
    path = root / "wespeaker.pt"
    torch.save({f"model.{k}": torch.from_numpy(v) for k, v in sd.items()}, path)
    return str(path)


def _main(monkeypatch, package, *argv):
    """One package's ``python -m <package>.convert`` in-process."""
    if package == "whisperx_tpu":
        from whisperx_tpu.convert.__main__ import main
    else:
        from whisperx_tpu_torch.convert.__main__ import main
    monkeypatch.setattr(sys, "argv", [f"{package}.convert", *argv])
    main()


def _source(case, root, monkeypatch):
    """The case's seeded source → (JAX's converter, the port's, their
    arguments before ``out``, the checkpoints written: suffixes of ``out``)."""
    from whisperx_tpu.convert import pyannote as jp, silero as js, wav2vec2_hf as jv
    from whisperx_tpu.convert import wespeaker as jk, whisper_hf as jw
    from whisperx_tpu_torch.convert import pyannote as tp, silero as ts, wav2vec2_hf as tv
    from whisperx_tpu_torch.convert import wespeaker as tk, whisper_hf as tw

    if case.startswith("whisper-quantize"):
        mode = case.rsplit("-", 1)[1]
        src = _hf_whisper_dir(root, "f16", vocab=True)

        def run(package, *extra):
            return lambda out: _main(
                monkeypatch, package, "whisper", "--src", src, "--out", out, "--quantize", mode, *extra
            )

        return run("whisperx_tpu"), run("whisperx_tpu_torch"), [], ["", f"-{mode}"]
    if case.startswith("whisper-hf-safetensors"):
        fmt = case.rsplit("-", 1)[1]
        fns, args = "convert_hf_whisper", [_hf_whisper_dir(root, fmt, vocab=True)]
    elif case == "whisper-hf-bin":
        fns, args = "convert_hf_whisper", [_hf_whisper_dir(root, "bin")]
    elif case == "whisper-openai-pt":
        fns, args = "convert_openai_whisper", [_openai_pt(root)]
    elif case == "wav2vec2-hf":
        fns, args = "convert_hf_wav2vec2", [_hf_wav2vec2_dir(root)]
    elif case == "wav2vec2-torchaudio":
        fns, args = "convert_torchaudio_wav2vec2", [_stub_torchaudio(monkeypatch)]
    elif case == "silero-onnx":
        fns, args = "convert_silero_onnx", [_stub_onnx(monkeypatch, root)]
    elif case == "silero-hub":
        _stub_hub(monkeypatch)
        fns, args = "convert_silero_torch", []
    elif case == "pyannote":
        fns, args = "convert_pyannote_segmentation", [_pyannote_bin(root)]
    else:
        fns, args = "convert_wespeaker_resnet", [_wespeaker_pt(root)]
    family = case.split("-")[0]
    jax_mod, port_mod = {
        "whisper": (jw, tw), "wav2vec2": (jv, tv), "silero": (js, ts),
        "pyannote": (jp, tp), "wespeaker": (jk, tk),
    }[family]
    return getattr(jax_mod, fns), getattr(port_mod, fns), args, [""]


CASES = (
    "whisper-hf-safetensors-f16", "whisper-hf-safetensors-bf16", "whisper-hf-bin",
    "whisper-openai-pt",
    "whisper-quantize-int8", "whisper-quantize-int4", "wav2vec2-hf", "wav2vec2-torchaudio",
    "silero-onnx", "silero-hub", "pyannote", "wespeaker",
)


def _checkpoint(path):
    with np.load(os.path.join(path, "weights.npz")) as data:
        weights = {k: data[k] for k in data.files}
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    vocab = os.path.join(path, "vocab.tiktoken")
    return weights, config, open(vocab, "rb").read() if os.path.exists(vocab) else None


def _same_checkpoint(got_dir, want_dir):
    """``weights.npz`` key for key in dtype, shape and bits; ``config.json``
    as JSON; ``vocab.tiktoken`` as bytes (or absent from both)."""
    want, got = _checkpoint(want_dir), _checkpoint(got_dir)
    assert sorted(got[0]) == sorted(want[0])
    for k, w in want[0].items():
        g = got[0][k]
        assert (g.dtype, g.shape) == (w.dtype, w.shape), k
        assert g.tobytes() == w.tobytes(), k
    assert got[1] == want[1]
    assert got[2] == want[2]
    return want


@pytest.mark.parametrize("case", CASES)
def test_converted_checkpoint_is_jax_bit_for_bit(tmp_path, monkeypatch, case):
    """The port writes JAX's checkpoint for the same source. The
    ``--quantize`` cases run each package's ``main()``: the bf16 load, the
    int8/int4 codes, the f32 scales and the f32-widened full-precision
    weights of ``<out>-<mode>`` are JAX's to the bit. A BF16 source is
    widened to f32, as JAX's ``save_checkpoint`` widens ml-dtypes'
    bfloat16."""
    jax_convert, port_convert, args, suffixes = _source(case, tmp_path, monkeypatch)
    jax_convert(*args, str(tmp_path / "jax"))
    port_convert(*args, str(tmp_path / "torch"))
    for suffix in suffixes:
        weights, config, vocab = _same_checkpoint(
            str(tmp_path / "torch") + suffix, str(tmp_path / "jax") + suffix
        )
    if case.startswith("whisper-hf-safetensors"):
        assert vocab and config["alignment_heads"] == [[1, 0], [1, 1]]
        want = np.float16 if case.endswith("-f16") else np.float32
        assert {w.dtype for w in weights.values()} == {np.dtype(want)}
    if case.startswith("whisper-quantize"):
        assert vocab and any("__quantized_linear__" in k for k in weights)


def test_numpy_tree_save_is_jax_bit_for_bit(tmp_path):
    """A numpy tree with empty containers and a bf16 leaf (ml_dtypes'):
    the same ``weights.npz`` as JAX's ``save_checkpoint`` (bf16 widened to
    f32, the empty markers kept), read back with its empty containers."""
    import ml_dtypes

    from whisperx_tpu.convert.checkpoint import save_checkpoint as jax_save
    from whisperx_tpu_torch.convert.checkpoint import read_checkpoint, save_checkpoint, unflatten_tree

    params = {
        "a": np.ones((2, 2), np.float32),
        "linear": [],
        "empty_cfg": {},
        "nested": {"items": [], "w": np.arange(3, dtype=np.float32).astype(ml_dtypes.bfloat16)},
        "n": np.asarray(3),
    }
    jax_save(str(tmp_path / "jax"), params, {"family": "test"})
    save_checkpoint(str(tmp_path / "torch"), params, {"family": "test"})
    weights, _, _ = _same_checkpoint(str(tmp_path / "torch"), str(tmp_path / "jax"))
    assert weights["nested/w"].dtype == np.float32
    tree = unflatten_tree(read_checkpoint(str(tmp_path / "torch"))[0])
    assert tree["linear"] == [] and tree["empty_cfg"] == {} and tree["nested"]["items"] == []


def test_safetensors_reader_matches_the_package(tmp_path):
    """Every dtype ``safetensors.numpy.load_file`` reads, an empty tensor
    and a scalar: the same names, order, dtypes, shapes and values. BF16,
    which the package reads as ``ml_dtypes.bfloat16`` once JAX has loaded
    ml-dtypes (as JAX's converters have), comes back widened to f32 with
    the same values; an F8 tensor raises a ``TypeError`` naming it."""
    from safetensors.numpy import load_file as package_load
    from safetensors.numpy import save_file
    from safetensors.torch import save_file as torch_save

    from whisperx_tpu_torch.convert.safetensors import load_file

    rng = np.random.default_rng(8)
    arrays = {
        f"t_{np.dtype(code).name}": (rng.standard_normal((3, 5)) * 100).astype(code)
        for code in ("f8", "f4", "f2", "i8", "i4", "i2", "i1", "u8", "u4", "u2", "u1", "?")
    }
    arrays["empty"] = np.zeros((0, 4), np.float32)
    arrays["scalar"] = np.asarray(3.5, np.float32)
    path = str(tmp_path / "all.safetensors")
    save_file(arrays, path)
    want, got = package_load(path), load_file(path)
    assert list(got) == list(want)
    for k, w in want.items():
        assert (got[k].dtype, got[k].shape) == (w.dtype, w.shape), k
        assert got[k].tobytes() == w.tobytes(), k

    bf16 = str(tmp_path / "bf16.safetensors")
    torch_save({"w": torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32)).bfloat16()}, bf16)
    want, got = package_load(bf16)["w"], load_file(bf16)["w"]
    assert want.dtype.name == "bfloat16" and got.dtype == np.float32
    assert got.tobytes() == want.astype(np.float32).tobytes()
    f8 = str(tmp_path / "f8.safetensors")
    torch_save({"ok": torch.zeros(2), "decoder.w": torch.zeros(2, dtype=torch.float8_e4m3fn)}, f8)
    with pytest.raises(TypeError, match=r"'decoder\.w' is F8_E4M3"):
        load_file(f8)


def test_converted_checkpoint_transcribes_as_jax(tmp_path):
    """The whole slice on test-nano: one HF source converted by each
    package and loaded by each (f32, CPU, energy VAD) transcribes 8 s of
    speech to the same segments; the port's checkpoint carries the HF
    alignment heads into the model."""
    import whisperx_tpu
    import whisperx_tpu_torch
    from whisperx_tpu.convert.whisper_hf import convert_hf_whisper as jax_convert
    from whisperx_tpu_torch.convert.whisper_hf import convert_hf_whisper

    src = _hf_whisper_dir(tmp_path, "bin")
    jax_convert(src, str(tmp_path / "jax"))
    convert_hf_whisper(src, str(tmp_path / "torch"))
    audio = synth_speech(8.0, seed=3)
    kw = dict(device="cpu", compute_type="float32", vad_method="energy")
    options = dict(language="en", temperatures=(0.0,), sample_len=24)
    want = whisperx_tpu.load_model(str(tmp_path / "jax"), **kw).transcribe(audio, **options)
    pipe = whisperx_tpu_torch.load_model(str(tmp_path / "torch"), **kw)
    got = pipe.transcribe(audio, **options)
    assert got == want and got["segments"], (got, want)
    assert pipe.model.alignment_heads == [(1, 0), (1, 1)] and pipe.model.name == "hf_bin"


@pytest.mark.parametrize("where", ["log_dir", "default"])
def test_profiler_trace_writes_a_chrome_trace(where, tmp_path, monkeypatch):
    """``profiler_trace`` on the CPU: one Chrome trace in ``log_dir`` whose
    events name the block's aten operations. Without ``log_dir`` the trace
    goes under the temporary directory (``TMPDIR``), not a fixed path."""
    import tempfile

    from whisperx_tpu_torch.utils.metrics import profiler_trace

    if where == "default":
        monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
        ctx = profiler_trace()
    else:
        ctx = profiler_trace(str(tmp_path / "trace"))
    with ctx as log_dir:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert log_dir == str(tmp_path / ("trace" if where == "log_dir" else "whisperx_tpu_torch_trace"))
    (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names or "aten::matmul" in names, sorted(map(str, names))[:20]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_package_level_names_read_the_other_packages_checkpoints(writer, tmp_path):
    """``whisperx_tpu_torch.convert`` re-exports the checkpoint API, as
    ``whisperx_tpu.convert`` does: a test-nano checkpoint written by either
    package's ``save_checkpoint`` loads through the other's package-level
    ``load_checkpoint`` with the same weights and config."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import whisperx_tpu.convert as jconvert
    import whisperx_tpu_torch.convert as tconvert
    from whisperx_tpu.convert.checkpoint import flatten_tree as jflatten
    from whisperx_tpu.models.whisper.config import MODEL_DIMS
    from whisperx_tpu.models.whisper.model import init_params
    from whisperx_tpu_torch.convert.checkpoint import flatten_tree, params_from_numpy

    dims = MODEL_DIMS["test-nano"]
    config = {"name": "test-nano", "family": "whisper", "dims": dataclasses.asdict(dims)}
    params = init_params(dims, jax.random.PRNGKey(0), dtype=jnp.float32)
    want = {k: np.asarray(v) for k, v in jflatten(params).items()}
    path = str(tmp_path / writer)
    if writer == "jax":
        jconvert.save_checkpoint(path, params, config)
    else:
        tconvert.save_checkpoint(path, params_from_numpy(want, dims, torch.float32, "cpu"), config)
    assert tconvert.is_checkpoint_dir(path) and jconvert.is_checkpoint_dir(path)
    model, got_config = tconvert.load_checkpoint(path, torch.float32, "cpu")
    assert got_config == config
    got = flatten_tree(model)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tree, jconfig = jconvert.load_checkpoint(path)
    assert jconfig == config
    for k, v in jflatten(tree).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_load_checkpoint_builds_whisper_only(tmp_path):
    """The port's ``load_checkpoint`` builds a ``Whisper`` (JAX's returns
    any family's raw tree): another family's directory raises, naming it,
    and ``read_checkpoint`` gives its flat weights and config."""
    from whisperx_tpu_torch.convert import load_checkpoint, read_checkpoint, save_checkpoint

    path = str(tmp_path / "w2v")
    save_checkpoint(path, {"proj": {"w": np.ones((2, 3), np.float32)}}, {"family": "wav2vec2"})
    with pytest.raises(ValueError, match="'wav2vec2' checkpoint"):
        load_checkpoint(path, torch.float32, "cpu")
    flat, config = read_checkpoint(path)
    assert config == {"family": "wav2vec2"} and flat["proj/w"].shape == (2, 3)

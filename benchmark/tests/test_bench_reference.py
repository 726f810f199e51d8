"""The plain reference against the port at test-nano on the CPU: the front
end (energy VAD, merge, log-mel), the float32 model (encoder, int8
cross-KV, teacher-forced decoder), the decoding rules, and, end to end, a
run whose served tokens the reference reads back at a gap of rounding."""

import numpy as np
import pytest
import torch

import nano
from reference import frontend, params, rules
from reference.whisper import Model


@pytest.fixture(scope="module")
def audio():
    return nano.pool(60.0)[: 50 * 16000]


def test_vad_and_merge_equal_the_ports(audio):
    from whisperx_tpu_torch.vad import EnergyVAD, merge_chunks

    vad = EnergyVAD()
    np.testing.assert_array_equal(frontend.energy_probs(audio), vad.speech_probs(audio))
    segs = vad({"waveform": torch.from_numpy(audio), "sample_rate": 16000, "length": len(audio)},
               max_speech_duration_s=30)
    want = [(c["start"], c["end"]) for c in merge_chunks(segs, 30, onset=0.5, offset=0.363)]
    assert frontend.chunks_of(audio) == want and len(want) >= 2


def test_log_mel_matches_the_ports(audio):
    from whisperx_tpu_torch.audio.device_chunk import chunk_mels, upload_audio

    chunks = frontend.chunks_of(audio)
    ref = frontend.log_mel(torch.from_numpy(frontend.window_rows(audio, chunks)), 80)
    got = chunk_mels(upload_audio(audio, "cpu"), [{"start": s, "end": e} for s, e in chunks], 80)
    assert ref.shape == got.shape
    assert float((ref - got).abs().max()) < 2e-4


def _port_model(weights, cfg):
    from whisperx_tpu_torch.convert.checkpoint import params_from_numpy
    from whisperx_tpu_torch.models.whisper import ModelDimensions

    flat = {k: v.numpy() for k, v in weights.items()}
    return params_from_numpy(flat, ModelDimensions(**params.dims_of(cfg)), torch.float32, "cpu")


def test_model_matches_the_ports_forward():
    from whisperx_tpu_torch.models.whisper.model import (KVCache, decoder_forward, encoder_forward,
                                                         new_self_cache, precompute_cross_kv, quantize_kv)

    cfg = nano.config()
    w = {k: v.float() for k, v in params.make_weights(cfg, 5, torch.device("cpu")).items()}
    ref = Model(w, params.dims_of(cfg))
    port = _port_model(w, cfg)
    mel = torch.randn(2, 3000, 80, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        f_ref, f_port = ref.encode(mel), encoder_forward(port.encoder, mel, 2)
        assert float((f_ref - f_port).abs().max()) < 1e-4
        cross = ref.cross_kv(f_ref)
        ks, vs = precompute_cross_kv(port.decoder, f_ref, 2)
        k8 = quantize_kv(ks[0])
        np.testing.assert_allclose((k8.q8.float() * k8.scale).reshape(2, 1500, 64), cross[0][0], atol=1e-6)
        toks = torch.tensor([list(rules.Specials.of(cfg).initial) + [50400, 300, 50410]] * 2)
        cache = KVCache(*new_self_cache(port.decoder, 2, 64, 2), [quantize_kv(k) for k in ks],
                        [quantize_kv(v) for v in vs])
        got = decoder_forward(port.decoder, toks, cache, 0, 2)
        want = ref.logits(toks, cross)
        assert float((got - want).abs().max()) < 1e-4


def test_hard_rules_equal_the_ports_filters():
    from whisperx_tpu_torch.decoding import filters as F

    cfg = nano.config()
    cfg["asr_options"] = {**cfg["asr_options"], "without_timestamps": False}  # the timestamp rules
    sp = rules.Specials.of(cfg)
    seq = list(sp.initial) + [sp.timestamp_begin + 10, 500, sp.timestamp_begin + 40,
                              sp.timestamp_begin + 40, 700, 800, sp.timestamp_begin + 90]
    n_init, n = len(sp.initial), len(seq) - len(sp.initial)
    logits = torch.randn(n, 51865, generator=torch.Generator().manual_seed(1))
    mine = rules.hard_masked(logits, seq, n_init, sp)
    state = F.init_filter_state(torch.tensor([seq[:n_init]]))
    sup = F._id_mask(51865, sp.suppress, "cpu")
    blank = F._id_mask(51865, sp.blank + (sp.eot,), "cpu")
    for j in range(n):
        x = F.suppress_blank(logits[j:j + 1].clone(), state, blank)
        x = F.suppress_tokens(x, sup)
        x = F.apply_timestamp_rules(x, state, timestamp_begin=sp.timestamp_begin, eot=sp.eot,
                                    no_timestamps=sp.no_timestamps, max_initial_timestamp_index=50)
        forced = torch.isinf(x[0, : sp.timestamp_begin]).all() and not torch.isinf(mine[j, : sp.timestamp_begin]).all()
        same = torch.isinf(x[0]) == torch.isinf(mine[j])
        assert bool(same.all()) or bool(forced), j  # the soft rule is ``gaps``'s, not the mask's
        state = F.update_filter_state(state, torch.tensor([seq[n_init + j]]), sp.timestamp_begin)


def test_hard_rules_without_timestamps_equal_the_ports_filters(tmp_path):
    from whisperx_tpu_torch.decoding import filters as F
    from whisperx_tpu_torch.decoding.tokenizer import get_tokenizer

    from harness import program, vocab

    cfg = nano.config()
    sp = rules.Specials.of(cfg)
    tok = get_tokenizer(True, num_languages=99, language="en", task="transcribe",
                        vocab_path=vocab.write(str(tmp_path / "vocab.json")))
    assert tuple(tok.encode(" ")) == sp.blank
    suppress = F.build_suppress_list(tok, program.pipeline_options(cfg, nano.workload("offline"))["suppress_tokens"])
    assert suppress == sp.suppress
    seq = list(sp.initial) + [500, 700, 800]
    logits = torch.randn(3, 51865, generator=torch.Generator().manual_seed(1))
    mine = rules.hard_masked(logits, seq, len(sp.initial), sp)
    state = F.init_filter_state(torch.tensor([seq[:len(sp.initial)]]))
    for j in range(3):
        x = F.suppress_blank(logits[j:j + 1].clone(), state, F._id_mask(51865, sp.blank + (sp.eot,), "cpu"))
        x = F.suppress_tokens(x, F._id_mask(51865, suppress, "cpu"))
        assert bool((torch.isinf(x[0]) == torch.isinf(mine[j])).all()), j
        state = F.update_filter_state(state, torch.tensor([seq[len(sp.initial) + j]]), sp.timestamp_begin)


@pytest.mark.parametrize("kind", ["offline", "serve"])
def test_a_sound_run_reads_back_its_tokens_at_rounding(kind):
    out = nano.run(kind)
    assert out["correct"], out["checks"]
    assert out["extra"]["deepest"] >= nano.workload(kind)["params"]["sample_len"]  # every position
    assert out["checks"]["off_grid"]["value"] == 0 and out["checks"]["empty_windows"]["value"] == 0


def test_served_text_reads_back_each_windows_tokens():
    from harness import check

    chunks = [(1.0, 11.0), (20.0, 23.31)]
    txt = lambda *ids: "".join(chr(0xF0000 + i) for i in ids)
    segs = [
        {"start": 1.0, "end": 11.0, "text": txt(500, 600)},
        {"start": 20.0, "end": 23.31, "text": txt(900)},
        {"start": 20.0, "end": 23.31, "text": txt(1000)},  # the same window twice: off
        {"start": 12.0, "end": 13.0, "text": txt(2000)},  # spans no window: off
    ]
    per, off = check.served_text(segs, chunks)
    assert per == {0: [500, 600], 1: [900]} and off == 2


def test_served_tokens_read_back_clamped_and_ambiguous_ends():
    from harness import check

    sp = rules.Specials.of(nano.config())
    ts = sp.timestamp_begin
    chunks = [(1.0, 11.0), (20.0, 23.31)]
    txt = lambda *ids: "".join(chr(0xF0000 + i) for i in ids)
    segs = [
        {"start": 1.0, "end": 3.0, "text": txt(500)},  # [ts+0 500 ts+100]
        {"start": 3.0, "end": 11.0, "text": txt(600, 700)},  # ends at the window's end, on the grid
        {"start": 11.0, "end": 11.0, "text": txt(800)},  # follows: that end was real
        {"start": 20.06, "end": 23.31, "text": txt(900)},  # clamped, off the grid
        {"start": 23.0, "end": 23.31, "text": txt(1000)},  # after a clamped end: off
    ]
    per, off = check.served_tokens(segs, chunks, sp)
    assert per[0] == [ts, 500, ts + 100, ts + 100, 600, 700, ts + 500, ts + 500, 800]
    assert per[1] == [ts + 3, 900]
    assert off == 1

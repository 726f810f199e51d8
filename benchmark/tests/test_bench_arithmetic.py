"""The benchmark's arithmetic: FLOP counts from the dimensions, K1's bound,
the union of device intervals and the idle gaps, percentiles over all
requests with failures counted as missing, and the offline rate."""

import math

import pytest

from harness import flops, stats, trace

NANO = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
            n_vocab=51865, n_text_ctx=448, n_text_state=64, n_text_head=2, n_text_layer=2)


def _gemm(m, k, n):
    return 2 * m * k * n


def test_encoder_flops_count_every_product():
    d = NANO
    t, w = 1500, 64
    want = _gemm(3000, 3 * 80, w) + _gemm(1500, 3 * w, w)
    per_block = 4 * _gemm(t, w, w) + _gemm(t, w, 4 * w) + _gemm(t, 4 * w, w) + 2 * _gemm(t, w, t)
    want += 2 * per_block
    assert flops.encoder_flops(d) == want


def test_decode_flops_count_positions_and_logits():
    d = NANO
    w, n = 64, 5
    want = 0
    for p in range(n):
        per_layer = 6 * _gemm(1, w, w) + _gemm(1, w, 4 * w) + _gemm(1, 4 * w, w)
        per_layer += 2 * _gemm(1, w, p + 1) + 2 * _gemm(1, w, 1500)
        want += 2 * per_layer + _gemm(1, w, 51865)
    assert flops.decode_flops(d, n) == pytest.approx(want)
    assert flops.cross_kv_flops(d) == 2 * 2 * _gemm(1500, w, w)


def test_k1_bound_is_the_larger_of_operations_and_bytes():
    big = dict(NANO, n_audio_state=1280, n_audio_head=20)
    ops = 4 * 16 * 20 * 1500 * 1500 * 64 / 989e12
    nbytes = 4 * 16 * 20 * 1500 * 64 * 2 / 3.35e12
    assert flops.k1_bound_s(big, 16) == pytest.approx(max(ops, nbytes))
    assert ops > nbytes


def test_union_and_idle_gaps():
    busy = trace.union([(5, 7), (0, 2), (1, 3), (6, 9)])
    assert busy == [(0, 3), (5, 9)]
    assert trace.gaps(busy, 0, 12) == [(3, 5), (9, 12)]


def test_summary_names_gaps_by_host_event():
    ev = [
        {"name": trace.SLICE, "cat": "user_annotation", "ts": 0, "dur": 100},
        {"name": "k", "cat": "kernel", "ts": 10, "dur": 30},
        {"name": "k", "cat": "kernel", "ts": 20, "dur": 30},
        {"name": "c", "cat": "gpu_memcpy", "ts": 80, "dur": 40},
        {"name": "cudaStreamSynchronize", "cat": "cuda_runtime", "ts": 52, "dur": 20},
        {"name": "aten::nonzero", "cat": "cpu_op", "ts": 0, "dur": 9},
    ]
    s = trace.summarize(ev)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(60e-6)  # 10–50 and 80–100 (clipped)
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::nonzero"] == pytest.approx(10e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(30e-6)
    assert s["kernel_calls"] == {"k": 2}


def test_percentiles_count_failures_as_missing():
    reqs = [{"due": 0.0, "done": float(i)} for i in range(1, 20)] + [{"due": 0.0, "error": "x"}]
    lat = stats.latencies(reqs)
    assert lat[-1] == math.inf
    assert stats.percentile(lat, 50) == pytest.approx(10.5)
    assert stats.percentile(lat, 95) == math.inf  # the 20th of 20 is the failure
    assert stats.percentile(lat[:-1], 95) == pytest.approx(18.1)


def test_offline_rate_is_work_over_time_to_the_last_completion():
    assert stats.rate(300.0, 10.0, [12.0, 16.0, 15.0]) == pytest.approx(50.0)
    assert stats.rate(1.0, 10.0, []) is None

"""The benchmark's arithmetic: model FLOPs from the dimensions, K1's bound,
and the published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit)."""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
N_FRAMES = 3000  # mel frames of a 30 s window


def encoder_flops(d: dict) -> float:
    """One 30 s window through the encoder: the two convolutions, the
    blocks' products and the attention's QKᵀ and PV."""
    t, w = d["n_audio_ctx"], d["n_audio_state"]
    conv = 2 * 3 * d["n_mels"] * w * N_FRAMES + 2 * 3 * w * w * t
    block = 2 * t * 4 * w * w + 2 * t * 2 * 4 * w * w + 2 * 2 * t * t * w
    return conv + d["n_audio_layer"] * block


def cross_kv_flops(d: dict) -> float:
    """One window's cross-attention K and V, every decoder layer."""
    return d["n_text_layer"] * 2 * 2 * d["n_audio_ctx"] * d["n_audio_state"] * d["n_text_state"]


def decode_flops(d: dict, n_tokens: int) -> float:
    """One row's decoder passes over ``n_tokens`` positions (prefill and
    steps), the self-attention over the positions written so far, the
    cross-attention over every frame, and the logits."""
    w, v = d["n_text_state"], d["n_vocab"]
    per_token = d["n_text_layer"] * (2 * 6 * w * w + 2 * 2 * 4 * w * w + 2 * 2 * d["n_audio_ctx"] * w) + 2 * w * v
    keys = n_tokens * (n_tokens + 1) / 2  # Σ (p + 1) over positions p
    return n_tokens * per_token + d["n_text_layer"] * 2 * 2 * w * keys


def k1_bound_s(d: dict, batch: int) -> float:
    """K1's least time for one encoder layer's attention at ``batch`` rows:
    4·B·H·T²·Dh operations at the bf16 peak, or its q, k, v and output in
    bf16 at the memory rate, whichever is larger."""
    bh, t = batch * d["n_audio_head"], d["n_audio_ctx"]
    dh = d["n_audio_state"] // d["n_audio_head"]
    ops = 4 * bh * t * t * dh
    nbytes = 4 * bh * t * dh * 2
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)

"""Plain Whisper in float32: the encoder, the decoder run teacher-forced over
a whole token sequence with a causal mask (no cache, no batching of steps),
and the configuration's int8 cross-attention K/V.

The caller turns TF32 off. ``lowp=True`` is the control: every matrix
product of a linear layer (and the logits' product with the token
embedding) takes its operands rounded to float8 e4m3 with one scale per
tensor, as the common fp8 GEMM path does (``torch._scaled_mm`` with
tensor-wise scales); everything else stays float32.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Model:
    """The weights of ``params.make_weights`` and the forward passes."""

    def __init__(self, weights: Dict[str, torch.Tensor], dims: dict, lowp: bool = False):
        self.w, self.dims, self.lowp = weights, dims, lowp
        self._fp8_cache: Dict[str, torch.Tensor] = {}

    def _weight(self, name: str) -> torch.Tensor:
        w = self.w[name]
        if not self.lowp:
            return w
        if name not in self._fp8_cache:
            self._fp8_cache[name] = _fp8(w)
        return self._fp8_cache[name]

    def _matmul(self, x: torch.Tensor, name: str) -> torch.Tensor:
        if self.lowp:
            x = _fp8(x)
        return x @ self._weight(name)

    def linear(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        y = self._matmul(x, f"{prefix}/w")
        b = self.w.get(f"{prefix}/b")
        return y if b is None else y + b

    def ln(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.w[f"{prefix}/g"], self.w[f"{prefix}/b"], 1e-5)

    @staticmethod
    def attention(q, k, v, n_head: int, mask=None) -> torch.Tensor:
        """q [B, Tq, D], k/v [B, Tk, D] → [B, Tq, D], softmax(q·kᵀ/√dh)·v."""
        b, tq, d = q.shape
        dh = d // n_head
        q = q.view(b, tq, n_head, dh).transpose(1, 2)
        k = k.view(b, -1, n_head, dh).transpose(1, 2)
        v = v.view(b, -1, n_head, dh).transpose(1, 2)
        s = (q @ k.transpose(-1, -2)) * dh**-0.5
        if mask is not None:
            s = s + mask
        return (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(b, tq, d)

    def _conv(self, x: torch.Tensor, prefix: str, stride: int) -> torch.Tensor:
        w = self.w[f"{prefix}/w"]  # [3, I, O]
        return F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), self.w[f"{prefix}/b"],
                        stride=stride, padding=1).transpose(1, 2)

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """[B, 3000, n_mels] → [B, 1500, d]."""
        gelu = lambda t: F.gelu(t, approximate="tanh")
        x = gelu(self._conv(mel, "encoder/conv1", 1))
        x = gelu(self._conv(x, "encoder/conv2", 2))
        x = x + self.w["encoder/pos_emb"][: x.shape[1]]
        h = self.dims["n_audio_head"]
        for i in range(self.dims["n_audio_layer"]):
            p = f"encoder/blocks/{i}"
            y = self.ln(x, f"{p}/attn_ln")
            q, k, v = (self.linear(y, f"{p}/attn/{n}") for n in ("query", "key", "value"))
            x = x + self.linear(self.attention(q, k, v, h), f"{p}/attn/out")
            y = self.ln(x, f"{p}/mlp_ln")
            x = x + self.linear(gelu(self.linear(y, f"{p}/mlp1")), f"{p}/mlp2")
        return self.ln(x, "encoder/ln_post")

    def cross_kv(self, features: torch.Tensor) -> List[tuple]:
        """Each decoder layer's cross-attention K and V, quantized as the
        configuration states: int8 with one scale per (row, head, channel)
        over the 1500 frames, returned dequantized."""
        h = self.dims["n_text_head"]
        out = []
        for i in range(self.dims["n_text_layer"]):
            p = f"decoder/blocks/{i}/cross_attn"
            kv = []
            for n in ("key", "value"):
                t = self.linear(features, f"{p}/{n}")  # [B, T, D]
                b, tt, d = t.shape
                t = t.view(b, tt, h, d // h)
                scale = torch.clamp(t.abs().amax(dim=1, keepdim=True) / 127.0, min=1e-10)
                q8 = torch.clamp(torch.round(t / scale), -127, 127)
                kv.append((q8 * scale).view(b, tt, d))
            out.append(tuple(kv))
        return out

    def logits(self, tokens: torch.Tensor, cross: List[tuple]) -> torch.Tensor:
        """Teacher-forced logits [B, T, V] of ``tokens`` [B, T]."""
        t = tokens.shape[1]
        x = self.w["decoder/tok_emb"][tokens] + self.w["decoder/pos_emb"][:t]
        mask = torch.full((t, t), float("-inf"), device=x.device).triu(1)
        h = self.dims["n_text_head"]
        gelu = lambda z: F.gelu(z, approximate="tanh")
        for i in range(self.dims["n_text_layer"]):
            p = f"decoder/blocks/{i}"
            y = self.ln(x, f"{p}/attn_ln")
            q, k, v = (self.linear(y, f"{p}/attn/{n}") for n in ("query", "key", "value"))
            x = x + self.linear(self.attention(q, k, v, h, mask), f"{p}/attn/out")
            y = self.ln(x, f"{p}/cross_attn_ln")
            q = self.linear(y, f"{p}/cross_attn/query")
            x = x + self.linear(self.attention(q, *cross[i], h), f"{p}/cross_attn/out")
            y = self.ln(x, f"{p}/mlp_ln")
            x = x + self.linear(gelu(self.linear(y, f"{p}/mlp1")), f"{p}/mlp2")
        x = self.ln(x, "decoder/ln")
        if self.lowp:
            return _fp8(x) @ self._weight("decoder/tok_emb").T
        return x @ self.w["decoder/tok_emb"].T

"""Plain wav2vec2-CTC in float32, written again from the published model
(Hugging Face's ``Wav2Vec2ForCTC``, torchaudio's ``wav2vec2_model``), for the
emissions WhisperX aligns with.

Both published layouts: "layer" feature extractors with pre-layer-norm
blocks (``do_stable_layer_norm``, the large and XLSR models) and "group"
extractors with post-layer-norm blocks (the base models). GELU is the exact
one (``hidden_act`` "gelu"); layer and group norms take the population
variance with eps 1e-5; the positional convolution is grouped, padded k//2
on both sides, its trailing frame dropped when k is even; the attention
runs over every frame with no mask, as WhisperX calls the model (no
attention mask, no input normalisation). The emissions are the CTC head's
log-softmax.

One departure from upstream WhisperX, which runs each segment unpadded:
``emissions`` zero-pads a segment's samples to a power-of-two bucket of at
least 4096 before the forward pass and keeps the frames of its real
samples, as the port and the JAX package both do (a documented behaviour of
both: ROADMAP's deliberate differences). The padding reaches the real frames
through the positional convolution and the unmasked attention (and a
"group" extractor's norm over time), so the bucket is part of the result.

The caller turns TF32 off. ``lowp=True`` is the aligner's control: weights
and activations in bfloat16, the CTC head's logits widened to float32 for
the log-softmax, as a bfloat16 aligner would compute them.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

MIN_BUCKET = 4096  # samples
MIN_SAMPLES = 400  # one frame of the feature extractor


def bucket_of(n: int) -> int:
    """The power-of-two sample bucket, at least MIN_BUCKET, of ``n`` samples."""
    bucket = MIN_BUCKET
    while bucket < n:
        bucket *= 2
    return bucket


def frames_of(dims: dict, n: int) -> int:
    """The feature extractor's frames for ``n`` samples."""
    for k, s in zip(dims["conv_kernel"], dims["conv_stride"]):
        n = (n - k) // s + 1
    return n


class Model:
    """The weights of ``params.make_align_weights`` and the forward pass."""

    def __init__(self, weights: Dict[str, torch.Tensor], dims: dict, lowp: bool = False):
        dtype = torch.bfloat16 if lowp else torch.float32
        self.w = {k: v.to(dtype) for k, v in weights.items()}
        self.dims, self.dtype = dims, dtype

    def _norm(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.w[f"{prefix}/g"], self.w[f"{prefix}/b"], 1e-5)

    def _linear(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        return x @ self.w[f"{prefix}/w"] + self.w[f"{prefix}/b"]

    def _conv(self, x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0,
              groups: int = 1) -> torch.Tensor:
        """[B, T, C] → [B, T', O] with the weight [k, C/groups, O]."""
        return F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), stride=stride, padding=padding,
                        groups=groups).transpose(1, 2)

    def features(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, samples] → [B, frames, conv_dim[-1]]."""
        x = audio.to(self.dtype)[:, :, None]
        for i, s in enumerate(self.dims["conv_stride"]):
            p = f"feature_extractor/{i}"
            x = self._conv(x, self.w[f"{p}/w"], stride=s)
            if f"{p}/b" in self.w:
                x = x + self.w[f"{p}/b"]
            if f"{p}/ln/g" in self.w:
                x = self._norm(x, f"{p}/ln")
            elif f"{p}/gn/g" in self.w:  # one group a channel: each channel over time
                mu = x.mean(1, keepdim=True)
                var = x.var(1, keepdim=True, unbiased=False)
                x = (x - mu) * torch.rsqrt(var + 1e-5) * self.w[f"{p}/gn/g"] + self.w[f"{p}/gn/b"]
            x = F.gelu(x)
        return x

    def _block(self, x: torch.Tensor, i: int) -> torch.Tensor:
        p = f"layers/{i}"
        heads = self.dims["num_heads"]

        def attn(h):
            b, t, d = h.shape
            dh = d // heads
            q, k, v = (self._linear(h, f"{p}/attn/{n}").view(b, t, heads, dh).transpose(1, 2)
                       for n in ("query", "key", "value"))
            s = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
            o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(b, t, d)
            return self._linear(o, f"{p}/attn/out")

        def mlp(h):
            return self._linear(F.gelu(self._linear(h, f"{p}/mlp1")), f"{p}/mlp2")

        if self.dims["do_stable_layer_norm"]:
            x = x + attn(self._norm(x, f"{p}/attn_ln"))
            return x + mlp(self._norm(x, f"{p}/mlp_ln"))
        x = self._norm(x + attn(x), f"{p}/attn_ln")
        return self._norm(x + mlp(x), f"{p}/mlp_ln")

    def log_probs(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, samples] → CTC log-probabilities [B, frames, vocab], float32."""
        d = self.dims
        h = self._linear(self._norm(self.features(audio), "feature_projection/ln"), "feature_projection/proj")
        k = d["num_conv_pos_embeddings"]
        pos = self._conv(h, self.w["pos_conv/w"], padding=k // 2, groups=d["num_conv_pos_embedding_groups"])
        if k % 2 == 0:
            pos = pos[:, :-1]
        h = h + F.gelu(pos + self.w["pos_conv/b"])
        if not d["do_stable_layer_norm"]:
            h = self._norm(h, "encoder_ln")
        for i in range(d["num_layers"]):
            h = self._block(h, i)
        if d["do_stable_layer_norm"]:
            h = self._norm(h, "encoder_ln")
        return torch.log_softmax(self._linear(h, "lm_head").float(), dim=-1)

    @torch.no_grad()
    def emissions(self, waves: List[np.ndarray], device, max_samples: int = 2**21) -> List[np.ndarray]:
        """Each segment's emissions [frames, vocab] (float32, on the host):
        the segment zero-padded to its bucket, run in blocks of rows of one
        bucket of at most ``max_samples`` samples, its real frames kept."""
        out: List[np.ndarray] = [None] * len(waves)
        by_bucket: Dict[int, List[int]] = {}
        for i, w in enumerate(waves):
            by_bucket.setdefault(bucket_of(max(len(w), MIN_SAMPLES)), []).append(i)
        for bucket, idx in by_bucket.items():
            rows = max(1, max_samples // bucket)
            for b in range(0, len(idx), rows):
                part = idx[b:b + rows]
                batch = np.zeros((len(part), bucket), np.float32)
                for r, i in enumerate(part):
                    batch[r, :len(waves[i])] = waves[i]
                lp = self.log_probs(torch.from_numpy(batch).to(device)).cpu().numpy()
                for r, i in enumerate(part):
                    out[i] = lp[r, :frames_of(self.dims, max(len(waves[i]), MIN_SAMPLES))]
        return out

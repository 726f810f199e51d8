#!/usr/bin/env python3
"""Where the time of K1's f32 route goes on the card (error-compensated
TF32 on wgmma, ``whisperx_tpu_torch/ops/csrc/flash_attention.cu``).

    python3 tools/ablate_attention_f32_torch.py

needs one CUDA GPU and nvcc. It builds copies of the kernel source, each
with one part of the f32 route's loop removed (their outputs are wrong by
design), beside the real one, and times each at the trainers' encoder
shape, [160, 1500, 64] f32, K1 (mode 0), as ``chip_smoke.py`` times kernels,
in two rounds:

  - baseline: the source as it is;
  - no split in the loop: the next tile's hi/lo split of K and Vᵀ skipped
    (the first tile is still split);
  - no P·V: the three P·V products of every tile dropped;
  - S hi·hi only: Q·Kᵀ as one TF32 product (its two small terms dropped);
  - 1xTF32: both products as one TF32 product each;
  - no S: no Q·Kᵀ product (the scores stay 0).

What a part costs is the baseline's time less the copy's without it.
"""

from __future__ import annotations

import ctypes
import math
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SHAPE = (160, 1500, 64)  # [B·H, T, D] at batch 8, large-v3


def _drop(pattern: str, text: str) -> str:
    """Every call matching ``pattern`` replaced by an empty statement."""
    out = re.sub(pattern, "(void)0;", text)
    if out == text:
        raise SystemExit(f"no match for {pattern!r}: the kernel source changed")
    return out


def variants(src: str) -> dict:
    s_small = _drop(
        r"wgmma_tf32_rs<kF32BK>\(s, ql\[kk\][^;]*\);",
        _drop(r"wgmma_tf32_rs<kF32BK>\(s, qh\[kk\], desc_sw128\(&sm\.klo[^;]*\);", src),
    )
    one = _drop(
        r"wgmma_tf32_rs<D>\(pv, pl\[j\][^;]*\);",
        _drop(r"wgmma_tf32_rs<D>\(pv, ph\[j\], desc_sw128\(&sm\.vlo[^;]*\);", s_small),
    )
    split = "split_kv_tile<D>(sm, st, b ^ 1, tid);"
    if split not in src:
        raise SystemExit("the loop's split call is not in the kernel source")
    return {
        "baseline": src,
        "no split in the loop": src.replace(split, ""),
        "no P·V": _drop(r"wgmma_tf32_rs<D>\(pv, [^;]*\);", src),
        "S hi·hi only": s_small,
        "1xTF32 (hi·hi only, both products)": one,
        "no S (scores 0)": _drop(r"wgmma_tf32_rs<kF32BK>\(s, [^;]*\);", src),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from whisperx_tpu_torch.ops import _build
    from whisperx_tpu_torch.ops.flash_attention import LOG2_E

    print(cs.card_line(), flush=True)
    with open(os.path.join(_build.CSRC, "flash_attention.cu")) as f:
        src = f.read()
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, text) in enumerate(variants(src).items()):
            path = os.path.join(tmp, f"v{i}.cu")
            with open(path, "w") as f:
                f.write(text)
            r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", f"{path}.so", path],
                               capture_output=True, text=True)
            if r.returncode != 0:
                print(f"{name}: nvcc failed\n{r.stdout[-2000:]}{r.stderr[-2000:]}")
                return 1
            lib = libs[name] = ctypes.CDLL(f"{path}.so")
            lib.attention_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
                ctypes.c_float, ctypes.c_void_p,
            ]
        bh, t, d = SHAPE
        q, k, v = cs.attention_case(bh, t, d, torch.float32, seed=4)
        out = torch.empty_like(q)
        for rnd in range(2):
            for name, lib in libs.items():
                def call(fn=lib.attention_launch):
                    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, t, t, d,
                              0, 0, LOG2_E / math.sqrt(d), torch.cuda.current_stream().cuda_stream)

                if call() != 0:
                    print(f"{name}: launch failed")
                    return 1
                print(f"round {rnd + 1}: {name}: {cs.cuda_ms(call):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

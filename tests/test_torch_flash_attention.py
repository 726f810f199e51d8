"""K1's plain PyTorch version (the port's CPU path) against the JAX package:
the Pallas ``_flash_attention_wholek`` run in interpret mode, and the XLA
oracle ``_xla_attention``. The CUDA kernel itself is held against this plain
version on the card by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperx_tpu.ops.flash_attention import (
    _flash_attention_wholek,
    _xla_attention,
    flash_attention as jax_flash_attention,
)
from whisperx_tpu_torch.ops.flash_attention import (
    _attention_reference,
    _check_operands,
    flash_attention,
    wholek_attention,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

# the tolerance of tests/test_ops.py for the same kernels in f32
TOL = dict(atol=2e-3, rtol=2e-3)


def _qkv(bh, tq, tk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal((bh, n, d)).astype(np.float32) for n in (tq, tk, tk)
    )


def _torch(*xs, dtype=torch.float32):
    return tuple(torch.from_numpy(x).to(dtype) for x in xs)


@pytest.mark.parametrize(
    "tq,tk,d,skip_max",
    [
        (200, 256, 64, False),  # ragged: 200 = 128 + 72 query rows
        (200, 300, 64, True),
        (200, 256, 32, False),
        (128, 300, 32, True),
    ],
)
def test_reference_matches_pallas_wholek(tq, tk, d, skip_max):
    q, k, v = _qkv(2, tq, tk, d, seed=tq + tk + d)
    want = np.asarray(
        _flash_attention_wholek(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            bq=128, skip_max=skip_max, interpret=True,
        )
    )
    got = wholek_attention(*_torch(q, k, v), skip_max=skip_max).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("d", [32, 64])
def test_reference_matches_xla(d):
    q, k, v = _qkv(3, 160, 224, d, seed=d)
    want = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(_attention_reference(*_torch(q, k, v)).numpy(), want, **TOL)


def test_reference_bf16_matches_pallas_bf16():
    """Same arithmetic in bf16: the outputs agree to one bf16 ulp at the
    outputs' magnitude (|out| < 1 here, ulp ≤ 3.9e-3)."""
    q, k, v = _qkv(2, 200, 256, 64, seed=11)
    want = np.asarray(
        _flash_attention_wholek(
            jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
            jnp.asarray(v, jnp.bfloat16), bq=128, interpret=True,
        ).astype(jnp.float32)
    )
    got = _attention_reference(*_torch(q, k, v, dtype=torch.bfloat16)).float().numpy()
    np.testing.assert_allclose(got, want, atol=4e-3, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_layout_matches_jax(causal):
    """The [B, T, H, D] wrapper: same layout handling and results as the JAX
    package's ``flash_attention`` (which takes its XLA path on the CPU)."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 96, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 96, 4, 32)).astype(np.float32)
    v = rng.standard_normal((2, 96, 4, 32)).astype(np.float32)
    want = np.asarray(
        jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    )
    got = flash_attention(*_torch(q, k, v), causal=causal)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cpu_tensors_take_the_plain_version_without_launching():
    q, k, v = _torch(*_qkv(2, 64, 64, 64, seed=3))
    before = flash_attention.launches
    out = wholek_attention(q, k, v)
    assert flash_attention.launches == before
    torch.testing.assert_close(out, _attention_reference(q, k, v), rtol=0, atol=0)


def test_kernel_operand_checks_reject_cpu_tensors():
    """The CUDA entry refuses what the kernel cannot take, before launching."""
    q, k, v = _torch(*_qkv(1, 8, 8, 64, seed=4))
    with pytest.raises(ValueError, match="CUDA"):
        _check_operands(q, k, v)

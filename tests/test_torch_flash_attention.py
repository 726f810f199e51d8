"""K1's, K1b's and K2's plain PyTorch versions (the port's CPU path) against
the JAX package: the Pallas ``_flash_attention_wholek`` and
``_flash_attention_pallas`` run in interpret mode, and the XLA oracle
``_xla_attention``. The CUDA kernel itself is held against these plain
versions on the card by ``chip_smoke.py``; its f32 route's arithmetic
(error-compensated TF32) is emulated here, against the JAX kernels and an
f64 evaluation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperx_tpu.ops.flash_attention import (
    _flash_attention_pallas,
    _flash_attention_wholek,
    _xla_attention,
    flash_attention as jax_flash_attention,
)
from whisperx_tpu_torch.ops.flash_attention import (
    _attention_reference,
    _causal_keep,
    _check_operands,
    _flash_reference,
    _scaled_q,
    flash_attention,
    flash_attention_tiled,
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


# ---------------------------------------------------------------------------
# K2 (``_flash_kernel``) and K1b (``_wholek_mxusum_kernel``)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "tk,bk,causal,dtype",
    [
        (384, 128, False, torch.float32),
        (384, 128, True, torch.float32),
        (384, 128, True, torch.bfloat16),
        (3072, 1536, False, torch.float32),  # past the whole-K kernel's 2048
        (3072, 1536, True, torch.bfloat16),
    ],
)
def test_k2_plain_matches_pallas(tk, bk, causal, dtype):
    """The tile recurrence at Tq = Tk, where the Pallas kernel's causal mask
    (aligned at the start) and the port's (aligned at the end) agree. f32:
    TOL; bf16: the same arithmetic and roundings in both, so the outputs
    agree to one bf16 ulp at their magnitude (|out| < 1 here). Tk is a
    multiple of ``bk``: the Pallas kernel does not mask a key tile that
    overhangs Tk (interpret mode reads NaN there), the port's does
    (``test_k2_masks_an_overhanging_key_tile``)."""
    q, k, v = _qkv(2, tk, tk, 64, seed=tk + causal)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(
        _flash_attention_pallas(
            jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
            causal=causal, bq=256, bk=bk, interpret=True,
        ).astype(jnp.float32)
    )
    got = flash_attention_tiled(*_torch(q, k, v, dtype=dtype), causal=causal, bk=bk)
    assert got.dtype == dtype and got.shape == q.shape
    tol = TOL if dtype == torch.float32 else dict(atol=4e-3, rtol=0)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("causal", [False, True])
def test_k2_masks_an_overhanging_key_tile(causal):
    """Tk = 300 in key tiles of 128: the last tile overhangs by 84 keys,
    which the port masks; equal to the XLA route."""
    q, k, v = _qkv(2, 300, 300, 64, seed=6)
    want = np.asarray(
        _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    )
    got = flash_attention_tiled(*_torch(q, k, v), causal=causal, bk=128)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_k2_plain_matches_xla_when_fewer_queries(causal):
    """Tq < Tk: the port's K2 equals the JAX package's XLA route, whose
    causal mask is aligned at the end of the keys (``tril(k=Tk-Tq)``)."""
    q, k, v = _qkv(2, 100, 300, 64, seed=7)
    want = np.asarray(
        _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    )
    got = flash_attention_tiled(*_torch(q, k, v), causal=causal, bk=128)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_k2_causal_divergence_of_the_reference_is_named():
    """A fault of the reference, named: with Tq < Tk the JAX package's
    Pallas K2 aligns the causal mask at the start (key ≤ query) while its
    XLA route aligns it at the end, so ``flash_attention(causal=True)``
    answers differently on a TPU and on a CPU. The port implements the end
    alignment (the XLA route's and the decoder's own mask): it agrees with
    the XLA route and differs from the Pallas kernel by O(1)."""
    q, k, v = _qkv(4, 100, 300, 64, seed=8)
    args = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    pallas = np.asarray(  # one key tile of 300: nothing overhangs
        _flash_attention_pallas(*args, causal=True, bk=300, interpret=True).astype(jnp.float32)
    )
    xla = np.asarray(_xla_attention(*args, causal=True).astype(jnp.float32))
    port = flash_attention_tiled(*_torch(q, k, v, dtype=torch.bfloat16), causal=True).float().numpy()
    assert np.abs(pallas - xla).max() > 0.5
    assert np.abs(port - pallas).max() > 0.5
    np.testing.assert_allclose(port, xla, atol=1e-2, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1b_plain_matches_pallas_mxu_sum(dtype):
    """K1b: the denominator sums the weights after their rounding. In f32
    that is K1 exactly; in bf16 it is not (v scaled by 8, |out| ≈ 4: the two
    Pallas kernels differ by 0.0156), and the plain version follows the
    Pallas K1b within one bf16 ulp of the output, closer than K1 is."""
    q, k, v = _qkv(4, 300, 300, 64, seed=12)
    v = 8 * v
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    want = np.asarray(
        _flash_attention_wholek(jq, jk, jv, bq=128, mxu_sum=True, interpret=True).astype(jnp.float32)
    )
    k1 = np.asarray(_flash_attention_wholek(jq, jk, jv, bq=128, interpret=True).astype(jnp.float32))
    tq, tk, tv = _torch(q, k, v, dtype=dtype)
    got = wholek_attention(tq, tk, tv, mxu_sum=True).float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, k1, **TOL)
    else:
        np.testing.assert_allclose(got, want, atol=2.0**-7 * np.abs(want).max(), rtol=0)
        assert np.abs(got - want).max() < np.abs(want - k1).max()


@pytest.mark.parametrize(
    "causal,tk,route", [(False, 2048, "K1"), (False, 2049, "K2"), (True, 64, "K2")]
)
def test_dispatch_follows_jax(monkeypatch, causal, tk, route):
    """``flash_attention`` routes as the JAX package does on its device:
    non-causal over at most 2048 keys to K1, else K2 (key tiles of 1536).
    Either kernel gets contiguous [BH, T, D] operands, which the CUDA
    kernels require, also at batch 1, where the head split is a view."""
    from whisperx_tpu_torch.ops import flash_attention as fa

    taken, contiguous = [], []
    monkeypatch.setattr(
        fa, "wholek_attention",
        lambda *a, **kw: contiguous.append(all(x.is_contiguous() for x in a))
        or taken.append("K1") or a[0],
    )
    monkeypatch.setattr(
        fa, "flash_attention_tiled",
        lambda *a, **kw: contiguous.append(all(x.is_contiguous() for x in a))
        or taken.append(("K2", kw["bk"], kw["causal"])) or a[0],
    )
    x = torch.zeros((1, tk, 2, 32))
    fa.flash_attention(x, x, x, causal=causal)
    assert taken == (["K1"] if route == "K1" else [("K2", 1536, causal)])
    assert contiguous == [True]


def test_k1b_and_k2_cpu_tensors_launch_nothing():
    q, k, v = _torch(*_qkv(2, 64, 64, 64, seed=3))
    before = (wholek_attention.mxu_sum_launches, flash_attention_tiled.launches)
    wholek_attention(q, k, v, mxu_sum=True)
    flash_attention_tiled(q, k, v, causal=True)
    assert (wholek_attention.mxu_sum_launches, flash_attention_tiled.launches) == before


# ---------------------------------------------------------------------------
# The f32 kernel's arithmetic: error-compensated TF32 ("3xTF32"), emulated
# ---------------------------------------------------------------------------

# the kernel's error against f64 may be this factor of the plain f32
# version's own; plain TF32 (one product) must fall outside it
F32_WITNESS_FACTOR = 8.0


def _tf32(x):
    """``cvt.rna.tf32.f32``: x rounded to 10 mantissa bits, to nearest with
    ties away from zero, on the f32 bits."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(a, b, terms):
    """a @ b as the tensor cores take f32 operands: each split into
    hi = tf32(x) and lo = tf32(x - hi), the products lo·hi + hi·lo + hi·hi
    summed in f32 and lo·lo dropped (``terms=3``), or hi·hi alone, plain
    TF32 (``terms=1``)."""
    ah, bh = _tf32(a), _tf32(b)
    if terms == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _kernel_f32_emulation(q, k, v, terms, skip_max=False, causal=False):
    """The f32 route's arithmetic, both products through ``_tf32_product``:
    q scaled as in K1, scores in log2 space, exp2, the denominator of the
    unrounded weights (K2's ``max(l, 1e-20)`` when causal)."""
    s = _tf32_product(_scaled_q(q), k.transpose(-1, -2), terms)
    if causal:
        s = s.masked_fill(~_causal_keep(q.shape[1], k.shape[1], q.device), float("-inf"))
    p = torch.exp2(s if skip_max else s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    return _tf32_product(p, v, terms) / (l.clamp(min=1e-20) if causal else l)


def _f64(q, k, v, causal=False):
    """The same function in f64 (q scaled and rounded to f32 as defined)."""
    s = _scaled_q(q).double() @ k.double().transpose(-1, -2)
    if causal:
        s = s.masked_fill(~_causal_keep(q.shape[1], k.shape[1], q.device), float("-inf"))
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    return (p @ v.double()) / p.sum(dim=-1, keepdim=True)


@pytest.mark.parametrize(
    "tq,tk,d,skip_max,causal",
    [
        (200, 256, 64, False, False),  # the cases of test_reference_matches_pallas_wholek
        (200, 300, 64, True, False),
        (200, 256, 32, False, False),
        (128, 300, 32, True, False),
        (384, 384, 64, False, True),  # K2 causal (Tk a multiple of the Pallas key tile)
    ],
)
def test_f32_kernel_arithmetic_keeps_f32_accuracy(tq, tk, d, skip_max, causal):
    """The split form the f32 kernel computes on the tensor cores agrees with
    the JAX kernels (interpret mode) within TOL, and its error against f64 is
    within F32_WITNESS_FACTOR x the plain f32 version's own; plain TF32 is
    within TOL too, so TOL cannot tell the two apart: the control is that it
    misses the f64 limit (by two orders of magnitude or more)."""
    q, k, v = _qkv(2, tq, tk, d, seed=tq + tk + d)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    if causal:
        want = _flash_attention_pallas(jq, jk, jv, causal=True, bq=256, bk=128, interpret=True)
        plain = _flash_reference(*_torch(q, k, v), causal=True, bk=128)
    else:
        want = _flash_attention_wholek(jq, jk, jv, bq=128, skip_max=skip_max, interpret=True)
        plain = _attention_reference(*_torch(q, k, v), skip_max=skip_max)
    tq_, tk_, tv_ = _torch(q, k, v)
    split = _kernel_f32_emulation(tq_, tk_, tv_, 3, skip_max, causal)
    one = _kernel_f32_emulation(tq_, tk_, tv_, 1, skip_max, causal)
    np.testing.assert_allclose(split.numpy(), np.asarray(want), **TOL)
    exact = _f64(tq_, tk_, tv_, causal)
    err_split, err_f32, err_tf32 = ((x.double() - exact).abs().max().item() for x in (split, plain, one))
    assert err_split <= F32_WITNESS_FACTOR * err_f32, (err_split, err_f32)
    assert err_tf32 > F32_WITNESS_FACTOR * err_f32, (err_tf32, err_f32)

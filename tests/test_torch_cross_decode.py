"""K3, K3kt and K3i8's plain PyTorch versions (the port's CPU path) against
the JAX package's Pallas functions run in interpret mode, and the decoder's
cross-decode opt-in (``WHISPERX_TPU_CROSS_DECODE``) against JAX's on f32
``test-nano``. The CUDA kernel is held against these plain versions on the
card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperx_tpu.convert.checkpoint import flatten_tree
from whisperx_tpu.decoding import DecodingOptions as JOptions
from whisperx_tpu.decoding import decode as jax_decode
from whisperx_tpu.models.whisper import Whisper as JWhisper
from whisperx_tpu.models.whisper import model as jm
from whisperx_tpu.models.whisper.config import MODEL_DIMS
from whisperx_tpu.ops import cross_attention_decode as jx
from whisperx_tpu_torch.convert.checkpoint import params_from_numpy
from whisperx_tpu_torch.decoding import DecodingOptions, decode
from whisperx_tpu_torch.models.whisper import model as tm
from whisperx_tpu_torch.ops import cross_attention_decode as tx
from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

DIMS = MODEL_DIMS["test-nano"]
# The plain versions repeat the Pallas recurrence tile by tile; the two
# differ only in the order of f32 sums. |V| ≤ 127, so outputs are O(100):
# 1e-3 absolute is ~1e-5 relative. A bf16 rounding of P that flips under a
# different f32 sum order moves an output by up to ~0.5 (2⁻⁸ · 127): a flip
# would fail this tolerance, and none occurs on these seeds.
TOL = dict(atol=1e-3, rtol=1e-5)


def _inputs(b, t, h, dh, seed):
    """Spread bf16 queries [B, H, D] (rows of N(0, 0.05²), so scores are
    O(1-10)), int8 k/v [B, T, D], and the per-head int8 queries with their
    scales, made as ``tools/probe_kv_layout.py`` makes them."""
    rng = np.random.default_rng(seed)
    d = h * dh
    q = (0.05 * rng.standard_normal((b, d))).astype(np.float32)
    q = np.asarray(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
    sel = (np.arange(d)[None, :] // dh) == np.arange(h)[:, None]  # [H, D]
    qs = q[:, None, :] * sel[None]
    k8 = rng.integers(-127, 128, (b, t, d)).astype(np.int8)
    v8 = rng.integers(-127, 128, (b, t, d)).astype(np.int8)
    amax = np.abs(qs).max(axis=-1, keepdims=True)
    sq = np.maximum(amax / 127.0, 1e-10).astype(np.float32)  # [B, H, 1]
    qs8 = np.clip(np.round(qs / sq), -127, 127).astype(np.int8)
    return qs, k8, v8, qs8, sq


CASES = [  # (t, h, dh): one tile, a tile that overhangs, three tiles
    (256, 4, 64), (300, 4, 64), (1500, 4, 64), (300, 4, 32), (1500, 2, 32),
]


@pytest.mark.parametrize("t,h,dh", CASES)
def test_k3_plain_matches_pallas(t, h, dh):
    qs, k8, v8, _, _ = _inputs(2, t, h, dh, seed=t + h + dh)
    want = np.asarray(
        jx._cross_decode_pallas(
            jnp.asarray(qs, jnp.bfloat16), jnp.asarray(k8), jnp.asarray(v8), interpret=True
        )
    )
    got = tx.cross_decode(
        torch.from_numpy(qs).to(torch.bfloat16), torch.from_numpy(k8), torch.from_numpy(v8)
    )
    assert got.shape == want.shape == (2, 1, h * dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("t,h,dh", CASES)
def test_k3kt_plain_matches_pallas(t, h, dh):
    qs, k8, v8, _, _ = _inputs(2, t, h, dh, seed=t + h + dh + 1)
    kt8 = np.ascontiguousarray(k8.transpose(0, 2, 1))
    want = np.asarray(
        jx._cross_decode_pallas_kt(
            jnp.asarray(qs, jnp.bfloat16), jnp.asarray(kt8), jnp.asarray(v8), interpret=True
        )
    )
    got = tx.cross_decode_kt(
        torch.from_numpy(qs).to(torch.bfloat16), torch.from_numpy(kt8), torch.from_numpy(v8)
    )
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("t,h,dh", CASES)
def test_k3i8_plain_matches_pallas(t, h, dh):
    _, k8, v8, qs8, sq = _inputs(2, t, h, dh, seed=t + h + dh + 2)
    want = np.asarray(
        jx._cross_decode_pallas_i8(
            jnp.asarray(qs8), jnp.asarray(sq), jnp.asarray(k8), jnp.asarray(v8),
            interpret=True,
        )
    )
    got = tx.cross_decode_i8(*map(torch.from_numpy, (qs8, sq, k8, v8)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize(
    "t,split,cluster,tiles_per_block",
    [(1, 64, 1, 1), (256, 64, 4, 1), (300, 64, 5, 1), (512, 64, 8, 1), (513, 128, 5, 1),
     (1000, 128, 8, 1), (1500, 256, 6, 1), (2048, 256, 8, 1), (2049, 512, 5, 1),
     (4096, 512, 8, 1), (4097, 512, 5, 2), (4999, 512, 5, 2), (100_000, 512, 8, 25)],
)
def test_launch_plan_splits_t_inside_tiles(t, split, cluster, tiles_per_block):
    """Every block of a cluster owns whole sub-splits that never straddle a
    512-key tile, the blocks cover T exactly in order, none is empty, a
    cluster has at most 8 blocks, and past 8 tiles a block walks whole
    tiles."""
    plan = tx.launch_plan(2, t, 4, 64)
    assert (plan["split"], plan["cluster"], plan["tiles_per_block"]) == (split, cluster, tiles_per_block)
    assert plan["cluster"] <= tx.MAX_CLUSTER and tx.TILE % plan["split"] == 0
    assert plan["splits_per_tile"] == tx.TILE // plan["split"]
    assert plan["tiles_per_block"] == 1 or plan["split"] == tx.TILE
    keys = plan["split"] * plan["tiles_per_block"]  # a block's keys
    blocks = [(r * keys, min(t, (r + 1) * keys)) for r in range(plan["cluster"])]
    assert blocks[-1][1] == t and all(a < e for a, e in blocks)
    for a, e in blocks:
        for c0 in range(a, e, plan["split"]):
            c1 = min(e, c0 + plan["split"])
            assert c0 // tx.TILE == (c1 - 1) // tx.TILE  # inside one tile
    assert plan["grid"] == (plan["cluster"] * 4, 2)
    assert plan["smem_bytes"] <= tx.MAX_SMEM


@pytest.mark.parametrize("b,blocks", [(8, 960), (1, 120)])
def test_launch_plan_at_the_large_v3_decode_step(b, blocks):
    """B 8 (the pipeline's batch) and B 1, T 1500, H 20, Dh 64: sub-splits
    of 256 keys, 6 a cluster; the old grid (H, B) had 160 and 20 blocks on
    132 SMs. K3kt's slots hold 80-byte rows of transposed K."""
    plan = tx.launch_plan(b, 1500, 20, 64)
    gx, gy = plan["grid"]
    assert (plan["split"], plan["splits_per_tile"], plan["cluster"]) == (256, 2, 6)
    assert gx * gy == blocks and gy == b
    kt = tx.launch_plan(b, 1500, 20, 64, k_transposed=True)
    # 4 slots of 64 keys (K, then V), the scores, one tile's max
    assert plan["smem_bytes"] == 4 * 64 * 64 + 4 * 256 + 4
    assert kt["smem_bytes"] - plan["smem_bytes"] == 4 * 64 * (tx.KT_ROW - 64)


def _select_heads(out_all, h):
    """[B, H, D] → [B, 1, D]: each column from the head that owns it."""
    d = out_all.shape[-1]
    sel = (torch.arange(d) // (d // h))[None, :] == torch.arange(h)[:, None]
    return torch.where(sel, out_all, 0.0).sum(dim=1, keepdim=True)


def _scores(qs, k, sq, k_transposed, t0, t1):
    kb = k[:, :, t0:t1] if k_transposed else k[:, t0:t1].transpose(1, 2)
    if sq is None:
        return torch.matmul(qs.float(), kb.float())
    return torch.matmul(qs.double(), kb.double()).float() * sq


def _cluster_split_emulation(qs, k, v, *, sq=None, k_transposed=False):
    """The CUDA kernel's order in plain torch, by ``launch_plan``: each
    sub-split's scores and max; every sub-split rounds P against the TPU's
    running max after its tile (the maxima the cluster shares); each block
    sums p unrounded into l and bf16(p)·V into acc (a block of whole tiles
    with the TPU's α between them); then each tile's blocks are summed in
    rank order and the TPU's recurrence runs over the tiles in order."""
    b, h, d = qs.shape
    t = k.shape[2] if k_transposed else k.shape[1]
    plan = tx.launch_plan(b, t, h, d // h, k_transposed)
    split, tpb = plan["split"], plan["tiles_per_block"]
    chunks = [(a, min(t, a + split)) for a in range(0, t, split)]
    s = [_scores(qs, k, sq, k_transposed, a, e) for a, e in chunks]
    tile = [a // tx.TILE for a, _ in chunks]
    running, m = [], torch.full((b, h, 1), float("-inf"))
    for j in range(tile[-1] + 1):
        for c in range(len(chunks)):
            if tile[c] == j:
                m = torch.maximum(m, s[c].amax(dim=-1, keepdim=True))
        running.append(m)
    blocks = []  # (tile of its last chunk, running max there, l, acc)
    for r in range(plan["cluster"]):
        l, acc = torch.zeros((b, h, 1)), torch.zeros((b, h, d))
        m_prev = torch.full((b, h, 1), float("-inf"))
        for c in range(r * tpb, min((r + 1) * tpb, len(chunks))):
            m = running[tile[c]]
            alpha = torch.exp(m_prev - m)
            p = torch.exp(s[c] - m)
            a, e = chunks[c]
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p.to(torch.bfloat16).float(), v[:, a:e].float())
            m_prev = m
        blocks.append((tile[c], m_prev, l, acc))
    l, acc = torch.zeros((b, h, 1)), torch.zeros((b, h, d))
    m = torch.full((b, h, 1), float("-inf"))
    for j in sorted({blk[0] for blk in blocks}):
        group = [blk for blk in blocks if blk[0] == j]
        gl, ga = group[0][2], group[0][3]
        for blk in group[1:]:
            gl, ga = gl + blk[2], ga + blk[3]
        alpha = torch.exp(m - group[0][1])
        l, acc, m = l * alpha + gl, acc * alpha + ga, group[0][1]
    return _select_heads(acc / torch.clamp(l, min=1e-20), h)


def _free_split_emulation(qs, k, v, split):
    """The usual flash-decode split: each run of ``split`` keys rounds P
    against its own max; the splits are merged at the end."""
    t = k.shape[1]
    ms, ls, accs = [], [], []
    for a in range(0, t, split):
        s = _scores(qs, k, None, False, a, min(t, a + split))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.matmul(p.to(torch.bfloat16).float(), v[:, a : a + split].float()))
    top = torch.stack(ms).amax(dim=0)
    l = sum(torch.exp(m - top) * x for m, x in zip(ms, ls))
    acc = sum(torch.exp(m - top) * x for m, x in zip(ms, accs))
    return _select_heads(acc / torch.clamp(l, min=1e-20), qs.shape[1])


def _pallas(mode, qs, k8, v8, qs8, sq):
    if mode == "K3i8":
        return jx._cross_decode_pallas_i8(*map(jnp.asarray, (qs8, sq, k8, v8)), interpret=True)
    q = jnp.asarray(qs, jnp.bfloat16)
    if mode == "K3kt":
        return jx._cross_decode_pallas_kt(q, jnp.asarray(k8), jnp.asarray(v8), interpret=True)
    return jx._cross_decode_pallas(q, jnp.asarray(k8), jnp.asarray(v8), interpret=True)


@pytest.mark.parametrize("mode", ["K3", "K3kt", "K3i8"])
@pytest.mark.parametrize("t,h,dh", CASES + [(1000, 2, 32), (4999, 2, 64)])
def test_cluster_split_emulation_matches_plain_and_pallas(mode, t, h, dh):
    """The kernel's order of sums (sub-splits sharing the TPU's running max,
    tiles combined in order; at T 4999 blocks of two whole tiles) stays
    within the plain versions' TOL of the plain version and of the Pallas
    function in interpret mode."""
    qs, k8, v8, qs8, sq = _inputs(2, t, h, dh, seed=t + h + dh + 3)
    if mode == "K3kt":
        k8 = np.ascontiguousarray(k8.transpose(0, 2, 1))
    qt, kt, vt = torch.from_numpy(qs).to(torch.bfloat16), torch.from_numpy(k8), torch.from_numpy(v8)
    kw = {"k_transposed": mode == "K3kt"}
    if mode == "K3i8":
        qt, kw = torch.from_numpy(qs8), {"sq": torch.from_numpy(sq)}
    got = _cluster_split_emulation(qt, kt, vt, **kw).numpy()
    np.testing.assert_allclose(got, tx._cross_decode_reference(qt, kt, vt, **kw).numpy(), **TOL)
    np.testing.assert_allclose(got, np.asarray(_pallas(mode, qs, k8, v8, qs8, sq)), **TOL)


@pytest.mark.parametrize("split", [512, 384, 256, 128])
def test_a_free_split_misses_the_chip_tolerance(split):
    """Why the cluster shares its maxima: with ``chip_smoke.py``'s inputs
    (q = 0.005·N(0, 1) in bf16, int8 K and V uniform in ±127), a split whose
    blocks round P against their own max falls outside the 1e-2 that the
    chip holds K3 to, where the kernel's order stays inside TOL."""
    rng = np.random.default_rng(0)
    b, t, h, dh = 2, 1500, 4, 64
    q = torch.from_numpy((0.005 * rng.standard_normal((b, h * dh))).astype(np.float32))
    qs = tx.spread_queries(q.to(torch.bfloat16), h)
    k8, v8 = (torch.from_numpy(rng.integers(-127, 128, (b, t, h * dh)).astype(np.int8))
              for _ in range(2))
    ref = tx._cross_decode_reference(qs, k8, v8).numpy()
    np.testing.assert_allclose(_cluster_split_emulation(qs, k8, v8).numpy(), ref, **TOL)
    assert np.abs(_free_split_emulation(qs, k8, v8, split).numpy() - ref).max() > 1e-2


def test_k3i8_scores_are_exact_integers():
    """The int8 × int8 scores of the plain version are the exact integer
    dot (here the TPU's int32 sum), so K3i8 differs from K3 run on the
    dequantized queries only through the query's quantization."""
    _, k8, v8, qs8, sq = _inputs(1, 300, 4, 64, seed=9)
    exact = np.einsum("bhd,btd->bht", qs8.astype(np.int64), k8.astype(np.int64))
    got = torch.matmul(
        torch.from_numpy(qs8).double(), torch.from_numpy(k8).double().transpose(1, 2)
    )
    np.testing.assert_array_equal(got.numpy().astype(np.int64), exact)
    assert np.abs(exact).max() < 2**24  # exact in f32 too, as on the TPU


@pytest.mark.parametrize("t", [300, 1500])
def test_op_matches_jax_op(t):
    """The decoder's op, ``cross_attention_decode(q_eff, k8, v8)`` in the
    [B, 1, H, Dh] layout, against the JAX package's (interpret mode)."""
    rng = np.random.default_rng(t)
    b, h, dh = 2, 4, 64
    q = (0.05 * rng.standard_normal((b, 1, h, dh))).astype(np.float32)
    k8 = rng.integers(-127, 128, (b, t, h, dh)).astype(np.int8)
    v8 = rng.integers(-127, 128, (b, t, h, dh)).astype(np.int8)
    want = np.asarray(
        jx.cross_attention_decode(jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), interpret=True)
    )
    got = tx.cross_attention_decode(*map(torch.from_numpy, (q, k8, v8)))
    assert got.shape == (b, 1, h, dh)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize(
    "flag,device,want", [("1", "cuda", True), ("1", "cpu", False), ("force", "cpu", True),
                         ("0", "cuda", False), ("yes", "cuda", False), (None, "cuda", False)],
)
def test_opt_in_keeps_the_jax_meaning(monkeypatch, flag, device, want):
    if flag is None:
        monkeypatch.delenv("WHISPERX_TPU_CROSS_DECODE", raising=False)
    else:
        monkeypatch.setenv("WHISPERX_TPU_CROSS_DECODE", flag)
    assert tx.use_cross_decode_kernel(torch.device(device)) is want


@pytest.mark.parametrize("capture", [False, True])
@pytest.mark.parametrize("beam_groups", [1, 2])
@pytest.mark.parametrize("t_new", [1, 3])
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_route_takes_k3_only_for_bf16_one_token_steps_on_cuda(
    monkeypatch, device, dtype, quantized, t_new, beam_groups, capture
):
    """With the opt-in unset, only CUDA + a bf16 query + an int8 cache + one
    token + no beams + no capture takes K3; a head size K3 does not take
    keeps the einsum there too."""
    monkeypatch.delenv("WHISPERX_TPU_CROSS_DECODE", raising=False)
    args = (torch.device(device), dtype, 64, quantized, t_new, beam_groups, capture)
    want = (device == "cuda" and dtype == torch.bfloat16 and quantized and t_new == 1
            and beam_groups == 1 and not capture)
    assert tx.cross_decode_route(*args) is want
    assert tx.cross_decode_route(*args[:2], 80, *args[3:]) is False


def test_cpu_tensors_take_the_plain_version_without_launching():
    qs, k8, v8, _, _ = _inputs(1, 64, 2, 32, seed=1)
    before = tx.cross_attention_decode.launches
    tx.cross_decode(torch.from_numpy(qs).to(torch.bfloat16), torch.from_numpy(k8), torch.from_numpy(v8))
    assert tx.cross_attention_decode.launches == before


def test_kernel_operand_checks_reject_cpu_tensors():
    qs, k8, v8, _, _ = _inputs(1, 64, 2, 32, seed=1)
    with pytest.raises(ValueError, match="CUDA"):
        tx._check_operands(
            torch.from_numpy(qs).to(torch.bfloat16), torch.from_numpy(k8), torch.from_numpy(v8),
            n_head=2, k_transposed=False, q_int8=False, bt=tx.TILE,
        )


@pytest.fixture(scope="module")
def nano():
    params = jm.init_params(DIMS, jax.random.PRNGKey(0), dtype=jnp.float32)
    return params, params_from_numpy(flatten_tree(params), DIMS, torch.float32, "cpu")


def _step_logits_torch(model, feats, flag, monkeypatch):
    monkeypatch.setenv("WHISPERX_TPU_CROSS_DECODE", flag)
    n_head = DIMS.n_text_head
    ck, cv = tm.precompute_cross_kv(model.decoder, torch.from_numpy(feats), n_head)
    shape = (2, 64, n_head, DIMS.n_text_state // n_head)
    cache = tm.KVCache(
        [torch.zeros(shape) for _ in range(DIMS.n_text_layer)],
        [torch.zeros(shape) for _ in range(DIMS.n_text_layer)],
        [tm.quantize_kv(x) for x in ck], [tm.quantize_kv(x) for x in cv],
    )
    tokens = torch.tensor([[11], [42]])
    return tm.decoder_forward(model.decoder, tokens, cache, 0, n_head).numpy()


def test_decoder_forward_force_matches_jax_force(nano, monkeypatch):
    """One t_new = 1 decoder pass over an int8 cache, f32 test-nano: the
    port's forced route (K3's plain version) against JAX's forced route
    (the Pallas kernel in interpret mode) and against the port's einsum."""
    params, model = nano
    feats = np.random.default_rng(0).standard_normal(
        (2, DIMS.n_audio_ctx, DIMS.n_audio_state)
    ).astype(np.float32)
    monkeypatch.setenv("WHISPERX_TPU_CROSS_DECODE", "force")
    n_head = DIMS.n_text_head
    ck, cv = jm.precompute_cross_kv(params, jnp.asarray(feats), n_head)
    sk, sv = jm.init_kv_cache(DIMS, 2, jnp.float32)
    cache = jm.KVCache(sk, sv, tuple(map(jm.quantize_kv, ck)), tuple(map(jm.quantize_kv, cv)))
    want, _, _ = jm.decoder_forward(
        params, jnp.asarray([[11], [42]], jnp.int32), cache, jnp.int32(0), n_head
    )
    want = np.asarray(want)

    calls = []
    real = tm.cross_attention_decode
    monkeypatch.setattr(tm, "cross_attention_decode", lambda *a: calls.append(1) or real(*a))
    forced = _step_logits_torch(model, feats, "force", monkeypatch)
    assert len(calls) == DIMS.n_text_layer  # every layer took K3's route
    # the same arithmetic (q rounded to bf16, P to bf16) in both packages
    np.testing.assert_allclose(forced, want, atol=1e-4, rtol=0)
    calls.clear()
    einsum = _step_logits_torch(model, feats, "0", monkeypatch)
    assert not calls
    # the kernel route rounds q and P to bf16, the f32 einsum does not: the
    # tolerance of tests/test_cross_decode.py for the same comparison
    np.testing.assert_allclose(forced, einsum, atol=2e-2, rtol=2e-2)
    assert np.array_equal(forced.argmax(-1), einsum.argmax(-1))


def test_prefill_and_beams_stay_on_the_einsum(nano, monkeypatch):
    """The route needs t_new == 1 and no beam folding, as in JAX."""
    _, model = nano
    monkeypatch.setenv("WHISPERX_TPU_CROSS_DECODE", "force")
    calls = []
    real = tm.cross_attention_decode
    monkeypatch.setattr(tm, "cross_attention_decode", lambda *a: calls.append(1) or real(*a))
    mel = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 3000, DIMS.n_mels)).astype(np.float32))
    decode(model, mel, DecodingOptions(language="en", kv_quant=True, beam_size=2, sample_len=3))
    assert not calls
    decode(model, mel, DecodingOptions(language="en", kv_quant=True, sample_len=3))
    # the prefill (t_new > 1) stays on the einsum; each of the 3 sampled
    # steps feeds its token back through one t_new = 1 pass of every layer
    assert len(calls) == DIMS.n_text_layer * 3


def test_greedy_tokens_with_k3_identical_to_jax(nano, monkeypatch):
    """Greedy decode with the int8 cross-KV cache and the opt-in forced in
    both packages (K3's plain version here, the Pallas kernel in interpret
    mode there): the same tokens, the same no-speech probability."""
    params, model = nano
    monkeypatch.setenv("WHISPERX_TPU_CROSS_DECODE", "force")
    from conftest import synth_speech
    from whisperx_tpu.audio.mel import log_mel_batch as jax_log_mel_batch

    audio = np.stack([synth_speech(30.0, seed=s) for s in (0, 1)])
    mels = np.asarray(jax_log_mel_batch(audio, DIMS.n_mels))
    jmodel = JWhisper(DIMS, params, dtype=jnp.float32, name="test-nano")
    want = jax_decode(
        jmodel, jnp.asarray(mels), JOptions(language="en", kv_quant=True, sample_len=24)
    )
    got = decode(
        model, torch.from_numpy(mels), DecodingOptions(language="en", kv_quant=True, sample_len=24)
    )
    assert [r.tokens for r in got] == [r.tokens for r in want]
    np.testing.assert_allclose(
        [r.no_speech_prob for r in got], [r.no_speech_prob for r in want], atol=1e-5
    )


def _pass_counts():
    c = GLOBAL_TRACKER.counters
    return {k: c.get(k, 0.0) for k in ("cross_decode.kernel_passes", "cross_decode.plain_passes", "step_replays")}


@pytest.mark.parametrize("flag", ["force", None])
def test_counters_count_one_token_passes_by_route(nano, monkeypatch, flag):
    """An eager test-nano greedy decode over the int8 cache counts one pass
    a layer a step, by route: under ``force`` every one on K3's plain
    version, without the opt-in every one on the einsum; the prefill
    (t_new > 1) is in neither count."""
    _, model = nano
    if flag is None:
        monkeypatch.delenv("WHISPERX_TPU_CROSS_DECODE", raising=False)
    else:
        monkeypatch.setenv("WHISPERX_TPU_CROSS_DECODE", flag)
    mel = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 3000, DIMS.n_mels)).astype(np.float32))
    before = _pass_counts()
    decode(model, mel, DecodingOptions(language="en", kv_quant=True, sample_len=3))
    got = {k: v - before[k] for k, v in _pass_counts().items()}
    passes = DIMS.n_text_layer * got["step_replays"]
    assert got["step_replays"] == 3
    kernel, plain = (passes, 0) if flag == "force" else (0, passes)
    assert (got["cross_decode.kernel_passes"], got["cross_decode.plain_passes"]) == (kernel, plain)

"""The port's weight-only quantization against the JAX package on the CPU:
``quantize_weight`` bit for bit, the int4 unpacking and ``dequantize``, the
paths ``quantize_tree`` quantizes, K4's plain version against the Pallas
kernel run in interpret mode and against the XLA dequant-dot, and quantized
checkpoints and trees through the weight bridge."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperx_tpu.convert.checkpoint import flatten_tree, load_checkpoint, save_checkpoint
from whisperx_tpu.models.whisper import Whisper as JWhisper
from whisperx_tpu.models.whisper import model as jm
from whisperx_tpu.models.whisper.config import MODEL_DIMS
from whisperx_tpu.ops.quant_matmul import _quant_matmul_pallas_int8, _quant_matmul_xla
from whisperx_tpu.quant import QuantConfig as JQuantConfig
from whisperx_tpu.quant import QuantizedLinear as JQuantizedLinear
from whisperx_tpu.quant import make_quantized_linear as jax_make_ql
from whisperx_tpu.quant import quantize_model as jax_quantize_model
from whisperx_tpu.quant import quantize_tree as jax_quantize_tree
from whisperx_tpu.quant import quantize_weight as jax_quantize_weight
from whisperx_tpu.quant.core import _unpack_int4 as jax_unpack_int4
from whisperx_tpu.quant.core import dequantize as jax_dequantize
from whisperx_tpu_torch.convert.checkpoint import load_checkpoint as torch_load_checkpoint
from whisperx_tpu_torch.convert.checkpoint import params_from_numpy
from whisperx_tpu_torch.models.whisper import model as tm
from whisperx_tpu_torch.ops.quant_matmul import _quant_matmul_reference, quant_matmul
from whisperx_tpu_torch.quant import (
    QuantConfig,
    QuantizedLinear,
    dequantize,
    make_quantized_linear,
    quantize_model,
    quantize_tree,
    quantize_weight,
)
from whisperx_tpu_torch.quant.core import _unpack_int4
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

DIMS = MODEL_DIMS["test-nano"]
BF16_EPS = 2.0**-7  # one bf16 ulp at magnitude 1 (8 significant bits)


def _weights(seed, d_in=256, d_out=128):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)


@pytest.mark.parametrize("group_size", [32, 64, 128])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_weight_bit_identical_to_jax(mode, group_size):
    w = _weights(group_size)
    # bf16-rounded weights, as compute_type="int8" loads them
    w = np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
    want = jax_quantize_weight(w, mode, group_size)
    got = quantize_weight(w, mode, group_size)
    assert got["qw"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["qw"].numpy(), np.asarray(want["qw"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    assert (got["bits"], got["group_size"]) == (want["bits"], want["group_size"])


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_unpack_and_dequantize_equal_jax(mode):
    w = _weights(7)
    jq, tq = jax_make_ql(w, mode, 64), make_quantized_linear(w, mode, 64)
    if mode == "int4":
        np.testing.assert_array_equal(
            _unpack_int4(tq.qw, 64).numpy(), np.asarray(jax_unpack_int4(jq.qw, 64))
        )
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(
            dequantize(tq, tdt).float().numpy(),
            np.asarray(jax_dequantize(jq, jdt).astype(jnp.float32)),
        )


def _jax_quantized_paths(tree, path=""):
    if isinstance(tree, JQuantizedLinear):
        return {path}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return set()
    return set().union(*(_jax_quantized_paths(v, f"{path}/{k}") for k, v in items))


@pytest.mark.parametrize(
    "n_layer,group_size,min_size",
    [(2, 64, 4096), (4, 64, 4096), (2, 128, 4096), (2, 64, 8192)],
    ids=["depth2", "depth4", "group-skips", "min-size-skips"],
)
def test_quantize_tree_same_paths_as_jax(n_layer, group_size, min_size):
    """At depth 4 the first and last decoder blocks stay full precision; the
    encoder, the conv stem and the embeddings always do; a group size that
    does not divide d_in, or a matrix under min_size, is skipped."""
    dims = dataclasses.replace(DIMS, n_text_layer=n_layer)
    params = jm.init_params(dims, jax.random.PRNGKey(0), dtype=jnp.float32)
    jcfg = JQuantConfig(group_size=group_size, min_size=min_size)
    want = _jax_quantized_paths(jax_quantize_tree(params, jcfg))
    model = params_from_numpy(flatten_tree(params), dims, torch.float32, "cpu")
    quantize_tree(model, QuantConfig(group_size=group_size, min_size=min_size))
    got = {
        "/" + name.replace(".", "/")
        for name, mod in model.named_modules()
        if isinstance(mod, QuantizedLinear)
    }
    assert got == want and got
    assert all(p.startswith("/decoder/blocks/") for p in got)
    if n_layer == 4:
        assert not any(p.startswith(("/decoder/blocks/0/", "/decoder/blocks/3/")) for p in got)


def _operands(m, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, 256)).astype(np.float32)
    w = _weights(seed + 100, 256, 128)  # K = 256 (4 groups of 64), N = 128
    return x, jax_make_ql(w, "int8", 64), make_quantized_linear(w, "int8", 64)


@pytest.mark.parametrize("m", [5, 8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_pallas_interpret(m, dtype):
    """K4's plain version computes what the TPU kernel computes. f32: the
    sums differ only in order (rtol 1e-5). bf16: both round one f32 sum
    once, so they agree to one bf16 ulp of the output."""
    x, jq, tq = _operands(m, seed=m)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(
        _quant_matmul_pallas_int8(jnp.asarray(x, jdt), jq.qw, jq.scale, 64, interpret=True)
        .astype(jnp.float32)
    )
    got = _quant_matmul_reference(torch.from_numpy(x).to(tdt), tq.qw, tq.scale, 64)
    assert got.dtype == tdt and got.shape == (m, 128)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_EPS * np.abs(want).max())


@pytest.mark.parametrize("m", [5, 8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_xla_dequant_dot(m, dtype):
    """The XLA route dequantizes the weight and rounds it to x's dtype
    before one dot, so in bf16 it differs from K4 by that weight rounding
    (each weight off by up to half a bf16 ulp; over K = 256 terms of O(1)
    inputs the sums stay within 2⁻⁶·max|y|); in f32 only by order (1e-5)."""
    x, jq, tq = _operands(m, seed=2 * m)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(_quant_matmul_xla(jnp.asarray(x, jdt), jq).astype(jnp.float32))
    got = quant_matmul(torch.from_numpy(x).to(tdt), tq).float().numpy()
    tol = 1e-5 if dtype == "float32" else 2.0**-6
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def test_int4_runs_the_dequant_dot_like_jax():
    """int4 has no kernel in either package: dequantize, then one product."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 256)).astype(np.float32)
    w = _weights(5)
    want = np.asarray(_quant_matmul_xla(jnp.asarray(x.reshape(21, 256)), jax_make_ql(w, "int4", 64)))
    got = quant_matmul(torch.from_numpy(x), make_quantized_linear(w, "int4", 64))
    assert got.shape == (3, 7, 128)
    np.testing.assert_allclose(got.reshape(21, 128).numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def nano_bf16():
    params = jm.init_params(DIMS, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    return JWhisper(DIMS, params, dtype=jnp.bfloat16, name="test-nano")


def _linear_outputs(jlin, tlin, x):
    """(JAX's linear output, the port's) for one layer on bf16 x."""
    want = jm.linear(jlin, jnp.asarray(x, jnp.bfloat16))
    got = tm.linear(tlin, torch.from_numpy(x).to(torch.bfloat16))
    return want, got


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("route", ["checkpoint", "in_memory"])
def test_quantized_linear_outputs_and_dtype_follow_jax(nano_bf16, tmp_path, mode, route):
    """Loaded from a JAX-written quantized checkpoint, a linear's bias stays
    f32 (the JAX loader leaves quantized arrays uncast), so ``y + b``
    promotes the bf16 product to f32; quantized in memory, the bias keeps the
    model's bf16 and so does the output. The port follows each route. The
    values agree to one bf16 ulp of the product (the two CPU routes round
    differently: XLA dequant-dot vs K4's arithmetic)."""
    jq = jax_quantize_model(nano_bf16, mode=mode)
    if route == "checkpoint":
        config = {"name": "nano", "family": "whisper", "dims": dataclasses.asdict(DIMS)}
        save_checkpoint(str(tmp_path), jq.params, config)
        jparams, _ = load_checkpoint(str(tmp_path), jnp.bfloat16)
        tmodel, _ = torch_load_checkpoint(str(tmp_path), torch.bfloat16, "cpu")
    else:
        jparams = jq.params
        tmodel = params_from_numpy(flatten_tree(nano_bf16.params), DIMS, torch.bfloat16, "cpu")
        quantize_model(tmodel, mode=mode)
    x = np.random.default_rng(3).standard_normal((2, 5, DIMS.n_text_state)).astype(np.float32)
    jblk, tblk = jparams["decoder"]["blocks"][1], tmodel.decoder.blocks[1]
    for jlin, tlin in (
        (jblk["attn"]["query"], tblk.attn.query),  # with a bias
        (jblk["attn"]["key"], tblk.attn.key),  # without
    ):
        assert isinstance(tlin, QuantizedLinear) and tlin.bits == (8 if mode == "int8" else 4)
        np.testing.assert_array_equal(tlin.qw.numpy(), np.asarray(jlin.qw))
        np.testing.assert_array_equal(tlin.scale.numpy(), np.asarray(jlin.scale))
        want, got = _linear_outputs(jlin, tlin, x)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(
            got.float().numpy(), want, rtol=0, atol=2 * BF16_EPS * np.abs(want).max()
        )
    expected_b = jnp.float32 if route == "checkpoint" else jnp.bfloat16
    assert str(tblk.attn.query.b.dtype).split(".")[-1] == str(jnp.dtype(expected_b))


def test_bridge_takes_a_jax_quantized_tree(nano_bf16):
    """``flatten_tree`` of a JAX quantized tree → the same QuantizedLinears
    (bits, group size, codes, scales) in the port; the rest stays in
    ``parameters()`` in the model dtype."""
    jq = jax_quantize_model(nano_bf16, mode="int8", group_size=32)
    flat = flatten_tree(jq.params)
    model = params_from_numpy(flat, DIMS, torch.bfloat16, "cpu")
    quantized = {
        name: mod for name, mod in model.named_modules() if isinstance(mod, QuantizedLinear)
    }
    assert {"/" + n.replace(".", "/") for n in quantized} == _jax_quantized_paths(jq.params)
    for name, mod in quantized.items():
        key = name.replace(".", "/") + "/__quantized_linear__"
        assert (mod.bits, mod.group_size) == (8, 32)
        np.testing.assert_array_equal(mod.qw.numpy(), flat[f"{key}/qw"])
        np.testing.assert_array_equal(mod.scale.numpy(), flat[f"{key}/scale"])
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    bad = dict(flat)
    bad["decoder/blocks/1/attn/query/__quantized_linear__/scale"] = np.zeros((1, 64), np.float32)
    with pytest.raises(ValueError, match="quantized shapes"):
        params_from_numpy(bad, DIMS, torch.bfloat16, "cpu")


def test_flatten_tree_lays_out_like_jax():
    """The port's ``flatten_tree`` of a quantized model writes the JAX
    package's names and arrays, marker layout included."""
    from whisperx_tpu.convert.checkpoint import flatten_tree as jax_flatten
    from whisperx_tpu_torch.convert.checkpoint import flatten_tree

    params = jm.init_params(DIMS, jax.random.PRNGKey(1), dtype=jnp.float32)
    want = jax_flatten(jax_quantize_model(JWhisper(DIMS, params, dtype=jnp.float32), mode="int8").params)
    model = params_from_numpy(jax_flatten(params), DIMS, torch.float32, "cpu")
    got = flatten_tree(quantize_model(model, mode="int8"))
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# K4's launch plan (``launch_plan``) at every shape the models give it: the
# decoder linears (d, d), (d, 4d), (4d, d) of large-v3 and test-nano at the
# rows of a greedy and a beam-5 step, the beam-5 prefill and the cross-KV
# projection of 8 x 1500 frames
_PLAN_SHAPES = [
    (arch, m, k, n)
    for arch, d in (("large-v3", 1280), ("test-nano", 64))
    for m in (8, 40, 120, 12000)
    for k, n in ((d, d), (d, 4 * d), (4 * d, d))
    if m != 12000 or k == n
]


@pytest.mark.parametrize(
    "arch,m,k,n", _PLAN_SHAPES, ids=[f"{a}-M{m}-K{k}-N{n}" for a, m, k, n in _PLAN_SHAPES]
)
def test_launch_plan_covers_k_in_whole_groups(arch, m, k, n):
    """Split K for the decode and prefill rows, wgmma tiles for the cross-KV
    product; every slice is a run of whole groups, the slices cover K
    exactly, the grid fits CUDA's limits, and large-v3's decode steps give
    at least two blocks per SM (132 SMs)."""
    from whisperx_tpu_torch.ops.quant_matmul import SM_COUNT, launch_plan

    group = 64
    plan = launch_plan(m, k, n, group)
    gx, gy = plan["grid"]
    assert 1 <= gx <= 2**31 - 1 and 1 <= gy <= 65535
    if m > 128:
        assert plan["regime"] == "wgmma" and plan["slices"] == 1
        assert gx * 128 >= n and gy * 128 >= m
        return
    assert plan["regime"] == "split_k" and gy == plan["slices"]
    assert gx * 64 >= n > (gx - 1) * 64
    ranges = plan["group_ranges"]
    assert len(ranges) == plan["slices"] and ranges[0][0] == 0 and ranges[-1][1] * group == k
    assert all(a < b for a, b in ranges)  # no slice is empty
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(len(ranges) - 1))
    if arch == "large-v3" and m in (8, 40):
        assert gx * gy >= 2 * SM_COUNT


@pytest.mark.parametrize(
    "m,k,n,group,regime",
    [(40, 1280, 1280, 32, "tiled"), (40, 1280, 100, 64, "tiled"), (40, 1280, 1280, 128, "split_k"),
     (12000, 1280, 1280, 128, "wgmma")],
)
def test_launch_plan_sends_other_groups_and_ragged_n_to_the_tiled_path(m, k, n, group, regime):
    from whisperx_tpu_torch.ops.quant_matmul import launch_plan

    plan = launch_plan(m, k, n, group)
    assert plan["regime"] == regime
    assert launch_plan(m, k, n, group, torch.float32)["regime"] == "f32"
    assert launch_plan(m, k, 128, 64, aligned=False)["regime"] == "tiled"


def _split_k_emulation(x, qw, scale, group, plan):
    """The split-K kernel's order of sums in plain torch: each slice adds
    its groups' scaled f32 partials from zero, then the slices are added in
    slice order and the sum is cast once."""
    xf = x.float()
    total = None
    for g0, g1 in plan["group_ranges"]:
        acc = torch.zeros((x.shape[0], qw.shape[1]))
        for g in range(g0, g1):
            rows = slice(g * group, (g + 1) * group)
            acc = acc + torch.matmul(xf[:, rows], qw[rows].float()) * scale[g]
        total = acc if total is None else total + acc
    return total.to(x.dtype)


@pytest.mark.parametrize("m,k", [(5, 256), (40, 640)])
def test_split_k_order_matches_reference_and_pallas(m, k):
    """The split-K order of sums stays within one bf16 ulp of the output
    (2⁻⁷·max|ref|, the tolerance ``chip_smoke.py`` holds K4 to) of the
    plain version and of the Pallas kernel in interpret mode."""
    from whisperx_tpu_torch.ops.quant_matmul import launch_plan

    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = _weights(k, k, 128)
    jq, tq = jax_make_ql(w, "int8", 64), make_quantized_linear(w, "int8", 64)
    plan = launch_plan(m, k, 128, 64)
    assert plan["regime"] == "split_k" and plan["slices"] == k // 64  # one group a slice
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = _split_k_emulation(xt, tq.qw, tq.scale, 64, plan).float().numpy()
    ref = _quant_matmul_reference(xt, tq.qw, tq.scale, 64).float().numpy()
    pallas = np.asarray(
        _quant_matmul_pallas_int8(jnp.asarray(x, jnp.bfloat16), jq.qw, jq.scale, 64, interpret=True)
        .astype(jnp.float32)
    )
    for want in (ref, pallas):
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_EPS * np.abs(want).max())

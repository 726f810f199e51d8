"""The port's Whisper model against the JAX package on f32 ``test-nano``: the
same parameters (JAX ``init_params`` → ``flatten_tree`` → the port's
``params_from_numpy``), the same numpy inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperx_tpu.convert.checkpoint import flatten_tree, save_checkpoint
from whisperx_tpu.convert.checkpoint import unflatten_tree as jax_unflatten
from whisperx_tpu.models.whisper import model as jm
from whisperx_tpu.models.whisper.config import MODEL_DIMS
from whisperx_tpu_torch.convert.checkpoint import (
    load_checkpoint,
    params_from_numpy,
    unflatten_tree,
)
from whisperx_tpu_torch.models.whisper import model as tm
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

DIMS = MODEL_DIMS["test-nano"]
# f32 activations of O(1) after layer norms; the two frameworks sum in
# different orders, so agreement is to ~1e-6 relative — 1e-4 absolute
ATOL = 1e-4


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(DIMS, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def model(jax_params):
    return params_from_numpy(flatten_tree(jax_params), DIMS, torch.float32, "cpu")


@pytest.fixture(scope="module")
def mel():
    rng = np.random.default_rng(0)
    return rng.standard_normal((2, 3000, DIMS.n_mels)).astype(np.float32)


def test_bridge_names_every_parameter(jax_params, model):
    flat = flatten_tree(jax_params)
    state = model.state_dict()
    assert {k.replace(".", "/") for k in state} == set(flat)
    for key, t in state.items():
        np.testing.assert_array_equal(t.numpy(), flat[key.replace(".", "/")])


def test_bridge_rejects_missing_and_misshapen(jax_params):
    flat = flatten_tree(jax_params)
    missing = dict(flat)
    missing.pop("decoder/ln/g")
    with pytest.raises(KeyError, match="decoder/ln/g"):
        params_from_numpy(missing, DIMS, torch.float32, "cpu")
    bad = dict(flat)
    bad["decoder/ln/g"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="decoder.ln.g"):
        params_from_numpy(bad, DIMS, torch.float32, "cpu")


def test_unflatten_tree_matches_jax(jax_params):
    flat = flatten_tree(jax_params)
    ours, theirs = unflatten_tree(flat), jax_unflatten(flat)
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)


def test_load_checkpoint_casts_like_jax(jax_params, tmp_path):
    """A JAX-written checkpoint loads in bf16 with the same rounding."""
    save_checkpoint(
        str(tmp_path), jax_params,
        {"name": "nano", "family": "whisper", "dims": dataclasses.asdict(DIMS)},
    )
    model, config = load_checkpoint(str(tmp_path), torch.bfloat16, "cpu")
    assert config["dims"] == dataclasses.asdict(DIMS)
    w = jax_params["decoder"]["blocks"][1]["mlp1"]["w"]
    np.testing.assert_array_equal(
        model.decoder.blocks[1].mlp1.w.float().numpy(),
        np.asarray(w.astype(jnp.bfloat16).astype(jnp.float32)),
    )


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_stem_matches_jax(jax_params, model, mel, stride):
    p = jax_params["encoder"]["conv1"]
    want = np.asarray(jm._conv1d(p, jnp.asarray(mel), stride))
    got = tm._conv1d(model.encoder.conv1, torch.from_numpy(mel), stride)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_layer_norm_and_linear_bf16_match_jax(jax_params, mel):
    """bf16 primitives on the CPU: f32 statistics / accumulation, one
    rounding — equal to JAX's up to one bf16 ulp of the O(1) outputs."""
    p = jax_params["encoder"]["blocks"][0]
    tmodel = params_from_numpy(flatten_tree(jax_params), DIMS, torch.bfloat16, "cpu")
    blk = tmodel.encoder.blocks[0]
    x = np.random.default_rng(1).standard_normal((2, 5, 64)).astype(np.float32)
    pb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    for want, got in (
        (jm.layer_norm(pb["attn_ln"], xj), tm.layer_norm(blk.attn_ln, xt)),
        (jm.linear(pb["mlp1"], xj), tm.linear(blk.mlp1, xt)),
    ):
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=2e-2, rtol=1e-2
        )


def test_encoder_features_match_jax(jax_params, model, mel):
    want = np.asarray(jm.encoder_forward(jax_params, jnp.asarray(mel), DIMS.n_audio_head))
    got = tm.encoder_forward(model.encoder, torch.from_numpy(mel), DIMS.n_audio_head)
    assert got.shape == (2, 1500, DIMS.n_audio_state)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_quantize_kv_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 1500, 2, 32)).astype(np.float32)
    want = jm.quantize_kv(jnp.asarray(x))
    got = tm.quantize_kv(torch.from_numpy(x))
    assert got.q8.dtype == torch.int8
    np.testing.assert_array_equal(got.q8.numpy(), np.asarray(want.q8))
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), atol=0, rtol=1e-6)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_and_step_logits_match_jax(jax_params, model, mel, kv_quant):
    """Prefill over a 3-token prefix, then one decode step at offset 3."""
    n_head = DIMS.n_text_head
    feats = jm.encoder_forward(jax_params, jnp.asarray(mel), DIMS.n_audio_head)
    jk, jv = jm.precompute_cross_kv(jax_params, feats, n_head)
    tk, tv = tm.precompute_cross_kv(
        model.decoder, torch.from_numpy(np.asarray(feats)), n_head
    )
    if kv_quant:
        jk, jv = tuple(map(jm.quantize_kv, jk)), tuple(map(jm.quantize_kv, jv))
        tk, tv = [tm.quantize_kv(x) for x in tk], [tm.quantize_kv(x) for x in tv]
    shape = (2, 64, n_head, DIMS.n_text_state // n_head)
    zeros = lambda: tuple(jnp.zeros(shape, jnp.float32) for _ in range(DIMS.n_text_layer))
    jcache = jm.KVCache(zeros(), zeros(), jk, jv)
    tcache = tm.KVCache(
        [torch.zeros(shape) for _ in range(DIMS.n_text_layer)],
        [torch.zeros(shape) for _ in range(DIMS.n_text_layer)],
        tk, tv,
    )
    prefix = np.array([[50258, 50259, 50359]] * 2, np.int64)
    want, jcache, _ = jm.decoder_forward(
        jax_params, jnp.asarray(prefix, jnp.int32), jcache, jnp.int32(0), n_head
    )
    got = tm.decoder_forward(model.decoder, torch.from_numpy(prefix), tcache, 0, n_head)
    assert got.dtype == torch.float32 and got.shape == (2, 3, DIMS.n_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    for i in range(DIMS.n_text_layer):  # the in-place cache write
        np.testing.assert_allclose(
            tcache.self_k[i].numpy(), np.asarray(jcache.self_k[i]), atol=ATOL, rtol=0
        )

    step = np.array([[50364], [50400]], np.int64)
    want, _, _ = jm.decoder_forward(
        jax_params, jnp.asarray(step, jnp.int32), jcache, jnp.int32(3), n_head
    )
    got = tm.decoder_forward(model.decoder, torch.from_numpy(step), tcache, 3, n_head)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)

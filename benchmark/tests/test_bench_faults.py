"""The check fails a broken timed path. Each test drives a whole run at
test-nano on the CPU (the harness's look for a chip is the caller's, so it
is skipped here) with the port broken underneath, and ``correct`` must come
out false: a token altered where it is produced, early or late in the
decode; decoder passes that leave their state unchanged; half of each
device batch left out (every second row decoded as its neighbour); the
loaded model's biases and layer-norm affine left out. A cell on one chip
has no exchange between chips to leave out."""

import importlib

import pytest

import nano


def _decode_module():
    return importlib.import_module("whisperx_tpu_torch.decoding.decode")


def _altered_at(position: int):
    def fault(mp):
        decode = _decode_module()
        orig = decode._sample_step

        def step(dec, s, cfg):
            orig(dec, s, cfg)
            k = int(s.state.step[0]) - 1  # the token this step wrote
            if k == position:
                s.tokens[:, k] = (s.tokens[:, k] + 7919) % 50000

        mp.setattr(decode, "_sample_step", step)

    fault.__name__ = f"_alter_token_at_{position}"
    return fault


def _biases_dropped(mp):
    """The loader zeroes every bias and layer-norm shift and sets every
    gain to one."""
    from whisperx_tpu_torch.convert import checkpoint

    orig = checkpoint.params_from_numpy

    def load(flat, *a, **kw):
        flat = {k: (v * 0 + (1 if k.endswith("/g") else 0)) if k.endswith(("/b", "/g")) else v
                for k, v in flat.items()}
        return orig(flat, *a, **kw)

    mp.setattr(checkpoint, "params_from_numpy", load)


def _state_unchanged(mp):
    """Every decoder pass (the prefill's and each step's) leaves the
    self-attention cache as it found it: its writes go to a copy."""
    decode = _decode_module()
    orig = decode.decoder_forward

    def forward(dec, tokens, cache, *a, **kw):
        copy = type(cache)([k.clone() for k in cache.self_k], [v.clone() for v in cache.self_v],
                           cache.cross_k, cache.cross_v)
        return orig(dec, tokens, copy, *a, **kw)

    mp.setattr(decode, "decoder_forward", forward)


def _half_batch(mp):
    from whisperx_tpu_torch import asr

    orig = asr.decode_dispatch

    def dispatch(model, rows, *a, **kw):
        rows = rows.clone()
        rows[1::2] = rows[0::2][: rows[1::2].shape[0]]
        return orig(model, rows, *a, **kw)

    mp.setattr(asr, "decode_dispatch", dispatch)


@pytest.mark.parametrize("kind", ["offline", "serve"])
@pytest.mark.parametrize("fault", [_altered_at(1), _altered_at(20), _state_unchanged, _half_batch,
                                   _biases_dropped])
def test_a_broken_path_is_not_correct(kind, fault, monkeypatch):
    fault(monkeypatch)
    out = nano.run(kind)
    assert not out["correct"], out["checks"]


def test_the_control_reads_above_the_limit_on_three_seeds():
    """The control (``reference/whisper.py``'s fp8 e4m3 products) in the
    program's place is not correct under the limit that the program's own
    tokens meet in the same run."""
    for seed in (11, 2**33 + 5, 987654321):
        out = nano.run("serve", seed=seed, control=True)
        assert not out["correct"], out["checks"]
        assert out["checks"]["max_gap"]["value"] > nano.LIMIT >= out["extra"]["program_gap"]

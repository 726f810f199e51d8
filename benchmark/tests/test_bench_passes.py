"""``cross_kernel_share`` (``harness/passes.py``): None on a window whose
program counts no cross-attention pass (a checkout without the counters),
and in a traced test-nano run on the CPU the share of the one-token passes
that took K3's route: every one under the opt-in's ``force``, which sends
CPU tensors to K3's plain version."""

from types import SimpleNamespace

import pytest

import nano
from harness import passes


@pytest.mark.parametrize("counters,want", [
    ({}, None),
    ({"step_replays": 5.0}, None),
    ({"cross_decode.kernel_passes": 0.0, "cross_decode.plain_passes": 0.0}, None),
    ({"cross_decode.kernel_passes": 30.0, "cross_decode.plain_passes": 10.0}, 75.0),
    ({"cross_decode.plain_passes": 8.0}, 0.0),
])
def test_share_of_kernel_passes(counters, want):
    assert passes.cross_kernel_share(SimpleNamespace(tracker={"counters": counters})) == want


def test_traced_run_reads_every_pass_on_the_kernel_route(monkeypatch):
    monkeypatch.setenv("WHISPERX_TPU_CROSS_DECODE", "force")
    out = nano.run("offline", trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["cross_kernel_share.offline"]["value"] == 100.0

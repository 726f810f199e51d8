"""The arithmetic of the per-layer metrics that read the port's counts of
the decoder's one-token cross-attention passes by route: the window's
deltas of ``utils/metrics.py::GLOBAL_TRACKER``'s counters
``cross_decode.kernel_passes`` (through K3, which reads the int8 cache in
place) and ``cross_decode.plain_passes`` (the einsum), one a layer a pass,
added once a replay on the card. Each metric's own file under ``metrics/``
names the function it reads with. Every function returns None where its
window gives it nothing to read, as on a checkout whose program has no such
counter."""

from __future__ import annotations

from typing import Optional


def cross_kernel_share(ctx) -> Optional[float]:
    """Kernel passes over all one-token cross-attention passes, %."""
    c = ctx.tracker.get("counters", {})
    kernel = c.get("cross_decode.kernel_passes", 0.0)
    total = kernel + c.get("cross_decode.plain_passes", 0.0)
    return 100.0 * kernel / total if total else None

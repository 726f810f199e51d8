"""The optimizer the trainers use: Adam with optax's defaults and optax's
``warmup_cosine_decay_schedule``.

Counterpart of the JAX trainers' ``optax.adam(schedule)`` and
``optax.apply_updates``. ``torch.optim.Adam``'s update is optax's formula
(``-lr · m̂ / (√v̂ + ε)``, ε outside the root, β 0.9 / 0.999, ε 1e-8).
optax evaluates a schedule at the count of updates made BEFORE the one it
scales: the first update uses ``schedule(0)``; ``Adam.step`` does the same.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Union

import numpy as np
import torch

Schedule = Callable[[int], float]


def warmup_cosine_decay_schedule(
    init_value: float,
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
    end_value: float = 0.0,
) -> Schedule:
    """optax 0.2.6's schedule of the same name, evaluated in f32 in its order
    of operations: a linear ramp from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then a cosine decay to ``end_value`` that reaches it at
    ``decay_steps`` (warmup included) and stays there."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed warmup_steps ({warmup_steps})")
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = f32(decay_steps - warmup_steps)

    def linear(count: int) -> np.float32:
        if warmup_steps <= 0:
            return f32(init_value)
        frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(warmup_steps)
        return f32(init_value - peak_value) * frac + f32(peak_value)

    def cosine(count: int) -> np.float32:
        c = min(f32(count), cos_steps)
        decay = f32(0.5) * (f32(1) + f32(math.cos(f32(math.pi) * c / cos_steps)))
        return f32(peak_value) * (f32(1 - alpha) * decay + f32(alpha))

    def schedule(count: int) -> float:
        return float(linear(count) if count < warmup_steps else cosine(count - warmup_steps))

    return schedule


class Adam:
    """``optax.adam(learning_rate)`` on ``params``: a constant learning rate
    or a schedule of the update count. After each backward pass, ``step()``
    sets the rate for the count of updates made so far, updates every
    parameter that has a gradient and clears the gradients."""

    def __init__(self, params: Iterable[torch.Tensor], learning_rate: Union[float, Schedule]):
        self.schedule = learning_rate if callable(learning_rate) else (lambda _count: learning_rate)
        self.count = 0
        self._opt = torch.optim.Adam(
            list(params), lr=float(self.schedule(0)), betas=(0.9, 0.999), eps=1e-8
        )

    def step(self) -> None:
        lr = float(self.schedule(self.count))
        for group in self._opt.param_groups:
            group["lr"] = lr
        self._opt.step()
        self._opt.zero_grad(set_to_none=True)
        self.count += 1

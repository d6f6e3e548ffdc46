"""Learning-rate schedules.

Port of `diffusers_tpu/training/optimization.py` (`get_scheduler` `:15-67`).
A schedule is a plain function from the update count (0 at the first update,
optax's count) to the learning rate, with optax's semantics: the linear
warmup from 0 is joined at `warmup` and the main schedule then counts from 0.
`lr_lambda_scheduler` drives one with `torch.optim.lr_scheduler.LambdaLR`.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: init -> end over `steps` updates, then end."""
    if steps <= 0:
        return lambda step: init
    return lambda step: init + (end - init) * min(max(step, 0), steps) / steps


def _polynomial(init: float, end: float, power: float, steps: int) -> Schedule:
    """optax.polynomial_schedule."""
    if steps <= 0:
        return lambda step: init
    return lambda step: (init - end) * (1 - min(max(step, 0), steps) / steps) ** power + end


def _join(first: Schedule, then: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules with one boundary: `then` counts from 0 at it."""
    return lambda step: first(step) if step < boundary else then(step - boundary)


def get_scheduler(
    name: str,
    learning_rate: float = 1e-4,
    num_warmup_steps: Optional[int] = None,
    num_training_steps: Optional[int] = None,
    num_cycles: float = 0.5,
    power: float = 1.0,
) -> Schedule:
    """constant / constant_with_warmup / linear / cosine / cosine_with_restarts /
    polynomial: the JAX package's schedules as step -> learning rate."""
    warmup = num_warmup_steps or 0
    warm = _linear(0.0, learning_rate, warmup)

    if name == "constant":
        return lambda step: learning_rate
    if name == "constant_with_warmup":
        return _join(warm, lambda step: learning_rate, warmup)
    if num_training_steps is None:
        raise ValueError(f"schedule '{name}' requires num_training_steps")
    decay_steps = max(num_training_steps - warmup, 1)

    if name == "linear":
        main = _linear(learning_rate, 0.0, decay_steps)
    elif name == "cosine":

        def main(step):
            progress = min(max(step / decay_steps, 0.0), 1.0)
            return learning_rate * max(0.0, 0.5 * (1.0 + math.cos(math.pi * 2.0 * num_cycles * progress)))

    elif name == "cosine_with_restarts":

        def main(step):
            progress = min(max(step / decay_steps, 0.0), 1.0 - 1e-9)
            return learning_rate * max(0.0, 0.5 * (1.0 + math.cos(math.pi * ((num_cycles * progress) % 1.0))))

    elif name == "polynomial":
        main = _polynomial(learning_rate, 0.0, power, decay_steps)
    else:
        raise ValueError(f"unknown schedule {name}")
    return _join(warm, main, warmup) if warmup else main


def lr_lambda_scheduler(optimizer: torch.optim.Optimizer, schedule: Schedule) -> torch.optim.lr_scheduler.LambdaLR:
    """A `LambdaLR` that sets every group's learning rate to `schedule(step)`
    (the optimizer's own lr is replaced by 1.0, the base that LambdaLR
    multiplies). Its `step()` after each optimizer step advances the count."""
    for group in optimizer.param_groups:
        group["lr"] = 1.0
        group["initial_lr"] = 1.0
    return torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)

"""TaylorSeer cache: Taylor-series extrapolation of the denoiser's output
across denoise steps.

Port of `diffusers_tpu/hooks/taylorseer.py` (paper arXiv:2503.06923). The
compute/predict decision depends only on the step index, so it is made on
the host (`taylorseer_compute_mask`). Where JAX traces both branches under a
`lax.cond`, the eager loop runs only the branch taken: a predicted step
evaluates the Taylor polynomial and launches nothing of the model.

The factors are a tensor on the model output's device, in its dtype (bf16
for SDXL on the card, as JAX holds them in `out_sd.dtype`). The two counters
are host integers: every decision that reads them is made on the host, so
the masking of orders that are not yet valid costs no device work.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class TaylorSeerCacheConfig:
    """Full forwards every `cache_interval` steps (predictions in between),
    no caching before `disable_cache_before_step` or at/after
    `disable_cache_after_step`, Taylor expansion up to `max_order`."""

    cache_interval: int = 5
    disable_cache_before_step: int = 3
    disable_cache_after_step: Optional[int] = None
    max_order: int = 1


def taylorseer_compute_mask(num_steps: int, config: TaylorSeerCacheConfig) -> np.ndarray:
    """bool[num_steps], True where the model runs a full forward."""
    steps = np.arange(num_steps)
    warmup = steps < config.disable_cache_before_step
    interval = (steps - config.disable_cache_before_step - 1) % config.cache_interval == 0
    cooldown = (
        steps >= config.disable_cache_after_step
        if config.disable_cache_after_step is not None
        else np.zeros(num_steps, dtype=bool)
    )
    return warmup | interval | cooldown


class TaylorSeerState:
    """factors[j] ~ the j-th divided difference of the model output
    (factors[0] is the output itself); order j is valid once `n_updates > j`."""

    def __init__(self, factors: torch.Tensor, last_update_step: int = 0, n_updates: int = 0):
        self.factors = factors  # [max_order + 1, *out_shape]
        self.last_update_step = last_update_step
        self.n_updates = n_updates


def init_taylorseer_state(out_shape: Tuple[int, ...], max_order: int = 1, dtype=torch.float32,
                          device=None) -> TaylorSeerState:
    return TaylorSeerState(torch.zeros((max_order + 1, *out_shape), dtype=dtype, device=device))


def _round(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`, as a JAX scalar of that dtype holds it."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))


def taylorseer_apply(
    state: TaylorSeerState,
    step_idx: int,
    should_compute: bool,
    model_fn: Callable[[], torch.Tensor],
) -> Tuple[torch.Tensor, TaylorSeerState]:
    """Run the model and update the divided differences, or predict by the
    Taylor expansion. Returns (output, new state)."""
    factors = state.factors
    dtype, max_order = factors.dtype, factors.shape[0] - 1
    if should_compute:
        y = model_fn()
        # first update: no differences yet (delta 1); a step distance is exact in any float dtype
        delta = float(step_idx - state.last_update_step) if state.n_updates > 0 else 1.0
        delta = torch.tensor(delta, dtype=dtype, device=factors.device)  # a true division, on the card too
        new = [y.to(dtype)]
        for j in range(max_order):
            # a divided difference is valid only once an order-j factor existed before
            new.append((new[j] - factors[j]) / delta if state.n_updates > j else torch.zeros_like(new[j]))
        return y, TaylorSeerState(torch.stack(new), step_idx, state.n_updates + 1)

    offset = step_idx - state.last_update_step
    out = torch.zeros_like(factors[0])
    for order in range(max_order + 1):
        if state.n_updates > order:  # factor j needs j + 1 past updates
            coeff = _round(_round(float(offset) ** order, dtype) / math.factorial(order), dtype)
            out = out + coeff * factors[order]
    return out, state

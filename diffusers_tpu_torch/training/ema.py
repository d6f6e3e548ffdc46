"""EMA of model parameters.

Port of `diffusers_tpu/training/ema.py` (`EMAModel` `:28-69`): the same decay
warmup (``(1 + step) / (10 + step)``, or ``1 - (1 + step / inv_gamma) **
-power`` with `use_ema_warmup`, capped at `decay`, 0 at the first update,
floored at `min_decay`) and the same update ``s - (1 - decay) (s - p)``. The
JAX version returns a new state; this one keeps an f32 shadow copy of the
parameters and updates it in place with `torch._foreach_*` ops, one fused
launch per op over all tensors.
"""

from __future__ import annotations

from typing import Iterable, List

import torch


class EMAModel:
    def __init__(
        self,
        parameters: Iterable[torch.Tensor],
        decay: float = 0.9999,
        min_decay: float = 0.0,
        update_after_step: int = 0,
        use_ema_warmup: bool = False,
        inv_gamma: float = 1.0,
        power: float = 2 / 3,
    ):
        self.decay = decay
        self.min_decay = min_decay
        self.update_after_step = update_after_step
        self.use_ema_warmup = use_ema_warmup
        self.inv_gamma = inv_gamma
        self.power = power
        self.shadow_params: List[torch.Tensor] = [p.detach().float().clone() for p in parameters]
        self.optimization_step = 0

    def get_decay(self, optimization_step: int) -> float:
        """The decay at update `optimization_step` (counted from 1)."""
        step = max(optimization_step - self.update_after_step - 1, 0)
        if step <= 0:
            return max(0.0, self.min_decay)
        if self.use_ema_warmup:
            cur_decay = 1 - (1 + step / self.inv_gamma) ** -self.power
        else:
            cur_decay = (1 + step) / (10 + step)
        return max(min(cur_decay, self.decay), self.min_decay)

    @torch.no_grad()
    def step(self, parameters: Iterable[torch.Tensor]) -> None:
        """One EMA update from the model's current parameters."""
        self.optimization_step += 1
        decay = self.get_decay(self.optimization_step)
        params = [p.detach().float() for p in parameters]
        diffs = torch._foreach_sub(self.shadow_params, params)
        torch._foreach_mul_(diffs, 1 - decay)
        torch._foreach_sub_(self.shadow_params, diffs)

    @torch.no_grad()
    def copy_to(self, parameters: Iterable[torch.Tensor]) -> None:
        """Write the shadow values into `parameters` (in their dtypes)."""
        for s, p in zip(self.shadow_params, parameters):
            p.copy_(s)

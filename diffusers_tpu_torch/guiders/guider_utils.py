"""Guidance base class and shared math.

Port of `diffusers_tpu/guiders/guider_utils.py`: a guider is pure,
``__call__(pred_cond, pred_uncond, step, num_steps)`` returns the guided
prediction, and the start / stop gate is a tensor, so a step given as a
Python number or as a tensor gates the same way.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configuration_utils import ConfigMixin


def rescale_noise_cfg(noise_cfg: torch.Tensor, noise_pred_text: torch.Tensor,
                      guidance_rescale: float = 0.0) -> torch.Tensor:
    """Sec. 3.4 of https://huggingface.co/papers/2305.08891 (population
    standard deviations over every axis but the batch)."""
    dims = tuple(range(1, noise_pred_text.ndim))
    std_text = noise_pred_text.std(dim=dims, keepdim=True, correction=0)
    std_cfg = noise_cfg.std(dim=dims, keepdim=True, correction=0)
    noise_pred_rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * noise_pred_rescaled + (1 - guidance_rescale) * noise_cfg


def float_step(step, device=None) -> torch.Tensor:
    """A Python or tensor step as a float32 tensor."""
    return torch.as_tensor(step, dtype=torch.float32, device=device)


def step_fraction(step, num_steps: int, device=None) -> torch.Tensor:
    """``step / max(num_steps, 1)`` in float32, as JAX computes it."""
    step = float_step(step, device)
    return step / torch.tensor(float(max(num_steps, 1)), dtype=torch.float32, device=step.device)


def in_window(frac: torch.Tensor, start: float, stop: float) -> torch.Tensor:
    """``start <= frac < stop`` with the bounds in float32."""
    return (frac >= torch.tensor(start, dtype=torch.float32)) & (frac < torch.tensor(stop, dtype=torch.float32))


class BaseGuidance(ConfigMixin):
    """Common surface: `num_conditions`, step-range gating, `__call__`."""

    config_name = "guider_config.json"
    _input_predictions = ["pred_cond", "pred_uncond"]

    @property
    def num_conditions(self) -> int:
        return 2

    def _enabled(self, step, num_steps: int, device=None) -> torch.Tensor:
        """The start / stop gate: a bool tensor."""
        frac = step_fraction(step, num_steps, device)
        return in_window(frac, getattr(self.config, "start", 0.0), getattr(self.config, "stop", 1.0))

    def __call__(self, pred_cond: torch.Tensor, pred_uncond: Optional[torch.Tensor] = None, step=0,
                 num_steps: int = 1):
        raise NotImplementedError

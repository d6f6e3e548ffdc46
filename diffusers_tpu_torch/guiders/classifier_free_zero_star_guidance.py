"""CFG-Zero* guidance (https://huggingface.co/papers/2503.18886; port of
`diffusers_tpu/guiders/classifier_free_zero_star_guidance.py`)."""

from __future__ import annotations

from typing import Optional

import torch

from ..configuration_utils import register_to_config
from .guider_utils import BaseGuidance, float_step, rescale_noise_cfg


def cfg_zero_star_scale(cond: torch.Tensor, uncond: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    cond_f = cond.float().reshape(cond.shape[0], -1)
    uncond_f = uncond.float().reshape(uncond.shape[0], -1)
    dot = (cond_f * uncond_f).sum(dim=1, keepdim=True)
    sq = (uncond_f**2).sum(dim=1, keepdim=True) + eps
    scale = dot / sq
    return scale.reshape(cond.shape[0], *(1,) * (cond.ndim - 1)).to(cond.dtype)


class ClassifierFreeZeroStarGuidance(BaseGuidance):
    @register_to_config
    def __init__(
        self,
        guidance_scale: float = 7.5,
        zero_init_steps: int = 1,
        guidance_rescale: float = 0.0,
        use_original_formulation: bool = False,
        start: float = 0.0,
        stop: float = 1.0,
    ):
        pass

    def __call__(self, pred_cond: torch.Tensor, pred_uncond: Optional[torch.Tensor] = None, step=0,
                 num_steps: int = 1):
        alpha = cfg_zero_star_scale(pred_cond, pred_uncond)
        scaled_uncond = pred_uncond * alpha
        shift = pred_cond - scaled_uncond
        base = pred_cond if self.config.use_original_formulation else scaled_uncond
        pred = base + self.config.guidance_scale * shift
        if self.config.guidance_rescale > 0.0:
            pred = rescale_noise_cfg(pred, pred_cond, self.config.guidance_rescale)
        step_t = float_step(step, pred.device)
        pred = torch.where(step_t < self.config.zero_init_steps, torch.zeros_like(pred), pred)
        return torch.where(self._enabled(step, num_steps, pred.device), pred, pred_cond)

"""Classifier-free guidance (port of `diffusers_tpu/guiders/classifier_free_guidance.py`)."""

from __future__ import annotations

from typing import Optional

import torch

from ..configuration_utils import register_to_config
from .guider_utils import BaseGuidance, rescale_noise_cfg


class ClassifierFreeGuidance(BaseGuidance):
    @register_to_config
    def __init__(
        self,
        guidance_scale: float = 7.5,
        guidance_rescale: float = 0.0,
        use_original_formulation: bool = False,
        start: float = 0.0,
        stop: float = 1.0,
    ):
        pass

    def __call__(self, pred_cond: torch.Tensor, pred_uncond: Optional[torch.Tensor] = None, step=0,
                 num_steps: int = 1):
        shift = pred_cond - pred_uncond
        base = pred_cond if self.config.use_original_formulation else pred_uncond
        pred = base + self.config.guidance_scale * shift
        if self.config.guidance_rescale > 0.0:
            pred = rescale_noise_cfg(pred, pred_cond, self.config.guidance_rescale)
        return torch.where(self._enabled(step, num_steps, pred.device), pred, pred_cond)

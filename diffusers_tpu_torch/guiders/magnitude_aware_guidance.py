"""Magnitude-aware momentum-boosted guidance (MAMBO-G,
https://huggingface.co/papers/2508.03320; port of
`diffusers_tpu/guiders/magnitude_aware_guidance.py`): the CFG scale decays
exponentially with the size of the cond - uncond shift relative to the
unconditional prediction."""

from __future__ import annotations

from typing import Optional

import torch

from ..configuration_utils import register_to_config
from .guider_utils import BaseGuidance, rescale_noise_cfg


def mambo_guidance(
    pred_cond: torch.Tensor,
    pred_uncond: torch.Tensor,
    guidance_scale: float,
    alpha: float = 8.0,
    use_original_formulation: bool = False,
) -> torch.Tensor:
    dims = tuple(range(1, pred_cond.ndim))
    diff = pred_cond - pred_uncond
    num = diff.float().square().sum(dim=dims, keepdim=True).sqrt()
    den = pred_uncond.float().square().sum(dim=dims, keepdim=True).sqrt()
    ratio = num / den.clamp_min(1e-12)
    if use_original_formulation:
        scale = guidance_scale * torch.exp(-alpha * ratio)
    else:
        scale = 1.0 + (guidance_scale - 1.0) * torch.exp(-alpha * ratio)
    base = pred_cond if use_original_formulation else pred_uncond
    return base + scale.to(pred_cond.dtype) * diff


class MagnitudeAwareGuidance(BaseGuidance):
    @register_to_config
    def __init__(
        self,
        guidance_scale: float = 10.0,
        alpha: float = 8.0,
        guidance_rescale: float = 0.0,
        use_original_formulation: bool = False,
        start: float = 0.0,
        stop: float = 1.0,
    ):
        pass

    def __call__(self, pred_cond: torch.Tensor, pred_uncond: Optional[torch.Tensor] = None, step=0,
                 num_steps: int = 1):
        cfg = self.config
        pred = mambo_guidance(pred_cond, pred_uncond, cfg.guidance_scale, cfg.alpha, cfg.use_original_formulation)
        if cfg.guidance_rescale > 0.0:
            pred = rescale_noise_cfg(pred, pred_cond, cfg.guidance_rescale)
        return torch.where(self._enabled(step, num_steps, pred.device), pred, pred_cond)

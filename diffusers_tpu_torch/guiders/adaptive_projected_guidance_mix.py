"""APG-Mix: CFG for the early steps, adaptive projected guidance from
`adaptive_projected_guidance_start_step` on (port of
`diffusers_tpu/guiders/adaptive_projected_guidance_mix.py`). Both branches
are computed and the step picks one, so a tensor step works; the momentum
buffer warms up during the CFG phase and is an explicit carry."""

from __future__ import annotations

from typing import Optional

import torch

from ..configuration_utils import register_to_config
from .adaptive_projected_guidance import normalized_guidance
from .guider_utils import BaseGuidance, float_step, rescale_noise_cfg


class AdaptiveProjectedMixGuidance(BaseGuidance):
    @register_to_config
    def __init__(
        self,
        guidance_scale: float = 7.5,
        adaptive_projected_guidance_scale: float = 7.5,
        adaptive_projected_guidance_momentum: float = -0.5,
        adaptive_projected_guidance_rescale: float = 10.0,
        eta: float = 0.0,
        adaptive_projected_guidance_start_step: int = 0,
        guidance_rescale: float = 0.0,
        use_original_formulation: bool = False,
        start: float = 0.0,
        stop: float = 1.0,
    ):
        pass

    def init_momentum(self, shape, dtype=torch.float32, device=None) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=device)

    def __call__(
        self,
        pred_cond: torch.Tensor,
        pred_uncond: Optional[torch.Tensor] = None,
        step=0,
        num_steps: int = 1,
        momentum: Optional[torch.Tensor] = None,
    ):
        cfg = self.config
        beta = cfg.adaptive_projected_guidance_momentum
        diff = pred_cond - pred_uncond
        base = pred_cond if cfg.use_original_formulation else pred_uncond
        cfg_pred = base + cfg.guidance_scale * diff
        apg_pred, _ = normalized_guidance(
            pred_cond,
            pred_uncond,
            cfg.adaptive_projected_guidance_scale,
            momentum=momentum,
            momentum_beta=beta,
            eta=cfg.eta,
            norm_threshold=cfg.adaptive_projected_guidance_rescale,
            use_original_formulation=cfg.use_original_formulation,
        )
        in_apg_phase = float_step(step, pred_cond.device) >= cfg.adaptive_projected_guidance_start_step
        pred = torch.where(in_apg_phase, apg_pred, cfg_pred)
        if cfg.guidance_rescale > 0.0:
            pred = rescale_noise_cfg(pred, pred_cond, cfg.guidance_rescale)
        pred = torch.where(self._enabled(step, num_steps, pred.device), pred, pred_cond)
        if momentum is not None:
            return pred, beta * momentum + diff  # both phases update the buffer alike
        return pred

"""Tangential CFG (TCFG, https://huggingface.co/papers/2503.18137; port of
`diffusers_tpu/guiders/tangential_classifier_free_guidance.py`): the
unconditional prediction is projected onto the first right singular vector
of the two-row matrix [cond, uncond] before the CFG update. The projection
uses the singular vectors twice, so their sign does not matter."""

from __future__ import annotations

from typing import Optional

import torch

from ..configuration_utils import register_to_config
from .guider_utils import BaseGuidance, rescale_noise_cfg


def tcfg_normalized_guidance(
    pred_cond: torch.Tensor,
    pred_uncond: torch.Tensor,
    guidance_scale: float,
    use_original_formulation: bool = False,
) -> torch.Tensor:
    dtype, b = pred_cond.dtype, pred_cond.shape[0]
    preds = torch.stack([pred_cond, pred_uncond], dim=1).float().reshape(b, 2, -1)
    _, _, vh = torch.linalg.svd(preds, full_matrices=False)  # [B, 2, N]
    vh_modified = vh.clone()
    vh_modified[:, 1] = 0.0
    uncond_flat = pred_uncond.reshape(b, 1, -1).float()
    x_vh = torch.matmul(uncond_flat, vh.transpose(-2, -1))  # [B, 1, 2]
    pred_uncond_proj = torch.matmul(x_vh, vh_modified).reshape(pred_uncond.shape).to(dtype)
    base = pred_cond if use_original_formulation else pred_uncond_proj
    return base + guidance_scale * (pred_cond - pred_uncond_proj)


class TangentialClassifierFreeGuidance(BaseGuidance):
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
        cfg = self.config
        pred = tcfg_normalized_guidance(pred_cond, pred_uncond, cfg.guidance_scale, cfg.use_original_formulation)
        if cfg.guidance_rescale > 0.0:
            pred = rescale_noise_cfg(pred, pred_cond, cfg.guidance_rescale)
        return torch.where(self._enabled(step, num_steps, pred.device), pred, pred_cond)

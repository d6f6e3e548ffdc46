"""AutoGuidance: guide with a degraded copy of the model as the
"unconditional" branch (https://huggingface.co/papers/2406.02507; port of
`diffusers_tpu/guiders/auto_guidance.py`). The formula is CFG's; the caller
makes `pred_uncond` with a conditional forward under
`skip_layer_guidance.layers_skipped(select_skip_blocks(model,
auto_guidance_layers))`."""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ..configuration_utils import register_to_config
from .guider_utils import BaseGuidance, rescale_noise_cfg


class AutoGuidance(BaseGuidance):
    _input_predictions = ["pred_cond", "pred_uncond"]

    @register_to_config
    def __init__(
        self,
        guidance_scale: float = 7.5,
        auto_guidance_layers: Optional[Union[int, List[int]]] = None,
        dropout: Optional[float] = None,
        guidance_rescale: float = 0.0,
        use_original_formulation: bool = False,
        start: float = 0.0,
        stop: float = 1.0,
    ):
        if auto_guidance_layers is None:
            raise ValueError("`auto_guidance_layers` must be provided to enable AutoGuidance.")

    def __call__(self, pred_cond: torch.Tensor, pred_uncond: Optional[torch.Tensor] = None, step=0,
                 num_steps: int = 1):
        """`pred_uncond` is the degraded model's prediction (layers skipped)."""
        cfg = self.config
        shift = pred_cond - pred_uncond
        base = pred_cond if cfg.use_original_formulation else pred_uncond
        pred = base + cfg.guidance_scale * shift
        if cfg.guidance_rescale > 0.0:
            pred = rescale_noise_cfg(pred, pred_cond, cfg.guidance_rescale)
        return torch.where(self._enabled(step, num_steps, pred.device), pred, pred_cond)

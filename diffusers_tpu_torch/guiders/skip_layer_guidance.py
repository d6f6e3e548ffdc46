"""Skip Layer Guidance (SLG, the SD3.5 recipe).

Port of `diffusers_tpu/guiders/skip_layer_guidance.py`:

    pred = pred_uncond + g (pred_cond - pred_uncond) + g_slg (pred_cond - pred_cond_skip)

where `pred_cond_skip` is the conditional forward with whole transformer
blocks skipped (`layer_skip` on the SD3 `JointTransformerBlock` and on
`BasicTransformerBlock`): the formula is PAG's, the perturbation differs.
`layers_skipped` sets the flag on entry and clears it on exit, an exception
included.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ..configuration_utils import register_to_config
from .guider_utils import BaseGuidance, in_window, rescale_noise_cfg, step_fraction
from .perturbed_attention_guidance import iter_self_attention_names


class SkipLayerGuidance(BaseGuidance):
    _input_predictions = ["pred_cond", "pred_uncond", "pred_cond_skip"]

    @register_to_config
    def __init__(
        self,
        guidance_scale: float = 7.5,
        skip_layer_guidance_scale: float = 2.8,
        skip_layer_guidance_start: float = 0.01,
        skip_layer_guidance_stop: float = 0.2,
        skip_layer_indices: Optional[Union[int, List[int]]] = None,
        guidance_rescale: float = 0.0,
        use_original_formulation: bool = False,
        start: float = 0.0,
        stop: float = 1.0,
    ):
        pass

    @property
    def num_conditions(self) -> int:
        return 3

    def __call__(
        self,
        pred_cond: torch.Tensor,
        pred_uncond: Optional[torch.Tensor] = None,
        pred_cond_skip: Optional[torch.Tensor] = None,
        step=0,
        num_steps: int = 1,
    ):
        cfg = self.config
        frac = step_fraction(step, num_steps, pred_cond.device)
        if pred_uncond is not None:
            base = pred_cond if cfg.use_original_formulation else pred_uncond
            pred = base + cfg.guidance_scale * (pred_cond - pred_uncond)
        else:
            pred = pred_cond
        if pred_cond_skip is not None:
            slg_on = in_window(frac, cfg.skip_layer_guidance_start, cfg.skip_layer_guidance_stop)
            pred = pred + torch.where(slg_on, cfg.skip_layer_guidance_scale, 0.0) * (pred_cond - pred_cond_skip)
        if cfg.guidance_rescale > 0.0:
            pred = rescale_noise_cfg(pred, pred_cond, cfg.guidance_rescale)
        return torch.where(self._enabled(step, num_steps, pred.device), pred, pred_cond)


class layers_skipped:
    """Context manager: `layer_skip` on the given blocks around the skip
    forward, cleared on exit (an exception included)."""

    def __init__(self, blocks):
        self.blocks = list(blocks)

    def __enter__(self):
        for m in self.blocks:
            m.layer_skip = True

    def __exit__(self, *exc):
        for m in self.blocks:
            m.layer_skip = False
        return False


def select_skip_blocks(model, indices: Union[int, List[int]]):
    """Blocks by index: a DiT's `transformer_blocks`, or every
    `BasicTransformerBlock` of a UNet in the order of
    `iter_self_attention_names`."""
    if isinstance(indices, int):
        indices = [indices]
    if hasattr(model, "transformer_blocks"):
        blocks = list(model.transformer_blocks)
    else:
        blocks, seen = [], set()
        for name, _ in iter_self_attention_names(model):
            prefix = name.rsplit(".attn1", 1)[0]
            if prefix not in seen:
                seen.add(prefix)
                blocks.append(model.get_submodule(prefix))
    return [blocks[i] for i in indices]

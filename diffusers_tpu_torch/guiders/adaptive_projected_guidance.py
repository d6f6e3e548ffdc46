"""APG, adaptive projected guidance (https://huggingface.co/papers/2410.02416;
port of `diffusers_tpu/guiders/adaptive_projected_guidance.py`). The momentum
buffer is an explicit carry: pass it in, get the new one back."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..configuration_utils import register_to_config
from .guider_utils import BaseGuidance


def _norm(x: torch.Tensor, dims) -> torch.Tensor:
    return x.square().sum(dim=dims, keepdim=True).sqrt()


def normalized_guidance(
    pred_cond: torch.Tensor,
    pred_uncond: torch.Tensor,
    guidance_scale: float,
    momentum: Optional[torch.Tensor] = None,
    momentum_beta: float = 0.0,
    eta: float = 1.0,
    norm_threshold: float = 0.0,
    use_original_formulation: bool = False,
    norm_axes: Optional[Tuple[int, ...]] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(guided prediction, new momentum or None). `norm_axes` defaults to
    every axis but the batch."""
    dims = tuple(range(1, pred_cond.ndim)) if norm_axes is None else tuple(norm_axes)
    diff = pred_cond - pred_uncond
    new_momentum = None
    if momentum is not None:
        new_momentum = momentum_beta * momentum + diff
        diff = new_momentum
    if norm_threshold > 0:
        diff_norm = _norm(diff, dims)
        diff = diff * torch.minimum(torch.ones_like(diff_norm), norm_threshold / diff_norm)
    v0 = diff.float()
    v1 = pred_cond.float()
    v1 = v1 / _norm(v1, dims).clamp_min(1e-12)
    v0_parallel = (v0 * v1).sum(dim=dims, keepdim=True) * v1
    v0_orthogonal = v0 - v0_parallel
    normalized_update = (v0_orthogonal + eta * v0_parallel).to(diff.dtype)
    base = pred_cond if use_original_formulation else pred_uncond
    return base + guidance_scale * normalized_update, new_momentum


class AdaptiveProjectedGuidance(BaseGuidance):
    @register_to_config
    def __init__(
        self,
        guidance_scale: float = 7.5,
        adaptive_projected_guidance_momentum: Optional[float] = None,
        adaptive_projected_guidance_rescale: float = 15.0,
        eta: float = 1.0,
        guidance_rescale: float = 0.0,
        use_original_formulation: bool = False,
        start: float = 0.0,
        stop: float = 1.0,
    ):
        pass

    def init_momentum(self, shape, dtype=torch.float32, device=None) -> Optional[torch.Tensor]:
        if self.config.adaptive_projected_guidance_momentum is None:
            return None
        return torch.zeros(shape, dtype=dtype, device=device)

    def __call__(
        self,
        pred_cond: torch.Tensor,
        pred_uncond: Optional[torch.Tensor] = None,
        step=0,
        num_steps: int = 1,
        momentum: Optional[torch.Tensor] = None,
    ):
        """The guided prediction, and the new momentum when `momentum` is given."""
        pred, new_momentum = normalized_guidance(
            pred_cond,
            pred_uncond,
            self.config.guidance_scale,
            momentum=momentum,
            momentum_beta=self.config.adaptive_projected_guidance_momentum or 0.0,
            eta=self.config.eta,
            norm_threshold=self.config.adaptive_projected_guidance_rescale,
            use_original_formulation=self.config.use_original_formulation,
        )
        pred = torch.where(self._enabled(step, num_steps, pred.device), pred, pred_cond)
        if momentum is not None:
            return pred, new_momentum
        return pred

"""Frequency-Decoupled Guidance (FDG, https://huggingface.co/papers/2506.19713;
port of `diffusers_tpu/guiders/frequency_decoupled_guidance.py`): split the
predictions into a Laplacian pyramid and apply CFG per frequency band, each
band with its own scale. The pyramid's down and up steps use the 5-tap
binomial kernel with reflect padding (kornia's `pyrdown` / `pyrup`), as
JAX builds them. Inputs are NCHW.
"""

from __future__ import annotations

import math
from typing import List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..configuration_utils import register_to_config
from .guider_utils import BaseGuidance, in_window, rescale_noise_cfg, step_fraction
from .smoothed_energy_guidance import reflect_pad_2d

# the 5-tap binomial (gaussian) kernel, Burt and Adelson's pyramid filter
_KERNEL_1D = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
_KERNEL_2D = np.outer(_KERNEL_1D, _KERNEL_1D).astype(np.float32)  # [5, 5]


def _blur(x: torch.Tensor) -> torch.Tensor:
    """Depthwise 5 x 5 blur in float32, reflect padding."""
    c = x.shape[1]
    kernel = torch.from_numpy(_KERNEL_2D).to(x.device).expand(c, 1, 5, 5)
    return F.conv2d(reflect_pad_2d(x.float(), 2), kernel, groups=c).to(x.dtype)


def pyr_down(x: torch.Tensor) -> torch.Tensor:
    return _blur(x)[:, :, ::2, ::2]


def pyr_up(x: torch.Tensor) -> torch.Tensor:
    """Zero-stuffed upsample, then the blur scaled by 4 (kornia's pyrup)."""
    b, c, h, w = x.shape
    up = torch.zeros((b, c, h * 2, w * 2), dtype=x.dtype, device=x.device)
    up[:, :, ::2, ::2] = x
    return _blur(up) * 4.0


def build_laplacian_pyramid(x: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """pyramid[i] = g_i - pyr_up(g_{i+1}); the last level is the coarse residual."""
    pyramid, current = [], x
    for _ in range(levels - 1):
        down = pyr_down(current)
        pyramid.append(current - pyr_up(down))
        current = down
    pyramid.append(current)
    return pyramid


def build_image_from_pyramid(pyramid: List[torch.Tensor]) -> torch.Tensor:
    img = pyramid[-1]
    for i in range(len(pyramid) - 2, -1, -1):
        img = pyr_up(img) + pyramid[i]
    return img


def _project(v0: torch.Tensor, v1: torch.Tensor):
    """(the part of v0 along v1, the rest), each sample on its own."""
    dims = tuple(range(1, v0.ndim))
    v0f, v1f = v0.float(), v1.float()
    v1n = v1f / v1f.square().sum(dim=dims, keepdim=True).sqrt().clamp_min(1e-12)
    parallel = (v0f * v1n).sum(dim=dims, keepdim=True) * v1n
    return parallel.to(v0.dtype), (v0f - parallel).to(v0.dtype)


class FrequencyDecoupledGuidance(BaseGuidance):
    @register_to_config
    def __init__(
        self,
        guidance_scales: tuple = (10.0, 5.0),  # high -> low frequency
        guidance_rescale: Union[float, tuple] = 0.0,
        parallel_weights: Optional[tuple] = None,
        use_original_formulation: bool = False,
        guidance_rescale_space: str = "freq",
        start: Union[float, tuple] = 0.0,
        stop: Union[float, tuple] = 1.0,
    ):
        pass

    @property
    def levels(self) -> int:
        return len(self.config.guidance_scales)

    @staticmethod
    def _per_level(value, level):
        return value[level] if isinstance(value, (list, tuple)) else value

    def __call__(self, pred_cond: torch.Tensor, pred_uncond: Optional[torch.Tensor] = None, step=0,
                 num_steps: int = 1):
        cfg = self.config
        frac = step_fraction(step, num_steps, pred_cond.device)
        cond_pyr = build_laplacian_pyramid(pred_cond, self.levels)
        uncond_pyr = build_laplacian_pyramid(pred_uncond, self.levels)

        guided = []
        for level in range(self.levels):
            g = cfg.guidance_scales[level]
            pw = self._per_level(cfg.parallel_weights, level) if cfg.parallel_weights is not None else 1.0
            rs = self._per_level(cfg.guidance_rescale, level)
            c, u = cond_pyr[level], uncond_pyr[level]
            shift = c - u
            if not math.isclose(pw, 1.0):
                par, orth = _project(shift, c)
                shift = pw * par + orth
            base = c if cfg.use_original_formulation else u
            pred = base + g * shift
            if cfg.guidance_rescale_space == "freq" and rs > 0.0:
                pred = rescale_noise_cfg(pred, c, rs)
            level_on = in_window(frac, self._per_level(cfg.start, level), self._per_level(cfg.stop, level))
            guided.append(torch.where(level_on, pred, c))

        pred = build_image_from_pyramid(guided)
        rs0 = self._per_level(cfg.guidance_rescale, 0)
        if cfg.guidance_rescale_space == "data" and rs0 > 0.0:
            pred = rescale_noise_cfg(pred, pred_cond, rs0)
        return pred

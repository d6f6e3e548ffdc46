"""Smoothed Energy Guidance (SEG, https://huggingface.co/papers/2408.00760;
port of `diffusers_tpu/guiders/smoothed_energy_guidance.py`): the perturbed
forward blurs the self-attention queries with a 2-D gaussian over the
square grid of image tokens, and the guider contrasts the clean and the
blurred conditional predictions as PAG does.

The blur is the `seg_blur_sigma` attribute of `models.attention.Attention`,
set by the `seg_blurred` context manager around the perturbed forward. The
padding is JAX's ``jnp.pad(mode="reflect")``, which reflects again and again
where the pad is wider than the grid (SD 1.5's 8 x 8 level at 512 px takes
a pad of 9 at sigma 3); upstream's ``F.pad(mode="reflect")`` raises there.
It is built here by index arithmetic (`reflect_indices`). The blur is a
depthwise convolution in float32, a PyTorch op on the card as it is an XLA
op in JAX.
"""

from __future__ import annotations

import math
from typing import List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..configuration_utils import register_to_config
from .guider_utils import BaseGuidance, in_window, rescale_noise_cfg, step_fraction


def reflect_indices(n: int, pad: int) -> np.ndarray:
    """The source index of each of the ``n + 2 pad`` entries of an axis of
    `n` padded by `pad` on both sides in numpy's "reflect" mode, for any pad
    (the reflection repeats with period ``2 (n - 1)``)."""
    idx = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    m = np.mod(idx, period)
    return np.where(m >= n, period - m, m)


def reflect_pad_2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """[..., H, W] padded by `pad` on every side, numpy's "reflect" mode."""
    h, w = x.shape[-2], x.shape[-1]
    rows = torch.from_numpy(reflect_indices(h, pad)).to(x.device)
    cols = torch.from_numpy(reflect_indices(w, pad)).to(x.device)
    return x.index_select(-2, rows).index_select(-1, cols)


def seg_kernel_size(sigma: float) -> int:
    """The odd kernel size of JAX's `Attention` (upstream's rule): ceil(6 sigma), made odd."""
    k = math.ceil(6 * sigma)
    return k + 1 - k % 2


def seg_gaussian_blur_2d(query: torch.Tensor, kernel_size: int, sigma: float) -> torch.Tensor:
    """Blur [B, S, D] queries as a sqrt(S) x sqrt(S) grid. Infinite sigma
    (>= 9999.9) gives every token the image's mean query; a grid that is
    not square is left as it is."""
    b, s, d = query.shape
    if sigma >= 9999.9:
        return query.mean(dim=1, keepdim=True).expand(query.shape)
    side = math.isqrt(s)
    if side * side != s:
        return query
    half = (kernel_size - 1) / 2
    x = np.linspace(-half, half, kernel_size)
    pdf = np.exp(-0.5 * (x / sigma) ** 2)
    k1 = (pdf / pdf.sum()).astype(np.float32)
    kernel = torch.from_numpy(np.outer(k1, k1)).to(query.device)
    grid = query.float().reshape(b, side, side, d).permute(0, 3, 1, 2)  # NCHW, a channel a feature
    grid = reflect_pad_2d(grid, kernel_size // 2)
    out = F.conv2d(grid, kernel.expand(d, 1, kernel_size, kernel_size), groups=d)
    # back to [B, S, D] rows in memory: the attention kernel takes a unit stride along each head's features
    return out.permute(0, 2, 3, 1).contiguous().view(b, s, d).to(query.dtype)


class seg_blurred:
    """Context manager: `seg_blur_sigma` on the given `Attention` modules
    around the perturbed forward, cleared on exit (an exception included)."""

    def __init__(self, attentions, sigma: float):
        self.attentions = list(attentions)
        self.sigma = sigma

    def __enter__(self):
        for m in self.attentions:
            m.seg_blur_sigma = self.sigma

    def __exit__(self, *exc):
        for m in self.attentions:
            m.seg_blur_sigma = None
        return False


class SmoothedEnergyGuidance(BaseGuidance):
    _input_predictions = ["pred_cond", "pred_uncond", "pred_cond_seg"]

    @register_to_config
    def __init__(
        self,
        guidance_scale: float = 7.5,
        seg_guidance_scale: float = 3.0,
        seg_blur_sigma: float = 9999999.0,
        seg_blur_threshold_inf: float = 9999.9,
        seg_guidance_start: float = 0.0,
        seg_guidance_stop: float = 1.0,
        seg_guidance_layers: Optional[Union[int, List[int]]] = None,
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
        pred_cond_seg: Optional[torch.Tensor] = None,
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
        if pred_cond_seg is not None:
            seg_on = in_window(frac, cfg.seg_guidance_start, cfg.seg_guidance_stop)
            pred = pred + torch.where(seg_on, cfg.seg_guidance_scale, 0.0) * (pred_cond - pred_cond_seg)
        if cfg.guidance_rescale > 0.0:
            pred = rescale_noise_cfg(pred, pred_cond, cfg.guidance_rescale)
        return torch.where(self._enabled(step, num_steps, pred.device), pred, pred_cond)

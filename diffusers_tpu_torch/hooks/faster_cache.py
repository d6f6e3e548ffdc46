"""FasterCache CFG-cache: skip the unconditional branch on most steps and
rebuild it from the conditional output plus a cached frequency-domain delta
(arXiv:2410.19355, Eq. 9-11).

Port of `diffusers_tpu/hooks/faster_cache.py`: the batch-2 CFG form that
SDXL and SD3 use (`faster_cache_apply`), and the pair form of pipelines whose
CFG is two separate forwards, Wan's (`faster_cache_apply_pair` `:86`, and its
loop `denoise_loop_faster_cache`, JAX's `denoise_scan_faster_cache` `:117`).
The skip schedule and the low/high-frequency weights depend only on the
timesteps, so they are made on the host (`faster_cache_schedules`); a
skipped step runs the denoiser at batch 1 (cond only) and calls nothing of
the unconditional branch. The deltas are complex64. The FFT runs on a
float32 copy: cuFFT takes no bf16, and JAX casts to float32 first too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class FasterCacheConfig:
    unconditional_batch_skip_range: int = 5
    unconditional_batch_timestep_skip_range: Tuple[int, int] = (-1, 641)
    low_frequency_weight_update_timestep_range: Tuple[int, int] = (99, 901)
    high_frequency_weight_update_timestep_range: Tuple[int, int] = (-1, 301)
    alpha_low_frequency: float = 1.1
    alpha_high_frequency: float = 1.1


def faster_cache_schedules(timesteps: np.ndarray, config: FasterCacheConfig):
    """Per-step schedules on the host: (skip_uncond bool[n], lf_weight
    f32[n], hf_weight f32[n])."""
    t = np.asarray(timesteps, dtype=np.float64)
    it = np.arange(len(t))
    lo, hi = config.unconditional_batch_timestep_skip_range
    within = (lo < t) & (t < hi)
    skip = (it > 0) & within & (it % config.unconditional_batch_skip_range != 0)
    llo, lhi = config.low_frequency_weight_update_timestep_range
    lf_w = np.where((llo < t) & (t < lhi), config.alpha_low_frequency, 1.0).astype(np.float32)
    hlo, hhi = config.high_frequency_weight_update_timestep_range
    hf_w = np.where((hlo < t) & (t < hhi), config.alpha_high_frequency, 1.0).astype(np.float32)
    return skip, lf_w, hf_w


@dataclass
class FasterCacheState:
    """Frequency-domain (uncond - cond) deltas from the last full step."""

    low_freq_delta: torch.Tensor  # complex64, [B, C, H, W] (fftshifted fft2)
    high_freq_delta: torch.Tensor


def init_faster_cache_state(cond_shape: Tuple[int, ...], device=None) -> FasterCacheState:
    zeros = torch.zeros(cond_shape, dtype=torch.complex64, device=device)
    return FasterCacheState(low_freq_delta=zeros, high_freq_delta=zeros)


def _split_low_high_freq(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fft2 over the trailing 2 dims of a float32 copy of `x`, split by a
    radius-(min(H, W) // 5) disk around the centre of the shifted spectrum."""
    fft_shifted = torch.fft.fftshift(torch.fft.fft2(x.float()), dim=(-2, -1))
    h, w = x.shape[-2], x.shape[-1]
    radius = min(h, w) // 5
    yy = np.arange(h)[:, None]
    xx = np.arange(w)[None, :]
    mask = torch.from_numpy((xx - w // 2) ** 2 + (yy - h // 2) ** 2 <= radius**2).to(x.device)
    return fft_shifted * mask, fft_shifted * ~mask


def faster_cache_apply(
    state: FasterCacheState,
    skip_uncond: bool,
    lf_weight: float,
    hf_weight: float,
    full_forward: Callable[[], torch.Tensor],  # () -> [2B, C, H, W] (uncond, cond)
    cond_forward: Callable[[], torch.Tensor],  # () -> [B, C, H, W] (cond only)
) -> Tuple[torch.Tensor, FasterCacheState]:
    """One step's denoiser evaluation under the CFG-cache. Returns the [2B,
    ...] noise prediction (uncond first, the CFG batch layout) and the new
    state."""
    if not skip_uncond:
        noise = full_forward()
        uncond, cond = noise.chunk(2, dim=0)
        lf_u, hf_u = _split_low_high_freq(uncond)
        lf_c, hf_c = _split_low_high_freq(cond)
        return noise, FasterCacheState(low_freq_delta=lf_u - lf_c, high_freq_delta=hf_u - hf_c)

    cond = cond_forward()
    lf_c, hf_c = _split_low_high_freq(cond)
    lf_delta = state.low_freq_delta * lf_weight
    hf_delta = state.high_freq_delta * hf_weight
    uncond_freq = (lf_delta + lf_c) + (hf_delta + hf_c)
    uncond = torch.fft.ifft2(torch.fft.ifftshift(uncond_freq, dim=(-2, -1))).real
    noise = torch.cat([uncond.to(cond.dtype), cond], dim=0)
    return noise, FasterCacheState(low_freq_delta=lf_delta, high_freq_delta=hf_delta)


def faster_cache_apply_pair(
    state: FasterCacheState,
    skip_uncond: bool,
    lf_weight: float,
    hf_weight: float,
    pair_forward: Callable[[], Tuple[torch.Tensor, torch.Tensor]],  # () -> (uncond, cond)
    cond_forward: Callable[[], torch.Tensor],  # () -> cond
) -> Tuple[Tuple[torch.Tensor, torch.Tensor], FasterCacheState]:
    """The pair form: returns ((uncond, cond), new state); the FFT runs over
    the trailing two axes of a prediction."""
    if not skip_uncond:
        uncond, cond = pair_forward()
        lf_u, hf_u = _split_low_high_freq(uncond)
        lf_c, hf_c = _split_low_high_freq(cond)
        return (uncond, cond), FasterCacheState(low_freq_delta=lf_u - lf_c, high_freq_delta=hf_u - hf_c)

    cond = cond_forward()
    lf_c, hf_c = _split_low_high_freq(cond)
    lf_delta = state.low_freq_delta * lf_weight
    hf_delta = state.high_freq_delta * hf_weight
    uncond_freq = (lf_delta + lf_c) + (hf_delta + hf_c)
    uncond = torch.fft.ifft2(torch.fft.ifftshift(uncond_freq, dim=(-2, -1))).real.to(cond.dtype)
    return (uncond, cond), FasterCacheState(low_freq_delta=lf_delta, high_freq_delta=hf_delta)


def denoise_loop_faster_cache(pair_forward, cond_forward, combine, scheduler, latents, state, timesteps, config,
                              reshape_in=None, reshape_out=None):
    """The denoise loop under the pair form of the CFG-cache.

    Args:
        pair_forward: fn(latents, i, t) -> (uncond, cond) predictions.
        cond_forward: fn(latents, i, t) -> cond prediction.
        combine: fn(uncond, cond) -> the model output fed to `scheduler.step`.
        timesteps: the schedule's timesteps (host tensor); the skip schedule
            and weights come from `faster_cache_schedules(timesteps, config)`.
        reshape_in / reshape_out: maps putting a prediction into a
            [..., H, W] grid for the frequency split and back (a token-sequence
            DiT's unpack and pack, JAX `denoise_scan_faster_cache`); default
            the identity.
    Returns the final latents."""
    rin = reshape_in or (lambda x: x)
    rout = reshape_out or (lambda x: x)
    skip, lf_w, hf_w = faster_cache_schedules(timesteps.numpy(), config)
    fc = init_faster_cache_state(rin(latents).shape, latents.device)

    def pair(i, t):
        uncond, cond = pair_forward(latents, i, t)
        return rin(uncond), rin(cond)

    for i, t in enumerate(timesteps):
        (uncond, cond), fc = faster_cache_apply_pair(
            fc, bool(skip[i]), float(lf_w[i]), float(hf_w[i]),
            lambda: pair(i, t), lambda: rin(cond_forward(latents, i, t)))
        latents = scheduler.step(state, combine(rout(uncond), rout(cond)), t, latents).prev_sample
    return latents

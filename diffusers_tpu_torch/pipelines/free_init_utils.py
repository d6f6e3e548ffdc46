"""FreeInit (arXiv:2312.07537): iterative noise reinitialization for video
pipelines. Between sampling passes, the result is re-noised to the last
training timestep with the first pass's noise, and its low spatio-temporal
frequencies are kept while fresh noise replaces the high ones.

Port of `diffusers_tpu/pipelines/free_init_utils.py` (`FreeInitConfig`,
`get_free_init_freq_filter`, `apply_freq_filter`, `FreeInitMixin` `:25-128`).
The filter and the FFTs run in float32 / complex64, as in JAX. The fresh
noise is drawn through `utils.torch_utils.randn_tensor`, like every random
draw of the pipelines. Disabled, a pipeline makes a single pass.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..utils import torch_utils


@dataclass(frozen=True)
class FreeInitConfig:
    num_iters: int = 3
    use_fast_sampling: bool = False
    method: str = "butterworth"  # "butterworth" | "gaussian" | "ideal"
    order: int = 4
    spatial_stop_frequency: float = 0.25
    temporal_stop_frequency: float = 0.25


def get_free_init_freq_filter(shape: Tuple[int, ...], config: FreeInitConfig, device=None) -> torch.Tensor:
    """float32 low-pass filter over the trailing (T, H, W) axes of `shape`."""
    time, height, width = shape[-3], shape[-2], shape[-1]
    s, ts = config.spatial_stop_frequency, config.temporal_stop_frequency
    if s == 0 or ts == 0:
        return torch.zeros((time, height, width), dtype=torch.float32, device=device)
    t = (2 * torch.arange(time, device=device) / time - 1)[:, None, None]
    h = (2 * torch.arange(height, device=device) / height - 1)[None, :, None]
    w = (2 * torch.arange(width, device=device) / width - 1)[None, None, :]
    d_square = ((s / ts) * t) ** 2 + h**2 + w**2
    if config.method == "butterworth":
        mask = 1.0 / (1.0 + (d_square / s**2) ** config.order)
    elif config.method == "gaussian":
        mask = torch.exp(-1.0 / (2 * s**2) * d_square)
    elif config.method == "ideal":
        mask = (d_square <= s * 2).float()
    else:
        raise NotImplementedError("`method` must be one of gaussian, butterworth or ideal")
    return mask.float()


def apply_freq_filter(x: torch.Tensor, noise: torch.Tensor, low_pass_filter: torch.Tensor) -> torch.Tensor:
    """Low frequencies from `x`, high ones from `noise`, over the last three axes."""
    dims = (-3, -2, -1)
    x_freq = torch.fft.fftshift(torch.fft.fftn(x.float(), dim=dims), dim=dims)
    noise_freq = torch.fft.fftshift(torch.fft.fftn(noise.float(), dim=dims), dim=dims)
    mixed = x_freq * low_pass_filter + noise_freq * (1.0 - low_pass_filter)
    return torch.fft.ifftn(torch.fft.ifftshift(mixed, dim=dims), dim=dims).real.to(x.dtype)


class FreeInitMixin:
    """`enable_free_init` / `disable_free_init` and the reinitialization
    between the passes of a video pipeline's denoise loop."""

    _free_init_config: Optional[FreeInitConfig] = None

    def enable_free_init(self, num_iters: int = 3, use_fast_sampling: bool = False, method: str = "butterworth",
                         order: int = 4, spatial_stop_frequency: float = 0.25, temporal_stop_frequency: float = 0.25):
        self._free_init_config = FreeInitConfig(
            num_iters=num_iters, use_fast_sampling=use_fast_sampling, method=method, order=order,
            spatial_stop_frequency=spatial_stop_frequency, temporal_stop_frequency=temporal_stop_frequency)

    def disable_free_init(self):
        self._free_init_config = None

    @property
    def free_init_enabled(self) -> bool:
        return self._free_init_config is not None

    def _free_init_iterations(self, num_inference_steps: int):
        """Yield (pass, steps of the pass): one pass when disabled."""
        cfg = self._free_init_config
        if cfg is None:
            yield 0, num_inference_steps
            return
        for it in range(cfg.num_iters):
            steps = num_inference_steps
            if cfg.use_fast_sampling:
                steps = max(1, int(num_inference_steps / cfg.num_iters * (it + 1)))
            yield it, steps

    def _free_init_reinit_latents(self, latents: torch.Tensor, initial_noise: torch.Tensor,
                                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Re-noise the last pass's result to t_max with the first pass's noise
        (`scheduler.add_noise` at a 2-step schedule, or to sigma 0.999 for a
        flow-match scheduler without it), then mix in fresh noise above the
        filter's cutoff."""
        scheduler = self.scheduler
        x, n = latents.float(), initial_noise.float()
        if hasattr(scheduler, "add_noise"):
            t_max = torch.full((latents.shape[0],), scheduler.config.num_train_timesteps - 1)
            z_t = scheduler.add_noise(scheduler.set_timesteps(2), x, n, t_max)
        else:
            z_t = (1.0 - 0.999) * x + 0.999 * n
        z_rand = torch_utils.randn_tensor(latents.shape, generator, latents.device)
        lpf = get_free_init_freq_filter(latents.shape, self._free_init_config, latents.device)
        return apply_freq_filter(z_t, z_rand, lpf).to(latents.dtype)

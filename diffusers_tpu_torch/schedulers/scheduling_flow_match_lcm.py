"""Flow-matching latent consistency sampler.

Port of `diffusers_tpu/schedulers/scheduling_flow_match_lcm.py`: the ladders
of `FlowMatchEulerDiscreteScheduler` (it subclasses it) with the LCM step
``x0 = x - sigma v`` then ``(1 - sigma_next) x0 + sigma_next noise``. The
noise is `variance_noise`, or a draw from `generator`; with neither the
step raises, as JAX's does without a PRNG key. The mid-sampling upscale
(`scale_factors`) raises, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..configuration_utils import register_to_config
from .scheduling_flow_match_euler_discrete import (
    FlowMatchEulerDiscreteScheduler,
    FlowMatchEulerDiscreteSchedulerOutput,
    FlowMatchEulerDiscreteSchedulerState,
)
from .scheduling_utils import index_for_timestep, step_noise

FlowMatchLCMSchedulerState = FlowMatchEulerDiscreteSchedulerState
FlowMatchLCMSchedulerOutput = FlowMatchEulerDiscreteSchedulerOutput


class FlowMatchLCMScheduler(FlowMatchEulerDiscreteScheduler):
    @register_to_config
    def __init__(
        self,
        num_train_timesteps: int = 1000,
        shift: float = 1.0,
        use_dynamic_shifting: bool = False,
        base_shift: float = 0.5,
        max_shift: float = 1.15,
        base_image_seq_len: int = 256,
        max_image_seq_len: int = 4096,
        invert_sigmas: bool = False,
        shift_terminal: Optional[float] = None,
        use_karras_sigmas: bool = False,
        use_exponential_sigmas: bool = False,
        use_beta_sigmas: bool = False,
        time_shift_type: str = "exponential",
        scale_factors: Optional[list] = None,
        upscale_mode: str = "bicubic",
    ):
        if scale_factors:
            raise NotImplementedError("mid-sampling upscaling (`scale_factors`) is not supported")
        sigmas = np.linspace(1, num_train_timesteps, num_train_timesteps, dtype=np.float32)[::-1] / np.float32(
            num_train_timesteps)
        if not use_dynamic_shifting:
            sigmas = np.float32(shift) * sigmas / (1 + np.float32(shift - 1) * sigmas)
        self.sigma_min = float(sigmas[-1])
        self.sigma_max = float(sigmas[0])

    def step(self, state: FlowMatchLCMSchedulerState, model_output: torch.Tensor, timestep, sample: torch.Tensor,
             generator: Optional[torch.Generator] = None, variance_noise: Optional[torch.Tensor] = None,
             return_dict: bool = True):
        idx = index_for_timestep(state.timesteps, timestep)
        sigma, sigma_next = state.sigmas[idx], state.sigmas[idx + 1]
        x0_pred = sample.float() - float(sigma) * model_output.float()
        noise = step_noise(variance_noise, generator, x0_pred, "FlowMatchLCMScheduler.step")
        prev_sample = (float(1 - sigma_next) * x0_pred + float(sigma_next) * noise).to(model_output.dtype)
        if not return_dict:
            return (prev_sample, state)
        return FlowMatchLCMSchedulerOutput(prev_sample=prev_sample, state=state)

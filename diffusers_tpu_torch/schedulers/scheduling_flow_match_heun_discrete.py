"""Flow-matching Heun (second-order) sampler.

Port of `diffusers_tpu/schedulers/scheduling_flow_match_heun_discrete.py`:
the shifted flow-match sigma ladder, interleaved (every timestep but the
first twice, so N steps call the model 2N - 1 times); an even step index
takes the Euler step and keeps its derivative, dt and sample, an odd one the
Heun correction from them. Ladders in numpy (float64) on the host exactly as
in JAX; the step index and the buffers live on the state and `step` updates
them in place. The result has the sample's dtype, as JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..configuration_utils import ConfigMixin, register_to_config
from ..utils import BaseOutput
from .scheduling_utils import SchedulerMixin, index_for_timestep


@dataclass
class FlowMatchHeunDiscreteSchedulerState:
    timesteps: torch.Tensor  # float32 [2S-1], host
    sigmas: torch.Tensor  # float32 [2S], host
    num_inference_steps: Optional[int] = None
    init_noise_sigma: float = 1.0
    step_index: int = 0
    prev_derivative: Optional[torch.Tensor] = None  # the Euler step's derivative, float32
    buffered_sample: Optional[torch.Tensor] = None  # the Euler step's sample, float32
    dt: Optional[torch.Tensor] = None  # the Euler step's sigma step, float32 host scalar


@dataclass
class FlowMatchHeunDiscreteSchedulerOutput(BaseOutput):
    prev_sample: torch.Tensor
    state: Optional[FlowMatchHeunDiscreteSchedulerState] = None


class FlowMatchHeunDiscreteScheduler(SchedulerMixin, ConfigMixin):
    order = 2

    @register_to_config
    def __init__(self, num_train_timesteps: int = 1000, shift: float = 1.0):
        sigmas = np.linspace(1, num_train_timesteps, num_train_timesteps, dtype=np.float64)[::-1] / num_train_timesteps
        sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
        self.sigma_min = float(sigmas[-1])
        self.sigma_max = float(sigmas[0])
        self.init_noise_sigma = 1.0

    def set_timesteps(self, num_inference_steps: int) -> FlowMatchHeunDiscreteSchedulerState:
        n, shift = self.config.num_train_timesteps, self.config.shift
        ts = np.linspace(self.sigma_max * n, self.sigma_min * n, num_inference_steps, dtype=np.float64)
        sigmas = ts / n
        sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
        timesteps = sigmas * n
        timesteps = np.concatenate([timesteps[:1], np.repeat(timesteps[1:], 2)])
        sigmas = np.concatenate([sigmas, [0.0]])
        sigmas = np.concatenate([sigmas[:1], np.repeat(sigmas[1:-1], 2), sigmas[-1:]])
        return FlowMatchHeunDiscreteSchedulerState(timesteps=torch.from_numpy(timesteps.astype(np.float32)),
                                                   sigmas=torch.from_numpy(sigmas.astype(np.float32)),
                                                   num_inference_steps=num_inference_steps)

    def prepare(self, state, sample):
        """JAX allocates its buffers here; the port's are set by `step`."""
        return state

    def scale_model_input(self, state, sample: torch.Tensor, timestep=None) -> torch.Tensor:
        return sample

    def scale_noise(self, state, sample: torch.Tensor, timestep, noise: torch.Tensor) -> torch.Tensor:
        """The forward process ``sigma * noise + (1 - sigma) * sample`` at one
        timestep of the schedule, found by equality."""
        sigma = state.sigmas[index_for_timestep(state.timesteps, timestep)]
        return float(sigma) * noise + float(1.0 - sigma) * sample

    def step(self, state: FlowMatchHeunDiscreteSchedulerState, model_output: torch.Tensor, timestep,
             sample: torch.Tensor, return_dict: bool = True):
        """The Euler step (even step index) or the Heun correction (odd);
        updates `state` in place."""
        idx = state.step_index
        first = idx % 2 == 0
        sigma = state.sigmas[idx] if first else state.sigmas[idx - 1]
        sigma_next = state.sigmas[idx + 1] if first else state.sigmas[idx]
        sample_f, model_output = sample.float(), model_output.float()
        if first:
            derivative = (sample_f - (sample_f - model_output * float(sigma))) / float(torch.clamp_min(sigma, 1e-12))
            dt = sigma_next - sigma
            prev_sample = sample_f + derivative * float(dt)
            state.prev_derivative, state.buffered_sample, state.dt = derivative, sample_f, dt
        else:
            derivative = ((sample_f - (sample_f - model_output * float(sigma_next)))
                          / float(torch.clamp_min(sigma_next, 1e-12)))
            derivative = 0.5 * (state.prev_derivative + derivative)
            prev_sample = state.buffered_sample + derivative * float(state.dt)
        state.step_index = idx + 1
        prev_sample = prev_sample.to(sample.dtype)
        if not return_dict:
            return (prev_sample, state)
        return FlowMatchHeunDiscreteSchedulerOutput(prev_sample=prev_sample, state=state)

    def __len__(self):
        return self.config.num_train_timesteps

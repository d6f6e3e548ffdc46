"""Heun (second-order) sampler.

Port of `diffusers_tpu/schedulers/scheduling_heun_discrete.py`. The schedule
is interleaved: every timestep but the first appears twice, so a loop of N
steps calls the model 2N - 1 times. An even step index runs the Euler
predictor and keeps its derivative, dt and sample on the state; an odd one
runs the Heun corrector from them. The ladders are built in numpy on the
host exactly as in JAX; the state that `set_timesteps` returns carries the
step index and the buffers, updated in place by `step` (the port's loops
pass that one state to every step); `scale_model_input` reads the sigma of
the state's step index, as JAX's does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..configuration_utils import ConfigMixin, register_to_config
from ..utils import BaseOutput
from .scheduling_utils import (
    KarrasDiffusionSchedulers,
    SchedulerMixin,
    add_sigma_noise,
    k_init_noise_sigma,
    k_pred_original,
    k_spaced_timesteps,
    make_beta_schedule,
)
from .sigma_utils import convert_to_karras, sigma_to_t


@dataclass
class HeunDiscreteSchedulerState:
    timesteps: torch.Tensor  # float32 [2S-1], host
    sigmas: torch.Tensor  # float32 [2S], host
    init_noise_sigma: float
    num_inference_steps: Optional[int] = None
    step_index: int = 0
    prev_derivative: Optional[torch.Tensor] = None  # the predictor's derivative, float32
    buffered_sample: Optional[torch.Tensor] = None  # the predictor's input sample, float32
    dt: Optional[torch.Tensor] = None  # the predictor's sigma step, float32 host scalar


@dataclass
class HeunDiscreteSchedulerOutput(BaseOutput):
    prev_sample: torch.Tensor
    pred_original_sample: Optional[torch.Tensor] = None
    state: Optional[HeunDiscreteSchedulerState] = None


class HeunDiscreteScheduler(SchedulerMixin, ConfigMixin):
    _compatibles = [e.name for e in KarrasDiffusionSchedulers]
    order = 2

    @register_to_config
    def __init__(
        self,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        beta_schedule: str = "linear",
        trained_betas: Optional[List[float]] = None,
        prediction_type: str = "epsilon",
        use_karras_sigmas: bool = False,
        clip_sample: bool = False,
        clip_sample_range: float = 1.0,
        timestep_spacing: str = "linspace",
        steps_offset: int = 0,
    ):
        betas = make_beta_schedule(beta_schedule, num_train_timesteps, beta_start, beta_end, trained_betas)
        self.betas = betas
        self.alphas = 1.0 - betas
        self.alphas_cumprod = np.cumprod(self.alphas, axis=0)

    def set_timesteps(self, num_inference_steps: int) -> HeunDiscreteSchedulerState:
        cfg = self.config
        timesteps = k_spaced_timesteps(cfg.timestep_spacing, num_inference_steps, cfg.num_train_timesteps,
                                       cfg.steps_offset)
        sigmas_full = np.array(((1 - self.alphas_cumprod) / self.alphas_cumprod) ** 0.5)
        sigmas = np.interp(timesteps, np.arange(0, len(sigmas_full)), sigmas_full)
        if cfg.use_karras_sigmas:
            sigmas = convert_to_karras(sigmas, num_inference_steps)
            timesteps = np.array([sigma_to_t(s, np.log(sigmas_full)) for s in sigmas])
        sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
        # every timestep but the first twice; every sigma but the first and the final 0 twice
        sigmas_i = np.concatenate([sigmas[:1], np.repeat(sigmas[1:-1], 2), sigmas[-1:]])
        timesteps_i = np.concatenate([timesteps[:1], np.repeat(timesteps[1:], 2)])
        return HeunDiscreteSchedulerState(
            timesteps=torch.from_numpy(timesteps_i.astype(np.float32)),
            sigmas=torch.from_numpy(sigmas_i.astype(np.float32)),
            init_noise_sigma=k_init_noise_sigma(sigmas, cfg.timestep_spacing),
            num_inference_steps=num_inference_steps)

    def prepare(self, state, sample):
        """JAX allocates its buffers here; the port's are set by `step`."""
        return state

    def scale_model_input(self, state, sample: torch.Tensor, timestep=None) -> torch.Tensor:
        sigma = state.sigmas[state.step_index]
        return sample / float((sigma**2 + 1) ** 0.5)

    def step(self, state: HeunDiscreteSchedulerState, model_output: torch.Tensor, timestep, sample: torch.Tensor,
             return_dict: bool = True):
        """The predictor (even step index) or the corrector (odd); updates
        `state` in place."""
        idx = state.step_index
        first = idx % 2 == 0
        sigma = state.sigmas[idx] if first else state.sigmas[idx - 1]
        sigma_next = state.sigmas[idx + 1] if first else state.sigmas[idx]
        sample_f, model_output_f = sample.float(), model_output.float()
        pred_original_sample = k_pred_original(self.config.prediction_type, model_output_f, sample_f,
                                               sigma if first else sigma_next)
        if self.config.clip_sample:
            r = self.config.clip_sample_range
            pred_original_sample = pred_original_sample.clamp(-r, r)

        if first:
            derivative = (sample_f - pred_original_sample) / float(sigma if sigma != 0 else 1.0)
            dt = sigma_next - sigma
            prev_sample = sample_f + derivative * float(dt)
            state.prev_derivative, state.buffered_sample, state.dt = derivative, sample_f, dt
        else:
            derivative = ((sample_f - pred_original_sample) / float(sigma_next if sigma_next != 0 else 1.0)
                          + state.prev_derivative) / 2
            prev_sample = state.buffered_sample + derivative * float(state.dt)
        state.step_index = idx + 1
        prev_sample = prev_sample.to(model_output.dtype)
        if not return_dict:
            return (prev_sample, state)
        return HeunDiscreteSchedulerOutput(prev_sample=prev_sample,
                                           pred_original_sample=pred_original_sample.to(model_output.dtype),
                                           state=state)

    add_noise = staticmethod(add_sigma_noise)

    def __len__(self):
        return self.config.num_train_timesteps

"""Euler ancestral sampler.

Port of `diffusers_tpu/schedulers/scheduling_euler_ancestral_discrete.py`: an
Euler step down to sigma_down, then noise scaled by sigma_up. The ladders are
built in numpy on the host exactly as in JAX; the step gathers its sigmas on
the host in float32 and does the sample arithmetic in torch in float32,
casting `prev_sample` back to the model output's dtype. The noise is
`variance_noise`, or a draw from `generator`; with neither the step raises,
as JAX's does without a PRNG key (JAX's pipelines pass none).
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
    index_for_timestep,
    k_init_noise_sigma,
    k_pred_original,
    k_spaced_timesteps,
    make_beta_schedule,
    rescale_zero_terminal_snr,
    step_noise,
)


@dataclass
class EulerAncestralDiscreteSchedulerState:
    timesteps: torch.Tensor  # float32 [S], host
    sigmas: torch.Tensor  # float32 [S+1], host
    init_noise_sigma: float
    num_inference_steps: Optional[int] = None


@dataclass
class EulerAncestralDiscreteSchedulerOutput(BaseOutput):
    prev_sample: torch.Tensor
    pred_original_sample: Optional[torch.Tensor] = None
    state: Optional[EulerAncestralDiscreteSchedulerState] = None


class EulerAncestralDiscreteScheduler(SchedulerMixin, ConfigMixin):
    _compatibles = [e.name for e in KarrasDiffusionSchedulers]
    order = 1

    @register_to_config
    def __init__(
        self,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.0001,
        beta_end: float = 0.02,
        beta_schedule: str = "linear",
        trained_betas: Optional[List[float]] = None,
        prediction_type: str = "epsilon",
        timestep_spacing: str = "linspace",
        steps_offset: int = 0,
        rescale_betas_zero_snr: bool = False,
    ):
        betas = make_beta_schedule(beta_schedule, num_train_timesteps, beta_start, beta_end, trained_betas)
        if rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)
        self.betas = betas
        self.alphas = 1.0 - betas
        self.alphas_cumprod = np.cumprod(self.alphas, axis=0)
        if rescale_betas_zero_snr:
            self.alphas_cumprod[-1] = 2**-24

    def set_timesteps(self, num_inference_steps: int) -> EulerAncestralDiscreteSchedulerState:
        cfg = self.config
        timesteps = k_spaced_timesteps(cfg.timestep_spacing, num_inference_steps, cfg.num_train_timesteps,
                                       cfg.steps_offset)
        sigmas_full = np.array(((1 - self.alphas_cumprod) / self.alphas_cumprod) ** 0.5)
        sigmas = np.interp(timesteps, np.arange(0, len(sigmas_full)), sigmas_full)
        sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
        return EulerAncestralDiscreteSchedulerState(
            timesteps=torch.from_numpy(np.asarray(timesteps, dtype=np.float32)), sigmas=torch.from_numpy(sigmas),
            init_noise_sigma=k_init_noise_sigma(sigmas, cfg.timestep_spacing),
            num_inference_steps=num_inference_steps)

    def scale_model_input(self, state, sample: torch.Tensor, timestep) -> torch.Tensor:
        sigma = state.sigmas[index_for_timestep(state.timesteps, timestep)]
        return sample / float((sigma**2 + 1) ** 0.5)

    def step(self, state: EulerAncestralDiscreteSchedulerState, model_output: torch.Tensor, timestep,
             sample: torch.Tensor, generator: Optional[torch.Generator] = None,
             variance_noise: Optional[torch.Tensor] = None, return_dict: bool = True):
        idx = index_for_timestep(state.timesteps, timestep)
        sigma, sigma_to = state.sigmas[idx], state.sigmas[idx + 1]
        sample_f, model_output_f = sample.float(), model_output.float()
        if self.config.prediction_type == "sample":
            raise NotImplementedError("prediction_type 'sample' is not supported")
        pred_original_sample = k_pred_original(self.config.prediction_type, model_output_f, sample_f, sigma)

        sigma_up = torch.sqrt(torch.clamp_min(sigma_to**2 * (sigma**2 - sigma_to**2) / sigma**2, 0.0))
        sigma_down = torch.sqrt(torch.clamp_min(sigma_to**2 - sigma_up**2, 0.0))
        derivative = (sample_f - pred_original_sample) / float(sigma)
        prev_sample = sample_f + derivative * float(sigma_down - sigma)
        noise = step_noise(variance_noise, generator, model_output, "EulerAncestral")
        prev_sample = (prev_sample + noise * float(sigma_up)).to(model_output.dtype)
        if not return_dict:
            return (prev_sample, pred_original_sample.to(model_output.dtype))
        return EulerAncestralDiscreteSchedulerOutput(
            prev_sample=prev_sample, pred_original_sample=pred_original_sample.to(model_output.dtype), state=state)

    add_noise = staticmethod(add_sigma_noise)

    def __len__(self):
        return self.config.num_train_timesteps

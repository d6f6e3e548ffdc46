"""KDPM2 (k-diffusion DPM-2) sampler.

Port of `diffusers_tpu/schedulers/scheduling_k_dpm_2_discrete.py`: the sigma
ladder and its log-space midpoints, interleaved, so a loop of N steps calls
the model 2N - 1 times: an even step index takes an Euler step to the
midpoint and keeps its sample, an odd one takes the DPM-2 step from that
sample with the derivative at the midpoint. Ladders in numpy on the host,
exactly as JAX builds them; the step index and the kept sample live on the
state and `step` updates them in place.
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
class KDPM2DiscreteSchedulerState:
    timesteps: torch.Tensor  # float32 [2S-1], host
    sigmas: torch.Tensor  # float32 [2S+1], host
    sigmas_interpol: torch.Tensor  # float32 [2S+1], host
    init_noise_sigma: float
    num_inference_steps: Optional[int] = None
    step_index: int = 0
    buffered_sample: Optional[torch.Tensor] = None  # the first-order step's sample, float32


@dataclass
class KDPM2DiscreteSchedulerOutput(BaseOutput):
    prev_sample: torch.Tensor
    pred_original_sample: Optional[torch.Tensor] = None
    state: Optional[KDPM2DiscreteSchedulerState] = None


def k_dpm_2_ladders(scheduler, num_inference_steps: int):
    """(timesteps, float64 sigmas with the final 0, log sigmas of the
    training ladder) of the KDPM2 pair: Karras timesteps are rounded."""
    cfg = scheduler.config
    timesteps = k_spaced_timesteps(cfg.timestep_spacing, num_inference_steps, cfg.num_train_timesteps,
                                   cfg.steps_offset)
    sigmas_full = np.array(((1 - scheduler.alphas_cumprod) / scheduler.alphas_cumprod) ** 0.5)
    log_sigmas = np.log(sigmas_full)
    sigmas = np.interp(timesteps, np.arange(0, len(sigmas_full)), sigmas_full)
    if cfg.use_karras_sigmas:
        sigmas = convert_to_karras(sigmas, num_inference_steps)
        timesteps = np.array([sigma_to_t(s, log_sigmas) for s in sigmas]).round()
    return timesteps, np.concatenate([sigmas, [0.0]]).astype(np.float64), log_sigmas


class KDPM2DiscreteScheduler(SchedulerMixin, ConfigMixin):
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
        use_karras_sigmas: bool = False,
        prediction_type: str = "epsilon",
        timestep_spacing: str = "linspace",
        steps_offset: int = 0,
    ):
        betas = make_beta_schedule(beta_schedule, num_train_timesteps, beta_start, beta_end, trained_betas)
        self.betas = betas
        self.alphas = 1.0 - betas
        self.alphas_cumprod = np.cumprod(self.alphas, axis=0)

    def set_timesteps(self, num_inference_steps: int) -> KDPM2DiscreteSchedulerState:
        timesteps, sigmas, log_sigmas = k_dpm_2_ladders(self, num_inference_steps)
        with np.errstate(divide="ignore"):  # log-space midpoints with the previous sigma
            sigmas_interpol = np.exp(0.5 * (np.log(sigmas) + np.log(np.roll(sigmas, 1))))
        sigmas_interpol[~np.isfinite(sigmas_interpol)] = 0.0

        def interleave(x):
            return np.concatenate([x[:1], np.repeat(x[1:], 2)[:-1], x[-1:]]).astype(np.float32)

        timesteps_interpol = np.array([sigma_to_t(s, log_sigmas) for s in sigmas_interpol]).astype(np.float32)
        interleaved = np.stack([timesteps_interpol[1:-1], timesteps[1:]], axis=-1).reshape(-1)
        return KDPM2DiscreteSchedulerState(
            timesteps=torch.from_numpy(np.concatenate([timesteps[:1], interleaved]).astype(np.float32)),
            sigmas=torch.from_numpy(interleave(sigmas)), sigmas_interpol=torch.from_numpy(interleave(sigmas_interpol)),
            init_noise_sigma=k_init_noise_sigma(sigmas, self.config.timestep_spacing),
            num_inference_steps=num_inference_steps)

    def prepare(self, state, sample):
        """JAX allocates its buffer here; the port's is set by `step`."""
        return state

    def scale_model_input(self, state, sample: torch.Tensor, timestep=None) -> torch.Tensor:
        idx = state.step_index
        sigma = state.sigmas[idx] if idx % 2 == 0 else state.sigmas_interpol[idx]
        return sample / float((sigma**2 + 1) ** 0.5)

    def step(self, state: KDPM2DiscreteSchedulerState, model_output: torch.Tensor, timestep, sample: torch.Tensor,
             return_dict: bool = True):
        """The step to the midpoint (even step index) or the DPM-2 step (odd);
        updates `state` in place."""
        idx = state.step_index
        first = idx % 2 == 0
        sample_f = sample.float()
        if first:
            sigma, sigma_interpol = state.sigmas[idx], state.sigmas_interpol[idx + 1]
        else:
            sigma, sigma_interpol, sigma_next = state.sigmas[idx - 1], state.sigmas_interpol[idx], state.sigmas[idx]
        pred_original = k_pred_original(self.config.prediction_type, model_output.float(), sample_f,
                                        sigma if first else sigma_interpol, allow_sample=False)
        if first:
            derivative = (sample_f - pred_original) / float(sigma if sigma != 0 else 1.0)
            prev_sample = sample_f + derivative * float(sigma_interpol - sigma)
            state.buffered_sample = sample_f
        else:
            derivative = (sample_f - pred_original) / float(sigma_interpol if sigma_interpol != 0 else 1.0)
            prev_sample = state.buffered_sample + derivative * float(sigma_next - sigma)
        state.step_index = idx + 1
        prev_sample = prev_sample.to(model_output.dtype)
        if not return_dict:
            return (prev_sample, state)
        return KDPM2DiscreteSchedulerOutput(prev_sample=prev_sample,
                                            pred_original_sample=pred_original.to(model_output.dtype), state=state)

    add_noise = staticmethod(add_sigma_noise)

    def __len__(self):
        return self.config.num_train_timesteps

"""KDPM2 ancestral sampler.

Port of `diffusers_tpu/schedulers/scheduling_k_dpm_2_ancestral_discrete.py`:
KDPM2's interleaved two-evaluation step with the ancestral split of each
interval into sigma_down (the deterministic part, whose log-space midpoint
the first evaluation targets) and sigma_up (the noise the second step adds).
Ladders in numpy on the host exactly as in JAX; the step index and the kept
sample live on the state and `step` updates them in place. Each step takes
`variance_noise` or draws from `generator`, and raises with neither, as
JAX's does without a PRNG key (JAX's pipelines pass none).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..configuration_utils import ConfigMixin, register_to_config
from ..utils import BaseOutput
from .scheduling_k_dpm_2_discrete import k_dpm_2_ladders
from .scheduling_utils import (
    KarrasDiffusionSchedulers,
    SchedulerMixin,
    add_sigma_noise,
    k_init_noise_sigma,
    k_pred_original,
    make_beta_schedule,
    step_noise,
)
from .sigma_utils import sigma_to_t


@dataclass
class KDPM2AncestralDiscreteSchedulerState:
    timesteps: torch.Tensor  # float32 [2S-1], host
    sigmas: torch.Tensor  # float32 [2S+1] each of these four, host
    sigmas_interpol: torch.Tensor
    sigmas_up: torch.Tensor
    sigmas_down: torch.Tensor
    init_noise_sigma: float
    num_inference_steps: Optional[int] = None
    step_index: int = 0
    buffered_sample: Optional[torch.Tensor] = None  # the first-order step's sample, float32


@dataclass
class KDPM2AncestralDiscreteSchedulerOutput(BaseOutput):
    prev_sample: torch.Tensor
    pred_original_sample: Optional[torch.Tensor] = None
    state: Optional[KDPM2AncestralDiscreteSchedulerState] = None


class KDPM2AncestralDiscreteScheduler(SchedulerMixin, ConfigMixin):
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

    def set_timesteps(self, num_inference_steps: int) -> KDPM2AncestralDiscreteSchedulerState:
        timesteps, sigmas, log_sigmas = k_dpm_2_ladders(self, num_inference_steps)
        sigmas_next = np.roll(sigmas, -1)
        sigmas_next[-1] = 0.0
        with np.errstate(divide="ignore", invalid="ignore"):
            sigmas_up = (sigmas_next**2 * (sigmas**2 - sigmas_next**2) / sigmas**2) ** 0.5
        sigmas_up[~np.isfinite(sigmas_up)] = 0.0
        sigmas_down = (np.maximum(sigmas_next**2 - sigmas_up**2, 0.0)) ** 0.5
        sigmas_down[-1] = 0.0
        with np.errstate(divide="ignore"):
            sigmas_interpol = np.exp(0.5 * (np.log(sigmas) + np.log(sigmas_down)))
        sigmas_interpol[~np.isfinite(sigmas_interpol)] = 0.0
        sigmas_interpol[-2:] = 0.0

        def interleave(x):
            return torch.from_numpy(np.concatenate([x[:1], np.repeat(x[1:], 2), x[-1:]]).astype(np.float32))

        timesteps_interpol = np.array([sigma_to_t(s, log_sigmas) for s in sigmas_interpol]).astype(np.float32)
        interleaved = np.stack([timesteps_interpol[:-2], timesteps[1:]], axis=-1).reshape(-1)
        return KDPM2AncestralDiscreteSchedulerState(
            timesteps=torch.from_numpy(np.concatenate([timesteps[:1], interleaved]).astype(np.float32)),
            sigmas=interleave(sigmas), sigmas_interpol=interleave(sigmas_interpol),
            sigmas_up=interleave(sigmas_up), sigmas_down=interleave(sigmas_down),
            init_noise_sigma=k_init_noise_sigma(sigmas, self.config.timestep_spacing),
            num_inference_steps=num_inference_steps)

    def prepare(self, state, sample):
        """JAX allocates its buffer here; the port's is set by `step`."""
        return state

    def scale_model_input(self, state, sample: torch.Tensor, timestep=None) -> torch.Tensor:
        idx = state.step_index
        sigma = state.sigmas[idx] if idx % 2 == 0 else state.sigmas_interpol[idx - 1]
        return sample / float((sigma**2 + 1) ** 0.5)

    def step(self, state: KDPM2AncestralDiscreteSchedulerState, model_output: torch.Tensor, timestep,
             sample: torch.Tensor, generator: Optional[torch.Generator] = None,
             variance_noise: Optional[torch.Tensor] = None, return_dict: bool = True):
        """The step to the midpoint (even step index) or the ancestral DPM-2
        step (odd); updates `state` in place."""
        idx = state.step_index
        first = idx % 2 == 0
        prev_i = max(idx - 1, 0)
        sample_f = sample.float()
        sigma = state.sigmas[idx] if first else state.sigmas[prev_i]
        sigma_interpol = state.sigmas_interpol[idx] if first else state.sigmas_interpol[prev_i]
        noise = step_noise(variance_noise, generator, model_output, "KDPM2Ancestral")
        pred_original = k_pred_original(self.config.prediction_type, model_output.float(), sample_f,
                                        sigma if first else sigma_interpol, allow_sample=False)
        if first:
            derivative = (sample_f - pred_original) / float(sigma if sigma != 0 else 1.0)
            prev_sample = sample_f + derivative * float(sigma_interpol - sigma)
            state.buffered_sample = sample_f
        else:
            derivative = (sample_f - pred_original) / float(sigma_interpol if sigma_interpol != 0 else 1.0)
            prev_sample = state.buffered_sample + derivative * float(state.sigmas_down[prev_i] - sigma)
            prev_sample = prev_sample + noise * float(state.sigmas_up[prev_i])
        state.step_index = idx + 1
        prev_sample = prev_sample.to(model_output.dtype)
        if not return_dict:
            return (prev_sample, state)
        return KDPM2AncestralDiscreteSchedulerOutput(prev_sample=prev_sample,
                                                     pred_original_sample=pred_original.to(model_output.dtype),
                                                     state=state)

    add_noise = staticmethod(add_sigma_noise)

    def __len__(self):
        return self.config.num_train_timesteps

"""Improved PNDM (fourth-order pseudo linear multistep) sampler.

Port of `diffusers_tpu/schedulers/scheduling_ipndm.py`: cosine-parametrized
alpha / beta ladders on a linspace(1 -> 0) grid, and the Adams-Bashforth
blend of up to four buffered `ets` terms. Ladders in numpy on the host
exactly as in JAX; the `ets` history and the step index live on the state
and `step` updates them in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..configuration_utils import ConfigMixin, register_to_config
from ..utils import BaseOutput
from .scheduling_utils import SchedulerMixin


@dataclass
class IPNDMSchedulerState:
    timesteps: torch.Tensor  # float32 [S], host
    alphas: torch.Tensor  # float32 [S+1], host
    betas: torch.Tensor  # float32 [S+1], host
    num_inference_steps: int
    init_noise_sigma: float = 1.0
    step_index: int = 0
    ets: List[torch.Tensor] = field(default_factory=list)  # newest last, at most 4


@dataclass
class IPNDMSchedulerOutput(BaseOutput):
    prev_sample: torch.Tensor
    state: Optional[IPNDMSchedulerState] = None


class IPNDMScheduler(SchedulerMixin, ConfigMixin):
    order = 1

    @register_to_config
    def __init__(self, num_train_timesteps: int = 1000, trained_betas: Optional[List[float]] = None):
        pass

    def set_timesteps(self, num_inference_steps: int) -> IPNDMSchedulerState:
        steps = np.linspace(1, 0, num_inference_steps + 1, dtype=np.float64)[:-1]
        steps = np.concatenate([steps, [0.0]])
        if self.config.trained_betas is not None:
            betas = np.asarray(self.config.trained_betas, dtype=np.float64)
        else:
            betas = np.sin(steps * math.pi / 2) ** 2
        alphas = (1.0 - betas**2) ** 0.5
        timesteps = (np.arctan2(betas, alphas) / math.pi * 2)[:-1]
        return IPNDMSchedulerState(timesteps=torch.from_numpy(timesteps.astype(np.float32)),
                                   alphas=torch.from_numpy(alphas.astype(np.float32)),
                                   betas=torch.from_numpy(betas.astype(np.float32)),
                                   num_inference_steps=num_inference_steps)

    def prepare(self, state, sample):
        """JAX allocates its history here; the port's grows in `step`."""
        return state

    def scale_model_input(self, state, sample: torch.Tensor, timestep=None) -> torch.Tensor:
        return sample

    def step(self, state: IPNDMSchedulerState, model_output: torch.Tensor, timestep, sample: torch.Tensor,
             return_dict: bool = True):
        """One step at `state.step_index`; updates `state` in place."""
        idx = state.step_index
        sample_f = sample.float()
        ets = sample_f * float(state.betas[idx]) + model_output.float() * float(state.alphas[idx])
        state.ets = (state.ets + [ets])[-4:]
        e = state.ets[::-1]  # newest first
        if len(e) == 1:
            blend = e[0]
        elif len(e) == 2:
            blend = (3 * e[0] - e[1]) / 2
        elif len(e) == 3:
            blend = (23 * e[0] - 16 * e[1] + 5 * e[2]) / 12
        else:
            blend = (55 * e[0] - 59 * e[1] + 37 * e[2] - 9 * e[3]) / 24
        alpha, sigma = state.alphas[idx], state.betas[idx]
        pred = (sample_f - float(sigma) * blend) / float(torch.clamp_min(alpha, 1e-8))
        prev_sample = float(state.alphas[idx + 1]) * pred + blend * float(state.betas[idx + 1])
        state.step_index = idx + 1
        prev_sample = prev_sample.to(model_output.dtype)
        if not return_dict:
            return (prev_sample, state)
        return IPNDMSchedulerOutput(prev_sample=prev_sample, state=state)

    def __len__(self):
        return self.config.num_train_timesteps

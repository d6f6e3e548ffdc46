"""EDM DPM-Solver++ multistep sampler (orders 1-2).

Port of `diffusers_tpu/schedulers/scheduling_edm_dpmsolver_multistep.py`:
the EDM ladder and preconditioning of `EDMEulerScheduler` (the model
receives c_noise = 0.25 log sigma as its timestep, a float) with the
DPM-Solver++ or SDE-DPM-Solver++ multistep update (alpha_t = 1). Scalars on
the host in float32; the history of x0 predictions, the step index and the
warm-up count live on the state and `step` updates them in place;
sde-dpmsolver++ takes `variance_noise` or draws from `generator`, and raises
with neither, as JAX's does without a PRNG key.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..configuration_utils import ConfigMixin, register_to_config
from ..utils import BaseOutput
from .scheduling_edm_euler import EDMPreconditioning, edm_sigmas
from .scheduling_utils import SchedulerMixin, add_sigma_noise, step_noise


@dataclass
class EDMDPMSolverMultistepSchedulerState:
    timesteps: torch.Tensor  # float32 c_noise values [S], host
    sigmas: torch.Tensor  # float32 [S+1], host
    init_noise_sigma: float = 80.0
    num_inference_steps: Optional[int] = None
    step_index: int = 0
    lower_order_nums: int = 0
    model_outputs: List[torch.Tensor] = field(default_factory=list)  # x0 predictions, newest last


@dataclass
class EDMDPMSolverMultistepSchedulerOutput(BaseOutput):
    prev_sample: torch.Tensor
    state: Optional[EDMDPMSolverMultistepSchedulerState] = None


class EDMDPMSolverMultistepScheduler(EDMPreconditioning, SchedulerMixin, ConfigMixin):
    order = 1

    @register_to_config
    def __init__(
        self,
        sigma_min: float = 0.002,
        sigma_max: float = 80.0,
        sigma_data: float = 0.5,
        sigma_schedule: str = "karras",
        num_train_timesteps: int = 1000,
        prediction_type: str = "epsilon",
        rho: float = 7.0,
        solver_order: int = 2,
        thresholding: bool = False,
        dynamic_thresholding_ratio: float = 0.995,
        sample_max_value: float = 1.0,
        algorithm_type: str = "dpmsolver++",
        solver_type: str = "midpoint",
        lower_order_final: bool = True,
        euler_at_final: bool = False,
        final_sigmas_type: str = "zero",
    ):
        if algorithm_type not in ("dpmsolver++", "sde-dpmsolver++"):
            raise NotImplementedError(f"{algorithm_type} is not implemented")
        if solver_order > 2:
            raise NotImplementedError("solver_order > 2 not implemented")
        self.init_noise_sigma = (sigma_max**2 + 1) ** 0.5

    def set_timesteps(self, num_inference_steps: int) -> EDMDPMSolverMultistepSchedulerState:
        sigmas = edm_sigmas(self.config, np.linspace(0, 1, num_inference_steps, dtype=np.float64))
        timesteps = 0.25 * np.log(sigmas)
        sigma_last = self.config.sigma_min if self.config.final_sigmas_type == "sigma_min" else 0.0
        sigmas = np.concatenate([sigmas, [sigma_last]]).astype(np.float32)
        return EDMDPMSolverMultistepSchedulerState(
            timesteps=torch.from_numpy(timesteps.astype(np.float32)), sigmas=torch.from_numpy(sigmas),
            init_noise_sigma=self.init_noise_sigma, num_inference_steps=num_inference_steps)

    def prepare(self, state, sample):
        """JAX allocates its history here; the port's grows in `step`."""
        return state

    def scale_model_input(self, state, sample: torch.Tensor, timestep=None) -> torch.Tensor:
        return self.precondition_inputs(sample, state.sigmas[state.step_index])

    def step(self, state: EDMDPMSolverMultistepSchedulerState, model_output: torch.Tensor, timestep,
             sample: torch.Tensor, generator: Optional[torch.Generator] = None,
             variance_noise: Optional[torch.Tensor] = None, return_dict: bool = True):
        """One step at `state.step_index`; updates `state` in place."""
        cfg = self.config
        idx, num_steps = state.step_index, int(state.timesteps.shape[0])
        sample_f = sample.float()
        x0 = self.precondition_outputs(sample_f, model_output.float(), state.sigmas[idx])
        state.model_outputs = (state.model_outputs + [x0])[-cfg.solver_order:]
        final = idx == num_steps - 1 and (cfg.euler_at_final or (cfg.lower_order_final and num_steps < 15)
                                          or cfg.final_sigmas_type == "zero")
        first = state.lower_order_nums < 1 or final

        def lam(s):
            return -torch.log(torch.clamp_min(s, 1e-20))

        sigma_t, sigma_s0 = state.sigmas[idx + 1], state.sigmas[idx]
        h = lam(sigma_t) - lam(sigma_s0)
        m0 = state.model_outputs[-1]
        sde = cfg.algorithm_type == "sde-dpmsolver++"
        noise = step_noise(variance_noise, generator, model_output, "sde-dpmsolver++") if sde else None
        if sde:
            prev_sample = float(sigma_t / sigma_s0 * torch.exp(-h)) * sample_f + float(1 - torch.exp(-2.0 * h)) * m0
        else:
            prev_sample = float(sigma_t / sigma_s0) * sample_f - float(torch.exp(-h) - 1.0) * m0
        if not first:
            r0 = (lam(sigma_s0) - lam(state.sigmas[idx - 1])) / h
            d1 = (m0 - state.model_outputs[-2]) / float(r0)
            midpoint = cfg.solver_type == "midpoint"
            if sde:
                c = 0.5 * (1 - torch.exp(-2.0 * h)) if midpoint else (1.0 - torch.exp(-2.0 * h)) / (-2.0 * h) + 1.0
            else:
                c = -0.5 * (torch.exp(-h) - 1.0) if midpoint else (torch.exp(-h) - 1.0) / h + 1.0
            prev_sample = prev_sample + float(c) * d1
        if sde:
            prev_sample = prev_sample + float(sigma_t * torch.sqrt(1.0 - torch.exp(-2 * h))) * noise
        state.step_index = idx + 1
        state.lower_order_nums = min(state.lower_order_nums + 1, cfg.solver_order)
        prev_sample = prev_sample.to(model_output.dtype)
        if not return_dict:
            return (prev_sample, state)
        return EDMDPMSolverMultistepSchedulerOutput(prev_sample=prev_sample, state=state)

    add_noise = staticmethod(add_sigma_noise)

    def __len__(self):
        return self.config.num_train_timesteps

"""EDM Euler sampler (Karras et al. 2022).

Port of `diffusers_tpu/schedulers/scheduling_edm_euler.py`: the Karras (rho)
or exponential sigma ladder between `sigma_min` and `sigma_max`, EDM's
preconditioning (c_in, c_skip, c_out, and c_noise = 0.25 log sigma as the
timestep the model receives) and the Euler step. Ladders in numpy on the
host exactly as in JAX; scalars on the host in float32; samples in torch in
float32, `prev_sample` cast back to the model output's dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..configuration_utils import ConfigMixin, register_to_config
from ..utils import BaseOutput
from .scheduling_utils import SchedulerMixin, add_sigma_noise, index_for_timestep


@dataclass
class EDMEulerSchedulerState:
    timesteps: torch.Tensor  # float32 c_noise values [S], host
    sigmas: torch.Tensor  # float32 [S+1], host
    init_noise_sigma: float
    num_inference_steps: Optional[int] = None


@dataclass
class EDMEulerSchedulerOutput(BaseOutput):
    prev_sample: torch.Tensor
    pred_original_sample: Optional[torch.Tensor] = None
    state: Optional[EDMEulerSchedulerState] = None


def edm_sigmas(config, ramp: np.ndarray) -> np.ndarray:
    """The EDM ladder over `ramp` in [0, 1]: Karras (rho) or exponential."""
    smin, smax, rho = config.sigma_min, config.sigma_max, config.rho
    if config.sigma_schedule == "karras":
        min_inv_rho, max_inv_rho = smin ** (1 / rho), smax ** (1 / rho)
        return (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
    if config.sigma_schedule == "exponential":
        return np.exp(np.linspace(np.log(smax), np.log(smin), len(ramp)))
    raise ValueError(f"unsupported sigma_schedule {config.sigma_schedule}")


class EDMPreconditioning:
    """EDM's input and output preconditioning, on float32 host sigmas."""

    def precondition_inputs(self, sample: torch.Tensor, sigma) -> torch.Tensor:
        sigma = torch.as_tensor(sigma, dtype=torch.float32)
        return sample * float(1 / ((sigma**2 + self.config.sigma_data**2) ** 0.5))

    def precondition_noise(self, sigma):
        return 0.25 * torch.log(sigma) if isinstance(sigma, torch.Tensor) else 0.25 * np.log(sigma)

    def precondition_outputs(self, sample: torch.Tensor, model_output: torch.Tensor, sigma) -> torch.Tensor:
        sigma = torch.as_tensor(sigma, dtype=torch.float32)
        sd = self.config.sigma_data
        c_skip = sd**2 / (sigma**2 + sd**2)
        if self.config.prediction_type == "epsilon":
            c_out = sigma * sd / (sigma**2 + sd**2) ** 0.5
        elif self.config.prediction_type == "v_prediction":
            c_out = -sigma * sd / (sigma**2 + sd**2) ** 0.5
        else:
            raise ValueError(f"unsupported prediction_type {self.config.prediction_type}")
        return float(c_skip) * sample + float(c_out) * model_output


class EDMEulerScheduler(EDMPreconditioning, SchedulerMixin, ConfigMixin):
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
        final_sigmas_type: str = "zero",
    ):
        if sigma_schedule not in ("karras", "exponential"):
            raise ValueError(f"unsupported sigma_schedule {sigma_schedule}")

    def set_timesteps(self, num_inference_steps: int) -> EDMEulerSchedulerState:
        sigmas = edm_sigmas(self.config, np.linspace(0, 1, num_inference_steps, dtype=np.float64)).astype(np.float32)
        timesteps = 0.25 * np.log(sigmas)
        sigma_last = self.config.sigma_min if self.config.final_sigmas_type == "sigma_min" else 0.0
        sigmas = np.concatenate([sigmas, [sigma_last]]).astype(np.float32)
        return EDMEulerSchedulerState(timesteps=torch.from_numpy(np.asarray(timesteps, dtype=np.float32)),
                                      sigmas=torch.from_numpy(sigmas),
                                      init_noise_sigma=float(np.float32((float(sigmas.max()) ** 2 + 1) ** 0.5)),
                                      num_inference_steps=num_inference_steps)

    def scale_model_input(self, state, sample: torch.Tensor, timestep) -> torch.Tensor:
        return self.precondition_inputs(sample, state.sigmas[index_for_timestep(state.timesteps, timestep)])

    def step(self, state: EDMEulerSchedulerState, model_output: torch.Tensor, timestep, sample: torch.Tensor,
             return_dict: bool = True):
        idx = index_for_timestep(state.timesteps, timestep)
        sigma, sigma_next = state.sigmas[idx], state.sigmas[idx + 1]
        sample_f = sample.float()
        pred_original = self.precondition_outputs(sample_f, model_output.float(), sigma)
        derivative = (sample_f - pred_original) / float(sigma)
        prev_sample = (sample_f + derivative * float(sigma_next - sigma)).to(model_output.dtype)
        if not return_dict:
            return (prev_sample, pred_original.to(model_output.dtype))
        return EDMEulerSchedulerOutput(prev_sample=prev_sample,
                                       pred_original_sample=pred_original.to(model_output.dtype), state=state)

    add_noise = staticmethod(add_sigma_noise)

    def __len__(self):
        return self.config.num_train_timesteps

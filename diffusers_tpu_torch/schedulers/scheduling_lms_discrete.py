"""Linear multistep (k-LMS) sampler.

Port of `diffusers_tpu/schedulers/scheduling_lms_discrete.py`: the
integrated Lagrange-polynomial coefficients over the sigma ladder depend only
on the ladder, the step and the order, so the whole [S, 4] table is made in
numpy (scipy quadrature in float64) at `set_timesteps`, as in JAX, and a step
is a weighted sum of the derivative history. The history (newest first) and
the step index live on the state and `step` updates them in place; a loop
that starts at a later step index sums the derivatives it has, as upstream's
does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
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
)
from .sigma_utils import convert_to_karras, sigma_to_t


@dataclass
class LMSDiscreteSchedulerState:
    timesteps: torch.Tensor  # float32 [S], host
    sigmas: torch.Tensor  # float32 [S+1], host
    lms_coeffs: torch.Tensor  # float32 [S, 4], host
    init_noise_sigma: float
    num_inference_steps: Optional[int] = None
    step_index: int = 0
    derivatives: List[torch.Tensor] = field(default_factory=list)  # newest first


@dataclass
class LMSDiscreteSchedulerOutput(BaseOutput):
    prev_sample: torch.Tensor
    pred_original_sample: Optional[torch.Tensor] = None
    state: Optional[LMSDiscreteSchedulerState] = None


class LMSDiscreteScheduler(SchedulerMixin, ConfigMixin):
    _compatibles = [e.name for e in KarrasDiffusionSchedulers]
    order = 1
    lms_order = 4

    @register_to_config
    def __init__(
        self,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.0001,
        beta_end: float = 0.02,
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

    @staticmethod
    def _lms_coeff(order: int, t: int, current_order: int, sigmas: np.ndarray) -> float:
        """The integral from sigma_t to sigma_{t+1} of the Lagrange basis
        polynomial of sigma_{t - current_order} over the last `order` sigmas."""
        import scipy.integrate

        def lms_derivative(tau):
            prod = 1.0
            for k in range(order):
                if current_order == k:
                    continue
                prod *= (tau - sigmas[t - k]) / (sigmas[t - current_order] - sigmas[t - k])
            return prod

        return scipy.integrate.quad(lms_derivative, sigmas[t], sigmas[t + 1], epsrel=1e-4)[0]

    def set_timesteps(self, num_inference_steps: int) -> LMSDiscreteSchedulerState:
        cfg = self.config
        timesteps = k_spaced_timesteps(cfg.timestep_spacing, num_inference_steps, cfg.num_train_timesteps,
                                       cfg.steps_offset)
        sigmas_full = np.array(((1 - self.alphas_cumprod) / self.alphas_cumprod) ** 0.5)
        sigmas = np.interp(timesteps, np.arange(0, len(sigmas_full)), sigmas_full)
        if cfg.use_karras_sigmas:
            sigmas = convert_to_karras(sigmas, num_inference_steps)
            timesteps = np.array([sigma_to_t(s, np.log(sigmas_full)) for s in sigmas])
        sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)

        coeffs = np.zeros((num_inference_steps, self.lms_order), dtype=np.float32)
        for i in range(num_inference_steps):
            order = min(i + 1, self.lms_order)
            for j in range(order):
                coeffs[i, j] = self._lms_coeff(order, i, j, sigmas.astype(np.float64))
        return LMSDiscreteSchedulerState(
            timesteps=torch.from_numpy(np.asarray(timesteps, dtype=np.float32)), sigmas=torch.from_numpy(sigmas),
            lms_coeffs=torch.from_numpy(coeffs), init_noise_sigma=k_init_noise_sigma(sigmas, cfg.timestep_spacing),
            num_inference_steps=num_inference_steps)

    def prepare(self, state, sample):
        """JAX allocates its history here; the port's grows in `step`."""
        return state

    def scale_model_input(self, state, sample: torch.Tensor, timestep) -> torch.Tensor:
        sigma = state.sigmas[index_for_timestep(state.timesteps, timestep)]
        return sample / float((sigma**2 + 1) ** 0.5)

    def step(self, state: LMSDiscreteSchedulerState, model_output: torch.Tensor, timestep, sample: torch.Tensor,
             return_dict: bool = True):
        """One LMS step at `state.step_index`; updates `state` in place."""
        idx = state.step_index
        sigma = state.sigmas[idx]
        sample_f = sample.float()
        pred_original_sample = k_pred_original(self.config.prediction_type, model_output.float(), sample_f, sigma)
        derivative = (sample_f - pred_original_sample) / float(sigma)
        state.derivatives = ([derivative] + state.derivatives)[:self.lms_order]
        coeffs = state.lms_coeffs[idx, :len(state.derivatives)].to(sample_f.device)
        update = torch.tensordot(coeffs, torch.stack(state.derivatives), dims=1)
        state.step_index = idx + 1
        prev_sample = (sample_f + update).to(model_output.dtype)
        if not return_dict:
            return (prev_sample, state)
        return LMSDiscreteSchedulerOutput(prev_sample=prev_sample,
                                          pred_original_sample=pred_original_sample.to(model_output.dtype),
                                          state=state)

    add_noise = staticmethod(add_sigma_noise)

    def __len__(self):
        return self.config.num_train_timesteps

"""DEIS multistep sampler (log-rho, orders 1-2).

Port of `diffusers_tpu/schedulers/scheduling_deis_multistep.py`: the
exponential integrator over noise predictions with the log-rho polynomial
coefficients. Ladders in numpy on the host exactly as in JAX (its terminal
sigma is the training ladder's smallest, not 0); scalars on the host in
float32; the history of converted outputs, the step index and the count of
steps taken live on the state and `step` updates them in place; the warm-up
counts the steps this state has taken.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..configuration_utils import ConfigMixin, register_to_config
from ..utils import BaseOutput
from .scheduling_dpmsolver_multistep import dpm_spaced_timesteps
from .scheduling_utils import (
    KarrasDiffusionSchedulers,
    SchedulerMixin,
    add_vp_noise,
    log_snr,
    make_beta_schedule,
    threshold_sample,
    vp_alpha_sigma,
)


@dataclass
class DEISMultistepSchedulerState:
    timesteps: torch.Tensor  # int64 [S], host
    sigmas: torch.Tensor  # float32 [S+1], host
    num_inference_steps: int
    init_noise_sigma: float = 1.0
    step_index: int = 0
    lower_order_nums: int = 0  # steps taken by this state
    model_outputs: List[torch.Tensor] = field(default_factory=list)  # converted (noise) outputs, newest last


@dataclass
class DEISMultistepSchedulerOutput(BaseOutput):
    prev_sample: torch.Tensor
    state: Optional[DEISMultistepSchedulerState] = None


class DEISMultistepScheduler(SchedulerMixin, ConfigMixin):
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
        solver_order: int = 2,
        prediction_type: str = "epsilon",
        thresholding: bool = False,
        dynamic_thresholding_ratio: float = 0.995,
        sample_max_value: float = 1.0,
        algorithm_type: str = "deis",
        solver_type: str = "logrho",
        lower_order_final: bool = True,
        timestep_spacing: str = "linspace",
        steps_offset: int = 0,
    ):
        if algorithm_type != "deis" or solver_type != "logrho":
            raise NotImplementedError("only the log-rho deis variant is implemented")
        if solver_order > 2:
            raise NotImplementedError("solver_order > 2 not implemented")
        betas = make_beta_schedule(beta_schedule, num_train_timesteps, beta_start, beta_end, trained_betas)
        self.betas = betas
        self.alphas = 1.0 - betas
        self.alphas_cumprod = np.cumprod(self.alphas, axis=0)
        self.init_noise_sigma = 1.0

    def set_timesteps(self, num_inference_steps: int) -> DEISMultistepSchedulerState:
        cfg = self.config
        ts = dpm_spaced_timesteps(cfg.timestep_spacing, num_inference_steps, cfg.num_train_timesteps,
                                  cfg.num_train_timesteps, cfg.steps_offset)
        sigmas_full = np.array(((1 - self.alphas_cumprod) / self.alphas_cumprod) ** 0.5)
        sigmas = np.interp(ts, np.arange(0, len(sigmas_full)), sigmas_full)
        sigmas = np.concatenate([sigmas, [float(sigmas_full[0])]]).astype(np.float32)
        return DEISMultistepSchedulerState(timesteps=torch.from_numpy(ts), sigmas=torch.from_numpy(sigmas),
                                           num_inference_steps=num_inference_steps)

    def prepare(self, state, sample):
        """JAX allocates its history here; the port's grows in `step`."""
        return state

    def scale_model_input(self, state, sample: torch.Tensor, timestep=None) -> torch.Tensor:
        return sample

    def convert_model_output(self, state, model_output: torch.Tensor, sample: torch.Tensor, idx: int):
        """The noise prediction, through the (thresholded) x0 prediction."""
        cfg = self.config
        alpha_t, sigma_t = vp_alpha_sigma(state.sigmas[idx])
        a, s = float(alpha_t), float(sigma_t)
        if cfg.prediction_type == "epsilon":
            x0 = (sample - s * model_output) / a
        elif cfg.prediction_type == "sample":
            x0 = model_output
        elif cfg.prediction_type == "v_prediction":
            x0 = a * sample - s * model_output
        else:
            raise ValueError(f"unsupported prediction_type {cfg.prediction_type}")
        if cfg.thresholding:
            x0 = threshold_sample(x0, cfg.dynamic_thresholding_ratio, cfg.sample_max_value)
        return (sample - a * x0) / float(torch.clamp_min(sigma_t, 1e-12))

    def step(self, state: DEISMultistepSchedulerState, model_output: torch.Tensor, timestep, sample: torch.Tensor,
             return_dict: bool = True):
        """One step at `state.step_index`; updates `state` in place."""
        idx, num_steps = state.step_index, int(state.timesteps.shape[0])
        sample_f = sample.float()
        converted = self.convert_model_output(state, model_output.float(), sample_f, idx)
        state.model_outputs = (state.model_outputs + [converted])[-2:]
        alpha_t, sigma_t = vp_alpha_sigma(state.sigmas[idx + 1])
        alpha_s0, sigma_s0 = vp_alpha_sigma(state.sigmas[idx])
        final = idx == num_steps - 1 and self.config.lower_order_final and num_steps < 15
        if self.config.solver_order == 1 or state.lower_order_nums < 1 or final:
            h = log_snr(alpha_t, sigma_t) - log_snr(alpha_s0, sigma_s0)
            prev_sample = float(alpha_t / alpha_s0) * sample_f - float(sigma_t * (torch.exp(h) - 1.0)) * converted
        else:  # the log-rho coefficients of the two last outputs
            alpha_s1, sigma_s1 = vp_alpha_sigma(state.sigmas[idx - 1])
            rho_t, rho_s0, rho_s1 = (s / torch.clamp_min(a, 1e-20) for a, s in
                                     ((alpha_t, sigma_t), (alpha_s0, sigma_s0), (alpha_s1, sigma_s1)))

            def ind_fn(t, b, c):
                log = lambda x: torch.log(torch.clamp_min(x, 1e-20))  # noqa: E731
                return t * (-log(c) + log(t) - 1) / (log(b) - log(c))

            coef1 = ind_fn(rho_t, rho_s0, rho_s1) - ind_fn(rho_s0, rho_s0, rho_s1)
            coef2 = ind_fn(rho_t, rho_s1, rho_s0) - ind_fn(rho_s0, rho_s1, rho_s0)
            m0, m1 = state.model_outputs[-1], state.model_outputs[-2]
            prev_sample = float(alpha_t) * (sample_f / float(torch.clamp_min(alpha_s0, 1e-20))
                                            + float(coef1) * m0 + float(coef2) * m1)
        state.step_index, state.lower_order_nums = idx + 1, state.lower_order_nums + 1
        prev_sample = prev_sample.to(model_output.dtype)
        if not return_dict:
            return (prev_sample, state)
        return DEISMultistepSchedulerOutput(prev_sample=prev_sample, state=state)

    def add_noise(self, state, original_samples: torch.Tensor, noise: torch.Tensor, timesteps) -> torch.Tensor:
        return add_vp_noise(state, original_samples, noise, timesteps)

    def __len__(self):
        return self.config.num_train_timesteps

"""Euler (k-diffusion) sampler.

Port of `diffusers_tpu/schedulers/scheduling_euler_discrete.py`. The sigma and
timestep ladders are built in numpy at `set_timesteps` time exactly as in JAX
(`:90-176`), the Karras, exponential and beta ladders included, and kept on
the host as float32 tensors; `step` and `add_noise` gather their sigmas on
the host and do the sample arithmetic in torch. `step` computes in float32
and casts `prev_sample` back to the model output's dtype (`:227`).

With a ladder, the timesteps are fractional (`sigma_to_t`), and a timestep
is found in the schedule by equality (`index_for_timestep`): pass the
schedule's own float32 values back.
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
    k_spaced_timesteps,
    make_beta_schedule,
    rescale_zero_terminal_snr,
)
from .sigma_utils import convert_to_beta, convert_to_exponential, convert_to_karras, sigma_to_t


@dataclass
class EulerDiscreteSchedulerState:
    timesteps: torch.Tensor  # float32 [S], host
    sigmas: torch.Tensor  # float32 [S+1], host
    init_noise_sigma: float
    num_inference_steps: Optional[int] = None


@dataclass
class EulerDiscreteSchedulerOutput(BaseOutput):
    prev_sample: torch.Tensor
    pred_original_sample: Optional[torch.Tensor] = None
    state: Optional[EulerDiscreteSchedulerState] = None


class EulerDiscreteScheduler(SchedulerMixin, ConfigMixin):
    """Euler method sampler following Karras et al. (2022) Algorithm 2."""

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
        interpolation_type: str = "linear",
        use_karras_sigmas: bool = False,
        use_exponential_sigmas: bool = False,
        use_beta_sigmas: bool = False,
        sigma_min: Optional[float] = None,
        sigma_max: Optional[float] = None,
        timestep_spacing: str = "linspace",
        timestep_type: str = "discrete",
        steps_offset: int = 0,
        rescale_betas_zero_snr: bool = False,
        final_sigmas_type: str = "zero",
    ):
        betas = make_beta_schedule(beta_schedule, num_train_timesteps, beta_start, beta_end, trained_betas)
        if rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)
        self.betas = betas
        self.alphas = 1.0 - betas
        self.alphas_cumprod = np.cumprod(self.alphas, axis=0)
        if rescale_betas_zero_snr:
            # close-to-0 sigma at the last step blows up 1/sqrt(acp)
            self.alphas_cumprod[-1] = 2**-24

    def set_timesteps(
        self,
        num_inference_steps: Optional[int] = None,
        timesteps: Optional[List[int]] = None,
    ) -> EulerDiscreteSchedulerState:
        if num_inference_steps is None and timesteps is None:
            raise ValueError("Must pass one of `num_inference_steps` or `timesteps`.")
        if num_inference_steps is not None and timesteps is not None:
            raise ValueError("Can only pass one of `num_inference_steps` or `timesteps`.")
        if num_inference_steps is None:
            num_inference_steps = len(timesteps)

        if timesteps is not None:
            timesteps = np.array(timesteps).astype(np.float32)
        else:
            timesteps = k_spaced_timesteps(self.config.timestep_spacing, num_inference_steps,
                                           self.config.num_train_timesteps, self.config.steps_offset)

        sigmas_full = np.array(((1 - self.alphas_cumprod) / self.alphas_cumprod) ** 0.5)
        log_sigmas = np.log(sigmas_full)
        if self.config.interpolation_type == "linear":
            sigmas = np.interp(timesteps, np.arange(0, len(sigmas_full)), sigmas_full)
        elif self.config.interpolation_type == "log_linear":
            sigmas = np.exp(np.linspace(np.log(sigmas_full[-1]), np.log(sigmas_full[0]), num_inference_steps + 1))
        else:
            raise ValueError(f"unsupported interpolation_type {self.config.interpolation_type}")

        ladder = (convert_to_karras if self.config.use_karras_sigmas else
                  convert_to_exponential if self.config.use_exponential_sigmas else
                  convert_to_beta if self.config.use_beta_sigmas else None)
        if ladder is not None:
            sigmas = ladder(sigmas, num_inference_steps, self.config.sigma_min, self.config.sigma_max)
            timesteps = np.array([sigma_to_t(s, log_sigmas) for s in sigmas])

        if self.config.final_sigmas_type == "sigma_min":
            sigma_last = float(((1 - self.alphas_cumprod[0]) / self.alphas_cumprod[0]) ** 0.5)
        elif self.config.final_sigmas_type == "zero":
            sigma_last = 0
        else:
            raise ValueError(f"final_sigmas_type must be 'zero' or 'sigma_min', got {self.config.final_sigmas_type}")
        sigmas = np.concatenate([sigmas, [sigma_last]]).astype(np.float32)

        if self.config.timestep_type == "continuous" and self.config.prediction_type == "v_prediction":
            timesteps = np.array([0.25 * np.log(s) for s in sigmas[:-1]], dtype=np.float32)

        return EulerDiscreteSchedulerState(
            timesteps=torch.from_numpy(np.asarray(timesteps, dtype=np.float32)),
            sigmas=torch.from_numpy(sigmas),
            init_noise_sigma=k_init_noise_sigma(sigmas, self.config.timestep_spacing),
            num_inference_steps=num_inference_steps,
        )

    def scale_model_input(self, state: EulerDiscreteSchedulerState, sample: torch.Tensor, timestep) -> torch.Tensor:
        sigma = state.sigmas[index_for_timestep(state.timesteps, timestep)]
        return sample / float((sigma**2 + 1) ** 0.5)

    def step(
        self,
        state: EulerDiscreteSchedulerState,
        model_output: torch.Tensor,
        timestep,
        sample: torch.Tensor,
        s_churn: float = 0.0,
        s_tmin: float = 0.0,
        s_tmax: float = float("inf"),
        s_noise: float = 1.0,
        generator: Optional[torch.Generator] = None,
        return_dict: bool = True,
    ):
        idx = index_for_timestep(state.timesteps, timestep)
        sigma = state.sigmas[idx]

        compute_dtype = torch.promote_types(sample.dtype, torch.float32)
        sample_f = sample.to(compute_dtype)
        model_output_f = model_output.to(compute_dtype)

        if s_churn > 0:
            gamma = min(s_churn / (state.sigmas.shape[0] - 1), 2**0.5 - 1) if s_tmin <= sigma <= s_tmax else 0.0
            sigma_hat = sigma * (gamma + 1)
            eps = torch.randn(
                model_output.shape, generator=generator, dtype=torch.float32,
                device=generator.device if generator is not None else model_output.device,
            ).to(device=model_output.device, dtype=compute_dtype) * s_noise
            sample_f = sample_f + eps * float(torch.sqrt(torch.clamp(sigma_hat**2 - sigma**2, min=0.0)))
        else:
            sigma_hat = sigma

        # 1. predicted x_0
        if self.config.prediction_type in ("original_sample", "sample"):
            pred_original_sample = model_output_f
        elif self.config.prediction_type == "epsilon":
            pred_original_sample = sample_f - float(sigma_hat) * model_output_f
        elif self.config.prediction_type == "v_prediction":
            pred_original_sample = model_output_f * float(-sigma / (sigma**2 + 1) ** 0.5) + sample_f / float(sigma**2 + 1)
        else:
            raise ValueError(f"prediction_type {self.config.prediction_type} must be epsilon/sample/v_prediction")

        # 2. Euler ODE step
        derivative = (sample_f - pred_original_sample) / float(sigma_hat)
        dt = float(state.sigmas[idx + 1] - sigma_hat)
        prev_sample = (sample_f + derivative * dt).to(model_output.dtype)

        if not return_dict:
            return (prev_sample, pred_original_sample.to(model_output.dtype))
        return EulerDiscreteSchedulerOutput(
            prev_sample=prev_sample,
            pred_original_sample=pred_original_sample.to(model_output.dtype),
            state=state,
        )

    add_noise = staticmethod(add_sigma_noise)

    def __len__(self):
        return self.config.num_train_timesteps

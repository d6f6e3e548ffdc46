"""DDPM (ancestral) sampler and training noise schedule.

Port of `diffusers_tpu/schedulers/scheduling_ddpm.py` (`DDPMScheduler`
`:68-304`). As in JAX, every per-timestep scalar (x0/xt posterior
coefficients, ancestral sigma, 1/sqrt(alpha_bar)) is computed in float64
numpy at `set_timesteps` time and kept as a float32 table on the host;
`step` gathers its scalars on the host and does only multiplies and adds on
the sample, in float32. `add_noise` and `get_velocity` index the float32
`alphas_cumprod` on the samples' device, cast to the samples' dtype before
the square roots, in JAX's order. The ancestral noise comes from a
`torch.Generator` (or is passed in as `variance_noise`), where JAX takes a
key.
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
    index_for_timestep,
    make_beta_schedule,
    make_spaced_timesteps,
    rescale_zero_terminal_snr,
    sqrt_alpha_terms,
)


@dataclass
class DDPMSchedulerState:
    """Sampling state: the schedule and the per-position coefficient tables,
    float32 on the host."""

    timesteps: torch.Tensor  # int64 [S], descending
    alphas_cumprod: torch.Tensor  # float32 [T] (training ladder, for add_noise)
    sqrt_alpha_prod: torch.Tensor  # sqrt(a_t)
    sqrt_beta_prod: torch.Tensor  # sqrt(1 - a_t)
    inv_sqrt_alpha_prod: torch.Tensor  # 1 / sqrt(a_t)
    x0_coeff: torch.Tensor  # sqrt(a_prev) beta_t / (1 - a_t)
    xt_coeff: torch.Tensor  # sqrt(alpha_t) (1 - a_prev) / (1 - a_t)
    sigma: torch.Tensor  # ancestral std-dev (0 at t == 0) for fixed variance types
    min_log_var: torch.Tensor  # log clipped posterior variance (learned_range)
    max_log_var: torch.Tensor  # log beta_t (learned_range)
    init_noise_sigma: float = 1.0
    num_inference_steps: Optional[int] = None


@dataclass
class DDPMSchedulerOutput(BaseOutput):
    prev_sample: torch.Tensor
    pred_original_sample: Optional[torch.Tensor] = None
    state: Optional[DDPMSchedulerState] = None


class DDPMScheduler(SchedulerMixin, ConfigMixin):
    """Denoising diffusion probabilistic models sampler (Ho et al. 2020)."""

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
        variance_type: str = "fixed_small",
        clip_sample: bool = True,
        prediction_type: str = "epsilon",
        thresholding: bool = False,
        dynamic_thresholding_ratio: float = 0.995,
        clip_sample_range: float = 1.0,
        sample_max_value: float = 1.0,
        timestep_spacing: str = "leading",
        steps_offset: int = 0,
        rescale_betas_zero_snr: bool = False,
    ):
        betas = make_beta_schedule(beta_schedule, num_train_timesteps, beta_start, beta_end, trained_betas)
        if rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)
        self.betas = betas
        self.alphas = 1.0 - betas
        self.alphas_cumprod = np.cumprod(self.alphas, axis=0)
        self.init_noise_sigma = 1.0

    def set_timesteps(
        self,
        num_inference_steps: Optional[int] = None,
        timesteps: Optional[List[int]] = None,
    ) -> DDPMSchedulerState:
        """Build the inference-time state. With no arguments, the full
        training schedule."""
        if num_inference_steps is not None and timesteps is not None:
            raise ValueError("Can only pass one of `num_inference_steps` or `timesteps`.")
        if timesteps is not None:
            for i in range(1, len(timesteps)):
                if timesteps[i] >= timesteps[i - 1]:
                    raise ValueError("`timesteps` must be in descending order.")
            if timesteps[0] >= self.config.num_train_timesteps:
                raise ValueError("`timesteps` must start before num_train_timesteps.")
            ts = np.array(timesteps, dtype=np.int64)
            num_inference_steps = len(ts)
        elif num_inference_steps is not None:
            if num_inference_steps > self.config.num_train_timesteps:
                raise ValueError(
                    f"num_inference_steps ({num_inference_steps}) > num_train_timesteps "
                    f"({self.config.num_train_timesteps})"
                )
            ts = make_spaced_timesteps(
                num_inference_steps, self.config.num_train_timesteps, self.config.timestep_spacing,
                self.config.steps_offset,
            )
        else:
            ts = np.arange(0, self.config.num_train_timesteps)[::-1].copy()

        # float64 coefficient tables (schedule position -> scalar)
        acp = self.alphas_cumprod.astype(np.float64)
        apt = acp[ts]
        prev_ts = np.concatenate([ts[1:], [-1]])
        aptp = np.where(prev_ts >= 0, acp[np.clip(prev_ts, 0, None)], 1.0)
        bpt = 1.0 - apt
        bptp = 1.0 - aptp
        current_alpha = apt / aptp
        current_beta = 1.0 - current_alpha

        posterior_var = np.clip(bptp / bpt * current_beta, 1e-20, None)
        vt = self.config.variance_type
        if vt == "fixed_small_log":
            sigma = np.exp(0.5 * np.log(posterior_var))
        elif vt == "fixed_large":
            sigma = np.sqrt(np.clip(current_beta, 0, None))
        elif vt == "fixed_large_log":
            sigma = np.exp(0.5 * np.log(np.clip(current_beta, 1e-20, None)))
        else:  # fixed_small; learned / learned_range resolve at run time from the tables
            sigma = np.sqrt(posterior_var)
        sigma = np.where(ts > 0, sigma, 0.0)

        def f32(x):
            return torch.from_numpy(np.asarray(x, dtype=np.float32))

        return DDPMSchedulerState(
            timesteps=torch.from_numpy(np.asarray(ts, dtype=np.int64)),
            alphas_cumprod=f32(self.alphas_cumprod),
            sqrt_alpha_prod=f32(np.sqrt(apt)),
            sqrt_beta_prod=f32(np.sqrt(bpt)),
            inv_sqrt_alpha_prod=f32(1.0 / np.sqrt(apt)),
            x0_coeff=f32(np.sqrt(aptp) * current_beta / bpt),
            xt_coeff=f32(np.sqrt(current_alpha) * bptp / bpt),
            sigma=f32(sigma),
            min_log_var=f32(np.log(posterior_var)),
            max_log_var=f32(np.log(np.clip(current_beta, 1e-20, None))),
            init_noise_sigma=1.0,
            num_inference_steps=num_inference_steps,
        )

    def scale_model_input(self, state: DDPMSchedulerState, sample: torch.Tensor, timestep=None) -> torch.Tensor:
        return sample

    def _threshold_sample(self, sample: torch.Tensor) -> torch.Tensor:
        """Dynamic thresholding (https://huggingface.co/papers/2205.11487)."""
        flat = sample.float().reshape(sample.shape[0], -1)
        s = torch.quantile(flat.abs(), self.config.dynamic_thresholding_ratio, dim=1)
        s = torch.clamp(s, 1, self.config.sample_max_value)[:, None]
        flat = torch.clamp(flat, -s, s) / s
        return flat.reshape(sample.shape).to(sample.dtype)

    def step(
        self,
        state: DDPMSchedulerState,
        model_output: torch.Tensor,
        timestep,
        sample: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        variance_noise: Optional[torch.Tensor] = None,
        return_dict: bool = True,
    ):
        """One reverse-diffusion step. Ancestral noise is `variance_noise`,
        else drawn from `generator` when one is given, else none."""
        t = int(timestep)
        idx = index_for_timestep(state.timesteps, t)

        if model_output.shape[1] == sample.shape[1] * 2 and self.config.variance_type in ("learned", "learned_range"):
            model_output, predicted_variance = torch.chunk(model_output, 2, dim=1)
        else:
            predicted_variance = None

        compute_dtype = torch.promote_types(sample.dtype, torch.float32)
        sample_f = sample.to(compute_dtype)
        model_output_f = model_output.to(compute_dtype)

        # predicted x_0 (formula (15)), multiplying by the precomputed 1/sqrt(a_t)
        if self.config.prediction_type == "epsilon":
            pred_original_sample = (
                sample_f - float(state.sqrt_beta_prod[idx]) * model_output_f
            ) * float(state.inv_sqrt_alpha_prod[idx])
        elif self.config.prediction_type == "sample":
            pred_original_sample = model_output_f
        elif self.config.prediction_type == "v_prediction":
            pred_original_sample = (
                float(state.sqrt_alpha_prod[idx]) * sample_f - float(state.sqrt_beta_prod[idx]) * model_output_f
            )
        else:
            raise ValueError(
                f"prediction_type {self.config.prediction_type} must be `epsilon`, `sample` or `v_prediction`"
            )

        if self.config.thresholding:
            pred_original_sample = self._threshold_sample(pred_original_sample)
        elif self.config.clip_sample:
            pred_original_sample = torch.clamp(
                pred_original_sample, -self.config.clip_sample_range, self.config.clip_sample_range
            )

        # posterior mean (formula (7))
        pred_prev_sample = float(state.x0_coeff[idx]) * pred_original_sample + float(state.xt_coeff[idx]) * sample_f

        if variance_noise is None and generator is not None:
            variance_noise = torch.randn(
                model_output.shape, generator=generator, dtype=torch.float32, device=generator.device,
            ).to(device=model_output.device, dtype=compute_dtype)
        if variance_noise is not None:
            if self.config.variance_type == "learned":
                sigma = predicted_variance.to(compute_dtype) ** 0.5 if t > 0 else 0.0
            elif self.config.variance_type == "learned_range":
                frac = (predicted_variance.to(compute_dtype) + 1) / 2
                log_var = frac * float(state.max_log_var[idx]) + (1 - frac) * float(state.min_log_var[idx])
                sigma = torch.exp(0.5 * log_var) if t > 0 else 0.0
            else:
                sigma = float(state.sigma[idx])
            pred_prev_sample = pred_prev_sample + sigma * variance_noise.to(compute_dtype)

        pred_prev_sample = pred_prev_sample.to(sample.dtype)
        pred_original_sample = pred_original_sample.to(sample.dtype)
        if not return_dict:
            return (pred_prev_sample, pred_original_sample)
        return DDPMSchedulerOutput(prev_sample=pred_prev_sample, pred_original_sample=pred_original_sample, state=state)

    def add_noise(self, state: DDPMSchedulerState, original_samples, noise, timesteps):
        sqrt_alpha_prod, sqrt_one_minus = sqrt_alpha_terms(state.alphas_cumprod, original_samples, timesteps)
        return sqrt_alpha_prod * original_samples + sqrt_one_minus * noise

    def get_velocity(self, state: DDPMSchedulerState, sample, noise, timesteps):
        sqrt_alpha_prod, sqrt_one_minus = sqrt_alpha_terms(state.alphas_cumprod, sample, timesteps)
        return sqrt_alpha_prod * noise - sqrt_one_minus * sample

    def __len__(self):
        return self.config.num_train_timesteps

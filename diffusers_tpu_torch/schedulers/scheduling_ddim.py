"""DDIM sampler (Song et al. 2020).

Port of `diffusers_tpu/schedulers/scheduling_ddim.py`: the "linspace",
"leading" and "trailing" spacings (`make_spaced_timesteps`), epsilon / sample
/ v prediction, clipping or dynamic thresholding of x_0, zero-terminal-SNR
betas and formulas (12) and (16) of https://huggingface.co/papers/2010.02502
with ``eta``. The scalar coefficients of a step are computed on the host in
float32, as JAX computes them; the sample arithmetic runs in float32 and is
cast back to the sample's dtype.

With ``eta > 0`` the step adds noise: `variance_noise` if given, else a
standard-normal draw from `generator` (a `torch.Generator`, JAX's key),
through `utils.torch_utils.randn_tensor`; one of them is required.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..configuration_utils import ConfigMixin, register_to_config
from ..utils import BaseOutput, torch_utils
from .scheduling_utils import (
    KarrasDiffusionSchedulers,
    SchedulerMixin,
    make_beta_schedule,
    make_spaced_timesteps,
    rescale_zero_terminal_snr,
    sqrt_alpha_terms,
)


@dataclass
class DDIMSchedulerState:
    timesteps: torch.Tensor  # int64 [S], host
    alphas_cumprod: np.ndarray  # float32 [T]
    final_alpha_cumprod: np.float32
    init_noise_sigma: float = 1.0
    num_inference_steps: Optional[int] = None


@dataclass
class DDIMSchedulerOutput(BaseOutput):
    prev_sample: torch.Tensor
    pred_original_sample: Optional[torch.Tensor] = None
    state: Optional[DDIMSchedulerState] = None


class DDIMScheduler(SchedulerMixin, ConfigMixin):
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
        clip_sample: bool = True,
        set_alpha_to_one: bool = True,
        steps_offset: int = 0,
        prediction_type: str = "epsilon",
        thresholding: bool = False,
        dynamic_thresholding_ratio: float = 0.995,
        clip_sample_range: float = 1.0,
        sample_max_value: float = 1.0,
        timestep_spacing: str = "leading",
        rescale_betas_zero_snr: bool = False,
    ):
        betas = make_beta_schedule(beta_schedule, num_train_timesteps, beta_start, beta_end, trained_betas)
        if rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)
        self.betas = betas
        self.alphas = 1.0 - betas
        self.alphas_cumprod = np.cumprod(self.alphas, axis=0)
        self.final_alpha_cumprod = np.float32(1.0) if set_alpha_to_one else self.alphas_cumprod[0]
        self.init_noise_sigma = 1.0

    def set_timesteps(self, num_inference_steps: int) -> DDIMSchedulerState:
        if num_inference_steps > self.config.num_train_timesteps:
            raise ValueError(f"num_inference_steps ({num_inference_steps}) > num_train_timesteps "
                             f"({self.config.num_train_timesteps})")
        ts = make_spaced_timesteps(num_inference_steps, self.config.num_train_timesteps,
                                   self.config.timestep_spacing, self.config.steps_offset)
        return DDIMSchedulerState(
            timesteps=torch.from_numpy(np.ascontiguousarray(ts, dtype=np.int64)),
            alphas_cumprod=self.alphas_cumprod.astype(np.float32),
            final_alpha_cumprod=np.float32(self.final_alpha_cumprod),
            num_inference_steps=num_inference_steps,
        )

    def scale_model_input(self, state: DDIMSchedulerState, sample: torch.Tensor, timestep=None) -> torch.Tensor:
        return sample

    def _threshold_sample(self, sample: torch.Tensor) -> torch.Tensor:
        flat = sample.float().reshape(sample.shape[0], -1)
        s = torch.quantile(flat.abs(), self.config.dynamic_thresholding_ratio, dim=1)
        s = s.clamp(1, self.config.sample_max_value)[:, None]
        return (torch.maximum(torch.minimum(flat, s), -s) / s).reshape(sample.shape).to(sample.dtype)

    def step(
        self,
        state: DDIMSchedulerState,
        model_output: torch.Tensor,
        timestep,
        sample: torch.Tensor,
        eta: float = 0.0,
        use_clipped_model_output: bool = False,
        generator: Optional[torch.Generator] = None,
        variance_noise: Optional[torch.Tensor] = None,
        return_dict: bool = True,
    ):
        if state.num_inference_steps is None:
            raise ValueError("run `set_timesteps` before `step`")
        t = int(timestep)
        prev_t = t - self.config.num_train_timesteps // state.num_inference_steps
        one = np.float32(1)
        alpha_prod_t = state.alphas_cumprod[t]
        alpha_prod_t_prev = state.alphas_cumprod[prev_t] if prev_t >= 0 else state.final_alpha_cumprod
        beta_prod_t = one - alpha_prod_t
        beta_prod_t_prev = one - alpha_prod_t_prev
        sqrt_a, sqrt_b = float(alpha_prod_t ** np.float32(0.5)), float(beta_prod_t ** np.float32(0.5))

        compute_dtype = torch.promote_types(sample.dtype, torch.float32)
        sample_f = sample.to(compute_dtype)
        model_output_f = model_output.to(compute_dtype)

        prediction = self.config.prediction_type
        if prediction == "epsilon":
            pred_original_sample = (sample_f - sqrt_b * model_output_f) / sqrt_a
            pred_epsilon = model_output_f
        elif prediction == "sample":
            pred_original_sample = model_output_f
            pred_epsilon = (sample_f - sqrt_a * pred_original_sample) / sqrt_b
        elif prediction == "v_prediction":
            pred_original_sample = sqrt_a * sample_f - sqrt_b * model_output_f
            pred_epsilon = sqrt_a * model_output_f + sqrt_b * sample_f
        else:
            raise ValueError(f"prediction_type {prediction} must be `epsilon`, `sample` or `v_prediction`")

        if self.config.thresholding:
            pred_original_sample = self._threshold_sample(pred_original_sample)
        elif self.config.clip_sample:
            pred_original_sample = pred_original_sample.clamp(-self.config.clip_sample_range,
                                                              self.config.clip_sample_range)

        if eta != 0.0:  # sigma_t, formula (16), clamped at 0 as JAX clamps it
            variance = (beta_prod_t_prev / beta_prod_t) * (one - alpha_prod_t / alpha_prod_t_prev)
            std_dev_t = np.float32(eta) * np.maximum(variance, np.float32(0)) ** np.float32(0.5)
        else:
            std_dev_t = np.float32(0)

        if use_clipped_model_output:
            pred_epsilon = (sample_f - sqrt_a * pred_original_sample) / sqrt_b

        # formula (12): the direction pointing to x_t, then x_{t-1}
        direction = float((one - alpha_prod_t_prev - std_dev_t**2) ** np.float32(0.5)) * pred_epsilon
        prev_sample = float(alpha_prod_t_prev ** np.float32(0.5)) * pred_original_sample + direction

        if eta > 0:
            if variance_noise is None and generator is not None:
                variance_noise = torch_utils.randn_tensor(model_output.shape, generator, model_output.device)
            if variance_noise is None:
                raise ValueError("eta > 0 requires `generator` or `variance_noise`")
            prev_sample = prev_sample + float(std_dev_t) * variance_noise.to(device=prev_sample.device,
                                                                              dtype=compute_dtype)

        prev_sample = prev_sample.to(sample.dtype)
        pred_original_sample = pred_original_sample.to(sample.dtype)
        if not return_dict:
            return (prev_sample, pred_original_sample)
        return DDIMSchedulerOutput(prev_sample=prev_sample, pred_original_sample=pred_original_sample, state=state)

    def add_noise(self, state: DDIMSchedulerState, original_samples: torch.Tensor, noise: torch.Tensor,
                  timesteps) -> torch.Tensor:
        sqrt_alpha, sqrt_one_minus = sqrt_alpha_terms(state.alphas_cumprod, original_samples, timesteps)
        return sqrt_alpha * original_samples + sqrt_one_minus * noise

    def get_velocity(self, state: DDIMSchedulerState, sample: torch.Tensor, noise: torch.Tensor,
                     timesteps) -> torch.Tensor:
        sqrt_alpha, sqrt_one_minus = sqrt_alpha_terms(state.alphas_cumprod, sample, timesteps)
        return sqrt_alpha * noise - sqrt_one_minus * sample

    def __len__(self):
        return self.config.num_train_timesteps

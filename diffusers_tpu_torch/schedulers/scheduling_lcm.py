"""Latent consistency model (LCM) sampler.

Port of `diffusers_tpu/schedulers/scheduling_lcm.py`: the LCM timestep
ladder (`original_inference_steps` evenly spaced training timesteps, of
which `num_inference_steps` are taken from the top), the consistency
boundary scalings ``c_skip`` / ``c_out`` at ``t * timestep_scaling``, and the
step: x_0 from the model output (epsilon, sample or v prediction), the
denoised sample ``c_out * x_0 + c_skip * sample``, then, on every step but
the last, the denoised sample noised to the next timestep. The scalar
coefficients are computed on the host in float32, as JAX computes them; the
sample arithmetic runs in float32 and is cast back to the model output's
dtype.

The noise is `variance_noise` if given, else a standard-normal draw from
`generator` (a `torch.Generator`, JAX's key) through
`utils.torch_utils.randn_tensor`; with neither, zeros, as JAX's step without
a key. The last step takes none. JAX draws inside the step from a key folded
with the step index, so the port's draws are not JAX's numbers (ROADMAP C3);
given the same noise tensor the two steps agree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..configuration_utils import ConfigMixin, register_to_config
from ..utils import BaseOutput, torch_utils
from .scheduling_utils import (
    SchedulerMixin,
    index_for_timestep,
    make_beta_schedule,
    rescale_zero_terminal_snr,
    sqrt_alpha_terms,
)


@dataclass
class LCMSchedulerState:
    timesteps: torch.Tensor  # int64 [S], host
    alphas_cumprod: np.ndarray  # float32 [T]
    final_alpha_cumprod: np.float32
    init_noise_sigma: float = 1.0
    num_inference_steps: Optional[int] = None


@dataclass
class LCMSchedulerOutput(BaseOutput):
    prev_sample: torch.Tensor
    denoised: Optional[torch.Tensor] = None
    state: Optional[LCMSchedulerState] = None


def lcm_timesteps(num_train_timesteps: int, original_steps: int, num_inference_steps: Optional[int],
                  timesteps: Optional[List[int]], strength: float, check: bool) -> np.ndarray:
    """The LCM ladder (JAX `set_timesteps` of LCM and TCD): `timesteps` as
    given, or `num_inference_steps` of the ``original_steps`` evenly spaced
    training timesteps, from the top. `check`: LCM refuses more steps than
    ``original_steps``; TCD does not."""
    if timesteps is not None:
        return np.array(timesteps, dtype=np.int64)
    k = num_train_timesteps // original_steps
    origin = (np.asarray(list(range(1, int(original_steps * strength) + 1))) * k - 1)[::-1].copy()
    if check and num_inference_steps > original_steps:
        raise ValueError(f"num_inference_steps ({num_inference_steps}) > original_inference_steps ({original_steps})")
    index = np.floor(np.linspace(0, len(origin), num=num_inference_steps, endpoint=False)).astype(np.int64)
    return origin[index].astype(np.int64)


def x0_and_eps(prediction_type: str, sample_f: torch.Tensor, model_output_f: torch.Tensor, alpha_prod_t, beta_prod_t):
    """(x_0, epsilon) from a model output and the sample (float32 scalars
    ``alpha_prod_t``, ``beta_prod_t``), as JAX's LCM / TCD steps take them."""
    sqrt_a, sqrt_b = float(alpha_prod_t ** np.float32(0.5)), float(beta_prod_t ** np.float32(0.5))
    if prediction_type == "epsilon":
        return (sample_f - sqrt_b * model_output_f) / sqrt_a, model_output_f
    if prediction_type == "sample":
        return model_output_f, (sample_f - sqrt_a * model_output_f) / sqrt_b
    if prediction_type == "v_prediction":
        return sqrt_a * sample_f - sqrt_b * model_output_f, sqrt_a * model_output_f + sqrt_b * sample_f
    raise ValueError(f"unsupported prediction_type {prediction_type}")


class LCMScheduler(SchedulerMixin, ConfigMixin):
    order = 1

    @register_to_config
    def __init__(
        self,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        beta_schedule: str = "scaled_linear",
        trained_betas: Optional[List[float]] = None,
        original_inference_steps: int = 50,
        clip_sample: bool = False,
        clip_sample_range: float = 1.0,
        set_alpha_to_one: bool = True,
        steps_offset: int = 0,
        prediction_type: str = "epsilon",
        thresholding: bool = False,
        dynamic_thresholding_ratio: float = 0.995,
        sample_max_value: float = 1.0,
        timestep_spacing: str = "leading",
        timestep_scaling: float = 10.0,
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
        self.sigma_data = 0.5

    def set_timesteps(self, num_inference_steps: Optional[int] = None, original_inference_steps: Optional[int] = None,
                      timesteps: Optional[List[int]] = None, strength: float = 1.0) -> LCMSchedulerState:
        ts = lcm_timesteps(self.config.num_train_timesteps,
                           original_inference_steps or self.config.original_inference_steps, num_inference_steps,
                           timesteps, strength, check=True)
        return LCMSchedulerState(
            timesteps=torch.from_numpy(ts),
            alphas_cumprod=self.alphas_cumprod.astype(np.float32),
            final_alpha_cumprod=np.float32(self.final_alpha_cumprod),
            num_inference_steps=len(ts),
        )

    def scale_model_input(self, state: LCMSchedulerState, sample: torch.Tensor, timestep=None) -> torch.Tensor:
        return sample

    def get_scalings_for_boundary_condition_discrete(self, timestep):
        """(c_skip, c_out) at a timestep, in float32."""
        sigma2 = np.float32(self.sigma_data**2)
        scaled = np.float32(timestep) * np.float32(self.config.timestep_scaling)
        return sigma2 / (scaled * scaled + sigma2), scaled / (scaled * scaled + sigma2) ** np.float32(0.5)

    @staticmethod
    def last_step(state, timestep) -> bool:
        """Whether `timestep` is the schedule's last (which takes no noise)."""
        return index_for_timestep(state.timesteps, timestep) == len(state.timesteps) - 1

    def step(
        self,
        state: LCMSchedulerState,
        model_output: torch.Tensor,
        timestep,
        sample: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        variance_noise: Optional[torch.Tensor] = None,
        return_dict: bool = True,
    ):
        t = int(timestep)
        idx = index_for_timestep(state.timesteps, t)
        steps = len(state.timesteps)
        prev_t = int(state.timesteps[idx + 1]) if idx + 1 < steps else t
        one = np.float32(1)
        alpha_prod_t = state.alphas_cumprod[t]
        alpha_prod_t_prev = state.alphas_cumprod[prev_t] if prev_t >= 0 else state.final_alpha_cumprod
        c_skip, c_out = self.get_scalings_for_boundary_condition_discrete(t)

        sample_f, model_output_f = sample.float(), model_output.float()
        pred_x0, _ = x0_and_eps(self.config.prediction_type, sample_f, model_output_f, alpha_prod_t,
                                one - alpha_prod_t)
        if self.config.clip_sample:
            pred_x0 = pred_x0.clamp(-self.config.clip_sample_range, self.config.clip_sample_range)
        denoised = float(c_out) * pred_x0 + float(c_skip) * sample_f

        if idx != steps - 1:
            if variance_noise is None and generator is not None:
                variance_noise = torch_utils.randn_tensor(model_output.shape, generator, model_output.device)
            noise = (variance_noise.to(device=denoised.device, dtype=torch.float32) if variance_noise is not None
                     else torch.zeros_like(denoised))
            prev_sample = (float(alpha_prod_t_prev ** np.float32(0.5)) * denoised
                           + float((one - alpha_prod_t_prev) ** np.float32(0.5)) * noise)
        else:
            prev_sample = denoised

        prev_sample, denoised = prev_sample.to(model_output.dtype), denoised.to(model_output.dtype)
        if not return_dict:
            return (prev_sample, denoised)
        return LCMSchedulerOutput(prev_sample=prev_sample, denoised=denoised, state=state)

    def add_noise(self, state: LCMSchedulerState, original_samples: torch.Tensor, noise: torch.Tensor,
                  timesteps) -> torch.Tensor:
        sqrt_alpha, sqrt_one_minus = sqrt_alpha_terms(state.alphas_cumprod, original_samples, timesteps)
        return sqrt_alpha * original_samples + sqrt_one_minus * noise

    def __len__(self):
        return self.config.num_train_timesteps

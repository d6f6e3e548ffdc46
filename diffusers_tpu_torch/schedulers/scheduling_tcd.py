"""Trajectory consistency distillation (TCD) sampler.

Port of `diffusers_tpu/schedulers/scheduling_tcd.py`: the LCM ladder
(`scheduling_lcm.lcm_timesteps`), and strategic stochastic sampling with
``eta`` (TCD's gamma): x_0 and epsilon from the model output, the sample
carried to ``s = floor((1 - eta) * prev_t)``, then, with ``eta > 0`` and on
every step but the last, noised forward to ``prev_t``. ``eta = 0`` is
deterministic. The scalar coefficients are computed on the host in float32,
as JAX computes them; the sample arithmetic runs in float32 and is cast back
to the model output's dtype.

The noise is `variance_noise` if given, else a standard-normal draw from
`generator` through `utils.torch_utils.randn_tensor`; ``eta > 0`` on a step
that takes noise with neither raises, as JAX's step without a key. JAX draws
inside the step from a key folded with the step index, so the port's draws
are not JAX's numbers (ROADMAP C3); given the same noise tensor the two steps
agree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..configuration_utils import ConfigMixin, register_to_config
from ..utils import BaseOutput, torch_utils
from .scheduling_lcm import LCMSchedulerState, lcm_timesteps, x0_and_eps
from .scheduling_utils import (
    SchedulerMixin,
    index_for_timestep,
    make_beta_schedule,
    rescale_zero_terminal_snr,
    sqrt_alpha_terms,
)

TCDSchedulerState = LCMSchedulerState


@dataclass
class TCDSchedulerOutput(BaseOutput):
    prev_sample: torch.Tensor
    pred_noised_sample: Optional[torch.Tensor] = None
    state: Optional[TCDSchedulerState] = None


class TCDScheduler(SchedulerMixin, ConfigMixin):
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

    def set_timesteps(self, num_inference_steps: Optional[int] = None, original_inference_steps: Optional[int] = None,
                      timesteps: Optional[List[int]] = None, strength: float = 1.0) -> TCDSchedulerState:
        ts = lcm_timesteps(self.config.num_train_timesteps,
                           original_inference_steps or self.config.original_inference_steps, num_inference_steps,
                           timesteps, strength, check=False)
        return TCDSchedulerState(
            timesteps=torch.from_numpy(ts),
            alphas_cumprod=self.alphas_cumprod.astype(np.float32),
            final_alpha_cumprod=np.float32(self.final_alpha_cumprod),
            num_inference_steps=len(ts),
        )

    def scale_model_input(self, state: TCDSchedulerState, sample: torch.Tensor, timestep=None) -> torch.Tensor:
        return sample

    @staticmethod
    def takes_noise(state, timestep, eta: float) -> bool:
        """Whether the step at `timestep` adds noise: ``eta > 0``, not the last."""
        return eta > 0 and index_for_timestep(state.timesteps, timestep) != len(state.timesteps) - 1

    def step(
        self,
        state: TCDSchedulerState,
        model_output: torch.Tensor,
        timestep,
        sample: torch.Tensor,
        eta: float = 0.3,
        generator: Optional[torch.Generator] = None,
        variance_noise: Optional[torch.Tensor] = None,
        return_dict: bool = True,
    ):
        if not 0 <= eta <= 1.0:
            raise ValueError(f"eta (TCD's gamma) must lie in [0, 1], got {eta}")
        t = int(timestep)
        idx = index_for_timestep(state.timesteps, t)
        steps = len(state.timesteps)
        prev_t = int(state.timesteps[idx + 1]) if idx + 1 < steps else 0
        timestep_s = int(np.floor(np.float32(1 - eta) * np.float32(prev_t)))
        one = np.float32(1)
        acp = state.alphas_cumprod
        alpha_prod_t = acp[t]
        alpha_prod_t_prev = acp[prev_t] if prev_t >= 0 else state.final_alpha_cumprod
        alpha_prod_s = acp[timestep_s]

        pred_x0, pred_eps = x0_and_eps(self.config.prediction_type, sample.float(), model_output.float(),
                                       alpha_prod_t, one - alpha_prod_t)
        pred_noised = (float(alpha_prod_s ** np.float32(0.5)) * pred_x0
                       + float((one - alpha_prod_s) ** np.float32(0.5)) * pred_eps)

        if self.takes_noise(state, t, eta):
            if variance_noise is None and generator is not None:
                variance_noise = torch_utils.randn_tensor(model_output.shape, generator, model_output.device)
            if variance_noise is None:
                raise ValueError("TCD with eta > 0 requires `generator` or `variance_noise`")
            ratio = alpha_prod_t_prev / alpha_prod_s
            prev_sample = (float(ratio ** np.float32(0.5)) * pred_noised
                           + float((one - ratio) ** np.float32(0.5))
                           * variance_noise.to(device=pred_noised.device, dtype=torch.float32))
        else:
            prev_sample = pred_noised

        prev_sample, pred_noised = prev_sample.to(model_output.dtype), pred_noised.to(model_output.dtype)
        if not return_dict:
            return (prev_sample, pred_noised)
        return TCDSchedulerOutput(prev_sample=prev_sample, pred_noised_sample=pred_noised, state=state)

    def add_noise(self, state: TCDSchedulerState, original_samples: torch.Tensor, noise: torch.Tensor,
                  timesteps) -> torch.Tensor:
        sqrt_alpha, sqrt_one_minus = sqrt_alpha_terms(state.alphas_cumprod, original_samples, timesteps)
        return sqrt_alpha * original_samples + sqrt_one_minus * noise

    def __len__(self):
        return self.config.num_train_timesteps

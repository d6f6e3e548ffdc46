"""PNDM sampler, the PLMS path (Stable Diffusion 1.5's published scheduler).

Port of `diffusers_tpu/schedulers/scheduling_pndm.py`: the timesteps of the
``skip_prk_steps=True`` schedule (the second-to-last timestep repeated once,
`:87-103`), the linear multistep combination of up to four past outputs
(`:156-209`) and formula (9) of https://huggingface.co/papers/2202.09778
(`_get_prev_sample`, `:130-146`). As in JAX, the Runge-Kutta warm-up that
``skip_prk_steps=False`` selects raises: every shipped Stable Diffusion
config skips it.

JAX carries the history (a [4, *shape] buffer, its fill count, the step
counter and the buffered sample) in a state that each step returns anew and
selects the step's order with `jnp.where`. The port's eager loops pass the
one state that `set_timesteps` made to every step, so the history lives on
that state and `step` updates it in place (as UniPC's does); the order is
picked on the host and only that combination is computed. The scalar
coefficients are computed on the host in float32, as JAX computes them; the
sample arithmetic runs in float32 and `prev_sample` is cast back to the model
output's dtype.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..configuration_utils import ConfigMixin, register_to_config
from ..utils import BaseOutput
from .scheduling_utils import KarrasDiffusionSchedulers, SchedulerMixin, make_beta_schedule, sqrt_alpha_terms


@dataclass
class PNDMSchedulerState:
    timesteps: torch.Tensor  # int64 [S], host
    alphas_cumprod: np.ndarray  # float32 [T]
    final_alpha_cumprod: np.float32
    num_inference_steps: int
    init_noise_sigma: float = 1.0
    counter: int = 0
    ets: List[torch.Tensor] = field(default_factory=list)  # past model outputs, float32, newest last (at most 4)
    cur_sample: Optional[torch.Tensor] = None  # the sample of the first step, float32


@dataclass
class PNDMSchedulerOutput(BaseOutput):
    prev_sample: torch.Tensor
    state: Optional[PNDMSchedulerState] = None


class PNDMScheduler(SchedulerMixin, ConfigMixin):
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
        skip_prk_steps: bool = False,
        set_alpha_to_one: bool = False,
        prediction_type: str = "epsilon",
        timestep_spacing: str = "leading",
        steps_offset: int = 0,
    ):
        betas = make_beta_schedule(beta_schedule, num_train_timesteps, beta_start, beta_end, trained_betas)
        self.betas = betas
        self.alphas = 1.0 - betas
        self.alphas_cumprod = np.cumprod(self.alphas, axis=0)
        self.final_alpha_cumprod = np.float32(1.0) if set_alpha_to_one else self.alphas_cumprod[0]
        self.init_noise_sigma = 1.0
        self.pndm_order = 4

    def set_timesteps(self, num_inference_steps: int) -> PNDMSchedulerState:
        if not self.config.skip_prk_steps:
            raise NotImplementedError(
                "PRK warm-up steps are not implemented (every shipped SD config sets skip_prk_steps=True)."
            )
        n_train = self.config.num_train_timesteps
        if self.config.timestep_spacing == "linspace":
            ts = np.linspace(0, n_train - 1, num_inference_steps).round().astype(np.int64)
        elif self.config.timestep_spacing == "leading":
            step_ratio = n_train // num_inference_steps
            ts = (np.arange(0, num_inference_steps) * step_ratio).round().astype(np.int64)
            ts += self.config.steps_offset
        elif self.config.timestep_spacing == "trailing":
            step_ratio = n_train / num_inference_steps
            ts = np.round(np.arange(n_train, 0, -step_ratio))[::-1].astype(np.int64)
            ts -= 1
        else:
            raise ValueError(f"unsupported timestep_spacing {self.config.timestep_spacing}")
        # skip_prk_steps=True: the second-to-last timestep once more
        plms = np.concatenate([ts[:-1], ts[-2:-1], ts[-1:]])[::-1].copy()
        return PNDMSchedulerState(
            timesteps=torch.from_numpy(plms),
            alphas_cumprod=self.alphas_cumprod.astype(np.float32),
            final_alpha_cumprod=np.float32(self.final_alpha_cumprod),
            num_inference_steps=num_inference_steps,
        )

    def scale_model_input(self, state: PNDMSchedulerState, sample: torch.Tensor, timestep=None) -> torch.Tensor:
        return sample

    def _get_prev_sample(self, state: PNDMSchedulerState, sample: torch.Tensor, timestep: int, prev_timestep: int,
                         model_output: torch.Tensor) -> torch.Tensor:
        alpha_prod_t = state.alphas_cumprod[timestep]
        alpha_prod_t_prev = state.alphas_cumprod[prev_timestep] if prev_timestep >= 0 else state.final_alpha_cumprod
        beta_prod_t = np.float32(1) - alpha_prod_t
        beta_prod_t_prev = np.float32(1) - alpha_prod_t_prev

        if self.config.prediction_type == "v_prediction":
            model_output = float(alpha_prod_t**0.5) * model_output + float(beta_prod_t**0.5) * sample
        elif self.config.prediction_type != "epsilon":
            raise ValueError(f"prediction_type must be epsilon or v_prediction, got {self.config.prediction_type}")

        sample_coeff = (alpha_prod_t_prev / alpha_prod_t) ** np.float32(0.5)
        denom = alpha_prod_t * beta_prod_t_prev ** np.float32(0.5) + (
            alpha_prod_t * beta_prod_t * alpha_prod_t_prev) ** np.float32(0.5)
        return float(sample_coeff) * sample - float(alpha_prod_t_prev - alpha_prod_t) * model_output / float(denom)

    def step(
        self,
        state: PNDMSchedulerState,
        model_output: torch.Tensor,
        timestep,
        sample: torch.Tensor,
        return_dict: bool = True,
    ):
        """One PLMS step. Updates `state`'s history in place."""
        t = int(timestep)
        step_ratio = self.config.num_train_timesteps // state.num_inference_steps
        counter = state.counter
        model_output_f = model_output.float()
        sample_f = sample.float()

        # at counter 1 the step repeats the pair (t + ratio, t) on the buffered first sample
        t_eff, prev_t = (t + step_ratio, t) if counter == 1 else (t, t - step_ratio)
        if counter != 1:
            state.ets = (state.ets + [model_output_f])[-4:]
        e = state.ets[::-1]  # newest first
        n = len(e)
        if n == 1:
            combined = model_output_f if counter == 0 else (model_output_f + e[0]) / 2
        elif n == 2:
            combined = (3 * e[0] - e[1]) / 2
        elif n == 3:
            combined = (23 * e[0] - 16 * e[1] + 5 * e[2]) / 12
        else:
            combined = (55 * e[0] - 59 * e[1] + 37 * e[2] - 9 * e[3]) / 24

        if counter == 0:
            state.cur_sample = sample_f
        sample_used = state.cur_sample if counter == 1 else sample_f
        prev_sample = self._get_prev_sample(state, sample_used, t_eff, prev_t, combined).to(model_output.dtype)
        state.counter = counter + 1
        if not return_dict:
            return (prev_sample, state)
        return PNDMSchedulerOutput(prev_sample=prev_sample, state=state)

    def add_noise(self, state: PNDMSchedulerState, original_samples: torch.Tensor, noise: torch.Tensor,
                  timesteps) -> torch.Tensor:
        sqrt_alpha, sqrt_one_minus = sqrt_alpha_terms(state.alphas_cumprod, original_samples, timesteps)
        return sqrt_alpha * original_samples + sqrt_one_minus * noise

    def __len__(self):
        return self.config.num_train_timesteps

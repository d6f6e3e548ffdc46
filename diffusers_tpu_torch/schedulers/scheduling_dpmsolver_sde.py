"""DPM-Solver SDE sampler (k-diffusion's ancestral midpoint step).

Port of `diffusers_tpu/schedulers/scheduling_dpmsolver_sde.py`. Every
timestep but the first appears twice: an even step index takes the ancestral
step to the midpoint in log sigma and keeps its sample; an odd one takes the
ancestral step of the whole interval from that sample, with the output at the
midpoint. A step whose next sigma is 0 is a plain Euler step. Upstream draws
correlated noise from torchsde's Brownian tree; JAX, and so the port, draws
an independent standard normal a step: `variance_noise`, or a draw from
`generator`. With neither the step raises, as JAX's does without a PRNG key
(JAX's pipelines pass none). Ladders in numpy on the host exactly as in JAX;
the step index and the kept sample live on the state and `step` updates them
in place.
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
    k_pred_original,
    k_spaced_timesteps,
    make_beta_schedule,
    step_noise,
)
from .sigma_utils import convert_to_beta, convert_to_exponential, convert_to_karras, sigma_to_t


@dataclass
class DPMSolverSDESchedulerState:
    timesteps: torch.Tensor  # float32 [2S-1], host
    sigmas: torch.Tensor  # float32 [2S], host
    init_noise_sigma: float = 1.0
    num_inference_steps: Optional[int] = None
    step_index: int = 0
    buffered_sample: Optional[torch.Tensor] = None  # the first-order step's sample, float32


@dataclass
class DPMSolverSDESchedulerOutput(BaseOutput):
    prev_sample: torch.Tensor
    state: Optional[DPMSolverSDESchedulerState] = None


class DPMSolverSDEScheduler(SchedulerMixin, ConfigMixin):
    _compatibles = [e.name for e in KarrasDiffusionSchedulers]
    order = 2

    @register_to_config
    def __init__(
        self,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        beta_schedule: str = "linear",
        trained_betas: Optional[List[float]] = None,
        prediction_type: str = "epsilon",
        use_karras_sigmas: bool = False,
        use_exponential_sigmas: bool = False,
        use_beta_sigmas: bool = False,
        noise_sampler_seed: Optional[int] = None,
        timestep_spacing: str = "linspace",
        steps_offset: int = 0,
    ):
        betas = make_beta_schedule(beta_schedule, num_train_timesteps, beta_start, beta_end, trained_betas)
        self.alphas_cumprod = np.cumprod(1.0 - betas, axis=0)

    def set_timesteps(self, num_inference_steps: int) -> DPMSolverSDESchedulerState:
        cfg = self.config
        if cfg.timestep_spacing == "linspace":  # float64 here, as in JAX
            ts = np.linspace(0, cfg.num_train_timesteps - 1, num_inference_steps, dtype=float)[::-1].copy()
        else:  # whole numbers: float32 holds them exactly
            ts = k_spaced_timesteps(cfg.timestep_spacing, num_inference_steps, cfg.num_train_timesteps,
                                    cfg.steps_offset).astype(float)
        sigmas_full = np.array(((1 - self.alphas_cumprod) / self.alphas_cumprod) ** 0.5)
        log_sigmas = np.log(sigmas_full)
        sigmas = np.interp(ts, np.arange(0, len(sigmas_full)), sigmas_full)
        ladder = (convert_to_karras if cfg.use_karras_sigmas else convert_to_exponential
                  if cfg.use_exponential_sigmas else convert_to_beta if cfg.use_beta_sigmas else None)
        if ladder is not None:
            sigmas = ladder(sigmas, num_inference_steps)
            ts = np.array([sigma_to_t(s, log_sigmas) for s in sigmas])

        # the midpoints in -log sigma: the timesteps of the second evaluations
        t_ladder = -np.log(sigmas)
        t_proposed = t_ladder[:-1] + np.diff(t_ladder) * 0.5
        second_order_ts = np.array([sigma_to_t(s, log_sigmas) for s in np.exp(-t_proposed)])

        sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
        sigmas_i = np.concatenate([sigmas[:1], np.repeat(sigmas[1:-1], 2), sigmas[-1:]])
        ts_i = np.concatenate([ts[:1], np.repeat(ts[1:], 2)])
        ts_i[1::2] = second_order_ts
        return DPMSolverSDESchedulerState(
            timesteps=torch.from_numpy(ts_i.astype(np.float32)), sigmas=torch.from_numpy(sigmas_i.astype(np.float32)),
            init_noise_sigma=k_init_noise_sigma(sigmas, cfg.timestep_spacing),
            num_inference_steps=num_inference_steps)

    def prepare(self, state, sample):
        """JAX allocates its buffer here; the port's is set by `step`."""
        return state

    def scale_model_input(self, state, sample: torch.Tensor, timestep) -> torch.Tensor:
        sigma = state.sigmas[index_for_timestep(state.timesteps, timestep)]
        return sample / float((sigma**2 + 1) ** 0.5)

    def step(self, state: DPMSolverSDESchedulerState, model_output: torch.Tensor, timestep, sample: torch.Tensor,
             generator: Optional[torch.Generator] = None, variance_noise: Optional[torch.Tensor] = None,
             s_noise: float = 1.0, return_dict: bool = True):
        """One step at `state.step_index`; updates `state` in place. The
        result has the sample's dtype, as JAX's."""
        idx = state.step_index
        first = idx % 2 == 0
        sample_f = sample.float()
        sigma = state.sigmas[idx] if first else state.sigmas[idx - 1]
        sigma_next = state.sigmas[idx + 1] if first else state.sigmas[idx]
        t = -torch.log(torch.clamp_min(sigma, 1e-20))
        t_next_full = -torch.log(torch.clamp_min(sigma_next, 1e-20))
        t_proposed = t + (t_next_full - t) * 0.5
        pred_x0 = k_pred_original(self.config.prediction_type, model_output.float(), sample_f,
                                  sigma if first else torch.exp(-t_proposed), allow_sample=False)
        noise = step_noise(variance_noise, generator, sample_f, "DPMSolverSDE")
        if sigma_next == 0:  # the final deterministic Euler step
            derivative = (sample_f - pred_x0) / float(torch.clamp_min(sigma, 1e-20))
            prev_sample = sample_f + derivative * float(sigma_next - sigma)
        else:
            t_next = t_proposed if first else t_next_full
            base = sample_f if first else state.buffered_sample
            sigma_from, sigma_to = torch.exp(-t), torch.exp(-t_next)
            sigma_up = torch.minimum(sigma_to, torch.sqrt(torch.clamp_min(
                sigma_to**2 * (sigma_from**2 - sigma_to**2) / sigma_from**2, 0.0)))
            sigma_down = torch.sqrt(torch.clamp_min(sigma_to**2 - sigma_up**2, 0.0))
            ancestral_t = -torch.log(torch.clamp_min(sigma_down, 1e-20))
            prev_sample = (float(torch.exp(-ancestral_t) / torch.exp(-t)) * base
                           - float(torch.expm1(t - ancestral_t)) * pred_x0)
            prev_sample = prev_sample + noise * s_noise * float(sigma_up)
        if first:
            state.buffered_sample = sample_f
        state.step_index = idx + 1
        prev_sample = prev_sample.to(sample.dtype)
        if not return_dict:
            return (prev_sample, state)
        return DPMSolverSDESchedulerOutput(prev_sample=prev_sample, state=state)

    add_noise = staticmethod(add_sigma_noise)

    def __len__(self):
        return self.config.num_train_timesteps

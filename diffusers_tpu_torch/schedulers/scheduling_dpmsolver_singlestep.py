"""DPM-Solver++ singlestep sampler (orders 1-2).

Port of `diffusers_tpu/schedulers/scheduling_dpmsolver_singlestep.py`: a
fixed per-step order list made at `set_timesteps`; a first-order step keeps
its sample, and the second-order step that follows integrates the two-step
interval from that sample. Scalars on the host in float32, samples in torch
in float32 on their device; the converted outputs, the kept sample and the
step index live on the state and `step` updates them in place. A step whose
listed order is 2 but whose state holds no first-order sample yet (a loop
that starts at a later step index) runs at first order, as upstream's does.
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
    add_vp_noise,
    log_snr,
    make_beta_schedule,
    threshold_sample,
    vp_alpha_sigma,
)
from .sigma_utils import convert_to_karras, sigma_to_t


@dataclass
class DPMSolverSinglestepSchedulerState:
    timesteps: torch.Tensor  # int64 [S], host
    sigmas: torch.Tensor  # float32 [S+1], host
    order_list: List[int]
    num_inference_steps: int
    init_noise_sigma: float = 1.0
    step_index: int = 0
    model_outputs: List[torch.Tensor] = field(default_factory=list)  # x0 predictions, newest last
    buffered_sample: Optional[torch.Tensor] = None  # the last first-order step's sample, float32


@dataclass
class DPMSolverSinglestepSchedulerOutput(BaseOutput):
    prev_sample: torch.Tensor
    state: Optional[DPMSolverSinglestepSchedulerState] = None


class DPMSolverSinglestepScheduler(SchedulerMixin, ConfigMixin):
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
        algorithm_type: str = "dpmsolver++",
        solver_type: str = "midpoint",
        lower_order_final: bool = False,
        use_karras_sigmas: bool = False,
        final_sigmas_type: str = "zero",
        lambda_min_clipped: float = -float("inf"),
        variance_type: Optional[str] = None,
    ):
        if algorithm_type not in ("dpmsolver++",):
            raise NotImplementedError("only dpmsolver++ singlestep is implemented")
        if solver_order > 2:
            raise NotImplementedError("solver_order > 2 not implemented")
        betas = make_beta_schedule(beta_schedule, num_train_timesteps, beta_start, beta_end, trained_betas)
        self.betas = betas
        self.alphas = 1.0 - betas
        self.alphas_cumprod = np.cumprod(self.alphas, axis=0)
        self.lambda_t = np.log(np.sqrt(self.alphas_cumprod)) - np.log(np.sqrt(1 - self.alphas_cumprod))
        self.init_noise_sigma = 1.0

    def get_order_list(self, steps: int) -> List[int]:
        """Each step's order; a zero final sigma forces `lower_order_final`."""
        order = self.config.solver_order
        if self.config.lower_order_final or self.config.final_sigmas_type == "zero":
            if order == 2:
                return [1, 2] * (steps // 2 - 1) + [1, 1] if steps % 2 == 0 else [1, 2] * (steps // 2) + [1]
            return [1] * steps
        return [1, 2] * (steps // 2) + ([1] if steps % 2 == 1 else []) if order == 2 else [1] * steps

    def set_timesteps(self, num_inference_steps: int) -> DPMSolverSinglestepSchedulerState:
        cfg = self.config
        clipped_idx = int(np.searchsorted(np.flip(self.lambda_t), cfg.lambda_min_clipped))
        T = cfg.num_train_timesteps - clipped_idx
        ts = np.linspace(0, T - 1, num_inference_steps + 1).round()[::-1][:-1].copy().astype(np.int64)
        sigmas_full = np.array(((1 - self.alphas_cumprod) / self.alphas_cumprod) ** 0.5)
        if cfg.use_karras_sigmas:
            sigmas = convert_to_karras(np.flip(sigmas_full).copy(), num_inference_steps)
            ts = np.array([sigma_to_t(s, np.log(sigmas_full)) for s in sigmas]).round().astype(np.int64)
        else:
            sigmas = np.interp(ts, np.arange(0, len(sigmas_full)), sigmas_full)
        sigma_last = float(sigmas_full[0]) if cfg.final_sigmas_type == "sigma_min" else 0.0
        sigmas = np.concatenate([sigmas, [sigma_last]]).astype(np.float32)
        return DPMSolverSinglestepSchedulerState(
            timesteps=torch.from_numpy(ts), sigmas=torch.from_numpy(sigmas),
            order_list=self.get_order_list(num_inference_steps), num_inference_steps=num_inference_steps)

    def prepare(self, state, sample):
        """JAX allocates its buffers here; the port's are set by `step`."""
        return state

    def scale_model_input(self, state, sample: torch.Tensor, timestep=None) -> torch.Tensor:
        return sample

    def convert_model_output(self, state, model_output: torch.Tensor, sample: torch.Tensor, idx: int):
        cfg = self.config
        alpha_t, sigma_t = (float(v) for v in vp_alpha_sigma(state.sigmas[idx]))
        if cfg.prediction_type == "epsilon":
            if cfg.variance_type in ("learned", "learned_range"):
                model_output = model_output[:, :3]
            x0 = (sample - sigma_t * model_output) / alpha_t
        elif cfg.prediction_type == "sample":
            x0 = model_output
        elif cfg.prediction_type == "v_prediction":
            x0 = alpha_t * sample - sigma_t * model_output
        else:
            raise ValueError(f"unsupported prediction_type {cfg.prediction_type}")
        if cfg.thresholding:
            x0 = threshold_sample(x0, cfg.dynamic_thresholding_ratio, cfg.sample_max_value)
        return x0

    def _lambda(self, sigma):
        alpha_t, sigma_t = vp_alpha_sigma(sigma)
        return log_snr(alpha_t, sigma_t), alpha_t, sigma_t

    def step(self, state: DPMSolverSinglestepSchedulerState, model_output: torch.Tensor, timestep,
             sample: torch.Tensor, return_dict: bool = True):
        """One step at `state.step_index`; updates `state` in place."""
        idx = state.step_index
        sample_f = sample.float()
        converted = self.convert_model_output(state, model_output.float(), sample_f, idx)
        state.model_outputs = (state.model_outputs + [converted])[-2:]
        order = state.order_list[idx]
        if order == 2 and (state.buffered_sample is None or len(state.model_outputs) < 2):
            order = 1
        lambda_t, alpha_t, sigma_t = self._lambda(state.sigmas[idx + 1])
        if order == 1:
            state.buffered_sample = sample_f
            lambda_s0, _, sigma_s0 = self._lambda(state.sigmas[idx])
            h = lambda_t - lambda_s0
            prev_sample = float(sigma_t / sigma_s0) * sample_f - float(alpha_t * (torch.exp(-h) - 1.0)) * converted
        else:  # the interval [s1 -> t] from the kept sample
            lambda_s0 = self._lambda(state.sigmas[idx])[0]
            lambda_s1, _, sigma_s1 = self._lambda(state.sigmas[idx - 1])
            m0, m1 = state.model_outputs[-1], state.model_outputs[-2]
            h, h_0 = lambda_t - lambda_s1, lambda_s0 - lambda_s1
            d1 = (m0 - m1) / float(h_0 / h)
            prev_sample = (float(sigma_t / sigma_s1) * state.buffered_sample
                           - float(alpha_t * (torch.exp(-h) - 1.0)) * m1)
            if self.config.solver_type == "midpoint":
                prev_sample = prev_sample - float(0.5 * (alpha_t * (torch.exp(-h) - 1.0))) * d1
            else:
                prev_sample = prev_sample + float(alpha_t * ((torch.exp(-h) - 1.0) / h + 1.0)) * d1
        state.step_index = idx + 1
        prev_sample = prev_sample.to(model_output.dtype)
        if not return_dict:
            return (prev_sample, state)
        return DPMSolverSinglestepSchedulerOutput(prev_sample=prev_sample, state=state)

    def add_noise(self, state, original_samples: torch.Tensor, noise: torch.Tensor, timesteps) -> torch.Tensor:
        return add_vp_noise(state, original_samples, noise, timesteps)

    def __len__(self):
        return self.config.num_train_timesteps

"""SA-Solver (stochastic Adams predictor-corrector, orders 1-2).

Port of `diffusers_tpu/schedulers/scheduling_sasolver.py`: the stochastic
Adams-Bashforth predictor and Adams-Moulton corrector over x0 predictions,
with the closed-form exponential integrals of the Lagrange basis and the
step-function stochasticity tau(t) (1 for 200 <= t <= 800 by default, or
`tau_func`, which receives a float32 host scalar). Each step first corrects
the previous step's sample with the new output (from the second step on),
then predicts the next. Scalars on the host in float32; samples in torch in
float32; the history (outputs, timesteps, the last sample and noise) and the
warm-up count live on the state and `step` updates them in place. Each step
takes `variance_noise` or draws from `generator`, and raises with neither,
as JAX's does without a PRNG key.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..configuration_utils import ConfigMixin, register_to_config
from ..utils import BaseOutput
from .scheduling_dpmsolver_multistep import dpm_spaced_timesteps
from .scheduling_utils import SchedulerMixin, add_vp_noise, log_snr, make_beta_schedule, step_noise, vp_alpha_sigma
from .sigma_utils import convert_to_karras, sigma_to_t


@dataclass
class SASolverSchedulerState:
    timesteps: torch.Tensor  # int64 [S], host
    sigmas: torch.Tensor  # float32 [S+1], host
    num_inference_steps: int
    init_noise_sigma: float = 1.0
    step_index: int = 0
    lower_order_nums: int = 0
    model_outputs: List[torch.Tensor] = field(default_factory=list)  # x0 predictions, newest last
    last_timestep: float = 0.0  # the previous step's timestep (JAX's timestep_buf[-1])
    last_sample: Optional[torch.Tensor] = None  # the previous step's corrected sample, float32
    last_noise: Optional[torch.Tensor] = None  # the previous step's noise, float32


@dataclass
class SASolverSchedulerOutput(BaseOutput):
    prev_sample: torch.Tensor
    state: Optional[SASolverSchedulerState] = None


class SASolverScheduler(SchedulerMixin, ConfigMixin):
    order = 1

    @register_to_config
    def __init__(
        self,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.0001,
        beta_end: float = 0.02,
        beta_schedule: str = "linear",
        trained_betas: Optional[List[float]] = None,
        predictor_order: int = 2,
        corrector_order: int = 2,
        prediction_type: str = "epsilon",
        tau_func: Optional[Callable] = None,
        thresholding: bool = False,
        dynamic_thresholding_ratio: float = 0.995,
        sample_max_value: float = 1.0,
        algorithm_type: str = "data_prediction",
        lower_order_final: bool = True,
        use_karras_sigmas: bool = False,
        timestep_spacing: str = "linspace",
        steps_offset: int = 0,
        variance_type: Optional[str] = None,
    ):
        if algorithm_type != "data_prediction":
            raise NotImplementedError("only data_prediction is implemented")
        if max(predictor_order, corrector_order) > 2:
            raise NotImplementedError("orders > 2 not implemented")
        betas = make_beta_schedule(beta_schedule, num_train_timesteps, beta_start, beta_end, trained_betas)
        self.betas = betas
        self.alphas = 1.0 - betas
        self.alphas_cumprod = np.cumprod(self.alphas, axis=0)
        self.init_noise_sigma = 1.0
        self._tau_func = tau_func

    def tau_func(self, t: float) -> torch.Tensor:
        t = torch.tensor(t, dtype=torch.float32)
        if self._tau_func is not None:
            return torch.as_tensor(self._tau_func(t), dtype=torch.float32)
        return ((t >= 200) & (t <= 800)).float()

    @property
    def _history(self) -> int:
        return max(self.config.predictor_order, self.config.corrector_order - 1)

    def set_timesteps(self, num_inference_steps: int) -> SASolverSchedulerState:
        cfg = self.config
        ts = dpm_spaced_timesteps(cfg.timestep_spacing, num_inference_steps, cfg.num_train_timesteps,
                                  cfg.num_train_timesteps, cfg.steps_offset)
        sigmas_full = np.array(((1 - self.alphas_cumprod) / self.alphas_cumprod) ** 0.5)
        if cfg.use_karras_sigmas:
            sigmas = convert_to_karras(np.flip(sigmas_full).copy(), num_inference_steps)
            ts = np.array([sigma_to_t(s, np.log(sigmas_full)) for s in sigmas]).round().astype(np.int64)
            sigmas = np.concatenate([sigmas, sigmas[-1:]]).astype(np.float32)
        else:
            sigmas = np.interp(ts, np.arange(0, len(sigmas_full)), sigmas_full)
            sigmas = np.concatenate([sigmas, [float(sigmas_full[0])]]).astype(np.float32)
        return SASolverSchedulerState(timesteps=torch.from_numpy(ts), sigmas=torch.from_numpy(sigmas),
                                      num_inference_steps=num_inference_steps)

    def prepare(self, state, sample):
        """JAX allocates its buffers here; the port's are set by `step`."""
        return state

    def scale_model_input(self, state, sample: torch.Tensor, timestep=None) -> torch.Tensor:
        return sample

    def _lambda(self, sigma):
        return log_snr(*vp_alpha_sigma(sigma))

    def convert_model_output(self, state, model_output: torch.Tensor, sample: torch.Tensor, idx: int):
        alpha_t, sigma_t = (float(v) for v in vp_alpha_sigma(state.sigmas[idx]))
        kind = self.config.prediction_type
        if kind == "epsilon":
            if self.config.variance_type in ("learned", "learned_range"):
                model_output = model_output[:, : sample.shape[1]]
            return (sample - sigma_t * model_output) / alpha_t
        if kind == "sample":
            return model_output
        if kind == "v_prediction":
            return alpha_t * sample - sigma_t * model_output
        raise ValueError(f"unsupported prediction_type {kind}")

    @staticmethod
    def _exp_pos(order: int, a, b, tau):
        """The integral from a to b of e^{x (1 + tau^2)} x^order, closed form."""
        c = 1 + tau**2
        bc, ac = c * b, c * a
        if order == 0:
            return torch.exp(bc) * (1 - torch.exp(-(bc - ac))) / c
        return torch.exp(bc) * ((bc - 1) - (ac - 1) * torch.exp(-(bc - ac))) / c**2

    def _coefficients(self, l_t, l_s0, l0, l1, tau):
        """The order-1 coefficient and the order-2 pair of the Lagrange basis
        over (l0, l1)."""
        denom = l0 - l1 if l0 != l1 else torch.ones_like(l0)
        e0, e1 = self._exp_pos(0, l_s0, l_t, tau), self._exp_pos(1, l_s0, l_t, tau)
        return e0, e1 / denom - l1 * e0 / denom, -e1 / denom + l0 * e0 / denom

    def _update(self, sigma_t, sigma_s0, l_list, mod_fn, m_new, m_old, base, noise, order, tau):
        """The shared form of both updates, from sigma_s0 to sigma_t."""
        _, sigma_t_ = vp_alpha_sigma(sigma_t)
        _, sigma_s0_ = vp_alpha_sigma(sigma_s0)
        l_t, l_s0 = self._lambda(sigma_t), self._lambda(sigma_s0)
        h = l_t - l_s0
        tau2 = 1 + tau**2
        scale = tau2 * sigma_t_ * torch.exp(-(tau**2) * l_t)
        c1, c2_0, c2_1 = self._coefficients(l_t, l_s0, *l_list(l_t, l_s0), tau)
        if order == 2:
            mod = mod_fn(l_t, h, tau2)
            gradient = float(scale) * (float(c2_0 + mod) * m_new + float(c2_1 - mod) * m_old)
        else:
            gradient = float(scale * c1) * m_new
        noise_part = float(sigma_t_ * torch.sqrt(torch.clamp_min(1 - torch.exp(-2 * tau**2 * h), 0.0))) * noise
        return float(torch.exp(-(tau**2) * h) * (sigma_t_ / sigma_s0_)) * base + gradient + noise_part

    def step(self, state: SASolverSchedulerState, model_output: torch.Tensor, timestep, sample: torch.Tensor,
             generator: Optional[torch.Generator] = None, variance_noise: Optional[torch.Tensor] = None,
             return_dict: bool = True):
        """The corrector of the previous step's sample, then the predictor;
        updates `state` in place."""
        cfg = self.config
        idx, num_steps, done = state.step_index, int(state.timesteps.shape[0]), state.lower_order_nums
        sample_f = sample.float()
        converted = self.convert_model_output(state, model_output.float(), sample_f, idx)
        if state.last_sample is not None:  # SA-Corrector over [idx - 1 -> idx]
            co = min(cfg.corrector_order, num_steps - idx + 1) if cfg.lower_order_final else cfg.corrector_order
            sigma_s1 = state.sigmas[idx - 1]
            sample_f = self._update(
                state.sigmas[idx], sigma_s1, lambda l_t, l_s0: (l_t, l_s0),
                lambda l_t, h, tau2: torch.exp(tau2 * l_t) * (
                    h / 2 - (h * tau2 - 1 + torch.exp(tau2 * (-h))) / (tau2**2 * (h if h != 0 else 1.0))),
                converted, state.model_outputs[-1], state.last_sample, state.last_noise, min(co, done + 2),
                self.tau_func(state.last_timestep))
        state.model_outputs = (state.model_outputs + [converted])[-max(self._history, 1):]
        state.last_timestep = float(np.float32(timestep))
        noise = step_noise(variance_noise, generator, model_output, "SA-Solver")
        po = min(cfg.predictor_order, num_steps - idx) if cfg.lower_order_final else cfg.predictor_order
        l_s0, l_s1 = self._lambda(state.sigmas[idx]), self._lambda(state.sigmas[max(idx - 1, 0)])
        span = l_s0 - l_s1 if l_s0 != l_s1 else 1.0
        prev_sample = self._update(  # SA-Predictor over [idx -> idx + 1]
            state.sigmas[idx + 1], state.sigmas[idx], lambda l_t, l_s0: (l_s0, l_s1),
            lambda l_t, h, tau2: torch.exp(tau2 * l_t) * (h**2 / 2 - (h * tau2 - 1 + torch.exp(tau2 * (-h))) / tau2**2)
            / span,
            converted, state.model_outputs[-2] if len(state.model_outputs) > 1 else None, sample_f, noise,
            min(po, done + 1), self.tau_func(state.last_timestep))
        state.step_index, state.last_sample, state.last_noise = idx + 1, sample_f, noise
        state.lower_order_nums = min(done + 1, self._history)
        prev_sample = prev_sample.to(model_output.dtype)
        if not return_dict:
            return (prev_sample, state)
        return SASolverSchedulerOutput(prev_sample=prev_sample, state=state)

    def add_noise(self, state, original_samples: torch.Tensor, noise: torch.Tensor, timesteps) -> torch.Tensor:
        return add_vp_noise(state, original_samples, noise, timesteps)

    def __len__(self):
        return self.config.num_train_timesteps

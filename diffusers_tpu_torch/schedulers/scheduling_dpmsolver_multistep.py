"""DPM-Solver / DPM-Solver++ multistep sampler.

Port of `diffusers_tpu/schedulers/scheduling_dpmsolver_multistep.py`: the
algorithm types dpmsolver++, sde-dpmsolver++ and dpmsolver at orders 1-3,
the midpoint and heun solver types, dynamic thresholding, `lower_order_final`
/ `euler_at_final`, `final_sigmas_type`, `lambda_min_clipped`, the
linspace / leading / trailing spacings and the Karras, exponential, beta,
lu-lambda and flow sigma ladders (numpy on the host, exactly as JAX builds
them).

The scalar coefficients of a step are computed on the host in float32 from
the float32 sigma ladder, as JAX computes them; the sample arithmetic runs in
torch in float32 on the sample's device and `prev_sample` is cast back to the
model output's dtype. The history of converted outputs, the step index and
the count of steps taken live on the state that `set_timesteps` returns and
`step` updates them in place (the port's loops pass that one state to every
step). Where JAX selects the order with `jnp.where`, the port picks it on the
host and computes that order alone. The warm-up counts the steps this state
has taken, as upstream's `lower_order_nums` does, so a loop that starts at a
later step index (img2img) begins at first order. sde-dpmsolver++ takes its
noise as `variance_noise` or draws it from `generator`; with neither it
raises, as JAX's step does without a key.
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
    rescale_zero_terminal_snr,
    step_noise,
    threshold_sample,
    vp_alpha_sigma,
)
from .sigma_utils import convert_to_beta, convert_to_exponential, convert_to_karras, sigma_to_t


@dataclass
class DPMSolverMultistepSchedulerState:
    timesteps: torch.Tensor  # [S], host: int64, float32 with flow sigmas
    sigmas: torch.Tensor  # float32 [S+1], host
    num_inference_steps: int
    init_noise_sigma: float = 1.0
    step_index: int = 0
    lower_order_nums: int = 0  # steps taken by this state (the warm-up counter)
    model_outputs: List[torch.Tensor] = field(default_factory=list)  # converted outputs, newest last


@dataclass
class DPMSolverMultistepSchedulerOutput(BaseOutput):
    prev_sample: torch.Tensor
    state: Optional[DPMSolverMultistepSchedulerState] = None


def dpm_spaced_timesteps(spacing: str, num_inference_steps: int, num_train_timesteps: int, last_timestep: int,
                         steps_offset: int) -> np.ndarray:
    """The DPM family's spacing: N + 1 grid points with the last dropped
    (linspace, leading), or trailing."""
    if spacing == "linspace":
        return np.linspace(0, last_timestep - 1, num_inference_steps + 1).round()[::-1][:-1].copy().astype(np.int64)
    if spacing == "leading":
        step_ratio = last_timestep // (num_inference_steps + 1)
        ts = (np.arange(0, num_inference_steps + 1) * step_ratio).round()[::-1][:-1].copy().astype(np.int64)
        return ts + steps_offset
    if spacing == "trailing":
        step_ratio = num_train_timesteps / num_inference_steps
        return np.arange(last_timestep, 0, -step_ratio).round().copy().astype(np.int64) - 1
    raise ValueError(f"unsupported timestep_spacing {spacing}")


class DPMSolverMultistepScheduler(SchedulerMixin, ConfigMixin):
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
        lower_order_final: bool = True,
        euler_at_final: bool = False,
        use_karras_sigmas: bool = False,
        use_exponential_sigmas: bool = False,
        use_beta_sigmas: bool = False,
        use_lu_lambdas: bool = False,
        use_flow_sigmas: bool = False,
        flow_shift: float = 1.0,
        final_sigmas_type: str = "zero",
        lambda_min_clipped: float = -float("inf"),
        variance_type: Optional[str] = None,
        timestep_spacing: str = "linspace",
        steps_offset: int = 0,
        rescale_betas_zero_snr: bool = False,
    ):
        if algorithm_type not in ("dpmsolver++", "sde-dpmsolver++", "dpmsolver"):
            raise NotImplementedError(f"algorithm_type {algorithm_type} not supported")
        if solver_order > 3:
            raise NotImplementedError("solver_order must be 1, 2 or 3")
        betas = make_beta_schedule(beta_schedule, num_train_timesteps, beta_start, beta_end, trained_betas)
        if rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)
        self.betas = betas
        self.alphas = 1.0 - betas
        self.alphas_cumprod = np.cumprod(self.alphas, axis=0)
        if rescale_betas_zero_snr:
            self.alphas_cumprod[-1] = 2**-24
        self.lambda_t = np.log(np.sqrt(self.alphas_cumprod)) - np.log(np.sqrt(1 - self.alphas_cumprod))
        self.init_noise_sigma = 1.0

    def set_timesteps(self, num_inference_steps: Optional[int] = None, mu: Optional[float] = None,
                      timesteps: Optional[List[int]] = None) -> DPMSolverMultistepSchedulerState:
        cfg = self.config
        flow_shift = float(np.exp(mu)) if mu is not None else cfg.flow_shift
        if num_inference_steps is None and timesteps is None:
            raise ValueError("Must pass one of num_inference_steps or timesteps")
        if timesteps is not None:
            ts = np.array(timesteps).astype(np.int64)
        else:
            clipped_idx = int(np.searchsorted(np.flip(self.lambda_t), cfg.lambda_min_clipped))
            ts = dpm_spaced_timesteps(cfg.timestep_spacing, num_inference_steps, cfg.num_train_timesteps,
                                      cfg.num_train_timesteps - clipped_idx, cfg.steps_offset)

        sigmas_full = np.array(((1 - self.alphas_cumprod) / self.alphas_cumprod) ** 0.5)
        log_sigmas = np.log(sigmas_full)
        if cfg.use_karras_sigmas:
            sigmas = convert_to_karras(np.flip(sigmas_full).copy(), num_inference_steps)
            ts = np.array([sigma_to_t(s, log_sigmas) for s in sigmas])
            if cfg.beta_schedule != "squaredcos_cap_v2":
                ts = ts.round()
        elif cfg.use_exponential_sigmas:
            sigmas = convert_to_exponential(np.flip(sigmas_full).copy(), num_inference_steps)
            ts = np.array([sigma_to_t(s, log_sigmas) for s in sigmas])
        elif cfg.use_beta_sigmas:
            sigmas = convert_to_beta(np.flip(sigmas_full).copy(), num_inference_steps)
            ts = np.array([sigma_to_t(s, log_sigmas) for s in sigmas])
        elif cfg.use_lu_lambdas:
            lambdas = np.flip(log_sigmas.copy())
            lambda_min, lambda_max = float(lambdas[-1]), float(lambdas[0])
            lambdas = np.exp(np.linspace(np.log(np.exp(lambda_max)), np.log(np.exp(lambda_min)),
                                         num_inference_steps + 1))
            sigmas = np.exp(np.log(lambdas))  # JAX's lu-lambda ladder: uniform in lambda
            ts = np.array([sigma_to_t(s, log_sigmas) for s in sigmas])
            if cfg.beta_schedule != "squaredcos_cap_v2":
                ts = ts.round()
        elif cfg.use_flow_sigmas:
            sigmas = 1.0 - np.linspace(1, 1 / cfg.num_train_timesteps, num_inference_steps + 1)
            sigmas = np.flip(flow_shift * sigmas / (1 + (flow_shift - 1) * sigmas))[:-1].copy()
            ts = (sigmas * cfg.num_train_timesteps).copy()
        else:
            sigmas = np.interp(ts, np.arange(0, len(sigmas_full)), sigmas_full)

        if cfg.final_sigmas_type == "sigma_min":
            sigma_last = float(((1 - self.alphas_cumprod[0]) / self.alphas_cumprod[0]) ** 0.5)
        elif cfg.final_sigmas_type == "zero":
            sigma_last = 0.0
        else:
            raise ValueError("final_sigmas_type must be 'zero' or 'sigma_min'")
        sigmas = np.concatenate([sigmas, [sigma_last]]).astype(np.float32)
        ts = np.asarray(ts, dtype=np.float32) if cfg.use_flow_sigmas else np.asarray(ts).astype(np.int64)
        return DPMSolverMultistepSchedulerState(timesteps=torch.from_numpy(ts), sigmas=torch.from_numpy(sigmas),
                                                num_inference_steps=len(ts))

    def prepare(self, state, sample):
        """JAX allocates its history here; the port's grows in `step`."""
        return state

    def scale_model_input(self, state, sample: torch.Tensor, timestep=None) -> torch.Tensor:
        return sample

    # ------------------------------------------------------ host scalars (f32)
    def _alpha_sigma_t(self, sigma: torch.Tensor):
        if self.config.use_flow_sigmas:
            return 1 - sigma, sigma
        return vp_alpha_sigma(sigma)

    def _lambda(self, state, idx: int):
        alpha_t, sigma_t = self._alpha_sigma_t(state.sigmas[idx])
        return log_snr(alpha_t, sigma_t), alpha_t, sigma_t

    # ------------------------------------------------------------- the step
    def convert_model_output(self, state, model_output: torch.Tensor, sample: torch.Tensor, idx: int):
        """The x0 prediction (DPM-Solver++) or the noise prediction (DPM-Solver)
        of a float32 model output."""
        cfg = self.config
        sigma = state.sigmas[idx]
        alpha_t, sigma_t = (float(v) for v in self._alpha_sigma_t(sigma))
        kind = cfg.prediction_type
        if cfg.algorithm_type in ("dpmsolver++", "sde-dpmsolver++"):
            if kind == "epsilon":
                if cfg.variance_type in ("learned", "learned_range"):
                    model_output = model_output[:, :3]
                x0 = (sample - sigma_t * model_output) / alpha_t
            elif kind == "sample":
                x0 = model_output
            elif kind == "v_prediction":
                x0 = alpha_t * sample - sigma_t * model_output
            elif kind == "flow_prediction":
                x0 = sample - float(sigma) * model_output
            else:
                raise ValueError(f"unsupported prediction_type {kind}")
            if cfg.thresholding:
                x0 = threshold_sample(x0, cfg.dynamic_thresholding_ratio, cfg.sample_max_value)
            return x0
        if kind == "epsilon":
            return model_output[:, :3] if cfg.variance_type in ("learned", "learned_range") else model_output
        if kind == "sample":
            return (sample - alpha_t * model_output) / sigma_t
        if kind == "v_prediction":
            return alpha_t * model_output + sigma_t * sample
        raise ValueError(f"unsupported prediction_type {kind}")

    def _update(self, state, sample: torch.Tensor, idx: int, order: int, noise) -> torch.Tensor:
        """The order-1, 2 or 3 multistep update from step idx to idx + 1."""
        cfg = self.config
        algo, midpoint = cfg.algorithm_type, cfg.solver_type == "midpoint"
        m = state.model_outputs
        lambda_t, alpha_t, sigma_t = self._lambda(state, idx + 1)
        lambda_s0, alpha_s0, sigma_s0 = self._lambda(state, idx)
        h = lambda_t - lambda_s0
        if algo == "dpmsolver++":
            out = float(sigma_t / sigma_s0) * sample - float(alpha_t * (torch.exp(-h) - 1.0)) * m[-1]
        elif algo == "dpmsolver":
            out = float(alpha_t / alpha_s0) * sample - float(sigma_t * (torch.exp(h) - 1.0)) * m[-1]
        else:
            out = (float(sigma_t / sigma_s0 * torch.exp(-h)) * sample
                   + float(alpha_t * (1 - torch.exp(-2.0 * h))) * m[-1])
        if order == 2:
            lambda_s1 = self._lambda(state, idx - 1)[0]
            r0 = (lambda_s0 - lambda_s1) / h
            d1 = float(1.0 / r0) * (m[-1] - m[-2])
            if algo == "dpmsolver++":
                c = (-0.5 * (alpha_t * (torch.exp(-h) - 1.0)) if midpoint
                     else alpha_t * ((torch.exp(-h) - 1.0) / h + 1.0))
            elif algo == "dpmsolver":
                c = (-0.5 * (sigma_t * (torch.exp(h) - 1.0)) if midpoint
                     else -(sigma_t * ((torch.exp(h) - 1.0) / h - 1.0)))
            else:
                c = (0.5 * (alpha_t * (1 - torch.exp(-2.0 * h))) if midpoint
                     else alpha_t * ((1.0 - torch.exp(-2.0 * h)) / (-2.0 * h) + 1.0))
            out = out + float(c) * d1
        elif order == 3:
            lambda_s1 = self._lambda(state, idx - 1)[0]
            lambda_s2 = self._lambda(state, idx - 2)[0]
            r0, r1 = (lambda_s0 - lambda_s1) / h, (lambda_s1 - lambda_s2) / h
            d1_0, d1_1 = float(1.0 / r0) * (m[-1] - m[-2]), float(1.0 / r1) * (m[-2] - m[-3])
            d1 = d1_0 + float(r0 / (r0 + r1)) * (d1_0 - d1_1)
            d2 = float(1.0 / (r0 + r1)) * (d1_0 - d1_1)
            if algo == "dpmsolver++":
                c1 = alpha_t * ((torch.exp(-h) - 1.0) / h + 1.0)
                c2 = -(alpha_t * ((torch.exp(-h) - 1.0 + h) / h**2 - 0.5))
            elif algo == "dpmsolver":
                c1 = -(sigma_t * ((torch.exp(h) - 1.0) / h - 1.0))
                c2 = -(sigma_t * ((torch.exp(h) - 1.0 - h) / h**2 - 0.5))
            else:
                c1 = alpha_t * ((1.0 - torch.exp(-2.0 * h)) / (-2.0 * h) + 1.0)
                c2 = alpha_t * ((1.0 - torch.exp(-2.0 * h) - 2.0 * h) / (2.0 * h) ** 2 - 0.5)
            out = out + float(c1) * d1 + float(c2) * d2
        if algo == "sde-dpmsolver++":
            out = out + float(sigma_t * torch.sqrt(torch.clamp_min(1.0 - torch.exp(-2 * h), 0.0))) * noise
        return out

    def _step_order(self, idx: int, num_steps: int, done: int) -> int:
        """The order of step idx after `done` steps of this state (JAX's
        selection, with its warm-up `idx < k` read as `done < k`)."""
        cfg = self.config
        final = idx == num_steps - 1 and (cfg.euler_at_final or (cfg.lower_order_final and num_steps < 15)
                                          or cfg.final_sigmas_type == "zero")
        if cfg.solver_order == 1 or done < 1 or final:
            return 1
        second = cfg.solver_order == 3 and idx == num_steps - 2 and cfg.lower_order_final and num_steps < 15
        if cfg.solver_order == 2 or done < 2 or second:
            return 2
        return 3

    def step(self, state: DPMSolverMultistepSchedulerState, model_output: torch.Tensor, timestep,
             sample: torch.Tensor, generator: Optional[torch.Generator] = None,
             variance_noise: Optional[torch.Tensor] = None, return_dict: bool = True):
        """One step at `state.step_index`; updates `state` in place."""
        idx, num_steps = state.step_index, int(state.timesteps.shape[0])
        sample_f = sample.float()
        converted = self.convert_model_output(state, model_output.float(), sample_f, idx)
        state.model_outputs = (state.model_outputs + [converted])[-self.config.solver_order:]
        noise = None
        if self.config.algorithm_type == "sde-dpmsolver++":
            noise = step_noise(variance_noise, generator, converted, "sde-dpmsolver++")
        order = self._step_order(idx, num_steps, state.lower_order_nums)
        prev_sample = self._update(state, sample_f, idx, order, noise)
        state.step_index, state.lower_order_nums = idx + 1, state.lower_order_nums + 1
        prev_sample = prev_sample.to(model_output.dtype)
        if not return_dict:
            return (prev_sample, state)
        return DPMSolverMultistepSchedulerOutput(prev_sample=prev_sample, state=state)

    def add_noise(self, state, original_samples: torch.Tensor, noise: torch.Tensor, timesteps) -> torch.Tensor:
        return add_vp_noise(state, original_samples, noise, timesteps, self._alpha_sigma_t)

    def __len__(self):
        return self.config.num_train_timesteps

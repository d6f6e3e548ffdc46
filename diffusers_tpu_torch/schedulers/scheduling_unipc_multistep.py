"""UniPC multistep sampler (Wan's scheduler).

Port of `diffusers_tpu/schedulers/scheduling_unipc_multistep.py` (`:58`):
``predict_x0``, the bh1 / bh2 solver family at ``solver_order`` <= 2, the
UniC corrector, epsilon / v / flow prediction, the linspace and flow sigma
ladders (``use_flow_sigmas`` with ``flow_shift``), ``lower_order_final``
and `add_noise`. The ladders are built in numpy on the host exactly as in
JAX and kept as host tensors; the scalar coefficients of a
step are computed on the host in float32, as JAX computes them, and the
sample arithmetic runs in torch in float32, `prev_sample` cast back to the
model output's dtype.

JAX's state is a functional dataclass that each step returns anew. The
port's eager loops pass the one state that `set_timesteps` made to every
step and ignore the state `step` returns, so the multistep history (the
converted outputs, the last sample, the step index) lives on that state and
`step` updates it in place; where JAX selects the step's order with
`jnp.where`, the port picks it on the host and computes that order alone.
The warm-up counts the steps this state has taken and the corrector runs the
order the last predictor ran (upstream's `lower_order_nums` and
`this_order`), so a loop that starts at a later step index begins at first
order; over a whole loop these are JAX's `idx`-based rules.
``predict_x0=False`` raises, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..configuration_utils import ConfigMixin, register_to_config
from ..utils import BaseOutput
from .scheduling_dpmsolver_multistep import dpm_spaced_timesteps
from .scheduling_utils import (
    KarrasDiffusionSchedulers,
    SchedulerMixin,
    add_vp_noise,
    log_snr,
    make_beta_schedule,
    rescale_zero_terminal_snr,
    threshold_sample,
    vp_alpha_sigma,
)
from .sigma_utils import convert_to_karras, sigma_to_t


@dataclass
class UniPCMultistepSchedulerState:
    timesteps: torch.Tensor  # [S], host: float32 with flow sigmas, else int64
    sigmas: torch.Tensor  # float32 [S+1], host
    num_inference_steps: int
    init_noise_sigma: float = 1.0
    step_index: int = 0
    lower_order_nums: int = 0  # steps taken by this state
    this_order: int = 1  # the order of the last predictor step
    model_outputs: List[torch.Tensor] = field(default_factory=list)  # converted (x0) outputs, newest last
    last_sample: Optional[torch.Tensor] = None  # the corrected sample of the last step, float32


@dataclass
class UniPCMultistepSchedulerOutput(BaseOutput):
    prev_sample: torch.Tensor
    state: Optional[UniPCMultistepSchedulerState] = None


class UniPCMultistepScheduler(SchedulerMixin, ConfigMixin):
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
        predict_x0: bool = True,
        solver_type: str = "bh2",
        lower_order_final: bool = True,
        disable_corrector: List[int] = [],
        use_karras_sigmas: bool = False,
        use_flow_sigmas: bool = False,
        flow_shift: float = 1.0,
        timestep_spacing: str = "linspace",
        steps_offset: int = 0,
        final_sigmas_type: str = "zero",
        rescale_betas_zero_snr: bool = False,
    ):
        if not predict_x0:
            raise NotImplementedError("predict_x0=False is not implemented (as in JAX)")
        if solver_order > 3:
            raise NotImplementedError("solver_order must be 1, 2 or 3")
        if solver_type not in ("bh1", "bh2"):
            raise ValueError(f"solver_type must be bh1 or bh2, got {solver_type}")
        betas = make_beta_schedule(beta_schedule, num_train_timesteps, beta_start, beta_end, trained_betas)
        if rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)
        self.alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
        if rescale_betas_zero_snr:
            self.alphas_cumprod[-1] = 2**-24
        self.init_noise_sigma = 1.0

    def set_timesteps(self, num_inference_steps: int, mu: Optional[float] = None) -> UniPCMultistepSchedulerState:
        """The timestep and sigma ladders (JAX `set_timesteps`) and an empty history."""
        cfg = self.config
        flow_shift = float(np.exp(mu)) if mu is not None else cfg.flow_shift
        sigmas_full = np.array(((1 - self.alphas_cumprod) / self.alphas_cumprod) ** 0.5)
        T = cfg.num_train_timesteps
        if cfg.use_flow_sigmas:
            sigmas = 1.0 - np.linspace(1, 1 / T, num_inference_steps + 1)
            sigmas = np.flip(flow_shift * sigmas / (1 + (flow_shift - 1) * sigmas))[:-1].copy()
            ts = (sigmas * T).copy().astype(np.float32)
        elif cfg.use_karras_sigmas:
            sigmas = convert_to_karras(np.flip(sigmas_full).copy(), num_inference_steps)
            ts = np.array([sigma_to_t(s, np.log(sigmas_full)) for s in sigmas]).round().astype(np.int64)
        else:
            ts = dpm_spaced_timesteps(cfg.timestep_spacing, num_inference_steps, T, T, cfg.steps_offset)
            sigmas = np.interp(ts, np.arange(0, len(sigmas_full)), sigmas_full)
        sigma_last = float(sigmas_full[0]) if cfg.final_sigmas_type == "sigma_min" else 0.0
        sigmas = np.concatenate([sigmas, [sigma_last]]).astype(np.float32)
        return UniPCMultistepSchedulerState(
            timesteps=torch.from_numpy(np.asarray(ts, dtype=np.float32 if cfg.use_flow_sigmas else np.int64)),
            sigmas=torch.from_numpy(sigmas), num_inference_steps=num_inference_steps)

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

    def _bh_coeffs(self, hh: torch.Tensor):
        """(b0, b1, b2, B_h, h_phi_1) of the bh family: the first three
        entries of its b-vector."""
        h_phi_1 = torch.expm1(hh)
        h_phi_k = h_phi_1 / hh - 1
        B_h = hh if self.config.solver_type == "bh1" else torch.expm1(hh)
        b0 = h_phi_k * 1.0 / B_h
        h_phi_k2 = h_phi_k / hh - 1 / 2
        b1 = h_phi_k2 * 2.0 / B_h
        b2 = (h_phi_k2 / hh - 1 / 6) * 6.0 / B_h
        return b0, b1, b2, B_h, h_phi_1

    # ------------------------------------------------------------- the step
    def convert_model_output(self, state, model_output: torch.Tensor, sample: torch.Tensor, idx: int):
        """The (thresholded) x0 prediction of a float32 model output."""
        cfg = self.config
        sigma = state.sigmas[idx]
        alpha_t, sigma_t = self._alpha_sigma_t(sigma)
        kind = cfg.prediction_type
        if kind == "epsilon":
            x0 = (sample - float(sigma_t) * model_output) / float(alpha_t)
        elif kind == "sample":
            x0 = model_output
        elif kind == "v_prediction":
            x0 = float(alpha_t) * sample - float(sigma_t) * model_output
        elif kind == "flow_prediction":
            x0 = sample - float(sigma) * model_output
        else:
            raise ValueError(f"unsupported prediction_type {kind}")
        if cfg.thresholding:
            x0 = threshold_sample(x0, cfg.dynamic_thresholding_ratio, cfg.sample_max_value)
        return x0

    def _order(self, idx: int, num_steps: int, done: int) -> int:
        """The predictor's order at step `idx` after `done` steps of this
        state (JAX's this_order, its warm-up `idx` read as `done`)."""
        order = self.config.solver_order
        if self.config.lower_order_final:
            order = min(order, num_steps - idx)
        return min(order, min(done, self.config.solver_order) + 1)

    def _predictor(self, state, sample: torch.Tensor, idx: int, order: int) -> torch.Tensor:
        """UniP (predict_x0) from step idx to idx + 1."""
        m = state.model_outputs
        lambda_t, alpha_t, sigma_t = self._lambda(state, idx + 1)
        lambda_s0, _, sigma_s0 = self._lambda(state, idx)
        h = lambda_t - lambda_s0
        b0, b1, _, B_h, h_phi_1 = self._bh_coeffs(-h)
        x_t = float(sigma_t / sigma_s0) * sample - float(alpha_t * h_phi_1) * m[-1]
        if order == 1:
            return x_t
        r0 = (self._lambda(state, idx - 1)[0] - lambda_s0) / h
        d1s0 = (m[-2] - m[-1]) / float(r0)
        if order == 2:
            return x_t - float(alpha_t * B_h) * (0.5 * d1s0)  # rhos_p = [0.5]
        # order 3: rhos_p = solve([[1, 1], [r0, r1]], [b0, b1])
        r1 = (self._lambda(state, idx - 2)[0] - lambda_s0) / h
        d1s1 = (m[-3] - m[-1]) / float(r1)
        p1 = (b1 - r0 * b0) / (r1 - r0)
        p0 = b0 - p1
        return x_t - float(alpha_t * B_h) * (float(p0) * d1s0 + float(p1) * d1s1)

    def _corrector(self, state, this_model_output: torch.Tensor, idx: int, order: int) -> torch.Tensor:
        """UniC: corrects the last step's sample with the new output at step idx."""
        m, x = state.model_outputs, state.last_sample
        lambda_t, alpha_t, sigma_t = self._lambda(state, idx)
        lambda_s0, _, sigma_s0 = self._lambda(state, idx - 1)
        h = lambda_t - lambda_s0
        b0, b1, b2, B_h, h_phi_1 = self._bh_coeffs(-h)
        x_t = float(sigma_t / sigma_s0) * x - float(alpha_t * h_phi_1) * m[-1]
        d1_t = this_model_output - m[-1]
        if order == 1:
            return x_t - float(alpha_t * B_h) * (0.5 * d1_t)  # rhos_c = [0.5]
        r0 = (self._lambda(state, idx - 2)[0] - lambda_s0) / h
        d1s0 = (m[-2] - m[-1]) / float(r0)
        if order == 2:  # solve [[1, 1], [r0, 1]] rhos = [b0, b1]
            rc0 = (b0 - b1) / (1.0 - r0)
            rc1 = b0 - rc0
            return x_t - float(alpha_t * B_h) * (float(rc0) * d1s0 + float(rc1) * d1_t)
        # order 3: solve [[1, 1, 1], [r0, r1, 1], [r0^2, r1^2, 1]] rhos = [b0, b1, b2]
        r1 = (self._lambda(state, idx - 3)[0] - lambda_s0) / h
        d1s1 = (m[-3] - m[-1]) / float(r1)
        one = torch.ones_like(r0)
        rhos = torch.linalg.solve(torch.stack([torch.stack([one, one, one]), torch.stack([r0, r1, one]),
                                               torch.stack([r0**2, r1**2, one])]), torch.stack([b0, b1, b2]))
        return x_t - float(alpha_t * B_h) * (float(rhos[0]) * d1s0 + float(rhos[1]) * d1s1 + float(rhos[2]) * d1_t)

    def step(self, state: UniPCMultistepSchedulerState, model_output: torch.Tensor, timestep,
             sample: torch.Tensor, return_dict: bool = True):
        """One UniPC step at `state.step_index` (the corrector of the last step's
        sample, then the predictor); updates `state` in place."""
        idx, num_steps = state.step_index, int(state.timesteps.shape[0])
        sample_f = sample.float()
        converted = self.convert_model_output(state, model_output.float(), sample_f, idx)
        if state.last_sample is not None and idx - 1 not in self.config.disable_corrector:
            sample_f = self._corrector(state, converted, idx, state.this_order)
        state.model_outputs = (state.model_outputs + [converted])[-max(self.config.solver_order, 2):]
        state.this_order = self._order(idx, num_steps, state.lower_order_nums)
        prev_sample = self._predictor(state, sample_f, idx, state.this_order).to(model_output.dtype)
        state.step_index, state.last_sample = idx + 1, sample_f
        state.lower_order_nums += 1
        if not return_dict:
            return (prev_sample, state)
        return UniPCMultistepSchedulerOutput(prev_sample=prev_sample, state=state)

    def add_noise(self, state, original_samples: torch.Tensor, noise: torch.Tensor, timesteps) -> torch.Tensor:
        return add_vp_noise(state, original_samples, noise, timesteps, self._alpha_sigma_t)

    def __len__(self):
        return self.config.num_train_timesteps

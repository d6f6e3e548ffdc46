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
Solver order 3, thresholding, the Karras ladder, the "leading" and
"trailing" spacings, zero-terminal-SNR betas and ``disable_corrector`` wait
for a pipeline that uses them, and raise.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..configuration_utils import ConfigMixin, register_to_config
from ..utils import BaseOutput
from .scheduling_utils import KarrasDiffusionSchedulers, SchedulerMixin, broadcast_to_left, index_for_timestep, \
    make_beta_schedule


@dataclass
class UniPCMultistepSchedulerState:
    timesteps: torch.Tensor  # [S], host: float32 with flow sigmas, else int64
    sigmas: torch.Tensor  # float32 [S+1], host
    num_inference_steps: int
    init_noise_sigma: float = 1.0
    step_index: int = 0
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
            raise NotImplementedError("predict_x0=False is not implemented (no shipped config uses it)")
        unported = {"solver_order 3": solver_order > 2, "thresholding": thresholding,
                    "use_karras_sigmas": use_karras_sigmas, "rescale_betas_zero_snr": rescale_betas_zero_snr,
                    "disable_corrector": bool(disable_corrector),
                    f"timestep_spacing {timestep_spacing!r}": timestep_spacing != "linspace"}
        if any(unported.values()):
            raise NotImplementedError(f"UniPCMultistepScheduler: {[k for k, v in unported.items() if v]} "
                                      "not ported yet")
        if solver_type not in ("bh1", "bh2"):
            raise ValueError(f"solver_type must be bh1 or bh2, got {solver_type}")
        betas = make_beta_schedule(beta_schedule, num_train_timesteps, beta_start, beta_end, trained_betas)
        self.alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
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
        else:  # linspace spacing: N + 1 grid points, the last dropped
            ts = np.linspace(0, T - 1, num_inference_steps + 1).round()[::-1][:-1].copy().astype(np.int64)
            sigmas = np.interp(ts, np.arange(0, len(sigmas_full)), sigmas_full)
        sigma_last = float(sigmas_full[0]) if cfg.final_sigmas_type == "sigma_min" else 0.0
        sigmas = np.concatenate([sigmas, [sigma_last]]).astype(np.float32)
        return UniPCMultistepSchedulerState(
            timesteps=torch.from_numpy(np.asarray(ts, dtype=np.float32 if cfg.use_flow_sigmas else np.int64)),
            sigmas=torch.from_numpy(sigmas), num_inference_steps=num_inference_steps)

    def scale_model_input(self, state, sample: torch.Tensor, timestep=None) -> torch.Tensor:
        return sample

    # ------------------------------------------------------ host scalars (f32)
    def _alpha_sigma_t(self, sigma: torch.Tensor):
        if self.config.use_flow_sigmas:
            return 1 - sigma, sigma
        alpha_t = 1 / ((sigma**2 + 1) ** 0.5)
        return alpha_t, sigma * alpha_t

    def _lambda(self, state, idx: int):
        alpha_t, sigma_t = self._alpha_sigma_t(state.sigmas[idx])
        return torch.log(alpha_t) - torch.log(torch.clamp_min(sigma_t, 1e-20)), alpha_t, sigma_t

    def _bh_coeffs(self, hh: torch.Tensor):
        """(b0, b1, B_h, h_phi_1) of the bh family for order <= 2."""
        h_phi_1 = torch.expm1(hh)
        h_phi_k = h_phi_1 / hh - 1
        B_h = hh if self.config.solver_type == "bh1" else torch.expm1(hh)
        b0 = h_phi_k * 1.0 / B_h
        b1 = (h_phi_k / hh - 1 / 2) * 2.0 / B_h
        return b0, b1, B_h, h_phi_1

    # ------------------------------------------------------------- the step
    def convert_model_output(self, state, model_output: torch.Tensor, sample: torch.Tensor, idx: int):
        """The x0 prediction of a float32 model output."""
        sigma = state.sigmas[idx]
        alpha_t, sigma_t = self._alpha_sigma_t(sigma)
        kind = self.config.prediction_type
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
        return x0

    def _order(self, idx: int, num_steps: int) -> int:
        """The solver order at step `idx` (JAX's this_order)."""
        order = self.config.solver_order
        if self.config.lower_order_final:
            order = min(order, num_steps - idx)
        return min(order, min(idx, self.config.solver_order) + 1)

    def _predictor(self, state, sample: torch.Tensor, idx: int, order: int) -> torch.Tensor:
        """UniP (predict_x0) from step idx to idx + 1."""
        m0 = state.model_outputs[-1]
        lambda_t, alpha_t, sigma_t = self._lambda(state, idx + 1)
        lambda_s0, _, sigma_s0 = self._lambda(state, idx)
        h = lambda_t - lambda_s0
        _, _, B_h, h_phi_1 = self._bh_coeffs(-h)
        x_t = float(sigma_t / sigma_s0) * sample - float(alpha_t * h_phi_1) * m0
        if order >= 2:
            rk = (self._lambda(state, idx - 1)[0] - lambda_s0) / h
            d1 = (state.model_outputs[-2] - m0) / float(rk)
            x_t = x_t - float(alpha_t * B_h) * (0.5 * d1)  # rhos_p = [0.5]
        return x_t

    def _corrector(self, state, this_model_output: torch.Tensor, idx: int, order: int) -> torch.Tensor:
        """UniC: corrects the last step's sample with the new output at step idx (> 0)."""
        m0, x = state.model_outputs[-1], state.last_sample
        lambda_t, alpha_t, sigma_t = self._lambda(state, idx)
        lambda_s0, _, sigma_s0 = self._lambda(state, idx - 1)
        h = lambda_t - lambda_s0
        b0, b1, B_h, h_phi_1 = self._bh_coeffs(-h)
        x_t = float(sigma_t / sigma_s0) * x - float(alpha_t * h_phi_1) * m0
        d1_t = this_model_output - m0
        if order < 2:
            return x_t - float(alpha_t * B_h) * (0.5 * d1_t)  # rhos_c = [0.5]
        # order 2: solve [[1, 1], [r0, 1]] rhos = [b0, b1]
        r0 = (self._lambda(state, idx - 2)[0] - lambda_s0) / h
        d1s0 = (state.model_outputs[-2] - m0) / float(r0)
        rc0 = (b0 - b1) / (1.0 - r0)
        rc1 = b0 - rc0
        return x_t - float(alpha_t * B_h) * (float(rc0) * d1s0 + float(rc1) * d1_t)

    def step(self, state: UniPCMultistepSchedulerState, model_output: torch.Tensor, timestep,
             sample: torch.Tensor, return_dict: bool = True):
        """One UniPC step at `state.step_index` (the corrector of the last step's
        sample, then the predictor); updates `state` in place."""
        idx, num_steps = state.step_index, int(state.timesteps.shape[0])
        sample_f = sample.float()
        converted = self.convert_model_output(state, model_output.float(), sample_f, idx)
        if idx > 0:
            sample_f = self._corrector(state, converted, idx, self._order(idx - 1, num_steps))
        state.model_outputs = (state.model_outputs + [converted])[-max(self.config.solver_order, 2):]
        prev_sample = self._predictor(state, sample_f, idx, self._order(idx, num_steps)).to(model_output.dtype)
        state.step_index, state.last_sample = idx + 1, sample_f
        if not return_dict:
            return (prev_sample, state)
        return UniPCMultistepSchedulerOutput(prev_sample=prev_sample, state=state)

    def add_noise(self, state, original_samples: torch.Tensor, noise: torch.Tensor, timesteps) -> torch.Tensor:
        """``alpha_t x + sigma_t noise`` at each row's timestep, found in the schedule
        by equality (the first entry when absent, as JAX's argmax)."""
        ts = torch.as_tensor(timesteps).reshape(-1)
        sigma = state.sigmas[[index_for_timestep(state.timesteps, t) for t in ts]]
        alpha_t, sigma_t = self._alpha_sigma_t(sigma)
        dtype, ndim = original_samples.dtype, original_samples.ndim
        alpha_t = broadcast_to_left(alpha_t.to(device=original_samples.device, dtype=dtype), ndim)
        sigma_t = broadcast_to_left(sigma_t.to(device=original_samples.device, dtype=dtype), ndim)
        return alpha_t * original_samples + sigma_t * noise

    def __len__(self):
        return self.config.num_train_timesteps

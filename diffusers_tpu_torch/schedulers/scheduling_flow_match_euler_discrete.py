"""Flow-matching Euler sampler (rectified flow; the Flux/SD3 scheduler).

Port of `diffusers_tpu/schedulers/scheduling_flow_match_euler_discrete.py`:
static shift, dynamic (mu) time shifting, the shift-terminal stretch, and the
Euler step ``x <- x + (sigma_next - sigma) v``. The sigma and timestep tables
are built in numpy on the host exactly as in JAX (float32 with float64
inputs) and kept as float32 host tensors; only `step` runs in torch, in
float32, casting `prev_sample` to the model output's dtype; `scale_noise`, the forward
process of the image-conditioned SD3 pipelines, likewise. `step`
also takes per-token timesteps (the LTX condition pipeline's). The Karras,
exponential and beta ladders convert the shifted sigmas, as in JAX. With
`stochastic_sampling` a step re-noises the x0 prediction to the next sigma
with `variance_noise`, or a draw from `generator`, and raises with neither,
as JAX's does without a PRNG key.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..configuration_utils import ConfigMixin, register_to_config
from ..utils import BaseOutput
from .scheduling_utils import SchedulerMixin, broadcast_to_left, index_for_timestep, step_noise
from .sigma_utils import convert_to_beta, convert_to_exponential, convert_to_karras


@dataclass
class FlowMatchEulerDiscreteSchedulerState:
    timesteps: torch.Tensor  # float32 [S], host
    sigmas: torch.Tensor  # float32 [S+1], host
    init_noise_sigma: float = 1.0
    num_inference_steps: Optional[int] = None


@dataclass
class FlowMatchEulerDiscreteSchedulerOutput(BaseOutput):
    prev_sample: torch.Tensor
    state: Optional[FlowMatchEulerDiscreteSchedulerState] = None


class FlowMatchEulerDiscreteScheduler(SchedulerMixin, ConfigMixin):
    """Euler sampler for rectified-flow models."""

    _compatibles = []
    order = 1

    @register_to_config
    def __init__(
        self,
        num_train_timesteps: int = 1000,
        shift: float = 1.0,
        use_dynamic_shifting: bool = False,
        base_shift: Optional[float] = 0.5,
        max_shift: Optional[float] = 1.15,
        base_image_seq_len: int = 256,
        max_image_seq_len: int = 4096,
        invert_sigmas: bool = False,
        shift_terminal: Optional[float] = None,
        use_karras_sigmas: bool = False,
        use_exponential_sigmas: bool = False,
        use_beta_sigmas: bool = False,
        time_shift_type: str = "exponential",
        stochastic_sampling: bool = False,
    ):
        if time_shift_type not in ("exponential", "linear"):
            raise ValueError("`time_shift_type` must be 'exponential' or 'linear'.")
        timesteps = np.linspace(1, num_train_timesteps, num_train_timesteps, dtype=np.float32)[::-1].copy()
        sigmas = timesteps / num_train_timesteps
        if not use_dynamic_shifting:
            sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
        self.sigma_min = float(sigmas[-1])
        self.sigma_max = float(sigmas[0])

    def time_shift(self, mu: float, sigma: float, t: np.ndarray) -> np.ndarray:
        if self.config.time_shift_type == "exponential":
            return math.exp(mu) / (math.exp(mu) + (1 / t - 1) ** sigma)
        return mu / (mu + (1 / t - 1) ** sigma)

    def stretch_shift_to_terminal(self, t: np.ndarray) -> np.ndarray:
        one_minus_z = 1 - t
        scale_factor = one_minus_z[-1] / (1 - self.config.shift_terminal)
        return 1 - (one_minus_z / scale_factor)

    def set_timesteps(
        self,
        num_inference_steps: Optional[int] = None,
        sigmas: Optional[List[float]] = None,
        mu: Optional[float] = None,
        timesteps: Optional[List[float]] = None,
    ) -> FlowMatchEulerDiscreteSchedulerState:
        if self.config.use_dynamic_shifting and mu is None:
            raise ValueError("`mu` must be passed when `use_dynamic_shifting` is True")
        if sigmas is not None and timesteps is not None and len(sigmas) != len(timesteps):
            raise ValueError("`sigmas` and `timesteps` should have the same length")
        if num_inference_steps is None:
            num_inference_steps = len(sigmas) if sigmas is not None else len(timesteps)

        if sigmas is None:
            if timesteps is None:
                n = self.config.num_train_timesteps
                timesteps = np.linspace(self.sigma_max * n, self.sigma_min * n, num_inference_steps)
            else:
                timesteps = np.array(timesteps).astype(np.float32)
            sigmas = timesteps / self.config.num_train_timesteps
        else:
            sigmas = np.array(sigmas).astype(np.float32)
            num_inference_steps = len(sigmas)

        if self.config.use_dynamic_shifting:
            sigmas = self.time_shift(mu, 1.0, sigmas)
        else:
            sigmas = self.config.shift * sigmas / (1 + (self.config.shift - 1) * sigmas)
        if self.config.shift_terminal:
            sigmas = self.stretch_shift_to_terminal(sigmas)
        ladder = (convert_to_karras if self.config.use_karras_sigmas else convert_to_exponential
                  if self.config.use_exponential_sigmas else convert_to_beta if self.config.use_beta_sigmas else None)
        if ladder is not None:
            sigmas = ladder(sigmas, num_inference_steps)

        sigmas = np.asarray(sigmas, dtype=np.float32)
        timesteps = sigmas * self.config.num_train_timesteps
        if self.config.invert_sigmas:
            sigmas = 1.0 - sigmas
            timesteps = sigmas * self.config.num_train_timesteps
            sigmas = np.concatenate([sigmas, [1.0]]).astype(np.float32)
        else:
            sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)

        return FlowMatchEulerDiscreteSchedulerState(
            timesteps=torch.from_numpy(np.asarray(timesteps, dtype=np.float32)),
            sigmas=torch.from_numpy(sigmas),
            init_noise_sigma=1.0,
            num_inference_steps=num_inference_steps,
        )

    def scale_model_input(self, state, sample: torch.Tensor, timestep=None) -> torch.Tensor:
        return sample

    def scale_noise(self, state: FlowMatchEulerDiscreteSchedulerState, sample: torch.Tensor, timestep,
                    noise: torch.Tensor) -> torch.Tensor:
        """The forward process of rectified flow, ``sigma * noise + (1 - sigma)
        * sample``, one t per batch row (or one for all); each t is a value of
        the schedule, found by equality (JAX `scale_noise`)."""
        ts = torch.as_tensor(timestep, dtype=state.timesteps.dtype).reshape(-1)
        sigma = state.sigmas[[index_for_timestep(state.timesteps, t) for t in ts]]
        sigma = broadcast_to_left(sigma.to(device=sample.device, dtype=sample.dtype), sample.ndim)
        return sigma * noise + (1.0 - sigma) * sample

    def step(
        self,
        state: FlowMatchEulerDiscreteSchedulerState,
        model_output: torch.Tensor,
        timestep,
        sample: torch.Tensor,
        per_token_timesteps: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        variance_noise: Optional[torch.Tensor] = None,
        return_dict: bool = True,
    ):
        """``x + (sigma_next - sigma) v`` in float32, cast to the model
        output's dtype; with `stochastic_sampling`, ``(1 - sigma_next) x0 +
        sigma_next noise`` with ``x0 = x - sigma v``. With
        `per_token_timesteps` ([B, S], train-timestep units; the LTX
        condition pipeline's), each token of ``[B, S, C]`` steps from its own
        sigma to the largest sigma of the schedule strictly below it, or 0
        (JAX `:164-191`)."""
        if per_token_timesteps is not None:
            sigma = per_token_timesteps.float() / self.config.num_train_timesteps  # [B, S]
            grid = state.sigmas.to(device=sigma.device, dtype=torch.float32)[:, None, None]
            zero = torch.zeros((), dtype=torch.float32, device=sigma.device)
            sigma_next = torch.where(grid < sigma[None] - 1e-6, grid, zero).amax(dim=0)[..., None]
            sigma = sigma[..., None]
            dt = sigma_next - sigma
        else:
            idx = index_for_timestep(state.timesteps, timestep)
            sigma, sigma_next = state.sigmas[idx], state.sigmas[idx + 1]
            dt = float(sigma_next - sigma)  # f32 difference, as in JAX
            sigma, sigma_next = float(sigma), float(sigma_next)
        if self.config.stochastic_sampling:
            x0 = sample.float() - sigma * model_output.float()
            noise = step_noise(variance_noise, generator, sample, "stochastic_sampling")
            prev_sample = ((1.0 - sigma_next) * x0 + sigma_next * noise).to(model_output.dtype)
        else:
            prev_sample = (sample.float() + dt * model_output.float()).to(model_output.dtype)
        if not return_dict:
            return (prev_sample,)
        return FlowMatchEulerDiscreteSchedulerOutput(prev_sample=prev_sample, state=state)

    def __len__(self):
        return self.config.num_train_timesteps


def calculate_shift(
    image_seq_len: int,
    base_seq_len: int = 256,
    max_seq_len: int = 4096,
    base_shift: float = 0.5,
    max_shift: float = 1.15,
) -> float:
    """Resolution-dependent mu for dynamic time shifting."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b

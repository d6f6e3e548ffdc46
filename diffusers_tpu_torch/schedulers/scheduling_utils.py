"""Scheduler base and beta-schedule builders.

Port of `diffusers_tpu/schedulers/scheduling_utils.py`. The scheduler
contract stays the JAX package's: `set_timesteps` returns a state object that
`scale_model_input` and `step` take. The ladders are built once in numpy on
the host, as in JAX; only the per-step arithmetic on samples runs in torch,
in an eager Python loop (the JAX pipeline's `lax.scan`).
"""

from __future__ import annotations

import math
from enum import Enum
from typing import List

import numpy as np
import torch

from ..configuration_utils import ConfigMixin

SCHEDULER_CONFIG_NAME = "scheduler_config.json"


class KarrasDiffusionSchedulers(Enum):
    """Swap-compatible scheduler families."""

    DDIMScheduler = 1
    DDPMScheduler = 2
    PNDMScheduler = 3
    LMSDiscreteScheduler = 4
    EulerDiscreteScheduler = 5
    HeunDiscreteScheduler = 6
    EulerAncestralDiscreteScheduler = 7
    DPMSolverMultistepScheduler = 8
    DPMSolverSinglestepScheduler = 9
    KDPM2DiscreteScheduler = 10
    KDPM2AncestralDiscreteScheduler = 11
    DEISMultistepScheduler = 12
    UniPCMultistepScheduler = 13
    DPMSolverSDEScheduler = 14
    EDMEulerScheduler = 15


class SchedulerMixin(ConfigMixin):
    """Save/load + compatibility surface shared by all schedulers."""

    config_name = SCHEDULER_CONFIG_NAME
    _compatibles: List[str] = []
    has_compatibles = True
    order = 1

    def save_pretrained(self, save_directory, **kwargs):
        self.save_config(save_directory=save_directory, **kwargs)


def betas_for_alpha_bar(
    num_diffusion_timesteps: int,
    max_beta: float = 0.999,
    alpha_transform_type: str = "cosine",
) -> np.ndarray:
    if alpha_transform_type == "cosine":

        def alpha_bar_fn(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    elif alpha_transform_type == "exp":

        def alpha_bar_fn(t):
            return math.exp(t * -12.0)

    elif alpha_transform_type == "laplace":

        def alpha_bar_fn(t):
            lmb = -0.5 * math.copysign(1, 0.5 - t) * math.log(1 - 2 * math.fabs(0.5 - t) + 1e-6)
            snr = math.exp(lmb)
            return math.sqrt(snr / (1 + snr))

    else:
        raise ValueError(f"Unsupported alpha_transform_type: {alpha_transform_type}")

    betas = [
        min(1 - alpha_bar_fn((i + 1) / num_diffusion_timesteps) / alpha_bar_fn(i / num_diffusion_timesteps), max_beta)
        for i in range(num_diffusion_timesteps)
    ]
    return np.array(betas, dtype=np.float32)


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Zero-terminal-SNR beta rescale (https://huggingface.co/papers/2305.08891 alg. 1)."""
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_bar_sqrt = np.sqrt(alphas_cumprod)

    alphas_bar_sqrt_0 = alphas_bar_sqrt[0].copy()
    alphas_bar_sqrt_T = alphas_bar_sqrt[-1].copy()

    alphas_bar_sqrt = alphas_bar_sqrt - alphas_bar_sqrt_T
    alphas_bar_sqrt = alphas_bar_sqrt * alphas_bar_sqrt_0 / (alphas_bar_sqrt_0 - alphas_bar_sqrt_T)

    alphas_bar = alphas_bar_sqrt**2
    alphas = alphas_bar[1:] / alphas_bar[:-1]
    alphas = np.concatenate([alphas_bar[0:1], alphas])
    return (1 - alphas).astype(np.float32)


def make_beta_schedule(
    beta_schedule: str,
    num_train_timesteps: int,
    beta_start: float,
    beta_end: float,
    trained_betas=None,
) -> np.ndarray:
    """The common beta ladders: linear / scaled_linear / squaredcos_cap_v2 /
    sigmoid / laplace / exp."""
    if trained_betas is not None:
        return np.asarray(trained_betas, dtype=np.float32)
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float32)
    if beta_schedule == "scaled_linear":
        return np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float32) ** 2
    if beta_schedule == "squaredcos_cap_v2":
        return betas_for_alpha_bar(num_train_timesteps)
    if beta_schedule == "laplace":
        return betas_for_alpha_bar(num_train_timesteps, alpha_transform_type="laplace")
    if beta_schedule == "exp":
        return betas_for_alpha_bar(num_train_timesteps, alpha_transform_type="exp")
    if beta_schedule == "sigmoid":
        betas = np.linspace(-6, 6, num_train_timesteps, dtype=np.float32)
        return 1 / (1 + np.exp(-betas)) * (beta_end - beta_start) + beta_start
    raise NotImplementedError(f"beta_schedule '{beta_schedule}' is not implemented")


def make_spaced_timesteps(
    num_inference_steps: int,
    num_train_timesteps: int,
    timestep_spacing: str,
    steps_offset: int = 0,
) -> np.ndarray:
    """'linspace' / 'leading' / 'trailing' timestep selection, Table 2 of
    https://huggingface.co/papers/2305.08891, as the JAX package's."""
    if timestep_spacing == "linspace":
        return np.linspace(0, num_train_timesteps - 1, num_inference_steps).round()[::-1].copy().astype(np.int64)
    if timestep_spacing == "leading":
        step_ratio = num_train_timesteps // num_inference_steps
        timesteps = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].copy().astype(np.int64)
        return timesteps + steps_offset
    if timestep_spacing == "trailing":
        step_ratio = num_train_timesteps / num_inference_steps
        timesteps = np.round(np.arange(num_train_timesteps, 0, -step_ratio)).astype(np.int64)
        return timesteps - 1
    raise ValueError(f"timestep_spacing '{timestep_spacing}' must be 'linspace', 'leading' or 'trailing'")


def broadcast_to_left(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """Append trailing singleton dims so a per-batch scalar broadcasts over a
    sample of rank `ndim`."""
    return x.reshape(x.shape + (1,) * (ndim - x.ndim))


def sqrt_alpha_terms(alphas_cumprod, sample: torch.Tensor, timesteps):
    """(sqrt(a_t), sqrt(1 - a_t)) of a cumulative-alpha table (a tensor or
    numpy array) at `timesteps`, one per batch element, broadcast over
    `sample`: the table is cast to the sample's dtype first, as in JAX (the
    `add_noise` and `get_velocity` of DDPM, DDIM and PNDM)."""
    acp = torch.as_tensor(alphas_cumprod).to(device=sample.device, dtype=sample.dtype)
    acp = acp[torch.as_tensor(timesteps, device=sample.device)]
    return broadcast_to_left(acp**0.5, sample.ndim), broadcast_to_left((1 - acp) ** 0.5, sample.ndim)


def index_for_timestep(timesteps: torch.Tensor, timestep) -> int:
    """Position of `timestep` in the (descending) inference schedule. The
    schedule lives on the host, so this never waits for the device."""
    return int(torch.argmax((timesteps == float(timestep)).int()))

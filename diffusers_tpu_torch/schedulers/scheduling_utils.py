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

    @property
    def compatibles(self):
        return [self.__class__]


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


def threshold_sample(sample: torch.Tensor, ratio: float, max_value: float) -> torch.Tensor:
    """Dynamic thresholding (Imagen): each row clipped to its `ratio`
    quantile of |x| (at least 1, at most `max_value`) and divided by it."""
    flat = sample.float().reshape(sample.shape[0], -1)
    s = torch.quantile(flat.abs(), ratio, dim=1).clamp(1, max_value)[:, None]
    return (torch.maximum(torch.minimum(flat, s), -s) / s).reshape(sample.shape).to(sample.dtype)


def step_noise(variance_noise, generator, like: torch.Tensor, what: str) -> torch.Tensor:
    """A step's standard-normal noise in float32 on `like`'s device: the
    injected `variance_noise`, else a draw from `generator`; with neither the
    step raises, as JAX's does without a PRNG key."""
    if variance_noise is not None:
        return variance_noise.to(device=like.device, dtype=torch.float32)
    if generator is None:
        raise ValueError(f"{what} requires a generator or variance_noise")
    return torch.randn(tuple(like.shape), generator=generator, device=generator.device,
                       dtype=torch.float32).to(like.device)


def vp_alpha_sigma(sigma: torch.Tensor):
    """(alpha_t, sigma_t) of a variance-preserving sigma, on the host in float32."""
    alpha_t = 1 / ((sigma**2 + 1) ** 0.5)
    return alpha_t, sigma * alpha_t


def log_snr(alpha_t: torch.Tensor, sigma_t: torch.Tensor) -> torch.Tensor:
    """lambda = log(alpha_t) - log(sigma_t), sigma_t floored at 1e-20."""
    return torch.log(alpha_t) - torch.log(torch.clamp_min(sigma_t, 1e-20))


def add_vp_noise(state, original_samples: torch.Tensor, noise: torch.Tensor, timesteps,
                 alpha_sigma=vp_alpha_sigma) -> torch.Tensor:
    """``alpha_t x + sigma_t noise`` at each row's timestep, found in the
    schedule by equality (the first entry when absent, as JAX's argmax); the
    coefficients are cast to the sample's dtype first, as in JAX (the
    `add_noise` of the DPM-Solver family)."""
    ts = torch.as_tensor(timesteps).reshape(-1)
    alpha_t, sigma_t = alpha_sigma(state.sigmas[[index_for_timestep(state.timesteps, t) for t in ts]])
    dtype, ndim, device = original_samples.dtype, original_samples.ndim, original_samples.device
    alpha_t = broadcast_to_left(alpha_t.to(device=device, dtype=dtype), ndim)
    sigma_t = broadcast_to_left(sigma_t.to(device=device, dtype=dtype), ndim)
    return alpha_t * original_samples + sigma_t * noise


def index_for_timestep(timesteps: torch.Tensor, timestep) -> int:
    """Position of `timestep` in the (descending) inference schedule. The
    schedule lives on the host, so this never waits for the device."""
    return int(torch.argmax((timesteps == float(timestep)).int()))


# ------------------------------------------- the k-diffusion samplers


def k_spaced_timesteps(spacing: str, num_inference_steps: int, num_train_timesteps: int,
                       steps_offset: int) -> np.ndarray:
    """The k-diffusion samplers' float32 timesteps: linspace, leading or trailing."""
    if spacing == "linspace":
        return np.linspace(0, num_train_timesteps - 1, num_inference_steps, dtype=np.float32)[::-1].copy()
    if spacing == "leading":
        step_ratio = num_train_timesteps // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].copy().astype(np.float32)
        return ts + steps_offset
    if spacing == "trailing":
        step_ratio = num_train_timesteps / num_inference_steps
        return (np.arange(num_train_timesteps, 0, -step_ratio)).round().copy().astype(np.float32) - 1
    raise ValueError(f"unsupported timestep_spacing {spacing}")


def k_init_noise_sigma(sigmas: np.ndarray, spacing: str) -> float:
    return float(sigmas.max()) if spacing in ("linspace", "trailing") else float((sigmas.max() ** 2 + 1) ** 0.5)


def k_pred_original(kind: str, model_output: torch.Tensor, sample: torch.Tensor, sigma: torch.Tensor,
                    allow_sample: bool = True) -> torch.Tensor:
    """x0 of a k-diffusion model output at `sigma` (a float32 host scalar)."""
    if kind == "epsilon":
        return sample - float(sigma) * model_output
    if kind == "v_prediction":
        return model_output * float(-sigma / (sigma**2 + 1) ** 0.5) + sample / float(sigma**2 + 1)
    if kind == "sample" and allow_sample:
        return model_output
    raise ValueError(f"unsupported prediction_type {kind}")


def add_sigma_noise(state, original_samples: torch.Tensor, noise: torch.Tensor, timesteps) -> torch.Tensor:
    """``x + noise * sigma(t)``, one t per batch row (or one for all), each a
    value of the schedule found by equality (JAX's `add_noise` of the
    k-diffusion samplers)."""
    ts = torch.as_tensor(timesteps, dtype=state.timesteps.dtype).reshape(-1)
    sigma = state.sigmas[[index_for_timestep(state.timesteps, t) for t in ts]]
    sigma = broadcast_to_left(sigma.to(device=original_samples.device, dtype=original_samples.dtype),
                              original_samples.ndim)
    return original_samples + noise * sigma

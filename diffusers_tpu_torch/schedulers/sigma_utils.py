"""Sigma-schedule converters shared across k-diffusion-style samplers.

Port of `diffusers_tpu/schedulers/sigma_utils.py`, kept as the port's own
copy. Numpy only: the ladders are built on the host at `set_timesteps`
time. The rules are k-diffusion's (crowsonkb/k-diffusion): Karras et al.
(2022) rho-spaced sigmas, log-uniform (exponential) sigmas, beta-distribution
spaced sigmas, and the piecewise log-linear inversion of a sigma back to a
fractional training timestep."""

from __future__ import annotations

import numpy as np


def sigma_to_t(sigma: np.ndarray, log_sigmas: np.ndarray) -> np.ndarray:
    """Invert the sigma ladder: piecewise-log-linear interpolation back to a
    (fractional) training timestep."""
    log_sigma = np.log(np.maximum(sigma, 1e-10))
    dists = log_sigma - log_sigmas[:, np.newaxis]
    low_idx = np.cumsum((dists >= 0), axis=0).argmax(axis=0).clip(max=log_sigmas.shape[0] - 2)
    high_idx = low_idx + 1
    low = log_sigmas[low_idx]
    high = log_sigmas[high_idx]
    w = np.clip((low - log_sigma) / (low - high), 0, 1)
    t = (1 - w) * low_idx + w * high_idx
    return t.reshape(np.shape(sigma))


def convert_to_karras(
    in_sigmas: np.ndarray,
    num_inference_steps: int,
    sigma_min: float | None = None,
    sigma_max: float | None = None,
    rho: float = 7.0,
) -> np.ndarray:
    """Karras et al. (2022) rho-spaced sigma ladder."""
    sigma_min = sigma_min if sigma_min is not None else float(in_sigmas[-1])
    sigma_max = sigma_max if sigma_max is not None else float(in_sigmas[0])
    ramp = np.linspace(0, 1, num_inference_steps)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    return (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho


def convert_to_exponential(
    in_sigmas: np.ndarray,
    num_inference_steps: int,
    sigma_min: float | None = None,
    sigma_max: float | None = None,
) -> np.ndarray:
    sigma_min = sigma_min if sigma_min is not None else float(in_sigmas[-1])
    sigma_max = sigma_max if sigma_max is not None else float(in_sigmas[0])
    return np.exp(np.linspace(np.log(sigma_max), np.log(sigma_min), num_inference_steps))


def convert_to_beta(
    in_sigmas: np.ndarray,
    num_inference_steps: int,
    sigma_min: float | None = None,
    sigma_max: float | None = None,
    alpha: float = 0.6,
    beta: float = 0.6,
) -> np.ndarray:
    """Beta-distribution-spaced sigmas (https://huggingface.co/papers/2407.12173)."""
    import scipy.stats

    sigma_min = sigma_min if sigma_min is not None else float(in_sigmas[-1])
    sigma_max = sigma_max if sigma_max is not None else float(in_sigmas[0])
    return np.array(
        [
            sigma_min + (ppf * (sigma_max - sigma_min))
            for ppf in [
                scipy.stats.beta.ppf(timestep, alpha, beta)
                for timestep in 1 - np.linspace(0, 1, num_inference_steps)
            ]
        ]
    )

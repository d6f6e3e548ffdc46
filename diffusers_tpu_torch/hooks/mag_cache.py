"""MagCache: magnitude-guided residual caching (https://github.com/Zehong-Ma/MagCache).

Port of `diffusers_tpu/hooks/mag_cache.py`. The whole transformer block
stack is skipped when the accumulated magnitude-ratio error stays under
`threshold`, reusing the previous computed step's block-stack residual
(`out = in + prev_residual`). The decision depends only on the step index
and the calibrated `mag_ratios`, so the schedule is made on the host
(`mag_cache_compute_mask`); a skipped step runs no block.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# Published calibration for Flux (Dev/Schnell)
FLUX_MAG_RATIOS = np.array(
    [1.0, 1.21094, 1.11719, 1.07812, 1.0625, 1.03906, 1.03125, 1.03906, 1.02344,
     1.03125, 1.02344, 0.98047, 1.01562, 1.00781, 1.0, 1.00781, 1.0, 1.00781,
     1.0, 1.0, 0.99609, 0.99609, 0.98047, 0.98828, 0.96484, 0.95703, 0.93359,
     0.89062],
    dtype=np.float64,
)


def nearest_interp(src: np.ndarray, target_length: int) -> np.ndarray:
    """Nearest-neighbour resample of the calibration ladder to the actual
    step count."""
    src = np.asarray(src, dtype=np.float64)
    if target_length == 1:
        return src[-1:]
    scale = (len(src) - 1) / (target_length - 1)
    idx = np.round(np.arange(target_length) * scale).astype(np.int64)
    return src[idx]


@dataclass(frozen=True)
class MagCacheConfig:
    """`mag_ratios` are checkpoint-dependent: use FLUX_MAG_RATIOS for Flux,
    or run with `calibrate=True` and feed the logged ratios back."""

    threshold: float = 0.06
    max_skip_steps: int = 3
    retention_ratio: float = 0.2
    num_inference_steps: int = 28
    mag_ratios: Optional[Tuple[float, ...]] = None
    calibrate: bool = False

    def __post_init__(self):
        if self.mag_ratios is None and not self.calibrate:
            raise ValueError(
                "mag_ratios must be provided for MagCache inference (they are "
                "model-dependent); run once with calibrate=True to obtain them, "
                "or use FLUX_MAG_RATIOS for Flux models."
            )


def mag_cache_compute_mask(config: MagCacheConfig) -> np.ndarray:
    """bool[num_steps]: True where the block stack must be computed."""
    n = config.num_inference_steps
    if config.calibrate:
        return np.ones(n, dtype=bool)
    ratios = nearest_interp(np.asarray(config.mag_ratios, dtype=np.float64), n)
    retention_step = int(config.retention_ratio * n + 0.5)
    compute = np.ones(n, dtype=bool)
    acc_ratio, acc_err, acc_steps = 1.0, 0.0, 0
    have_residual = False
    for step in range(n):
        scale = ratios[step] if step < len(ratios) else 1.0
        should_compute = True
        if step >= retention_step:
            acc_ratio *= scale
            acc_steps += 1
            acc_err += abs(1.0 - acc_ratio)
            if have_residual and acc_err <= config.threshold and acc_steps <= config.max_skip_steps:
                should_compute = False
            else:
                acc_ratio, acc_err, acc_steps = 1.0, 0.0, 0
        compute[step] = should_compute
        if should_compute:
            have_residual = True
    return compute


@dataclass
class MagCacheState:
    residual_hidden: torch.Tensor  # block-stack residual (out - in) at the last computed step
    residual_context: torch.Tensor


def init_mag_cache_state(hidden_shape, context_shape, dtype=torch.float32, device=None) -> MagCacheState:
    return MagCacheState(
        residual_hidden=torch.zeros(hidden_shape, dtype=dtype, device=device),
        residual_context=torch.zeros(context_shape, dtype=dtype, device=device),
    )


def flux_forward_with_magcache(
    model,
    mc_state: MagCacheState,
    compute: bool,  # from the host-made mask
    hidden_states: torch.Tensor,
    encoder_hidden_states: torch.Tensor,
    pooled_projections: torch.Tensor,
    timestep: torch.Tensor,
    image_rotary_emb: Tuple[torch.Tensor, torch.Tensor],
    guidance: Optional[torch.Tensor] = None,
    context: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, MagCacheState]:
    """FluxTransformer2DModel forward with the block stack under MagCache.
    A skipped step replays `in + prev_residual`; the timestep-conditioned
    `norm_out` / `proj_out` still run."""
    hidden, context, temb, rope = model.embed(hidden_states, encoder_hidden_states, pooled_projections, timestep,
                                              guidance, image_rotary_emb=image_rotary_emb, context=context)
    if compute:
        h_in, c_in = hidden, context
        hidden, context = model.run_blocks(hidden, context, temb, rope)
        mc_state = MagCacheState(residual_hidden=hidden - h_in, residual_context=context - c_in)
    else:
        hidden = hidden + mc_state.residual_hidden  # the replayed context is not read again
    return model.project_out(hidden, temb), mc_state


def mag_cache_calibrate_ratios(residual_norms: Sequence[float]) -> List[float]:
    """Turn per-step block-stack residual norms (|out - in|, collected over
    one uncached run) into the `mag_ratios` ladder (ratios of consecutive
    residual magnitudes)."""
    norms = np.asarray(list(residual_norms), dtype=np.float64)
    if len(norms) < 2:
        return [1.0] * len(norms)
    ratios = np.concatenate([[1.0], norms[1:] / np.maximum(norms[:-1], 1e-12)])
    return [float(r) for r in ratios]

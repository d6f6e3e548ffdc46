"""Pyramid Attention Broadcast (PAB): reuse attention outputs across denoise
steps (arXiv:2408.12588).

Port of `diffusers_tpu/hooks/pyramid_attention_broadcast.py`. Whether a step
recomputes attention depends only on the timestep schedule, so the pattern
is made on the host (`pab_compute_mask`). The per-block attention outputs
are a stacked cache that the Flux transformer's forward takes and returns
(`pab_compute`, `pab_cache`); on a broadcast step no block runs its
attention (nor its projections), while the MLPs still run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class PyramidAttentionBroadcastConfig:
    """`spatial_attention_block_skip_range = N`: attention recomputes every
    N-th step inside the timestep window, reusing the cache for the N - 1
    between."""

    spatial_attention_block_skip_range: int = 2
    spatial_attention_timestep_skip_range: Tuple[int, int] = (100, 800)
    cross_attention_block_skip_range: Optional[int] = None
    cross_attention_timestep_skip_range: Tuple[int, int] = (100, 800)


def pab_compute_mask(
    timesteps: np.ndarray,
    block_skip_range: int,
    timestep_skip_range: Tuple[int, int],
) -> np.ndarray:
    """bool[num_steps]: True where attention must be recomputed (the
    iteration counter is the step index: one forward a step)."""
    t = np.asarray(timesteps, dtype=np.float64)
    it = np.arange(len(t))
    within = (timestep_skip_range[0] < t) & (t < timestep_skip_range[1])
    compute = (it == 0) | (~within) | (it % block_skip_range == 0)
    return compute

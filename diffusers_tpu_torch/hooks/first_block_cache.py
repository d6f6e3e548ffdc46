"""First-block cache (FBC) for the Flux and SD3 transformers.

Port of `diffusers_tpu/hooks/first_block_cache.py`: when the first
transformer block's residual barely changes between denoise steps (relative
mean-abs change at most `threshold`), the remaining blocks are skipped and
the cached tail residual is reused. Flux's form (`flux_forward_with_fbc`)
caches the residuals of both streams; the single-stream form
(`FBCSingleState`, `fbc_single_gate`, JAX `:61-110`) caches the hidden
stream's alone, for a model that runs the head/tail split in its own forward
(`SD3Transformer2DModel` with `fbc_state`).

JAX decides on the device inside a `lax.cond`. Here the decision is read on
the host once a step (one sync), and only the branch taken runs: a skipped
step runs the prologue, the first block and the epilogue. The first step
computes without reading anything. Each step's decision and relative
change are recorded on the state (`decisions`, `ratios`; a ratio stays a
device scalar until the caller reads it).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch


@dataclass(frozen=True)
class FirstBlockCacheConfig:
    """threshold: higher means more aggressive caching."""

    threshold: float = 0.05


@dataclass
class FBCState:
    prev_first_residual: torch.Tensor  # the first block's hidden residual at the last computed step
    tail_residual_hidden: torch.Tensor  # final hidden - hidden after the first block, at the last computed step
    tail_residual_context: torch.Tensor
    valid: bool = False  # True after the first step
    decisions: List[bool] = field(default_factory=list)
    ratios: List[Optional[torch.Tensor]] = field(default_factory=list)


def init_fbc_state(hidden_shape, context_shape, dtype=torch.float32, device=None) -> FBCState:
    return FBCState(
        prev_first_residual=torch.zeros(hidden_shape, dtype=dtype, device=device),
        tail_residual_hidden=torch.zeros(hidden_shape, dtype=dtype, device=device),
        tail_residual_context=torch.zeros(context_shape, dtype=dtype, device=device),
    )


def fbc_relative_change(state, first_residual: torch.Tensor) -> torch.Tensor:
    """Relative mean-abs change of the first block's residual against the last
    computed step's, in the residual's dtype (a device scalar)."""
    diff = torch.mean(torch.abs(first_residual - state.prev_first_residual))
    prev_mean = torch.mean(torch.abs(state.prev_first_residual))
    return diff / torch.clamp_min(prev_mean, 1e-12)


def fbc_should_compute(state: FBCState, config: FirstBlockCacheConfig, first_residual: torch.Tensor) -> torch.Tensor:
    """The skip decision as a device bool: compute when the state is not
    valid yet or the relative change exceeds the threshold."""
    return (fbc_relative_change(state, first_residual) > config.threshold) | (not state.valid)


@dataclass
class FBCSingleState:
    prev_first_residual: torch.Tensor  # the first block's residual at the last computed step
    tail_residual: torch.Tensor  # final hidden - hidden after the first block, at the last computed step
    valid: bool = False  # True after the first step
    decisions: List[bool] = field(default_factory=list)
    ratios: List[Optional[torch.Tensor]] = field(default_factory=list)


def init_fbc_single_state(hidden_shape, dtype=torch.float32, device=None) -> FBCSingleState:
    return FBCSingleState(prev_first_residual=torch.zeros(hidden_shape, dtype=dtype, device=device),
                          tail_residual=torch.zeros(hidden_shape, dtype=dtype, device=device))


def _decide(state, config: FirstBlockCacheConfig, first_residual: torch.Tensor) -> bool:
    """The step's decision, recorded on the state with its ratio: compute
    when the state is not valid yet (no read) or the relative change exceeds
    the threshold (the step's one host sync)."""
    if state.valid:
        ratio = fbc_relative_change(state, first_residual)
        should_compute = bool(ratio > config.threshold)
    else:
        ratio, should_compute = None, True
    state.decisions.append(should_compute)
    state.ratios.append(ratio)
    return should_compute


def fbc_single_gate(state: FBCSingleState, config: FirstBlockCacheConfig, first_residual: torch.Tensor,
                    hidden: torch.Tensor, tail_fn) -> Tuple[torch.Tensor, FBCSingleState]:
    """Run `tail_fn(hidden) -> final hidden` or replay the cached tail
    residual. Returns (final hidden, new state)."""
    if not _decide(state, config, first_residual):
        return hidden + state.tail_residual, state
    out = tail_fn(hidden)
    return out, FBCSingleState(prev_first_residual=first_residual, tail_residual=out - hidden, valid=True,
                               decisions=state.decisions, ratios=state.ratios)


def flux_forward_with_fbc(
    model,
    fbc_state: FBCState,
    config: FirstBlockCacheConfig,
    hidden_states: torch.Tensor,
    encoder_hidden_states: torch.Tensor,
    pooled_projections: torch.Tensor,
    timestep: torch.Tensor,
    image_rotary_emb: Tuple[torch.Tensor, torch.Tensor],
    guidance: Optional[torch.Tensor] = None,
    context: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, FBCState]:
    """FluxTransformer2DModel forward with first-block caching. Returns
    (sample, new state)."""
    hidden, context, temb, rope = model.embed(hidden_states, encoder_hidden_states, pooled_projections, timestep,
                                              guidance, image_rotary_emb=image_rotary_emb, context=context)
    first_in = hidden
    context, hidden = model.transformer_blocks[0](hidden, context, temb, rope)
    first_residual = hidden - first_in

    if _decide(fbc_state, config, first_residual):
        after_first_hidden, after_first_context = hidden, context
        hidden, context = model.run_blocks(hidden, context, temb, rope, first=1)
        fbc_state = FBCState(
            prev_first_residual=first_residual,
            tail_residual_hidden=hidden - after_first_hidden,
            tail_residual_context=context - after_first_context,
            valid=True, decisions=fbc_state.decisions, ratios=fbc_state.ratios,
        )
    else:
        hidden = hidden + fbc_state.tail_residual_hidden  # the replayed context is not read again
    return model.project_out(hidden, temb), fbc_state

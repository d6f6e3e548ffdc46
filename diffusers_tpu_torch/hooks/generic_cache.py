"""Model-agnostic timestep caches for eager denoise loops.

Port of `diffusers_tpu/hooks/generic_cache.py`. A pipeline whose loop is

    forward(latents, i, t) -> model_output ; scheduler.step(...)

calls `denoise_loop(...)` and honours the model-agnostic configs:

  * ``TaylorSeerCacheConfig``: Taylor-extrapolated output on predicted
    steps, which make no model call;
  * ``MagCacheConfig``: the generic form replays the last computed model
    output on skipped steps, which make no model call;
  * ``TextKVCacheConfig``: the loop itself is unchanged. JAX accepts it as a
    no-op because XLA hoists the loop-invariant text K/V projections out of
    its scan; an eager loop hoists nothing, so the pipeline makes it real:
    `text_kv_cache` computes each cross-attention's K/V of the prompt
    embeddings once per request and reuses them every step.

The cached state has the latents' shape and dtype, which is the denoiser
output's in both pipelines (JAX reads it with `eval_shape`).
`denoise_loop_with_callback` is the loop that fires `callback_on_step_end`;
it takes no cache config.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .mag_cache import MagCacheConfig, mag_cache_compute_mask, nearest_interp
from .taylorseer import TaylorSeerCacheConfig, init_taylorseer_state, taylorseer_apply, taylorseer_compute_mask


@dataclass(frozen=True)
class TextKVCacheConfig:
    """Compute the text-conditioned K/V projections once per request
    (`text_kv_cache`), where JAX leaves them to XLA's loop-invariant code
    motion."""


@contextlib.contextmanager
def text_kv_cache(model: nn.Module):
    """Within the block, every attention module of `model` that has a
    `text_kv` slot keeps the K/V it computes from an `encoder_hidden_states`
    tensor and reuses them while it is called with that same tensor (the
    same object); the cache is dropped on exit."""
    modules = [m for m in model.modules() if hasattr(m, "text_kv")]
    for m in modules:
        m.text_kv = ()  # on, nothing cached yet
    try:
        yield
    finally:
        for m in modules:
            m.text_kv = None


def denoise_loop(forward, scheduler, latents, state, timesteps, cache_cfg=None):
    """Run the denoise loop step by step, honouring a model-agnostic cache.

    Args:
        forward: fn(latents, i, t) -> model_output, i the step index and t
            the timestep; CFG combination happens inside the closure.
        scheduler: scheduler with .step(state, model_output, t, sample).
        latents: initial sample.
        state: scheduler state from set_timesteps.
        timesteps: the schedule's timesteps (host tensor).
        cache_cfg: None | TaylorSeerCacheConfig | MagCacheConfig | TextKVCacheConfig.
    Returns final latents.
    """
    num_steps = int(timesteps.shape[0])
    if cache_cfg is None or isinstance(cache_cfg, TextKVCacheConfig):
        for i, t in enumerate(timesteps):
            latents = scheduler.step(state, forward(latents, i, t), t, latents).prev_sample
        return latents

    if isinstance(cache_cfg, TaylorSeerCacheConfig):
        mask = taylorseer_compute_mask(num_steps, cache_cfg)
        ts = init_taylorseer_state(latents.shape, cache_cfg.max_order, latents.dtype, latents.device)
        for i, t in enumerate(timesteps):
            pred, ts = taylorseer_apply(ts, i, bool(mask[i]), lambda: forward(latents, i, t))
            latents = scheduler.step(state, pred, t, latents).prev_sample
        return latents

    if isinstance(cache_cfg, MagCacheConfig):
        # generic form: cache the model output itself and replay it on skipped steps
        mask = mag_cache_compute_mask(cache_cfg)
        if mask.shape[0] != num_steps:
            mask = nearest_interp(mask.astype(np.float32), num_steps) > 0.5
        cached = torch.zeros_like(latents)
        for i, t in enumerate(timesteps):
            if mask[i]:
                cached = forward(latents, i, t)
            latents = scheduler.step(state, cached, t, latents).prev_sample
        return latents

    raise ValueError(
        f"denoise_loop does not support cache config {type(cache_cfg).__name__}; "
        "supported: TaylorSeerCacheConfig, MagCacheConfig, TextKVCacheConfig"
    )


def denoise_loop_with_callback(forward_cb, scheduler, latents, state, timesteps, pipe, callback, cb_tensors,
                               cache_cfg=None):
    """Denoise loop honouring `callback_on_step_end`.

    Args:
        forward_cb: fn(latents, i, t, cb: dict) -> model_output. Reads its
            conditioning tensors from `cb` each step, so a callback's
            replacements (e.g. CFG cutoff halving prompt_embeds) take effect
            from the next step.
        callback: fn(pipe, step_index, timestep, callback_kwargs) -> dict,
            fired after scheduler.step; may return "latents" and any of the
            `cb_tensors` keys.
        cb_tensors: tensors and scalars shown to the callback beside
            "latents" (e.g. "guidance_scale" for the cutoff callbacks).
    Returns final latents.
    """
    if cache_cfg is not None:
        # TextKVCacheConfig too: a callback may replace the text embeddings mid-loop
        raise ValueError(
            "callback_on_step_end cannot yet be combined with cache config "
            f"{type(cache_cfg).__name__}; disable one of them"
        )
    pipe._num_timesteps = int(timesteps.shape[0])
    cb = dict(cb_tensors)
    for i, t in enumerate(timesteps):
        latents = scheduler.step(state, forward_cb(latents, i, t, cb), t, latents).prev_sample
        out = callback(pipe, i, t, {"latents": latents, **cb}) or {}
        latents = out.pop("latents", latents)
        cb.update(out)
    return latents

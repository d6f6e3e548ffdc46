"""Training utilities: SNR, flow-matching loss, SD3 timestep densities and
weightings, aspect-ratio buckets, and the train step.

Port of `diffusers_tpu/training/train_state.py`. JAX's step is one jitted
function of (params, opt_state, batch); here the model and the optimizer
hold their state, and `make_train_step` returns a function that zeroes the
grads, runs the loss and its backward, steps the optimizer and the LR
schedule, and returns the loss. `optax.adamw(lr, weight_decay=1e-2)` is
`torch.optim.AdamW(lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2)`.
Random draws take an explicit `torch.Generator` where JAX takes a key; the
mesh-sharded step waits for the parallelism slice.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, Optional

import torch


def compute_snr(alphas_cumprod: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
    """Signal-to-noise ratio per timestep."""
    acp = alphas_cumprod.to(timesteps.device)[timesteps]
    return acp / (1 - acp)


def flow_match_loss(
    model_call: Callable,
    latents: torch.Tensor,  # [B, S, C] packed (or any shape)
    noise: torch.Tensor,
    sigmas: torch.Tensor,  # [B] in (0, 1]
    cond_kwargs: Dict[str, Any],
) -> torch.Tensor:
    """Rectified-flow MSE: the model predicts the velocity ``noise - x0`` at
    ``x_t = (1 - sigma) x0 + sigma noise``."""
    sig = sigmas.reshape(sigmas.shape + (1,) * (latents.ndim - 1))
    noisy = (1.0 - sig) * latents + sig * noise
    target = noise - latents
    pred = model_call(noisy, timestep=sigmas, **cond_kwargs)
    return torch.mean(torch.square(pred.float() - target.float()))


def timestep_density_from_draw(
    weighting_scheme: str,
    draw: torch.Tensor,
    logit_mean: float = 0.0,
    logit_std: float = 1.0,
    mode_scale: float = 1.29,
) -> torch.Tensor:
    """The SD3 timestep density (arXiv:2403.03206) applied to a draw: a
    standard normal one for ``logit_normal``, a uniform one on [0, 1)
    otherwise."""
    if weighting_scheme == "logit_normal":
        return torch.sigmoid(logit_mean + logit_std * draw)
    if weighting_scheme == "mode":
        return 1 - draw - mode_scale * (torch.cos(math.pi * draw / 2) ** 2 - 1 + draw)
    return draw


def compute_density_for_timestep_sampling(
    weighting_scheme: str,
    batch_size: int,
    generator: Optional[torch.Generator] = None,
    logit_mean: float = 0.0,
    logit_std: float = 1.0,
    mode_scale: float = 1.29,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """SD3 timestep-density sampling: u in (0, 1) per sample under the chosen
    scheme, drawn from `generator` (on its device, or `device`)."""
    device = generator.device if generator is not None else device
    if weighting_scheme == "logit_normal":
        draw = torch.randn((batch_size,), generator=generator, device=device)
    else:
        draw = torch.rand((batch_size,), generator=generator, device=device)
    return timestep_density_from_draw(weighting_scheme, draw, logit_mean, logit_std, mode_scale)


def compute_loss_weighting_for_sd3(weighting_scheme: str, sigmas: torch.Tensor) -> torch.Tensor:
    """SD3 per-sample loss weighting."""
    if weighting_scheme == "sigma_sqrt":
        return (sigmas**-2.0).float()
    if weighting_scheme == "cosmap":
        bot = 1 - 2 * sigmas + 2 * sigmas**2
        return 2 / (math.pi * bot)
    return torch.ones_like(sigmas)


# Aspect-ratio bucketing: a ladder of (h, w) with h * w close to resolution^2.

_DEFAULT_BUCKET_ASPECT_RATIOS = [
    (1, 1), (4, 5), (5, 4), (2, 3), (3, 2), (3, 4), (4, 3),
    (9, 16), (16, 9), (1, 2), (2, 1),
]


def parse_buckets_string(buckets_str: str):
    """'h1,w1;h2,w2;...' -> [(h, w), ...]."""
    if not buckets_str:
        raise ValueError("Bucket string cannot be empty.")
    parsed = []
    for pair in buckets_str.strip().split(";"):
        m = re.match(r"^\s*(\d+)\s*,\s*(\d+)\s*$", pair)
        if not m:
            raise ValueError(f"Invalid bucket format: {pair!r}. Expected 'height,width'.")
        h, w = int(m.group(1)), int(m.group(2))
        if h <= 0 or w <= 0:
            raise ValueError("Bucket dimensions must be positive integers.")
        parsed.append((h, w))
    return parsed


def find_nearest_bucket(h: int, w: int, bucket_options):
    """Index of the bucket whose aspect ratio is closest (the last on ties)."""
    best, best_idx = float("inf"), None
    for i, (bh, bw) in enumerate(bucket_options):
        metric = abs(h * bw - w * bh)
        if metric <= best:
            best, best_idx = metric, i
    return best_idx


def generate_aspect_ratio_buckets(resolution: int, divisibility: int = 16, base_resolutions=None):
    """(h, w) ladder with h * w close to resolution^2 across aspect ratios;
    each dim rounded to `divisibility`."""
    target = resolution * resolution
    ratios = ([(w, h) for (h, w) in base_resolutions]
              if base_resolutions is not None else _DEFAULT_BUCKET_ASPECT_RATIOS)
    buckets, seen = [], set()
    for rw, rh in ratios:
        aspect = rw / rh
        h = (target / aspect) ** 0.5
        w = h * aspect
        h = max(divisibility, round(h / divisibility) * divisibility)
        w = max(divisibility, round(w / divisibility) * divisibility)
        if (h, w) not in seen:
            seen.add((h, w))
            buckets.append((h, w))
    return buckets


def make_train_step(
    loss_fn: Callable[[torch.nn.Module, Dict[str, Any]], torch.Tensor],
    optimizer: torch.optim.Optimizer,
    lr_scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
):
    """Returns ``train_step(model, batch) -> loss``: zero the grads, run
    `loss_fn(model, batch)` and its backward, step the optimizer, then the LR
    schedule. The grads stay on the parameters until the next step."""

    def train_step(model: torch.nn.Module, batch: Dict[str, Any]) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        optimizer.step()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss.detach()

    return train_step

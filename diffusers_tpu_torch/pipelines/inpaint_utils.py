"""Mask and strength helpers of the image-conditioned pipelines.

Port of `diffusers_tpu/pipelines/inpaint_utils.py` (`as_mask_array`,
`resize_mask_nearest`, `repeat_to_batch`, `prepare_packed_mask`,
`check_strength_and_schedule`). Host-side numpy, except `repeat_to_batch`,
which also takes tensors, and `prepare_packed_mask`, which returns one. PIL is
imported only when a PIL mask is passed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..image_processor import VaeImageProcessor


def as_mask_array(mask_image) -> np.ndarray:
    """A mask (PIL | array [H,W] | [1,H,W] | [B,1,H,W], values in [0, 1];
    a PIL mask as grayscale / 255) -> binary float32 NCHW, 1 where the
    value is > 0.5 (`VaeImageProcessor.binarize`)."""
    if type(mask_image).__module__.startswith("PIL."):
        mask_image = np.asarray(mask_image.convert("L"), dtype=np.float32) / 255.0
    if isinstance(mask_image, torch.Tensor):
        mask_image = mask_image.detach().cpu().float().numpy()
    mask = np.asarray(mask_image, dtype=np.float32)
    if mask.ndim == 2:
        mask = mask[None, None]
    elif mask.ndim == 3:
        mask = mask[None]
    return VaeImageProcessor.binarize(mask)


def resize_mask_nearest(mask: np.ndarray, lh: int, lw: int) -> np.ndarray:
    """Nearest-neighbour resize of an NCHW mask to exactly (lh, lw), up or
    down, any ratio (the index rule of torch's `interpolate(...,
    mode="nearest")`). Where the mask's size is a multiple of (lh, lw) this
    is the strided pick `mask[:, :, ::h // lh, ::w // lw]`."""
    h, w = mask.shape[2], mask.shape[3]
    rows = (np.arange(lh) * h // lh).astype(np.intp)
    cols = (np.arange(lw) * w // lw).astype(np.intp)
    return mask[:, :, rows][:, :, :, cols]


def repeat_to_batch(x, batch_size: int, what: str = "input"):
    """Repeat a leading batch dim up to `batch_size` (each row repeated in
    place), raising when the sizes do not divide."""
    if x.shape[0] == batch_size:
        return x
    if batch_size % x.shape[0] != 0:
        raise ValueError(
            f"cannot duplicate {what} of batch size {x.shape[0]} to effective batch size "
            f"{batch_size}: not a multiple. Pass a matching number of {what}s."
        )
    reps = batch_size // x.shape[0]
    if isinstance(x, torch.Tensor):
        return x.repeat_interleave(reps, dim=0)
    return np.repeat(x, reps, axis=0)


def prepare_packed_mask(mask: np.ndarray, batch_size: int, num_channels_latents: int, lh: int, lw: int,
                        pack_fn) -> torch.Tensor:
    """A binary NCHW pixel mask -> nearest resize to the latent size ->
    repeated over the latent channels and up to `batch_size` -> `pack_fn`
    (Flux's 2 x 2 packing): a float32 tensor on the CPU."""
    m = np.repeat(resize_mask_nearest(mask, lh, lw), num_channels_latents, axis=1)
    return pack_fn(torch.from_numpy(np.ascontiguousarray(repeat_to_batch(m, batch_size, what="mask"))))


def check_strength_and_schedule(strength: float, timesteps) -> None:
    """`strength` must lie in [0, 1], and the schedule it leaves must not be
    empty."""
    if strength < 0 or strength > 1:
        raise ValueError(f"strength must be in [0, 1], got {strength}")
    if timesteps.shape[0] == 0:
        raise ValueError(
            f"strength={strength} with this step count leaves zero denoise steps; "
            "increase strength or num_inference_steps."
        )

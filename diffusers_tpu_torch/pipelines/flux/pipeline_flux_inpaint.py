"""Flux inpainting pipeline (the 16-channel transformer and a latent blend).

Port of `diffusers_tpu/pipelines/flux/pipeline_flux_inpaint.py`: img2img's
start (the posterior's sample, `scale_noise` at the strength-selected
timestep), then after each step the latents outside the mask are replaced by
the clean image latents noised to the next step's timestep, and after the
last step by the clean latents themselves. The mask (1 where the image is
repainted) is binarized at 0.5, resized to the latent size by nearest
neighbour, repeated over the latent channels and packed
(`inpaint_utils.prepare_packed_mask`). `enable_cache` raises.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from .pipeline_flux import FluxPipeline


class FluxInpaintPipeline(FluxPipeline):
    _supported_cache_configs = ()

    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        prompt_2: Optional[Union[str, List[str]]] = None,
        image=None,
        mask_image=None,
        strength: float = 0.6,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 28,
        guidance_scale: float = 7.0,
        num_images_per_prompt: int = 1,
        generator: Optional[torch.Generator] = None,
        prompt_embeds: Optional[torch.Tensor] = None,
        pooled_prompt_embeds: Optional[torch.Tensor] = None,
        max_sequence_length: int = 512,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Inpainting. `image` as for img2img (PIL images resized to
        `height` x `width`); `mask_image` (PIL, or an array or tensor [H, W],
        [1, H, W] or [B, 1, H, W] in [0, 1]) is 1 where the image is
        repainted."""
        prompt_embeds, pooled, txt_ids, batch_size = self._prompt(
            prompt, prompt_2, prompt_embeds, pooled_prompt_embeds, max_sequence_length, num_images_per_prompt)
        packed, (lh, lw), (h, w) = self._image_latents(image, generator, batch_size, height, width)
        mask = self._packed_mask(mask_image, batch_size, packed, lh, lw)
        state, timesteps, noise, latents = self._noised(packed, strength, num_inference_steps, generator)
        rope = self._rope(txt_ids, self._prepare_latent_image_ids(lh // 2, lw // 2))
        latents = self._loop(latents, state, timesteps,
                             self._predict(prompt_embeds, pooled, self._guidance(batch_size, guidance_scale), rope),
                             blend=self._inpaint_blend(state, timesteps, packed, noise, mask))
        return self._decode(latents, height or h, width or w, output_type, return_dict)

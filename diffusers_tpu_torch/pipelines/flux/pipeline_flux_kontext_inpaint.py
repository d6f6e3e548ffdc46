"""Flux Kontext inpainting pipeline.

Port of `diffusers_tpu/pipelines/flux/pipeline_flux_kontext_inpaint.py`: the
conditioning stream (the `image_reference` if given, else the source image;
the posterior's mode) is appended on the sequence axis with RoPE ids whose
first coordinate is 1; the latents start from `scale_noise` of the source
image's latents (the posterior's mode) at the strength-selected timestep; the
prediction is cut back to the noise tokens, and after each step the region
outside the packed mask is blended as in `FluxInpaintPipeline`. The port
draws the noise from one `torch.Generator`. `enable_cache` raises.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from .pipeline_flux_kontext import FluxKontextPipeline


class FluxKontextInpaintPipeline(FluxKontextPipeline):
    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        prompt_2: Optional[Union[str, List[str]]] = None,
        image=None,
        mask_image=None,
        image_reference=None,
        strength: float = 1.0,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 28,
        guidance_scale: float = 2.5,
        num_images_per_prompt: int = 1,
        generator: Optional[torch.Generator] = None,
        prompt_embeds: Optional[torch.Tensor] = None,
        pooled_prompt_embeds: Optional[torch.Tensor] = None,
        max_sequence_length: int = 512,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Kontext inpainting: `image` and `mask_image` as for
        `FluxInpaintPipeline`; `image_reference`, when given, is the
        conditioning image (resized like `image` when PIL)."""
        prompt_embeds, pooled, txt_ids, batch_size = self._prompt(
            prompt, prompt_2, prompt_embeds, pooled_prompt_embeds, max_sequence_length, num_images_per_prompt)
        packed, latent_ids, (lh, lw), (h, w) = self._reference(image, batch_size, height, width)
        height, width = height or h, width or w
        latent_ids[..., 0] = 0  # the source's ids are the noise tokens'
        if image_reference is not None:
            cond, cond_ids, _, _ = self._reference(image_reference, batch_size, height, width)
        else:
            cond, cond_ids = packed, latent_ids.copy()
            cond_ids[..., 0] = 1
        mask = self._packed_mask(mask_image, batch_size, packed, lh, lw)
        rope = self._rope(txt_ids, latent_ids, cond_ids)
        state, timesteps, noise, latents = self._noised(packed, strength, num_inference_steps, generator)
        latents = self._loop(latents, state, timesteps,
                             self._kontext_predict(cond, prompt_embeds, pooled,
                                                   self._guidance(batch_size, guidance_scale), rope),
                             blend=self._inpaint_blend(state, timesteps, packed, noise, mask))
        return self._decode(latents, height, width, output_type, return_dict)

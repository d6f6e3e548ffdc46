"""Flux ControlNet image-to-image pipeline.

Port of `diffusers_tpu/pipelines/flux/pipeline_flux_controlnet_image_to_image.py`:
img2img's start (the source's posterior sample, `scale_noise` at the
strength-selected timestep) with the ControlNet loop of
`pipeline_flux_controlnet.py`. Draws, in JAX's order of use: the control
image's encoder sample, the source's, then the noise. `_edit` also serves
`FluxControlNetInpaintPipeline`, which adds inpaint's per-step blend.
`enable_cache` raises.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from .pipeline_flux_controlnet import FluxControlNetPipeline


class FluxControlNetImg2ImgPipeline(FluxControlNetPipeline):
    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        prompt_2: Optional[Union[str, List[str]]] = None,
        image=None,
        control_image=None,
        control_mode: Optional[int] = None,
        controlnet_conditioning_scale: float = 1.0,
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
        """Image-to-image under `control_image`; `image` as for `FluxImg2ImgPipeline`."""
        return self._edit(prompt, prompt_2, image, None, control_image, control_mode, controlnet_conditioning_scale,
                          strength, height, width, num_inference_steps, guidance_scale, num_images_per_prompt,
                          generator, prompt_embeds, pooled_prompt_embeds, max_sequence_length, output_type,
                          return_dict)

    def _edit(self, prompt, prompt_2, image, mask_image, control_image, control_mode, scale, strength, height, width,
              num_inference_steps, guidance_scale, num_images_per_prompt, generator, prompt_embeds,
              pooled_prompt_embeds, max_sequence_length, output_type, return_dict):
        """The img2img request, or with `mask_image` the inpaint request."""
        prompt_embeds, pooled, txt_ids, batch_size = self._prompt(
            prompt, prompt_2, prompt_embeds, pooled_prompt_embeds, max_sequence_length, num_images_per_prompt)
        pixels = self._preprocess(image, height, width)
        height, width = height or pixels.shape[-2], width or pixels.shape[-1]
        cond, mode = self._control_condition(control_image, control_mode, height, width, batch_size, generator)
        packed, (lh, lw) = self._packed_latents(pixels, generator, batch_size)
        mask = None if mask_image is None else self._packed_mask(mask_image, batch_size, packed, lh, lw)
        state, timesteps, noise, latents = self._noised(packed, strength, num_inference_steps, generator)
        predict = self._controlnet_predict(cond, mode, scale, prompt_embeds, pooled,
                                           self._guidance(batch_size, guidance_scale), txt_ids,
                                           self._prepare_latent_image_ids(lh // 2, lw // 2))
        blend = None if mask is None else self._inpaint_blend(state, timesteps, packed, noise, mask)
        latents = self._loop(latents, state, timesteps, predict, blend=blend)
        return self._decode(latents, height, width, output_type, return_dict)

"""Flux Control image-to-image pipeline.

Port of `diffusers_tpu/pipelines/flux/pipeline_flux_control_img2img.py`:
img2img's start (the source's posterior sample, `scale_noise` at the
strength-selected timestep) with the Control channel concat of
`pipeline_flux_control.py`. Draws, in JAX's order of use: the source's
encoder sample, the control image's, then the noise. `enable_cache` raises.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from .pipeline_flux_control import FluxControlPipeline


class FluxControlImg2ImgPipeline(FluxControlPipeline):
    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        prompt_2: Optional[Union[str, List[str]]] = None,
        image=None,
        control_image=None,
        strength: float = 0.6,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 28,
        guidance_scale: float = 3.5,
        num_images_per_prompt: int = 1,
        generator: Optional[torch.Generator] = None,
        prompt_embeds: Optional[torch.Tensor] = None,
        pooled_prompt_embeds: Optional[torch.Tensor] = None,
        max_sequence_length: int = 512,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Image-to-image under `control_image`; `image` as for
        `FluxImg2ImgPipeline` (PIL images resized to `height` x `width`)."""
        prompt_embeds, pooled, txt_ids, batch_size = self._prompt(
            prompt, prompt_2, prompt_embeds, pooled_prompt_embeds, max_sequence_length, num_images_per_prompt)
        packed, (lh, lw), (h, w) = self._image_latents(image, generator, batch_size, height, width)
        height, width = height or h, width or w
        control = self._encode_pack_control(control_image, height, width, batch_size, generator)
        state, timesteps, _, latents = self._noised(packed, strength, num_inference_steps, generator)
        rope = self._rope(txt_ids, self._prepare_latent_image_ids(lh // 2, lw // 2))
        latents = self._loop(latents, state, timesteps,
                             self._control_predict(control, prompt_embeds, pooled,
                                                   self._guidance(batch_size, guidance_scale), rope))
        return self._decode(latents, height, width, output_type, return_dict)

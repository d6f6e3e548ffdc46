"""Stable Diffusion 3 inpainting pipeline.

Port of `diffusers_tpu/pipelines/stable_diffusion_3/pipeline_stable_diffusion_3_inpaint.py`
(`:26-132`): the 16-channel latent blend. The mask (1 where the image is
repainted) is binarized at 0.5 and taken to the latent size by nearest
neighbour; after step i the region outside it is the init latents noised to
the *next* timestep (`scale_noise` at ``timesteps[i + 1]``), and after the
last step the clean init latents, so it comes back unchanged. The start, the
randomness and the decode are img2img's. JAX's loop reads no cache config;
the port accepts none (`enable_cache` raises).
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ..inpaint_utils import as_mask_array, resize_mask_nearest
from .pipeline_stable_diffusion_3_img2img import StableDiffusion3Img2ImgPipeline


class StableDiffusion3InpaintPipeline(StableDiffusion3Img2ImgPipeline):
    _supported_cache_configs = ()

    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        image=None,
        mask_image=None,
        strength: float = 0.6,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.0,
        num_images_per_prompt: int = 1,
        generator: Optional[torch.Generator] = None,
        max_sequence_length: int = 256,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Inpainting. `image` as for img2img; `mask_image` (PIL, or an array
        or tensor [H, W], [1, H, W] or [B, 1, H, W] in [0, 1]) is 1 where the
        image is repainted."""
        prompt_embeds, pooled, init_latents, noise, state, timesteps, latents = self._prepare(
            prompt, negative_prompt, image, strength, num_inference_steps, guidance_scale, num_images_per_prompt,
            generator, max_sequence_length)
        mask = as_mask_array(mask_image)
        mask = torch.from_numpy(resize_mask_nearest(mask, init_latents.shape[2], init_latents.shape[3]))
        mask = mask.to(init_latents.device)
        ts = timesteps.to(latents.device)
        n = len(timesteps)
        for i, t in enumerate(timesteps):
            noise_pred = self._forward(latents, ts[i], prompt_embeds, pooled, guidance_scale)[0]
            latents = self.scheduler.step(state, noise_pred, t, latents).prev_sample
            proper = (self.scheduler.scale_noise(state, init_latents, timesteps[i + 1:i + 2], noise) if i + 1 < n
                      else init_latents)
            latents = (1.0 - mask) * proper + mask * latents
        return self._output(latents, output_type, return_dict)

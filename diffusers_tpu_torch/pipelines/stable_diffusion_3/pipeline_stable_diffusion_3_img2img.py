"""Stable Diffusion 3 image-to-image pipeline.

Port of `diffusers_tpu/pipelines/stable_diffusion_3/pipeline_stable_diffusion_3_img2img.py`
(`:26-112`): the input image is encoded with the VAE posterior's sample
(``(z - shift_factor) * scaling_factor``), noised by the rectified-flow
forward process to the first timestep the strength keeps (`scale_noise`:
``sigma * noise + (1 - sigma) * x0``), and the text-to-image loop runs over
the tail of the schedule. Where JAX splits one key three ways, the port draws
the encoder's sample, then the noise, from one `torch.Generator`, both
through `utils.torch_utils.randn_tensor`. The caches JAX's loop runs here
(TaylorSeer, MagCache, TextKV, FirstBlockCache) are honoured; FasterCache
and PAB, which JAX's img2img loop cannot run, are refused by `enable_cache`.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ...utils import torch_utils
from ..inpaint_utils import repeat_to_batch
from ..stable_diffusion_xl.pipeline_stable_diffusion_xl_img2img import strength_timesteps
from .pipeline_stable_diffusion_3 import StableDiffusion3Pipeline


class StableDiffusion3Img2ImgPipeline(StableDiffusion3Pipeline):
    _supported_cache_configs = (
        "TaylorSeerCacheConfig", "MagCacheConfig", "TextKVCacheConfig", "FirstBlockCacheConfig",
    )

    def _prepare(self, prompt, negative_prompt, image, strength, num_inference_steps, guidance_scale,
                 num_images_per_prompt, generator, max_sequence_length):
        """(prompt_embeds, pooled, init latents, noise, scheduler state, kept
        timesteps, noised latents) of an image-conditioned request."""
        if not 0 <= strength <= 1:
            raise ValueError(f"strength must be in [0, 1], got {strength}")
        prompt_embeds, pooled, batch_size = self._conditioning(prompt, negative_prompt, guidance_scale > 1.0,
                                                               max_sequence_length, num_images_per_prompt)
        init_latents = repeat_to_batch(self._encode(self._preprocess(image), generator), batch_size, what="image")
        state = self.scheduler.set_timesteps(num_inference_steps)
        timesteps = strength_timesteps(self.scheduler, state, num_inference_steps, strength)
        noise = torch_utils.randn_tensor(init_latents.shape, generator, init_latents.device)
        latents = self.scheduler.scale_noise(state, init_latents, timesteps[:1], noise)
        return prompt_embeds, pooled, init_latents, noise, state, timesteps, latents

    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        image=None,
        strength: float = 0.6,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.0,
        num_images_per_prompt: int = 1,
        generator: Optional[torch.Generator] = None,
        max_sequence_length: int = 256,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Image-to-image. `image`: PIL, or an array or tensor (HWC, NHWC or
        NCHW; values in [0, 1] are normalized to [-1, 1]). `output_type` as
        for text-to-image."""
        prompt_embeds, pooled, _, _, state, timesteps, latents = self._prepare(
            prompt, negative_prompt, image, strength, num_inference_steps, guidance_scale, num_images_per_prompt,
            generator, max_sequence_length)
        latents = self._denoise(latents, prompt_embeds, pooled, state, timesteps, guidance_scale)
        return self._output(latents, output_type, return_dict)

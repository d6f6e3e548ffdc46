"""Flux image-to-image pipeline.

Port of `diffusers_tpu/pipelines/flux/pipeline_flux_img2img.py`: the input
image is encoded with the VAE posterior's sample (``(z - shift_factor) *
scaling_factor``), packed, noised by the rectified-flow forward process to
the first timestep that `strength` keeps (`scale_noise`: ``sigma * noise +
(1 - sigma) * x0``), and the text-to-image step runs over the tail of the
mu-shifted schedule (mu from the image's token count). Where JAX splits one
key three ways, the port draws the encoder's sample, then the noise, from
one `torch.Generator` through `utils.torch_utils.randn_tensor`. The loop is
the text-to-image pipeline's `_denoise` over the kept schedule, as in JAX, so
TaylorSeer, FirstBlockCache and TextKV act here; PAB and MagCache, which
JAX's img2img accepts but cannot run (its loop gets no skip mask), are
refused by `enable_cache` (ROADMAP C3).
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from .pipeline_flux import FluxPipeline


class FluxImg2ImgPipeline(FluxPipeline):
    _supported_cache_configs = ("TaylorSeerCacheConfig", "FirstBlockCacheConfig", "TextKVCacheConfig")

    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        prompt_2: Optional[Union[str, List[str]]] = None,
        image=None,
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
        """Image-to-image. `image`: PIL, or an array or tensor (HWC, NHWC or
        NCHW; values in [0, 1] are normalized to [-1, 1]); the output has its
        size. `output_type` as for text-to-image."""
        prompt_embeds, pooled, txt_ids, batch_size = self._prompt(
            prompt, prompt_2, prompt_embeds, pooled_prompt_embeds, max_sequence_length, num_images_per_prompt)
        packed, (lh, lw), (h, w) = self._image_latents(image, generator, batch_size)
        state, timesteps, _, latents = self._noised(packed, strength, num_inference_steps, generator)
        rope = self._rope(txt_ids, self._prepare_latent_image_ids(lh // 2, lw // 2))
        latents = self._denoise(latents, prompt_embeds, pooled, rope, state, self._guidance(batch_size, guidance_scale),
                                schedule=timesteps)
        return self._decode(latents, height or h, width or w, output_type, return_dict)

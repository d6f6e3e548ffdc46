"""Qwen-Image inpainting pipeline.

Port of `diffusers_tpu/pipelines/qwenimage/pipeline_qwenimage_inpaint.py`:
img2img's start (the VAE encode, the strength-truncated schedule,
`scale_noise`), then after every step the blend through the packed mask
(the binarized pixel mask at the latent size, over the latent channels,
packed 2 x 2; 1 where repainted): outside the mask, the clean latents
re-noised to the next step's timestep, after the last step the clean
latents themselves (`:42-67`).
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ..inpaint_utils import as_mask_array, prepare_packed_mask
from .pipeline_qwenimage_img2img import QwenImageImg2ImgPipeline


class QwenImageInpaintPipeline(QwenImageImg2ImgPipeline):
    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        image=None,
        mask_image=None,
        strength: float = 0.6,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 50,
        true_cfg_scale: float = 4.0,
        generator: Optional[torch.Generator] = None,
        max_sequence_length: int = 1024,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Inpainting: `mask_image` (PIL, or an array in [0, 1], > 0.5 repainted)
        beside img2img's arguments."""
        embeds, mask, batch_size, do_cfg = self._prompt(prompt, negative_prompt, true_cfg_scale,
                                                        max_sequence_length)
        packed, lh, lw, height, width = self._prepare_image(image, height, width, batch_size, generator)
        packed_mask = prepare_packed_mask(as_mask_array(mask_image), batch_size, packed.shape[2] // 4, lh, lw,
                                          self._pack_latents).to(packed.device)
        state, timesteps, noise, latents = self._strength_start(packed, num_inference_steps, strength, generator)
        n = len(timesteps)

        def blend(latents, i):
            proper = (self.scheduler.scale_noise(state, packed, timesteps[i + 1:i + 2], noise) if i + 1 < n
                      else packed)
            return (1.0 - packed_mask) * proper + packed_mask * latents

        latents = self._loop(latents, embeds, mask, state, timesteps, [(1, lh // 2, lw // 2)], true_cfg_scale,
                             do_cfg, blend=blend)
        return self._decode(latents, height, width, output_type, return_dict)

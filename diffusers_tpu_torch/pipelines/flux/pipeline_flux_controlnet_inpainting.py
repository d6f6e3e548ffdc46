"""Flux ControlNet inpainting pipeline.

Port of `diffusers_tpu/pipelines/flux/pipeline_flux_controlnet_inpainting.py`:
the ControlNet loop with inpaint's start and per-step blend of the packed
mask (`pipeline_flux_inpaint.py`). Draws as the ControlNet img2img's: the
control image's encoder sample, the source's, then the noise.
`enable_cache` raises.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from .pipeline_flux_controlnet_image_to_image import FluxControlNetImg2ImgPipeline


class FluxControlNetInpaintPipeline(FluxControlNetImg2ImgPipeline):
    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        prompt_2: Optional[Union[str, List[str]]] = None,
        image=None,
        mask_image=None,
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
        """Inpainting under `control_image`; `image` and `mask_image` as for
        `FluxInpaintPipeline`."""
        return self._edit(prompt, prompt_2, image, mask_image, control_image, control_mode,
                          controlnet_conditioning_scale, strength, height, width, num_inference_steps, guidance_scale,
                          num_images_per_prompt, generator, prompt_embeds, pooled_prompt_embeds, max_sequence_length,
                          output_type, return_dict)

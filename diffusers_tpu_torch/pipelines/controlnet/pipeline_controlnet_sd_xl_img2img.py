"""SDXL + ControlNet image-to-image pipeline.

Port of `diffusers_tpu/pipelines/controlnet/pipeline_controlnet_sd_xl_img2img.py`
(`:27-146`): the input image is encoded with the VAE posterior's sample, the
latents are noised to the first timestep that `strength` keeps (the port's
`strength_timesteps`, which also refuses a strength that leaves no step;
JAX then decodes the noised latents), and the ControlNet loop of the
text-to-image pipeline runs from there, its micro-conditioning at the input
image's size. The encoder's sample, then the noise, are drawn from one
`torch.Generator` (JAX splits one key three ways). Guess mode under CFG
follows upstream (`controlnet_utils`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from .controlnet_utils import ControlNetCall
from .pipeline_controlnet_sd_xl import StableDiffusionXLControlNetPipeline


class StableDiffusionXLControlNetImg2ImgPipeline(StableDiffusionXLControlNetPipeline):
    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        prompt_2: Optional[Union[str, List[str]]] = None,
        image=None,
        control_image=None,
        strength: float = 0.8,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        controlnet_conditioning_scale: Union[float, List[float]] = 1.0,
        guess_mode: bool = False,
        original_size: Optional[Tuple[int, int]] = None,
        crops_coords_top_left: Tuple[int, int] = (0, 0),
        target_size: Optional[Tuple[int, int]] = None,
        generator: Optional[torch.Generator] = None,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Image-to-image from `image` steered by `control_image` (each PIL,
        array or tensor)."""
        cond = self._control_images(control_image)
        do_cfg = guidance_scale > 1.0
        init = self._preprocess(image)
        height, width = init.shape[-2:]
        prompt_embeds, added, batch_size = self._sdxl_conditioning(
            prompt, prompt_2, negative_prompt, do_cfg, height, width, original_size, crops_coords_top_left,
            target_size)
        _, _, state, timesteps, latents = self._image_latents(init, strength, num_inference_steps, batch_size,
                                                                 generator)
        cn = ControlNetCall(self.controlnet, cond, controlnet_conditioning_scale, guess_mode, do_cfg, batch_size,
                            prompt_embeds, added)
        latents = self._loop(cn, state, timesteps, latents, prompt_embeds, guidance_scale, added)
        return self._output(latents, output_type, return_dict)

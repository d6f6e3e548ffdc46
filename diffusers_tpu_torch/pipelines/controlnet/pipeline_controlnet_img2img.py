"""Stable Diffusion (1.x) + ControlNet image-to-image pipeline.

Port of `diffusers_tpu/pipelines/controlnet/pipeline_controlnet_img2img.py`
(`:26-123`): the input image is encoded with the VAE posterior's sample, the
latents are noised to the first timestep that `strength` keeps (`t_start *
scheduler.order`, as JAX's `get_timesteps`), and the ControlNet loop runs
from there. The encoder's sample, then the noise, are drawn from one
`torch.Generator` (JAX splits one key three ways).
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from .controlnet_utils import ControlNetCall
from .pipeline_controlnet import StableDiffusionControlNetPipeline


class StableDiffusionControlNetImg2ImgPipeline(StableDiffusionControlNetPipeline):
    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        image=None,
        control_image=None,
        strength: float = 0.8,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        controlnet_conditioning_scale: Union[float, List[float]] = 1.0,
        guess_mode: bool = False,
        generator: Optional[torch.Generator] = None,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Image-to-image from `image` steered by `control_image` (each PIL,
        array or tensor)."""
        cond = self._control_images(control_image)
        do_cfg = guidance_scale > 1.0
        prompt_embeds, batch_size = self._conditioning(prompt, negative_prompt, do_cfg)
        _, _, state, timesteps, latents = self._image_latents(self._preprocess(image), strength, num_inference_steps,
                                                              batch_size, generator)
        cn = ControlNetCall(self.controlnet, cond, controlnet_conditioning_scale, guess_mode, do_cfg, batch_size,
                            prompt_embeds)
        latents = self._loop(cn, state, timesteps, latents, prompt_embeds, guidance_scale)
        return self._output(latents, output_type, return_dict)

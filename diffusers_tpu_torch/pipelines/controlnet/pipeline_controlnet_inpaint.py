"""Stable Diffusion (1.x) + ControlNet inpainting pipeline.

Port of `diffusers_tpu/pipelines/controlnet/pipeline_controlnet_inpaint.py`
(`:26-141`): a 4-channel UNet, the mask (1 where the image is repainted)
binarized at 0.5 and taken to the latent size by nearest neighbour, the
latents noised to the first timestep `strength` keeps (at any strength, as
JAX's ControlNet inpaint does), and the ControlNet loop with the blend of
`controlnet_utils.blend_loop` (the known region at the next timestep's
noise level, clean after the last step: JAX's rule here, and upstream's).
A 9-channel inpainting UNet raises, as JAX's loop has no masked-image
input. Randomness as in img2img.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from .controlnet_utils import ControlNetCall, latent_mask
from .pipeline_controlnet import StableDiffusionControlNetPipeline


class StableDiffusionControlNetInpaintPipeline(StableDiffusionControlNetPipeline):
    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        image=None,
        mask_image=None,
        control_image=None,
        strength: float = 1.0,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        controlnet_conditioning_scale: Union[float, List[float]] = 0.5,
        guess_mode: bool = False,
        generator: Optional[torch.Generator] = None,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Inpainting of `image` where `mask_image` is 1 (PIL, or an array or
        tensor [H, W], [1, H, W] or [B, 1, H, W] in [0, 1]), steered by
        `control_image`."""
        cond = self._control_images(control_image)
        do_cfg = guidance_scale > 1.0
        prompt_embeds, batch_size = self._conditioning(prompt, negative_prompt, do_cfg)
        init_latents, noise, state, timesteps, latents = self._image_latents(
            self._preprocess(image), strength, num_inference_steps, batch_size, generator)
        cn = ControlNetCall(self.controlnet, cond, controlnet_conditioning_scale, guess_mode, do_cfg, batch_size,
                            prompt_embeds)
        latents = self._inpaint_loop(cn, state, timesteps, latents, init_latents, noise,
                                     latent_mask(mask_image, init_latents), prompt_embeds, guidance_scale)
        return self._output(latents, output_type, return_dict)

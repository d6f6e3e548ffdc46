"""SDXL + ControlNet inpainting pipeline.

Port of `diffusers_tpu/pipelines/controlnet/pipeline_controlnet_inpaint_sd_xl.py`
(`:26-158`): a 4-channel UNet, the mask (1 where the image is repainted)
binarized at 0.5 and taken to the latent size by nearest neighbour, the
latents noised to the first timestep `strength` keeps (at any strength, as
JAX's ControlNet inpaint does; the default 0.9999 keeps every step), and the
ControlNet loop with the blend of `controlnet_utils.blend_loop` (JAX's rule
here is upstream's: the known region at the next timestep's noise level,
clean after the last step). A 9-channel inpainting UNet raises, as JAX's
loop has no masked-image input. Randomness as in img2img.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from .controlnet_utils import ControlNetCall, latent_mask
from .pipeline_controlnet_sd_xl import StableDiffusionXLControlNetPipeline


class StableDiffusionXLControlNetInpaintPipeline(StableDiffusionXLControlNetPipeline):
    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        prompt_2: Optional[Union[str, List[str]]] = None,
        image=None,
        mask_image=None,
        control_image=None,
        strength: float = 0.9999,
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
        """Inpainting of `image` where `mask_image` is 1 (PIL, or an array or
        tensor [H, W], [1, H, W] or [B, 1, H, W] in [0, 1]), steered by
        `control_image`."""
        cond = self._control_images(control_image)
        do_cfg = guidance_scale > 1.0
        init = self._preprocess(image)
        height, width = init.shape[-2:]
        prompt_embeds, added, batch_size = self._sdxl_conditioning(
            prompt, prompt_2, negative_prompt, do_cfg, height, width, original_size, crops_coords_top_left,
            target_size)
        init_latents, noise, state, timesteps, latents = self._image_latents(init, strength, num_inference_steps,
                                                                                batch_size, generator)
        cn = ControlNetCall(self.controlnet, cond, controlnet_conditioning_scale, guess_mode, do_cfg, batch_size,
                            prompt_embeds, added)
        latents = self._inpaint_loop(cn, state, timesteps, latents, init_latents, noise,
                                     latent_mask(mask_image, init_latents), prompt_embeds, guidance_scale, added)
        return self._output(latents, output_type, return_dict)

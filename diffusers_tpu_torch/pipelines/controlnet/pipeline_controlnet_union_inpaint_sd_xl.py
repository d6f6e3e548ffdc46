"""SDXL + ControlNet-Union inpainting pipeline.

Port of `diffusers_tpu/pipelines/controlnet/pipeline_controlnet_union_inpaint_sd_xl.py`
(`:26-186`): the Union controls of the text-to-image pipeline (with JAX's
`ValueError` when `control_mode` does not list one task per image, `:115`;
a multi model too) on the 4-channel inpaint loop of `controlnet_utils`: the
latents noised to the first timestep `strength` keeps, the known region
blended back at the next timestep's noise level and clean after the last
step. Randomness as in img2img.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from .controlnet_utils import ControlNetCall, latent_mask
from .pipeline_controlnet_union_sd_xl import StableDiffusionXLControlNetUnionPipeline


class StableDiffusionXLControlNetUnionInpaintPipeline(StableDiffusionXLControlNetUnionPipeline):
    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        prompt_2: Optional[Union[str, List[str]]] = None,
        image=None,
        mask_image=None,
        control_image=None,
        control_mode: Union[int, List[int], None] = None,
        strength: float = 0.9999,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        negative_prompt_2: Optional[Union[str, List[str]]] = None,
        controlnet_conditioning_scale: Union[float, List[float]] = 1.0,
        guess_mode: bool = False,
        generator: Optional[torch.Generator] = None,
        original_size: Optional[Tuple[int, int]] = None,
        crops_coords_top_left: Tuple[int, int] = (0, 0),
        target_size: Optional[Tuple[int, int]] = None,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Inpainting of `image` where `mask_image` is 1, steered by
        `control_image` for the tasks of `control_mode`."""
        controls = self._union_controls(control_image, control_mode)
        do_cfg = guidance_scale > 1.0
        init = self._preprocess(image)
        height, width = init.shape[-2:]
        prompt_embeds, added, batch_size = self._sdxl_conditioning(
            prompt, prompt_2, negative_prompt, do_cfg, height, width, original_size, crops_coords_top_left,
            target_size, negative_prompt_2)
        init_latents, noise, state, timesteps, latents = self._image_latents(init, strength, num_inference_steps,
                                                                            batch_size, generator)
        cn = ControlNetCall(self.controlnet, conditioning_scale=controlnet_conditioning_scale, guess_mode=guess_mode,
                            do_cfg=do_cfg, batch_size=batch_size, prompt_embeds=prompt_embeds, added=added,
                            **controls)
        latents = self._inpaint_loop(cn, state, timesteps, latents, init_latents, noise,
                                     latent_mask(mask_image, init_latents), prompt_embeds, guidance_scale, added)
        return self._output(latents, output_type, return_dict)

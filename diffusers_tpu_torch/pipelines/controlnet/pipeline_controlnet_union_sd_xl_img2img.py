"""SDXL + ControlNet-Union image-to-image pipeline.

Port of `diffusers_tpu/pipelines/controlnet/pipeline_controlnet_union_sd_xl_img2img.py`
(`:27-171`): the Union controls of the text-to-image pipeline (a multi
model too) on the img2img start of `controlnet_utils`: the VAE posterior's
sample, the latents noised to the first timestep `strength` keeps, the
encoder's sample and then the noise drawn from one `torch.Generator`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from .controlnet_utils import ControlNetCall
from .pipeline_controlnet_union_sd_xl import StableDiffusionXLControlNetUnionPipeline


class StableDiffusionXLControlNetUnionImg2ImgPipeline(StableDiffusionXLControlNetUnionPipeline):
    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        prompt_2: Optional[Union[str, List[str]]] = None,
        image=None,
        control_image=None,
        control_mode: Union[int, List[int], None] = None,
        strength: float = 0.8,
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
        """Image-to-image from `image` steered by `control_image` for the
        tasks of `control_mode`."""
        controls = self._union_controls(control_image, control_mode)
        do_cfg = guidance_scale > 1.0
        init = self._preprocess(image)
        height, width = init.shape[-2:]
        prompt_embeds, added, batch_size = self._sdxl_conditioning(
            prompt, prompt_2, negative_prompt, do_cfg, height, width, original_size, crops_coords_top_left,
            target_size, negative_prompt_2)
        _, _, state, timesteps, latents = self._image_latents(init, strength, num_inference_steps, batch_size,
                                                              generator)
        cn = ControlNetCall(self.controlnet, conditioning_scale=controlnet_conditioning_scale, guess_mode=guess_mode,
                            do_cfg=do_cfg, batch_size=batch_size, prompt_embeds=prompt_embeds, added=added,
                            **controls)
        latents = self._loop(cn, state, timesteps, latents, prompt_embeds, guidance_scale, added)
        return self._output(latents, output_type, return_dict)

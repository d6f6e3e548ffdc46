"""SDXL + ControlNet text-to-image pipeline.

Port of `diffusers_tpu/pipelines/controlnet/pipeline_controlnet_sd_xl.py`
(`:25-146`): SDXL's micro-conditioning (text_embeds, time_ids) feeds both the
ControlNet and the UNet; each step the ControlNet runs before the UNet and
hands it its residuals. The conditioning image is preprocessed and mapped
back to [0, 1], as JAX does (`:103`). Guess mode under CFG follows upstream
diffusers (`controlnet_utils`): the ControlNet runs on the conditional half
only; JAX runs it on both halves (`:55-58`; ROADMAP C4). `controlnet` is a
registered component, so `_place` and `.to` move it. A list or tuple of
ControlNets is wrapped in a `MultiControlNetModel`, as the SD pipeline's
twin does; `image` is then one conditioning image a net and
`controlnet_conditioning_scale` a float or one scale a net.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from ...utils import torch_utils
from ..stable_diffusion_xl.pipeline_stable_diffusion_xl import StableDiffusionXLPipeline
from .controlnet_utils import ControlNetCall, ControlNetPipelineMixin, as_controlnet


class StableDiffusionXLControlNetPipeline(ControlNetPipelineMixin, StableDiffusionXLPipeline):
    _supported_cache_configs = ()

    def __init__(self, vae, text_encoder, text_encoder_2, tokenizer, tokenizer_2, unet, controlnet, scheduler,
                 image_encoder=None, feature_extractor=None, force_zeros_for_empty_prompt: bool = True,
                 device: Union[str, torch.device] = "cuda"):
        self.register_modules(controlnet=as_controlnet(controlnet))  # before the base places the components
        super().__init__(vae=vae, text_encoder=text_encoder, text_encoder_2=text_encoder_2, tokenizer=tokenizer,
                         tokenizer_2=tokenizer_2, unet=unet, scheduler=scheduler, image_encoder=image_encoder,
                         feature_extractor=feature_extractor,
                         force_zeros_for_empty_prompt=force_zeros_for_empty_prompt, device=device)

    def _sdxl_conditioning(self, prompt, prompt_2, negative_prompt, do_cfg, height, width, original_size,
                           crops_coords_top_left, target_size, negative_prompt_2=None):
        """(prompt_embeds, added micro-conditioning, batch_size)."""
        prompt_embeds, add_text_embeds, add_time_ids, batch_size = self._conditioning(
            prompt, prompt_2, negative_prompt, negative_prompt_2, do_cfg, original_size or (height, width),
            crops_coords_top_left, target_size or (height, width),
        )
        return prompt_embeds, {"text_embeds": add_text_embeds, "time_ids": add_time_ids}, batch_size

    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        prompt_2: Optional[Union[str, List[str]]] = None,
        image=None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        controlnet_conditioning_scale: Union[float, List[float]] = 1.0,
        guess_mode: bool = False,
        original_size: Optional[Tuple[int, int]] = None,
        crops_coords_top_left: Tuple[int, int] = (0, 0),
        target_size: Optional[Tuple[int, int]] = None,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Text-to-image steered by the conditioning `image` (an edge map,
        say; PIL, array or tensor) at the output's pixel size, unless
        `height` / `width` are given."""
        device, dtype = self.unet.device, self.unet.dtype
        cond = self._control_images(image)
        first = cond[0] if isinstance(cond, list) else cond
        height = height or first.shape[-2]
        width = width or first.shape[-1]
        do_cfg = guidance_scale > 1.0
        prompt_embeds, added, batch_size = self._sdxl_conditioning(
            prompt, prompt_2, negative_prompt, do_cfg, height, width, original_size, crops_coords_top_left,
            target_size)
        cn = ControlNetCall(self.controlnet, cond, controlnet_conditioning_scale, guess_mode, do_cfg, batch_size,
                            prompt_embeds, added)
        shape = (batch_size, self.unet.config.in_channels, height // self.vae_scale_factor,
                 width // self.vae_scale_factor)
        if latents is None:
            latents = torch_utils.randn_tensor(shape, generator, device)
        state, latents, _ = self._start(latents.to(device=device, dtype=dtype), num_inference_steps)
        latents = self._loop(cn, state, state.timesteps, latents, prompt_embeds, guidance_scale, added,
                             num_steps=num_inference_steps)
        return self._output(latents, output_type, return_dict)

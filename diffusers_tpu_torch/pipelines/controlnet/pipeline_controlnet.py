"""Stable Diffusion (1.x) + ControlNet text-to-image pipeline.

Port of `diffusers_tpu/pipelines/controlnet/pipeline_controlnet.py`
(`:25-170`) on the port's `StableDiffusionPipeline`: each step the
ControlNet runs before the UNet and hands it its residuals. The
conditioning image is preprocessed and mapped back to [0, 1], and the
output takes its size unless `height` / `width` are given. A list or tuple
of ControlNets becomes a `MultiControlNetModel` (`:57-61`, `:118-123`):
`image` is then one conditioning image a net, and
`controlnet_conditioning_scale` a float or one scale a net. Guess mode
under CFG follows upstream (`controlnet_utils`; JAX runs the ControlNet on
both halves, ROADMAP C4). JAX's loop reads no cache config: `enable_cache`
raises `TypeError`.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ...utils import torch_utils
from ..stable_diffusion.pipeline_stable_diffusion import StableDiffusionPipeline
from .controlnet_utils import ControlNetCall, ControlNetPipelineMixin, as_controlnet


class StableDiffusionControlNetPipeline(ControlNetPipelineMixin, StableDiffusionPipeline):
    def __init__(self, vae, text_encoder, tokenizer, unet, controlnet, scheduler, safety_checker=None,
                 feature_extractor=None, image_encoder=None, requires_safety_checker: bool = False,
                 device: Union[str, torch.device] = "cuda"):
        self.register_modules(controlnet=as_controlnet(controlnet))  # before the base places the components
        super().__init__(vae=vae, text_encoder=text_encoder, tokenizer=tokenizer, unet=unet, scheduler=scheduler,
                         safety_checker=safety_checker, feature_extractor=feature_extractor,
                         image_encoder=image_encoder, requires_safety_checker=requires_safety_checker,
                         device=device)

    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        image=None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        controlnet_conditioning_scale: Union[float, List[float]] = 1.0,
        guess_mode: bool = False,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Text-to-image steered by the conditioning `image` (PIL, array or
        tensor; a list, one a net, for a Multi-ControlNet)."""
        device, dtype = self.unet.device, self.unet.dtype
        cond = self._control_images(image)
        first = cond[0] if isinstance(cond, list) else cond
        height = height or first.shape[-2]
        width = width or first.shape[-1]
        do_cfg = guidance_scale > 1.0
        prompt_embeds, batch_size = self._conditioning(prompt, negative_prompt, do_cfg)
        cn = ControlNetCall(self.controlnet, cond, controlnet_conditioning_scale, guess_mode, do_cfg, batch_size,
                            prompt_embeds)
        shape = (batch_size, self.unet.config.in_channels, height // self.vae_scale_factor,
                 width // self.vae_scale_factor)
        if latents is None:
            latents = torch_utils.randn_tensor(shape, generator, device)
        state = self.scheduler.set_timesteps(num_inference_steps)
        latents = latents.to(device=device, dtype=dtype) * state.init_noise_sigma
        latents = self._loop(cn, state, state.timesteps, latents, prompt_embeds, guidance_scale,
                             num_steps=num_inference_steps)
        return self._output(latents, output_type, return_dict)

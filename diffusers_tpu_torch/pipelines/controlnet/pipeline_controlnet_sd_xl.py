"""SDXL + ControlNet text-to-image pipeline.

Port of `diffusers_tpu/pipelines/controlnet/pipeline_controlnet_sd_xl.py`
(`:25-146`): SDXL's micro-conditioning (text_embeds, time_ids) feeds both the
ControlNet and the UNet; each step the ControlNet runs before the UNet and
hands it its residuals. The conditioning image is preprocessed and mapped
back to [0, 1], as JAX does (`:103`). Guess mode under CFG follows upstream
diffusers (`pipelines/controlnet/pipeline_controlnet_sd_xl.py`, ``guess_mode
and self.do_classifier_free_guidance``): the ControlNet runs on the
conditional half only, its guess-mode scales act there, and the
unconditional half's residuals are zeros. JAX runs it on both halves
(`:55-58`; ROADMAP C, faults on the reference side). `controlnet` is a
registered component, so `_place` and `.to` move it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ...hooks.generic_cache import denoise_loop
from ...utils import torch_utils
from ..inpaint_utils import repeat_to_batch
from ..stable_diffusion_xl.pipeline_stable_diffusion_xl import StableDiffusionXLPipeline


class StableDiffusionXLControlNetPipeline(StableDiffusionXLPipeline):
    _supported_cache_configs = ()

    def __init__(self, vae, text_encoder, text_encoder_2, tokenizer, tokenizer_2, unet, controlnet, scheduler,
                 image_encoder=None, feature_extractor=None, force_zeros_for_empty_prompt: bool = True,
                 device: Union[str, torch.device] = "cuda"):
        self.register_modules(controlnet=controlnet)  # before the base places the components
        super().__init__(vae=vae, text_encoder=text_encoder, text_encoder_2=text_encoder_2, tokenizer=tokenizer,
                         tokenizer_2=tokenizer_2, unet=unet, scheduler=scheduler, image_encoder=image_encoder,
                         feature_extractor=feature_extractor,
                         force_zeros_for_empty_prompt=force_zeros_for_empty_prompt, device=device)

    def _conditioning_image(self, image) -> torch.Tensor:
        """The conditioning image, NCHW in [0, 1]: PIL or an array is
        preprocessed (normalized to [-1, 1]) and mapped back; a tensor is
        taken as it is, mapped to [0, 1] when it holds negative values."""
        if isinstance(image, torch.Tensor):
            cond = image.float()
            return ((cond + 1) / 2).clamp(0, 1) if float(cond.min()) < 0 else cond
        cond = self.image_processor.preprocess(image)
        return torch.from_numpy(np.clip((cond + 1) / 2, 0, 1) if cond.min() < 0 else cond)

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
        controlnet_conditioning_scale: float = 1.0,
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
        cond = self._conditioning_image(image)
        height = height or cond.shape[-2]
        width = width or cond.shape[-1]
        do_cfg = guidance_scale > 1.0
        prompt_embeds, add_text_embeds, add_time_ids, batch_size = self._conditioning(
            prompt, prompt_2, negative_prompt, None, do_cfg, original_size or (height, width),
            crops_coords_top_left, target_size or (height, width),
        )
        cond_only = guess_mode and do_cfg  # upstream: the ControlNet sees the conditional half only
        cond = repeat_to_batch(cond, batch_size, what="image")
        if do_cfg and not cond_only:
            cond = torch.cat([cond, cond])
        cond = cond.to(device=self.controlnet.device, dtype=self.controlnet.dtype)

        shape = (batch_size, self.unet.config.in_channels, height // self.vae_scale_factor, width // self.vae_scale_factor)
        if latents is None:
            latents = torch_utils.randn_tensor(shape, generator, device)
        state, latents, timesteps_device = self._start(latents.to(device=device, dtype=dtype), num_inference_steps)
        added = {"text_embeds": add_text_embeds, "time_ids": add_time_ids}
        cn_embeds, cn_added = prompt_embeds, added
        if cond_only:
            cn_embeds = prompt_embeds[batch_size:]
            cn_added = {k: v[batch_size:] for k, v in added.items()}

        def forward(latents, i, t):
            latent_input = torch.cat([latents, latents], dim=0) if do_cfg else latents
            latent_input = self.scheduler.scale_model_input(state, latent_input, t)
            cn_input = self.scheduler.scale_model_input(state, latents, t) if cond_only else latent_input
            down, mid = self.controlnet(cn_input, timesteps_device[i], cn_embeds, cond,
                                        conditioning_scale=controlnet_conditioning_scale, guess_mode=guess_mode,
                                        added_cond_kwargs=cn_added, return_dict=False)
            if cond_only:
                down = [torch.cat([torch.zeros_like(d), d]) for d in down]
                mid = torch.cat([torch.zeros_like(mid), mid])
            noise_pred = self.unet(latent_input, timesteps_device[i], encoder_hidden_states=prompt_embeds,
                                   added_cond_kwargs=added, down_block_additional_residuals=down,
                                   mid_block_additional_residual=mid).sample
            if do_cfg:
                uncond, text = noise_pred.chunk(2, dim=0)
                noise_pred = uncond + guidance_scale * (text - uncond)
            return noise_pred

        latents = denoise_loop(forward, self.scheduler, latents, state, state.timesteps)
        return self._output(latents, output_type, return_dict)

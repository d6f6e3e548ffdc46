"""InstructPix2Pix on SDXL.

Port of `diffusers_tpu/pipelines/stable_diffusion_xl/pipeline_stable_diffusion_xl_instruct_pix2pix.py`:
the SD InstructPix2Pix rule (`stable_diffusion.pipeline_stable_diffusion_instruct_pix2pix`,
which shares this module's `image_condition` and `instruct_pix2pix_guidance`:
an 8-channel UNet, the [text, image, uncond] batch, the image latents the
VAE posterior's unscaled mode, ``uncond + g * (text - image) + g_img *
(image - uncond)`` when ``g > 1`` and ``g_img >= 1``) with SDXL's
conditioning: both CLIP towers (`encode_prompt`), the pooled embeds and the
micro-conditioning time ids, each tripled to [prompt, negative, negative].
The time ids default to the input image's size. JAX's loop reads no cache
config; the port accepts none.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from ...hooks.generic_cache import denoise_loop
from ...utils import torch_utils
from ..inpaint_utils import repeat_to_batch
from .pipeline_stable_diffusion_xl import StableDiffusionXLPipeline


def instruct_pix2pix_guidance(noise_pred: torch.Tensor, guidance_scale: float, image_guidance_scale: float):
    """The triple-CFG combination of a [text, image, uncond] batch."""
    text, image, uncond = noise_pred.chunk(3, dim=0)
    return uncond + guidance_scale * (text - image) + image_guidance_scale * (image - uncond)


def image_condition(vae, image: torch.Tensor, batch_size: int, do_cfg: bool, dtype: torch.dtype) -> torch.Tensor:
    """The source image's latents on the channel axis: the posterior's mode,
    unscaled, repeated to the batch; [image, image, zeros] with guidance."""
    latents = repeat_to_batch(vae.encode(image).mode(), batch_size, what="image").to(dtype)
    return torch.cat([latents, latents, torch.zeros_like(latents)], dim=0) if do_cfg else latents


class StableDiffusionXLInstructPix2PixPipeline(StableDiffusionXLPipeline):
    _supported_cache_configs = ()

    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        prompt_2: Optional[Union[str, List[str]]] = None,
        image=None,
        num_inference_steps: int = 100,
        guidance_scale: float = 5.0,
        image_guidance_scale: float = 1.5,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        negative_prompt_2: Optional[Union[str, List[str]]] = None,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        original_size: Optional[Tuple[int, int]] = None,
        crops_coords_top_left: Tuple[int, int] = (0, 0),
        target_size: Optional[Tuple[int, int]] = None,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Edit `image` (PIL, or an array or tensor HWC, NHWC or NCHW; values
        in [0, 1] are normalized to [-1, 1]) as `prompt` says."""
        device, dtype = self.unet.device, self.unet.dtype
        do_cfg = guidance_scale > 1.0 and image_guidance_scale >= 1.0
        prompt_embeds, negative_embeds, pooled, negative_pooled = self.encode_prompt(
            prompt, prompt_2, negative_prompt, negative_prompt_2, do_cfg)
        batch_size = prompt_embeds.shape[0]
        init = self._preprocess(image)
        h, w = init.shape[-2], init.shape[-1]
        add_time_ids = self._get_add_time_ids(original_size or (h, w), crops_coords_top_left, target_size or (h, w),
                                              batch_size, device)
        if do_cfg:
            prompt_embeds = torch.cat([prompt_embeds, negative_embeds, negative_embeds], dim=0)
            add_text_embeds = torch.cat([pooled, negative_pooled, negative_pooled], dim=0)
            add_time_ids = torch.cat([add_time_ids] * 3, dim=0)
        else:
            add_text_embeds = pooled
        image_latents = image_condition(self.vae, init, batch_size, do_cfg, dtype)
        shape = (batch_size, self.vae.config.latent_channels, h // self.vae_scale_factor, w // self.vae_scale_factor)
        if latents is None:
            latents = torch_utils.randn_tensor(shape, generator, device)
        state, latents, timesteps_device = self._start(latents.to(device=device, dtype=dtype), num_inference_steps)

        def forward(latents, i, t):
            latent_input = torch.cat([latents] * 3, dim=0) if do_cfg else latents
            latent_input = torch.cat([self.scheduler.scale_model_input(state, latent_input, t), image_latents], dim=1)
            noise_pred = self._unet(latent_input, timesteps_device[i], prompt_embeds, add_text_embeds, add_time_ids)
            return instruct_pix2pix_guidance(noise_pred, guidance_scale, image_guidance_scale) if do_cfg else noise_pred

        latents = denoise_loop(forward, self.scheduler, latents, state, state.timesteps)
        return self._output(latents, output_type, return_dict)

"""InstructPix2Pix: image editing from a text instruction, on SD 1.x.

Port of `diffusers_tpu/pipelines/stable_diffusion/pipeline_stable_diffusion_instruct_pix2pix.py`:
an 8-channel UNet sees the latents and the source image's latents on the
channel axis. With guidance the batch runs three ways, laid out [text,
image, uncond]: the embeddings are [prompt, negative, negative] and the image
latents [image, image, zeros], and the prediction is ``uncond + g * (text -
image) + g_img * (image - uncond)`` (JAX `:57-61`). Guidance runs when ``g >
1`` and ``g_img >= 1`` (`:88`). The image latents are the VAE posterior's
mode, not scaled by the VAE's scaling factor (upstream's rule, kept by JAX);
the scheduler does not scale them. Latents run in the UNet's dtype, as in the
SD pipeline; the initial noise is drawn from `generator` through
`utils.torch_utils.randn_tensor`. JAX's loop reads no cache config; the port
accepts none.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ...hooks.generic_cache import denoise_loop
from ...utils import torch_utils
from ..stable_diffusion_xl.pipeline_stable_diffusion_xl_instruct_pix2pix import (
    image_condition,
    instruct_pix2pix_guidance,
)
from .pipeline_stable_diffusion import StableDiffusionPipeline


class StableDiffusionInstructPix2PixPipeline(StableDiffusionPipeline):
    _supported_cache_configs = ()

    def encode_prompt_ip2p(self, prompt, negative_prompt, do_cfg: bool) -> torch.Tensor:
        """[prompt, negative, negative] embeddings under guidance (the image
        branch reuses the negative text), the prompt's alone without."""
        embeds = self.encode_prompt(prompt, negative_prompt, do_cfg)
        if not do_cfg:
            return embeds
        negative, text = embeds.chunk(2, dim=0)
        return torch.cat([text, negative, negative], dim=0)

    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        image=None,
        num_inference_steps: int = 100,
        guidance_scale: float = 7.5,
        image_guidance_scale: float = 1.5,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Edit `image` (PIL, or an array or tensor HWC, NHWC or NCHW; values
        in [0, 1] are normalized to [-1, 1]) as `prompt` says."""
        device, dtype = self.unet.device, self.unet.dtype
        do_cfg = guidance_scale > 1.0 and image_guidance_scale >= 1.0
        prompt_embeds = self.encode_prompt_ip2p(prompt, negative_prompt, do_cfg)
        batch_size = prompt_embeds.shape[0] // (3 if do_cfg else 1)
        init = self._preprocess(image)
        image_latents = image_condition(self.vae, init, batch_size, do_cfg, dtype)
        shape = (batch_size, self.vae.config.latent_channels, init.shape[-2] // self.vae_scale_factor,
                 init.shape[-1] // self.vae_scale_factor)
        if latents is None:
            latents = torch_utils.randn_tensor(shape, generator, device)
        state = self.scheduler.set_timesteps(num_inference_steps)
        latents = latents.to(device=device, dtype=dtype) * state.init_noise_sigma
        timesteps_device = state.timesteps.to(device)

        def forward(latents, i, t):
            latent_input = torch.cat([latents] * 3, dim=0) if do_cfg else latents
            latent_input = torch.cat([self.scheduler.scale_model_input(state, latent_input, t), image_latents], dim=1)
            noise_pred = self.unet(latent_input, timesteps_device[i], encoder_hidden_states=prompt_embeds).sample
            return instruct_pix2pix_guidance(noise_pred, guidance_scale, image_guidance_scale) if do_cfg else noise_pred

        latents = denoise_loop(forward, self.scheduler, latents, state, state.timesteps)
        return self._output(latents, output_type, return_dict)

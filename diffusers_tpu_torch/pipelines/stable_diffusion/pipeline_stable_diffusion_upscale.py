"""The Stable Diffusion x4 upscaler.

Port of `diffusers_tpu/pipelines/stable_diffusion/pipeline_stable_diffusion_upscale.py`:
the low-resolution image, noised to `noise_level` by the DDPM
`low_res_scheduler` (`:99-105`), rides the channel axis of a 7-channel UNet
at the latents' resolution (the latents have the low-resolution image's size),
and the noise level conditions the UNet as its class label (the UNet's
`num_class_embeds` table; JAX `:36-60`). CFG is the SD pipeline's (batch 2,
the negative first), with the noised image and the noise level doubled. The
upscaler's 3-block VAE decodes the latents at 4x scale. PIL inputs are
resized with the bicubic filter, as in JAX.

Random draws go through `utils.torch_utils.randn_tensor`, from `generator`:
first the low-resolution image's noise, then the initial latents (JAX
splits one key three ways; ROADMAP C3). JAX's loop reads no cache config; the
port accepts none.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ...hooks.generic_cache import denoise_loop
from ...image_processor import VaeImageProcessor
from ...utils import torch_utils
from ..pipeline_utils import DiffusionPipeline
from .pipeline_stable_diffusion import StableDiffusionPipeline


class StableDiffusionUpscalePipeline(StableDiffusionPipeline):
    _optional_components = []
    _supported_cache_configs = ()

    def __init__(self, vae, text_encoder, tokenizer, unet, low_res_scheduler, scheduler,
                 device: Union[str, torch.device] = "cuda"):
        DiffusionPipeline.__init__(self)  # the SD pipeline's components, with `low_res_scheduler`
        self.register_modules(vae=vae, text_encoder=text_encoder, tokenizer=tokenizer, unet=unet,
                              low_res_scheduler=low_res_scheduler, scheduler=scheduler)
        self.vae_scale_factor = 2 ** (len(self.vae.config.block_out_channels) - 1)
        self.image_processor = VaeImageProcessor(vae_scale_factor=self.vae_scale_factor, resample="bicubic")
        self._place(device)

    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        image=None,
        num_inference_steps: int = 75,
        guidance_scale: float = 9.0,
        noise_level: int = 20,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Upscale `image` (PIL, or an array or tensor HWC, NHWC or NCHW;
        values in [0, 1] are normalized to [-1, 1]) 4x, guided by `prompt`."""
        device, dtype = self.unet.device, self.unet.dtype
        do_cfg = guidance_scale > 1.0
        prompt_embeds = self.encode_prompt(prompt, negative_prompt, do_cfg)
        batch_size = prompt_embeds.shape[0] // (2 if do_cfg else 1)

        init = torch.from_numpy(self.image_processor.preprocess(image)).to(device)
        if init.shape[0] < batch_size:
            init = init.repeat_interleave(batch_size // init.shape[0], dim=0)
        noise_levels = torch.full((init.shape[0],), noise_level, dtype=torch.long, device=device)
        lr_state = self.low_res_scheduler.set_timesteps(self.low_res_scheduler.config.num_train_timesteps)
        noise = torch_utils.randn_tensor(init.shape, generator, device)
        init = self.low_res_scheduler.add_noise(lr_state, init, noise, noise_levels).to(dtype)
        if do_cfg:
            init, noise_levels = torch.cat([init, init], dim=0), torch.cat([noise_levels, noise_levels], dim=0)

        shape = (batch_size, self.vae.config.latent_channels, init.shape[-2], init.shape[-1])
        if latents is None:
            latents = torch_utils.randn_tensor(shape, generator, device)
        state = self.scheduler.set_timesteps(num_inference_steps)
        latents = latents.to(device=device, dtype=dtype) * state.init_noise_sigma
        timesteps_device = state.timesteps.to(device)

        def forward(latents, i, t):
            latent_input = torch.cat([latents, latents], dim=0) if do_cfg else latents
            latent_input = torch.cat([self.scheduler.scale_model_input(state, latent_input, t), init], dim=1)
            noise_pred = self.unet(latent_input, timesteps_device[i], encoder_hidden_states=prompt_embeds,
                                   class_labels=noise_levels).sample
            if do_cfg:
                uncond, text = noise_pred.chunk(2, dim=0)
                noise_pred = uncond + guidance_scale * (text - uncond)
            return noise_pred

        latents = denoise_loop(forward, self.scheduler, latents, state, state.timesteps)
        return self._output(latents, output_type, return_dict)

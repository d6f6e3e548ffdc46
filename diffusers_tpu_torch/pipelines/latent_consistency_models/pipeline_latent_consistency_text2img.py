"""Latent consistency model (LCM) text-to-image.

Port of `diffusers_tpu/pipelines/latent_consistency_models/pipeline_latent_consistency_text2img.py`:
no classifier-free guidance; the guidance scale enters the UNet as a
sinusoidal embedding of ``(guidance_scale - 1) * 1000`` through its
`time_cond_proj_dim` projection (`get_guidance_scale_embedding`, JAX
`:29-39`). Each step runs the LCM scheduler, which returns the denoised
sample beside the next latents, and the image decodes the last denoised
sample, not the latents.

Random draws go through `utils.torch_utils.randn_tensor`, from `generator`:
the initial latents (unless given), then one noise tensor for each step but
the last (the only steps that use one). JAX draws the step noise inside its
scheduler from a key folded with the step index (ROADMAP C3); at one step the
path draws no noise and is JAX's, given the same latents. The port raises on
a UNet without `time_cond_proj_dim` (JAX's pipeline fails there in the
UNet). JAX's loop reads no cache config; the port accepts none.
"""

from __future__ import annotations

import math
from typing import List, Optional, Union

import torch

from ...utils import torch_utils
from ..stable_diffusion.pipeline_stable_diffusion import StableDiffusionPipeline


def get_guidance_scale_embedding(w: torch.Tensor, embedding_dim: int = 512) -> torch.Tensor:
    """Sinusoidal embedding of ``w * 1000`` (w = guidance_scale - 1), float32
    [B, embedding_dim]: sines then cosines of ``embedding_dim / 2``
    frequencies, zero-padded to an odd `embedding_dim`."""
    w = w.float() * 1000.0
    half_dim = embedding_dim // 2
    freqs = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=w.device)
                      * (-math.log(10000.0) / (half_dim - 1)))
    emb = w[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    return torch.nn.functional.pad(emb, (0, 1)) if embedding_dim % 2 == 1 else emb


def guidance_embedding(unet, guidance_scale: float, batch_size: int, device) -> Optional[torch.Tensor]:
    """The UNet's ``timestep_cond``: the w-embedding at its
    `time_cond_proj_dim`, in its dtype; None for a UNet without one."""
    dim = unet.config.time_cond_proj_dim
    if dim is None:
        return None
    w = torch.full((batch_size,), guidance_scale - 1.0, dtype=torch.float32, device=device)
    return get_guidance_scale_embedding(w, dim).to(unet.dtype)


class LatentConsistencyModelPipeline(StableDiffusionPipeline):
    _supported_cache_configs = ()

    def _prepare(self, prompt, prompt_embeds, num_images_per_prompt, height, width, generator, latents):
        """(prompt_embeds, latents) of a consistency pipeline: the prompt's
        embeddings alone (no CFG batch), repeated per image, and the initial
        latents in the UNet's dtype."""
        device, dtype = self.unet.device, self.unet.dtype
        if prompt_embeds is None:
            prompt_embeds = self.encode_prompt(prompt, None, do_classifier_free_guidance=False)
        prompt_embeds = prompt_embeds.to(device).repeat_interleave(num_images_per_prompt, dim=0)
        height = height or self.unet.config.sample_size * self.vae_scale_factor
        width = width or self.unet.config.sample_size * self.vae_scale_factor
        shape = (prompt_embeds.shape[0], self.unet.config.in_channels, height // self.vae_scale_factor,
                 width // self.vae_scale_factor)
        if latents is None:
            latents = torch_utils.randn_tensor(shape, generator, device)
        return prompt_embeds, latents.to(device=device, dtype=dtype)

    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 4,
        guidance_scale: float = 8.5,
        num_images_per_prompt: int = 1,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        prompt_embeds: Optional[torch.Tensor] = None,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Text-to-image in a few consistency steps (4 by default)."""
        if self.unet.config.time_cond_proj_dim is None:
            raise ValueError("LatentConsistencyModelPipeline needs a UNet with `time_cond_proj_dim` (an LCM "
                             "distilled UNet): the guidance scale enters through it")
        prompt_embeds, latents = self._prepare(prompt, prompt_embeds, num_images_per_prompt, height, width,
                                               generator, latents)
        w_embedding = guidance_embedding(self.unet, guidance_scale, latents.shape[0], latents.device)
        state = self.scheduler.set_timesteps(num_inference_steps)
        latents = latents * state.init_noise_sigma
        timesteps_device = state.timesteps.to(latents.device)
        denoised = latents
        for i, t in enumerate(state.timesteps):
            noise_pred = self.unet(latents, timesteps_device[i], encoder_hidden_states=prompt_embeds,
                                   timestep_cond=w_embedding).sample
            noise = (None if self.scheduler.last_step(state, t)
                     else torch_utils.randn_tensor(latents.shape, generator, latents.device))
            out = self.scheduler.step(state, noise_pred, t, latents, variance_noise=noise)
            latents, denoised = out.prev_sample, out.denoised
        return self._output(denoised, output_type, return_dict)

"""Flux Control pipelines (FLUX.1-Canny-dev / FLUX.1-Depth-dev).

Port of `diffusers_tpu/pipelines/flux/pipeline_flux_control.py`: a Control
checkpoint doubles the transformer's input channels (`in_channels` 128); the
control image's latents (the posterior's sample, ``(z - shift_factor) *
scaling_factor``; a tensor that is not a 3-channel NCHW image is taken as
latents already) are packed and concatenated to the noisy latents on the
packed channel axis every step (`:43-82`). `FluxControlImg2ImgPipeline` and
`FluxControlInpaintPipeline` (`pipeline_flux_control_img2img.py`,
`pipeline_flux_control_inpaint.py`) add img2img's start and inpaint's blend.
A numpy array or PIL control image is preprocessed; a torch tensor is taken
as given (NCHW in [-1, 1]), as JAX takes a `jax.Array`. The port draws, from
one `torch.Generator` and in JAX's order of use, each encoder sample and the
noise. `enable_cache` raises.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ...utils import torch_utils
from ..inpaint_utils import repeat_to_batch
from .pipeline_flux import FluxPipeline


class FluxControlPipeline(FluxPipeline):
    """Text-to-image with the control latents concatenated on the channel axis."""

    _supported_cache_configs = ()

    def _control_pixels(self, control_image, height, width) -> torch.Tensor:
        """A control image on the VAE's device: a torch tensor as given, else
        preprocessed (PIL resized to `height` x `width`)."""
        if isinstance(control_image, torch.Tensor):
            return control_image.to(device=self.vae.device, dtype=self.vae.dtype)
        return self._preprocess(control_image, height, width)

    def _encode_pack_control(self, control_image, height, width, batch_size, generator=None) -> torch.Tensor:
        """The packed control latents [B, S, 4 C] (JAX `_encode_pack_control`)."""
        ci = self._control_pixels(control_image, height, width)
        if ci.ndim == 4 and ci.shape[1] == 3:
            ci = self._encode_image(ci, generator)
        return self._pack_latents(repeat_to_batch(ci.float(), batch_size, what="control image"))

    def _control_predict(self, control_latents, prompt_embeds, pooled, guidance, rope):
        """predict(latents, i, t) of `_loop`: the transformer over [latents ;
        control latents] on the channel axis."""
        control_latents = control_latents.to(prompt_embeds.dtype)
        return lambda latents, i, t: self.transformer(
            torch.cat([latents.to(prompt_embeds.dtype), control_latents], dim=2), encoder_hidden_states=prompt_embeds,
            pooled_projections=pooled, timestep=t, guidance=guidance, image_rotary_emb=rope).sample

    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        prompt_2: Optional[Union[str, List[str]]] = None,
        control_image=None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 28,
        guidance_scale: float = 3.5,
        num_images_per_prompt: int = 1,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        prompt_embeds: Optional[torch.Tensor] = None,
        pooled_prompt_embeds: Optional[torch.Tensor] = None,
        max_sequence_length: int = 512,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Text-to-image under `control_image` (a Canny edge map or a depth
        map as an image). `latents`, when given, are packed ([B, seq, 4 C])."""
        height = height or self.default_sample_size * self.vae_scale_factor
        width = width or self.default_sample_size * self.vae_scale_factor
        prompt_embeds, pooled, txt_ids, batch_size = self._prompt(
            prompt, prompt_2, prompt_embeds, pooled_prompt_embeds, max_sequence_length, num_images_per_prompt)
        control = self._encode_pack_control(control_image, height, width, batch_size, generator)
        lh = 2 * (height // (self.vae_scale_factor * 2))
        lw = 2 * (width // (self.vae_scale_factor * 2))
        if latents is None:  # control checkpoints double in_channels
            latents = self._pack_latents(torch_utils.randn_tensor(
                (batch_size, self.transformer.config.in_channels // 8, lh, lw), generator, control.device))
        latents = latents.to(device=control.device, dtype=torch.float32)
        rope = self._rope(txt_ids, self._prepare_latent_image_ids(lh // 2, lw // 2))
        state = self._schedule(latents.shape[1], num_inference_steps)
        latents = self._loop(latents, state, state.timesteps,
                             self._control_predict(control, prompt_embeds, pooled,
                                                   self._guidance(batch_size, guidance_scale), rope))
        return self._decode(latents, height, width, output_type, return_dict)

"""Flux Kontext pipeline (instruction edits with FLUX.1-Kontext-dev).

Port of `diffusers_tpu/pipelines/flux/pipeline_flux_kontext.py`: the
reference image is encoded with the posterior's mode, packed and appended to
the noise tokens on the sequence axis at every step (`:37`), with RoPE ids
whose first coordinate is 1 (`:98`); the prediction is cut back to the noise
tokens. At 1024 px with a 1024 px reference the joint stream is 512 text +
4,096 target + 4,096 reference = 8,704 tokens: kernel K1 at (1, 8704, 24,
128) and kernel K5 at M = 8,704 in the single blocks. mu comes from the
noise tokens alone, as in JAX. `enable_cache` raises.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ...utils import torch_utils
from .pipeline_flux import FluxPipeline


class FluxKontextPipeline(FluxPipeline):
    _supported_cache_configs = ()

    def _reference(self, image, batch_size, height=None, width=None):
        """(packed reference latents, their RoPE ids with first coordinate 1,
        their latent size, the image's size) of a reference image (the
        posterior's mode)."""
        packed, (lh, lw), hw = self._image_latents(image, None, batch_size, height, width, sample=False)
        ids = self._prepare_latent_image_ids(lh // 2, lw // 2)
        ids[..., 0] = 1  # the conditioning stream's marker
        return packed, ids, (lh, lw), hw

    def _kontext_predict(self, cond, prompt_embeds, pooled, guidance, rope):
        """predict(latents, i, t) of `_loop`: the transformer over [noise
        tokens ; `cond`], cut back to the noise tokens."""
        cond = cond.to(prompt_embeds.dtype)

        def predict(latents, i, t):
            seq = latents.shape[1]
            return self.transformer(torch.cat([latents.to(prompt_embeds.dtype), cond], dim=1),
                                    encoder_hidden_states=prompt_embeds, pooled_projections=pooled, timestep=t,
                                    guidance=guidance, image_rotary_emb=rope).sample[:, :seq]

        return predict

    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        prompt_2: Optional[Union[str, List[str]]] = None,
        image=None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 28,
        guidance_scale: float = 2.5,
        num_images_per_prompt: int = 1,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        prompt_embeds: Optional[torch.Tensor] = None,
        pooled_prompt_embeds: Optional[torch.Tensor] = None,
        max_sequence_length: int = 512,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """An edit of `image` (PIL, array or tensor) as `prompt` says; the
        output has the image's size unless `height` / `width` say otherwise.
        `latents`, when given, are packed ([B, seq, 4 C])."""
        prompt_embeds, pooled, txt_ids, batch_size = self._prompt(
            prompt, prompt_2, prompt_embeds, pooled_prompt_embeds, max_sequence_length, num_images_per_prompt)
        cond, cond_ids, _, (h, w) = self._reference(image, batch_size)
        height, width = height or h, width or w
        lh = 2 * (height // (self.vae_scale_factor * 2))
        lw = 2 * (width // (self.vae_scale_factor * 2))
        if latents is None:
            latents = self._pack_latents(torch_utils.randn_tensor(
                (batch_size, self.transformer.config.in_channels // 4, lh, lw), generator, cond.device))
        latents = latents.to(device=cond.device, dtype=torch.float32)
        rope = self._rope(txt_ids, self._prepare_latent_image_ids(lh // 2, lw // 2), cond_ids)
        state = self._schedule(latents.shape[1], num_inference_steps)
        latents = self._loop(latents, state, state.timesteps,
                             self._kontext_predict(cond, prompt_embeds, pooled,
                                                   self._guidance(batch_size, guidance_scale), rope))
        return self._decode(latents, height, width, output_type, return_dict)

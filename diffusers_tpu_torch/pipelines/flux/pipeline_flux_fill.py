"""Flux Fill pipeline (inpainting and outpainting with FLUX.1-Fill-dev).

Port of `diffusers_tpu/pipelines/flux/pipeline_flux_fill.py`: the masked
image (``image * (1 - mask)``, the mask taken as given, 1 where repainted)
is encoded with the posterior's sample and packed (64 channels); the pixel
mask goes to the latent size by an 8 x 8 space-to-depth (``vae_scale_factor
** 2`` = 64 channels) and is packed (256); every step feeds
``[latents ; masked-image latents ; mask]`` on the channel axis (64 + 320 =
384 = the Fill transformer's `in_channels`) and the prediction (64 channels)
steps the latents, over the whole mu-shifted schedule. The port draws the
encoder's sample, then (unless `latents` is given) the initial noise, from
one `torch.Generator`. `enable_cache` raises.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from ...utils import torch_utils
from ..inpaint_utils import repeat_to_batch
from .pipeline_flux import FluxPipeline


def _fill_mask_array(mask_image) -> np.ndarray:
    """The Fill mask as JAX reads it: an array or tensor of values in [0, 1]
    (not binarized), [H, W] -> [1, 1, H, W], [B, H, W] -> [B, 1, H, W]."""
    if isinstance(mask_image, torch.Tensor):
        mask_image = mask_image.detach().cpu().float().numpy()
    mask = np.asarray(mask_image, dtype=np.float32)
    if mask.ndim == 2:
        return mask[None, None]
    return mask[:, None] if mask.ndim == 3 else mask


class FluxFillPipeline(FluxPipeline):
    _supported_cache_configs = ()

    def prepare_mask_latents(self, mask: torch.Tensor, masked_image: torch.Tensor, batch_size: int,
                             generator=None) -> torch.Tensor:
        """mask [B, 1, H, W] and the masked image [B, 3, H, W] (pixel size) ->
        the packed conditioning [B, S, 4 C + 4 vsf^2] (JAX `:25-44`)."""
        masked = repeat_to_batch(self._encode_image(masked_image, generator), batch_size, what="image")
        vsf = self.vae_scale_factor
        lh, lw = masked.shape[2], masked.shape[3]
        m = repeat_to_batch(mask.float(), batch_size, what="mask")[:, 0]
        m = m.reshape(batch_size, lh, vsf, lw, vsf).permute(0, 2, 4, 1, 3).reshape(batch_size, vsf * vsf, lh, lw)
        return torch.cat([self._pack_latents(masked), self._pack_latents(m.to(masked.device))], dim=-1)

    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        prompt_2: Optional[Union[str, List[str]]] = None,
        image=None,
        mask_image=None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 50,
        guidance_scale: float = 30.0,
        num_images_per_prompt: int = 1,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        prompt_embeds: Optional[torch.Tensor] = None,
        pooled_prompt_embeds: Optional[torch.Tensor] = None,
        max_sequence_length: int = 512,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Fill. `image` as for img2img; `mask_image` an array or tensor
        ([H, W], [B, H, W] or [B, 1, H, W]) of the image's size, 1 where
        repainted; `latents`, when given, packed ([B, seq, 4 C])."""
        init = self._preprocess(image, height, width)
        height, width = height or init.shape[-2], width or init.shape[-1]
        mask = torch.from_numpy(_fill_mask_array(mask_image)).to(device=init.device, dtype=init.dtype)
        prompt_embeds, pooled, txt_ids, batch_size = self._prompt(
            prompt, prompt_2, prompt_embeds, pooled_prompt_embeds, max_sequence_length, num_images_per_prompt)
        cond = self.prepare_mask_latents(mask, init * (1 - mask), batch_size, generator)

        lh = 2 * (height // (self.vae_scale_factor * 2))
        lw = 2 * (width // (self.vae_scale_factor * 2))
        if latents is None:
            latents = self._pack_latents(torch_utils.randn_tensor(
                (batch_size, self.vae.config.latent_channels, lh, lw), generator, cond.device))
        latents = latents.to(device=cond.device, dtype=torch.float32)
        rope = self._rope(txt_ids, self._prepare_latent_image_ids(lh // 2, lw // 2))
        state = self._schedule(latents.shape[1], num_inference_steps)
        guidance = self._guidance(batch_size, guidance_scale)
        cond = cond.to(prompt_embeds.dtype)

        def predict(latents, i, t):
            return self.transformer(torch.cat([latents.to(prompt_embeds.dtype), cond], dim=2),
                                    encoder_hidden_states=prompt_embeds, pooled_projections=pooled, timestep=t,
                                    guidance=guidance, image_rotary_emb=rope).sample

        latents = self._loop(latents, state, state.timesteps, predict)
        return self._decode(latents, height, width, output_type, return_dict)

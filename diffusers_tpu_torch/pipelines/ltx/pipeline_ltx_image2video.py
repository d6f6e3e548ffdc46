"""LTX-Video image-to-video pipeline.

Port of `diffusers_tpu/pipelines/ltx/pipeline_ltx_image2video.py`: the
input image is encoded by the VAE (the posterior's sample) and normalized,
its latent fills the first latent frame, and the packed conditioning mask (1
on the first frame's tokens) zeroes those tokens' timestep (a per-token
timestep ``t (1 - mask)``) and freezes them across scheduler steps
(`:36-66`); the rest is the text-to-video pipeline's. The encoder's sample,
the noise and the decode's draws come from one `torch.Generator`, in that
order, where JAX splits one key four ways. JAX's loop here reads no cache
config, and this pipeline accepts none (ROADMAP C3).
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ...image_processor import VaeImageProcessor
from ...utils import torch_utils
from .pipeline_ltx import LTXPipeline


class LTXImageToVideoPipeline(LTXPipeline):
    _supported_cache_configs = ()

    @torch.no_grad()
    def _denoise_i2v(self, latents, cond_mask, embeds, mask, rope, state, guidance_scale, guidance_rescale,
                     do_cfg):
        ts = state.timesteps.to(latents.device)
        mask_input = torch.cat([cond_mask, cond_mask]) if do_cfg else cond_mask
        keep = cond_mask[..., None]
        for i, t in enumerate(state.timesteps):
            latent_input = torch.cat([latents, latents]) if do_cfg else latents
            timestep = ts[i] * (1.0 - mask_input)  # the conditioned tokens run at timestep 0
            noise_pred = self.transformer(latent_input.to(embeds.dtype), embeds, timestep, encoder_attention_mask=mask,
                                          image_rotary_emb=rope).sample.float()
            noise_pred = self._guide(noise_pred, do_cfg, guidance_scale, guidance_rescale)
            prev = self.scheduler.step(state, noise_pred, t, latents).prev_sample
            latents = keep * latents + (1.0 - keep) * prev
        return latents

    @torch.no_grad()
    def __call__(
        self,
        image=None,
        prompt: Union[str, List[str]] = None,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        height: int = 512,
        width: int = 704,
        num_frames: int = 161,
        frame_rate: int = 25,
        num_inference_steps: int = 50,
        guidance_scale: float = 3.0,
        guidance_rescale: float = 0.0,
        generator: Optional[torch.Generator] = None,
        decode_timestep: float = 0.0,
        decode_noise_scale: Optional[float] = None,
        max_sequence_length: int = 128,
        output_type: str = "np",
        return_dict: bool = True,
    ):
        """Image-to-video: `image` (PIL, or an array or tensor HWC / NHWC /
        NCHW) is the first frame."""
        device = self.transformer.device
        do_cfg = guidance_scale > 1.0
        embeds, mask, batch_size = self._prompt(prompt, negative_prompt, do_cfg, max_sequence_length)
        grid = self._latent_grid(height, width, num_frames)
        p, pt = self.transformer_spatial_patch_size, self.transformer_temporal_patch_size

        pixels = torch.from_numpy(VaeImageProcessor(vae_scale_factor=self.vae_spatial_compression_ratio)
                                  .preprocess(image, height, width)).to(device=self.vae.device, dtype=self.vae.dtype)
        init = self.vae.encode(pixels[:, :, None]).latent_dist.sample(generator).float()
        init = self._normalize_latents(init, self.vae.latents_mean, self.vae.latents_std,
                                       self.vae.config.scaling_factor).to(device)
        shape = (batch_size, self.transformer.config.in_channels, *grid)
        init = init[:, :, :1].expand(shape)
        cond_mask_5d = torch.zeros((batch_size, 1, *grid), device=device)
        cond_mask_5d[:, :, 0] = 1.0
        noise = torch_utils.randn_tensor(shape, generator, device)
        latents = self._pack_latents(init * cond_mask_5d + noise * (1 - cond_mask_5d), p, pt)
        cond_mask = self._pack_latents(cond_mask_5d, p, pt)[..., 0]

        rope = self._rope(*grid, frame_rate)
        state = self._schedule(latents.shape[1], num_inference_steps)
        latents = self._denoise_i2v(latents, cond_mask, embeds, mask, rope, state, guidance_scale, guidance_rescale,
                                    do_cfg)
        return self._decode(latents, grid, generator, decode_timestep, decode_noise_scale, output_type, return_dict)

"""HunyuanVideo 1.5 image-to-video pipeline.

Port of `diffusers_tpu/pipelines/hunyuan_video1_5/pipeline_hunyuan_video1_5_image2video.py`:
the text-to-video pipeline's prompts, guidance, schedule and decode, plus

* SigLIP's semantic image embeds (729 tokens at so400m's 384 px), the image
  preprocessed as FramePack's is (`siglip_image_embeds`: mapped to [0, 1]
  for the feature extractor where there is one, else the raw [-1, 1]
  pixels), broadcast over the batch (`:47-60`);
* the first frame's condition latents: the image through the VAE's encoder,
  the posterior's mode times ``scaling_factor``, later frames zeroed, and
  the mask 1 on frame 0 only (`:62-75`).

`image` is a [-1, 1] array or tensor, [C, H, W] or [B, C, H, W], at the
request's height and width. JAX hands the [-1, 1] image to the feature
extractor with its default rescale; the port gives it the [0, 1] image with
``do_rescale=False`` (ROADMAP C3). Caches as text-to-video: the
guidance-free path only.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from ..hunyuan_image.pipeline_hunyuanimage import linspace_schedule
from ..hunyuan_video.pipeline_hunyuan_video_framepack import siglip_image_embeds
from .pipeline_hunyuan_video1_5 import (
    HunyuanVideo15Pipeline,
    HunyuanVideo15PipelineOutput,
    calculate_default_height_width,
)


class HunyuanVideo15ImageToVideoPipeline(HunyuanVideo15Pipeline):
    _optional_components = ["guider", "image_encoder", "feature_extractor"]

    def __init__(self, text_encoder, tokenizer, transformer, vae, scheduler, text_encoder_2, tokenizer_2,
                 guider=None, image_encoder=None, feature_extractor=None, device: Union[str, torch.device] = "cuda"):
        super().__init__(text_encoder, tokenizer, transformer, vae, scheduler, text_encoder_2, tokenizer_2,
                         guider=guider, device=device)
        self.register_modules(image_encoder=image_encoder, feature_extractor=feature_extractor)
        self._place(device)

    @torch.no_grad()
    def encode_image(self, image, batch_size: int) -> torch.Tensor:
        """SigLIP's last hidden state, [batch_size, 729, 1152] at so400m."""
        image = np.asarray(image.float().cpu() if isinstance(image, torch.Tensor) else image, np.float32)
        embeds = siglip_image_embeds(self.image_encoder, self.feature_extractor, image if image.ndim == 4 else image[None])
        return embeds.expand(batch_size, *embeds.shape[1:])

    @torch.no_grad()
    def prepare_cond_latents_and_mask_i2v(self, latents, image):
        """The first frame's VAE latents (the posterior's mode, scaled), zeros
        after it, and the mask 1 on frame 0 only."""
        vae = self.vae
        b, c, f, lh, lw = latents.shape
        img = torch.as_tensor(np.asarray(image.float().cpu() if isinstance(image, torch.Tensor) else image,
                                         np.float32), device=vae.device)
        img = img if img.ndim == 4 else img[None]
        first = vae.encode(img[:, :, None].to(vae.dtype)).latent_dist.mode().float() * vae.config.scaling_factor
        cond = torch.zeros_like(latents)
        cond[:, :, :1] = first.expand(b, c, 1, lh, lw)
        mask = torch.zeros((b, 1, f, lh, lw), dtype=latents.dtype, device=latents.device)
        mask[:, :, 0] = 1.0
        return cond, mask

    @torch.no_grad()
    def __call__(
        self,
        image=None,
        prompt: Union[str, List[str]] = None,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_frames: int = 121,
        num_inference_steps: int = 50,
        sigmas: Optional[List[float]] = None,
        guidance_scale: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        image_embeds: Optional[torch.Tensor] = None,
        output_type: str = "np",
        return_dict: bool = True,
    ):
        """Image-to-video from `image` (see the module docstring); frames
        [B, F, H, W, C] ("np") or the final latents ("latent")."""
        if height is None and width is None:
            shape = np.shape(image)
            ih, iw = shape[-2:] if len(shape) >= 3 else self.default_aspect_ratio[::-1]
            height, width = calculate_default_height_width(ih, iw, self.target_size, self.vae_scale_factor_spatial)
        guider, do_cfg = self._guider(guidance_scale)
        conditioning = self._conditioning(prompt, negative_prompt, do_cfg)
        batch_size = conditioning[-1]
        state = linspace_schedule(self.scheduler, num_inference_steps, sigmas)
        latents = self._latents(batch_size, num_frames, height, width, generator, latents)
        cond_latents, mask_latents = self.prepare_cond_latents_and_mask_i2v(latents, image)
        if image_embeds is None:
            image_embeds = self.encode_image(image, batch_size)
        latents = self._denoise(latents, cond_latents, mask_latents, image_embeds.to(latents.device).float(),
                                conditioning, state, guider, do_cfg)
        video = latents if output_type == "latent" else self.decode_latents(latents)
        if not return_dict:
            return (video,)
        return HunyuanVideo15PipelineOutput(frames=video)

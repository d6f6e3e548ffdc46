"""LTX-Video latent upsample pipeline (2x upscale in latent space).

Port of `diffusers_tpu/pipelines/ltx/pipeline_ltx_latent_upsample.py`:
normalized latents (or a video, encoded by the VAE: the posterior's sample,
trimmed to 1 + 8 k frames) are de-normalized, run through
`LTXLatentUpsamplerModel`, optionally matched to the input's per-(batch,
channel) statistics (`adain_filter_latent`) and tone-mapped
(`tone_map_latents`), then re-normalized ("latent") or decoded as the
text-to-video pipeline decodes. The encoder's sample and the decode's draws
come from one `torch.Generator`, in that order.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ...video_processor import VideoProcessor
from ..pipeline_utils import DiffusionPipeline
from .pipeline_ltx import LTXPipeline, LTXPipelineOutput


def adain_filter_latent(latents: torch.Tensor, reference_latents: torch.Tensor, factor: float = 1.0) -> torch.Tensor:
    """Per-(batch, channel) AdaIN toward the reference's statistics (sample
    standard deviations)."""
    dims = tuple(range(2, latents.ndim))
    i_mean, i_sd = latents.mean(dim=dims, keepdim=True), latents.std(dim=dims, keepdim=True, correction=1)
    r_mean = reference_latents.mean(dim=dims, keepdim=True)
    r_sd = reference_latents.std(dim=dims, keepdim=True, correction=1)
    result = ((latents - i_mean) / i_sd) * r_sd + r_mean
    return latents + factor * (result - latents)


def tone_map_latents(latents: torch.Tensor, compression: float) -> torch.Tensor:
    """Sigmoid compression of the latents' dynamic range."""
    scale_factor = compression * 0.75
    sigmoid_term = torch.sigmoid(4.0 * scale_factor * (latents.abs() - 1.0))
    return latents * (1.0 - 0.8 * scale_factor * sigmoid_term)


class LTXLatentUpsamplePipeline(DiffusionPipeline):
    _normalize_latents = staticmethod(LTXPipeline._normalize_latents)
    _denormalize_latents = staticmethod(LTXPipeline._denormalize_latents)
    decode_video = LTXPipeline.decode_video

    def __init__(self, vae, latent_upsampler, device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.register_modules(vae=vae, latent_upsampler=latent_upsampler)
        self.vae_spatial_compression_ratio = vae.spatial_compression_ratio if vae is not None else 32
        self.vae_temporal_compression_ratio = vae.temporal_compression_ratio if vae is not None else 8
        self.video_processor = VideoProcessor(vae_scale_factor=self.vae_spatial_compression_ratio)
        self._place(device)

    @torch.no_grad()
    def upsample(self, latents: torch.Tensor, adain_factor: float = 0.0, tone_map_compression_ratio: float = 0.0):
        """De-normalized latents [B, C, F, H, W] of normalized ones, upsampled,
        AdaIN-matched and tone-mapped as asked."""
        vae = self.vae
        lat = self._denormalize_latents(latents.float(), vae.latents_mean, vae.latents_std, vae.config.scaling_factor)
        up = self.latent_upsampler(lat.to(self.latent_upsampler.dtype)).float()
        if adain_factor > 0.0:
            up = adain_filter_latent(up, lat, adain_factor)
        if tone_map_compression_ratio > 0.0:
            up = tone_map_latents(up, tone_map_compression_ratio)
        return up

    @torch.no_grad()
    def __call__(
        self,
        video=None,
        height: int = 512,
        width: int = 704,
        latents: Optional[torch.Tensor] = None,
        decode_timestep: float = 0.0,
        decode_noise_scale: Optional[float] = None,
        adain_factor: float = 0.0,
        tone_map_compression_ratio: float = 0.0,
        generator: Optional[torch.Generator] = None,
        output_type: str = "np",
        return_dict: bool = True,
    ):
        """Exactly one of `video` and `latents` (normalized, [B, C, F, H, W]).
        "latent" returns the upsampled latents normalized again; "np" the
        decoded frames [B, F, H, W, C] in [0, 1]."""
        vae = self.vae
        if (video is None) == (latents is None):
            raise ValueError("Provide exactly one of `video` or `latents`.")
        if not 0 <= tone_map_compression_ratio <= 1:
            raise ValueError("`tone_map_compression_ratio` must be in [0, 1]")
        if video is not None:
            vid = torch.from_numpy(self.video_processor.preprocess_video(video, height=height, width=width))
            ratio = self.vae_temporal_compression_ratio
            if vid.shape[2] % ratio != 1:
                vid = vid[:, :, : vid.shape[2] // ratio * ratio + 1]
            latents = vae.encode(vid.to(device=vae.device, dtype=vae.dtype)).latent_dist.sample(generator).float()
            latents = self._normalize_latents(latents, vae.latents_mean, vae.latents_std, vae.config.scaling_factor)
        up = self.upsample(latents.to(self.latent_upsampler.device), adain_factor, tone_map_compression_ratio)
        if output_type == "latent":
            out = self._normalize_latents(up, vae.latents_mean, vae.latents_std, vae.config.scaling_factor)
        else:
            out = self.decode_video(up, generator, decode_timestep, decode_noise_scale)
        if not return_dict:
            return (out,)
        return LTXPipelineOutput(frames=out)

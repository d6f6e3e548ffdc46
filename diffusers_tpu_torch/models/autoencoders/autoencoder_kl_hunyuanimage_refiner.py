"""AutoencoderKLHunyuanImageRefiner: HunyuanImage-2.1's refiner VAE, a causal
3-D DCAE-style VAE with L2-RMS norms (16x in space, 32 latent channels;
widths (128, 256, 512, 1024, 1024) published).

Port of `diffusers_tpu/models/autoencoders/autoencoder_kl_hunyuanimage_refiner.py`
over NCDHW activations, with upstream diffusers' state-dict names. It is
HunyuanVideo 1.5's VAE (`autoencoder_kl_hunyuanvideo15.py`: the same norms,
causal convs, resnets, block schedules and residual heads) with two
differences, both JAX's:

* the DCAE up- and downsamplers shuffle every frame in space only
  (`:134-191`): a "temporal" sampler doubles or halves the channels where
  HunyuanVideo 1.5's moves them into frames, so the frame count never
  changes;
* the mid block's single-head attention sees every token of every frame
  (`:100-119`, no causal mask). It runs ``native`` (head_dim = 1,024).

No pipeline of the JAX package uses it, so the port has none. No GroupNorm:
this VAE runs no kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ..modeling_utils import ModelMixin
from .autoencoder_kl_hunyuan_video import HYCausalConv3d
from .autoencoder_kl_hunyuanvideo15 import (
    AutoencoderKLOutput,
    HunyuanVideo15Decoder3D,
    HunyuanVideo15Encoder3D,
    _group_mean,
    _shuffle_down,
    _shuffle_up,
)
from .vae import DecoderOutput, DiagonalGaussianDistribution


class HunyuanImageRefinerDownsample(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, add_temporal_downsample: bool = True):
        super().__init__()
        factor = 8 if add_temporal_downsample else 4
        self.conv = HYCausalConv3d(in_channels, out_channels // factor, 3)
        self.add_temporal_downsample = add_temporal_downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _shuffle_down(self.conv(x), 1, 2, 2)
        if self.add_temporal_downsample:
            h = torch.cat([h, h], dim=1)
        return h + _group_mean(_shuffle_down(x, 1, 2, 2), h.shape[1])


class HunyuanImageRefinerUpsample(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, add_temporal_upsample: bool = True):
        super().__init__()
        factor = 8 if add_temporal_upsample else 4
        self.conv = HYCausalConv3d(in_channels, out_channels * factor, 3)
        self.add_temporal_upsample = add_temporal_upsample
        self.repeats = factor * out_channels // in_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _shuffle_up(self.conv(x), 1, 2, 2)
        if self.add_temporal_upsample:
            return h[:, :h.shape[1] // 2] + _shuffle_up(x, 1, 2, 2).repeat_interleave(self.repeats // 2, dim=1)
        return h + _shuffle_up(x.repeat_interleave(self.repeats, dim=1), 1, 2, 2)


class AutoencoderKLHunyuanImageRefiner(ModelMixin, ConfigMixin):
    """Video in and out as [B, C, T, H, W]."""

    @register_to_config
    def __init__(
        self,
        in_channels: int = 3,
        out_channels: int = 3,
        latent_channels: int = 32,
        block_out_channels: Tuple[int, ...] = (128, 256, 512, 1024, 1024),
        layers_per_block: int = 2,
        spatial_compression_ratio: int = 16,
        temporal_compression_ratio: int = 4,
        downsample_match_channel: bool = True,
        upsample_match_channel: bool = True,
        scaling_factor: float = 1.03682,
    ):
        super().__init__()
        block_out_channels = tuple(block_out_channels)
        self.encoder = HunyuanVideo15Encoder3D(in_channels, 2 * latent_channels, block_out_channels,
                                               layers_per_block, temporal_compression_ratio,
                                               spatial_compression_ratio, downsample_match_channel,
                                               downsample_cls=HunyuanImageRefinerDownsample, causal_attention=False)
        self.decoder = HunyuanVideo15Decoder3D(latent_channels, out_channels, tuple(reversed(block_out_channels)),
                                               layers_per_block, spatial_compression_ratio,
                                               temporal_compression_ratio, upsample_match_channel,
                                               upsample_cls=HunyuanImageRefinerUpsample, causal_attention=False)

    def encode(self, x: torch.Tensor, return_dict: bool = True):
        posterior = DiagonalGaussianDistribution(self.encoder(x))
        return AutoencoderKLOutput(latent_dist=posterior) if return_dict else (posterior,)

    def decode(self, z: torch.Tensor, return_dict: bool = True):
        dec = self.decoder(z)
        return DecoderOutput(sample=dec) if return_dict else (dec,)

    def forward(self, sample: torch.Tensor, sample_posterior: bool = False, generator=None, return_dict: bool = True):
        posterior = self.encode(sample).latent_dist
        z = posterior.sample(generator) if sample_posterior else posterior.mode()
        return self.decode(z, return_dict=return_dict)

"""AutoencoderKLHunyuanImage: HunyuanImage-2.1's 32x image VAE (64 latent
channels; widths (128, 256, 512, 512, 1024, 1024) published).

Port of `diffusers_tpu/models/autoencoders/autoencoder_kl_hunyuanimage.py`
over NCHW activations, with upstream diffusers' state-dict names:

* the resnet: GroupNorm(32) + SiLU (kernel K4 on the card, through the
  port's `GroupNorm` with ``apply_silu=True``) and a 3 x 3 conv, twice; the
  1 x 1 shortcut conv applies to the branch, as in JAX (`:56-60`);
* pixel (un)shuffles with channel order ``(r1, r2, c)``: the downsample's
  shortcut is the mean of consecutive channel groups, the upsample's a
  channel repeat (`:97-118`);
* the mid block's single-head attention over the H W tokens after a
  GroupNorm (K4, no SiLU); head_dim = 1,024, so it runs ``native``;
* the encoder's group-mean residual and the decoder's channel-repeat
  residual (`:160`, `:188`); `norm_out` is GroupNorm + SiLU (K4).

A decode at full width runs 42 GroupNorms: 5 in the mid block, 36 in the
six up blocks' resnets and `norm_out`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...ops.attention import dispatch_attention_fn
from ...ops.module import Conv2d, GroupNorm
from ...utils import BaseOutput
from ..modeling_utils import ModelMixin
from .autoencoder_kl_hunyuanvideo15 import _group_mean
from .vae import DecoderOutput, DiagonalGaussianDistribution


@dataclass
class AutoencoderKLOutput(BaseOutput):
    latent_dist: DiagonalGaussianDistribution


class HunyuanImageResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = GroupNorm(32, in_channels, eps=1e-6)
        self.conv1 = Conv2d(in_channels, out_channels, kernel_size=3, padding=1)
        self.norm2 = GroupNorm(32, out_channels, eps=1e-6)
        self.conv2 = Conv2d(out_channels, out_channels, kernel_size=3, padding=1)
        self.conv_shortcut = Conv2d(in_channels, out_channels, kernel_size=1) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x, apply_silu=True))
        h = self.conv2(self.norm2(h, apply_silu=True))
        if self.conv_shortcut is not None:
            h = self.conv_shortcut(h)
        return h + x


class HunyuanImageAttentionBlock(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.norm = GroupNorm(32, in_channels, eps=1e-6)
        self.to_q = Conv2d(in_channels, in_channels, kernel_size=1)
        self.to_k = Conv2d(in_channels, in_channels, kernel_size=1)
        self.to_v = Conv2d(in_channels, in_channels, kernel_size=1)
        self.proj = Conv2d(in_channels, in_channels, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        normed = self.norm(x)

        def tokens(conv):
            return conv(normed).flatten(2).transpose(1, 2).reshape(b, h * w, 1, c).contiguous()

        out = dispatch_attention_fn(tokens(self.to_q), tokens(self.to_k), tokens(self.to_v))
        out = out.reshape(b, h * w, c).transpose(1, 2).reshape(b, c, h, w).to(x.dtype)
        return self.proj(out) + x


def _pixel_unshuffle(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, 4 C, H / 2, W / 2], channel order (r1, r2, c)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, 4 * c, h // 2, w // 2)


def _pixel_shuffle(x: torch.Tensor) -> torch.Tensor:
    """[B, 4 C, H, W] -> [B, C, 2 H, 2 W], channel order (r1, r2, c)."""
    b, c4, h, w = x.shape
    x = x.reshape(b, 2, 2, c4 // 4, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, c4 // 4, 2 * h, 2 * w)


class HunyuanImageDownsample(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels // 4, kernel_size=3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _pixel_unshuffle(self.conv(x))
        return h + _group_mean(_pixel_unshuffle(x), h.shape[1])


class HunyuanImageUpsample(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels * 4, kernel_size=3, padding=1)
        self.repeats = 4 * out_channels // in_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _pixel_shuffle(self.conv(x)) + _pixel_shuffle(x.repeat_interleave(self.repeats, dim=1))


class HunyuanImageMidBlock(nn.Module):
    def __init__(self, in_channels: int, num_layers: int = 1):
        super().__init__()
        self.resnets = nn.ModuleList([HunyuanImageResnetBlock(in_channels, in_channels)
                                      for _ in range(num_layers + 1)])
        self.attentions = nn.ModuleList([HunyuanImageAttentionBlock(in_channels) for _ in range(num_layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        for attn, resnet in zip(self.attentions, self.resnets[1:]):
            x = resnet(attn(x))
        return x


class HunyuanImageEncoder2D(nn.Module):
    def __init__(self, in_channels, z_channels, block_out_channels, num_res_blocks, spatial_compression_ratio,
                 downsample_match_channel: bool = True):
        super().__init__()
        self.out_channels = 2 * z_channels
        self.conv_in = Conv2d(in_channels, block_out_channels[0], kernel_size=3, padding=1)
        blocks, ch = [], block_out_channels[0]
        n_down = int(math.log2(spatial_compression_ratio))
        for i, out_ch in enumerate(block_out_channels):
            for _ in range(num_res_blocks):
                blocks.append(HunyuanImageResnetBlock(ch, out_ch))
                ch = out_ch
            if i < n_down and i != len(block_out_channels) - 1:
                if downsample_match_channel:
                    out_ch = block_out_channels[i + 1]
                blocks.append(HunyuanImageDownsample(ch, out_ch))
                ch = out_ch
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = HunyuanImageMidBlock(block_out_channels[-1])
        self.norm_out = GroupNorm(32, block_out_channels[-1], eps=1e-6)
        self.conv_out = Conv2d(block_out_channels[-1], 2 * z_channels, kernel_size=3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(self.norm_out(x, apply_silu=True)) + _group_mean(x, self.out_channels)


class HunyuanImageDecoder2D(nn.Module):
    def __init__(self, z_channels, out_channels, block_out_channels, num_res_blocks, spatial_compression_ratio,
                 upsample_match_channel: bool = True):
        super().__init__()
        self.repeat = block_out_channels[0] // z_channels
        self.conv_in = Conv2d(z_channels, block_out_channels[0], kernel_size=3, padding=1)
        self.mid_block = HunyuanImageMidBlock(block_out_channels[0])
        blocks, ch = [], block_out_channels[0]
        n_up = int(math.log2(spatial_compression_ratio))
        for i, out_ch in enumerate(block_out_channels):
            for _ in range(num_res_blocks + 1):
                blocks.append(HunyuanImageResnetBlock(ch, out_ch))
                ch = out_ch
            if i < n_up and i != len(block_out_channels) - 1:
                if upsample_match_channel:
                    out_ch = block_out_channels[i + 1]
                blocks.append(HunyuanImageUpsample(ch, out_ch))
                ch = out_ch
        self.up_blocks = nn.ModuleList(blocks)
        self.norm_out = GroupNorm(32, block_out_channels[-1], eps=1e-6)
        self.conv_out = Conv2d(block_out_channels[-1], out_channels, kernel_size=3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z) + z.repeat_interleave(self.repeat, dim=1)
        h = self.mid_block(h)
        for block in self.up_blocks:
            h = block(h)
        return self.conv_out(self.norm_out(h, apply_silu=True))


class AutoencoderKLHunyuanImage(ModelMixin, ConfigMixin):
    """Images in and out as [B, C, H, W]."""

    @register_to_config
    def __init__(
        self,
        in_channels: int = 3,
        out_channels: int = 3,
        latent_channels: int = 64,
        block_out_channels: Tuple[int, ...] = (128, 256, 512, 512, 1024, 1024),
        layers_per_block: int = 2,
        spatial_compression_ratio: int = 32,
        sample_size: int = 384,
        scaling_factor: Optional[float] = 0.75289,
        downsample_match_channel: bool = True,
        upsample_match_channel: bool = True,
    ):
        super().__init__()
        block_out_channels = tuple(block_out_channels)
        self.encoder = HunyuanImageEncoder2D(in_channels, latent_channels, block_out_channels, layers_per_block,
                                             spatial_compression_ratio, downsample_match_channel)
        self.decoder = HunyuanImageDecoder2D(latent_channels, out_channels, tuple(reversed(block_out_channels)),
                                             layers_per_block, spatial_compression_ratio, upsample_match_channel)

    def encode(self, x: torch.Tensor, return_dict: bool = True):
        """x [B, C, H, W] in [-1, 1] -> the posterior over [B, 2 z, H / 32, W / 32] moments."""
        posterior = DiagonalGaussianDistribution(self.encoder(x))
        return AutoencoderKLOutput(latent_dist=posterior) if return_dict else (posterior,)

    def decode(self, z: torch.Tensor, return_dict: bool = True):
        dec = self.decoder(z)
        return DecoderOutput(sample=dec) if return_dict else (dec,)

    def forward(self, sample: torch.Tensor, sample_posterior: bool = False, generator=None, return_dict: bool = True):
        posterior = self.encode(sample).latent_dist
        z = posterior.sample(generator) if sample_posterior else posterior.mode()
        return self.decode(z, return_dict=return_dict)

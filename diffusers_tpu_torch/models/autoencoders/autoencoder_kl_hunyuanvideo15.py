"""AutoencoderKLHunyuanVideo15: HunyuanVideo 1.5's causal 3-D VAE (16x in
space, 4x in time, 32 latent channels; widths (128, 256, 512, 1024, 1024)
published).

Port of `diffusers_tpu/models/autoencoders/autoencoder_kl_hunyuanvideo15.py`
over NCDHW activations, with upstream diffusers' state-dict names:

* `HunyuanVideo15RMSNorm` (`:41`): the channel vector divided by its L2
  norm (in f32), times ``sqrt(C) * gamma``; ``gamma`` keeps upstream's
  ``[C, 1, 1, 1]`` layout;
* replicate-padded causal convs: HunyuanVideo's `HYCausalConv3d`, which
  convolves an input over 1 GiB a span of output frames at a time;
* DCAE shuffles (`_shuffle_down`, `_shuffle_up`, channel order
  ``(r1, r2, r3, c)``) in which the first frame is shuffled in space only
  (`:132-182`): the down shortcut is a mean over channel groups, the up
  shortcut a channel repeat;
* the encoder's group-mean residual and the decoder's channel-repeat
  residual (`:333`, `:375`);
* the mid block's single-head attention (head_dim = the last width, 1,024
  published, so it runs ``native``) under JAX's frame-causal rule
  (`:85-90`), served a query frame at a time by `frame_causal_sdpa`: JAX
  builds a dense ``[N, N]`` keep-mask over the N latent tokens (0.8 GB of
  f32 logits at 480 x 848 x 33, 9.7 GB at 121 frames), the port no
  ``[N, N]`` tensor (ROADMAP C3).

No GroupNorm: this VAE runs no kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...ops.attention import dispatch_attention_fn
from ...ops.module import Conv3d
from ...utils import BaseOutput
from ..modeling_utils import ModelMixin
from .autoencoder_kl_hunyuan_video import HYCausalConv3d, frame_causal_sdpa
from .vae import DecoderOutput, DiagonalGaussianDistribution


@dataclass
class AutoencoderKLOutput(BaseOutput):
    latent_dist: DiagonalGaussianDistribution


class HunyuanVideo15RMSNorm(nn.Module):
    """``x / max(||x||_2, 1e-12) * sqrt(C) * gamma`` over the channel axis
    (dim 1); the normalisation in f32, cast back to x's dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.gamma = nn.Parameter(torch.ones(dim, 1, 1, 1))

    def reset_parameters(self) -> None:
        nn.init.ones_(self.gamma)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        normed = F.normalize(x.float(), dim=1, eps=1e-12).to(x.dtype)
        return normed * (self.dim ** 0.5) * self.gamma.reshape(1, -1, 1, 1, 1).to(x.dtype)


def _shuffle_down(x: torch.Tensor, r1: int, r2: int, r3: int) -> torch.Tensor:
    """(b, c, f r1, h r2, w r3) -> (b, r1 r2 r3 c, f, h, w), channel order (r1, r2, r3, c)."""
    b, c, pf, ph, pw = x.shape
    f, h, w = pf // r1, ph // r2, pw // r3
    x = x.reshape(b, c, f, r1, h, r2, w, r3).permute(0, 3, 5, 7, 1, 2, 4, 6)
    return x.reshape(b, r1 * r2 * r3 * c, f, h, w)


def _shuffle_up(x: torch.Tensor, r1: int, r2: int, r3: int) -> torch.Tensor:
    """(b, r1 r2 r3 c, f, h, w) -> (b, c, f r1, h r2, w r3)."""
    b, pc, f, h, w = x.shape
    c = pc // (r1 * r2 * r3)
    x = x.reshape(b, r1, r2, r3, c, f, h, w).permute(0, 4, 5, 1, 6, 2, 7, 3)
    return x.reshape(b, c, f * r1, h * r2, w * r3)


def _group_mean(x: torch.Tensor, out_channels: int) -> torch.Tensor:
    """The mean of each run of ``C / out_channels`` consecutive channels."""
    b, c = x.shape[:2]
    return x.reshape(b, out_channels, c // out_channels, *x.shape[2:]).mean(dim=2)


class HunyuanVideo15AttnBlock(nn.Module):
    """Single-head attention over the T H W tokens; `causal`: a query of
    frame f sees the keys of frames 0..f (HunyuanVideo 1.5), else every key
    (the refiner VAE)."""

    def __init__(self, in_channels: int, causal: bool = True):
        super().__init__()
        self.causal = causal
        self.norm = HunyuanVideo15RMSNorm(in_channels)
        self.to_q = Conv3d(in_channels, in_channels, kernel_size=1)
        self.to_k = Conv3d(in_channels, in_channels, kernel_size=1)
        self.to_v = Conv3d(in_channels, in_channels, kernel_size=1)
        self.proj_out = Conv3d(in_channels, in_channels, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, h, w = x.shape
        normed = self.norm(x)

        def tokens(conv):
            return conv(normed).flatten(2).transpose(1, 2).reshape(b, t * h * w, 1, c).contiguous()

        q, k, v = tokens(self.to_q), tokens(self.to_k), tokens(self.to_v)
        if self.causal:
            out = frame_causal_sdpa(q, k, v, h * w)
        else:
            out = dispatch_attention_fn(q, k, v)
        out = out.reshape(b, t * h * w, c).transpose(1, 2).reshape(b, c, t, h, w).to(x.dtype)
        return self.proj_out(out) + x


class HunyuanVideo15Downsample(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, add_temporal_downsample: bool = True):
        super().__init__()
        factor = 8 if add_temporal_downsample else 4
        self.conv = HYCausalConv3d(in_channels, out_channels // factor, 3)
        self.add_temporal_downsample = add_temporal_downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x)
        if not self.add_temporal_downsample:
            h = _shuffle_down(h, 1, 2, 2)
            return h + _group_mean(_shuffle_down(x, 1, 2, 2), h.shape[1])
        first = _shuffle_down(h[:, :, :1], 1, 2, 2)
        h = torch.cat([torch.cat([first, first], dim=1), _shuffle_down(h[:, :, 1:], 2, 2, 2)], dim=2)
        shortcut = torch.cat([_group_mean(_shuffle_down(x[:, :, :1], 1, 2, 2), h.shape[1]),
                              _group_mean(_shuffle_down(x[:, :, 1:], 2, 2, 2), h.shape[1])], dim=2)
        return h + shortcut


class HunyuanVideo15Upsample(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, add_temporal_upsample: bool = True):
        super().__init__()
        factor = 8 if add_temporal_upsample else 4
        self.conv = HYCausalConv3d(in_channels, out_channels * factor, 3)
        self.add_temporal_upsample = add_temporal_upsample
        self.repeats = factor * out_channels // in_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x)
        if not self.add_temporal_upsample:
            return _shuffle_up(h, 1, 2, 2) + _shuffle_up(x.repeat_interleave(self.repeats, dim=1), 1, 2, 2)
        first = _shuffle_up(h[:, :, :1], 1, 2, 2)
        h = torch.cat([first[:, :first.shape[1] // 2], _shuffle_up(h[:, :, 1:], 2, 2, 2)], dim=2)
        shortcut = torch.cat([_shuffle_up(x[:, :, :1], 1, 2, 2).repeat_interleave(self.repeats // 2, dim=1),
                              _shuffle_up(x[:, :, 1:], 2, 2, 2).repeat_interleave(self.repeats, dim=1)], dim=2)
        return h + shortcut


class HunyuanVideo15ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: Optional[int] = None):
        super().__init__()
        out_channels = out_channels or in_channels
        self.norm1 = HunyuanVideo15RMSNorm(in_channels)
        self.conv1 = HYCausalConv3d(in_channels, out_channels, 3)
        self.norm2 = HunyuanVideo15RMSNorm(out_channels)
        self.conv2 = HYCausalConv3d(out_channels, out_channels, 3)
        self.conv_shortcut = Conv3d(in_channels, out_channels, kernel_size=1) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        x = self.conv1(F.silu(self.norm1(x)))
        return self.conv2(F.silu(self.norm2(x))) + residual


class HunyuanVideo15MidBlock(nn.Module):
    def __init__(self, in_channels: int, num_layers: int = 1, add_attention: bool = True, causal: bool = True):
        super().__init__()
        self.add_attention = add_attention
        self.resnets = nn.ModuleList([HunyuanVideo15ResnetBlock(in_channels) for _ in range(num_layers + 1)])
        self.attentions = nn.ModuleList([HunyuanVideo15AttnBlock(in_channels, causal)
                                         for _ in range(num_layers if add_attention else 0)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        for i, resnet in enumerate(self.resnets[1:]):
            if self.add_attention:
                x = self.attentions[i](x)
            x = resnet(x)
        return x


class HunyuanVideo15DownBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int = 1,
                 downsample_out_channels: Optional[int] = None, add_temporal_downsample: bool = True,
                 downsample_cls=HunyuanVideo15Downsample):
        super().__init__()
        self.resnets = nn.ModuleList([HunyuanVideo15ResnetBlock(in_channels if i == 0 else out_channels, out_channels)
                                      for i in range(num_layers)])
        self.downsamplers = (nn.ModuleList([downsample_cls(out_channels, downsample_out_channels,
                                                           add_temporal_downsample)])
                             if downsample_out_channels is not None else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        return x if self.downsamplers is None else self.downsamplers[0](x)


class HunyuanVideo15UpBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int = 1,
                 upsample_out_channels: Optional[int] = None, add_temporal_upsample: bool = True,
                 upsample_cls=HunyuanVideo15Upsample):
        super().__init__()
        self.resnets = nn.ModuleList([HunyuanVideo15ResnetBlock(in_channels if i == 0 else out_channels, out_channels)
                                      for i in range(num_layers)])
        self.upsamplers = (nn.ModuleList([upsample_cls(out_channels, upsample_out_channels, add_temporal_upsample)])
                           if upsample_out_channels is not None else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        return x if self.upsamplers is None else self.upsamplers[0](x)


class HunyuanVideo15Encoder3D(nn.Module):
    """The down schedule from the compression ratios (JAX `:287-323`); the
    output adds the group mean of the mid block's channels."""

    def __init__(self, in_channels: int, out_channels: int, block_out_channels, layers_per_block: int,
                 temporal_compression_ratio: int, spatial_compression_ratio: int, downsample_match_channel: bool,
                 downsample_cls=HunyuanVideo15Downsample, causal_attention: bool = True):
        super().__init__()
        self.out_channels = out_channels
        self.conv_in = HYCausalConv3d(in_channels, block_out_channels[0], 3)
        n_spatial = int(np.log2(spatial_compression_ratio))
        n_pre_temporal = int(np.log2(spatial_compression_ratio // temporal_compression_ratio))
        blocks, ch = [], block_out_channels[0]
        for i, out_ch in enumerate(block_out_channels):
            if i < n_spatial:
                down_out = block_out_channels[i + 1] if downsample_match_channel else out_ch
                blocks.append(HunyuanVideo15DownBlock3D(ch, out_ch, layers_per_block, down_out,
                                                        add_temporal_downsample=i >= n_pre_temporal,
                                                        downsample_cls=downsample_cls))
                ch = down_out
            else:
                blocks.append(HunyuanVideo15DownBlock3D(ch, out_ch, layers_per_block))
                ch = out_ch
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = HunyuanVideo15MidBlock(block_out_channels[-1], causal=causal_attention)
        self.norm_out = HunyuanVideo15RMSNorm(block_out_channels[-1])
        self.conv_out = HYCausalConv3d(block_out_channels[-1], out_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.norm_out(x))) + _group_mean(x, self.out_channels)


class HunyuanVideo15Decoder3D(nn.Module):
    """`conv_in` plus a channel repeat of the latents; the up schedule
    mirrors the encoder's (JAX `:326-377`)."""

    def __init__(self, in_channels: int, out_channels: int, block_out_channels, layers_per_block: int,
                 spatial_compression_ratio: int, temporal_compression_ratio: int, upsample_match_channel: bool,
                 upsample_cls=HunyuanVideo15Upsample, causal_attention: bool = True):
        super().__init__()
        self.repeat = block_out_channels[0] // in_channels
        self.conv_in = HYCausalConv3d(in_channels, block_out_channels[0], 3)
        self.mid_block = HunyuanVideo15MidBlock(block_out_channels[0], causal=causal_attention)
        n_spatial = int(np.log2(spatial_compression_ratio))
        n_temporal = int(np.log2(temporal_compression_ratio))
        blocks, ch = [], block_out_channels[0]
        for i, out_ch in enumerate(block_out_channels):
            if i < n_spatial or i < n_temporal:
                up_out = block_out_channels[i + 1] if upsample_match_channel else out_ch
                blocks.append(HunyuanVideo15UpBlock3D(ch, out_ch, layers_per_block + 1, up_out,
                                                      add_temporal_upsample=i < n_temporal,
                                                      upsample_cls=upsample_cls))
                ch = up_out
            else:
                blocks.append(HunyuanVideo15UpBlock3D(ch, out_ch, layers_per_block + 1))
                ch = out_ch
        self.up_blocks = nn.ModuleList(blocks)
        self.norm_out = HunyuanVideo15RMSNorm(block_out_channels[-1])
        self.conv_out = HYCausalConv3d(block_out_channels[-1], out_channels, 3)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(z) + z.repeat_interleave(self.repeat, dim=1)
        x = self.mid_block(x)
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.norm_out(x)))


class AutoencoderKLHunyuanVideo15(ModelMixin, ConfigMixin):
    """Video in and out as [B, C, T, H, W]; ``T = 1 + 4 k`` frames in,
    ``1 + k`` latent frames."""

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
                                               spatial_compression_ratio, downsample_match_channel)
        self.decoder = HunyuanVideo15Decoder3D(latent_channels, out_channels, tuple(reversed(block_out_channels)),
                                               layers_per_block, spatial_compression_ratio,
                                               temporal_compression_ratio, upsample_match_channel)
        self.spatial_compression_ratio = spatial_compression_ratio
        self.temporal_compression_ratio = temporal_compression_ratio

    def encode(self, x: torch.Tensor, return_dict: bool = True):
        """x [B, C, T, H, W] in [-1, 1] -> the posterior over [B, 2 z, T', H', W'] moments."""
        posterior = DiagonalGaussianDistribution(self.encoder(x))
        return AutoencoderKLOutput(latent_dist=posterior) if return_dict else (posterior,)

    def decode(self, z: torch.Tensor, return_dict: bool = True):
        """z [B, z, T', H', W'] -> video [B, C, T, H, W]."""
        dec = self.decoder(z)
        return DecoderOutput(sample=dec) if return_dict else (dec,)

    def forward(self, sample: torch.Tensor, sample_posterior: bool = False, generator=None, return_dict: bool = True):
        posterior = self.encode(sample).latent_dist
        z = posterior.sample(generator) if sample_posterior else posterior.mode()
        return self.decode(z, return_dict=return_dict)

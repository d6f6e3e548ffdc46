"""AutoencoderKLHunyuanVideo: HunyuanVideo's causal 3-D VAE (8x in space, 4x
in time, 16 latent channels; widths (128, 256, 512, 512) published).

Port of `diffusers_tpu/models/autoencoders/autoencoder_kl_hunyuan_video.py`
over NCDHW activations, with upstream diffusers' state-dict names:

* `HYCausalConv3d` (`:45`): the first frame replicated ``k_t - 1`` times in
  front, replicate padding in space, then a strided `Conv3d` (an extra zero
  padding where the module asks for one);
* the resnet: GroupNorm + SiLU (kernel K4 on the card, through the port's
  `GroupNorm` with ``apply_silu=True``), causal conv, twice, with a 1 x 1 x 1
  causal conv on the shortcut where the width changes;
* the mid block's single-head attention (head_dim = the last width, 512
  published, so it runs ``native``) under the frame-causal rule (`:36-42`,
  `:107-117`): a query of frame f sees the keys of frames 0..f. JAX adds a
  dense f32 ``[B, N, N]`` mask of ``-inf`` over every latent token; a masked
  key adds exactly zero after the softmax, so the port attends each query
  frame to the keys it may see and builds no ``[N, N]`` tensor, which halves
  the work (ROADMAP C3);
* the down blocks (strided causal conv), and the up blocks whose first frame
  is upsampled in space only (`:153-172`);
* the encoder and the decoder (`:190-268`), `quant_conv` and
  `post_quant_conv`.

JAX encodes and decodes the whole video at once, with no tiling, and so does
this port; a causal conv whose input is over 1 GiB convolves it a span of
output frames at a time, so that no padded copy of the whole video is made.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...ops.attention import dispatch_attention_fn
from ...ops.module import Conv3d, GroupNorm
from ...utils import BaseOutput
from ..attention import Attention
from ..modeling_utils import ModelMixin
from .vae import DecoderOutput, DiagonalGaussianDistribution


@dataclass
class AutoencoderKLOutput(BaseOutput):
    latent_dist: DiagonalGaussianDistribution


def _triple(v) -> Tuple[int, int, int]:
    return (v, v, v) if isinstance(v, int) else tuple(v)


class HYCausalConv3d(nn.Module):
    """An input larger than `chunk_bytes` is convolved a span of output frames
    at a time, each span padded from the input frames it reads: the padded
    copy of the whole video (as large as the input) is never made."""

    chunk_bytes = 1 << 30

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3, stride=1, padding=0, bias: bool = True):
        super().__init__()
        self.k, self.extra_pad = _triple(kernel_size), _triple(padding)
        self.conv = Conv3d(in_channels, out_channels, kernel_size=self.k, stride=_triple(stride), use_bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kt, kh, kw = self.k
        if any(self.extra_pad) or x.numel() * x.element_size() <= self.chunk_bytes:
            x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2, kt - 1, 0), mode="replicate")
            if any(self.extra_pad):
                pt, ph, pw = self.extra_pad
                x = F.pad(x, (pw, pw, ph, ph, pt, pt))
            return self.conv(x)
        st = self.conv.stride[0]
        frames = (x.shape[2] - 1) // st + 1  # output frames of the causally padded input
        per_chunk = max(1, int(self.chunk_bytes // (x[:, :, :1].numel() * x.element_size() * st)))
        outs = []
        for o0 in range(0, frames, per_chunk):
            o1 = min(frames, o0 + per_chunk)
            # padded frame p reads input frame max(p - (kt - 1), 0): the first frame replicated in front
            idx = (torch.arange(o0 * st, (o1 - 1) * st + kt, device=x.device) - (kt - 1)).clamp(min=0)
            chunk = F.pad(x.index_select(2, idx), (kw // 2, kw // 2, kh // 2, kh // 2, 0, 0), mode="replicate")
            outs.append(self.conv(chunk))
            del chunk
        return torch.cat(outs, dim=2)


class HYResnetBlockCausal3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int = None, groups: int = 32, eps: float = 1e-6):
        super().__init__()
        out_channels = out_channels or in_channels
        self.norm1 = GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = HYCausalConv3d(in_channels, out_channels, 3)
        self.norm2 = GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = HYCausalConv3d(out_channels, out_channels, 3)
        self.conv_shortcut = HYCausalConv3d(in_channels, out_channels, 1) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        x = self.conv1(self.norm1(x, apply_silu=True))
        return self.conv2(self.norm2(x, apply_silu=True)) + residual


def frame_causal_attention(attn: Attention, x: torch.Tensor) -> torch.Tensor:
    """`attn` (GroupNorm, projections, residual) over the tokens of
    ``x`` [B, C, T, H, W], each query frame attending to the keys of frames
    0..its own: JAX's result under its frame-causal mask, with no ``[N, N]``
    tensor."""
    b, c, t, h, w = x.shape
    hw = h * w
    tokens = attn.group_norm(x).flatten(2).transpose(1, 2)  # [B, T H W, C]

    def heads(p):
        return p.reshape(b, t * hw, attn.heads, attn.dim_head)

    q, k, v = heads(attn.to_q(tokens)), heads(attn.to_k(tokens)), heads(attn.to_v(tokens))
    out = torch.cat([
        dispatch_attention_fn(q[:, f * hw:(f + 1) * hw], k[:, :(f + 1) * hw], v[:, :(f + 1) * hw], scale=attn.scale)
        for f in range(t)], dim=1)
    out = attn.to_out[0](out.reshape(b, t * hw, attn.heads * attn.dim_head))
    out = out.transpose(1, 2).reshape(b, c, t, h, w)
    return (out + x) / attn.rescale_output_factor


class HYMidBlock3D(nn.Module):
    def __init__(self, in_channels: int, num_layers: int = 1, resnet_groups: int = 32, add_attention: bool = True,
                 attention_head_dim: int = 1, eps: float = 1e-6):
        super().__init__()
        self.add_attention = add_attention
        self.resnets = nn.ModuleList([HYResnetBlockCausal3D(in_channels, in_channels, resnet_groups, eps)
                                      for _ in range(num_layers + 1)])
        self.attentions = nn.ModuleList([
            Attention(in_channels, heads=in_channels // attention_head_dim, dim_head=attention_head_dim, eps=eps,
                      norm_num_groups=resnet_groups, residual_connection=True, bias=True)
            for _ in range(num_layers if add_attention else 0)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        for i, resnet in enumerate(self.resnets[1:]):
            if self.add_attention:
                x = frame_causal_attention(self.attentions[i], x)
            x = resnet(x)
        return x


class _HYDownsample(nn.Module):
    def __init__(self, channels: int, out_channels: int, padding: int = 1, kernel_size: int = 3, stride=2):
        super().__init__()
        self.conv = HYCausalConv3d(channels, out_channels, kernel_size, stride, padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class _HYUpsample(nn.Module):
    def __init__(self, in_channels: int, out_channels: int = None, kernel_size: int = 3, stride: int = 1,
                 upsample_factor=(2, 2, 2)):
        super().__init__()
        self.upsample_factor = tuple(upsample_factor)
        self.conv = HYCausalConv3d(in_channels, out_channels or in_channels, kernel_size, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ft, fh, fw = self.upsample_factor
        t = x.shape[2]
        if t > 1 and ft > 1:  # the first frame in space only (JAX `:153-172`)
            frames = torch.cat([torch.zeros(1, dtype=torch.long), 1 + torch.arange((t - 1) * ft) // ft])
            x = x.index_select(2, frames.to(x.device))
        if fh > 1 or fw > 1:  # nearest: each pixel repeated
            x = F.interpolate(x, scale_factor=(1, fh, fw), mode="nearest")
        return self.conv(x)


class HYDownBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int = 1, resnet_groups: int = 32,
                 add_downsample: bool = True, downsample_stride=2, downsample_padding: int = 0):
        super().__init__()
        self.resnets = nn.ModuleList([
            HYResnetBlockCausal3D(in_channels if i == 0 else out_channels, out_channels, resnet_groups)
            for i in range(num_layers)])
        self.downsamplers = (nn.ModuleList([_HYDownsample(out_channels, out_channels, downsample_padding,
                                                          stride=downsample_stride)])
                             if add_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        return x if self.downsamplers is None else self.downsamplers[0](x)


class HYUpBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int = 1, resnet_groups: int = 32,
                 add_upsample: bool = True, upsample_scale_factor=(2, 2, 2)):
        super().__init__()
        self.resnets = nn.ModuleList([
            HYResnetBlockCausal3D(in_channels if i == 0 else out_channels, out_channels, resnet_groups)
            for i in range(num_layers)])
        self.upsamplers = (nn.ModuleList([_HYUpsample(out_channels, out_channels,
                                                      upsample_factor=upsample_scale_factor)])
                           if add_upsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        return x if self.upsamplers is None else self.upsamplers[0](x)


class HYEncoder3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, block_out_channels, layers_per_block: int,
                 norm_num_groups: int, double_z: bool = True, mid_block_add_attention: bool = True,
                 temporal_compression_ratio: int = 4, spatial_compression_ratio: int = 8):
        super().__init__()
        self.conv_in = HYCausalConv3d(in_channels, block_out_channels[0], 3, 1)
        n_spatial, n_time = int(np.log2(spatial_compression_ratio)), int(np.log2(temporal_compression_ratio))
        blocks, output_channel = [], block_out_channels[0]
        for i, channels in enumerate(block_out_channels):
            input_channel, output_channel = output_channel, channels
            is_final = i == len(block_out_channels) - 1
            if temporal_compression_ratio == 4:
                add_spatial = i < n_spatial
                add_time = i >= (len(block_out_channels) - 1 - n_time) and not is_final
            elif temporal_compression_ratio == 8:
                add_spatial, add_time = i < n_spatial, i < n_time
            else:
                raise ValueError(f"unsupported temporal_compression_ratio {temporal_compression_ratio}")
            stride = ((2,) if add_time else (1,)) + ((2, 2) if add_spatial else (1, 1))
            blocks.append(HYDownBlock3D(input_channel, output_channel, num_layers=layers_per_block,
                                        resnet_groups=norm_num_groups, add_downsample=add_spatial or add_time,
                                        downsample_stride=stride, downsample_padding=0))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = HYMidBlock3D(block_out_channels[-1], resnet_groups=norm_num_groups,
                                      add_attention=mid_block_add_attention,
                                      attention_head_dim=block_out_channels[-1])
        self.conv_norm_out = GroupNorm(norm_num_groups, block_out_channels[-1], eps=1e-6)
        self.conv_out = HYCausalConv3d(block_out_channels[-1], 2 * out_channels if double_z else out_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(self.conv_norm_out(x, apply_silu=True))


class HYDecoder3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, block_out_channels, layers_per_block: int,
                 norm_num_groups: int, mid_block_add_attention: bool = True, time_compression_ratio: int = 4,
                 spatial_compression_ratio: int = 8):
        super().__init__()
        self.conv_in = HYCausalConv3d(in_channels, block_out_channels[-1], 3, 1)
        self.mid_block = HYMidBlock3D(block_out_channels[-1], resnet_groups=norm_num_groups,
                                      add_attention=mid_block_add_attention,
                                      attention_head_dim=block_out_channels[-1])
        rev = list(reversed(block_out_channels))
        n_spatial, n_time = int(np.log2(spatial_compression_ratio)), int(np.log2(time_compression_ratio))
        blocks, output_channel = [], rev[0]
        for i, channels in enumerate(rev):
            prev_output, output_channel = output_channel, channels
            is_final = i == len(block_out_channels) - 1
            add_spatial = i < n_spatial
            add_time = i >= len(block_out_channels) - 1 - n_time and not is_final
            factor = ((2,) if add_time else (1,)) + ((2, 2) if add_spatial else (1, 1))
            blocks.append(HYUpBlock3D(prev_output, output_channel, num_layers=layers_per_block + 1,
                                      resnet_groups=norm_num_groups, add_upsample=add_spatial or add_time,
                                      upsample_scale_factor=factor))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(norm_num_groups, block_out_channels[0], eps=1e-6)
        self.conv_out = HYCausalConv3d(block_out_channels[0], out_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(x))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(x, apply_silu=True))


class AutoencoderKLHunyuanVideo(ModelMixin, ConfigMixin):
    """Video in and out as [B, C, T, H, W]; ``T = 1 + 4 k`` frames in, ``1 + k``
    latent frames."""

    @register_to_config
    def __init__(
        self,
        in_channels: int = 3,
        out_channels: int = 3,
        latent_channels: int = 16,
        down_block_types: Tuple[str, ...] = ("HunyuanVideoDownBlock3D",) * 4,
        up_block_types: Tuple[str, ...] = ("HunyuanVideoUpBlock3D",) * 4,
        block_out_channels: Tuple[int, ...] = (128, 256, 512, 512),
        layers_per_block: int = 2,
        act_fn: str = "silu",
        norm_num_groups: int = 32,
        scaling_factor: float = 0.476986,
        spatial_compression_ratio: int = 8,
        temporal_compression_ratio: int = 4,
        mid_block_add_attention: bool = True,
    ):
        super().__init__()
        block_out_channels = tuple(block_out_channels)
        self.encoder = HYEncoder3D(in_channels, latent_channels, block_out_channels, layers_per_block,
                                   norm_num_groups, double_z=True, mid_block_add_attention=mid_block_add_attention,
                                   temporal_compression_ratio=temporal_compression_ratio,
                                   spatial_compression_ratio=spatial_compression_ratio)
        self.decoder = HYDecoder3D(latent_channels, out_channels, block_out_channels, layers_per_block,
                                   norm_num_groups, mid_block_add_attention=mid_block_add_attention,
                                   time_compression_ratio=temporal_compression_ratio,
                                   spatial_compression_ratio=spatial_compression_ratio)
        self.quant_conv = Conv3d(2 * latent_channels, 2 * latent_channels, kernel_size=1)
        self.post_quant_conv = Conv3d(latent_channels, latent_channels, kernel_size=1)

    def encode(self, x: torch.Tensor, return_dict: bool = True):
        """x [B, C, T, H, W] in [-1, 1] -> the posterior over [B, 2 z, T', H', W'] moments."""
        posterior = DiagonalGaussianDistribution(self.quant_conv(self.encoder(x)))
        return AutoencoderKLOutput(latent_dist=posterior) if return_dict else (posterior,)

    def decode(self, z: torch.Tensor, return_dict: bool = True):
        """z [B, z, T', H', W'] -> video [B, C, T, H, W]."""
        dec = self.decoder(self.post_quant_conv(z))
        return DecoderOutput(sample=dec) if return_dict else (dec,)

    def forward(self, sample: torch.Tensor, sample_posterior: bool = False, generator=None, return_dict: bool = True):
        posterior = self.encode(sample).latent_dist
        z = posterior.sample(generator) if sample_posterior else posterior.mode()
        return self.decode(z, return_dict=return_dict)

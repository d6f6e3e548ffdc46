"""AutoencoderKLLTXVideo: LTX-Video's causal 3-D VAE (32x in space, 8x in
time, 128 latent channels at the published widths).

Port of `diffusers_tpu/models/autoencoders/autoencoder_kl_ltx.py` over
NCDHW activations, with upstream diffusers' state-dict names: the causal
`Conv3d` (`LTXCausalConv3d`: the first frame repeated ``k_t - 1`` times in
front; the non-causal decoder splits them over both ends, repeating the
last frame behind), the RMSNorm resnets (eps 1e-8, no affine, over the
channel axis; a LayerNorm and a 1 x 1 x 1 conv on the shortcut where the
width changes), both down-block kinds (`LTXVideoDownBlock3D`'s strided
conv, `LTXVideo095DownBlock3D` with a strided conv or the pixel-unshuffle
`LTXDownsampler3d` and its grouped-mean shortcut), the up blocks with the
pixel-shuffle `LTXUpsampler3d` (``upsample_residual`` / ``upsample_factor``),
the spatial patching of ``patch_size`` 4, and the timestep-conditioned
decoder (``timestep_conditioning``: the mid and up blocks' timestep
embedders, each resnet's 4-way ``scale_shift_table``, the decoder's
``timestep_scale_multiplier`` and output modulation) with its injected
spatial noise (``decoder_inject_noise``: one [H, W] normal map a conv,
scaled per channel).

JAX encodes and decodes the whole video at once, with no tiling, and so
does this port. The injected noise comes from a `torch.Generator` through
`utils.torch_utils.randn_tensor`, one draw a noised conv in the order the
decoder runs them; JAX draws it from split keys (ROADMAP C3). `latents_mean`
and `latents_std` are persistent buffers, as upstream's are.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...ops.module import Conv3d, LayerNorm, get_activation
from ...utils import BaseOutput, torch_utils
from ..modeling_utils import ModelMixin
from ..transformers.pixart_transformer_2d import PixArtAlphaCombinedTimestepSizeEmbeddings
from .vae import DecoderOutput, DiagonalGaussianDistribution


@dataclass
class AutoencoderKLOutput(BaseOutput):
    latent_dist: DiagonalGaussianDistribution


def _triple(v) -> Tuple[int, int, int]:
    return (v, v, v) if isinstance(v, int) else tuple(v)


def rms_channels(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """RMSNorm without affine over the channel axis (dim 1), in f32, cast back."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(dim=1, keepdim=True) + eps)).to(x.dtype)


class LTXCausalConv3d(nn.Module):
    """Conv3d with replicate temporal padding (causal: ``k_t - 1`` copies of
    the first frame in front; else half of them at each end) and zero
    spatial padding."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1, dilation=1, is_causal=True):
        super().__init__()
        k = _triple(kernel_size)
        d = (dilation, 1, 1) if isinstance(dilation, int) else tuple(dilation)
        self.kernel_size = k
        self.is_causal = is_causal
        self.conv = Conv3d(in_channels, out_channels, kernel_size=k, stride=_triple(stride),
                           padding=(0, k[1] // 2, k[2] // 2), dilation=d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kt = self.kernel_size[0]
        if kt > 1:
            if self.is_causal:
                x = torch.cat([x[:, :, :1].expand(-1, -1, kt - 1, -1, -1), x], dim=2)
            else:
                pad = (kt - 1) // 2
                x = torch.cat([x[:, :, :1].expand(-1, -1, pad, -1, -1), x,
                               x[:, :, -1:].expand(-1, -1, pad, -1, -1)], dim=2)
        return self.conv(x)


class LTXResnetBlock3d(nn.Module):
    """RMSNorm (eps 1e-8) -> act -> causal conv, twice; the shortcut's
    LayerNorm + 1 x 1 x 1 conv where the width changes; optional per-channel
    spatial noise after each conv and 4-way timestep modulation."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None, eps: float = 1e-6,
                 non_linearity: str = "swish", is_causal: bool = True, inject_noise: bool = False,
                 timestep_conditioning: bool = False):
        super().__init__()
        out_channels = out_channels or in_channels
        self.in_channels = in_channels
        self.nonlinearity = get_activation(non_linearity)
        self.inject_noise = inject_noise
        self.timestep_conditioning = timestep_conditioning
        self.conv1 = LTXCausalConv3d(in_channels, out_channels, kernel_size=3, is_causal=is_causal)
        self.conv2 = LTXCausalConv3d(out_channels, out_channels, kernel_size=3, is_causal=is_causal)
        self.norm3 = self.conv_shortcut = None
        if in_channels != out_channels:
            self.norm3 = LayerNorm(in_channels, eps=eps, use_scale=True, use_bias=True)
            self.conv_shortcut = LTXCausalConv3d(in_channels, out_channels, kernel_size=1, is_causal=is_causal)
        if inject_noise:
            self.per_channel_scale1 = nn.Parameter(torch.zeros(in_channels, 1, 1))
            self.per_channel_scale2 = nn.Parameter(torch.zeros(in_channels, 1, 1))
        if timestep_conditioning:
            self.scale_shift_table = nn.Parameter(torch.randn(4, in_channels) / in_channels**0.5)

    def reset_parameters(self) -> None:
        with torch.no_grad():
            if self.inject_noise:
                self.per_channel_scale1.zero_()
                self.per_channel_scale2.zero_()
            if self.timestep_conditioning:
                self.scale_shift_table.normal_().div_(self.in_channels**0.5)

    @staticmethod
    def _add_noise(x: torch.Tensor, scale: torch.Tensor, generator) -> torch.Tensor:
        """One [H, W] standard-normal map, scaled per channel (upstream `:166`)."""
        noise = torch_utils.randn_tensor(x.shape[-2:], generator, x.device).to(x.dtype)
        return x + noise[None, None, None] * scale.reshape(1, -1, 1, 1, 1).to(x.dtype)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None, generator=None) -> torch.Tensor:
        h = rms_channels(x)
        if self.timestep_conditioning:
            ada = self.scale_shift_table[None].float() + temb.reshape(temb.shape[0], 4, -1).float()
            shift_1, scale_1, shift_2, scale_2 = (ada[:, i][:, :, None, None, None].to(x.dtype) for i in range(4))
            h = h * (1 + scale_1) + shift_1
        h = self.conv1(self.nonlinearity(h))
        if self.inject_noise:
            h = self._add_noise(h, self.per_channel_scale1, generator)
        h = rms_channels(h)
        if self.timestep_conditioning:
            h = h * (1 + scale_2) + shift_2
        h = self.conv2(self.nonlinearity(h))
        if self.inject_noise:
            h = self._add_noise(h, self.per_channel_scale2, generator)
        if self.norm3 is not None:
            x = self.norm3(x.movedim(1, -1)).movedim(-1, 1)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return h + x


def pixel_unshuffle_3d(x: torch.Tensor, s: Tuple[int, int, int]) -> torch.Tensor:
    """[B, C, F s0, H s1, W s2] -> [B, C s0 s1 s2, F, H, W], channels in
    (c, s0, s1, s2) order."""
    b, c, f, h, w = x.shape
    x = x.reshape(b, c, f // s[0], s[0], h // s[1], s[1], w // s[2], s[2]).permute(0, 1, 3, 5, 7, 2, 4, 6)
    return x.reshape(b, c * s[0] * s[1] * s[2], f // s[0], h // s[1], w // s[2])


def pixel_shuffle_3d(x: torch.Tensor, s: Tuple[int, int, int]) -> torch.Tensor:
    """The inverse of `pixel_unshuffle_3d`."""
    b, cs, f, h, w = x.shape
    c = cs // (s[0] * s[1] * s[2])
    x = x.reshape(b, c, s[0], s[1], s[2], f, h, w).permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(b, c, f * s[0], h * s[1], w * s[2])


class LTXDownsampler3d(nn.Module):
    """``s0 - 1`` first frames prepended, a conv to out / (s0 s1 s2)
    channels, pixel-unshuffle, plus the grouped-mean shortcut of the
    unshuffled input."""

    def __init__(self, in_channels: int, out_channels: int, stride, is_causal=True):
        super().__init__()
        self.stride = _triple(stride)
        s0, s1, s2 = self.stride
        self.group_size = (in_channels * s0 * s1 * s2) // out_channels
        self.conv = LTXCausalConv3d(in_channels, out_channels // (s0 * s1 * s2), kernel_size=3, stride=1,
                                    is_causal=is_causal)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.stride
        x = torch.cat([x[:, :, : s[0] - 1], x], dim=2)
        residual = pixel_unshuffle_3d(x, s)
        b, cs, f, h, w = residual.shape
        residual = residual.reshape(b, cs // self.group_size, self.group_size, f, h, w).mean(dim=2)
        return pixel_unshuffle_3d(self.conv(x), s) + residual


class LTXUpsampler3d(nn.Module):
    def __init__(self, in_channels: int, stride, is_causal=True, residual=False, upscale_factor=1):
        super().__init__()
        self.stride = _triple(stride)
        self.residual = residual
        self.upscale_factor = upscale_factor
        s0, s1, s2 = self.stride
        self.conv = LTXCausalConv3d(in_channels, (in_channels * s0 * s1 * s2) // upscale_factor, kernel_size=3,
                                    stride=1, is_causal=is_causal)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.stride
        out = pixel_shuffle_3d(self.conv(x), s)[:, :, s[0] - 1:]
        if self.residual:
            repeats = (s[0] * s[1] * s[2]) // self.upscale_factor
            out = out + pixel_shuffle_3d(x, s).repeat(1, repeats, 1, 1, 1)[:, :, s[0] - 1:]
        return out


class LTXMidBlock3d(nn.Module):
    def __init__(self, in_channels, num_layers=1, resnet_eps=1e-6, resnet_act_fn="swish", is_causal=True,
                 inject_noise=False, timestep_conditioning=False):
        super().__init__()
        self.timestep_conditioning = timestep_conditioning
        if timestep_conditioning:
            self.time_embedder = PixArtAlphaCombinedTimestepSizeEmbeddings(in_channels * 4)
        self.resnets = nn.ModuleList([
            LTXResnetBlock3d(in_channels, in_channels, eps=resnet_eps, non_linearity=resnet_act_fn,
                             is_causal=is_causal, inject_noise=inject_noise,
                             timestep_conditioning=timestep_conditioning)
            for _ in range(num_layers)])

    def forward(self, x, temb=None, generator=None):
        if self.timestep_conditioning:
            temb = self.time_embedder(temb.reshape(-1), dtype=x.dtype)
        for resnet in self.resnets:
            x = resnet(x, temb, generator)
        return x


class LTXDownBlock3D(nn.Module):
    """Resnets, a strided causal conv, then a width-changing resnet."""

    def __init__(self, in_channels, out_channels=None, num_layers=1, resnet_eps=1e-6, resnet_act_fn="swish",
                 spatio_temporal_scale=True, is_causal=True):
        super().__init__()
        out_channels = out_channels or in_channels
        self.resnets = nn.ModuleList([
            LTXResnetBlock3d(in_channels, in_channels, eps=resnet_eps, non_linearity=resnet_act_fn,
                             is_causal=is_causal) for _ in range(num_layers)])
        self.downsamplers = None
        if spatio_temporal_scale:
            self.downsamplers = nn.ModuleList([LTXCausalConv3d(in_channels, in_channels, kernel_size=3,
                                                               stride=(2, 2, 2), is_causal=is_causal)])
        self.conv_out = None
        if in_channels != out_channels:
            self.conv_out = LTXResnetBlock3d(in_channels, out_channels, eps=resnet_eps, non_linearity=resnet_act_fn,
                                             is_causal=is_causal)

    def forward(self, x, temb=None, generator=None):
        for resnet in self.resnets:
            x = resnet(x, temb, generator)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        if self.conv_out is not None:
            x = self.conv_out(x, temb, generator)
        return x


class LTXVideo095DownBlock3D(nn.Module):
    """Resnets, then a downsampler of the configured kind: a strided conv
    ("conv") or `LTXDownsampler3d` ("spatial", "temporal",
    "spatiotemporal")."""

    def __init__(self, in_channels, out_channels=None, num_layers=1, resnet_eps=1e-6, resnet_act_fn="swish",
                 spatio_temporal_scale=True, is_causal=True, downsample_type="conv"):
        super().__init__()
        out_channels = out_channels or in_channels
        self.resnets = nn.ModuleList([
            LTXResnetBlock3d(in_channels, in_channels, eps=resnet_eps, non_linearity=resnet_act_fn,
                             is_causal=is_causal) for _ in range(num_layers)])
        self.downsamplers = None
        if spatio_temporal_scale:
            strides = {"spatial": (1, 2, 2), "temporal": (2, 1, 1), "spatiotemporal": (2, 2, 2)}
            if downsample_type == "conv":
                down = LTXCausalConv3d(in_channels, in_channels, kernel_size=3, stride=(2, 2, 2), is_causal=is_causal)
            else:
                down = LTXDownsampler3d(in_channels, out_channels, stride=strides[downsample_type],
                                        is_causal=is_causal)
            self.downsamplers = nn.ModuleList([down])

    def forward(self, x, temb=None, generator=None):
        for resnet in self.resnets:
            x = resnet(x, temb, generator)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class LTXUpBlock3d(nn.Module):
    def __init__(self, in_channels, out_channels=None, num_layers=1, resnet_eps=1e-6, resnet_act_fn="swish",
                 spatio_temporal_scale=True, is_causal=True, inject_noise=False, timestep_conditioning=False,
                 upsample_residual=False, upscale_factor=1):
        super().__init__()
        out_channels = out_channels or in_channels
        self.timestep_conditioning = timestep_conditioning
        if timestep_conditioning:
            self.time_embedder = PixArtAlphaCombinedTimestepSizeEmbeddings(in_channels * 4)
        self.conv_in = None
        if in_channels != out_channels:
            self.conv_in = LTXResnetBlock3d(in_channels, out_channels, eps=resnet_eps, non_linearity=resnet_act_fn,
                                            is_causal=is_causal, inject_noise=inject_noise,
                                            timestep_conditioning=timestep_conditioning)
        self.upsamplers = None
        if spatio_temporal_scale:
            self.upsamplers = nn.ModuleList([LTXUpsampler3d(out_channels * upscale_factor, stride=(2, 2, 2),
                                                            is_causal=is_causal, residual=upsample_residual,
                                                            upscale_factor=upscale_factor)])
        self.resnets = nn.ModuleList([
            LTXResnetBlock3d(out_channels, out_channels, eps=resnet_eps, non_linearity=resnet_act_fn,
                             is_causal=is_causal, inject_noise=inject_noise,
                             timestep_conditioning=timestep_conditioning)
            for _ in range(num_layers)])

    def forward(self, x, temb=None, generator=None):
        if self.conv_in is not None:
            x = self.conv_in(x, temb, generator)
        if self.timestep_conditioning:
            temb = self.time_embedder(temb.reshape(-1), dtype=x.dtype)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        for resnet in self.resnets:
            x = resnet(x, temb, generator)
        return x


class LTXVideoEncoder3d(nn.Module):
    """Video [B, C, F, H, W] -> 2 x latent-channel moments (the log-variance
    is one channel, repeated)."""

    def __init__(self, in_channels=3, out_channels=128, block_out_channels=(128, 256, 512, 512),
                 down_block_types=("LTXVideoDownBlock3D",) * 4, spatio_temporal_scaling=(True, True, True, False),
                 layers_per_block=(4, 3, 3, 3, 4), downsample_type=("conv",) * 4, patch_size: int = 4,
                 patch_size_t: int = 1, resnet_norm_eps: float = 1e-6, is_causal: bool = True):
        super().__init__()
        self.patch_size = patch_size
        self.patch_size_t = patch_size_t
        output_channel = block_out_channels[0]
        self.conv_in = LTXCausalConv3d(in_channels * patch_size**2, output_channel, kernel_size=3, stride=1,
                                       is_causal=is_causal)
        is_ltx_095 = down_block_types[-1] == "LTXVideo095DownBlock3D"
        num_blocks = len(block_out_channels) - (1 if is_ltx_095 else 0)
        blocks = []
        for i in range(num_blocks):
            input_channel = output_channel
            if is_ltx_095:
                output_channel = block_out_channels[i + 1]
            else:
                output_channel = block_out_channels[i + 1] if i + 1 < num_blocks else block_out_channels[i]
            kwargs = dict(num_layers=layers_per_block[i], resnet_eps=resnet_norm_eps,
                          spatio_temporal_scale=spatio_temporal_scaling[i], is_causal=is_causal)
            if down_block_types[i] == "LTXVideoDownBlock3D":
                blocks.append(LTXDownBlock3D(input_channel, output_channel, **kwargs))
            elif down_block_types[i] == "LTXVideo095DownBlock3D":
                blocks.append(LTXVideo095DownBlock3D(input_channel, output_channel,
                                                     downsample_type=downsample_type[i], **kwargs))
            else:
                raise ValueError(f"Unknown down block type: {down_block_types[i]}")
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = LTXMidBlock3d(output_channel, num_layers=layers_per_block[-1], resnet_eps=resnet_norm_eps,
                                       is_causal=is_causal)
        self.conv_out = LTXCausalConv3d(output_channel, out_channels + 1, kernel_size=3, stride=1,
                                        is_causal=is_causal)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p, pt = self.patch_size, self.patch_size_t
        b, c, f, h, w = x.shape
        # patchify, channels in upstream's (c, p_t, p_w, p_h) order
        x = x.reshape(b, c, f // pt, pt, h // p, p, w // p, p).permute(0, 1, 3, 7, 5, 2, 4, 6)
        x = self.conv_in(x.reshape(b, c * pt * p * p, f // pt, h // p, w // p))
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        x = self.conv_out(F.silu(rms_channels(x)))
        return torch.cat([x, x[:, -1:].repeat(1, x.shape[1] - 2, 1, 1, 1)], dim=1)


class LTXVideoDecoder3d(nn.Module):
    def __init__(self, in_channels=128, out_channels=3, block_out_channels=(128, 256, 512, 512),
                 spatio_temporal_scaling=(True, True, True, False), layers_per_block=(4, 3, 3, 3, 4),
                 patch_size: int = 4, patch_size_t: int = 1, resnet_norm_eps: float = 1e-6, is_causal: bool = False,
                 inject_noise=(False,) * 4, timestep_conditioning: bool = False, upsample_residual=(False,) * 4,
                 upsample_factor=(1,) * 4):
        super().__init__()
        self.patch_size = patch_size
        self.patch_size_t = patch_size_t
        self.timestep_conditioning = timestep_conditioning
        block_out_channels = tuple(reversed(block_out_channels))
        spatio_temporal_scaling = tuple(reversed(spatio_temporal_scaling))
        layers_per_block = tuple(reversed(layers_per_block))
        inject_noise = tuple(reversed(inject_noise))
        upsample_residual = tuple(reversed(upsample_residual))
        upsample_factor = tuple(reversed(upsample_factor))
        output_channel = block_out_channels[0]
        self.conv_in = LTXCausalConv3d(in_channels, output_channel, kernel_size=3, stride=1, is_causal=is_causal)
        self.mid_block = LTXMidBlock3d(output_channel, num_layers=layers_per_block[0], resnet_eps=resnet_norm_eps,
                                       is_causal=is_causal, inject_noise=inject_noise[0],
                                       timestep_conditioning=timestep_conditioning)
        blocks = []
        for i in range(len(block_out_channels)):
            input_channel = output_channel // upsample_factor[i]
            output_channel = block_out_channels[i] // upsample_factor[i]
            blocks.append(LTXUpBlock3d(input_channel, output_channel, num_layers=layers_per_block[i + 1],
                                       resnet_eps=resnet_norm_eps, spatio_temporal_scale=spatio_temporal_scaling[i],
                                       is_causal=is_causal, inject_noise=inject_noise[i + 1],
                                       timestep_conditioning=timestep_conditioning,
                                       upsample_residual=upsample_residual[i], upscale_factor=upsample_factor[i]))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_out = LTXCausalConv3d(output_channel, out_channels * patch_size**2, kernel_size=3, stride=1,
                                        is_causal=is_causal)
        self.final_channel = output_channel
        if timestep_conditioning:
            self.time_embedder = PixArtAlphaCombinedTimestepSizeEmbeddings(output_channel * 2)
            self.scale_shift_table = nn.Parameter(torch.randn(2, output_channel) / output_channel**0.5)
            self.timestep_scale_multiplier = nn.Parameter(torch.tensor(1000.0))

    def reset_parameters(self) -> None:
        if self.timestep_conditioning:
            with torch.no_grad():
                self.scale_shift_table.normal_().div_(self.final_channel**0.5)
                self.timestep_scale_multiplier.fill_(1000.0)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None, generator=None) -> torch.Tensor:
        x = self.conv_in(x)
        if self.timestep_conditioning and temb is not None:
            temb = temb * self.timestep_scale_multiplier
        x = self.mid_block(x, temb, generator)
        for block in self.up_blocks:
            x = block(x, temb, generator)
        x = rms_channels(x)
        if self.timestep_conditioning and temb is not None:
            t_emb = self.time_embedder(temb.reshape(-1), dtype=x.dtype)
            ada = self.scale_shift_table[None].float() + t_emb.reshape(x.shape[0], 2, -1).float()
            shift, scale = (ada[:, i][:, :, None, None, None].to(x.dtype) for i in range(2))
            x = x * (1 + scale) + shift
        x = self.conv_out(F.silu(x))
        # un-patchify (upstream's permute(0, 1, 5, 2, 6, 4, 7, 3))
        p, pt = self.patch_size, self.patch_size_t
        b, cs, f, h, w = x.shape
        c = cs // (pt * p * p)
        x = x.reshape(b, c, pt, p, p, f, h, w).permute(0, 1, 5, 2, 6, 4, 7, 3)
        return x.reshape(b, c, f * pt, h * p, w * p)


class AutoencoderKLLTXVideo(ModelMixin, ConfigMixin):
    """Video in and out as [B, C, F, H, W]."""

    @register_to_config
    def __init__(
        self,
        in_channels: int = 3,
        out_channels: int = 3,
        latent_channels: int = 128,
        block_out_channels=(128, 256, 512, 512),
        down_block_types=("LTXVideoDownBlock3D",) * 4,
        decoder_block_out_channels=(128, 256, 512, 512),
        layers_per_block=(4, 3, 3, 3, 4),
        decoder_layers_per_block=(4, 3, 3, 3, 4),
        spatio_temporal_scaling=(True, True, True, False),
        decoder_spatio_temporal_scaling=(True, True, True, False),
        decoder_inject_noise=(False,) * 5,
        downsample_type=("conv",) * 4,
        upsample_residual=(False,) * 4,
        upsample_factor=(1,) * 4,
        timestep_conditioning: bool = False,
        patch_size: int = 4,
        patch_size_t: int = 1,
        resnet_norm_eps: float = 1e-6,
        scaling_factor: float = 1.0,
        encoder_causal: bool = True,
        decoder_causal: bool = False,
        spatial_compression_ratio: Optional[int] = None,
        temporal_compression_ratio: Optional[int] = None,
    ):
        super().__init__()
        self.encoder = LTXVideoEncoder3d(
            in_channels=in_channels, out_channels=latent_channels, block_out_channels=tuple(block_out_channels),
            down_block_types=tuple(down_block_types), spatio_temporal_scaling=tuple(spatio_temporal_scaling),
            layers_per_block=tuple(layers_per_block), downsample_type=tuple(downsample_type), patch_size=patch_size,
            patch_size_t=patch_size_t, resnet_norm_eps=resnet_norm_eps, is_causal=encoder_causal)
        self.decoder = LTXVideoDecoder3d(
            in_channels=latent_channels, out_channels=out_channels,
            block_out_channels=tuple(decoder_block_out_channels),
            spatio_temporal_scaling=tuple(decoder_spatio_temporal_scaling),
            layers_per_block=tuple(decoder_layers_per_block), patch_size=patch_size, patch_size_t=patch_size_t,
            resnet_norm_eps=resnet_norm_eps, is_causal=decoder_causal, inject_noise=tuple(decoder_inject_noise),
            timestep_conditioning=timestep_conditioning, upsample_residual=tuple(upsample_residual),
            upsample_factor=tuple(upsample_factor))
        self.spatial_compression_ratio = (patch_size * 2 ** sum(spatio_temporal_scaling)
                                          if spatial_compression_ratio is None else spatial_compression_ratio)
        self.temporal_compression_ratio = (patch_size_t * 2 ** sum(spatio_temporal_scaling)
                                           if temporal_compression_ratio is None else temporal_compression_ratio)
        self.register_buffer("latents_mean", torch.zeros(latent_channels))
        self.register_buffer("latents_std", torch.ones(latent_channels))

    def encode(self, x: torch.Tensor, return_dict: bool = True):
        """x [B, C, F, H, W] in [-1, 1] -> the posterior over [B, 2 z, F', H', W'] moments."""
        posterior = DiagonalGaussianDistribution(self.encoder(x))
        return AutoencoderKLOutput(latent_dist=posterior) if return_dict else (posterior,)

    def decode(self, z: torch.Tensor, temb: Optional[torch.Tensor] = None, generator=None, return_dict: bool = True):
        """z [B, z, F', H', W'] -> video [B, C, F, H, W]; `temb` [B] the decode
        timestep of a timestep-conditioned decoder; `generator` draws the
        injected noise."""
        dec = self.decoder(z, temb, generator)
        return DecoderOutput(sample=dec) if return_dict else (dec,)

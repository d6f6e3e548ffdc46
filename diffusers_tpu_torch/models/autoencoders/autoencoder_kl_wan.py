"""AutoencoderKLWan: the Wan 2.1 3-D causal video VAE (4x in time, 8x in space).

Port of `diffusers_tpu/models/autoencoders/autoencoder_kl_wan.py`
(`WanCausalConv3d` `:38`, `WanRMSNorm` `:50`, `WanResample` `:94`,
`WanResidualBlock` `:151`, `WanAttentionBlock` `:172`, `WanMidBlock`,
`WanEncoder3d`, `WanUpBlock`, `WanDecoder3d`, `AutoencoderKLWan` `:325`) over
NCDHW activations, with upstream diffusers' state-dict names and shapes
(`WanRMSNorm.gamma` is [C, 1, 1, 1], or [C, 1, 1] in the attention block;
a flat [C] gamma, as the JAX package writes it, is reshaped on load).

A causal conv pads 2 p_t zero frames before the stream. A temporal upsample
never lets frame 0 into its doubling `time_conv` (upstream's "Rep" rule); a
temporal downsample keeps frame 0 and runs its stride-2 `time_conv` over
the whole stream. `encode` and `decode` run as upstream diffusers does, in
causal temporal chunks, and a `CausalCache` carries the last `CACHE_T` = 2
input frames of every causal conv from one chunk to the next (upstream's
`feat_cache`), so no activation of a full-length video (96 channels x 81
frames x 480 x 832 at the first and last stages, beyond 2^31 elements) ever
exists at once. The encode takes frame 0, then 4 frames a chunk (one latent
frame each); a temporal downsample carries the previous chunk's last frame
and runs its stride-2 `time_conv` over that frame and the chunk, which is
JAX's `concat([x0, conv_t(x, k=3, s=2)])` window by window. The decode takes
one latent frame a chunk (1 video frame, then 4 each). Every other op is per
frame, so both are the same functions as JAX's whole-sequence ones
(tests/test_torch_wan.py and tests/test_torch_wan_i2v.py hold them
together).

The mid-block attention is single-headed over the pixels of each frame at
head_dim = the channel width, on the `native` backend as JAX forces it
(`:191`): no kernel takes that head dim.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...ops.attention import dispatch_attention_fn
from ...ops.module import Conv2d, Conv3d
from ..modeling_utils import ModelMixin
from .vae import DecoderOutput, DiagonalGaussianDistribution

CACHE_T = 2  # input frames a causal conv carries between chunks (its temporal kernel - 1)


def _triple(v) -> Tuple[int, int, int]:
    return (v,) * 3 if isinstance(v, int) else tuple(v)


class WanCausalConv3d(Conv3d):
    """Conv3d padded causally in time (2 p_t frames before, none after) and
    symmetrically in space. `cache_x`: frames of the stream that come before
    `x` (at most 2 p_t), standing in for as many zero frames."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0):
        super().__init__(in_channels, out_channels, _triple(kernel_size), stride=_triple(stride), padding=0)
        p = _triple(padding)
        self._padding = (p[2], p[2], p[1], p[1], 2 * p[0], 0)

    def forward(self, x: torch.Tensor, cache_x: Optional[torch.Tensor] = None) -> torch.Tensor:
        padding = list(self._padding)
        if cache_x is not None and padding[4] > 0:
            x = torch.cat([cache_x.to(x.dtype), x], dim=2)
            padding[4] -= cache_x.shape[2]
        return super().forward(F.pad(x, padding))


class CausalCache:
    """The carries of a chunked encode or decode: for each causal conv, the
    last CACHE_T frames of its input stream so far (fewer while the stream
    is shorter: upstream's ``cache_x.shape[2] < 2`` case); for each temporal
    downsample's `time_conv`, the last frame of its input so far; the
    temporal upsamples whose first frame has passed."""

    def __init__(self):
        self.frames = {}
        self.started = set()

    def conv(self, conv: WanCausalConv3d, x: torch.Tensor) -> torch.Tensor:
        prev = self.frames.get(conv)
        carry = x[:, :, -CACHE_T:]
        if carry.shape[2] < CACHE_T and prev is not None:
            carry = torch.cat([prev[:, :, -1:], carry], dim=2)
        self.frames[conv] = carry.clone()
        return conv(x, prev)

    def downsample(self, time_conv: WanCausalConv3d, x: torch.Tensor) -> torch.Tensor:
        """The stride-2 temporal downsample of a chunk: frame 0 of the stream
        passes through (and the first chunk's later frames, if any, take the
        whole-sequence rule); a later chunk runs `time_conv` over the previous
        chunk's last frame and its own frames. Exact while every later chunk
        has an even number of frames."""
        prev = self.frames.get(time_conv)
        self.frames[time_conv] = x[:, :, -1:].clone()
        if prev is not None:
            return time_conv(torch.cat([prev, x], dim=2))
        return x[:, :, :1] if x.shape[2] == 1 else torch.cat([x[:, :, :1], time_conv(x)], dim=2)


def _causal(conv: WanCausalConv3d, x: torch.Tensor, cache: Optional[CausalCache]) -> torch.Tensor:
    return conv(x) if cache is None else cache.conv(conv, x)


class WanRMSNorm(nn.Module):
    """x / ||x|| (over the channel axis 1, in float32) * sqrt(dim) * gamma, as
    JAX computes it; gamma [dim, 1, 1, 1] (`images=False`) or [dim, 1, 1]."""

    reshape_on_load = ("gamma", "bias")  # the JAX package writes them flat [dim]

    def __init__(self, dim: int, images: bool = True, bias: bool = False):
        super().__init__()
        self.dim = dim
        shape = (dim, 1, 1) if images else (dim, 1, 1, 1)
        self.gamma = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape)) if bias else None

    def reset_parameters(self) -> None:
        nn.init.ones_(self.gamma)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for name in self.reshape_on_load:
            param, t = getattr(self, name), state_dict.get(prefix + name)
            if param is not None and t is not None and t.shape != param.shape and t.numel() == param.numel():
                state_dict[prefix + name] = t.reshape(param.shape)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf / torch.clamp_min(xf.square().sum(dim=1, keepdim=True).sqrt(), 1e-12)
        out = xf.to(x.dtype) * (self.dim**0.5) * self.gamma.to(x.dtype)
        return out if self.bias is None else out + self.bias.to(x.dtype)


class _Upsample2x(nn.Module):
    """Nearest 2x spatial upsample of [N, C, H, W]."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class WanResample(nn.Module):
    def __init__(self, dim: int, mode: str, upsample_out_dim: Optional[int] = None):
        super().__init__()
        self.mode = mode
        out_dim = upsample_out_dim if upsample_out_dim is not None else dim // 2
        self.time_conv = None
        if mode in ("upsample2d", "upsample3d"):
            self.resample = nn.Sequential(_Upsample2x(), Conv2d(dim, out_dim, kernel_size=3, padding=1))
            if mode == "upsample3d":
                self.time_conv = WanCausalConv3d(dim, dim * 2, (3, 1, 1), padding=(1, 0, 0))
        elif mode in ("downsample2d", "downsample3d"):
            self.resample = nn.Sequential(nn.ZeroPad2d((0, 1, 0, 1)), Conv2d(dim, dim, kernel_size=3, stride=2))
            if mode == "downsample3d":
                self.time_conv = WanCausalConv3d(dim, dim, (3, 1, 1), stride=(2, 1, 1), padding=(0, 0, 0))
        else:
            raise ValueError(f"unknown resample mode {mode}")

    def forward(self, x: torch.Tensor, cache: Optional[CausalCache] = None) -> torch.Tensor:
        """x [B, C, T, H, W]. With `cache`, x is a chunk of an encode or a decode."""
        b, c, t, h, w = x.shape
        if self.mode == "upsample3d":
            first = cache is None or self not in cache.started  # frame 0 of the stream is in this chunk
            if cache is not None:
                cache.started.add(self)
            head, rest = (x[:, :, :1], x[:, :, 1:]) if first else (None, x)
            if rest.shape[2] > 0:
                y = _causal(self.time_conv, rest, cache)  # [B, 2C, T', H, W], the two halves interleave in time
                n = rest.shape[2]
                y = y.reshape(b, 2, c, n, h, w).permute(0, 2, 3, 1, 4, 5).reshape(b, c, 2 * n, h, w)
                x = y if head is None else torch.cat([head, y], dim=2)
            else:
                x = head
            t = x.shape[2]
        y = self.resample(x.transpose(1, 2).reshape(b * t, c, h, w))
        x = y.reshape(b, t, *y.shape[1:]).transpose(1, 2)
        if self.mode == "downsample3d":
            if cache is not None:
                return cache.downsample(self.time_conv, x)
            x = torch.cat([x[:, :, :1], self.time_conv(x)], dim=2)  # frame 0, then stride-2 windows
        return x


class WanResidualBlock(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.norm1 = WanRMSNorm(in_dim, images=False)
        self.conv1 = WanCausalConv3d(in_dim, out_dim, 3, padding=1)
        self.norm2 = WanRMSNorm(out_dim, images=False)
        self.conv2 = WanCausalConv3d(out_dim, out_dim, 3, padding=1)
        self.conv_shortcut = WanCausalConv3d(in_dim, out_dim, 1) if in_dim != out_dim else None

    def forward(self, x: torch.Tensor, cache: Optional[CausalCache] = None) -> torch.Tensor:
        h = x if self.conv_shortcut is None else self.conv_shortcut(x)
        x = _causal(self.conv1, F.silu(self.norm1(x)), cache)
        x = _causal(self.conv2, F.silu(self.norm2(x)), cache)
        return x + h


class WanAttentionBlock(nn.Module):
    """Single-head attention over the pixels of each frame."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = WanRMSNorm(dim)
        self.to_qkv = Conv2d(dim, dim * 3, kernel_size=1)
        self.proj = Conv2d(dim, dim, kernel_size=1)

    def forward(self, x: torch.Tensor, cache: Optional[CausalCache] = None) -> torch.Tensor:
        """x [B, C, T, H, W]; each frame on its own, so a chunk needs no `cache`."""
        b, c, t, h, w = x.shape
        y = self.to_qkv(self.norm(x.transpose(1, 2).reshape(b * t, c, h, w)))
        q, k, v = y.reshape(b * t, 3 * c, h * w).transpose(1, 2)[:, :, None].chunk(3, dim=-1)  # [BT, HW, 1, C]
        o = dispatch_attention_fn(q, k, v, backend="native").reshape(b * t, h * w, c).transpose(1, 2)
        o = self.proj(o.reshape(b * t, c, h, w))
        return x + o.reshape(b, t, c, h, w).transpose(1, 2)


class WanMidBlock(nn.Module):
    def __init__(self, dim: int, num_layers: int = 1):
        super().__init__()
        self.resnets = nn.ModuleList([WanResidualBlock(dim, dim) for _ in range(num_layers + 1)])
        self.attentions = nn.ModuleList([WanAttentionBlock(dim) for _ in range(num_layers)])

    def forward(self, x: torch.Tensor, cache: Optional[CausalCache] = None) -> torch.Tensor:
        x = self.resnets[0](x, cache)
        for attn, resnet in zip(self.attentions, self.resnets[1:]):
            x = resnet(attn(x), cache)
        return x


class WanEncoder3d(nn.Module):
    def __init__(self, in_channels: int = 3, dim: int = 128, z_dim: int = 4, dim_mult=(1, 2, 4, 4),
                 num_res_blocks: int = 2, attn_scales=(), temperal_downsample=(True, True, False)):
        super().__init__()
        dims = [dim * u for u in [1] + list(dim_mult)]
        self.conv_in = WanCausalConv3d(in_channels, dims[0], 3, padding=1)
        blocks, scale = [], 1.0
        for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
            for _ in range(num_res_blocks):
                blocks.append(WanResidualBlock(in_dim, out_dim))
                if scale in attn_scales:
                    blocks.append(WanAttentionBlock(out_dim))
                in_dim = out_dim
            if i != len(dim_mult) - 1:
                blocks.append(WanResample(out_dim, mode="downsample3d" if temperal_downsample[i] else "downsample2d"))
                scale /= 2.0
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = WanMidBlock(dims[-1], num_layers=1)
        self.norm_out = WanRMSNorm(dims[-1], images=False)
        self.conv_out = WanCausalConv3d(dims[-1], z_dim, 3, padding=1)

    def forward(self, x: torch.Tensor, cache: Optional[CausalCache] = None) -> torch.Tensor:
        x = _causal(self.conv_in, x, cache)
        for block in self.down_blocks:
            x = block(x, cache)
        x = self.mid_block(x, cache)
        return _causal(self.conv_out, F.silu(self.norm_out(x)), cache)


class WanUpBlock(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, num_res_blocks: int, upsample_mode: Optional[str] = None):
        super().__init__()
        self.resnets = nn.ModuleList([WanResidualBlock(in_dim if i == 0 else out_dim, out_dim)
                                      for i in range(num_res_blocks + 1)])
        self.upsamplers = (nn.ModuleList([WanResample(out_dim, mode=upsample_mode)])
                           if upsample_mode is not None else None)

    def forward(self, x: torch.Tensor, cache: Optional[CausalCache] = None) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x, cache)
        return x if self.upsamplers is None else self.upsamplers[0](x, cache)


class WanDecoder3d(nn.Module):
    def __init__(self, dim: int = 128, z_dim: int = 4, dim_mult=(1, 2, 4, 4), num_res_blocks: int = 2,
                 attn_scales=(), temperal_upsample=(False, True, True), out_channels: int = 3):
        super().__init__()
        dims = [dim * u for u in [dim_mult[-1]] + list(dim_mult)[::-1]]
        self.conv_in = WanCausalConv3d(z_dim, dims[0], 3, padding=1)
        self.mid_block = WanMidBlock(dims[0], num_layers=1)
        blocks = []
        for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
            up = i != len(dim_mult) - 1
            mode = ("upsample3d" if temperal_upsample[i] else "upsample2d") if up else None
            blocks.append(WanUpBlock(in_dim // 2 if i > 0 else in_dim, out_dim, num_res_blocks, mode))
        self.up_blocks = nn.ModuleList(blocks)
        self.norm_out = WanRMSNorm(dims[-1], images=False)
        self.conv_out = WanCausalConv3d(dims[-1], out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor, cache: Optional[CausalCache] = None) -> torch.Tensor:
        x = self.mid_block(_causal(self.conv_in, x, cache), cache)
        for block in self.up_blocks:
            x = block(x, cache)
        return _causal(self.conv_out, F.silu(self.norm_out(x)), cache)


class AutoencoderKLWan(ModelMixin, ConfigMixin):
    """The Wan 2.1 video VAE."""

    @register_to_config
    def __init__(
        self,
        base_dim: int = 96,
        z_dim: int = 16,
        dim_mult: Tuple[int, ...] = (1, 2, 4, 4),
        num_res_blocks: int = 2,
        attn_scales: Tuple[float, ...] = (),
        temperal_downsample: Tuple[bool, ...] = (False, True, True),
        dropout: float = 0.0,
        latents_mean: Optional[List[float]] = None,
        latents_std: Optional[List[float]] = None,
        is_residual: bool = False,
        in_channels: int = 3,
        out_channels: int = 3,
        patch_size: Optional[int] = None,
        scale_factor_temporal: int = 4,
        scale_factor_spatial: int = 8,
        clip_output: bool = True,
    ):
        super().__init__()
        if is_residual or patch_size is not None:
            raise NotImplementedError("the Wan 2.2 residual VAE is not ported (nor in the JAX package)")
        self.clip_output = clip_output
        # video frames an encode chunk takes after frame 0: one latent frame's worth
        self.encode_chunk = 2 ** sum(bool(d) for d in list(temperal_downsample)[:len(dim_mult) - 1])
        self.encoder = WanEncoder3d(in_channels=in_channels, dim=base_dim, z_dim=z_dim * 2, dim_mult=dim_mult,
                                    num_res_blocks=num_res_blocks, attn_scales=attn_scales,
                                    temperal_downsample=temperal_downsample)
        self.quant_conv = WanCausalConv3d(z_dim * 2, z_dim * 2, 1)
        self.post_quant_conv = WanCausalConv3d(z_dim, z_dim, 1)
        self.decoder = WanDecoder3d(dim=base_dim, z_dim=z_dim, dim_mult=dim_mult, num_res_blocks=num_res_blocks,
                                    attn_scales=attn_scales, temperal_upsample=list(temperal_downsample)[::-1],
                                    out_channels=out_channels)

    def encode(self, x: torch.Tensor, return_dict: bool = True):
        """x [B, C, T, H, W] in [-1, 1] -> the posterior over [B, 2 z, T', H', W']
        moments, T' = 1 + (T - 1) / `encode_chunk`: frame 0, then
        `encode_chunk` frames (4 in Wan's VAE) a chunk. T - 1 must be a
        multiple of `encode_chunk`."""
        t, n = x.shape[2], self.encode_chunk
        if (t - 1) % n:
            raise ValueError(f"AutoencoderKLWan.encode takes 1 + {n} k frames, got {t}")
        cache = CausalCache()
        bounds = [(0, 1)] + [(i, i + n) for i in range(1, t, n)]
        moments = torch.cat([self.encoder(x[:, :, i:j], cache) for i, j in bounds], dim=2)
        posterior = DiagonalGaussianDistribution(self.quant_conv(moments))
        return posterior if return_dict else (posterior,)

    def decode(self, z: torch.Tensor, return_dict: bool = True):
        """z [B, z, T', H', W'] -> video [B, C, 1 + 4 (T' - 1), H, W] in [-1, 1],
        one latent frame a chunk."""
        x, cache, chunks = self.post_quant_conv(z), CausalCache(), []
        for i in range(x.shape[2]):
            out = self.decoder(x[:, :, i:i + 1], cache)
            chunks.append(out.clamp(-1.0, 1.0) if self.clip_output else out)
        out = torch.cat(chunks, dim=2)
        return DecoderOutput(sample=out) if return_dict else (out,)

"""LTXLatentUpsamplerModel: LTX-Video's 2x latent upsampler (spatial,
temporal or both).

Port of `diffusers_tpu/pipelines/ltx/modeling_latent_upsampler.py` over
``[B, C, F, H, W]`` latents, with upstream's state-dict names: an initial
conv with GroupNorm + SiLU, ``num_blocks_per_stage`` residual blocks, a
pixel-shuffle upsampler (a per-frame 2-D conv for the spatial mode, even
when ``dims`` is 3; a 3-D conv otherwise; the temporal modes drop the first
upsampled frame, `:129-134`), as many residual blocks after it, and a final
conv. ``dims`` 2 runs every conv per frame.

Every `GroupNorm(32, mid_channels)` is the port's `GroupNorm`, so kernel K4
on the card (the initial norm and each block's first norm with its SiLU
fused, ``apply_silu=True``): 17 launches a call at ``num_blocks_per_stage``
4, over 5-D ``[B, 512, F, H, W]`` activations (per-frame 4-D ones where
``dims`` is 2).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...models.modeling_utils import ModelMixin
from ...ops.module import Conv2d, Conv3d, GroupNorm


class _ResBlock(nn.Module):
    def __init__(self, channels: int, dims: int = 3):
        super().__init__()
        conv = Conv2d if dims == 2 else Conv3d
        self.conv1 = conv(channels, channels, kernel_size=3, padding=1)
        self.norm1 = GroupNorm(32, channels)
        self.conv2 = conv(channels, channels, kernel_size=3, padding=1)
        self.norm2 = GroupNorm(32, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(self.conv1(x), apply_silu=True)
        return F.silu(self.norm2(self.conv2(h)) + x)


def _per_frame(fn, x: torch.Tensor) -> torch.Tensor:
    """`fn` over each frame of ``[B, C, F, H, W]`` as ``[B F, C, H, W]``."""
    b, _, f = x.shape[:3]
    y = fn(x.transpose(1, 2).reshape(b * f, *x.shape[1:2], *x.shape[3:]))
    return y.reshape(b, f, *y.shape[1:]).transpose(1, 2)


def _shuffle_spatiotemporal(x: torch.Tensor) -> torch.Tensor:
    """[B, c 8, D, H, W] (upstream's channel order c, p1, p2, p3) -> [B, c, 2D, 2H, 2W]."""
    b, cp, d, h, w = x.shape
    x = x.reshape(b, cp // 8, 2, 2, 2, d, h, w).permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(b, cp // 8, 2 * d, 2 * h, 2 * w)


def _shuffle_temporal(x: torch.Tensor) -> torch.Tensor:
    """[B, c 2, D, H, W] (order c, p1) -> [B, c, 2D, H, W]."""
    b, cp, d, h, w = x.shape
    return x.reshape(b, cp // 2, 2, d, h, w).permute(0, 1, 3, 2, 4, 5).reshape(b, cp // 2, 2 * d, h, w)


class LTXLatentUpsamplerModel(ModelMixin, ConfigMixin):
    @register_to_config
    def __init__(
        self,
        in_channels: int = 128,
        mid_channels: int = 512,
        num_blocks_per_stage: int = 4,
        dims: int = 3,
        spatial_upsample: bool = True,
        temporal_upsample: bool = False,
    ):
        super().__init__()
        if not (spatial_upsample or temporal_upsample):
            raise ValueError("Either spatial_upsample or temporal_upsample must be True")
        conv = Conv2d if dims == 2 else Conv3d
        self.initial_conv = conv(in_channels, mid_channels, kernel_size=3, padding=1)
        self.initial_norm = GroupNorm(32, mid_channels)
        self.res_blocks = nn.ModuleList([_ResBlock(mid_channels, dims) for _ in range(num_blocks_per_stage)])
        if spatial_upsample and temporal_upsample:
            up = Conv3d(mid_channels, 8 * mid_channels, kernel_size=3, padding=1)
        elif spatial_upsample:  # upstream's per-frame 2-D conv, even where dims is 3
            up = Conv2d(mid_channels, 4 * mid_channels, kernel_size=3, padding=1)
        else:
            up = Conv3d(mid_channels, 2 * mid_channels, kernel_size=3, padding=1)
        self.upsampler = nn.ModuleList([up])
        self.post_upsample_res_blocks = nn.ModuleList([_ResBlock(mid_channels, dims)
                                                       for _ in range(num_blocks_per_stage)])
        self.final_conv = conv(mid_channels, in_channels, kernel_size=3, padding=1)

    def _stages(self, x: torch.Tensor, upsample) -> torch.Tensor:
        x = self.initial_norm(self.initial_conv(x), apply_silu=True)
        for block in self.res_blocks:
            x = block(x)
        x = upsample(x)
        for block in self.post_upsample_res_blocks:
            x = block(x)
        return self.final_conv(x)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        """[B, C, F, H, W] -> the upsampled [B, C, F', H', W']."""
        cfg = self.config
        up = self.upsampler[0]
        if cfg.dims == 2:
            return _per_frame(lambda x: self._stages(x, lambda h: F.pixel_shuffle(up(h), 2)), hidden_states)
        if cfg.spatial_upsample and cfg.temporal_upsample:
            return self._stages(hidden_states, lambda h: _shuffle_spatiotemporal(up(h))[:, :, 1:])
        if cfg.temporal_upsample:
            return self._stages(hidden_states, lambda h: _shuffle_temporal(up(h))[:, :, 1:])
        return self._stages(hidden_states, lambda h: _per_frame(lambda f: F.pixel_shuffle(up(f), 2), h))

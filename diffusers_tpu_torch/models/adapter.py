"""T2I-Adapter (https://huggingface.co/papers/2302.08453): small
control-feature extractors whose multi-scale features the UNet adds inside
its down blocks (`down_intrablock_additional_residuals`).

Port of `diffusers_tpu/models/adapter.py`: `T2IAdapter` with its
``full_adapter`` (SD), ``full_adapter_xl`` (SDXL) and ``light_adapter``
bodies, and `MultiAdapter`, the weighted sum of several adapters' features.
NCHW throughout (JAX goes NHWC inside): the control image is pixel-unshuffled
by `downscale_factor` (`F.pixel_unshuffle`, the channel order JAX's
`_pixel_unshuffle` reproduces), and a downsampling block halves with a 2x2
average pool that rounds up (JAX pads odd sizes by edge replication before
its pool). The feature maps come out NCHW, one per body block.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..configuration_utils import ConfigMixin, register_to_config
from ..ops.module import Conv2d
from .modeling_utils import ModelMixin


def _avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2; an odd height or width is first padded by
    repeating its last row or column (JAX's `_avg_pool_2x`)."""
    ph, pw = x.shape[-2] % 2, x.shape[-1] % 2
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), mode="replicate")
    return F.avg_pool2d(x, kernel_size=2, stride=2)


class AdapterResnetBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.block1 = Conv2d(channels, channels, kernel_size=3, padding=1)
        self.block2 = Conv2d(channels, channels, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block2(F.relu(self.block1(x))) + x


class AdapterBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_res_blocks: int, down: bool = False):
        super().__init__()
        self.down = down
        self.in_conv = Conv2d(in_channels, out_channels, kernel_size=1) if in_channels != out_channels else None
        self.resnets = nn.ModuleList([AdapterResnetBlock(out_channels) for _ in range(num_res_blocks)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.down:
            x = _avg_pool_2x(x)
        if self.in_conv is not None:
            x = self.in_conv(x)
        for resnet in self.resnets:
            x = resnet(x)
        return x


class LightAdapterResnetBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.block1 = Conv2d(channels, channels, kernel_size=3, padding=1)
        self.block2 = Conv2d(channels, channels, kernel_size=3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block2(F.relu(self.block1(x))) + x


class LightAdapterBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_res_blocks: int, down: bool = False):
        super().__init__()
        mid = out_channels // 4
        self.down = down
        self.in_conv = Conv2d(in_channels, mid, kernel_size=1)
        self.resnets = nn.ModuleList([LightAdapterResnetBlock(mid) for _ in range(num_res_blocks)])
        self.out_conv = Conv2d(mid, out_channels, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.down:
            x = _avg_pool_2x(x)
        x = self.in_conv(x)
        for resnet in self.resnets:
            x = resnet(x)
        return self.out_conv(x)


class T2IAdapter(ModelMixin, ConfigMixin):
    @register_to_config
    def __init__(
        self,
        in_channels: int = 3,
        channels: Sequence[int] = (320, 640, 1280, 1280),
        num_res_blocks: int = 2,
        downscale_factor: int = 8,
        adapter_type: str = "full_adapter",
    ):
        super().__init__()
        channels = list(channels)
        self.downscale_factor = downscale_factor
        unshuffled = in_channels * downscale_factor**2
        if adapter_type == "full_adapter":
            self.conv_in = Conv2d(unshuffled, channels[0], kernel_size=3, padding=1)
            body = [AdapterBlock(channels[0], channels[0], num_res_blocks)]
            body += [AdapterBlock(channels[i - 1], channels[i], num_res_blocks, down=True)
                     for i in range(1, len(channels))]
            self.total_downscale_factor = downscale_factor * 2 ** (len(channels) - 1)
        elif adapter_type == "full_adapter_xl":
            self.conv_in = Conv2d(unshuffled, channels[0], kernel_size=3, padding=1)
            body = []
            for i in range(len(channels)):
                if i == 1:
                    body.append(AdapterBlock(channels[i - 1], channels[i], num_res_blocks))
                elif i == 2:
                    body.append(AdapterBlock(channels[i - 1], channels[i], num_res_blocks, down=True))
                else:
                    body.append(AdapterBlock(channels[i], channels[i], num_res_blocks))
            self.total_downscale_factor = downscale_factor * 2
        elif adapter_type == "light_adapter":
            self.conv_in = None
            body = [LightAdapterBlock(unshuffled, channels[0], num_res_blocks)]
            body += [LightAdapterBlock(channels[i], channels[i + 1], num_res_blocks, down=True)
                     for i in range(len(channels) - 1)]
            body += [LightAdapterBlock(channels[-1], channels[-1], num_res_blocks, down=True)]
            self.total_downscale_factor = downscale_factor * (2 ** len(channels))
        else:
            raise ValueError(f"Unsupported adapter_type: {adapter_type!r}. Choose 'full_adapter', "
                             "'full_adapter_xl' or 'light_adapter'.")
        self.body = nn.ModuleList(body)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: [B, C, H, W] control image -> one NCHW feature map a body block."""
        x = F.pixel_unshuffle(x, self.downscale_factor)
        if self.conv_in is not None:
            x = self.conv_in(x)
        features = []
        for block in self.body:
            x = block(x)
            features.append(x)
        return features


class MultiAdapter(ModelMixin):
    """Several `T2IAdapter`s, their feature lists summed with weights."""

    def __init__(self, adapters: List[T2IAdapter]):
        super().__init__()
        if len(adapters) < 2:
            raise ValueError("MultiAdapter takes at least two adapters; for one, use T2IAdapter directly")
        factors = {a.total_downscale_factor for a in adapters}
        if len(factors) != 1:
            raise ValueError(f"adapters disagree on total_downscale_factor: {factors}")
        self.adapters = nn.ModuleList(adapters)
        self.total_downscale_factor = adapters[0].total_downscale_factor

    def forward(self, xs: torch.Tensor, adapter_weights: Optional[Sequence[float]] = None) -> List[torch.Tensor]:
        """xs: [B, n_adapters * C, H, W], the control images stacked on the
        channel axis; the weights default to 1 / n_adapters each."""
        n = len(self.adapters)
        weights = adapter_weights if adapter_weights is not None else [1.0 / n] * n
        total = None
        for x, w, adapter in zip(xs.chunk(n, dim=1), weights, self.adapters):
            features = adapter(x)
            total = [w * f for f in features] if total is None else [a + w * f for a, f in zip(total, features)]
        return total

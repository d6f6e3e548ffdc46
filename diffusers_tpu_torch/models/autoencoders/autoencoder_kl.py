"""AutoencoderKL — the SD-family image VAE.

Port of `diffusers_tpu/models/autoencoders/autoencoder_kl.py` (`encode`,
`decode`; NCHW public API) with its tiled decode (`:72-156`):
`enable_tiling` / `disable_tiling` set `use_tiling`, which the Flux pipeline
reads; `tiled_decode` decodes latent tiles of ``tile_latent_min_size`` (the
config's ``sample_size`` over the VAE's scale factor) overlapping by a
quarter, each through the same `decode` (so each tile's GroupNorms run
kernel K4 on the card), blends each tile's top and left edges into its
neighbours' with a linear ramp (`_blend_v`, `_blend_h`) and keeps each
tile's first ``tile_sample_min_size - blend_extent`` pixels. A decode's
working memory is then one tile's. JAX has no tiled encode, and neither has
the port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...configuration_utils import ConfigMixin, register_to_config
from ...ops.module import Conv2d
from ..modeling_utils import ModelMixin
from .vae import Decoder, DecoderOutput, DiagonalGaussianDistribution, Encoder


class AutoencoderKL(ModelMixin, ConfigMixin):
    @register_to_config
    def __init__(
        self,
        in_channels: int = 3,
        out_channels: int = 3,
        down_block_types: Tuple[str, ...] = ("DownEncoderBlock2D",),
        up_block_types: Tuple[str, ...] = ("UpDecoderBlock2D",),
        block_out_channels: Tuple[int, ...] = (64,),
        layers_per_block: int = 1,
        act_fn: str = "silu",
        latent_channels: int = 4,
        norm_num_groups: int = 32,
        sample_size: int = 32,
        scaling_factor: float = 0.18215,
        shift_factor: Optional[float] = None,
        latents_mean: Optional[Tuple[float]] = None,
        latents_std: Optional[Tuple[float]] = None,
        force_upcast: bool = True,
        use_quant_conv: bool = True,
        use_post_quant_conv: bool = True,
        mid_block_add_attention: bool = True,
    ):
        super().__init__()
        self.encoder = Encoder(
            in_channels=in_channels,
            out_channels=latent_channels,
            down_block_types=down_block_types,
            block_out_channels=block_out_channels,
            layers_per_block=layers_per_block,
            act_fn=act_fn,
            norm_num_groups=norm_num_groups,
            double_z=True,
            mid_block_add_attention=mid_block_add_attention,
        )
        self.decoder = Decoder(
            in_channels=latent_channels,
            out_channels=out_channels,
            up_block_types=up_block_types,
            block_out_channels=block_out_channels,
            layers_per_block=layers_per_block,
            norm_num_groups=norm_num_groups,
            act_fn=act_fn,
            mid_block_add_attention=mid_block_add_attention,
        )
        self.quant_conv = Conv2d(2 * latent_channels, 2 * latent_channels, kernel_size=1, padding=0) if use_quant_conv else None
        self.post_quant_conv = Conv2d(latent_channels, latent_channels, kernel_size=1, padding=0) if use_post_quant_conv else None

        # tiling defaults (JAX `:67-71`)
        self.tile_sample_min_size = sample_size if isinstance(sample_size, int) else 512
        self.tile_latent_min_size = int(self.tile_sample_min_size / (2 ** (len(block_out_channels) - 1)))
        self.tile_overlap_factor = 0.25
        self.use_tiling = False

    def enable_tiling(self, tile_sample_min_size: Optional[int] = None) -> None:
        """Decode in tiles (`tiled_decode`) where a pipeline honours it; a
        tile is `tile_sample_min_size` pixels on a side (default: the
        config's ``sample_size``)."""
        self.use_tiling = True
        if tile_sample_min_size is not None:
            self.tile_sample_min_size = tile_sample_min_size
            self.tile_latent_min_size = int(tile_sample_min_size / (2 ** (len(self.config.block_out_channels) - 1)))

    def disable_tiling(self) -> None:
        self.use_tiling = False

    def encode(self, x: torch.Tensor, return_dict: bool = True):
        """x: [B, C, H, W] in [-1, 1] -> DiagonalGaussianDistribution (NCHW)."""
        h = self.encoder(x)
        if self.quant_conv is not None:
            h = self.quant_conv(h)
        posterior = DiagonalGaussianDistribution(h)
        if not return_dict:
            return (posterior,)
        return posterior

    def decode(self, z: torch.Tensor, return_dict: bool = True):
        """z: [B, latent_C, h, w] -> sample [B, C, H, W]."""
        if self.post_quant_conv is not None:
            z = self.post_quant_conv(z)
        dec = self.decoder(z)
        if not return_dict:
            return (dec,)
        return DecoderOutput(sample=dec)

    @staticmethod
    def _blend_v(a: torch.Tensor, b: torch.Tensor, blend_extent: int) -> torch.Tensor:
        """`b` with its first rows faded in from the last rows of `a` above it."""
        blend_extent = min(a.shape[2], b.shape[2], blend_extent)
        ramp = (torch.arange(blend_extent, device=b.device, dtype=torch.float32) / blend_extent).to(b.dtype)
        ramp = ramp[None, None, :, None]
        mixed = a[:, :, -blend_extent:, :] * (1 - ramp) + b[:, :, :blend_extent, :] * ramp
        return torch.cat([mixed, b[:, :, blend_extent:, :]], dim=2)

    @staticmethod
    def _blend_h(a: torch.Tensor, b: torch.Tensor, blend_extent: int) -> torch.Tensor:
        """`b` with its first columns faded in from the last columns of `a` to its left."""
        blend_extent = min(a.shape[3], b.shape[3], blend_extent)
        ramp = (torch.arange(blend_extent, device=b.device, dtype=torch.float32) / blend_extent).to(b.dtype)
        ramp = ramp[None, None, None, :]
        mixed = a[:, :, :, -blend_extent:] * (1 - ramp) + b[:, :, :, :blend_extent] * ramp
        return torch.cat([mixed, b[:, :, :, blend_extent:]], dim=3)

    def tiled_decode(self, z: torch.Tensor, return_dict: bool = True):
        """The seam-blended decode of `z` in overlapping tiles (JAX `:126-156`)."""
        overlap_size = int(self.tile_latent_min_size * (1 - self.tile_overlap_factor))
        blend_extent = int(self.tile_sample_min_size * self.tile_overlap_factor)
        row_limit = self.tile_sample_min_size - blend_extent
        tile = self.tile_latent_min_size
        rows = [[self.decode(z[:, :, i:i + tile, j:j + tile]).sample for j in range(0, z.shape[3], overlap_size)]
                for i in range(0, z.shape[2], overlap_size)]
        result_rows = []
        for i, row in enumerate(rows):
            result_row = []
            for j, decoded in enumerate(row):
                if i > 0:
                    decoded = self._blend_v(rows[i - 1][j], decoded, blend_extent)
                if j > 0:
                    decoded = self._blend_h(row[j - 1], decoded, blend_extent)
                result_row.append(decoded[:, :, :row_limit, :row_limit])
            result_rows.append(torch.cat(result_row, dim=3))
        dec = torch.cat(result_rows, dim=2)
        if not return_dict:
            return (dec,)
        return DecoderOutput(sample=dec)

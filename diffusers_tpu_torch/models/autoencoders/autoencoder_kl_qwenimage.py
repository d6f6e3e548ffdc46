"""AutoencoderKLQwenImage: Qwen-Image's VAE.

Port of `diffusers_tpu/models/autoencoders/autoencoder_kl_qwenimage.py`
(`:20-60`): upstream's Qwen-Image VAE is the Wan 2.1 causal 3-D VAE under
another config surface, so this is a config-compatible subclass of the
port's `AutoencoderKLWan` (the same state-dict names) whose `config.json`
keeps QwenImage's keys (``input_channels`` for in and out channels, no Wan-only
key) and whose default ``latents_mean`` / ``latents_std`` are Qwen-Image's
per-channel statistics. An image goes in as one frame (``[B, C, 1, H, W]``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ...configuration_utils import register_to_config
from .autoencoder_kl_wan import AutoencoderKLWan

QWENIMAGE_LATENTS_MEAN = [
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
]
QWENIMAGE_LATENTS_STD = [
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
]


class AutoencoderKLQwenImage(AutoencoderKLWan):
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
        input_channels: int = 3,
        latents_mean: Optional[List[float]] = tuple(QWENIMAGE_LATENTS_MEAN),
        latents_std: Optional[List[float]] = tuple(QWENIMAGE_LATENTS_STD),
    ):
        # the parent's body without its config recording: the saved config
        # keeps QwenImage's key surface
        AutoencoderKLWan.__init__.__wrapped__(
            self, base_dim=base_dim, z_dim=z_dim, dim_mult=tuple(dim_mult), num_res_blocks=num_res_blocks,
            attn_scales=tuple(attn_scales), temperal_downsample=tuple(temperal_downsample), dropout=dropout,
            in_channels=input_channels, out_channels=input_channels,
            latents_mean=list(QWENIMAGE_LATENTS_MEAN if latents_mean is None else latents_mean),
            latents_std=list(QWENIMAGE_LATENTS_STD if latents_std is None else latents_std))

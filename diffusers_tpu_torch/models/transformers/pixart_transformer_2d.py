"""PixArt-alpha's timestep embeddings: `AdaLayerNormSingle` and the
combined timestep embedder it builds on, which LTX-Video's transformer and
its VAE's timestep-conditioned decoder use.

Port of `PixArtAlphaCombinedTimestepSizeEmbeddings` and
`AdaLayerNormSingle` of `diffusers_tpu/models/transformers/
pixart_transformer_2d.py` (`:33-66`), at the same path. The PixArt
transformer itself is not ported yet (ROADMAP A9).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.module import Linear
from ..embeddings import TimestepEmbedding, Timesteps


class PixArtAlphaCombinedTimestepSizeEmbeddings(nn.Module):
    """The timestep embedding of `AdaLayerNormSingle` and of LTX's VAE
    decoder blocks (PixArt's resolution and aspect-ratio conditions wait for
    PixArt)."""

    def __init__(self, embedding_dim: int):
        super().__init__()
        self.time_proj = Timesteps(num_channels=256, flip_sin_to_cos=True, downscale_freq_shift=0)
        self.timestep_embedder = TimestepEmbedding(in_channels=256, time_embed_dim=embedding_dim)

    def forward(self, timestep: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self.timestep_embedder(self.time_proj(timestep).to(dtype))


class AdaLayerNormSingle(nn.Module):
    """(``linear(silu(emb))`` [N, 6 D], the embedded timestep [N, D])."""

    def __init__(self, embedding_dim: int):
        super().__init__()
        self.emb = PixArtAlphaCombinedTimestepSizeEmbeddings(embedding_dim)
        self.linear = Linear(embedding_dim, 6 * embedding_dim)

    def forward(self, timestep: torch.Tensor, dtype: torch.dtype = torch.float32):
        embedded_timestep = self.emb(timestep, dtype=dtype)
        return self.linear(F.silu(embedded_timestep)), embedded_timestep

"""IP-Adapter image-projection heads.

Port of `diffusers_tpu/models/ip_adapter.py`: `ImageProjection` (the base
head; the same class as the UNet's Kandinsky ``image_proj`` head in
`embeddings`), `IPAdapterFullImageProjection`,
`IPAdapterFaceIDImageProjection`, the Plus resampler
(`IPAdapterPlusImageProjectionBlock`, `IPAdapterPlusImageProjection`) and
`MultiIPAdapterImageProjection`. Submodule names are the diffusers-format
state-dict names that `loaders.ip_adapter` renames a published checkpoint
to. The resampler's attention goes through `dispatch_attention_fn`: on the
card its 64-wide heads run kernel K1.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from ..ops.module import LayerNorm, Linear
from .attention import Attention
from .attention_blocks import FeedForward
from .embeddings import ImageProjection

__all__ = [
    "ImageProjection",
    "IPAdapterFullImageProjection",
    "IPAdapterFaceIDImageProjection",
    "IPAdapterPlusImageProjectionBlock",
    "IPAdapterPlusImageProjection",
    "MultiIPAdapterImageProjection",
]


class IPAdapterFullImageProjection(nn.Module):
    """Per-patch CLIP states -> the same number of tokens: FeedForward, LayerNorm."""

    def __init__(self, image_embed_dim: int = 1024, cross_attention_dim: int = 1024):
        super().__init__()
        self.ff = FeedForward(image_embed_dim, cross_attention_dim, mult=1, activation_fn="gelu")
        self.norm = LayerNorm(cross_attention_dim)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        return self.norm(self.ff(image_embeds))


class IPAdapterFaceIDImageProjection(nn.Module):
    """An InsightFace id embedding -> `num_tokens` context tokens."""

    def __init__(self, image_embed_dim: int = 1024, cross_attention_dim: int = 1024, mult: int = 1,
                 num_tokens: int = 1):
        super().__init__()
        self.num_tokens = num_tokens
        self.cross_attention_dim = cross_attention_dim
        self.ff = FeedForward(image_embed_dim, cross_attention_dim * num_tokens, mult=mult, activation_fn="gelu")
        self.norm = LayerNorm(cross_attention_dim)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        x = self.ff(image_embeds)
        return self.norm(x.reshape(-1, self.num_tokens, self.cross_attention_dim))


class IPAdapterPlusImageProjectionBlock(nn.Module):
    """One resampler block: the latents attend to [image tokens ; latents]."""

    def __init__(self, embed_dims: int = 768, dim_head: int = 64, heads: int = 16, ffn_ratio: float = 4):
        super().__init__()
        self.ln0 = LayerNorm(embed_dims)
        self.ln1 = LayerNorm(embed_dims)
        self.attn = Attention(query_dim=embed_dims, dim_head=dim_head, heads=heads, out_bias=False)
        # (LayerNorm, FeedForward) in sequence: checkpoint keys ff.0 / ff.1
        self.ff = nn.ModuleList([
            LayerNorm(embed_dims),
            FeedForward(embed_dims, embed_dims, mult=int(ffn_ratio), activation_fn="gelu", bias=False),
        ])

    def forward(self, x: torch.Tensor, latents: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        enc = self.ln0(x)
        latents = self.ln1(latents)
        latents = self.attn(latents, encoder_hidden_states=torch.cat([enc, latents], dim=-2)) + residual
        return self.ff[1](self.ff[0](latents)) + latents


class IPAdapterPlusImageProjection(nn.Module):
    """Perceiver-style resampler over per-patch CLIP hidden states: learned
    queries (`latents`) through `depth` blocks, then a projection."""

    def __init__(self, embed_dims: int = 768, output_dims: int = 1024, hidden_dims: int = 1280, depth: int = 4,
                 dim_head: int = 64, heads: int = 16, num_queries: int = 8, ffn_ratio: float = 4):
        super().__init__()
        self.num_queries = num_queries
        self.hidden_dims = hidden_dims
        self.latents = nn.Parameter(torch.randn(1, num_queries, hidden_dims) / hidden_dims**0.5)
        self.proj_in = Linear(embed_dims, hidden_dims)
        self.proj_out = Linear(hidden_dims, output_dims)
        self.norm_out = LayerNorm(output_dims)
        self.layers = nn.ModuleList(
            [IPAdapterPlusImageProjectionBlock(hidden_dims, dim_head, heads, ffn_ratio) for _ in range(depth)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        latents = self.latents.expand(x.shape[0], -1, -1)
        x = self.proj_in(x)
        for block in self.layers:
            latents = block(x, latents, latents)
        return self.norm_out(self.proj_out(latents))


class MultiIPAdapterImageProjection(nn.Module):
    """One projection head per loaded IP-Adapter.

    Input: a list of n tensors [B, num_images, (seq,) D], one per adapter
    (a single tensor [B, D] stands for one adapter and one image); output:
    the list of projected tokens [B, num_images, tokens, cross_dim]."""

    def __init__(self, image_projection_layers: Sequence[nn.Module]):
        super().__init__()
        self.image_projection_layers = nn.ModuleList(list(image_projection_layers))

    @property
    def num_ip_adapters(self) -> int:
        return len(self.image_projection_layers)

    def forward(self, image_embeds: List[torch.Tensor]) -> List[torch.Tensor]:
        if not isinstance(image_embeds, (list, tuple)):
            image_embeds = [image_embeds[:, None]]
        if len(image_embeds) != len(self.image_projection_layers):
            raise ValueError(f"image_embeds must have one entry per IP-Adapter ({len(image_embeds)} vs "
                             f"{len(self.image_projection_layers)})")
        projected = []
        for embed, layer in zip(image_embeds, self.image_projection_layers):
            b, n = embed.shape[0], embed.shape[1]
            out = layer(embed.reshape((b * n,) + tuple(embed.shape[2:])))
            projected.append(out.reshape((b, n) + tuple(out.shape[1:])))
        return projected

"""Adaptive LayerNorms of the DiT family (AdaLN-Zero and friends).

Port of `diffusers_tpu/models/normalization.py` (`AdaLayerNormZero`,
`AdaLayerNormZeroSingle`, `AdaLayerNormContinuous` `:19-72`). Submodule names
(linear/norm) match the reference state-dict keys.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.module import LayerNorm, Linear, RMSNorm


class AdaLayerNormZero(nn.Module):
    """LayerNorm modulated by a 6-way (shift/scale/gate x 2) projection of temb."""

    def __init__(self, embedding_dim: int, bias: bool = True):
        super().__init__()
        self.linear = Linear(embedding_dim, 6 * embedding_dim, use_bias=bias)
        self.norm = LayerNorm(embedding_dim, eps=1e-6, use_scale=False, use_bias=False)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        emb = self.linear(F.silu(emb))
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = emb.chunk(6, dim=-1)
        x = self.norm(x) * (1 + scale_msa[:, None]) + shift_msa[:, None]
        return x, gate_msa, shift_mlp, scale_mlp, gate_mlp


class AdaLayerNormZeroSingle(nn.Module):
    def __init__(self, embedding_dim: int, bias: bool = True):
        super().__init__()
        self.linear = Linear(embedding_dim, 3 * embedding_dim, use_bias=bias)
        self.norm = LayerNorm(embedding_dim, eps=1e-6, use_scale=False, use_bias=False)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        emb = self.linear(F.silu(emb))
        shift_msa, scale_msa, gate_msa = emb.chunk(3, dim=-1)
        x = self.norm(x) * (1 + scale_msa[:, None]) + shift_msa[:, None]
        return x, gate_msa


class AdaLayerNormContinuous(nn.Module):
    def __init__(
        self,
        embedding_dim: int,
        conditioning_embedding_dim: int,
        elementwise_affine: bool = True,
        eps: float = 1e-5,
        bias: bool = True,
        norm_type: str = "layer_norm",
    ):
        super().__init__()
        self.linear = Linear(conditioning_embedding_dim, embedding_dim * 2, use_bias=bias)
        if norm_type == "layer_norm":
            self.norm = LayerNorm(embedding_dim, eps=eps, use_scale=elementwise_affine,
                                  use_bias=elementwise_affine and bias)
        elif norm_type == "rms_norm":
            self.norm = RMSNorm(embedding_dim, eps=eps, use_scale=elementwise_affine)
        else:
            raise ValueError(f"unknown norm_type {norm_type}")

    def forward(self, x: torch.Tensor, conditioning_embedding: torch.Tensor) -> torch.Tensor:
        emb = self.linear(F.silu(conditioning_embedding).to(x.dtype))
        scale, shift = emb.chunk(2, dim=-1)
        return self.norm(x) * (1 + scale[:, None, :]) + shift[:, None, :]

"""Transformer building blocks: FeedForward (GELU, GEGLU) and
BasicTransformerBlock.

Port of the SDXL- and Flux-path classes of
`diffusers_tpu/models/attention_blocks.py` (`GELUProj` `:35`, `GEGLU` `:48`,
`LinearActivation` `:83`, `FeedForward` `:103` with its ``gelu``,
``gelu-approximate``, ``geglu`` and ``linear-silu`` routes,
`BasicTransformerBlock` `:141`, the layer_norm variant). Submodule names
(norm1/attn1/norm2/attn2/norm3/ff.net.0.proj/ff.net.2) match the reference
state-dict keys.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.module import LayerNorm, Linear
from .attention import Attention


class GELUProj(nn.Module):
    """Linear + GELU (exact, or the tanh approximation)."""

    def __init__(self, dim_in: int, dim_out: int, approximate: str = "none", bias: bool = True):
        super().__init__()
        self.proj = Linear(dim_in, dim_out, use_bias=bias)
        self.approximate = approximate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.proj(x), approximate="tanh" if self.approximate == "tanh" else "none")


class GEGLU(nn.Module):
    """Linear to 2x width, gate with exact GELU."""

    def __init__(self, dim_in: int, dim_out: int, bias: bool = True):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2, use_bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class LinearActivation(nn.Module):
    """Linear + SiLU (SkyReels-V2's fps projection)."""

    def __init__(self, dim_in: int, dim_out: int, bias: bool = True):
        super().__init__()
        self.proj = Linear(dim_in, dim_out, use_bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.proj(x))


class FeedForward(nn.Module):
    def __init__(
        self,
        dim: int,
        dim_out: Optional[int] = None,
        mult: int = 4,
        activation_fn: str = "geglu",
        inner_dim: Optional[int] = None,
        bias: bool = True,
    ):
        super().__init__()
        inner_dim = inner_dim if inner_dim is not None else int(dim * mult)
        dim_out = dim_out if dim_out is not None else dim
        if activation_fn == "geglu":
            act = GEGLU(dim, inner_dim, bias=bias)
        elif activation_fn in ("gelu", "gelu-approximate"):
            act = GELUProj(dim, inner_dim, approximate="tanh" if activation_fn == "gelu-approximate" else "none",
                           bias=bias)
        elif activation_fn == "linear-silu":
            act = LinearActivation(dim, inner_dim, bias=bias)
        else:
            raise NotImplementedError(f"activation_fn {activation_fn!r} is not ported yet")
        # net.0 = act, net.1 = dropout slot (no-op), net.2 = out linear
        self.net = nn.ModuleList([act, nn.Identity(), Linear(inner_dim, dim_out, use_bias=bias)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn -> FF, layer_norm variant (SD/SDXL UNets)."""

    def __init__(
        self,
        dim: int,
        num_attention_heads: int,
        attention_head_dim: int,
        cross_attention_dim: Optional[int] = None,
        activation_fn: str = "geglu",
        attention_bias: bool = False,
        only_cross_attention: bool = False,
        double_self_attention: bool = False,
        norm_elementwise_affine: bool = True,
        norm_eps: float = 1e-5,
        ff_inner_dim: Optional[int] = None,
        ff_bias: bool = True,
        attention_out_bias: bool = True,
    ):
        super().__init__()
        self.only_cross_attention = only_cross_attention
        affine = norm_elementwise_affine
        self.norm1 = LayerNorm(dim, eps=norm_eps, use_scale=affine, use_bias=affine)
        self.attn1 = Attention(
            query_dim=dim,
            heads=num_attention_heads,
            dim_head=attention_head_dim,
            bias=attention_bias,
            cross_attention_dim=cross_attention_dim if only_cross_attention else None,
            out_bias=attention_out_bias,
        )
        if cross_attention_dim is not None or double_self_attention:
            self.norm2 = LayerNorm(dim, eps=norm_eps, use_scale=affine, use_bias=affine)
            self.attn2 = Attention(
                query_dim=dim,
                cross_attention_dim=cross_attention_dim if not double_self_attention else None,
                heads=num_attention_heads,
                dim_head=attention_head_dim,
                bias=attention_bias,
                out_bias=attention_out_bias,
            )
        else:
            self.norm2 = None
            self.attn2 = None
        self.norm3 = LayerNorm(dim, eps=norm_eps, use_scale=affine, use_bias=affine)
        self.ff = FeedForward(dim, activation_fn=activation_fn, inner_dim=ff_inner_dim, bias=ff_bias)

    def forward(
        self,
        hidden_states: torch.Tensor,
        encoder_hidden_states: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        encoder_attention_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        # IP-Adapter: the UNet passes (text states, [image tokens per adapter])
        ip_hidden_states = None
        if isinstance(encoder_hidden_states, tuple):
            encoder_hidden_states, ip_hidden_states = encoder_hidden_states

        # 1. self attention
        attn_output = self.attn1(
            self.norm1(hidden_states),
            encoder_hidden_states=encoder_hidden_states if self.only_cross_attention else None,
            attention_mask=attention_mask,
        )
        hidden_states = attn_output + hidden_states

        # 2. cross attention
        if self.attn2 is not None:
            attn_output = self.attn2(
                self.norm2(hidden_states),
                encoder_hidden_states=encoder_hidden_states,
                attention_mask=encoder_attention_mask,
                ip_hidden_states=ip_hidden_states,
            )
            hidden_states = attn_output + hidden_states

        # 3. feed forward
        return self.ff(self.norm3(hidden_states)) + hidden_states

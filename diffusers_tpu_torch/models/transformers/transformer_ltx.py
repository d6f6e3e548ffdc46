"""LTXVideoTransformer3DModel: Lightricks' LTX-Video rectified-flow video DiT
(2 B at LTX-Video 0.9.x's widths: 28 blocks of 32 heads x 64, T5-XXL text).

Port of `diffusers_tpu/models/transformers/transformer_ltx.py` over one
[B, S, D] token stream (frames x height x width flattened):
`LTXVideoRotaryPosEmbed` (`:52`: full-dim f32 RoPE from the video
coordinates, scaled by ``rope_interpolation_scale`` or given as
``video_coords`` in frames and pixels), `LTXAttention` (`:112-166`: RMSNorm
across the full inner dim *before* the head split, the interleaved-pair
rotation on the full channel dim), the block with its ``scale_shift_table``
(`:168-249`: a timestep of [B] or per token [B, S], so image-to-video and
the conditions give each token its own), the cross attention's mask as an
additive bias of ``-10000`` (not ``-inf``, `:344-347`), and the caches' forms
JAX's pipeline calls: the block's Pyramid Attention Broadcast gate
(`pab=(compute, cached)`), the model's first-block cache
(`fbc_state`, `fbc_config`) and PAB (`pab_compute`, `pab_cache`,
`init_pab_cache` `:437`). TextKV: `context`, the caption projection made
once by the caller, and each cross attention's `text_kv` slot
(`hooks.generic_cache.text_kv_cache`).

Attention goes through the dispatch layer: on the card both the self and
the cross attention are kernel K1 at head_dim 64, two launches a block.
Left for later: the `scan_blocks` path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...hooks.first_block_cache import fbc_single_gate
from ...ops.attention import dispatch_attention_fn
from ...ops.module import LayerNorm, Linear, RMSNorm
from ...utils import BaseOutput
from ..attention_blocks import FeedForward
from ..embeddings import PixArtAlphaTextProjection
from ..modeling_utils import ModelMixin
from .pixart_transformer_2d import AdaLayerNormSingle


@dataclass
class Transformer2DModelOutput(BaseOutput):
    sample: torch.Tensor


def cross_attention_bias(mask: torch.Tensor) -> torch.Tensor:
    """A 1 / 0 text keep-mask [B, S_txt] -> the cross attention's f32
    additive bias [B, 1, 1, S_txt]: 0 where kept, ``-10000`` on the padding
    (JAX `:344-347`)."""
    return ((1 - mask.float()) * -10000.0)[:, None, None, :]


def ltx_apply_rotary_emb(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The interleaved-pair rotation of ``x`` [B, S, D] on its full channel
    dim, ``cos`` / ``sin`` [B or 1, S, D], in f32, cast back."""
    x_f = x.float()
    x1, x2 = x_f.reshape(*x.shape[:-1], -1, 2).unbind(-1)
    x_rot = torch.stack([-x2, x1], dim=-1).reshape(x.shape)
    return (x_f * cos + x_rot * sin).to(x.dtype)


class LTXVideoRotaryPosEmbed(nn.Module):
    """3-axis (frame, height, width) RoPE over flattened video tokens."""

    def __init__(self, dim: int, base_num_frames: int = 20, base_height: int = 2048, base_width: int = 2048,
                 patch_size: int = 1, patch_size_t: int = 1, theta: float = 10000.0):
        super().__init__()
        self.dim = dim
        self.base_num_frames = base_num_frames
        self.base_height = base_height
        self.base_width = base_width
        self.patch_size = patch_size
        self.patch_size_t = patch_size_t
        self.theta = theta

    def prepare_video_coords(self, batch_size, num_frames, height, width, rope_interpolation_scale=None):
        """The scaled coordinates [B, S, 3] of a (frames, height, width) token
        grid, on the host (float32)."""
        grid = np.stack(np.meshgrid(np.arange(num_frames, dtype=np.float32), np.arange(height, dtype=np.float32),
                                    np.arange(width, dtype=np.float32), indexing="ij"), axis=0)
        grid = np.broadcast_to(grid[None], (batch_size, *grid.shape)).copy()
        if rope_interpolation_scale is not None:
            grid[:, 0] = grid[:, 0] * rope_interpolation_scale[0] * self.patch_size_t / self.base_num_frames
            grid[:, 1] = grid[:, 1] * rope_interpolation_scale[1] * self.patch_size / self.base_height
            grid[:, 2] = grid[:, 2] * rope_interpolation_scale[2] * self.patch_size / self.base_width
        return grid.reshape(batch_size, 3, -1).transpose(0, 2, 1)

    def forward(self, grid) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cos, sin) [B, S, dim] in f32 of the coordinates ``grid`` [B, S, 3]."""
        grid = torch.as_tensor(grid, dtype=torch.float32)
        n_freqs = self.dim // 6
        freqs = self.theta ** torch.linspace(math.log(1.0, self.theta) if self.theta != 1.0 else 0.0, 1.0,
                                             n_freqs, dtype=torch.float32, device=grid.device)
        freqs = freqs * math.pi / 2.0
        freqs = freqs * (grid[..., None] * 2 - 1)  # [B, S, 3, dim // 6]
        freqs = freqs.transpose(-1, -2).reshape(*grid.shape[:2], -1)
        cos, sin = freqs.cos().repeat_interleave(2, dim=-1), freqs.sin().repeat_interleave(2, dim=-1)
        pad = self.dim % 6
        if pad:
            cos = torch.cat([torch.ones_like(cos[:, :, :pad]), cos], dim=-1)
            sin = torch.cat([torch.zeros_like(sin[:, :, :pad]), sin], dim=-1)
        return cos, sin


class LTXAttention(nn.Module):
    def __init__(self, query_dim: int, heads: int = 8, kv_heads: int = 8, dim_head: int = 64, bias: bool = True,
                 cross_attention_dim: Optional[int] = None, out_bias: bool = True, eps: float = 1e-5):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        self.inner_dim = dim_head * heads
        inner_kv_dim = dim_head * kv_heads
        cross_attention_dim = cross_attention_dim if cross_attention_dim is not None else query_dim
        self.norm_q = RMSNorm(self.inner_dim, eps=eps)
        self.norm_k = RMSNorm(inner_kv_dim, eps=eps)
        self.to_q = Linear(query_dim, self.inner_dim, use_bias=bias)
        self.to_k = Linear(cross_attention_dim, inner_kv_dim, use_bias=bias)
        self.to_v = Linear(cross_attention_dim, inner_kv_dim, use_bias=bias)
        self.to_out = nn.ModuleList([Linear(self.inner_dim, query_dim, use_bias=out_bias)])
        self.text_kv = None  # TextKVCacheConfig's slot (hooks.generic_cache.text_kv_cache)

    def _context_kv(self, context: torch.Tensor):
        """(k, v) of the text tokens; under TextKV kept for each context
        tensor the module sees and reused while it is called with that same
        tensor."""
        for entry in self.text_kv or ():
            if entry[0] is context:
                return entry[1]
        kv = (self.norm_k(self.to_k(context)), self.to_v(context))
        if self.text_kv is not None:
            self.text_kv = self.text_kv + ((context, kv),)
        return kv

    def forward(self, hidden_states, encoder_hidden_states=None, attention_mask=None, image_rotary_emb=None):
        b, s, _ = hidden_states.shape
        q = self.norm_q(self.to_q(hidden_states))  # across the full inner dim, before the head split
        if encoder_hidden_states is None:
            k, v = self.norm_k(self.to_k(hidden_states)), self.to_v(hidden_states)
        else:
            k, v = self._context_kv(encoder_hidden_states)
        if image_rotary_emb is not None:
            q, k = ltx_apply_rotary_emb(q, *image_rotary_emb), ltx_apply_rotary_emb(k, *image_rotary_emb)
        out = dispatch_attention_fn(q.reshape(b, s, self.heads, self.dim_head),
                                    k.reshape(b, -1, self.heads, self.dim_head),
                                    v.reshape(b, -1, self.heads, self.dim_head), attn_mask=attention_mask)
        return self.to_out[0](out.reshape(b, s, self.inner_dim).to(q.dtype))


class LTXVideoTransformerBlock(nn.Module):
    """RMSNorm (no affine) with per-token ``scale_shift_table`` modulation,
    self attention with RoPE, plain cross attention, gated feed-forward."""

    def __init__(self, dim: int, num_attention_heads: int, attention_head_dim: int, cross_attention_dim: int,
                 activation_fn: str = "gelu-approximate", attention_bias: bool = True,
                 attention_out_bias: bool = True, eps: float = 1e-6):
        super().__init__()
        self.dim = dim
        self.norm1 = RMSNorm(dim, eps=eps, use_scale=False)
        self.attn1 = LTXAttention(query_dim=dim, heads=num_attention_heads, kv_heads=num_attention_heads,
                                  dim_head=attention_head_dim, bias=attention_bias, out_bias=attention_out_bias)
        self.norm2 = RMSNorm(dim, eps=eps, use_scale=False)
        self.attn2 = LTXAttention(query_dim=dim, cross_attention_dim=cross_attention_dim, heads=num_attention_heads,
                                  kv_heads=num_attention_heads, dim_head=attention_head_dim, bias=attention_bias,
                                  out_bias=attention_out_bias)
        self.ff = FeedForward(dim, activation_fn=activation_fn)
        self.scale_shift_table = nn.Parameter(torch.randn(6, dim) / dim**0.5)

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.scale_shift_table.normal_().div_(self.dim**0.5)

    def forward(self, hidden_states, encoder_hidden_states, temb, image_rotary_emb=None, encoder_attention_mask=None,
                pab=None):
        """`temb` [B, T, 6 D] (T = 1 or per token). `pab=(compute, cached)`:
        on a step that does not compute, `cached` stands in for the self
        attention's output, which is then returned second."""
        b = hidden_states.shape[0]
        ada = self.scale_shift_table[None, None].float() + temb.reshape(b, temb.shape[1], 6, -1).float()
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
            m.to(hidden_states.dtype) for m in ada.unbind(2))
        norm_hidden = self.norm1(hidden_states) * (1 + scale_msa) + shift_msa
        if pab is None or pab[0]:
            attn_out = self.attn1(norm_hidden, image_rotary_emb=image_rotary_emb)
        else:
            attn_out = pab[1]
        hidden_states = hidden_states + attn_out * gate_msa
        hidden_states = hidden_states + self.attn2(hidden_states, encoder_hidden_states=encoder_hidden_states,
                                                   attention_mask=encoder_attention_mask)
        norm_hidden = self.norm2(hidden_states) * (1 + scale_mlp) + shift_mlp
        hidden_states = hidden_states + self.ff(norm_hidden) * gate_mlp
        return hidden_states if pab is None else (hidden_states, attn_out)


class LTXVideoTransformer3DModel(ModelMixin, ConfigMixin):
    @register_to_config
    def __init__(
        self,
        in_channels: int = 128,
        out_channels: int = 128,
        patch_size: int = 1,
        patch_size_t: int = 1,
        num_attention_heads: int = 32,
        attention_head_dim: int = 64,
        cross_attention_dim: int = 2048,
        num_layers: int = 28,
        activation_fn: str = "gelu-approximate",
        qk_norm: str = "rms_norm_across_heads",
        norm_elementwise_affine: bool = False,
        norm_eps: float = 1e-6,
        caption_channels: int = 4096,
        attention_bias: bool = True,
        attention_out_bias: bool = True,
    ):
        super().__init__()
        self.out_channels = out_channels or in_channels
        inner_dim = num_attention_heads * attention_head_dim
        self.inner_dim = inner_dim
        self.proj_in = Linear(in_channels, inner_dim)
        self.time_embed = AdaLayerNormSingle(inner_dim)
        self.caption_projection = PixArtAlphaTextProjection(in_features=caption_channels, hidden_size=inner_dim)
        self.rope = LTXVideoRotaryPosEmbed(dim=inner_dim, base_num_frames=20, base_height=2048, base_width=2048,
                                           patch_size=patch_size, patch_size_t=patch_size_t, theta=10000.0)
        self.transformer_blocks = nn.ModuleList([
            LTXVideoTransformerBlock(dim=inner_dim, num_attention_heads=num_attention_heads,
                                     attention_head_dim=attention_head_dim, cross_attention_dim=cross_attention_dim,
                                     activation_fn=activation_fn, attention_bias=attention_bias,
                                     attention_out_bias=attention_out_bias, eps=norm_eps)
            for _ in range(num_layers)])
        self.norm_out = LayerNorm(inner_dim, eps=1e-6, use_scale=False, use_bias=False)
        self.proj_out = Linear(inner_dim, self.out_channels)
        self.scale_shift_table = nn.Parameter(torch.randn(2, inner_dim) / inner_dim**0.5)

    def rotary_emb(self, batch_size: int, num_frames: int, height: int, width: int,
                   rope_interpolation_scale=None, device=None):
        """(cos, sin) [B, S, D] of a token grid (frames, height, width) on `device`."""
        grid = self.rope.prepare_video_coords(batch_size, num_frames, height, width, rope_interpolation_scale)
        return self.rope(torch.from_numpy(grid).to(device))

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, S, in_channels] packed video latents
        encoder_hidden_states: torch.Tensor,  # [B, S_txt, caption_channels]
        timestep: torch.Tensor,  # [B] or [B, S] in train-timestep units
        encoder_attention_mask: Optional[torch.Tensor] = None,  # [B, S_txt] 1 / 0
        num_frames: Optional[int] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        rope_interpolation_scale: Optional[Tuple[float, float, float]] = None,
        video_coords: Optional[torch.Tensor] = None,  # [B, 3, S] in frames (seconds) and pixels
        image_rotary_emb: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        fbc_state=None,
        fbc_config=None,
        pab_compute: Optional[bool] = None,
        pab_cache: Optional[Dict[int, torch.Tensor]] = None,
        context: Optional[torch.Tensor] = None,
        return_dict: bool = True,
    ) -> Union[Transformer2DModelOutput, tuple]:
        """The velocity [B, S, out_channels]; with `fbc_state` the pair
        (output, new state), with `pab_cache` (output, new cache).
        `context`, when given, is `caption_projection(encoder_hidden_states)`
        made by the caller (loop-invariant: TextKVCacheConfig)."""
        batch_size, device = hidden_states.shape[0], hidden_states.device
        if image_rotary_emb is None:
            if video_coords is None:
                image_rotary_emb = self.rotary_emb(batch_size, num_frames, height, width, rope_interpolation_scale,
                                                   device)
            else:
                vc = torch.as_tensor(video_coords, dtype=torch.float32, device=device)
                grid = torch.stack([vc[:, 0] / self.rope.base_num_frames, vc[:, 1] / self.rope.base_height,
                                    vc[:, 2] / self.rope.base_width], dim=-1)
                image_rotary_emb = self.rope(grid)

        if encoder_attention_mask is not None and encoder_attention_mask.ndim == 2:
            encoder_attention_mask = cross_attention_bias(encoder_attention_mask)

        hidden_states = self.proj_in(hidden_states)
        temb, embedded_timestep = self.time_embed(timestep.reshape(-1), dtype=hidden_states.dtype)
        temb = temb.reshape(batch_size, -1, temb.shape[-1])
        embedded_timestep = embedded_timestep.reshape(batch_size, -1, embedded_timestep.shape[-1])
        if context is None:
            context = self.text_context(encoder_hidden_states)
        encoder_hidden_states = context
        args = (encoder_hidden_states, temb, image_rotary_emb, encoder_attention_mask)

        extra = None
        if fbc_state is not None:
            first_in = hidden_states
            hidden_states = self.transformer_blocks[0](hidden_states, *args)

            def tail(h):
                for block in self.transformer_blocks[1:]:
                    h = block(h, *args)
                return h

            hidden_states, extra = fbc_single_gate(fbc_state, fbc_config, hidden_states - first_in, hidden_states,
                                                   tail)
        elif pab_cache is not None:
            extra = {}
            for i, block in enumerate(self.transformer_blocks):
                hidden_states, extra[i] = block(hidden_states, *args, pab=(pab_compute, pab_cache[i]))
        else:
            for block in self.transformer_blocks:
                hidden_states = block(hidden_states, *args)

        scale_shift = self.scale_shift_table[None, None].float() + embedded_timestep[:, :, None].float()
        shift, scale = (m.to(hidden_states.dtype) for m in scale_shift.unbind(2))
        output = self.proj_out(self.norm_out(hidden_states) * (1 + scale) + shift)

        if extra is not None:
            return (output, extra) if not return_dict else (Transformer2DModelOutput(sample=output), extra)
        if not return_dict:
            return (output,)
        return Transformer2DModelOutput(sample=output)

    def text_context(self, encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        """The caption projection of the text embeddings, [B, S_txt, D]."""
        return self.caption_projection(encoder_hidden_states).reshape(encoder_hidden_states.shape[0], -1,
                                                                       self.inner_dim)

    def init_pab_cache(self, batch_size: int, tokens: int, dtype=torch.float32, device=None):
        """Zero per-block self-attention caches for PAB (step 0 always
        computes, so the zeros are never read)."""
        return {i: torch.zeros((batch_size, tokens, self.inner_dim), dtype=dtype, device=device)
                for i in range(len(self.transformer_blocks))}

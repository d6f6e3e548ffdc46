"""Timestep, text-time, pooled-text and rotary position embeddings.

Port of the SDXL- and Flux-path classes of `diffusers_tpu/models/embeddings.py`
(`get_timestep_embedding` `:21`, `Timesteps` `:45`, `TimestepEmbedding` `:66`,
`apply_rotary_emb` `:175`, `AttentionPooling` `:200`, `TextTimeEmbedding`
`:242`, `PixArtAlphaTextProjection` `:260`, `CombinedTimestepTextProjEmbeddings`
`:282`, `CombinedTimestepGuidanceTextProjEmbeddings` `:298`,
`get_1d_rotary_pos_embed_np` `:318`, `FluxPosEmbed` `:353`), and the UNet's
`encoder_hid_proj` heads `ImageProjection` `:560` and `TextImageProjection`
`:578` (the IP-Adapter base head is the same `ImageProjection`). The sinusoidal
table math runs in float32 regardless of parameter dtype; the RoPE tables are
computed on the host in float64, as in JAX (and the reference).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.module import LayerNorm, Linear, get_activation


def get_timestep_embedding(
    timesteps: torch.Tensor,
    embedding_dim: int,
    flip_sin_to_cos: bool = False,
    downscale_freq_shift: float = 1.0,
    scale: float = 1.0,
    max_period: int = 10000,
) -> torch.Tensor:
    """DDPM sinusoidal timestep embedding; `timesteps` is 1-D [N]."""
    if timesteps.ndim != 1:
        raise ValueError("timesteps should be a 1d-array")
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(half_dim, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = torch.exp(exponent)
    emb = timesteps[:, None].float() * emb[None, :]
    emb = scale * emb
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class Timesteps(nn.Module):
    def __init__(self, num_channels: int, flip_sin_to_cos: bool, downscale_freq_shift: float, scale: int = 1):
        super().__init__()
        self.num_channels = num_channels
        self.flip_sin_to_cos = flip_sin_to_cos
        self.downscale_freq_shift = downscale_freq_shift
        self.scale = scale

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        return get_timestep_embedding(
            timesteps,
            self.num_channels,
            flip_sin_to_cos=self.flip_sin_to_cos,
            downscale_freq_shift=self.downscale_freq_shift,
            scale=self.scale,
        )


class TimestepEmbedding(nn.Module):
    """2-layer MLP over the sinusoidal embedding."""

    def __init__(
        self,
        in_channels: int,
        time_embed_dim: int,
        act_fn: str = "silu",
        out_dim: Optional[int] = None,
        post_act_fn: Optional[str] = None,
        cond_proj_dim: Optional[int] = None,
        sample_proj_bias: bool = True,
    ):
        super().__init__()
        self.linear_1 = Linear(in_channels, time_embed_dim, use_bias=sample_proj_bias)
        self.cond_proj = Linear(cond_proj_dim, in_channels, use_bias=False) if cond_proj_dim is not None else None
        self.act = get_activation(act_fn)
        self.linear_2 = Linear(time_embed_dim, out_dim or time_embed_dim, use_bias=sample_proj_bias)
        self.post_act = get_activation(post_act_fn) if post_act_fn is not None else None

    def forward(self, sample: torch.Tensor, condition: Optional[torch.Tensor] = None) -> torch.Tensor:
        if condition is not None:
            sample = sample + self.cond_proj(condition)
        sample = self.linear_1(sample)
        sample = self.act(sample)
        sample = self.linear_2(sample)
        if self.post_act is not None:
            sample = self.post_act(sample)
        return sample


class AttentionPooling(nn.Module):
    """Attention pooling over token states: class token = mean + learned
    positional embedding; single-query attention over [class, tokens]."""

    def __init__(self, num_heads: int, embed_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.embed_dim = embed_dim
        self.dim_per_head = embed_dim // num_heads
        self.positional_embedding = nn.Parameter(torch.randn(1, embed_dim) / embed_dim**0.5)
        self.k_proj = Linear(embed_dim, embed_dim)
        self.q_proj = Linear(embed_dim, embed_dim)
        self.v_proj = Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bs, length, width = x.shape

        def shape(t):
            return t.reshape(bs, -1, self.num_heads, self.dim_per_head).transpose(1, 2)

        class_token = x.mean(dim=1, keepdim=True) + self.positional_embedding.to(x.dtype)
        x = torch.cat([class_token, x], dim=1)
        q = shape(self.q_proj(class_token))
        k = shape(self.k_proj(x))
        v = shape(self.v_proj(x))
        scale = 1 / math.sqrt(math.sqrt(self.dim_per_head))
        weight = torch.einsum("bhqd,bhkd->bhqk", q * scale, k * scale)
        weight = torch.softmax(weight.float(), dim=-1).to(v.dtype)
        a = torch.einsum("bhqk,bhkd->bhqd", weight, v)
        return a.transpose(1, 2).reshape(bs, width)


class TextTimeEmbedding(nn.Module):
    """LN -> attention-pool -> proj -> LN (the `addition_embed_type="text"`
    aug embedding)."""

    def __init__(self, encoder_dim: int, time_embed_dim: int, num_heads: int = 64):
        super().__init__()
        self.norm1 = LayerNorm(encoder_dim)
        self.pool = AttentionPooling(num_heads, encoder_dim)
        self.proj = Linear(encoder_dim, time_embed_dim)
        self.norm2 = LayerNorm(time_embed_dim)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        hidden_states = self.norm1(hidden_states)
        hidden_states = self.pool(hidden_states)
        hidden_states = self.proj(hidden_states)
        return self.norm2(hidden_states)


class ImageProjection(nn.Module):
    """Image embed -> `num_image_text_embeds` cross-attention tokens: one
    Linear, then LayerNorm over each token (Kandinsky 2.2's
    ``encoder_hid_dim_type="image_proj"``, IP-Adapter's base head)."""

    def __init__(self, image_embed_dim: int = 768, cross_attention_dim: int = 768, num_image_text_embeds: int = 32):
        super().__init__()
        self.num_image_text_embeds = num_image_text_embeds
        self.image_embeds = Linear(image_embed_dim, num_image_text_embeds * cross_attention_dim)
        self.norm = LayerNorm(cross_attention_dim)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        x = self.image_embeds(image_embeds)
        return self.norm(x.reshape(image_embeds.shape[0], self.num_image_text_embeds, -1))


class TextImageProjection(nn.Module):
    """Text + image embeds -> joint cross-attention tokens, the image's first
    (Kandinsky 2.1's ``encoder_hid_dim_type="text_image_proj"``)."""

    def __init__(self, text_embed_dim: int = 1024, image_embed_dim: int = 768, cross_attention_dim: int = 768,
                 num_image_text_embeds: int = 10):
        super().__init__()
        self.num_image_text_embeds = num_image_text_embeds
        self.image_embeds = Linear(image_embed_dim, num_image_text_embeds * cross_attention_dim)
        self.text_proj = Linear(text_embed_dim, cross_attention_dim)

    def forward(self, text_embeds: torch.Tensor, image_embeds: torch.Tensor) -> torch.Tensor:
        image_text = self.image_embeds(image_embeds).reshape(text_embeds.shape[0], self.num_image_text_embeds, -1)
        return torch.cat([image_text, self.text_proj(text_embeds)], dim=1)


def apply_rotary_emb(x: torch.Tensor, freqs_cos: torch.Tensor, freqs_sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs of x ([B, S, H, D] with freqs [S, D], or any
    x whose trailing axes the freqs broadcast against). bf16 inputs rotate in
    bf16, as in JAX (the result feeds the bf16 attention kernel); f32 stays
    f32."""
    dt = torch.float32 if x.dtype == torch.float32 else x.dtype
    x_f = x.to(dt)
    x1, x2 = x_f.reshape(*x.shape[:-1], -1, 2).unbind(-1)
    x_rot = torch.stack([-x2, x1], dim=-1).reshape(x.shape)
    if x.ndim == 4 and freqs_cos.ndim == 2:  # x: [B, S, H, D], freqs: [S, D]
        freqs_cos, freqs_sin = freqs_cos[None, :, None, :], freqs_sin[None, :, None, :]
    else:
        while freqs_cos.ndim < x.ndim:
            freqs_cos, freqs_sin = freqs_cos[None], freqs_sin[None]
    out = x_f * freqs_cos.to(dt) + x_rot * freqs_sin.to(dt)
    return out.to(x.dtype)


class PixArtAlphaTextProjection(nn.Module):
    """Pooled-text MLP projection: linear_1 -> activation -> linear_2."""

    def __init__(self, in_features: int, hidden_size: int, out_features: Optional[int] = None,
                 act_fn: str = "gelu_tanh"):
        super().__init__()
        if act_fn not in ("gelu_tanh", "silu", "silu_fp32"):
            raise ValueError(f"unknown activation {act_fn}")
        self.linear_1 = Linear(in_features, hidden_size, use_bias=True)
        self.act_fn = act_fn
        self.linear_2 = Linear(hidden_size, out_features or hidden_size, use_bias=True)

    def forward(self, caption: torch.Tensor) -> torch.Tensor:
        x = self.linear_1(caption)
        if self.act_fn == "gelu_tanh":
            x = F.gelu(x, approximate="tanh")
        elif self.act_fn == "silu":
            x = F.silu(x)
        else:
            x = F.silu(x.float()).to(x.dtype)
        return self.linear_2(x)


class CombinedTimestepTextProjEmbeddings(nn.Module):
    """Timestep-sinusoid MLP + pooled-text MLP, summed (the SD3/Flux temb)."""

    def __init__(self, embedding_dim: int, pooled_projection_dim: int):
        super().__init__()
        self.time_proj = Timesteps(num_channels=256, flip_sin_to_cos=True, downscale_freq_shift=0)
        self.timestep_embedder = TimestepEmbedding(in_channels=256, time_embed_dim=embedding_dim)
        self.text_embedder = PixArtAlphaTextProjection(pooled_projection_dim, embedding_dim, act_fn="silu")

    def forward(self, timestep: torch.Tensor, pooled_projection: torch.Tensor) -> torch.Tensor:
        t_emb = self.timestep_embedder(self.time_proj(timestep).to(pooled_projection.dtype))
        return t_emb + self.text_embedder(pooled_projection)


class CombinedTimestepGuidanceTextProjEmbeddings(nn.Module):
    """The guidance-distilled (Flux-dev) variant: + a guidance embedding."""

    def __init__(self, embedding_dim: int, pooled_projection_dim: int):
        super().__init__()
        self.time_proj = Timesteps(num_channels=256, flip_sin_to_cos=True, downscale_freq_shift=0)
        self.timestep_embedder = TimestepEmbedding(in_channels=256, time_embed_dim=embedding_dim)
        self.guidance_embedder = TimestepEmbedding(in_channels=256, time_embed_dim=embedding_dim)
        self.text_embedder = PixArtAlphaTextProjection(pooled_projection_dim, embedding_dim, act_fn="silu")

    def forward(self, timestep: torch.Tensor, guidance: torch.Tensor, pooled_projection: torch.Tensor) -> torch.Tensor:
        t_emb = self.timestep_embedder(self.time_proj(timestep).to(pooled_projection.dtype))
        g_emb = self.guidance_embedder(self.time_proj(guidance).to(pooled_projection.dtype))
        return t_emb + g_emb + self.text_embedder(pooled_projection)


def get_1d_rotary_pos_embed_np(
    dim: int,
    pos: np.ndarray,
    theta: float = 10000.0,
    repeat_interleave_real: bool = True,
    freqs_dtype=np.float64,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side (numpy, float64) 1D RoPE table, cast to float32: cos and sin
    [S, dim], each frequency repeated for its pair."""
    assert dim % 2 == 0
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=freqs_dtype) / dim))
    freqs = np.outer(np.asarray(pos, dtype=freqs_dtype), freqs)  # [S, D/2]
    if repeat_interleave_real:
        cos = np.repeat(np.cos(freqs), 2, axis=1).astype(np.float32)
        sin = np.repeat(np.sin(freqs), 2, axis=1).astype(np.float32)
    else:
        cos = np.concatenate([np.cos(freqs), np.cos(freqs)], axis=-1).astype(np.float32)
        sin = np.concatenate([np.sin(freqs), np.sin(freqs)], axis=-1).astype(np.float32)
    return cos, sin


class FluxPosEmbed(nn.Module):
    """Multi-axis RoPE over packed (text + image) position ids [S, n_axes]:
    one float64 host table per axis, concatenated. Returns float32 (cos, sin)
    [S, sum(axes_dim)] on the ids' device (the CPU for numpy ids)."""

    def __init__(self, theta: int, axes_dim: Sequence[int]):
        super().__init__()
        self.theta = theta
        self.axes_dim = list(axes_dim)

    def forward(self, ids: Union[np.ndarray, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        device = ids.device if isinstance(ids, torch.Tensor) else torch.device("cpu")
        ids = ids.detach().cpu().numpy() if isinstance(ids, torch.Tensor) else np.asarray(ids)
        tables = [get_1d_rotary_pos_embed_np(self.axes_dim[i], ids[:, i], theta=self.theta)
                  for i in range(ids.shape[-1])]
        cos = np.concatenate([c for c, _ in tables], axis=-1)
        sin = np.concatenate([s for _, s in tables], axis=-1)
        return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def get_2d_sincos_pos_embed(
    embed_dim: int,
    grid_size: Union[int, Tuple[int, int]],
    base_size: int = 16,
    interpolation_scale: float = 1.0,
    crop: Optional[Tuple[int, int, int, int]] = None,
) -> np.ndarray:
    """Fixed 2D sin-cos position table [N, embed_dim] float32 over a grid of
    `grid_size` (JAX `get_2d_sincos_pos_embed`), or over the window `crop` =
    (top, left, h, w) of that grid only: the rows of the full table for those
    positions, row-major, bit for bit (each element is one float64 product,
    its sin or cos, and one cast to float32). Position (i, j) holds the
    column's code (grid_w[j]) in its first half and the row's (grid_h[i]) in
    its second, as JAX's table does."""
    gh, gw = grid_size if isinstance(grid_size, tuple) else (grid_size, grid_size)
    top, left, h, w = crop if crop is not None else (0, 0, gh, gw)
    if top < 0 or left < 0 or top + h > gh or left + w > gw:
        raise ValueError(f"crop {(top, left, h, w)} does not fit in the {gh} x {gw} position grid")
    grid_h = np.arange(top, top + h, dtype=np.float32) / (gh / base_size) / interpolation_scale
    grid_w = np.arange(left, left + w, dtype=np.float32) / (gw / base_size) / interpolation_scale

    def _1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000**omega
        out = pos.astype(np.float64)[:, None] * omega[None, :]
        return np.concatenate([np.sin(out), np.cos(out)], axis=1).astype(np.float32)

    half = embed_dim // 2
    cols, rows = _1d(half, grid_w), _1d(half, grid_h)  # [w, half], [h, half]
    table = np.concatenate([np.broadcast_to(cols[None], (h, w, half)), np.broadcast_to(rows[:, None], (h, w, half))],
                           axis=-1)
    return table.reshape(h * w, 2 * half)


class PatchEmbed(nn.Module):
    """Image -> patch tokens plus the SD3-style cropped sin-cos position
    table (JAX `PatchEmbed` with its SD3 settings: sin-cos positions, no
    LayerNorm). JAX builds the whole `pos_embed_max_size`² table at init
    (384² x 1536 for SD3.5 Medium, 0.9 GB) to crop the centre of it; the
    port computes only the crop a call needs (`get_2d_sincos_pos_embed` with
    `crop`), the same values, and keeps it in a per-shape cache on the
    call's device and dtype: no parameter and no state-dict entry. With
    ``pos_embed_type=None`` (the SD3 ControlNet's conditioning embed) the
    tokens get no positions."""

    def __init__(
        self,
        height: int = 224,
        width: int = 224,
        patch_size: int = 16,
        in_channels: int = 3,
        embed_dim: int = 768,
        bias: bool = True,
        interpolation_scale: float = 1,
        pos_embed_max_size: Optional[int] = None,
        pos_embed_type: Optional[str] = "sincos",
    ):
        super().__init__()
        if pos_embed_type not in ("sincos", None):
            raise ValueError(f"unsupported pos_embed_type {pos_embed_type}")
        self.pos_embed_type = pos_embed_type
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.pos_embed_max_size = pos_embed_max_size
        self.height, self.width = height // patch_size, width // patch_size
        self.base_size = height // patch_size
        self.interpolation_scale = interpolation_scale
        self.proj = nn.Conv2d(in_channels, embed_dim, kernel_size=patch_size, stride=patch_size, bias=bias)
        self._pos_cache = {}

    def pos_table(self, h: int, w: int) -> np.ndarray:
        """The position rows [h * w, D] of an h x w patch grid: the centre crop
        of the `pos_embed_max_size`² table (JAX `cropped_pos_embed`), or the
        whole table of the configured grid when there is no maximum."""
        m = self.pos_embed_max_size
        if m is None:
            size = int((self.height * self.width) ** 0.5)
            return get_2d_sincos_pos_embed(self.embed_dim, size, self.base_size, self.interpolation_scale)
        if h > m or w > m:
            raise ValueError(f"a {h} x {w} patch grid exceeds pos_embed_max_size {m}")
        return get_2d_sincos_pos_embed(self.embed_dim, m, self.base_size, self.interpolation_scale,
                                       crop=((m - h) // 2, (m - w) // 2, h, w))

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        """latent [B, C, H, W] -> tokens [B, (H / p) (W / p), D]."""
        x = self.proj(latent).flatten(2).transpose(1, 2)
        if self.pos_embed_type is None:
            return x
        h, w = latent.shape[-2] // self.patch_size, latent.shape[-1] // self.patch_size
        key = (h, w, x.device, x.dtype)
        if key not in self._pos_cache:
            self._pos_cache[key] = torch.from_numpy(self.pos_table(h, w)).to(device=x.device, dtype=x.dtype)
        return x + self._pos_cache[key]

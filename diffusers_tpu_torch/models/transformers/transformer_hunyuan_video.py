"""HunyuanVideoTransformer3DModel: HunyuanVideo's dual- and single-stream
video DiT (13 B at the published widths: 20 dual and 40 single blocks of 24
heads x 128, 2 token-refiner layers, 3,072 wide).

Port of `diffusers_tpu/models/transformers/transformer_hunyuan_video.py` with
upstream diffusers' state-dict names:

* `HunyuanVideoAttention` (`:48`): the joint attention with the image tokens
  first and the text appended; per-head RMSNorms on q/k (and on the added
  text q/k of a dual block); RoPE on the image tokens only (`:97-104`); the
  single-stream form projects the already-joined sequence (`:87-89`) and
  returns both parts unprojected (`pre_only`, `:119-125`);
* `HunyuanVideoAdaNorm` and `HunyuanVideoConditionEmbedding` (`:131`,
  `:142`), with the distilled-guidance embedder and, for
  ``image_condition_type="token_replace"``, `token_replace_emb` (the
  embedding of timestep 0);
* the token refiner (`:171-242`): the masked mean pool of the raw text
  (`:233-238`) feeds its timestep embedding; its self attention runs under
  the 2-D keep mask ``m_q & m_k`` with column 0 forced on (`:207-212`), so a
  padded query (even a padded first token) still sees key 0;
* the dual block (`:326`) and the single block (`:245`), each with the
  first frame's tokens modulated by `token_replace_emb`
  (`_token_replace_norm_single` `:293`, `_token_replace_norm_zero` `:306`);
* the `Conv3d` patch embed (`:400`) and the RoPE tables of the token grid
  (`rope`, `:464`), made on the host in f64 and kept a shape on the
  model's device;
* the validity of the joined sequence (`:509-516`): every image key and the
  first ``sum(mask)`` text keys. It reaches the attention as an f32
  ``[B, 1, 1, N]`` key-padding bias, ``-inf`` on the dropped keys, which
  kernel K1 reads through its broadcast strides (as Qwen-Image's does).

On the card every joint attention is K1 at head_dim 128 (60 launches a call
at full depth) and the refiner's two self attentions are K1 under their
2-D mask. TextKV (`text_context`): the refiner's input projection, its pool
and its first layer's attention do not depend on the timestep, so a request
makes them once and every step reuses them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...ops.attention import dispatch_attention_fn
from ...ops.module import Conv3d, LayerNorm, Linear, RMSNorm
from ...utils import BaseOutput
from ..attention import Attention
from ..attention_blocks import FeedForward
from ..embeddings import (
    CombinedTimestepTextProjEmbeddings,
    PixArtAlphaTextProjection,
    TimestepEmbedding,
    Timesteps,
    apply_rotary_emb,
    get_1d_rotary_pos_embed_np,
)
from ..modeling_utils import ModelMixin
from ..normalization import AdaLayerNormContinuous, AdaLayerNormZero, AdaLayerNormZeroSingle


@dataclass
class Transformer2DModelOutput(BaseOutput):
    sample: torch.Tensor


class HunyuanVideoAttention(nn.Module):
    """Joint attention, image tokens first (JAX `:48-128`)."""

    def __init__(self, query_dim: int, heads: int, dim_head: int, added_kv_proj_dim: Optional[int] = None,
                 qk_norm: str = "rms_norm", eps: float = 1e-6, pre_only: bool = False):
        super().__init__()
        if qk_norm != "rms_norm":
            raise ValueError(f"unsupported qk_norm {qk_norm}")
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.added_kv_proj_dim, self.pre_only = added_kv_proj_dim, pre_only
        self.to_q = Linear(query_dim, inner)
        self.to_k = Linear(query_dim, inner)
        self.to_v = Linear(query_dim, inner)
        self.norm_q = RMSNorm(dim_head, eps=eps)
        self.norm_k = RMSNorm(dim_head, eps=eps)
        if added_kv_proj_dim is not None:
            self.add_q_proj = Linear(added_kv_proj_dim, inner)
            self.add_k_proj = Linear(added_kv_proj_dim, inner)
            self.add_v_proj = Linear(added_kv_proj_dim, inner)
            self.norm_added_q = RMSNorm(dim_head, eps=eps)
            self.norm_added_k = RMSNorm(dim_head, eps=eps)
            self.to_add_out = Linear(inner, added_kv_proj_dim)
        if not pre_only:
            self.to_out = nn.ModuleList([Linear(inner, query_dim)])

    def forward(self, hidden_states, encoder_hidden_states, attn_bias=None, image_rotary_emb=None):
        """(image out, text out). `attn_bias`: the f32 [B, 1, 1, S_img + S_txt]
        key-padding bias, or None."""
        b, img_len, txt_len = hidden_states.shape[0], hidden_states.shape[1], encoder_hidden_states.shape[1]
        single = self.added_kv_proj_dim is None
        if single:
            hidden_states = torch.cat([hidden_states, encoder_hidden_states], dim=1)

        def heads(t):
            return t.reshape(b, -1, self.heads, self.dim_head)

        q = self.norm_q(heads(self.to_q(hidden_states)))
        k = self.norm_k(heads(self.to_k(hidden_states)))
        v = heads(self.to_v(hidden_states))
        if image_rotary_emb is not None:
            cos, sin = image_rotary_emb
            if single:
                q = torch.cat([apply_rotary_emb(q[:, :img_len], cos, sin), q[:, img_len:]], dim=1)
                k = torch.cat([apply_rotary_emb(k[:, :img_len], cos, sin), k[:, img_len:]], dim=1)
            else:
                q, k = apply_rotary_emb(q, cos, sin), apply_rotary_emb(k, cos, sin)
        if not single:
            q = torch.cat([q, self.norm_added_q(heads(self.add_q_proj(encoder_hidden_states)))], dim=1)
            k = torch.cat([k, self.norm_added_k(heads(self.add_k_proj(encoder_hidden_states)))], dim=1)
            v = torch.cat([v, heads(self.add_v_proj(encoder_hidden_states))], dim=1)
        out = dispatch_attention_fn(q, k, v, attn_mask=attn_bias)
        out = out.reshape(b, -1, self.heads * self.dim_head).to(q.dtype)
        sample, context = out[:, :-txt_len], out[:, -txt_len:]
        if not self.pre_only:
            sample = self.to_out[0](sample)
        if not single:
            context = self.to_add_out(context)
        return sample, context


class HunyuanVideoAdaNorm(nn.Module):
    def __init__(self, in_features: int, out_features: Optional[int] = None):
        super().__init__()
        self.linear = Linear(in_features, out_features or 2 * in_features)

    def forward(self, temb: torch.Tensor):
        gate_msa, gate_mlp = self.linear(F.silu(temb)).chunk(2, dim=1)
        return gate_msa[:, None], gate_mlp[:, None]


class HunyuanVideoConditionEmbedding(nn.Module):
    """Timestep + pooled text (+ distilled guidance) embedding; with
    ``token_replace`` also the first frame's embedding at timestep 0."""

    def __init__(self, embedding_dim: int, pooled_projection_dim: int, guidance_embeds: bool,
                 image_condition_type: Optional[str] = None):
        super().__init__()
        self.image_condition_type = image_condition_type
        self.time_proj = Timesteps(num_channels=256, flip_sin_to_cos=True, downscale_freq_shift=0)
        self.timestep_embedder = TimestepEmbedding(in_channels=256, time_embed_dim=embedding_dim)
        self.text_embedder = PixArtAlphaTextProjection(pooled_projection_dim, embedding_dim, act_fn="silu")
        self.guidance_embedder = (TimestepEmbedding(in_channels=256, time_embed_dim=embedding_dim)
                                  if guidance_embeds else None)

    def forward(self, timestep, pooled_projection, guidance=None):
        dtype = pooled_projection.dtype
        t_emb = self.timestep_embedder(self.time_proj(timestep).to(dtype))
        pooled = self.text_embedder(pooled_projection)
        token_replace_emb = None
        if self.image_condition_type == "token_replace":
            tr = self.time_proj(torch.zeros_like(timestep)).to(dtype)
            token_replace_emb = self.timestep_embedder(tr) + pooled
        if self.guidance_embedder is not None:
            g_emb = self.guidance_embedder(self.time_proj(guidance).to(dtype))
            return t_emb + g_emb + pooled, token_replace_emb
        return t_emb + pooled, token_replace_emb


class HunyuanVideoIndividualTokenRefinerBlock(nn.Module):
    def __init__(self, num_attention_heads: int, attention_head_dim: int, mlp_width_ratio: float = 4.0,
                 attention_bias: bool = True):
        super().__init__()
        hidden_size = num_attention_heads * attention_head_dim
        self.norm1 = LayerNorm(hidden_size, eps=1e-6)
        self.attn = Attention(query_dim=hidden_size, heads=num_attention_heads, dim_head=attention_head_dim,
                              bias=attention_bias)
        self.norm2 = LayerNorm(hidden_size, eps=1e-6)
        self.ff = FeedForward(hidden_size, mult=mlp_width_ratio, activation_fn="linear-silu")
        self.norm_out = HunyuanVideoAdaNorm(hidden_size, 2 * hidden_size)

    def self_attention(self, hidden_states, attention_mask=None):
        return self.attn(self.norm1(hidden_states), attention_mask=attention_mask)

    def forward(self, hidden_states, temb, attention_mask=None, attn_output=None):
        """`attn_output`, when given, is `self_attention(hidden_states, mask)`
        made earlier (TextKV)."""
        if attn_output is None:
            attn_output = self.self_attention(hidden_states, attention_mask)
        gate_msa, gate_mlp = self.norm_out(temb)
        hidden_states = hidden_states + attn_output * gate_msa
        return hidden_states + self.ff(self.norm2(hidden_states)) * gate_mlp


class HunyuanVideoIndividualTokenRefiner(nn.Module):
    def __init__(self, num_attention_heads: int, attention_head_dim: int, num_layers: int,
                 mlp_width_ratio: float = 4.0, attention_bias: bool = True):
        super().__init__()
        self.refiner_blocks = nn.ModuleList([
            HunyuanVideoIndividualTokenRefinerBlock(num_attention_heads, attention_head_dim,
                                                    mlp_width_ratio=mlp_width_ratio, attention_bias=attention_bias)
            for _ in range(num_layers)])

    def forward(self, hidden_states, temb, attention_mask=None, first_attn=None):
        mask = refiner_mask(attention_mask)
        for i, block in enumerate(self.refiner_blocks):
            hidden_states = block(hidden_states, temb, mask, first_attn if i == 0 else None)
        return hidden_states


def refiner_mask(attention_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The refiner's bool [B, 1, S, S] keep mask ``m_q & m_k`` with column 0
    set (JAX `:207-212`), or None."""
    if attention_mask is None:
        return None
    m = attention_mask.bool()
    mask = m[:, None, :, None] & m[:, None, None, :]
    mask[:, :, :, 0] = True
    return mask


@dataclass
class HunyuanTextContext:
    """The timestep-independent half of the token refiner (TextKV): its
    input projection, the pooled text its timestep embedding reads, and its
    first layer's self attention."""

    pooled: torch.Tensor
    projected: torch.Tensor
    first_attn: Optional[torch.Tensor]


class HunyuanVideoTokenRefiner(nn.Module):
    def __init__(self, in_channels: int, num_attention_heads: int, attention_head_dim: int, num_layers: int,
                 mlp_ratio: float = 4.0, attention_bias: bool = True):
        super().__init__()
        hidden_size = num_attention_heads * attention_head_dim
        self.time_text_embed = CombinedTimestepTextProjEmbeddings(embedding_dim=hidden_size,
                                                                  pooled_projection_dim=in_channels)
        self.proj_in = Linear(in_channels, hidden_size)
        self.token_refiner = HunyuanVideoIndividualTokenRefiner(num_attention_heads, attention_head_dim, num_layers,
                                                                mlp_width_ratio=mlp_ratio,
                                                                attention_bias=attention_bias)

    def text_context(self, hidden_states, attention_mask=None) -> HunyuanTextContext:
        if attention_mask is None:
            pooled = hidden_states.mean(dim=1)
        else:
            mask = attention_mask.float()[..., None]
            pooled = ((hidden_states.float() * mask).sum(dim=1) / mask.sum(dim=1)).to(hidden_states.dtype)
        projected = self.proj_in(hidden_states)
        blocks = self.token_refiner.refiner_blocks
        first = blocks[0].self_attention(projected, refiner_mask(attention_mask)) if len(blocks) else None
        return HunyuanTextContext(pooled, projected, first)

    def forward(self, hidden_states, timestep, attention_mask=None, context: Optional[HunyuanTextContext] = None):
        if context is None:
            context = self.text_context(hidden_states, attention_mask)
        temb = self.time_text_embed(timestep, context.pooled)
        return self.token_refiner(context.projected, temb, attention_mask, first_attn=context.first_attn)


def _modulate(normed, shift, scale):
    return normed * (1 + scale[:, None]) + shift[:, None]


def _split_frames(first_fn, rest_fn, x, n_first):
    """``cat([first_fn(x[:, :n]), rest_fn(x[:, n:])])`` over the token axis."""
    return torch.cat([first_fn(x[:, :n_first]), rest_fn(x[:, n_first:])], dim=1)


class HunyuanVideoSingleTransformerBlock(nn.Module):
    def __init__(self, num_attention_heads: int, attention_head_dim: int, mlp_ratio: float = 4.0,
                 qk_norm: str = "rms_norm"):
        super().__init__()
        hidden_size = num_attention_heads * attention_head_dim
        self.mlp_dim = int(hidden_size * mlp_ratio)
        self.attn = HunyuanVideoAttention(hidden_size, num_attention_heads, attention_head_dim, qk_norm=qk_norm,
                                          pre_only=True)
        self.norm = AdaLayerNormZeroSingle(hidden_size)
        self.proj_mlp = Linear(hidden_size, self.mlp_dim)
        self.proj_out = Linear(hidden_size + self.mlp_dim, hidden_size)

    def forward(self, hidden_states, encoder_hidden_states, temb, attn_bias=None, image_rotary_emb=None,
                token_replace_emb=None, first_frame_num_tokens: int = 0):
        text_len = encoder_hidden_states.shape[1]
        hidden_states = torch.cat([hidden_states, encoder_hidden_states], dim=1)
        residual = hidden_states
        if token_replace_emb is None:
            norm_hidden, gate = self.norm(hidden_states, emb=temb)
        else:  # JAX `_token_replace_norm_single` (`:293`)
            shift, scale, gate = self.norm.linear(F.silu(temb)).chunk(3, dim=-1)
            tr_shift, tr_scale, tr_gate = self.norm.linear(F.silu(token_replace_emb)).chunk(3, dim=-1)
            norm_hidden = _split_frames(lambda x: _modulate(x, tr_shift, tr_scale),
                                        lambda x: _modulate(x, shift, scale), self.norm.norm(hidden_states),
                                        first_frame_num_tokens)
        mlp_hidden = F.gelu(self.proj_mlp(norm_hidden), approximate="tanh")
        attn_out, ctx_out = self.attn(norm_hidden[:, :-text_len], norm_hidden[:, -text_len:], attn_bias,
                                      image_rotary_emb)
        proj = self.proj_out(torch.cat([torch.cat([attn_out, ctx_out], dim=1), mlp_hidden], dim=2))
        if token_replace_emb is None:
            hidden_states = gate[:, None] * proj
        else:
            hidden_states = _split_frames(lambda x: tr_gate[:, None] * x, lambda x: gate[:, None] * x, proj,
                                          first_frame_num_tokens)
        hidden_states = hidden_states + residual
        return hidden_states[:, :-text_len], hidden_states[:, -text_len:]


class HunyuanVideoTransformerBlock(nn.Module):
    def __init__(self, num_attention_heads: int, attention_head_dim: int, mlp_ratio: float,
                 qk_norm: str = "rms_norm"):
        super().__init__()
        hidden_size = num_attention_heads * attention_head_dim
        self.norm1 = AdaLayerNormZero(hidden_size)
        self.norm1_context = AdaLayerNormZero(hidden_size)
        self.attn = HunyuanVideoAttention(hidden_size, num_attention_heads, attention_head_dim,
                                          added_kv_proj_dim=hidden_size, qk_norm=qk_norm)
        self.norm2 = LayerNorm(hidden_size, eps=1e-6, use_scale=False, use_bias=False)
        self.ff = FeedForward(hidden_size, mult=mlp_ratio, activation_fn="gelu-approximate")
        self.norm2_context = LayerNorm(hidden_size, eps=1e-6, use_scale=False, use_bias=False)
        self.ff_context = FeedForward(hidden_size, mult=mlp_ratio, activation_fn="gelu-approximate")

    def forward(self, hidden_states, encoder_hidden_states, temb, attn_bias=None, image_rotary_emb=None,
                token_replace_emb=None, first_frame_num_tokens: int = 0):
        n = first_frame_num_tokens
        if token_replace_emb is None:
            norm_hidden, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.norm1(hidden_states, emb=temb)
        else:  # JAX `_token_replace_norm_zero` (`:306`)
            shift, scale, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.norm1.linear(F.silu(temb)).chunk(6, dim=-1)
            tr = self.norm1.linear(F.silu(token_replace_emb)).chunk(6, dim=-1)
            norm_hidden = _split_frames(lambda x: _modulate(x, tr[0], tr[1]), lambda x: _modulate(x, shift, scale),
                                        self.norm1.norm(hidden_states), n)
        norm_context, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = self.norm1_context(encoder_hidden_states,
                                                                                             emb=temb)
        attn_output, context_attn_output = self.attn(norm_hidden, norm_context, attn_bias, image_rotary_emb)

        if token_replace_emb is None:
            hidden_states = hidden_states + attn_output * gate_msa[:, None]
        else:
            hidden_states = hidden_states + _split_frames(lambda x: tr[2][:, None] * x,
                                                          lambda x: gate_msa[:, None] * x, attn_output, n)
        encoder_hidden_states = encoder_hidden_states + context_attn_output * c_gate_msa[:, None]

        norm_hidden = self.norm2(hidden_states)
        if token_replace_emb is None:
            norm_hidden = _modulate(norm_hidden, shift_mlp, scale_mlp)
        else:
            norm_hidden = _split_frames(lambda x: _modulate(x, tr[3], tr[4]),
                                        lambda x: _modulate(x, shift_mlp, scale_mlp), norm_hidden, n)
        norm_context = _modulate(self.norm2_context(encoder_hidden_states), c_shift_mlp, c_scale_mlp)

        ff_output = self.ff(norm_hidden)
        if token_replace_emb is None:
            hidden_states = hidden_states + gate_mlp[:, None] * ff_output
        else:
            hidden_states = hidden_states + _split_frames(lambda x: tr[5][:, None] * x,
                                                          lambda x: gate_mlp[:, None] * x, ff_output, n)
        encoder_hidden_states = encoder_hidden_states + c_gate_mlp[:, None] * self.ff_context(norm_context)
        return hidden_states, encoder_hidden_states


class HunyuanVideoPatchEmbed(nn.Module):
    """NCDHW latents -> [B, F' H' W', C] tokens through one strided `Conv3d`."""

    def __init__(self, patch_size: Tuple[int, int, int], in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = Conv3d(in_chans, embed_dim, kernel_size=patch_size, stride=patch_size)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        return self.proj(hidden_states).flatten(2).transpose(1, 2)


def validity_bias(mask: torch.Tensor, img_len: int) -> torch.Tensor:
    """The joined sequence's f32 [B, 1, 1, S_img + S_txt] key bias: 0 on every
    image key and on the first ``sum(mask)`` text keys, ``-inf`` after them
    (JAX `:509-516`)."""
    total = img_len + mask.shape[1]
    eff = img_len + mask.long().sum(dim=1)
    keep = torch.arange(total, device=mask.device)[None, :] < eff[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(keep, zero, -math.inf)[:, None, None, :]


def rope_tables(axes_dim, theta: float, frame_indices, height: int, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """f32 (cos, sin) [F H W, sum(axes_dim)] over the (frame, row, column)
    grid, frames at `frame_indices` (JAX `rope` `:464`)."""
    grid = np.stack(np.meshgrid(np.asarray(frame_indices, np.float32), np.arange(height, dtype=np.float32),
                                np.arange(width, dtype=np.float32), indexing="ij"), axis=0)
    tables = [get_1d_rotary_pos_embed_np(axes_dim[i], grid[i].reshape(-1), theta=theta) for i in range(3)]
    return np.concatenate([c for c, _ in tables], axis=-1), np.concatenate([s for _, s in tables], axis=-1)


class HunyuanVideoTransformer3DModel(ModelMixin, ConfigMixin):
    @register_to_config
    def __init__(
        self,
        in_channels: int = 16,
        out_channels: int = 16,
        num_attention_heads: int = 24,
        attention_head_dim: int = 128,
        num_layers: int = 20,
        num_single_layers: int = 40,
        num_refiner_layers: int = 2,
        mlp_ratio: float = 4.0,
        patch_size: int = 2,
        patch_size_t: int = 1,
        qk_norm: str = "rms_norm",
        guidance_embeds: bool = True,
        text_embed_dim: int = 4096,
        pooled_projection_dim: int = 768,
        rope_theta: float = 256.0,
        rope_axes_dim: Tuple[int, ...] = (16, 56, 56),
        image_condition_type: Optional[str] = None,
    ):
        super().__init__()
        if image_condition_type not in (None, "latent_concat", "token_replace"):
            raise ValueError(f"invalid image_condition_type {image_condition_type}")
        inner_dim = num_attention_heads * attention_head_dim
        self.inner_dim = inner_dim
        self.out_channels = out_channels or in_channels
        self.x_embedder = HunyuanVideoPatchEmbed((patch_size_t, patch_size, patch_size), in_channels, inner_dim)
        self.context_embedder = HunyuanVideoTokenRefiner(text_embed_dim, num_attention_heads, attention_head_dim,
                                                         num_layers=num_refiner_layers)
        self.time_text_embed = HunyuanVideoConditionEmbedding(inner_dim, pooled_projection_dim, guidance_embeds,
                                                              image_condition_type)
        self.transformer_blocks = nn.ModuleList([
            HunyuanVideoTransformerBlock(num_attention_heads, attention_head_dim, mlp_ratio, qk_norm)
            for _ in range(num_layers)])
        self.single_transformer_blocks = nn.ModuleList([
            HunyuanVideoSingleTransformerBlock(num_attention_heads, attention_head_dim, mlp_ratio, qk_norm)
            for _ in range(num_single_layers)])
        self.norm_out = AdaLayerNormContinuous(inner_dim, inner_dim, elementwise_affine=False, eps=1e-6)
        self.proj_out = Linear(inner_dim, patch_size_t * patch_size * patch_size * self.out_channels)
        self._rope_cache: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def rope(self, num_frames: int, height: int, width: int) -> Tuple[np.ndarray, np.ndarray]:
        """Host (cos, sin) tables of the post-patchify token grid of a
        [F, H, W] latent (JAX `:464-477`; tokens T-major, then H, W)."""
        c = self.config
        return rope_tables(c.rope_axes_dim, c.rope_theta, np.arange(num_frames // c.patch_size_t),
                           height // c.patch_size, width // c.patch_size)

    def _device_rope(self, num_frames: int, height: int, width: int, device):
        key = (num_frames, height, width, str(device))
        if key not in self._rope_cache:
            cos, sin = self.rope(num_frames, height, width)
            self._rope_cache[key] = (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))
        return self._rope_cache[key]

    def text_context(self, encoder_hidden_states, encoder_attention_mask=None) -> HunyuanTextContext:
        """The refiner's timestep-independent half of a prompt, made once a
        request under TextKV and passed back as `text_context`."""
        return self.context_embedder.text_context(encoder_hidden_states, encoder_attention_mask)

    def run_blocks(self, hidden_states, encoder_hidden_states, temb, attn_bias, rope, token_replace_emb,
                   first_frame_num_tokens: int):
        """The dual blocks, then the single blocks: (image, text) streams."""
        for block in self.transformer_blocks:
            hidden_states, encoder_hidden_states = block(hidden_states, encoder_hidden_states, temb, attn_bias, rope,
                                                         token_replace_emb, first_frame_num_tokens)
        for block in self.single_transformer_blocks:
            hidden_states, encoder_hidden_states = block(hidden_states, encoder_hidden_states, temb, attn_bias, rope,
                                                         token_replace_emb, first_frame_num_tokens)
        return hidden_states, encoder_hidden_states

    def unpatchify(self, hidden_states, temb, batch_size: int, post_f: int, post_h: int, post_w: int):
        """`norm_out`, `proj_out` and the tokens back to [B, C, F, H, W]."""
        p, p_t = self.config.patch_size, self.config.patch_size_t
        hidden_states = self.proj_out(self.norm_out(hidden_states, temb))
        hidden_states = hidden_states.reshape(batch_size, post_f, post_h, post_w, -1, p_t, p, p)
        hidden_states = hidden_states.permute(0, 4, 1, 5, 2, 6, 3, 7)
        return hidden_states.reshape(batch_size, -1, post_f * p_t, post_h * p, post_w * p)

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, C, F, H, W]
        timestep: torch.Tensor,  # [B]
        encoder_hidden_states: torch.Tensor,  # [B, S, text_embed_dim]
        encoder_attention_mask: torch.Tensor,  # [B, S]
        pooled_projections: torch.Tensor,  # [B, pooled_projection_dim]
        guidance: Optional[torch.Tensor] = None,
        image_rotary_emb: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        return_dict: bool = True,
        text_context: Optional[HunyuanTextContext] = None,
    ):
        batch_size, _, num_frames, height, width = hidden_states.shape
        p, p_t = self.config.patch_size, self.config.patch_size_t
        post_f, post_h, post_w = num_frames // p_t, height // p, width // p
        if image_rotary_emb is None:
            image_rotary_emb = self._device_rope(num_frames, height, width, hidden_states.device)

        temb, token_replace_emb = self.time_text_embed(timestep, pooled_projections, guidance)
        hidden_states = self.x_embedder(hidden_states)
        encoder_hidden_states = self.context_embedder(encoder_hidden_states, timestep, encoder_attention_mask,
                                                      context=text_context)
        bias = validity_bias(encoder_attention_mask, hidden_states.shape[1])
        hidden_states, _ = self.run_blocks(hidden_states, encoder_hidden_states, temb, bias, image_rotary_emb,
                                           token_replace_emb, post_h * post_w)
        out = self.unpatchify(hidden_states, temb, batch_size, post_f, post_h, post_w)
        if not return_dict:
            return (out,)
        return Transformer2DModelOutput(sample=out)

"""WanTransformer3DModel: the Wan 2.1 video DiT.

Port of `diffusers_tpu/models/transformers/transformer_wan.py`
(`WanAttention` `:35`, `WanImageEmbedding` `:109`,
`WanTimeTextImageEmbedding` `:134`, `WanRotaryPosEmbed` `:157`,
`WanTransformerBlock` `:200`, `WanTransformer3DModel` `:270`) as a plain
Python loop over the blocks. The latents are patchified by a `Conv3d` into
(frame, row, column)-ordered tokens; each block runs a self attention with
qk RMSNorm across the heads and 3-D RoPE, a cross attention over the text
tokens (and, with `added_kv_proj_dim`, over the image-context tokens put
before them), and a tanh-GELU feed-forward. As in JAX, the modulation
(`scale_shift_table` + the timestep projection), the three LayerNorms and
the gated residuals run in float32 and are cast back to the stream's dtype;
the affine `norm2` takes its weights in float32, so a bf16 model on the card
gets no mixed-dtype call. Attention goes through the dispatch layer, so on
the card both attentions of a block are kernel K1 at head_dim 128.

The block also takes the two paths SkyReels-V2 needs (JAX `:225-236`): an
`attention_mask` for its self attention (a bool keep-mask reaches K1 as an
additive float32 mask) and a modulation per token, `temb` [B, 6, N, D];
`wan_output` is the head the Wan-family models share (a `temb` per token
too). VACE, Animate and SkyReels-V2 build on these blocks
(`transformer_wan_vace.py`, `transformer_wan_animate.py`,
`transformer_skyreels_v2.py`).

The caches: Pyramid Attention Broadcast (`pab_compute`, `pab_cache` from
`init_pab_cache`): on a broadcast step no block runs its self attention (nor
its projections) and each reuses its cached output; FirstBlockCache
(`fbc_state`, `fbc_config`): the first block always runs and
`hooks.first_block_cache.fbc_single_gate` runs the others or replays their
cached residual. Either returns its new state beside the sample. TextKV:
`context`, the text embedder's output made once by the caller, and each
cross attention's `text_kv` slot (`hooks.generic_cache.text_kv_cache`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...hooks.first_block_cache import fbc_single_gate
from ...ops.attention import dispatch_attention_fn
from ...ops.module import Conv3d, LayerNorm, Linear, RMSNorm
from ...utils import BaseOutput
from ..attention_blocks import FeedForward
from ..embeddings import (
    PixArtAlphaTextProjection,
    TimestepEmbedding,
    Timesteps,
    apply_rotary_emb,
    get_1d_rotary_pos_embed_np,
)
from ..modeling_utils import ModelMixin

# the text context length of Wan's cross attention; with image context, the
# tokens before the last TEXT_CONTEXT_LENGTH are the image's (JAX `:77`)
TEXT_CONTEXT_LENGTH = 512


@dataclass
class Transformer3DModelOutput(BaseOutput):
    sample: torch.Tensor


class WanAttention(nn.Module):
    """Attention with RMSNorm of q and k across the heads; a cross attention
    with `added_kv_proj_dim` also attends to the image-context tokens."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, eps: float = 1e-5,
                 added_kv_proj_dim: Optional[int] = None, cross_attention_dim_head: Optional[int] = None):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        self.inner_dim = dim_head * heads
        kv_inner_dim = self.inner_dim if cross_attention_dim_head is None else cross_attention_dim_head * heads
        self.added_kv_proj_dim = added_kv_proj_dim
        self.to_q = Linear(dim, self.inner_dim, use_bias=True)
        self.to_k = Linear(dim, kv_inner_dim, use_bias=True)
        self.to_v = Linear(dim, kv_inner_dim, use_bias=True)
        self.to_out = nn.ModuleList([Linear(self.inner_dim, dim, use_bias=True)])
        self.norm_q = RMSNorm(self.inner_dim, eps=eps)
        self.norm_k = RMSNorm(kv_inner_dim, eps=eps)
        if added_kv_proj_dim is not None:
            self.add_k_proj = Linear(added_kv_proj_dim, self.inner_dim, use_bias=True)
            self.add_v_proj = Linear(added_kv_proj_dim, self.inner_dim, use_bias=True)
            self.norm_added_k = RMSNorm(self.inner_dim, eps=eps)
        self.text_kv = None  # TextKVCacheConfig's slot (hooks.generic_cache.text_kv_cache)

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape(t.shape[0], -1, self.heads, self.dim_head)

    def _context_kv(self, encoder_hidden_states: torch.Tensor):
        """(k, v) of the text tokens, and of the image-context tokens or None.
        Under TextKV they are kept for each context tensor the module sees (the
        cond and the uncond one: Wan's CFG is two forwards) and reused while it
        is called with that same tensor."""
        for entry in self.text_kv or ():
            if entry[0] is encoder_hidden_states:
                return entry[1:]
        context, image_kv = encoder_hidden_states, None
        if self.added_kv_proj_dim is not None:
            n_image = encoder_hidden_states.shape[1] - TEXT_CONTEXT_LENGTH
            image, context = encoder_hidden_states[:, :n_image], encoder_hidden_states[:, n_image:]
            image_kv = (self._heads(self.norm_added_k(self.add_k_proj(image))), self._heads(self.add_v_proj(image)))
        kv = (self._heads(self.norm_k(self.to_k(context))), self._heads(self.to_v(context)))
        if self.text_kv is not None:
            self.text_kv = self.text_kv + ((encoder_hidden_states, kv, image_kv),)
        return kv, image_kv

    def forward(self, hidden_states: torch.Tensor, encoder_hidden_states: Optional[torch.Tensor] = None,
                rotary_emb: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`attention_mask` (a bool keep-mask or an additive one, broadcast to
        [B, H, Sq, Sk]) applies to the text or self keys, not to the
        image-context keys, as in JAX."""
        b = hidden_states.shape[0]
        q = self._heads(self.norm_q(self.to_q(hidden_states)))
        if encoder_hidden_states is None:
            (k, v), image_kv = (self._heads(self.norm_k(self.to_k(hidden_states))),
                                self._heads(self.to_v(hidden_states))), None
        else:
            (k, v), image_kv = self._context_kv(encoder_hidden_states)
        if rotary_emb is not None:
            q, k = apply_rotary_emb(q, *rotary_emb), apply_rotary_emb(k, *rotary_emb)
        out = dispatch_attention_fn(q, k, v, attn_mask=attention_mask).reshape(b, -1, self.inner_dim).to(q.dtype)
        if image_kv is not None:
            out = out + dispatch_attention_fn(q, *image_kv).reshape(b, -1, self.inner_dim).to(out.dtype)
        return self.to_out[0](out)


class WanImageEmbedding(nn.Module):
    """The image-context projection: LayerNorm, GELU MLP, LayerNorm (with an
    added position table when `pos_embed_seq_len` is set)."""

    def __init__(self, in_features: int, out_features: int, pos_embed_seq_len: Optional[int] = None):
        super().__init__()
        self.norm1 = LayerNorm(in_features)
        self.ff = FeedForward(in_features, out_features, mult=1, activation_fn="gelu")
        self.norm2 = LayerNorm(out_features)
        self.pos_embed_seq_len = pos_embed_seq_len
        if pos_embed_seq_len is not None:
            self.pos_embed = nn.Parameter(torch.zeros(1, pos_embed_seq_len, in_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pos_embed_seq_len is not None:
            _, s, d = x.shape
            x = x.reshape(-1, 2 * s if 2 * s == self.pos_embed_seq_len else self.pos_embed_seq_len, d)
            x = x + self.pos_embed.to(x.dtype)
        return self.norm2(self.ff(self.norm1(x)))


class WanTimeTextImageEmbedding(nn.Module):
    def __init__(self, dim: int, time_freq_dim: int, time_proj_dim: int, text_embed_dim: int,
                 image_embed_dim: Optional[int] = None, pos_embed_seq_len: Optional[int] = None):
        super().__init__()
        self.timesteps_proj = Timesteps(num_channels=time_freq_dim, flip_sin_to_cos=True, downscale_freq_shift=0)
        self.time_embedder = TimestepEmbedding(in_channels=time_freq_dim, time_embed_dim=dim)
        self.time_proj = Linear(dim, time_proj_dim)
        self.text_embedder = PixArtAlphaTextProjection(text_embed_dim, dim, act_fn="gelu_tanh")
        self.image_embedder = (WanImageEmbedding(image_embed_dim, dim, pos_embed_seq_len=pos_embed_seq_len)
                               if image_embed_dim is not None else None)

    def forward(self, timestep: torch.Tensor, encoder_hidden_states: torch.Tensor,
                encoder_hidden_states_image: Optional[torch.Tensor] = None, context: Optional[torch.Tensor] = None):
        """(temb, timestep_proj, text tokens, image tokens or None); the
        timestep sinusoid is cast to the text embeddings' dtype, as in JAX.
        `context`, when given, is the text embedder's output already made."""
        temb = self.time_embedder(self.timesteps_proj(timestep).to(encoder_hidden_states.dtype))
        timestep_proj = self.time_proj(F.silu(temb))
        encoder_hidden_states = self.text_embedder(encoder_hidden_states) if context is None else context
        if encoder_hidden_states_image is not None:
            encoder_hidden_states_image = self.image_embedder(encoder_hidden_states_image)
        return temb, timestep_proj, encoder_hidden_states, encoder_hidden_states_image


class WanRotaryPosEmbed:
    """3-D RoPE tables made on the host in float64 (no parameters): head_dim d
    split into frame, row and column parts of d - 4(d // 6), 2(d // 6) and
    2(d // 6)."""

    def __init__(self, attention_head_dim: int, patch_size, max_seq_len: int, theta: float = 10000.0):
        self.patch_size = tuple(patch_size)
        h_dim = w_dim = 2 * (attention_head_dim // 6)
        t_dim = attention_head_dim - h_dim - w_dim
        pos = np.arange(max_seq_len)
        self.freqs = [get_1d_rotary_pos_embed_np(d, pos, theta=theta) for d in (t_dim, h_dim, w_dim)]

    def __call__(self, num_frames: int, height: int, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """float32 (cos, sin) [1, tokens, 1, head_dim] for a latent of
        `num_frames` x `height` x `width`, on the CPU."""
        p_t, p_h, p_w = self.patch_size
        grid = (num_frames // p_t, height // p_h, width // p_w)
        tables = []
        for part in (0, 1):  # cos, then sin
            axes = []
            for axis, (n, table) in enumerate(zip(grid, (f[part] for f in self.freqs))):
                shape = [1, 1, 1, table.shape[-1]]
                shape[axis] = n
                axes.append(np.broadcast_to(table[:n].reshape(shape), (*grid, table.shape[-1])))
            tables.append(torch.from_numpy(np.concatenate(axes, axis=-1).reshape(1, math.prod(grid), 1, -1)))
        return tables[0], tables[1]


def _layer_norm_f32(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """`norm` of a float32 `x` with float32 weights (a bf16 model's LayerNorm
    refuses a float32 input on the card)."""
    weight = norm.weight.float() if norm.weight is not None else None
    bias = norm.bias.float() if norm.bias is not None else None
    return F.layer_norm(x, norm.normalized_shape, weight, bias, norm.eps)


class WanTransformerBlock(nn.Module):
    def __init__(self, dim: int, ffn_dim: int, num_heads: int, qk_norm: str = "rms_norm_across_heads",
                 cross_attn_norm: bool = False, eps: float = 1e-6, added_kv_proj_dim: Optional[int] = None):
        super().__init__()
        if qk_norm != "rms_norm_across_heads":
            raise NotImplementedError(f"qk_norm {qk_norm!r} is not ported (Wan uses rms_norm_across_heads)")
        self.dim = dim
        self.norm1 = LayerNorm(dim, eps=eps, use_scale=False, use_bias=False)
        self.attn1 = WanAttention(dim=dim, heads=num_heads, dim_head=dim // num_heads, eps=eps)
        self.attn2 = WanAttention(dim=dim, heads=num_heads, dim_head=dim // num_heads, eps=eps,
                                  added_kv_proj_dim=added_kv_proj_dim, cross_attention_dim_head=dim // num_heads)
        self.norm2 = LayerNorm(dim, eps=eps) if cross_attn_norm else None
        self.ffn = FeedForward(dim, inner_dim=ffn_dim, activation_fn="gelu-approximate")
        self.norm3 = LayerNorm(dim, eps=eps, use_scale=False, use_bias=False)
        self.scale_shift_table = nn.Parameter(torch.randn(1, 6, dim) / dim**0.5)

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.scale_shift_table.normal_().div_(self.dim**0.5)

    def forward(self, hidden_states, encoder_hidden_states, temb, rotary_emb, pab=None, attention_mask=None):
        """The block's output; with `pab=(compute, cached)`, (output, the self
        attention's output in use), `cached` standing in on a step that does
        not compute. `temb` is [B, 6, D], or [B, 6, N, D] for a modulation per
        token (SkyReels-V2's diffusion forcing, JAX `:225-236`);
        `attention_mask` goes to the self attention."""
        if temb.ndim == 3:
            mods = (self.scale_shift_table.float() + temb.float()).chunk(6, dim=1)  # each [B, 1, D]
        else:
            mods = (self.scale_shift_table.float()[:, :, None] + temb.float()).unbind(1)  # each [B, N, D]
        shift_msa, scale_msa, gate_msa, c_shift_msa, c_scale_msa, c_gate_msa = mods
        dtype = hidden_states.dtype

        norm_h = (self.norm1(hidden_states.float()) * (1 + scale_msa) + shift_msa).to(dtype)
        attn_out = (self.attn1(norm_h, None, rotary_emb, attention_mask) if pab is None or pab[0] else pab[1])
        hidden_states = (hidden_states.float() + attn_out.float() * gate_msa).to(dtype)

        norm_h = hidden_states if self.norm2 is None else _layer_norm_f32(hidden_states.float(), self.norm2).to(dtype)
        hidden_states = hidden_states + self.attn2(norm_h, encoder_hidden_states)

        norm_h = (self.norm3(hidden_states.float()) * (1 + c_scale_msa) + c_shift_msa).to(dtype)
        hidden_states = (hidden_states.float() + self.ffn(norm_h).float() * c_gate_msa).to(dtype)
        return (hidden_states, attn_out) if pab is not None else hidden_states


class WanRotaryMixin:
    """`rotary_tables` for a Wan-family model with a `rope` (WanRotaryPosEmbed)."""

    def rotary_tables(self, latents: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cos, sin) of RoPE for `latents` [B, C, F, H, W], on their device."""
        cos, sin = self.rope(*latents.shape[2:])
        return cos.to(latents.device), sin.to(latents.device)


def wan_output(model: nn.Module, x: torch.Tensor, temb: torch.Tensor, grid: Tuple[int, int, int]) -> torch.Tensor:
    """The Wan models' head: `norm_out` modulated by `model.scale_shift_table`
    + `temb` in float32 (`temb` [B, D], or [B, N, D] a token), `proj_out`,
    then the tokens of the (frame, row, column) `grid` unpatchified to [B, C,
    F, H, W]."""
    if temb.ndim == 2:
        shift, scale = (model.scale_shift_table.float() + temb.float()[:, None]).chunk(2, dim=1)  # [B, 1, D]
    else:
        shift, scale = (model.scale_shift_table.float()[:, :, None] + temb.float()[:, None]).unbind(1)  # [B, N, D]
    x = (model.norm_out(x.float()) * (1 + scale) + shift).to(x.dtype)
    x = model.proj_out(x)
    (ppf, pph, ppw), (p_t, p_h, p_w), c = grid, model.config.patch_size, model.out_channels
    x = x.reshape(x.shape[0], ppf, pph, ppw, p_t, p_h, p_w, c).permute(0, 7, 1, 4, 2, 5, 3, 6)
    return x.reshape(x.shape[0], c, ppf * p_t, pph * p_h, ppw * p_w)


class WanTransformer3DModel(WanRotaryMixin, ModelMixin, ConfigMixin):
    @register_to_config
    def __init__(
        self,
        patch_size: Tuple[int, ...] = (1, 2, 2),
        num_attention_heads: int = 40,
        attention_head_dim: int = 128,
        in_channels: int = 16,
        out_channels: int = 16,
        text_dim: int = 4096,
        freq_dim: int = 256,
        ffn_dim: int = 13824,
        num_layers: int = 40,
        cross_attn_norm: bool = True,
        qk_norm: Optional[str] = "rms_norm_across_heads",
        eps: float = 1e-6,
        image_dim: Optional[int] = None,
        added_kv_proj_dim: Optional[int] = None,
        rope_max_seq_len: int = 1024,
        pos_embed_seq_len: Optional[int] = None,
    ):
        super().__init__()
        patch_size = tuple(patch_size)
        self.inner_dim = inner_dim = num_attention_heads * attention_head_dim
        self.out_channels = out_channels or in_channels
        self.rope = WanRotaryPosEmbed(attention_head_dim, patch_size, rope_max_seq_len)
        self.patch_embedding = Conv3d(in_channels, inner_dim, kernel_size=patch_size, stride=patch_size)
        self.condition_embedder = WanTimeTextImageEmbedding(
            dim=inner_dim, time_freq_dim=freq_dim, time_proj_dim=inner_dim * 6, text_embed_dim=text_dim,
            image_embed_dim=image_dim, pos_embed_seq_len=pos_embed_seq_len)
        self.blocks = nn.ModuleList([
            WanTransformerBlock(inner_dim, ffn_dim, num_attention_heads, qk_norm, cross_attn_norm, eps,
                                added_kv_proj_dim)
            for _ in range(num_layers)
        ])
        self.norm_out = LayerNorm(inner_dim, eps=eps, use_scale=False, use_bias=False)
        self.proj_out = Linear(inner_dim, self.out_channels * math.prod(patch_size))
        self.scale_shift_table = nn.Parameter(torch.randn(1, 2, inner_dim) / inner_dim**0.5)

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, C, F, H, W]
        timestep: torch.Tensor,  # [B], on the 0-1000 scale
        encoder_hidden_states: torch.Tensor,  # [B, S, text_dim]
        encoder_hidden_states_image: Optional[torch.Tensor] = None,
        rotary_emb: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        fbc_state=None,  # FBCSingleState (hooks/first_block_cache.py)
        fbc_config=None,
        pab_compute: Optional[bool] = None,  # PAB: recompute the self attentions this step?
        pab_cache: Optional[dict] = None,  # per-block self-attention outputs (init_pab_cache)
        context: Optional[torch.Tensor] = None,  # the text embedder's output, if the caller has it
        return_dict: bool = True,
    ) -> Union[Transformer3DModelOutput, tuple]:
        b, _, f, h, w = hidden_states.shape
        p_t, p_h, p_w = self.config.patch_size
        ppf, pph, ppw = f // p_t, h // p_h, w // p_w
        if rotary_emb is None:
            rotary_emb = self.rotary_tables(hidden_states)

        x = self.patch_embedding(hidden_states).flatten(2).transpose(1, 2)  # [B, tokens, D], (f, h, w) order
        temb, timestep_proj, text, image = self.condition_embedder(timestep, encoder_hidden_states,
                                                                   encoder_hidden_states_image, context)
        timestep_proj = timestep_proj.reshape(b, 6, -1)
        context_tokens = text if image is None else torch.cat([image, text], dim=1)

        extra = None
        if fbc_state is not None:
            first_in = x
            x = self.blocks[0](x, context_tokens, timestep_proj, rotary_emb)
            x, extra = fbc_single_gate(fbc_state, fbc_config, x - first_in, x,
                                       lambda t: self.run_blocks(t, context_tokens, timestep_proj, rotary_emb, 1))
        elif pab_cache is not None:
            extra = {}
            for i, block in enumerate(self.blocks):
                x, extra[i] = block(x, context_tokens, timestep_proj, rotary_emb, pab=(pab_compute, pab_cache[i]))
        else:
            x = self.run_blocks(x, context_tokens, timestep_proj, rotary_emb)

        output = wan_output(self, x, temb, (ppf, pph, ppw))
        if extra is not None:  # the cache's new state beside the sample
            return (output, extra) if not return_dict else (Transformer3DModelOutput(sample=output), extra)
        return Transformer3DModelOutput(sample=output) if return_dict else (output,)

    def run_blocks(self, x, context_tokens, timestep_proj, rotary_emb, first: int = 0):
        for block in self.blocks[first:]:
            x = block(x, context_tokens, timestep_proj, rotary_emb)
        return x

    def text_context(self, encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        """The text embedder's output, loop-invariant within a request
        (`context=` under TextKVCacheConfig)."""
        return self.condition_embedder.text_embedder(encoder_hidden_states)

    def init_pab_cache(self, batch_size: int, tokens: int, dtype=torch.float32, device=None) -> dict:
        """Zero per-block self-attention outputs for PAB (the first step always
        computes, so the zeros are never read)."""
        return {i: torch.zeros((batch_size, tokens, self.inner_dim), dtype=dtype, device=device)
                for i in range(len(self.blocks))}

"""FluxTransformer2DModel: the rectified-flow DiT of the Flux.1 family.

Port of `diffusers_tpu/models/transformers/transformer_flux.py`
(`FluxAttention`, `FluxSingleTransformerBlock`, `FluxTransformerBlock`,
`FluxTransformer2DModel`) as a plain Python loop over the blocks. The packed
(text + image) token stream runs through one joint attention per block;
attention goes through the dispatch layer, so on the card it is kernel K1 at
head_dim 128. After `quantize_w8a8`, every large Linear runs kernel K5.

The forward is three reusable pieces, `embed` (the prologue), `run_blocks`
and `project_out` (the epilogue), which the first-block and MagCache
forwards of `diffusers_tpu_torch.hooks` share. Pyramid Attention Broadcast
(`pab_compute`, `pab_cache`): on a broadcast step no block runs its
attention or its q/k/v/out projections, and each block reuses its cached
attention output.

ControlNet residuals (JAX `:392-409`): `controlnet_block_samples` is added
after each dual block, sample ``i // ceil(num_layers / len(samples))`` (the
interval rule) or, with `controlnet_blocks_repeat` (an XLabs ControlNet),
sample ``i % len(samples)``; `controlnet_single_block_samples` after each
single block by the interval rule, to the image tokens the block returns.

Left for later: the `scan_blocks` path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...ops.attention import dispatch_attention_fn
from ...ops.module import LayerNorm, Linear, RMSNorm
from ...utils import BaseOutput
from ..attention_blocks import FeedForward
from ..embeddings import (
    CombinedTimestepGuidanceTextProjEmbeddings,
    CombinedTimestepTextProjEmbeddings,
    FluxPosEmbed,
    apply_rotary_emb,
)
from ..modeling_utils import ModelMixin
from ..normalization import AdaLayerNormContinuous, AdaLayerNormZero, AdaLayerNormZeroSingle


@dataclass
class Transformer2DModelOutput(BaseOutput):
    sample: torch.Tensor


class FluxAttention(nn.Module):
    """Joint text + image attention with RMS qk-norm and RoPE."""

    def __init__(
        self,
        query_dim: int,
        heads: int,
        dim_head: int,
        added_kv_proj_dim: Optional[int] = None,
        bias: bool = True,
        eps: float = 1e-6,
        out_dim: Optional[int] = None,
        pre_only: bool = False,
    ):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        self.inner_dim = out_dim if out_dim is not None else heads * dim_head
        self.added_kv_proj_dim = added_kv_proj_dim
        self.pre_only = pre_only

        self.norm_q = RMSNorm(dim_head, eps=eps)
        self.norm_k = RMSNorm(dim_head, eps=eps)
        self.to_q = Linear(query_dim, self.inner_dim, use_bias=bias)
        self.to_k = Linear(query_dim, self.inner_dim, use_bias=bias)
        self.to_v = Linear(query_dim, self.inner_dim, use_bias=bias)
        if not pre_only:
            self.to_out = nn.ModuleList([Linear(self.inner_dim, query_dim, use_bias=True)])
        if added_kv_proj_dim is not None:
            self.norm_added_q = RMSNorm(dim_head, eps=eps)
            self.norm_added_k = RMSNorm(dim_head, eps=eps)
            self.add_q_proj = Linear(added_kv_proj_dim, self.inner_dim, use_bias=bias)
            self.add_k_proj = Linear(added_kv_proj_dim, self.inner_dim, use_bias=bias)
            self.add_v_proj = Linear(added_kv_proj_dim, self.inner_dim, use_bias=bias)
            self.to_add_out = Linear(self.inner_dim, added_kv_proj_dim, use_bias=True)

    def forward(
        self,
        hidden_states: torch.Tensor,
        encoder_hidden_states: Optional[torch.Tensor] = None,
        image_rotary_emb: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ):
        b = hidden_states.shape[0]

        def heads(t):
            return t.reshape(b, -1, self.heads, self.dim_head)

        q = self.norm_q(heads(self.to_q(hidden_states)))
        k = self.norm_k(heads(self.to_k(hidden_states)))
        v = heads(self.to_v(hidden_states))
        if self.added_kv_proj_dim is not None and encoder_hidden_states is not None:
            eq = self.norm_added_q(heads(self.add_q_proj(encoder_hidden_states)))
            ek = self.norm_added_k(heads(self.add_k_proj(encoder_hidden_states)))
            ev = heads(self.add_v_proj(encoder_hidden_states))
            q = torch.cat([eq, q], dim=1)
            k = torch.cat([ek, k], dim=1)
            v = torch.cat([ev, v], dim=1)
        if image_rotary_emb is not None:
            cos, sin = image_rotary_emb
            q = apply_rotary_emb(q, cos, sin)
            k = apply_rotary_emb(k, cos, sin)

        out = dispatch_attention_fn(q, k, v)
        out = out.reshape(b, -1, self.heads * self.dim_head).to(q.dtype)
        if encoder_hidden_states is not None:
            txt_len = encoder_hidden_states.shape[1]
            return self.to_out[0](out[:, txt_len:]), self.to_add_out(out[:, :txt_len])
        if self.pre_only:
            return out
        return self.to_out[0](out)


class FluxSingleTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_attention_heads: int, attention_head_dim: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.mlp_hidden_dim = int(dim * mlp_ratio)
        self.norm = AdaLayerNormZeroSingle(dim)
        self.proj_mlp = Linear(dim, self.mlp_hidden_dim)
        self.proj_out = Linear(dim + self.mlp_hidden_dim, dim)
        self.attn = FluxAttention(query_dim=dim, heads=num_attention_heads, dim_head=attention_head_dim,
                                  out_dim=dim, bias=True, eps=1e-6, pre_only=True)

    def forward(self, hidden_states, encoder_hidden_states, temb, image_rotary_emb=None, pab=None):
        """`pab=(compute, cached)`: on a step that does not compute, `cached`
        stands in for the attention output; the attention output is then
        returned third."""
        text_seq_len = encoder_hidden_states.shape[1]
        hidden_states = torch.cat([encoder_hidden_states, hidden_states], dim=1)
        residual = hidden_states
        norm_hidden_states, gate = self.norm(hidden_states, emb=temb)
        mlp_hidden_states = F.gelu(self.proj_mlp(norm_hidden_states), approximate="tanh")
        if pab is None or pab[0]:
            attn_output = self.attn(norm_hidden_states, image_rotary_emb=image_rotary_emb)
        else:
            attn_output = pab[1]
        hidden_states = torch.cat([attn_output, mlp_hidden_states], dim=2)
        hidden_states = residual + gate[:, None] * self.proj_out(hidden_states)
        out = (hidden_states[:, :text_seq_len], hidden_states[:, text_seq_len:])
        return out if pab is None else (*out, attn_output)


class FluxTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_attention_heads: int, attention_head_dim: int, eps: float = 1e-6):
        super().__init__()
        self.norm1 = AdaLayerNormZero(dim)
        self.norm1_context = AdaLayerNormZero(dim)
        self.attn = FluxAttention(query_dim=dim, added_kv_proj_dim=dim, heads=num_attention_heads,
                                  dim_head=attention_head_dim, out_dim=dim, bias=True, eps=eps)
        self.norm2 = LayerNorm(dim, eps=1e-6, use_scale=False, use_bias=False)
        self.ff = FeedForward(dim=dim, dim_out=dim, activation_fn="gelu-approximate")
        self.norm2_context = LayerNorm(dim, eps=1e-6, use_scale=False, use_bias=False)
        self.ff_context = FeedForward(dim=dim, dim_out=dim, activation_fn="gelu-approximate")

    def forward(self, hidden_states, encoder_hidden_states, temb, image_rotary_emb=None, pab=None):
        """`pab=(compute, (attn_output, context_attn_output))` as for the
        single block; the pair is then returned third."""
        norm_hidden, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.norm1(hidden_states, emb=temb)
        norm_context, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = self.norm1_context(
            encoder_hidden_states, emb=temb)
        if pab is None or pab[0]:
            attn_output, context_attn_output = self.attn(norm_hidden, encoder_hidden_states=norm_context,
                                                         image_rotary_emb=image_rotary_emb)
        else:
            attn_output, context_attn_output = pab[1]

        hidden_states = hidden_states + gate_msa[:, None] * attn_output
        norm_hidden = self.norm2(hidden_states) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
        hidden_states = hidden_states + gate_mlp[:, None] * self.ff(norm_hidden)

        encoder_hidden_states = encoder_hidden_states + c_gate_msa[:, None] * context_attn_output
        norm_context = self.norm2_context(encoder_hidden_states) * (1 + c_scale_mlp[:, None]) + c_shift_mlp[:, None]
        encoder_hidden_states = encoder_hidden_states + c_gate_mlp[:, None] * self.ff_context(norm_context)
        if pab is not None:
            return encoder_hidden_states, hidden_states, (attn_output, context_attn_output)
        return encoder_hidden_states, hidden_states


class FluxTransformer2DModel(ModelMixin, ConfigMixin):
    @register_to_config
    def __init__(
        self,
        patch_size: int = 1,
        in_channels: int = 64,
        out_channels: Optional[int] = None,
        num_layers: int = 19,
        num_single_layers: int = 38,
        attention_head_dim: int = 128,
        num_attention_heads: int = 24,
        joint_attention_dim: int = 4096,
        pooled_projection_dim: int = 768,
        guidance_embeds: bool = False,
        axes_dims_rope: Tuple[int, ...] = (16, 56, 56),
    ):
        super().__init__()
        self.out_channels = out_channels or in_channels
        self.inner_dim = num_attention_heads * attention_head_dim

        self.pos_embed = FluxPosEmbed(theta=10000, axes_dim=axes_dims_rope)
        embed_cls = CombinedTimestepGuidanceTextProjEmbeddings if guidance_embeds else CombinedTimestepTextProjEmbeddings
        self.time_text_embed = embed_cls(embedding_dim=self.inner_dim, pooled_projection_dim=pooled_projection_dim)
        self.context_embedder = Linear(joint_attention_dim, self.inner_dim)
        self.x_embedder = Linear(in_channels, self.inner_dim)
        self.transformer_blocks = nn.ModuleList(
            [FluxTransformerBlock(self.inner_dim, num_attention_heads, attention_head_dim) for _ in range(num_layers)]
        )
        self.single_transformer_blocks = nn.ModuleList(
            [FluxSingleTransformerBlock(self.inner_dim, num_attention_heads, attention_head_dim)
             for _ in range(num_single_layers)]
        )
        self.norm_out = AdaLayerNormContinuous(self.inner_dim, self.inner_dim, elementwise_affine=False, eps=1e-6)
        self.proj_out = Linear(self.inner_dim, patch_size * patch_size * self.out_channels, use_bias=True)

    def embed(self, hidden_states, encoder_hidden_states, pooled_projections, timestep, guidance=None,
              img_ids=None, txt_ids=None, image_rotary_emb=None, context=None):
        """The prologue: (hidden, context, temb, image_rotary_emb). `context`,
        when given, is `context_embedder(encoder_hidden_states)` computed by the
        caller (it is loop-invariant: TextKVCacheConfig)."""
        hidden_states = self.x_embedder(hidden_states)
        timestep = timestep.to(hidden_states.dtype) * 1000
        if guidance is None:
            temb = self.time_text_embed(timestep, pooled_projections)
        else:
            temb = self.time_text_embed(timestep, guidance.to(hidden_states.dtype) * 1000, pooled_projections)
        if context is None:
            context = self.context_embedder(encoder_hidden_states)
        if image_rotary_emb is None:
            ids = torch.cat([torch.as_tensor(txt_ids), torch.as_tensor(img_ids)], dim=0)
            cos, sin = self.pos_embed(ids)
            image_rotary_emb = (cos.to(hidden_states.device), sin.to(hidden_states.device))
        return hidden_states, context, temb, image_rotary_emb

    def run_blocks(self, hidden_states, context, temb, image_rotary_emb, first: int = 0,
                   controlnet_block_samples: Optional[Sequence[torch.Tensor]] = None,
                   controlnet_single_block_samples: Optional[Sequence[torch.Tensor]] = None,
                   controlnet_blocks_repeat: bool = False):
        """The dual blocks from index `first`, then the single blocks, each
        followed by its ControlNet residual when samples are given (module
        docstring): (hidden, context)."""
        n_dual, n_single = len(self.transformer_blocks), len(self.single_transformer_blocks)
        for i in range(first, n_dual):
            context, hidden_states = self.transformer_blocks[i](hidden_states, context, temb, image_rotary_emb)
            if controlnet_block_samples is not None:
                n = len(controlnet_block_samples)
                j = i % n if controlnet_blocks_repeat else i // math.ceil(n_dual / n)
                hidden_states = hidden_states + controlnet_block_samples[j]
        for i, block in enumerate(self.single_transformer_blocks):
            context, hidden_states = block(hidden_states, context, temb, image_rotary_emb)
            if controlnet_single_block_samples is not None:
                hidden_states = hidden_states + controlnet_single_block_samples[
                    i // math.ceil(n_single / len(controlnet_single_block_samples))]
        return hidden_states, context

    def project_out(self, hidden_states, temb):
        """The epilogue: `norm_out`, then `proj_out`."""
        return self.proj_out(self.norm_out(hidden_states, temb))

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, image_seq, in_channels] (packed latents)
        encoder_hidden_states: torch.Tensor,  # [B, text_seq, joint_attention_dim]
        pooled_projections: torch.Tensor,  # [B, pooled_projection_dim]
        timestep: torch.Tensor,  # [B] in [0, 1]
        img_ids=None,  # [image_seq, 3]
        txt_ids=None,  # [text_seq, 3]
        guidance: Optional[torch.Tensor] = None,  # [B]
        image_rotary_emb: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        pab_compute: Optional[bool] = None,  # PAB: recompute attention this step?
        pab_cache: Optional[dict] = None,  # stacked per-block attention outputs (hooks/pyramid_attention_broadcast.py)
        context: Optional[torch.Tensor] = None,  # context_embedder(encoder_hidden_states), if the caller has it
        controlnet_block_samples: Optional[Sequence[torch.Tensor]] = None,  # residuals after the dual blocks
        controlnet_single_block_samples: Optional[Sequence[torch.Tensor]] = None,  # ... after the single blocks
        controlnet_blocks_repeat: bool = False,  # dual residuals by i % n (XLabs) instead of the interval rule
        return_dict: bool = True,
    ) -> Union[Transformer2DModelOutput, tuple]:
        hidden_states, context, temb, image_rotary_emb = self.embed(
            hidden_states, encoder_hidden_states, pooled_projections, timestep, guidance, img_ids, txt_ids,
            image_rotary_emb, context)

        if pab_cache is not None:
            # the PAB forward returns (sample, pab_cache), the cache's entries
            # overwritten in place on a step that computes attention
            for i, block in enumerate(self.transformer_blocks):
                cached = (pab_cache["dual_attn"][i], pab_cache["dual_ctx"][i])
                context, hidden_states, (a, c) = block(hidden_states, context, temb, image_rotary_emb,
                                                       pab=(pab_compute, cached))
                if pab_compute:
                    pab_cache["dual_attn"][i].copy_(a)
                    pab_cache["dual_ctx"][i].copy_(c)
            for i, block in enumerate(self.single_transformer_blocks):
                context, hidden_states, a = block(hidden_states, context, temb, image_rotary_emb,
                                                  pab=(pab_compute, pab_cache["single_attn"][i]))
                if pab_compute:
                    pab_cache["single_attn"][i].copy_(a)
            return self.project_out(hidden_states, temb), pab_cache

        hidden_states, _ = self.run_blocks(hidden_states, context, temb, image_rotary_emb,
                                           controlnet_block_samples=controlnet_block_samples,
                                           controlnet_single_block_samples=controlnet_single_block_samples,
                                           controlnet_blocks_repeat=controlnet_blocks_repeat)
        output = self.project_out(hidden_states, temb)
        if not return_dict:
            return (output,)
        return Transformer2DModelOutput(sample=output)

"""SD3Transformer2DModel: the MMDiT of Stable Diffusion 3 and 3.5.

Port of `diffusers_tpu/models/transformers/transformer_sd3.py`
(`SD35AdaLayerNormZeroX`, `JointAttention`, `JointTransformerBlock`,
`SD3Transformer2DModel` `:35-397`) as a plain Python loop over the blocks.
The joint token stream is sample-first (the opposite of Flux); the last block
is `context_pre_only` (its `norm1_context` is an `AdaLayerNormContinuous`, it
has no `to_add_out` and it drops the text half); SD3.5's dual-attention
blocks add a self-attention over the image tokens alone (`attn2`); qk
RMSNorm is per head. Attention goes through the dispatch layer, so on the
card it is kernel K1 at head_dim 64.

The forward is three reusable pieces, `embed` (the prologue), `run_blocks`
and `project_out` (the epilogue with the unpatchify), which the first-block
cache shares. ControlNet residuals (`block_controlnet_hidden_states`) are
added after each block but the last, JAX's float `interval` and
`int(i / interval)` picking the residual. Pyramid Attention Broadcast
(`pab_compute`, `pab_cache` from `init_pab_cache`): on a broadcast step no
block runs its attentions (nor their projections) and each reuses its
cached outputs; the forward then returns the cache beside the sample.
FirstBlockCache (`fbc_state`, `fbc_config`): the first block always runs,
and `hooks.first_block_cache.fbc_single_gate` runs the other blocks or
replays their cached residual.

Perturbed-Attention Guidance (JAX `:100-130`): while `JointAttention.pag_identity`
is set, the joint attention takes an additive float32 mask [1, 1, Sq, Sq]
whose image-to-image block is the identity (``finfo(float32).min`` off the
diagonal, 0 on it) and which leaves every text key open to every query; on
the card K1 reads it through its broadcast strides. Skip Layer Guidance
(JAX `:178-187`): while `JointTransformerBlock.layer_skip` is set the block
returns its inputs (and the PAB cache it was given). Both are plain
attributes that the guiders' context managers set and clear.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...hooks.first_block_cache import fbc_single_gate
from ...ops.attention import dispatch_attention_fn
from ...ops.module import LayerNorm, Linear, RMSNorm
from ...utils import BaseOutput
from ..attention_blocks import FeedForward
from ..embeddings import CombinedTimestepTextProjEmbeddings, PatchEmbed, get_2d_sincos_pos_embed
from ..modeling_utils import ModelMixin
from ..normalization import AdaLayerNormContinuous, AdaLayerNormZero


@dataclass
class Transformer2DModelOutput(BaseOutput):
    sample: torch.Tensor


class SD35AdaLayerNormZeroX(nn.Module):
    """9-way modulation of SD3.5's dual-attention blocks: the 6 of
    `AdaLayerNormZero` plus a shift, scale and gate for `attn2`."""

    def __init__(self, embedding_dim: int, bias: bool = True):
        super().__init__()
        self.linear = Linear(embedding_dim, 9 * embedding_dim, use_bias=bias)
        self.norm = LayerNorm(embedding_dim, eps=1e-6, use_scale=False, use_bias=False)

    def forward(self, x: torch.Tensor, emb: torch.Tensor):
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp,
         shift_msa2, scale_msa2, gate_msa2) = self.linear(F.silu(emb)).chunk(9, dim=-1)
        norm_x = self.norm(x)
        x1 = norm_x * (1 + scale_msa[:, None]) + shift_msa[:, None]
        x2 = norm_x * (1 + scale_msa2[:, None]) + shift_msa2[:, None]
        return x1, gate_msa, shift_mlp, scale_mlp, gate_mlp, x2, gate_msa2


def pag_identity_mask(seq_len: int, sample_len: int, device=None) -> torch.Tensor:
    """PAG's additive mask over the joint stream (image tokens first): among
    the first `sample_len` tokens each query sees only itself (float32
    minimum elsewhere); the text keys stay open to every query. [1, 1, S, S]."""
    mask = torch.zeros((seq_len, seq_len), dtype=torch.float32, device=device)
    mask[:sample_len, :sample_len] = torch.finfo(torch.float32).min
    mask[:sample_len, :sample_len].fill_diagonal_(0.0)
    return mask[None, None]


class JointAttention(nn.Module):
    """SD3 attention over the sample-first joint stream (image tokens, then
    text tokens), or over the image tokens alone without `added_kv_proj_dim`."""

    pag_identity: bool = False

    def __init__(
        self,
        query_dim: int,
        heads: int,
        dim_head: int,
        added_kv_proj_dim: Optional[int] = None,
        context_pre_only: Optional[bool] = None,
        qk_norm: Optional[str] = None,
        bias: bool = True,
        eps: float = 1e-6,
        out_dim: Optional[int] = None,
    ):
        super().__init__()
        if qk_norm not in (None, "rms_norm"):
            raise ValueError(f"unsupported qk_norm {qk_norm}")
        self.heads = heads
        self.dim_head = dim_head
        self.inner_dim = out_dim if out_dim is not None else heads * dim_head
        self.added_kv_proj_dim = added_kv_proj_dim
        self.context_pre_only = context_pre_only

        self.to_q = Linear(query_dim, self.inner_dim, use_bias=bias)
        self.to_k = Linear(query_dim, self.inner_dim, use_bias=bias)
        self.to_v = Linear(query_dim, self.inner_dim, use_bias=bias)
        self.to_out = nn.ModuleList([Linear(self.inner_dim, query_dim, use_bias=True)])
        rms = qk_norm == "rms_norm"
        self.norm_q = RMSNorm(dim_head, eps=eps) if rms else None
        self.norm_k = RMSNorm(dim_head, eps=eps) if rms else None
        if added_kv_proj_dim is not None:
            self.add_q_proj = Linear(added_kv_proj_dim, self.inner_dim, use_bias=bias)
            self.add_k_proj = Linear(added_kv_proj_dim, self.inner_dim, use_bias=bias)
            self.add_v_proj = Linear(added_kv_proj_dim, self.inner_dim, use_bias=bias)
            self.norm_added_q = RMSNorm(dim_head, eps=eps) if rms else None
            self.norm_added_k = RMSNorm(dim_head, eps=eps) if rms else None
            if not context_pre_only:
                self.to_add_out = Linear(self.inner_dim, added_kv_proj_dim, use_bias=True)

    def forward(self, hidden_states: torch.Tensor, encoder_hidden_states: Optional[torch.Tensor] = None):
        """(sample_out, context_out) with `encoder_hidden_states` (context_out
        not projected on a `context_pre_only` block), else the output."""
        b, sample_len = hidden_states.shape[0], hidden_states.shape[1]

        def heads(t):
            return t.reshape(b, -1, self.heads, self.dim_head)

        q, k, v = heads(self.to_q(hidden_states)), heads(self.to_k(hidden_states)), heads(self.to_v(hidden_states))
        if self.norm_q is not None:
            q, k = self.norm_q(q), self.norm_k(k)
        if encoder_hidden_states is not None:
            eq = heads(self.add_q_proj(encoder_hidden_states))
            ek = heads(self.add_k_proj(encoder_hidden_states))
            ev = heads(self.add_v_proj(encoder_hidden_states))
            if self.norm_added_q is not None:
                eq, ek = self.norm_added_q(eq), self.norm_added_k(ek)
            q, k, v = torch.cat([q, eq], dim=1), torch.cat([k, ek], dim=1), torch.cat([v, ev], dim=1)

        out = dispatch_attention_fn(q, k, v, attn_mask=pag_identity_mask(q.shape[1], sample_len, q.device)
                                    if self.pag_identity else None)
        out = out.reshape(b, -1, self.heads * self.dim_head).to(q.dtype)
        if encoder_hidden_states is None:
            return self.to_out[0](out)
        sample_out, context_out = self.to_out[0](out[:, :sample_len]), out[:, sample_len:]
        if not self.context_pre_only:
            context_out = self.to_add_out(context_out)
        return sample_out, context_out


class JointTransformerBlock(nn.Module):
    layer_skip: bool = False

    def __init__(
        self,
        dim: int,
        num_attention_heads: int,
        attention_head_dim: int,
        context_pre_only: bool = False,
        qk_norm: Optional[str] = None,
        use_dual_attention: bool = False,
    ):
        super().__init__()
        self.use_dual_attention = use_dual_attention
        self.context_pre_only = context_pre_only

        self.norm1 = SD35AdaLayerNormZeroX(dim) if use_dual_attention else AdaLayerNormZero(dim)
        if context_pre_only:
            self.norm1_context = AdaLayerNormContinuous(dim, dim, elementwise_affine=False, eps=1e-6, bias=True)
        else:
            self.norm1_context = AdaLayerNormZero(dim)
        self.attn = JointAttention(query_dim=dim, heads=num_attention_heads, dim_head=attention_head_dim,
                                   added_kv_proj_dim=dim, context_pre_only=context_pre_only, qk_norm=qk_norm,
                                   out_dim=dim)
        if use_dual_attention:
            self.attn2 = JointAttention(query_dim=dim, heads=num_attention_heads, dim_head=attention_head_dim,
                                        qk_norm=qk_norm, out_dim=dim)
        self.norm2 = LayerNorm(dim, eps=1e-6, use_scale=False, use_bias=False)
        self.ff = FeedForward(dim=dim, dim_out=dim, activation_fn="gelu-approximate")
        if not context_pre_only:
            self.norm2_context = LayerNorm(dim, eps=1e-6, use_scale=False, use_bias=False)
            self.ff_context = FeedForward(dim=dim, dim_out=dim, activation_fn="gelu-approximate")

    def forward(self, hidden_states, encoder_hidden_states, temb, pab=None):
        """(hidden, context or None on a `context_pre_only` block).
        `pab=(compute, cached)`: on a step that does not compute, the dict
        `cached` ("attn", "ctx" unless context_pre_only, "attn2" on a dual
        block) stands in for the attention outputs; the dict in use is then
        returned third. A skipped block (`layer_skip`) returns its inputs."""
        if self.layer_skip:
            return (hidden_states, encoder_hidden_states) + ((pab[1],) if pab is not None else ())
        if self.use_dual_attention:
            norm_hidden, gate_msa, shift_mlp, scale_mlp, gate_mlp, norm_hidden2, gate_msa2 = self.norm1(
                hidden_states, emb=temb)
        else:
            norm_hidden, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.norm1(hidden_states, emb=temb)
        if self.context_pre_only:
            norm_context = self.norm1_context(encoder_hidden_states, temb)
        else:
            norm_context, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = self.norm1_context(
                encoder_hidden_states, emb=temb)

        if pab is None or pab[0]:
            attn_output, context_attn_output = self.attn(norm_hidden, norm_context)
            entry = {"attn": attn_output}
            if not self.context_pre_only:
                entry["ctx"] = context_attn_output
            if self.use_dual_attention:
                entry["attn2"] = self.attn2(norm_hidden2)
        else:
            entry = pab[1]
        hidden_states = hidden_states + gate_msa[:, None] * entry["attn"]
        if self.use_dual_attention:
            hidden_states = hidden_states + gate_msa2[:, None] * entry["attn2"]
        norm_hidden = self.norm2(hidden_states) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
        hidden_states = hidden_states + gate_mlp[:, None] * self.ff(norm_hidden)

        if self.context_pre_only:
            encoder_hidden_states = None
        else:
            encoder_hidden_states = encoder_hidden_states + c_gate_msa[:, None] * entry["ctx"]
            norm_context = self.norm2_context(encoder_hidden_states) * (1 + c_scale_mlp[:, None]) + c_shift_mlp[:, None]
            encoder_hidden_states = encoder_hidden_states + c_gate_mlp[:, None] * self.ff_context(norm_context)
        if pab is not None:
            return hidden_states, encoder_hidden_states, entry
        return hidden_states, encoder_hidden_states


class SD3Transformer2DModel(ModelMixin, ConfigMixin):
    # upstream checkpoints hold the full sin-cos table as a persistent buffer;
    # the port derives the crops it needs from the config (`check_derived_tensor`)
    _derived_keys = ("pos_embed.pos_embed",)

    @register_to_config
    def __init__(
        self,
        sample_size: int = 128,
        patch_size: int = 2,
        in_channels: int = 16,
        num_layers: int = 18,
        attention_head_dim: int = 64,
        num_attention_heads: int = 18,
        joint_attention_dim: int = 4096,
        caption_projection_dim: int = 1152,
        pooled_projection_dim: int = 2048,
        out_channels: int = 16,
        pos_embed_max_size: int = 96,
        dual_attention_layers: Tuple[int, ...] = (),
        qk_norm: Optional[str] = None,
    ):
        super().__init__()
        self.out_channels = out_channels if out_channels is not None else in_channels
        self.inner_dim = num_attention_heads * attention_head_dim

        self.pos_embed = PatchEmbed(height=sample_size, width=sample_size, patch_size=patch_size,
                                    in_channels=in_channels, embed_dim=self.inner_dim,
                                    pos_embed_max_size=pos_embed_max_size)
        self.time_text_embed = CombinedTimestepTextProjEmbeddings(embedding_dim=self.inner_dim,
                                                                  pooled_projection_dim=pooled_projection_dim)
        self.context_embedder = Linear(joint_attention_dim, caption_projection_dim)
        self.transformer_blocks = nn.ModuleList([
            JointTransformerBlock(dim=self.inner_dim, num_attention_heads=num_attention_heads,
                                  attention_head_dim=attention_head_dim, context_pre_only=(i == num_layers - 1),
                                  qk_norm=qk_norm, use_dual_attention=(i in dual_attention_layers))
            for i in range(num_layers)
        ])
        self.norm_out = AdaLayerNormContinuous(self.inner_dim, self.inner_dim, elementwise_affine=False, eps=1e-6)
        self.proj_out = Linear(self.inner_dim, patch_size * patch_size * self.out_channels, use_bias=True)

    def check_derived_tensor(self, key: str, tensor: torch.Tensor) -> None:
        """`pos_embed.pos_embed` of an upstream checkpoint: the full [1, m², D]
        sin-cos table of `pos_embed_max_size` m. Its shape must match the
        config and its values the table the port computes (within 1e-6: upstream
        may take sin and cos from torch rather than numpy), checked in slabs of
        16 grid rows; the tensor itself is not kept."""
        pe, m = self.pos_embed, self.config.pos_embed_max_size
        if key != "pos_embed.pos_embed" or m is None:
            raise ValueError(f"{type(self).__name__}: {key} is not a derived tensor of this config")
        if tuple(tensor.shape) != (1, m * m, self.inner_dim):
            raise ValueError(f"{type(self).__name__}: {key} has shape {tuple(tensor.shape)}, the config "
                             f"(pos_embed_max_size {m}, {self.inner_dim} wide) gives {(1, m * m, self.inner_dim)}")
        table = tensor.reshape(m, m, self.inner_dim).float()
        for top in range(0, m, 16):
            rows = min(16, m - top)
            ref = torch.from_numpy(get_2d_sincos_pos_embed(pe.embed_dim, m, pe.base_size, pe.interpolation_scale,
                                                           crop=(top, 0, rows, m)))
            err = float((table[top:top + rows].reshape(-1, self.inner_dim) - ref).abs().max())
            if not err <= 1e-6:
                raise ValueError(f"{type(self).__name__}: {key} differs from the sin-cos table of this config by "
                                 f"{err:.3e} in grid rows {top}-{top + rows - 1}")

    def embed(self, hidden_states, encoder_hidden_states, pooled_projections, timestep, context=None):
        """The prologue: (hidden [B, N, D], context, temb). `context`, when
        given, is `context_embedder(encoder_hidden_states)` computed by the
        caller (it is loop-invariant: TextKVCacheConfig)."""
        hidden = self.pos_embed(hidden_states)
        temb = self.time_text_embed(timestep, pooled_projections)
        if context is None:
            context = self.context_embedder(encoder_hidden_states)
        return hidden, context, temb

    def run_blocks(self, hidden_states, context, temb, first: int = 0,
                   block_controlnet_hidden_states: Optional[List[torch.Tensor]] = None):
        """The blocks from index `first`: the final hidden stream."""
        for i in range(first, len(self.transformer_blocks)):
            hidden_states, new_context = self.transformer_blocks[i](hidden_states, context, temb)
            if new_context is not None:
                context = new_context
            hidden_states = self._add_controlnet_residual(i, hidden_states, block_controlnet_hidden_states)
        return hidden_states

    def _add_controlnet_residual(self, i: int, hidden_states, residuals):
        """Block i's ControlNet residual (none after the last block), picked
        with JAX's float `interval` and `int(i / interval)`."""
        if residuals is None or self.transformer_blocks[i].context_pre_only:
            return hidden_states
        interval = len(self.transformer_blocks) / len(residuals)
        return hidden_states + residuals[int(i / interval)]

    def project_out(self, hidden_states, temb, height: int, width: int):
        """The epilogue: `norm_out`, `proj_out` and the unpatchify
        (`bhwpqc->bchpwq`) to [B, C, height, width]."""
        p = self.config.patch_size
        hidden_states = self.proj_out(self.norm_out(hidden_states, temb))
        b, h, w = hidden_states.shape[0], height // p, width // p
        hidden_states = hidden_states.reshape(b, h, w, p, p, self.out_channels).permute(0, 5, 1, 3, 2, 4)
        return hidden_states.reshape(b, self.out_channels, h * p, w * p)

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, C, H, W]
        encoder_hidden_states: torch.Tensor,  # [B, S, joint_attention_dim]
        pooled_projections: torch.Tensor,  # [B, pooled_projection_dim]
        timestep: torch.Tensor,  # [B], on the 0-1000 scale
        block_controlnet_hidden_states: Optional[List[torch.Tensor]] = None,
        fbc_state=None,  # FBCSingleState (hooks/first_block_cache.py)
        fbc_config=None,
        pab_compute: Optional[bool] = None,  # PAB: recompute attention this step?
        pab_cache: Optional[dict] = None,  # per-block attention outputs (init_pab_cache)
        context: Optional[torch.Tensor] = None,  # context_embedder(encoder_hidden_states), if the caller has it
        return_dict: bool = True,
    ) -> Union[Transformer2DModelOutput, tuple]:
        height, width = hidden_states.shape[-2], hidden_states.shape[-1]
        hidden, context, temb = self.embed(hidden_states, encoder_hidden_states, pooled_projections, timestep,
                                           context)
        extra = None
        if fbc_state is not None:
            first_in = hidden
            hidden, new_context = self.transformer_blocks[0](hidden, context, temb)
            context = new_context if new_context is not None else context
            hidden, extra = fbc_single_gate(fbc_state, fbc_config, hidden - first_in, hidden,
                                            lambda h: self.run_blocks(h, context, temb, first=1))
        elif pab_cache is not None:
            extra = {}
            for i, block in enumerate(self.transformer_blocks):
                hidden, new_context, extra[i] = block(hidden, context, temb, pab=(pab_compute, pab_cache[i]))
                if new_context is not None:
                    context = new_context
                hidden = self._add_controlnet_residual(i, hidden, block_controlnet_hidden_states)
        else:
            hidden = self.run_blocks(hidden, context, temb, block_controlnet_hidden_states=block_controlnet_hidden_states)

        output = self.project_out(hidden, temb, height, width)
        if extra is not None:  # the cache's new state beside the sample
            return (output, extra) if not return_dict else (Transformer2DModelOutput(sample=output), extra)
        if not return_dict:
            return (output,)
        return Transformer2DModelOutput(sample=output)

    def init_pab_cache(self, batch_size: int, image_tokens: int, text_tokens: int, dtype=torch.float32,
                       device=None) -> dict:
        """Zero per-block attention outputs for PAB (the first step always
        computes, so the zeros are never read)."""
        def zeros(n):
            return torch.zeros((batch_size, n, self.inner_dim), dtype=dtype, device=device)

        cache = {}
        for i, block in enumerate(self.transformer_blocks):
            cache[i] = {"attn": zeros(image_tokens)}
            if not block.context_pre_only:
                cache[i]["ctx"] = zeros(text_tokens)
            if block.use_dual_attention:
                cache[i]["attn2"] = zeros(image_tokens)
        return cache


"""Attention module.

Port of `diffusers_tpu/models/attention.py` (`Attention` `:22-195`) with
its IP-Adapter branch (`:176-188`) and the two perturbation flags of the
guiders (`:108-153`). Submodule names (to_q/to_k/to_v/to_out.0/group_norm/
norm_cross) match the reference state-dict keys.

`pag_identity` (Perturbed-Attention Guidance): a self-attention call uses
the identity attention map, so it returns ``to_out(to_v(x))`` after the
group norm, with the residual and `rescale_output_factor` applied and no
IP-Adapter branch. `seg_blur_sigma` (Smoothed Energy Guidance): a
self-attention call blurs its queries over the token grid
(`guiders.smoothed_energy_guidance.seg_gaussian_blur_2d`) before attending.
Both are plain attributes, read on every call; the guiders' context managers
(`pag_perturbed`, `seg_blurred`) set and clear them.

IP-Adapter: `loaders.ip_adapter.load_ip_adapter` gives a cross attention
`to_k_ip` / `to_v_ip` (one bias-free Linear per adapter) and
`ip_adapter_scale`; a call with `ip_hidden_states` (one [B, images, tokens,
D] tensor per adapter) adds ``scale * attention(q, to_k_ip(ip),
to_v_ip(ip))`` for each adapter whose scale is not 0. JAX pins that
attention to ``backend="native"``; the port routes it by the automatic rule,
so on the card its 64- and 128-wide heads run kernel K1 (ROADMAP C3). `text_kv` is the slot of `hooks.generic_cache.text_kv_cache`
(TextKVCacheConfig): while it is not None, the K/V projections of an
`encoder_hidden_states` tensor are computed once and reused for as long as
the module is called with that same tensor.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..guiders.smoothed_energy_guidance import seg_gaussian_blur_2d, seg_kernel_size
from ..ops.attention import dispatch_attention_fn
from ..ops.module import GroupNorm, LayerNorm, Linear


class Attention(nn.Module):
    """Multi-head attention over [B, S, C] hidden states (self or cross)."""

    pag_identity: bool = False
    seg_blur_sigma: Optional[float] = None

    def __init__(
        self,
        query_dim: int,
        cross_attention_dim: Optional[int] = None,
        heads: int = 8,
        dim_head: int = 64,
        bias: bool = False,
        cross_attention_norm: Optional[str] = None,
        norm_num_groups: Optional[int] = None,
        out_bias: bool = True,
        scale_qk: bool = True,
        eps: float = 1e-5,
        rescale_output_factor: float = 1.0,
        residual_connection: bool = False,
        out_dim: Optional[int] = None,
        pre_only: bool = False,
        kv_heads: Optional[int] = None,
    ):
        super().__init__()
        self.inner_dim = out_dim if out_dim is not None else dim_head * heads
        self.inner_kv_dim = self.inner_dim if kv_heads is None else dim_head * kv_heads
        self.query_dim = query_dim
        self.cross_attention_dim = cross_attention_dim if cross_attention_dim is not None else query_dim
        self.heads = out_dim // dim_head if out_dim is not None else heads
        self.dim_head = dim_head
        self.scale = dim_head**-0.5 if scale_qk else 1.0
        self.rescale_output_factor = rescale_output_factor
        self.residual_connection = residual_connection
        self.out_dim = out_dim if out_dim is not None else query_dim
        self.pre_only = pre_only

        if norm_num_groups is not None:
            self.group_norm = GroupNorm(num_groups=norm_num_groups, num_channels=query_dim, eps=eps, affine=True)
        else:
            self.group_norm = None

        if cross_attention_norm == "layer_norm":
            self.norm_cross = LayerNorm(self.cross_attention_dim)
        elif cross_attention_norm is None:
            self.norm_cross = None
        else:
            raise NotImplementedError(f"cross_attention_norm {cross_attention_norm!r} is not ported yet")

        self.to_q = Linear(query_dim, self.inner_dim, use_bias=bias)
        self.to_k = Linear(self.cross_attention_dim, self.inner_kv_dim, use_bias=bias)
        self.to_v = Linear(self.cross_attention_dim, self.inner_kv_dim, use_bias=bias)
        if not pre_only:
            self.to_out = nn.ModuleList([Linear(self.inner_dim, self.out_dim, use_bias=out_bias)])
        self.text_kv = None
        self.to_k_ip = self.to_v_ip = None
        self.ip_adapter_scale = None

    def _cross_kv(self, encoder_hidden_states: torch.Tensor):
        if self.text_kv and self.text_kv[0] is encoder_hidden_states:
            return self.text_kv[1:]
        context = encoder_hidden_states if self.norm_cross is None else self.norm_cross(encoder_hidden_states)
        key, value = self.to_k(context), self.to_v(context)
        if self.text_kv is not None:
            self.text_kv = (encoder_hidden_states, key, value)
        return key, value

    def forward(
        self,
        hidden_states: torch.Tensor,
        encoder_hidden_states: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        ip_hidden_states: Optional[List[torch.Tensor]] = None,
    ) -> torch.Tensor:
        residual = hidden_states
        b, s, _ = hidden_states.shape

        if self.group_norm is not None:
            # GroupNorm normalizes the channel axis: tokens [B, S, C] -> [B, C, S]
            hidden_states = self.group_norm(hidden_states.transpose(1, 2)).transpose(1, 2)

        if self.pag_identity and encoder_hidden_states is None:
            out = self.to_out[0](self.to_v(hidden_states))  # the identity attention map: the output is V
            if self.residual_connection:
                out = out + residual
            return out / self.rescale_output_factor

        query = self.to_q(hidden_states)
        if self.seg_blur_sigma is not None and encoder_hidden_states is None:
            query = seg_gaussian_blur_2d(query, seg_kernel_size(self.seg_blur_sigma), self.seg_blur_sigma)
        if encoder_hidden_states is None:
            key, value = self.to_k(hidden_states), self.to_v(hidden_states)
        else:
            key, value = self._cross_kv(encoder_hidden_states)

        query = query.reshape(b, s, self.heads, self.dim_head)
        kv_heads = key.shape[-1] // self.dim_head
        key = key.reshape(b, -1, kv_heads, self.dim_head)
        value = value.reshape(b, -1, kv_heads, self.dim_head)
        if kv_heads != self.heads:
            key = key.repeat_interleave(self.heads // kv_heads, dim=2)
            value = value.repeat_interleave(self.heads // kv_heads, dim=2)

        attn = dispatch_attention_fn(query, key, value, attn_mask=attention_mask, scale=self.scale)
        attn = attn.reshape(b, s, self.heads * self.dim_head)
        if ip_hidden_states is not None and self.to_k_ip is not None:
            scales = self.ip_adapter_scale or [1.0] * len(ip_hidden_states)
            for i, ip in enumerate(ip_hidden_states):
                if scales[i] == 0:
                    continue
                ip = ip.reshape(b, -1, ip.shape[-1])  # [B, images x tokens, D]
                ip_key = self.to_k_ip[i](ip).reshape(b, -1, self.heads, self.dim_head)
                ip_value = self.to_v_ip[i](ip).reshape(b, -1, self.heads, self.dim_head)
                ip_attn = dispatch_attention_fn(query, ip_key, ip_value, scale=self.scale)
                attn = attn + scales[i] * ip_attn.reshape(b, s, self.heads * self.dim_head)
        if self.pre_only:
            return attn

        out = self.to_out[0](attn)
        if self.residual_connection:
            out = out + residual
        return out / self.rescale_output_factor

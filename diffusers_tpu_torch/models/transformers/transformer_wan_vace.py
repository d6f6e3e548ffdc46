"""WanVACETransformer3DModel: Wan with the VACE control branch.

Port of `diffusers_tpu/models/transformers/transformer_wan_vace.py`
(`WanVACETransformerBlock` `:39`, `WanVACETransformer3DModel` `:108`): a
parallel stack of VACE blocks runs over the control tokens first (block 0
adds the main stream through `proj_in`; every block emits a `proj_out`
"hint"), then the Wan blocks run and the block at each index of
`vace_layers` adds its hint times that layer's `control_hidden_states_scale`
(`:219-225`). The control latents are patchified by their own `Conv3d` and
zero-padded to the main token count (`:199-201`). A VACE block's body is a
Wan block's (the 3-D modulation path), so on the card each block runs K1
twice: Wan2.1-VACE-1.3B's 30 + 15 blocks make 90 launches a call.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...ops.module import Conv3d, LayerNorm, Linear
from ..modeling_utils import ModelMixin
from .transformer_wan import (
    Transformer3DModelOutput,
    WanRotaryMixin,
    WanRotaryPosEmbed,
    WanTimeTextImageEmbedding,
    WanTransformerBlock,
    wan_output,
)


class WanVACETransformerBlock(WanTransformerBlock):
    """A Wan block over the control stream, with `proj_in` (block 0: the
    control tokens plus the main stream) and `proj_out` (the hint)."""

    def __init__(self, dim: int, ffn_dim: int, num_heads: int, qk_norm: str = "rms_norm_across_heads",
                 cross_attn_norm: bool = False, eps: float = 1e-6, added_kv_proj_dim: Optional[int] = None,
                 apply_input_projection: bool = False, apply_output_projection: bool = False):
        super().__init__(dim, ffn_dim, num_heads, qk_norm, cross_attn_norm, eps, added_kv_proj_dim)
        self.proj_in = Linear(dim, dim) if apply_input_projection else None
        self.proj_out = Linear(dim, dim) if apply_output_projection else None

    def forward(self, hidden_states, encoder_hidden_states, control_hidden_states, temb, rotary_emb):
        """(the hint or None, the new control stream)."""
        if self.proj_in is not None:
            control_hidden_states = self.proj_in(control_hidden_states) + hidden_states
        control_hidden_states = super().forward(control_hidden_states, encoder_hidden_states, temb, rotary_emb)
        hint = self.proj_out(control_hidden_states) if self.proj_out is not None else None
        return hint, control_hidden_states


class WanVACETransformer3DModel(WanRotaryMixin, ModelMixin, ConfigMixin):
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
        vace_layers: List[int] = (0, 5, 10, 15, 20, 25, 30, 35),
        vace_in_channels: int = 96,
    ):
        super().__init__()
        if 0 not in vace_layers:
            raise ValueError("VACE layers must include layer 0.")
        patch_size = tuple(patch_size)
        self.inner_dim = inner_dim = num_attention_heads * attention_head_dim
        self.out_channels = out_channels or in_channels
        self.vace_layers = tuple(vace_layers)
        self.rope = WanRotaryPosEmbed(attention_head_dim, patch_size, rope_max_seq_len)
        self.patch_embedding = Conv3d(in_channels, inner_dim, kernel_size=patch_size, stride=patch_size)
        self.vace_patch_embedding = Conv3d(vace_in_channels, inner_dim, kernel_size=patch_size, stride=patch_size)
        self.condition_embedder = WanTimeTextImageEmbedding(
            dim=inner_dim, time_freq_dim=freq_dim, time_proj_dim=inner_dim * 6, text_embed_dim=text_dim,
            image_embed_dim=image_dim, pos_embed_seq_len=pos_embed_seq_len)
        self.blocks = nn.ModuleList([
            WanTransformerBlock(inner_dim, ffn_dim, num_attention_heads, qk_norm, cross_attn_norm, eps,
                                added_kv_proj_dim)
            for _ in range(num_layers)
        ])
        self.vace_blocks = nn.ModuleList([
            WanVACETransformerBlock(inner_dim, ffn_dim, num_attention_heads, qk_norm, cross_attn_norm, eps,
                                    added_kv_proj_dim, apply_input_projection=i == 0, apply_output_projection=True)
            for i in range(len(vace_layers))
        ])
        self.norm_out = LayerNorm(inner_dim, eps=eps, use_scale=False, use_bias=False)
        self.proj_out = Linear(inner_dim, self.out_channels * math.prod(patch_size))
        self.scale_shift_table = nn.Parameter(torch.randn(1, 2, inner_dim) / inner_dim**0.5)

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, C, F, H, W]
        timestep: torch.Tensor,  # [B]
        encoder_hidden_states: torch.Tensor,  # [B, S, text_dim]
        encoder_hidden_states_image: Optional[torch.Tensor] = None,
        control_hidden_states: Optional[torch.Tensor] = None,  # [B, vace_in_channels, F', H, W]
        control_hidden_states_scale: Optional[Union[torch.Tensor, Sequence[float]]] = None,  # one per VACE layer
        rotary_emb: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        return_dict: bool = True,
    ) -> Union[Transformer3DModelOutput, tuple]:
        b, _, f, h, w = hidden_states.shape
        p_t, p_h, p_w = self.config.patch_size
        grid = (f // p_t, h // p_h, w // p_w)
        if control_hidden_states is None:
            raise ValueError("WanVACETransformer3DModel needs `control_hidden_states`")
        n_vace = len(self.vace_layers)
        if control_hidden_states_scale is None:
            control_hidden_states_scale = torch.ones(n_vace)
        scale = torch.as_tensor(control_hidden_states_scale, device=hidden_states.device)
        if scale.shape != (n_vace,):
            raise ValueError(f"control_hidden_states_scale must hold one scale per VACE layer ({n_vace}), "
                             f"got shape {tuple(scale.shape)}")
        if rotary_emb is None:
            rotary_emb = self.rotary_tables(hidden_states)

        x = self.patch_embedding(hidden_states).flatten(2).transpose(1, 2)  # [B, tokens, D], (f, h, w) order
        ctrl = self.vace_patch_embedding(control_hidden_states).flatten(2).transpose(1, 2)
        if ctrl.shape[1] < x.shape[1]:
            ctrl = F.pad(ctrl, (0, 0, 0, x.shape[1] - ctrl.shape[1]))
        temb, timestep_proj, text, image = self.condition_embedder(timestep, encoder_hidden_states,
                                                                   encoder_hidden_states_image)
        timestep_proj = timestep_proj.reshape(b, 6, -1)
        context = text if image is None else torch.cat([image, text], dim=1)

        hints = []
        for block in self.vace_blocks:
            hint, ctrl = block(x, context, ctrl, timestep_proj, rotary_emb)
            hints.append(hint)
        k = 0  # the k-th block in `vace_layers` takes the k-th hint, as in JAX
        for i, block in enumerate(self.blocks):
            x = block(x, context, timestep_proj, rotary_emb)
            if i in self.vace_layers:
                x = x + hints[k] * scale[k].to(x.dtype)
                k += 1

        output = wan_output(self, x, temb, grid)
        return Transformer3DModelOutput(sample=output) if return_dict else (output,)

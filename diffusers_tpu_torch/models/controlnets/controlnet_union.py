"""ControlNetUnionModel (SDXL, several control tasks in one net).

Port of `diffusers_tpu/models/controlnets/controlnet_union.py` (`:30-283`):
the trunk of `ControlNetModel`, plus the union's condition fusion. Each
active condition is embedded by the shared conditioning embedding; its
spatial mean plus its task's row of `task_embedding`, and the spatial mean
of the `conv_in` stream, go through a small transformer (upstream's
misspelt `transformer_layes`); each condition is added to the stream with
its token's `spatial_ch_projs` output as a per-channel offset. The 0/1
control-type mask is Fourier-embedded by `control_type_proj` (a
`Timesteps`) and added to the time embedding through
`control_add_embedding`. Only the first `conditioning_scale` applies, as in
JAX.

The transformer keeps `torch.nn.MultiheadAttention`'s parameter names
(`in_proj_weight` [3d, d], `in_proj_bias`, `out_proj`), so upstream
checkpoints load, and, like upstream, runs it sequence-first on a
batch-first [B, n + 1, C] tensor: it attends over the batch axis at each
token index (shipped checkpoints were trained that way). JAX computes that
attention by einsum inside the model, f32 logits over a few tokens at head
dim 40; the port mirrors it in plain torch (no kernel runs there on either
side). `task_embedding` starts as ``sqrt(C) * randn`` and `spatial_ch_projs`
at zero, as upstream's do.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...configuration_utils import register_to_config
from ...ops.module import LayerNorm, Linear
from ..embeddings import TimestepEmbedding, Timesteps
from .controlnet import ControlNetModel, ControlNetOutput


class TorchMultiheadAttention(nn.Module):
    """`torch.nn.MultiheadAttention`'s layout (packed q/k/v `in_proj_*`,
    `out_proj`) attending over axis 0 of an [S, B, C] input, by plain
    matmuls with f32 logits (JAX `:30-63`)."""

    def __init__(self, d_model: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, b, c = x.shape
        h, dh = self.n_head, c // self.n_head
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)

        def heads(t):  # [S, B, C] -> [B, H, S, Dh]
            return t.reshape(s, b, h, dh).permute(1, 2, 0, 3)

        q, k, v = heads(q), heads(k), heads(v)
        logits = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(dh)
        out = logits.softmax(dim=-1).to(x.dtype) @ v
        return self.out_proj(out.permute(2, 0, 1, 3).reshape(s, b, c))


class _ResidualAttentionMlp(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        self.c_fc = Linear(d_model, d_model * 4)
        self.c_proj = Linear(d_model * 4, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.c_fc(x)
        return self.c_proj(h * torch.sigmoid(1.702 * h))  # QuickGELU


class ResidualAttentionBlock(nn.Module):
    """Pre-LN attention and a QuickGELU MLP (JAX `:80-92`)."""

    def __init__(self, d_model: int, n_head: int):
        super().__init__()
        self.attn = TorchMultiheadAttention(d_model, n_head)
        self.ln_1 = LayerNorm(d_model)
        self.mlp = _ResidualAttentionMlp(d_model)
        self.ln_2 = LayerNorm(d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class ControlNetUnionModel(ControlNetModel):
    @register_to_config
    def __init__(
        self,
        in_channels: int = 4,
        conditioning_channels: int = 3,
        flip_sin_to_cos: bool = True,
        freq_shift: int = 0,
        down_block_types: Tuple[str, ...] = (
            "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D",
        ),
        only_cross_attention: bool = False,
        block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280),
        layers_per_block: int = 2,
        downsample_padding: int = 1,
        mid_block_scale_factor: float = 1,
        act_fn: str = "silu",
        norm_num_groups: Optional[int] = 32,
        norm_eps: float = 1e-5,
        cross_attention_dim: int = 1280,
        transformer_layers_per_block: Union[int, Tuple[int, ...]] = 1,
        attention_head_dim: Union[int, Tuple[int, ...]] = 8,
        num_attention_heads: Optional[Union[int, Tuple[int, ...]]] = None,
        use_linear_projection: bool = False,
        class_embed_type: Optional[str] = None,
        addition_embed_type: Optional[str] = None,
        addition_time_embed_dim: Optional[int] = None,
        projection_class_embeddings_input_dim: Optional[int] = None,
        controlnet_conditioning_channel_order: str = "rgb",
        conditioning_embedding_out_channels: Tuple[int, ...] = (16, 32, 96, 256),
        global_pool_conditions: bool = False,
        addition_embed_type_num_heads: int = 64,
        num_control_type: int = 6,
        num_trans_channel: int = 320,
        num_trans_head: int = 8,
        num_trans_layer: int = 1,
        num_proj_channel: int = 320,
    ):
        super().__init__(
            in_channels=in_channels, conditioning_channels=conditioning_channels, flip_sin_to_cos=flip_sin_to_cos,
            freq_shift=freq_shift, down_block_types=down_block_types, only_cross_attention=only_cross_attention,
            block_out_channels=block_out_channels, layers_per_block=layers_per_block,
            downsample_padding=downsample_padding, mid_block_scale_factor=mid_block_scale_factor, act_fn=act_fn,
            norm_num_groups=norm_num_groups, norm_eps=norm_eps, cross_attention_dim=cross_attention_dim,
            transformer_layers_per_block=transformer_layers_per_block, attention_head_dim=attention_head_dim,
            num_attention_heads=num_attention_heads, use_linear_projection=use_linear_projection,
            class_embed_type=class_embed_type, addition_embed_type=addition_embed_type,
            addition_time_embed_dim=addition_time_embed_dim,
            projection_class_embeddings_input_dim=projection_class_embeddings_input_dim,
            controlnet_conditioning_channel_order=controlnet_conditioning_channel_order,
            conditioning_embedding_out_channels=conditioning_embedding_out_channels,
            global_pool_conditions=global_pool_conditions,
            addition_embed_type_num_heads=addition_embed_type_num_heads,
        )
        self.task_embedding = nn.Parameter(math.sqrt(num_trans_channel)
                                           * torch.randn(num_control_type, num_trans_channel))
        self.transformer_layes = nn.ModuleList(
            [ResidualAttentionBlock(num_trans_channel, num_trans_head) for _ in range(num_trans_layer)])
        self.spatial_ch_projs = Linear(num_trans_channel, num_proj_channel)
        nn.init.zeros_(self.spatial_ch_projs.weight)
        nn.init.zeros_(self.spatial_ch_projs.bias)
        self.control_type_proj = Timesteps(addition_time_embed_dim, flip_sin_to_cos, freq_shift)
        self.control_add_embedding = TimestepEmbedding(addition_time_embed_dim * num_control_type,
                                                       block_out_channels[0] * 4)

    def forward(
        self,
        sample: torch.Tensor,  # [B, C, H, W] latents
        timestep,
        encoder_hidden_states: torch.Tensor,
        controlnet_cond: Union[torch.Tensor, Sequence[torch.Tensor]],  # one [B, 3, H f, W f] image an active task
        control_type: torch.Tensor,  # [B, num_control_type] 0/1 mask of the active tasks
        control_type_idx: Sequence[int],  # the active tasks' indices, aligned with `controlnet_cond`
        conditioning_scale: Union[float, List[float]] = 1.0,
        added_cond_kwargs: Optional[dict] = None,
        guess_mode: bool = False,
        return_dict: bool = True,
    ) -> Union[ControlNetOutput, tuple]:
        if not isinstance(controlnet_cond, (list, tuple)):
            controlnet_cond = [controlnet_cond]
        if isinstance(conditioning_scale, (list, tuple)):
            conditioning_scale = conditioning_scale[0]

        emb = self._time_embedding(sample, timestep, added_cond_kwargs)
        control_embeds = self.control_type_proj(control_type.reshape(-1)).reshape(sample.shape[0], -1)
        emb = emb + self.control_add_embedding(control_embeds.to(emb.dtype))

        sample = self.conv_in(sample)
        tokens, conditions = [], []
        for cond, idx in zip(controlnet_cond, control_type_idx):
            if self.config.controlnet_conditioning_channel_order == "bgr":
                cond = torch.flip(cond, dims=[1])
            condition = self.controlnet_cond_embedding(cond)
            tokens.append(condition.mean(dim=(2, 3)) + self.task_embedding[idx])
            conditions.append(condition)
        tokens.append(sample.mean(dim=(2, 3)))
        x = torch.stack(tokens, dim=1)  # [B, n + 1, C], read sequence-first as upstream does
        for layer in self.transformer_layes:
            x = layer(x)

        fused = torch.zeros_like(sample)
        for i, condition in enumerate(conditions):
            fused = fused + condition + self.spatial_ch_projs(x[:, i])[:, :, None, None]
        return self._residuals(sample + fused, emb, encoder_hidden_states, conditioning_scale, guess_mode,
                               return_dict)

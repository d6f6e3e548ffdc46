"""UNet2D down/mid/up blocks.

Port of the SDXL-path classes of `diffusers_tpu/models/unets/unet_2d_blocks.py`
(`DownBlock2D`, `UNetMidBlock2D`, `UpBlock2D`, `get_down_block`,
`get_up_block`), on NCHW activations with spatial attention flattened to
``[B, H*W, C]``. The other blocks of that file wait. An up block with a
`freeu` dict (set by `UNet2DConditionModel.enable_freeu`) passes each
(backbone, skip) pair through `utils.freeu_utils.apply_freeu` before joining
them, as JAX `:277-283` does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...utils.freeu_utils import apply_freeu
from ..attention import Attention
from ..resnet import Downsample2D, ResnetBlock2D, Upsample2D


def _attend_spatial(attn: Attention, x: torch.Tensor) -> torch.Tensor:
    """Run token attention over an NCHW feature map."""
    b, c, h, w = x.shape
    out = attn(x.reshape(b, c, h * w).transpose(1, 2))
    return out.transpose(1, 2).reshape(b, c, h, w)


class DownBlock2D(nn.Module):
    has_cross_attention = False

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        temb_channels: int,
        num_layers: int = 1,
        resnet_eps: float = 1e-6,
        resnet_time_scale_shift: str = "default",
        resnet_act_fn: str = "swish",
        resnet_groups: int = 32,
        output_scale_factor: float = 1.0,
        add_downsample: bool = True,
        downsample_padding: int = 1,
    ):
        super().__init__()
        self.resnets = nn.ModuleList(
            [
                ResnetBlock2D(
                    in_channels=in_channels if i == 0 else out_channels,
                    out_channels=out_channels,
                    temb_channels=temb_channels,
                    eps=resnet_eps,
                    groups=resnet_groups,
                    time_embedding_norm=resnet_time_scale_shift,
                    non_linearity=resnet_act_fn,
                    output_scale_factor=output_scale_factor,
                )
                for i in range(num_layers)
            ]
        )
        self.add_downsample = add_downsample
        if add_downsample:
            self.downsamplers = nn.ModuleList(
                [Downsample2D(out_channels, use_conv=True, out_channels=out_channels, padding=downsample_padding)]
            )

    def forward(self, hidden_states: torch.Tensor, temb: Optional[torch.Tensor] = None):
        output_states = ()
        for resnet in self.resnets:
            hidden_states = resnet(hidden_states, temb)
            output_states += (hidden_states,)
        if self.add_downsample:
            hidden_states = self.downsamplers[0](hidden_states)
            output_states += (hidden_states,)
        return hidden_states, output_states


class UNetMidBlock2D(nn.Module):
    has_cross_attention = False

    def __init__(
        self,
        in_channels: int,
        temb_channels: Optional[int],
        num_layers: int = 1,
        resnet_eps: float = 1e-6,
        resnet_time_scale_shift: str = "default",
        resnet_act_fn: str = "swish",
        resnet_groups: int = 32,
        attn_groups: Optional[int] = None,
        add_attention: bool = True,
        attention_head_dim: int = 1,
        output_scale_factor: float = 1.0,
    ):
        super().__init__()
        resnet_groups = resnet_groups if resnet_groups is not None else min(in_channels // 4, 32)
        self.add_attention = add_attention
        if attn_groups is None:
            attn_groups = resnet_groups if resnet_time_scale_shift == "default" else None
        if attention_head_dim is None:
            attention_head_dim = in_channels

        def make_resnet():
            return ResnetBlock2D(
                in_channels=in_channels,
                out_channels=in_channels,
                temb_channels=temb_channels,
                eps=resnet_eps,
                groups=resnet_groups,
                time_embedding_norm=resnet_time_scale_shift,
                non_linearity=resnet_act_fn,
                output_scale_factor=output_scale_factor,
            )

        self.resnets = nn.ModuleList([make_resnet() for _ in range(num_layers + 1)])
        if add_attention:
            self.attentions = nn.ModuleList(
                [
                    Attention(
                        in_channels,
                        heads=in_channels // attention_head_dim,
                        dim_head=attention_head_dim,
                        rescale_output_factor=output_scale_factor,
                        eps=resnet_eps,
                        norm_num_groups=attn_groups,
                        residual_connection=True,
                        bias=True,
                    )
                    for _ in range(num_layers)
                ]
            )

    def forward(self, hidden_states: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        hidden_states = self.resnets[0](hidden_states, temb)
        for i in range(len(self.resnets) - 1):
            if self.add_attention:
                hidden_states = _attend_spatial(self.attentions[i], hidden_states)
            hidden_states = self.resnets[i + 1](hidden_states, temb)
        return hidden_states


class UpBlock2D(nn.Module):
    has_cross_attention = False
    freeu = None  # FreeU's factors and this block's index, set by UNet2DConditionModel.enable_freeu
    resolution_idx = None

    def __init__(
        self,
        in_channels: int,
        prev_output_channel: int,
        out_channels: int,
        temb_channels: int,
        num_layers: int = 1,
        resnet_eps: float = 1e-6,
        resnet_time_scale_shift: str = "default",
        resnet_act_fn: str = "swish",
        resnet_groups: int = 32,
        output_scale_factor: float = 1.0,
        add_upsample: bool = True,
    ):
        super().__init__()
        resnets = []
        for i in range(num_layers):
            res_skip_channels = in_channels if (i == num_layers - 1) else out_channels
            resnet_in_channels = prev_output_channel if i == 0 else out_channels
            resnets.append(
                ResnetBlock2D(
                    in_channels=resnet_in_channels + res_skip_channels,
                    out_channels=out_channels,
                    temb_channels=temb_channels,
                    eps=resnet_eps,
                    groups=resnet_groups,
                    time_embedding_norm=resnet_time_scale_shift,
                    non_linearity=resnet_act_fn,
                    output_scale_factor=output_scale_factor,
                )
            )
        self.resnets = nn.ModuleList(resnets)
        self.add_upsample = add_upsample
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(out_channels, use_conv=True, out_channels=out_channels)])

    def forward(self, hidden_states: torch.Tensor, res_hidden_states_tuple, temb=None) -> torch.Tensor:
        for resnet in self.resnets:
            res_hidden_states = res_hidden_states_tuple[-1]
            res_hidden_states_tuple = res_hidden_states_tuple[:-1]
            if self.freeu is not None:
                hidden_states, res_hidden_states = apply_freeu(self.resolution_idx, hidden_states, res_hidden_states,
                                                               self.freeu)
            hidden_states = torch.cat([hidden_states, res_hidden_states], dim=1)
            hidden_states = resnet(hidden_states, temb)
        if self.add_upsample:
            hidden_states = self.upsamplers[0](hidden_states)
        return hidden_states


def get_down_block(
    down_block_type: str,
    num_layers: int,
    in_channels: int,
    out_channels: int,
    temb_channels: int,
    add_downsample: bool,
    resnet_eps: float,
    resnet_act_fn: str,
    resnet_groups: Optional[int] = None,
    downsample_padding: Optional[int] = None,
    resnet_time_scale_shift: str = "default",
    cross_attention_dim: Optional[int] = None,
    num_attention_heads: Optional[int] = None,
    transformer_layers_per_block: int = 1,
    use_linear_projection: bool = False,
    **kwargs,
):
    if down_block_type == "DownBlock2D":
        return DownBlock2D(
            num_layers=num_layers,
            in_channels=in_channels,
            out_channels=out_channels,
            temb_channels=temb_channels,
            add_downsample=add_downsample,
            resnet_eps=resnet_eps,
            resnet_act_fn=resnet_act_fn,
            resnet_groups=resnet_groups or 32,
            downsample_padding=downsample_padding if downsample_padding is not None else 1,
            resnet_time_scale_shift=resnet_time_scale_shift,
        )
    if down_block_type == "CrossAttnDownBlock2D":
        from .unet_2d_condition_blocks import CrossAttnDownBlock2D

        return CrossAttnDownBlock2D(
            num_layers=num_layers,
            in_channels=in_channels,
            out_channels=out_channels,
            temb_channels=temb_channels,
            add_downsample=add_downsample,
            resnet_eps=resnet_eps,
            resnet_act_fn=resnet_act_fn,
            resnet_groups=resnet_groups or 32,
            cross_attention_dim=cross_attention_dim,
            num_attention_heads=num_attention_heads,
            transformer_layers_per_block=transformer_layers_per_block,
            use_linear_projection=use_linear_projection,
            downsample_padding=downsample_padding if downsample_padding is not None else 1,
            resnet_time_scale_shift=resnet_time_scale_shift,
        )
    raise ValueError(f"unsupported down_block_type {down_block_type}")


def get_up_block(
    up_block_type: str,
    num_layers: int,
    in_channels: int,
    out_channels: int,
    prev_output_channel: int,
    temb_channels: int,
    add_upsample: bool,
    resnet_eps: float,
    resnet_act_fn: str,
    resnet_groups: Optional[int] = None,
    resnet_time_scale_shift: str = "default",
    cross_attention_dim: Optional[int] = None,
    num_attention_heads: Optional[int] = None,
    transformer_layers_per_block: int = 1,
    use_linear_projection: bool = False,
    **kwargs,
):
    if up_block_type == "UpBlock2D":
        return UpBlock2D(
            num_layers=num_layers,
            in_channels=in_channels,
            out_channels=out_channels,
            prev_output_channel=prev_output_channel,
            temb_channels=temb_channels,
            add_upsample=add_upsample,
            resnet_eps=resnet_eps,
            resnet_act_fn=resnet_act_fn,
            resnet_groups=resnet_groups or 32,
            resnet_time_scale_shift=resnet_time_scale_shift,
        )
    if up_block_type == "CrossAttnUpBlock2D":
        from .unet_2d_condition_blocks import CrossAttnUpBlock2D

        return CrossAttnUpBlock2D(
            num_layers=num_layers,
            in_channels=in_channels,
            out_channels=out_channels,
            prev_output_channel=prev_output_channel,
            temb_channels=temb_channels,
            add_upsample=add_upsample,
            resnet_eps=resnet_eps,
            resnet_act_fn=resnet_act_fn,
            resnet_groups=resnet_groups or 32,
            cross_attention_dim=cross_attention_dim,
            num_attention_heads=num_attention_heads,
            transformer_layers_per_block=transformer_layers_per_block,
            use_linear_projection=use_linear_projection,
            resnet_time_scale_shift=resnet_time_scale_shift,
        )
    raise ValueError(f"unsupported up_block_type {up_block_type}")

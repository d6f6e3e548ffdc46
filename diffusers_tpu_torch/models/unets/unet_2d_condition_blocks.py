"""Cross-attention UNet blocks (SD/SDXL).

Port of `diffusers_tpu/models/unets/unet_2d_condition_blocks.py`
(`CrossAttnDownBlock2D`, `UNetMidBlock2DCrossAttn`, `CrossAttnUpBlock2D`), on
NCHW activations; `CrossAttnDownBlock2D` adds a T2I-Adapter feature
(`additional_residual`) after its last (resnet, attention) pair, as JAX
`:106-110` does. FreeU waits for its utilities.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..resnet import Downsample2D, ResnetBlock2D, Upsample2D
from ..transformers.transformer_2d import Transformer2DModel


def _per_layer(value, num_layers):
    if isinstance(value, (list, tuple)):
        return list(value)
    return [value] * num_layers


class CrossAttnDownBlock2D(nn.Module):
    has_cross_attention = True

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        temb_channels: int,
        num_layers: int = 1,
        transformer_layers_per_block: Union[int, Tuple[int, ...]] = 1,
        resnet_eps: float = 1e-6,
        resnet_time_scale_shift: str = "default",
        resnet_act_fn: str = "swish",
        resnet_groups: int = 32,
        num_attention_heads: int = 1,
        cross_attention_dim: int = 1280,
        output_scale_factor: float = 1.0,
        downsample_padding: int = 1,
        add_downsample: bool = True,
        use_linear_projection: bool = False,
        only_cross_attention: bool = False,
    ):
        super().__init__()
        tl = _per_layer(transformer_layers_per_block, num_layers)
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
        self.attentions = nn.ModuleList(
            [
                Transformer2DModel(
                    num_attention_heads,
                    out_channels // num_attention_heads,
                    in_channels=out_channels,
                    num_layers=tl[i],
                    cross_attention_dim=cross_attention_dim,
                    norm_num_groups=resnet_groups,
                    use_linear_projection=use_linear_projection,
                    only_cross_attention=only_cross_attention,
                )
                for i in range(num_layers)
            ]
        )
        self.add_downsample = add_downsample
        if add_downsample:
            self.downsamplers = nn.ModuleList(
                [Downsample2D(out_channels, use_conv=True, out_channels=out_channels, padding=downsample_padding)]
            )

    def forward(
        self,
        hidden_states: torch.Tensor,
        temb: Optional[torch.Tensor] = None,
        encoder_hidden_states: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        encoder_attention_mask: Optional[torch.Tensor] = None,
        additional_residual: Optional[torch.Tensor] = None,
    ):
        output_states = ()
        n = len(self.resnets)
        for i, (resnet, attn) in enumerate(zip(self.resnets, self.attentions)):
            hidden_states = resnet(hidden_states, temb)
            hidden_states = attn(
                hidden_states,
                encoder_hidden_states=encoder_hidden_states,
                attention_mask=attention_mask,
                encoder_attention_mask=encoder_attention_mask,
            )
            if i == n - 1 and additional_residual is not None:
                hidden_states = hidden_states + additional_residual
            output_states += (hidden_states,)
        if self.add_downsample:
            hidden_states = self.downsamplers[0](hidden_states)
            output_states += (hidden_states,)
        return hidden_states, output_states


class UNetMidBlock2DCrossAttn(nn.Module):
    has_cross_attention = True

    def __init__(
        self,
        in_channels: int,
        temb_channels: int,
        num_layers: int = 1,
        transformer_layers_per_block: Union[int, Tuple[int, ...]] = 1,
        resnet_eps: float = 1e-6,
        resnet_time_scale_shift: str = "default",
        resnet_act_fn: str = "swish",
        resnet_groups: int = 32,
        resnet_groups_out: Optional[int] = None,
        num_attention_heads: int = 1,
        cross_attention_dim: int = 1280,
        output_scale_factor: float = 1.0,
        use_linear_projection: bool = False,
        out_channels: Optional[int] = None,
    ):
        super().__init__()
        tl = _per_layer(transformer_layers_per_block, num_layers)
        # out_channels defaults to in_channels; only the first resnet changes
        # the channel count
        out_channels = out_channels or in_channels
        resnet_groups_out = resnet_groups_out or resnet_groups

        def make_resnet(first: bool):
            return ResnetBlock2D(
                in_channels=in_channels if first else out_channels,
                out_channels=out_channels,
                temb_channels=temb_channels,
                eps=resnet_eps,
                groups=resnet_groups if first else resnet_groups_out,
                groups_out=resnet_groups_out,
                time_embedding_norm=resnet_time_scale_shift,
                non_linearity=resnet_act_fn,
                output_scale_factor=output_scale_factor,
            )

        self.resnets = nn.ModuleList([make_resnet(i == 0) for i in range(num_layers + 1)])
        self.attentions = nn.ModuleList(
            [
                Transformer2DModel(
                    num_attention_heads,
                    out_channels // num_attention_heads,
                    in_channels=out_channels,
                    num_layers=tl[i],
                    cross_attention_dim=cross_attention_dim,
                    norm_num_groups=resnet_groups_out,
                    use_linear_projection=use_linear_projection,
                )
                for i in range(num_layers)
            ]
        )

    def forward(
        self,
        hidden_states: torch.Tensor,
        temb: Optional[torch.Tensor] = None,
        encoder_hidden_states: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        encoder_attention_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        hidden_states = self.resnets[0](hidden_states, temb)
        for i, attn in enumerate(self.attentions):
            hidden_states = attn(
                hidden_states,
                encoder_hidden_states=encoder_hidden_states,
                attention_mask=attention_mask,
                encoder_attention_mask=encoder_attention_mask,
            )
            hidden_states = self.resnets[i + 1](hidden_states, temb)
        return hidden_states


class CrossAttnUpBlock2D(nn.Module):
    has_cross_attention = True

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        prev_output_channel: int,
        temb_channels: int,
        num_layers: int = 1,
        transformer_layers_per_block: Union[int, Tuple[int, ...]] = 1,
        resnet_eps: float = 1e-6,
        resnet_time_scale_shift: str = "default",
        resnet_act_fn: str = "swish",
        resnet_groups: int = 32,
        num_attention_heads: int = 1,
        cross_attention_dim: int = 1280,
        output_scale_factor: float = 1.0,
        add_upsample: bool = True,
        use_linear_projection: bool = False,
        only_cross_attention: bool = False,
    ):
        super().__init__()
        tl = _per_layer(transformer_layers_per_block, num_layers)
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
        self.attentions = nn.ModuleList(
            [
                Transformer2DModel(
                    num_attention_heads,
                    out_channels // num_attention_heads,
                    in_channels=out_channels,
                    num_layers=tl[i],
                    cross_attention_dim=cross_attention_dim,
                    norm_num_groups=resnet_groups,
                    use_linear_projection=use_linear_projection,
                    only_cross_attention=only_cross_attention,
                )
                for i in range(num_layers)
            ]
        )
        self.add_upsample = add_upsample
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(out_channels, use_conv=True, out_channels=out_channels)])

    def forward(
        self,
        hidden_states: torch.Tensor,
        res_hidden_states_tuple,
        temb: Optional[torch.Tensor] = None,
        encoder_hidden_states: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        encoder_attention_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        for resnet, attn in zip(self.resnets, self.attentions):
            res_hidden_states = res_hidden_states_tuple[-1]
            res_hidden_states_tuple = res_hidden_states_tuple[:-1]
            hidden_states = torch.cat([hidden_states, res_hidden_states], dim=1)
            hidden_states = resnet(hidden_states, temb)
            hidden_states = attn(
                hidden_states,
                encoder_hidden_states=encoder_hidden_states,
                attention_mask=attention_mask,
                encoder_attention_mask=encoder_attention_mask,
            )
        if self.add_upsample:
            hidden_states = self.upsamplers[0](hidden_states)
        return hidden_states

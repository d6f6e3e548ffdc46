"""ControlNetModel (SD/SDXL family).

Port of `diffusers_tpu/models/controlnets/controlnet.py` (`:33-243`): the
conditioning embedding, SDXL's ``text_time`` micro-conditioning, the UNet's
down and mid blocks (the port's, so attention goes through the registry to
kernel K1 and GroupNorm to kernel K4 on the card), the 1x1 output convs
(`controlnet_down_blocks`, `controlnet_mid_block`; plain Conv2d leaves, as
in JAX), `conditioning_scale`, guess mode's `logspace(-1, 0, n + 1)`
scales, `global_pool_conditions` and the ``bgr`` channel order. NCHW in and
out (JAX goes NHWC inside); the residuals are NCHW, ready for the UNet's
`down_block_additional_residuals` / `mid_block_additional_residual`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...ops.module import Conv2d
from ...utils import BaseOutput
from ..embeddings import TimestepEmbedding, Timesteps
from ..modeling_utils import ModelMixin
from ..unets.unet_2d_blocks import get_down_block
from ..unets.unet_2d_condition_blocks import UNetMidBlock2DCrossAttn


@dataclass
class ControlNetOutput(BaseOutput):
    down_block_res_samples: Tuple[torch.Tensor, ...]
    mid_block_res_sample: torch.Tensor


class ControlNetConditioningEmbedding(nn.Module):
    """The conditioning image (NCHW, pixel size) -> features at the latent
    size: conv + SiLU, then a (conv, strided conv) pair per step of
    `block_out_channels`, each followed by SiLU, then conv_out."""

    def __init__(
        self,
        conditioning_embedding_channels: int,
        conditioning_channels: int = 3,
        block_out_channels: Tuple[int, ...] = (16, 32, 96, 256),
    ):
        super().__init__()
        self.conv_in = Conv2d(conditioning_channels, block_out_channels[0], kernel_size=3, padding=1)
        blocks = []
        for i in range(len(block_out_channels) - 1):
            blocks.append(Conv2d(block_out_channels[i], block_out_channels[i], kernel_size=3, padding=1))
            blocks.append(Conv2d(block_out_channels[i], block_out_channels[i + 1], kernel_size=3, padding=1, stride=2))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = Conv2d(block_out_channels[-1], conditioning_embedding_channels, kernel_size=3, padding=1)

    def forward(self, conditioning: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.conv_in(conditioning))
        for block in self.blocks:
            x = F.silu(block(x))
        return self.conv_out(x)


class ControlNetModel(ModelMixin, ConfigMixin):
    @register_to_config
    def __init__(
        self,
        in_channels: int = 4,
        conditioning_channels: int = 3,
        flip_sin_to_cos: bool = True,
        freq_shift: int = 0,
        down_block_types: Tuple[str, ...] = (
            "CrossAttnDownBlock2D",
            "CrossAttnDownBlock2D",
            "CrossAttnDownBlock2D",
            "DownBlock2D",
        ),
        mid_block_type: str = "UNetMidBlock2DCrossAttn",
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
    ):
        super().__init__()
        # the SD family's naming quirk: attention_head_dim is the head *count*
        num_attention_heads = num_attention_heads or attention_head_dim
        n_blocks = len(down_block_types)

        def per_block(v):
            return list(v) if isinstance(v, (list, tuple)) else [v] * n_blocks

        num_attention_heads_l = per_block(num_attention_heads)
        transformer_layers = per_block(transformer_layers_per_block)

        time_embed_dim = block_out_channels[0] * 4
        self.conv_in = Conv2d(in_channels, block_out_channels[0], kernel_size=3, padding=1)
        self.time_proj = Timesteps(block_out_channels[0], flip_sin_to_cos, freq_shift)
        self.time_embedding = TimestepEmbedding(block_out_channels[0], time_embed_dim, act_fn=act_fn)

        if addition_embed_type == "text_time":
            self.add_time_proj = Timesteps(addition_time_embed_dim, flip_sin_to_cos, freq_shift)
            self.add_embedding = TimestepEmbedding(projection_class_embeddings_input_dim, time_embed_dim)
        elif addition_embed_type is not None:
            raise NotImplementedError(f"addition_embed_type {addition_embed_type} is not ported yet")

        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(
            conditioning_embedding_channels=block_out_channels[0],
            conditioning_channels=conditioning_channels,
            block_out_channels=conditioning_embedding_out_channels,
        )

        down_blocks = []
        controlnet_down_blocks = [Conv2d(block_out_channels[0], block_out_channels[0], kernel_size=1)]
        output_channel = block_out_channels[0]
        for i, down_block_type in enumerate(down_block_types):
            input_channel = output_channel
            output_channel = block_out_channels[i]
            is_final_block = i == n_blocks - 1
            down_blocks.append(
                get_down_block(
                    down_block_type,
                    num_layers=layers_per_block,
                    transformer_layers_per_block=transformer_layers[i],
                    in_channels=input_channel,
                    out_channels=output_channel,
                    temb_channels=time_embed_dim,
                    add_downsample=not is_final_block,
                    resnet_eps=norm_eps,
                    resnet_act_fn=act_fn,
                    resnet_groups=norm_num_groups,
                    cross_attention_dim=cross_attention_dim,
                    num_attention_heads=num_attention_heads_l[i],
                    downsample_padding=downsample_padding,
                    use_linear_projection=use_linear_projection,
                    only_cross_attention=only_cross_attention,
                )
            )
            for _ in range(layers_per_block + (0 if is_final_block else 1)):  # + the downsampler's output
                controlnet_down_blocks.append(Conv2d(output_channel, output_channel, kernel_size=1))
        self.down_blocks = nn.ModuleList(down_blocks)
        self.controlnet_down_blocks = nn.ModuleList(controlnet_down_blocks)

        mid_block_channel = block_out_channels[-1]
        self.controlnet_mid_block = Conv2d(mid_block_channel, mid_block_channel, kernel_size=1)
        self.mid_block = UNetMidBlock2DCrossAttn(
            transformer_layers_per_block=transformer_layers[-1],
            in_channels=mid_block_channel,
            temb_channels=time_embed_dim,
            resnet_eps=norm_eps,
            resnet_act_fn=act_fn,
            output_scale_factor=mid_block_scale_factor,
            cross_attention_dim=cross_attention_dim,
            num_attention_heads=num_attention_heads_l[-1],
            resnet_groups=norm_num_groups,
            use_linear_projection=use_linear_projection,
        )

    def forward(
        self,
        sample: torch.Tensor,  # [B, C, H, W] latents
        timestep: Union[torch.Tensor, float, int],
        encoder_hidden_states: torch.Tensor,  # [B, S, D]
        controlnet_cond: torch.Tensor,  # [B, 3, H * f, W * f], f the conditioning embedding's downsampling
        conditioning_scale: float = 1.0,
        added_cond_kwargs: Optional[dict] = None,
        guess_mode: bool = False,
        return_dict: bool = True,
    ) -> Union[ControlNetOutput, tuple]:
        if self.config.controlnet_conditioning_channel_order == "bgr":
            controlnet_cond = torch.flip(controlnet_cond, dims=[1])
        emb = self._time_embedding(sample, timestep, added_cond_kwargs)
        sample = self.conv_in(sample) + self.controlnet_cond_embedding(controlnet_cond)
        return self._residuals(sample, emb, encoder_hidden_states, conditioning_scale, guess_mode, return_dict)

    def _time_embedding(self, sample, timestep, added_cond_kwargs):
        """The timestep embedding, plus SDXL's ``text_time`` micro-conditioning."""
        timesteps = torch.as_tensor(timestep, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps[None]
        timesteps = timesteps.expand(sample.shape[0])
        emb = self.time_embedding(self.time_proj(timesteps).to(sample.dtype))
        if self.config.addition_embed_type == "text_time":
            text_embeds = added_cond_kwargs["text_embeds"]
            time_embeds = self.add_time_proj(added_cond_kwargs["time_ids"].reshape(-1))
            time_embeds = time_embeds.reshape(text_embeds.shape[0], -1)
            add_embeds = torch.cat([text_embeds.float(), time_embeds], dim=-1).to(sample.dtype)
            emb = emb + self.add_embedding(add_embeds)
        return emb

    def _residuals(self, sample, emb, encoder_hidden_states, conditioning_scale, guess_mode, return_dict):
        """The down and mid blocks from the conditioned `sample`, their 1x1
        output convs, the scales (guess mode's ramp) and global pooling."""
        down_block_res_samples = (sample,)
        for block in self.down_blocks:
            if block.has_cross_attention:
                sample, res_samples = block(sample, temb=emb, encoder_hidden_states=encoder_hidden_states)
            else:
                sample, res_samples = block(sample, temb=emb)
            down_block_res_samples += res_samples

        sample = self.mid_block(sample, temb=emb, encoder_hidden_states=encoder_hidden_states)

        down_res = [conv(r) for r, conv in zip(down_block_res_samples, self.controlnet_down_blocks)]
        mid_res = self.controlnet_mid_block(sample)

        if guess_mode and not self.config.global_pool_conditions:
            scales = (torch.logspace(-1, 0, len(down_res) + 1) * conditioning_scale).tolist()  # on the host
            down_res = [r * s for r, s in zip(down_res, scales[:-1])]
            mid_res = mid_res * scales[-1]
        else:
            down_res = [r * conditioning_scale for r in down_res]
            mid_res = mid_res * conditioning_scale

        if self.config.global_pool_conditions:
            down_res = [r.mean(dim=(2, 3), keepdim=True) for r in down_res]
            mid_res = mid_res.mean(dim=(2, 3), keepdim=True)

        if not return_dict:
            return (tuple(down_res), mid_res)
        return ControlNetOutput(down_block_res_samples=tuple(down_res), mid_block_res_sample=mid_res)

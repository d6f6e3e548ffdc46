"""UNet2DConditionModel — the SD-family conditional UNet (SD 1.5, SDXL).

Port of `diffusers_tpu/models/unets/unet_2d_condition.py`: text
cross-attention, the SDXL ``text_time`` additional embedding (and the
``text`` one), LCM's `time_cond_proj_dim`. Public I/O is NCHW, as in JAX
(`:325`, `:497`); inside, the port stays NCHW (the JAX model goes NHWC).
ControlNet residuals (`down_block_additional_residuals`,
`mid_block_additional_residual`, JAX `:452-472`) and T2I-Adapter features
(`down_intrablock_additional_residuals`, JAX `:425-461`: one a
cross-attention down block, after its last layer; a down block without
cross attention or the mid block takes the next one where its shape
matches) arrive NCHW and are added as they are.

`encoder_hid_proj` (JAX `:130-157`, `:394-418`) follows
``encoder_hid_dim_type``: ``text_proj`` (a Linear over the text states),
``text_image_proj`` and ``image_proj`` (Kandinsky's heads, reading
``added_cond_kwargs["image_embeds"]``), or ``ip_image_proj``, filled after
construction by `loaders.ip_adapter.load_ip_adapter` with a
`MultiIPAdapterImageProjection`: then the blocks get ``(text states, [image
tokens per adapter])`` as `encoder_hidden_states`.

Class embeddings (JAX `:159-171`, `:349-360`) read `class_labels`: with
`num_class_embeds` and no `class_embed_type` an `Embedding` table (the x4
upscaler's noise level), or ``timestep`` (the labels through the time
projection, then a `TimestepEmbedding`), ``identity``, ``projection`` (a
`TimestepEmbedding` of `projection_class_embeddings_input_dim`) or
``simple_projection`` (one Linear). The result is added to the time
embedding, or concatenated to it with `class_embeddings_concat`, which
doubles every resnet's time-embedding width. FreeU waits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...ops.module import Conv2d, Embedding, GroupNorm, get_activation
from ...utils import BaseOutput
from ...ops.module import Linear
from ..embeddings import ImageProjection, TextImageProjection, TextTimeEmbedding, TimestepEmbedding, Timesteps
from ..ip_adapter import MultiIPAdapterImageProjection
from ..modeling_utils import ModelMixin
from .unet_2d_blocks import get_down_block, get_up_block
from .unet_2d_condition_blocks import UNetMidBlock2DCrossAttn


@dataclass
class UNet2DConditionOutput(BaseOutput):
    sample: torch.Tensor


def _tuple_per_block(value, n):
    if isinstance(value, (list, tuple)):
        return list(value)
    return [value] * n


class UNet2DConditionModel(ModelMixin, ConfigMixin):
    @register_to_config
    def __init__(
        self,
        sample_size: Optional[int] = None,
        in_channels: int = 4,
        out_channels: int = 4,
        center_input_sample: bool = False,
        flip_sin_to_cos: bool = True,
        freq_shift: int = 0,
        down_block_types: Tuple[str, ...] = (
            "CrossAttnDownBlock2D",
            "CrossAttnDownBlock2D",
            "CrossAttnDownBlock2D",
            "DownBlock2D",
        ),
        mid_block_type: Optional[str] = "UNetMidBlock2DCrossAttn",
        up_block_types: Tuple[str, ...] = (
            "UpBlock2D",
            "CrossAttnUpBlock2D",
            "CrossAttnUpBlock2D",
            "CrossAttnUpBlock2D",
        ),
        only_cross_attention: Union[bool, Tuple[bool, ...]] = False,
        block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280),
        layers_per_block: Union[int, Tuple[int, ...]] = 2,
        downsample_padding: int = 1,
        mid_block_scale_factor: float = 1,
        act_fn: str = "silu",
        norm_num_groups: Optional[int] = 32,
        norm_eps: float = 1e-5,
        cross_attention_dim: Union[int, Tuple[int, ...]] = 1280,
        transformer_layers_per_block: Union[int, Tuple[int, ...]] = 1,
        reverse_transformer_layers_per_block: Optional[Tuple] = None,
        encoder_hid_dim: Optional[int] = None,
        encoder_hid_dim_type: Optional[str] = None,
        attention_head_dim: Union[int, Tuple[int, ...]] = 8,
        num_attention_heads: Optional[Union[int, Tuple[int, ...]]] = None,
        use_linear_projection: bool = False,
        class_embed_type: Optional[str] = None,
        addition_embed_type: Optional[str] = None,
        addition_time_embed_dim: Optional[int] = None,
        num_class_embeds: Optional[int] = None,
        resnet_time_scale_shift: str = "default",
        time_embedding_dim: Optional[int] = None,
        time_embedding_act_fn: Optional[str] = None,
        timestep_post_act: Optional[str] = None,
        time_cond_proj_dim: Optional[int] = None,
        conv_in_kernel: int = 3,
        conv_out_kernel: int = 3,
        projection_class_embeddings_input_dim: Optional[int] = None,
        class_embeddings_concat: bool = False,
        addition_embed_type_num_heads: int = 64,
    ):
        super().__init__()
        # the historical naming quirk: attention_head_dim is the head *count*
        # for the SD family
        num_attention_heads = num_attention_heads or attention_head_dim

        n_blocks = len(down_block_types)
        num_attention_heads = _tuple_per_block(num_attention_heads, n_blocks)
        cross_attention_dims = _tuple_per_block(cross_attention_dim, n_blocks)
        layers_per_block_l = _tuple_per_block(layers_per_block, n_blocks)
        transformer_layers = _tuple_per_block(transformer_layers_per_block, n_blocks)
        only_cross_attention_l = _tuple_per_block(only_cross_attention, n_blocks)

        time_embed_dim = time_embedding_dim or block_out_channels[0] * 4

        conv_in_padding = (conv_in_kernel - 1) // 2
        self.conv_in = Conv2d(in_channels, block_out_channels[0], kernel_size=conv_in_kernel, padding=conv_in_padding)

        self.time_proj = Timesteps(block_out_channels[0], flip_sin_to_cos, freq_shift)
        self.time_embedding = TimestepEmbedding(
            block_out_channels[0],
            time_embed_dim,
            act_fn=act_fn,
            post_act_fn=timestep_post_act,
            cond_proj_dim=time_cond_proj_dim,
        )

        if encoder_hid_dim_type is None and encoder_hid_dim is not None:
            encoder_hid_dim_type = "text_proj"
        if encoder_hid_dim_type == "text_proj":
            self.encoder_hid_proj = Linear(encoder_hid_dim, cross_attention_dims[0])
        elif encoder_hid_dim_type == "text_image_proj":
            self.encoder_hid_proj = TextImageProjection(text_embed_dim=encoder_hid_dim,
                                                        image_embed_dim=cross_attention_dims[0],
                                                        cross_attention_dim=cross_attention_dims[0])
        elif encoder_hid_dim_type == "image_proj":
            self.encoder_hid_proj = ImageProjection(image_embed_dim=encoder_hid_dim,
                                                    cross_attention_dim=cross_attention_dims[0])
        elif encoder_hid_dim_type in (None, "ip_image_proj"):  # ip_image_proj: set by the IP-Adapter loader
            self.encoder_hid_proj = None
        else:
            raise NotImplementedError(f"encoder_hid_dim_type {encoder_hid_dim_type} is not ported yet")

        if class_embed_type is None and num_class_embeds is not None:
            self.class_embedding = Embedding(num_class_embeds, time_embed_dim)
        elif class_embed_type == "timestep":
            self.class_embedding = TimestepEmbedding(block_out_channels[0], time_embed_dim, act_fn=act_fn)
        elif class_embed_type == "identity":
            self.class_embedding = nn.Identity()
        elif class_embed_type == "projection":
            self.class_embedding = TimestepEmbedding(projection_class_embeddings_input_dim, time_embed_dim)
        elif class_embed_type == "simple_projection":
            self.class_embedding = Linear(projection_class_embeddings_input_dim, time_embed_dim)
        elif class_embed_type is not None:
            raise ValueError(f"class_embed_type {class_embed_type!r} must be None, 'timestep', 'identity', "
                             "'projection' or 'simple_projection'")
        else:
            self.class_embedding = None

        if addition_embed_type == "text":
            text_time_embedding_from_dim = encoder_hid_dim if encoder_hid_dim is not None else cross_attention_dims[0]
            self.add_embedding = TextTimeEmbedding(
                text_time_embedding_from_dim, time_embed_dim, num_heads=addition_embed_type_num_heads
            )
        elif addition_embed_type == "text_time":
            self.add_time_proj = Timesteps(addition_time_embed_dim, flip_sin_to_cos, freq_shift)
            self.add_embedding = TimestepEmbedding(projection_class_embeddings_input_dim, time_embed_dim)
        elif addition_embed_type is not None:
            raise NotImplementedError(f"addition_embed_type {addition_embed_type} is not ported yet")

        self.time_embed_act = get_activation(time_embedding_act_fn) if time_embedding_act_fn else None
        # the class embedding concatenated onto the time embedding doubles every resnet's temb width
        blocks_time_embed_dim = time_embed_dim * 2 if class_embeddings_concat else time_embed_dim

        # down
        down_blocks = []
        output_channel = block_out_channels[0]
        for i, down_block_type in enumerate(down_block_types):
            input_channel = output_channel
            output_channel = block_out_channels[i]
            down_blocks.append(
                get_down_block(
                    down_block_type,
                    num_layers=layers_per_block_l[i],
                    transformer_layers_per_block=transformer_layers[i],
                    in_channels=input_channel,
                    out_channels=output_channel,
                    temb_channels=blocks_time_embed_dim,
                    add_downsample=i != n_blocks - 1,
                    resnet_eps=norm_eps,
                    resnet_act_fn=act_fn,
                    resnet_groups=norm_num_groups,
                    cross_attention_dim=cross_attention_dims[i],
                    num_attention_heads=num_attention_heads[i],
                    downsample_padding=downsample_padding,
                    use_linear_projection=use_linear_projection,
                    only_cross_attention=only_cross_attention_l[i],
                    resnet_time_scale_shift=resnet_time_scale_shift,
                )
            )
        self.down_blocks = nn.ModuleList(down_blocks)

        # mid
        if mid_block_type == "UNetMidBlock2DCrossAttn":
            self.mid_block = UNetMidBlock2DCrossAttn(
                transformer_layers_per_block=transformer_layers[-1],
                in_channels=block_out_channels[-1],
                temb_channels=blocks_time_embed_dim,
                resnet_eps=norm_eps,
                resnet_act_fn=act_fn,
                output_scale_factor=mid_block_scale_factor,
                resnet_time_scale_shift=resnet_time_scale_shift,
                cross_attention_dim=cross_attention_dims[-1],
                num_attention_heads=num_attention_heads[-1],
                resnet_groups=norm_num_groups,
                use_linear_projection=use_linear_projection,
            )
        elif mid_block_type is None:
            self.mid_block = None
        else:
            raise NotImplementedError(f"mid_block_type {mid_block_type} is not ported yet")

        # up
        up_blocks = []
        reversed_block_out_channels = list(reversed(block_out_channels))
        reversed_num_attention_heads = list(reversed(num_attention_heads))
        reversed_layers_per_block = list(reversed(layers_per_block_l))
        reversed_cross_attention_dim = list(reversed(cross_attention_dims))
        reversed_transformer_layers = (
            list(reversed(transformer_layers))
            if reverse_transformer_layers_per_block is None
            else list(reverse_transformer_layers_per_block)
        )
        reversed_only_cross_attention = list(reversed(only_cross_attention_l))
        output_channel = reversed_block_out_channels[0]
        for i, up_block_type in enumerate(up_block_types):
            prev_output_channel = output_channel
            output_channel = reversed_block_out_channels[i]
            input_channel = reversed_block_out_channels[min(i + 1, n_blocks - 1)]
            up_blocks.append(
                get_up_block(
                    up_block_type,
                    num_layers=reversed_layers_per_block[i] + 1,
                    transformer_layers_per_block=reversed_transformer_layers[i],
                    in_channels=input_channel,
                    out_channels=output_channel,
                    prev_output_channel=prev_output_channel,
                    temb_channels=blocks_time_embed_dim,
                    add_upsample=i != n_blocks - 1,
                    resnet_eps=norm_eps,
                    resnet_act_fn=act_fn,
                    resnet_groups=norm_num_groups,
                    cross_attention_dim=reversed_cross_attention_dim[i],
                    num_attention_heads=reversed_num_attention_heads[i],
                    use_linear_projection=use_linear_projection,
                    only_cross_attention=reversed_only_cross_attention[i],
                    resnet_time_scale_shift=resnet_time_scale_shift,
                )
            )
        self.up_blocks = nn.ModuleList(up_blocks)

        if norm_num_groups is not None:
            self.conv_norm_out = GroupNorm(
                num_channels=block_out_channels[0], num_groups=norm_num_groups, eps=norm_eps
            )
            self.conv_act = get_activation(act_fn)
        else:
            self.conv_norm_out = None
        conv_out_padding = (conv_out_kernel - 1) // 2
        self.conv_out = Conv2d(block_out_channels[0], out_channels, kernel_size=conv_out_kernel, padding=conv_out_padding)

    def forward(
        self,
        sample: torch.Tensor,  # [B, C, H, W]
        timestep: Union[torch.Tensor, float, int],
        encoder_hidden_states: torch.Tensor,  # [B, S, D]
        class_labels: Optional[torch.Tensor] = None,
        timestep_cond: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        added_cond_kwargs: Optional[Dict[str, torch.Tensor]] = None,
        encoder_attention_mask: Optional[torch.Tensor] = None,
        down_block_additional_residuals: Optional[Tuple[torch.Tensor, ...]] = None,
        mid_block_additional_residual: Optional[torch.Tensor] = None,
        down_intrablock_additional_residuals: Optional[Tuple[torch.Tensor, ...]] = None,
        return_dict: bool = True,
    ) -> Union[UNet2DConditionOutput, tuple]:
        if self.config.center_input_sample:
            sample = 2 * sample - 1.0

        # 1. time
        timesteps = torch.as_tensor(timestep, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps[None]
        timesteps = timesteps.expand(sample.shape[0])
        t_emb = self.time_proj(timesteps).to(sample.dtype)
        emb = self.time_embedding(t_emb, timestep_cond)

        if self.class_embedding is not None:
            if class_labels is None:
                raise ValueError("class_labels must be provided for class conditioning")
            class_labels = torch.as_tensor(class_labels, device=sample.device)
            if self.config.class_embed_type == "timestep":
                class_labels = self.time_proj(class_labels).to(sample.dtype)
            class_emb = self.class_embedding(class_labels).to(sample.dtype)
            emb = torch.cat([emb, class_emb], dim=-1) if self.config.class_embeddings_concat else emb + class_emb

        if self.config.addition_embed_type == "text":
            emb = emb + self.add_embedding(encoder_hidden_states)
        elif self.config.addition_embed_type == "text_time":
            if added_cond_kwargs is None or "text_embeds" not in added_cond_kwargs:
                raise ValueError("addition_embed_type 'text_time' requires added_cond_kwargs with text_embeds/time_ids")
            text_embeds = added_cond_kwargs["text_embeds"]
            time_ids = added_cond_kwargs["time_ids"]
            time_embeds = self.add_time_proj(time_ids.reshape(-1))
            time_embeds = time_embeds.reshape(text_embeds.shape[0], -1)
            add_embeds = torch.cat([text_embeds.float(), time_embeds], dim=-1).to(sample.dtype)
            emb = emb + self.add_embedding(add_embeds)

        if self.time_embed_act is not None:
            emb = self.time_embed_act(emb)

        if self.encoder_hid_proj is not None:
            hid_type = self.config.encoder_hid_dim_type
            if isinstance(self.encoder_hid_proj, MultiIPAdapterImageProjection):
                if added_cond_kwargs is None or "image_embeds" not in added_cond_kwargs:
                    raise ValueError("an IP-Adapter is loaded: pass added_cond_kwargs={'image_embeds': [...]}")
                image_embeds = self.encoder_hid_proj(added_cond_kwargs["image_embeds"])
                encoder_hidden_states = (encoder_hidden_states, image_embeds)
            elif hid_type in ("text_image_proj", "image_proj"):
                if added_cond_kwargs is None or "image_embeds" not in added_cond_kwargs:
                    raise ValueError(f"encoder_hid_dim_type {hid_type!r} requires added_cond_kwargs with image_embeds")
                image_embeds = added_cond_kwargs["image_embeds"]
                encoder_hidden_states = (self.encoder_hid_proj(encoder_hidden_states, image_embeds)
                                         if hid_type == "text_image_proj" else self.encoder_hid_proj(image_embeds))
            else:
                encoder_hidden_states = self.encoder_hid_proj(encoder_hidden_states)

        # boolean/int [B, K] text mask -> additive bias broadcastable over [B, H, Q, K]
        if encoder_attention_mask is not None and encoder_attention_mask.ndim == 2:
            encoder_attention_mask = ((1 - encoder_attention_mask.to(sample.dtype)) * -10000.0)[:, None, None, :]

        # 2. pre-process
        sample = self.conv_in(sample)

        # 3. down, with the T2I-Adapter features (NCHW), one a block
        intrablock = list(down_intrablock_additional_residuals or ())
        down_block_res_samples = (sample,)
        for block in self.down_blocks:
            if block.has_cross_attention:
                sample, res_samples = block(
                    sample,
                    temb=emb,
                    encoder_hidden_states=encoder_hidden_states,
                    attention_mask=attention_mask,
                    encoder_attention_mask=encoder_attention_mask,
                    additional_residual=intrablock.pop(0) if intrablock else None,
                )
            else:
                sample, res_samples = block(sample, temb=emb)
                if intrablock and sample.shape == intrablock[0].shape:
                    sample = sample + intrablock.pop(0)
                    res_samples = res_samples[:-1] + (sample,)
            down_block_res_samples += res_samples

        # 3.5 ControlNet residuals
        if down_block_additional_residuals is not None:
            down_block_res_samples = tuple(
                r + cr for r, cr in zip(down_block_res_samples, down_block_additional_residuals)
            )

        # 4. mid: a feature left over at the mid block's size joins here
        if intrablock and self.mid_block is not None and sample.shape == intrablock[0].shape:
            sample = sample + intrablock.pop(0)
        if self.mid_block is not None:
            sample = self.mid_block(
                sample,
                temb=emb,
                encoder_hidden_states=encoder_hidden_states,
                attention_mask=attention_mask,
                encoder_attention_mask=encoder_attention_mask,
            )
        if mid_block_additional_residual is not None:
            sample = sample + mid_block_additional_residual

        # 5. up
        for block in self.up_blocks:
            n = len(block.resnets)
            res_samples = down_block_res_samples[-n:]
            down_block_res_samples = down_block_res_samples[:-n]
            if block.has_cross_attention:
                sample = block(
                    sample,
                    res_samples,
                    temb=emb,
                    encoder_hidden_states=encoder_hidden_states,
                    attention_mask=attention_mask,
                    encoder_attention_mask=encoder_attention_mask,
                )
            else:
                sample = block(sample, res_samples, temb=emb)

        # 6. post-process (SiLU fuses into the GroupNorm kernel)
        if self.conv_norm_out is not None:
            if self.conv_act is F.silu:
                sample = self.conv_norm_out(sample, apply_silu=True)
            else:
                sample = self.conv_act(self.conv_norm_out(sample))
        sample = self.conv_out(sample)

        if not return_dict:
            return (sample,)
        return UNet2DConditionOutput(sample=sample)

"""FluxControlNetModel and FluxMultiControlNetModel: ControlNets of the Flux.1 DiT.

Port of `diffusers_tpu/models/controlnets/controlnet_flux.py` (`:45-256`).
The ControlNet is a prefix of the Flux transformer (the same
`FluxTransformerBlock` / `FluxSingleTransformerBlock`, so its attention is
kernel K1 and, after `quantize_w8a8`, its Linears kernel K5) whose input is
the packed latents plus `controlnet_x_embedder(controlnet_cond)`; after each
block a `controlnet_blocks` / `controlnet_single_blocks` Linear, zero at
construction, projects the image tokens into the residual that the
transformer adds (`FluxTransformer2DModel.run_blocks`), times
`conditioning_scale`.

`controlnet_cond` is the packed VAE latents of the control image
(InstantX-style), or, for a model with `conditioning_embedding_channels`
(XLabs-style), the NCHW image, which `input_hint_block`
(`ControlNetConditioningEmbedding` with widths (16, 16, 16, 16)) takes to
the latent size before it is packed in 1 x 1 patches (`patch_size`). The
Union form (`num_mode`) prepends `controlnet_mode_embedder(controlnet_mode)`
as one more text token, and its RoPE ids repeat the first text id.
`from_transformer` builds one from a transformer's config and copies its
embedders and its first blocks (the copy keeps w8a8 Linears as they are).
"""

from __future__ import annotations

import copy
import inspect
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...ops.module import Embedding, Linear
from ...utils import BaseOutput
from ..embeddings import CombinedTimestepGuidanceTextProjEmbeddings, CombinedTimestepTextProjEmbeddings, FluxPosEmbed
from ..modeling_utils import ModelMixin
from ..transformers.transformer_flux import FluxSingleTransformerBlock, FluxTransformerBlock
from .controlnet import ControlNetConditioningEmbedding


@dataclass
class FluxControlNetOutput(BaseOutput):
    controlnet_block_samples: Optional[Tuple[torch.Tensor, ...]]
    controlnet_single_block_samples: Optional[Tuple[torch.Tensor, ...]]


class FluxControlNetModel(ModelMixin, ConfigMixin):
    @register_to_config
    def __init__(
        self,
        patch_size: int = 1,
        in_channels: int = 64,
        num_layers: int = 19,
        num_single_layers: int = 38,
        attention_head_dim: int = 128,
        num_attention_heads: int = 24,
        joint_attention_dim: int = 4096,
        pooled_projection_dim: int = 768,
        guidance_embeds: bool = False,
        axes_dims_rope: Tuple[int, ...] = (16, 56, 56),
        num_mode: Optional[int] = None,
        conditioning_embedding_channels: Optional[int] = None,
    ):
        super().__init__()
        self.out_channels = in_channels
        self.inner_dim = num_attention_heads * attention_head_dim
        self.pos_embed = FluxPosEmbed(theta=10000, axes_dim=axes_dims_rope)
        embed_cls = (CombinedTimestepGuidanceTextProjEmbeddings if guidance_embeds
                     else CombinedTimestepTextProjEmbeddings)
        self.time_text_embed = embed_cls(embedding_dim=self.inner_dim, pooled_projection_dim=pooled_projection_dim)
        self.context_embedder = Linear(joint_attention_dim, self.inner_dim)
        self.x_embedder = Linear(in_channels, self.inner_dim)
        self.transformer_blocks = nn.ModuleList(
            [FluxTransformerBlock(self.inner_dim, num_attention_heads, attention_head_dim) for _ in range(num_layers)])
        self.single_transformer_blocks = nn.ModuleList(
            [FluxSingleTransformerBlock(self.inner_dim, num_attention_heads, attention_head_dim)
             for _ in range(num_single_layers)])
        self.controlnet_blocks = nn.ModuleList([Linear(self.inner_dim, self.inner_dim) for _ in range(num_layers)])
        self.controlnet_single_blocks = nn.ModuleList(
            [Linear(self.inner_dim, self.inner_dim) for _ in range(num_single_layers)])
        self.union = num_mode is not None
        if self.union:
            self.controlnet_mode_embedder = Embedding(num_mode, self.inner_dim)
        self.input_hint_block = None
        if conditioning_embedding_channels is not None:
            self.input_hint_block = ControlNetConditioningEmbedding(
                conditioning_embedding_channels=conditioning_embedding_channels, block_out_channels=(16, 16, 16, 16))
        self.controlnet_x_embedder = Linear(in_channels, self.inner_dim)
        self._zero_residual_paths()

    @torch.no_grad()
    def _zero_residual_paths(self) -> None:
        """Zero the residual projections (and, without a hint block, the
        conditioning embedder), so an untrained ControlNet adds nothing (JAX
        `init_params`)."""
        zeroed = [*self.controlnet_blocks, *self.controlnet_single_blocks]
        if self.input_hint_block is None:
            zeroed.append(self.controlnet_x_embedder)
        for lin in zeroed:
            if not lin.weight.is_meta:
                lin.weight.zero_()
                lin.bias.zero_()

    @classmethod
    def from_transformer(cls, transformer, num_layers: int = 4, num_single_layers: int = 10,
                         attention_head_dim: int = 128, num_attention_heads: int = 24,
                         load_weights_from_transformer: bool = True) -> "FluxControlNetModel":
        """A ControlNet with `transformer`'s config and the given depth and
        heads, on its device and in its dtype; with
        `load_weights_from_transformer`, its time/text embedder, context and x
        embedders and its first `num_layers` dual and `num_single_layers`
        single blocks are copies of the transformer's, and
        `controlnet_x_embedder` is zero (JAX `:117-143`)."""
        accepted = set(inspect.signature(cls.__init__).parameters)
        config = {k: v for k, v in transformer.config.items() if k in accepted}
        config.update(num_layers=num_layers, num_single_layers=num_single_layers,
                      attention_head_dim=attention_head_dim, num_attention_heads=num_attention_heads)
        param = next(transformer.parameters())
        with torch.device(param.device):
            controlnet = cls(**config)
        controlnet.to(dtype=transformer.dtype)
        if load_weights_from_transformer:
            for name in ("time_text_embed", "context_embedder", "x_embedder"):
                setattr(controlnet, name, copy.deepcopy(getattr(transformer, name)))
            for i in range(num_layers):
                controlnet.transformer_blocks[i] = copy.deepcopy(transformer.transformer_blocks[i])
            for i in range(num_single_layers):
                controlnet.single_transformer_blocks[i] = copy.deepcopy(transformer.single_transformer_blocks[i])
            with torch.no_grad():
                controlnet.controlnet_x_embedder.weight.zero_()
                controlnet.controlnet_x_embedder.bias.zero_()
        return controlnet

    def _pack_hint(self, controlnet_cond: torch.Tensor) -> torch.Tensor:
        """NCHW image -> hint features at the latent size -> [B, S, C ps ps]."""
        cond = self.input_hint_block(controlnet_cond.to(self.input_hint_block.conv_in.weight.dtype))
        b, c, hp, wp = cond.shape
        ps = self.config.patch_size
        cond = cond.reshape(b, c, hp // ps, ps, wp // ps, ps).permute(0, 2, 4, 1, 3, 5)
        return cond.reshape(b, (hp // ps) * (wp // ps), c * ps * ps)

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, image_seq, in_channels] packed latents
        controlnet_cond: torch.Tensor,  # packed [B, image_seq, in_channels], or NCHW with input_hint_block
        controlnet_mode: Optional[torch.Tensor] = None,  # [B, 1] int (Union)
        conditioning_scale: float = 1.0,
        encoder_hidden_states: Optional[torch.Tensor] = None,
        pooled_projections: Optional[torch.Tensor] = None,
        timestep: Optional[torch.Tensor] = None,  # [B] in [0, 1]
        img_ids=None,
        txt_ids=None,
        guidance: Optional[torch.Tensor] = None,
        image_rotary_emb: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        return_dict: bool = True,
    ) -> Union[FluxControlNetOutput, tuple]:
        hidden_states = self.x_embedder(hidden_states)
        if self.input_hint_block is not None:
            controlnet_cond = self._pack_hint(controlnet_cond)
        hidden_states = hidden_states + self.controlnet_x_embedder(controlnet_cond.to(hidden_states.dtype))
        timestep = timestep.to(hidden_states.dtype) * 1000
        if guidance is not None:
            temb = self.time_text_embed(timestep, guidance.to(hidden_states.dtype) * 1000, pooled_projections)
        else:
            temb = self.time_text_embed(timestep, pooled_projections)
        context = self.context_embedder(encoder_hidden_states)
        if self.union:
            if controlnet_mode is None:
                raise ValueError("`controlnet_mode` cannot be `None` when applying ControlNet-Union")
            context = torch.cat([self.controlnet_mode_embedder(controlnet_mode).to(context.dtype), context], dim=1)
            if txt_ids is not None:
                txt_ids = torch.cat([torch.as_tensor(txt_ids)[:1], torch.as_tensor(txt_ids)], dim=0)
        if image_rotary_emb is None:
            cos, sin = self.pos_embed(torch.cat([torch.as_tensor(txt_ids), torch.as_tensor(img_ids)], dim=0))
            image_rotary_emb = (cos.to(hidden_states.device), sin.to(hidden_states.device))

        block_samples = []
        for block, proj in zip(self.transformer_blocks, self.controlnet_blocks):
            context, hidden_states = block(hidden_states, context, temb, image_rotary_emb)
            block_samples.append(proj(hidden_states) * conditioning_scale)
        single_samples = []
        for block, proj in zip(self.single_transformer_blocks, self.controlnet_single_blocks):
            context, hidden_states = block(hidden_states, context, temb, image_rotary_emb)
            single_samples.append(proj(hidden_states) * conditioning_scale)
        block_samples, single_samples = tuple(block_samples) or None, tuple(single_samples) or None
        if not return_dict:
            return (block_samples, single_samples)
        return FluxControlNetOutput(controlnet_block_samples=block_samples,
                                    controlnet_single_block_samples=single_samples)


class FluxMultiControlNetModel(nn.Module):
    """Several FluxControlNetModels whose residuals are summed (JAX
    `:219-256`): each gets its own condition, mode and scale."""

    def __init__(self, controlnets: Sequence[FluxControlNetModel]):
        super().__init__()
        self.nets = nn.ModuleList(controlnets)

    def forward(self, hidden_states, controlnet_cond: List, controlnet_mode: Optional[List] = None,
                conditioning_scale: Optional[List[float]] = None, **kwargs) -> FluxControlNetOutput:
        conditioning_scale = conditioning_scale or [1.0] * len(self.nets)
        controlnet_mode = controlnet_mode or [None] * len(self.nets)
        blocks = singles = None
        for net, cond, mode, scale in zip(self.nets, controlnet_cond, controlnet_mode, conditioning_scale):
            out = net(hidden_states, cond, controlnet_mode=mode, conditioning_scale=scale, **kwargs)
            if blocks is None:
                blocks, singles = out.controlnet_block_samples, out.controlnet_single_block_samples
                continue
            if out.controlnet_block_samples is not None:
                blocks = tuple(a + b for a, b in zip(blocks, out.controlnet_block_samples))
            if out.controlnet_single_block_samples is not None:
                singles = tuple(a + b for a, b in zip(singles, out.controlnet_single_block_samples))
        return FluxControlNetOutput(controlnet_block_samples=blocks, controlnet_single_block_samples=singles)

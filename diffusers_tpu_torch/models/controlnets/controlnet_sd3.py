"""SD3ControlNetModel: the ControlNet of the SD3 / SD3.5 MMDiT.

Port of `diffusers_tpu/models/controlnets/controlnet_sd3.py` (`:36-219`).
Two kinds:

* the joint-block kind (InstantX's layout): the transformer's `pos_embed`,
  `time_text_embed` and `context_embedder`, then `JointTransformerBlock`s
  (none of them `context_pre_only`) over the image and text streams;
* the single-block kind (``joint_attention_dim=None``, SD3.5 Large's
  ControlNets, usually with ``use_pos_embed=False``): `SD3SingleTransformerBlock`s
  over the image tokens alone, which take the patch tokens [B, N, D]
  (the transformer's `pos_embed` applied by the caller) when the net has no
  `pos_embed` of its own.

The conditioning latents go through `pos_embed_input` (a `PatchEmbed` with
no positions) and are added to the patch tokens; after each block a Linear
of `controlnet_blocks` gives that block's residual, times
`conditioning_scale`. The residual Linears and `pos_embed_input` start at
zero, as upstream's and JAX's `init_params` do, so an untrained net is a
no-op. Attention goes through the dispatch layer: K1 on the card at head dim
64.

`from_transformer` (JAX `:138-158`) follows upstream diffusers: the net
takes the `SD3Transformer2DModel`'s whole config, `dual_attention_layers`
and `qk_norm` included, so each of its `num_layers` blocks has the layout
of the transformer's block and is copied whole, with the embedders. JAX
drops those two keys: its net then runs without the base's qk norms, and
for a dual-attention base (SD3.5 Medium) its forward fails (ROADMAP C4).
`SD3MultiControlNetModel` sums several nets' residuals (JAX `:201-219`).
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...ops.module import LayerNorm, Linear
from ...utils import BaseOutput
from ..attention_blocks import FeedForward
from ..embeddings import CombinedTimestepTextProjEmbeddings, PatchEmbed
from ..modeling_utils import ModelMixin
from ..normalization import AdaLayerNormZero
from ..transformers.transformer_sd3 import JointAttention, JointTransformerBlock, SD3Transformer2DModel


@dataclass
class SD3ControlNetOutput(BaseOutput):
    controlnet_block_samples: Tuple[torch.Tensor, ...]


class SD3SingleTransformerBlock(nn.Module):
    """A context-free MMDiT block (JAX `:40-63`): `AdaLayerNormZero`
    modulation, self attention over the image tokens, the gated MLP."""

    def __init__(self, dim: int, num_attention_heads: int, attention_head_dim: int):
        super().__init__()
        self.norm1 = AdaLayerNormZero(dim)
        self.attn = JointAttention(query_dim=dim, heads=num_attention_heads, dim_head=attention_head_dim, out_dim=dim)
        self.norm2 = LayerNorm(dim, eps=1e-6, use_scale=False, use_bias=False)
        self.ff = FeedForward(dim=dim, dim_out=dim, activation_fn="gelu-approximate")

    def forward(self, hidden_states: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        norm_hidden, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.norm1(hidden_states, emb=temb)
        hidden_states = hidden_states + gate_msa[:, None] * self.attn(norm_hidden)
        norm_hidden = self.norm2(hidden_states) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
        return hidden_states + gate_mlp[:, None] * self.ff(norm_hidden)


class SD3ControlNetModel(ModelMixin, ConfigMixin):
    _derived_keys = ("pos_embed.pos_embed",)  # upstream checkpoints keep the sin-cos table
    check_derived_tensor = SD3Transformer2DModel.check_derived_tensor

    @register_to_config
    def __init__(
        self,
        sample_size: int = 128,
        patch_size: int = 2,
        in_channels: int = 16,
        num_layers: int = 18,
        attention_head_dim: int = 64,
        num_attention_heads: int = 18,
        joint_attention_dim: Optional[int] = 4096,
        caption_projection_dim: int = 1152,
        pooled_projection_dim: int = 2048,
        out_channels: int = 16,
        pos_embed_max_size: int = 96,
        extra_conditioning_channels: int = 0,
        dual_attention_layers: Tuple[int, ...] = (),
        qk_norm: Optional[str] = None,
        pos_embed_type: Optional[str] = "sincos",
        use_pos_embed: bool = True,
        force_zeros_for_pooled_projection: bool = True,
    ):
        super().__init__()
        self.inner_dim = num_attention_heads * attention_head_dim
        self.pos_embed = PatchEmbed(height=sample_size, width=sample_size, patch_size=patch_size,
                                    in_channels=in_channels, embed_dim=self.inner_dim,
                                    pos_embed_max_size=pos_embed_max_size,
                                    pos_embed_type=pos_embed_type) if use_pos_embed else None
        self.time_text_embed = CombinedTimestepTextProjEmbeddings(embedding_dim=self.inner_dim,
                                                                  pooled_projection_dim=pooled_projection_dim)
        if joint_attention_dim is not None:
            self.context_embedder = Linear(joint_attention_dim, caption_projection_dim)
            self.transformer_blocks = nn.ModuleList([
                JointTransformerBlock(dim=self.inner_dim, num_attention_heads=num_attention_heads,
                                      attention_head_dim=attention_head_dim, context_pre_only=False, qk_norm=qk_norm,
                                      use_dual_attention=(i in dual_attention_layers))
                for i in range(num_layers)])
        else:
            self.context_embedder = None
            self.transformer_blocks = nn.ModuleList([
                SD3SingleTransformerBlock(self.inner_dim, num_attention_heads, attention_head_dim)
                for _ in range(num_layers)])
        self.controlnet_blocks = nn.ModuleList([Linear(self.inner_dim, self.inner_dim) for _ in range(num_layers)])
        self.pos_embed_input = PatchEmbed(height=sample_size, width=sample_size, patch_size=patch_size,
                                          in_channels=in_channels + extra_conditioning_channels,
                                          embed_dim=self.inner_dim, pos_embed_type=None)
        with torch.no_grad():
            for p in (*self.controlnet_blocks.parameters(), *self.pos_embed_input.parameters()):
                p.zero_()

    @classmethod
    def from_transformer(cls, transformer: SD3Transformer2DModel, num_layers: int = 12,
                         num_extra_conditioning_channels: int = 1,
                         load_weights_from_transformer: bool = True) -> "SD3ControlNetModel":
        """A net of `transformer`'s config with `num_layers` blocks, on its
        device and in its dtype; with `load_weights_from_transformer`, its
        embedders and blocks are copies of the transformer's and
        `pos_embed_input` is zero."""
        accepted = set(inspect.signature(cls.__init__).parameters)
        config = {k: v for k, v in transformer.config.items() if k in accepted}
        config.update(num_layers=num_layers or transformer.config.num_layers,
                      extra_conditioning_channels=num_extra_conditioning_channels)
        with torch.device(next(transformer.parameters()).device):
            controlnet = cls(**config)
        controlnet.to(dtype=transformer.dtype)
        if load_weights_from_transformer:
            for name in ("pos_embed", "time_text_embed", "context_embedder"):
                getattr(controlnet, name).load_state_dict(getattr(transformer, name).state_dict())
            for i, block in enumerate(controlnet.transformer_blocks):
                base = transformer.transformer_blocks[i]
                if base.context_pre_only:
                    raise ValueError(f"SD3ControlNetModel.from_transformer: transformer block {i} is "
                                     "context_pre_only (the last block) and cannot seed a ControlNet block")
                block.load_state_dict(base.state_dict())
            with torch.no_grad():
                for p in controlnet.pos_embed_input.parameters():
                    p.zero_()
        return controlnet

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, C, H, W] latents, or [B, N, D] patch tokens without `pos_embed`
        controlnet_cond: torch.Tensor,  # [B, C + extra, H, W] conditioning latents
        conditioning_scale: float = 1.0,
        encoder_hidden_states: Optional[torch.Tensor] = None,
        pooled_projections: Optional[torch.Tensor] = None,
        timestep: Optional[torch.Tensor] = None,
        return_dict: bool = True,
    ) -> Union[SD3ControlNetOutput, tuple]:
        if self.pos_embed is not None:
            if hidden_states.ndim != 4:
                raise ValueError(f"{type(self).__name__}: with a pos_embed the hidden states must be latents "
                                 f"[B, C, H, W], got {tuple(hidden_states.shape)}")
            hidden_states = self.pos_embed(hidden_states)
        elif hidden_states.ndim != 3:
            raise ValueError(f"{type(self).__name__}: without a pos_embed (use_pos_embed=False) the hidden states "
                             f"must be patch tokens [B, N, D], got {tuple(hidden_states.shape)}")
        temb = self.time_text_embed(timestep, pooled_projections)
        if self.context_embedder is not None:
            encoder_hidden_states = self.context_embedder(encoder_hidden_states)
        hidden_states = hidden_states + self.pos_embed_input(controlnet_cond.to(hidden_states.dtype))

        samples = []
        for block, proj in zip(self.transformer_blocks, self.controlnet_blocks):
            if self.context_embedder is not None:
                hidden_states, encoder_hidden_states = block(hidden_states, encoder_hidden_states, temb)
            else:
                hidden_states = block(hidden_states, temb)
            samples.append(proj(hidden_states) * conditioning_scale)
        if not return_dict:
            return (tuple(samples),)
        return SD3ControlNetOutput(controlnet_block_samples=tuple(samples))


class SD3MultiControlNetModel(nn.Module):
    """Several SD3ControlNetModels whose residual stacks are summed (JAX
    `:201-219`): each gets its own conditioning latents and scale."""

    def __init__(self, controlnets: Sequence[SD3ControlNetModel]):
        super().__init__()
        self.nets = nn.ModuleList(controlnets)

    def forward(self, hidden_states, controlnet_cond: Sequence[torch.Tensor],
                conditioning_scale: Optional[Sequence[float]] = None, **kwargs) -> SD3ControlNetOutput:
        if conditioning_scale is None:
            conditioning_scale = [1.0] * len(self.nets)
        samples = None
        for net, cond, scale in zip(self.nets, controlnet_cond, conditioning_scale):
            out = net(hidden_states, cond, conditioning_scale=scale, **kwargs).controlnet_block_samples
            samples = out if samples is None else tuple(a + b for a, b in zip(samples, out))
        return SD3ControlNetOutput(controlnet_block_samples=samples)

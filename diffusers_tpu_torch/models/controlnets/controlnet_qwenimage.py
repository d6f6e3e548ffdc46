"""QwenImageControlNetModel and QwenImageMultiControlNetModel: ControlNets of
the Qwen-Image DiT.

Port of `diffusers_tpu/models/controlnets/controlnet_qwenimage.py` (`:37-155`).
The ControlNet is a prefix of the Qwen-Image transformer (the same
`QwenImageTransformerBlock`, so its joint attention is kernel K1 under the
key-padding bias) whose input is the packed latents plus
`controlnet_x_embedder(controlnet_cond)`; after each block a
`controlnet_blocks` Linear, zero at construction, projects the image tokens
into the residual that `QwenImageTransformer2DModel` adds by its interval
rule (``controlnet_block_samples``), times `conditioning_scale`.
`from_transformer` builds one from a transformer's config and copies its
embedders and first blocks. The multi model sums the nets' residuals.
"""

from __future__ import annotations

import copy
import inspect
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...ops.module import Linear, RMSNorm
from ...utils import BaseOutput
from ..modeling_utils import ModelMixin
from ..transformers.transformer_qwenimage import (
    QwenEmbedRope,
    QwenImageTransformerBlock,
    QwenTimestepProjEmbeddings,
    key_padding_bias,
)


@dataclass
class QwenImageControlNetOutput(BaseOutput):
    controlnet_block_samples: Tuple[torch.Tensor, ...]


class QwenImageControlNetModel(ModelMixin, ConfigMixin):
    @register_to_config
    def __init__(
        self,
        patch_size: int = 2,
        in_channels: int = 64,
        out_channels: Optional[int] = 16,
        num_layers: int = 60,
        attention_head_dim: int = 128,
        num_attention_heads: int = 24,
        joint_attention_dim: int = 3584,
        axes_dims_rope: Tuple[int, int, int] = (16, 56, 56),
        extra_condition_channels: int = 0,
    ):
        super().__init__()
        self.inner_dim = num_attention_heads * attention_head_dim
        self.pos_embed = QwenEmbedRope(theta=10000, axes_dim=list(axes_dims_rope), scale_rope=True)
        self.time_text_embed = QwenTimestepProjEmbeddings(self.inner_dim)
        self.txt_norm = RMSNorm(joint_attention_dim, eps=1e-6)
        self.img_in = Linear(in_channels, self.inner_dim)
        self.txt_in = Linear(joint_attention_dim, self.inner_dim)
        self.transformer_blocks = nn.ModuleList([
            QwenImageTransformerBlock(self.inner_dim, num_attention_heads, attention_head_dim)
            for _ in range(num_layers)])
        self.controlnet_blocks = nn.ModuleList([Linear(self.inner_dim, self.inner_dim) for _ in range(num_layers)])
        self.controlnet_x_embedder = Linear(in_channels + extra_condition_channels, self.inner_dim)
        self._zero_residual_paths()

    @torch.no_grad()
    def _zero_residual_paths(self) -> None:
        """Zero the residual projections and the condition embedder, so an
        untrained ControlNet adds nothing (JAX `init_params`)."""
        for lin in (*self.controlnet_blocks, self.controlnet_x_embedder):
            if not lin.weight.is_meta:
                lin.weight.zero_()
                lin.bias.zero_()

    @classmethod
    def from_transformer(cls, transformer, num_layers: int = 5, attention_head_dim: int = 128,
                         num_attention_heads: int = 24, load_weights_from_transformer: bool = True,
                         extra_condition_channels: int = 0) -> "QwenImageControlNetModel":
        """A ControlNet with `transformer`'s config and the given depth and
        heads, on its device and in its dtype; with
        `load_weights_from_transformer`, its time embedder, ``img_in``,
        ``txt_in``, ``txt_norm`` and first `num_layers` blocks are copies of
        the transformer's (JAX `:76-93`)."""
        accepted = set(inspect.signature(cls.__init__).parameters)
        config = {k: v for k, v in transformer.config.items() if k in accepted}
        config.update(num_layers=num_layers, attention_head_dim=attention_head_dim,
                      num_attention_heads=num_attention_heads, extra_condition_channels=extra_condition_channels)
        with torch.device(next(transformer.parameters()).device):
            controlnet = cls(**config)
        controlnet.to(dtype=transformer.dtype)
        if load_weights_from_transformer:
            for name in ("time_text_embed", "img_in", "txt_in", "txt_norm"):
                setattr(controlnet, name, copy.deepcopy(getattr(transformer, name)))
            for i in range(num_layers):
                controlnet.transformer_blocks[i] = copy.deepcopy(transformer.transformer_blocks[i])
        return controlnet

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, image_seq, in_channels] packed latents
        controlnet_cond: torch.Tensor,  # [B, image_seq, in_channels (+ extra)] packed condition
        conditioning_scale: float = 1.0,
        encoder_hidden_states: Optional[torch.Tensor] = None,
        encoder_hidden_states_mask: Optional[torch.Tensor] = None,
        timestep: Optional[torch.Tensor] = None,  # [B] in [0, 1]
        img_shapes: Optional[List[Tuple[int, int, int]]] = None,
        return_dict: bool = True,
    ):
        h = self.img_in(hidden_states) + self.controlnet_x_embedder(controlnet_cond)
        temb = self.time_text_embed(timestep.to(h.dtype), h.dtype)
        ctx = self.txt_in(self.txt_norm(encoder_hidden_states))
        rope = self.pos_embed(img_shapes, ctx.shape[1], device=h.device)
        bias = key_padding_bias(encoder_hidden_states_mask, h.shape[1])
        samples = []
        for block, proj in zip(self.transformer_blocks, self.controlnet_blocks):
            ctx, h = block(h, ctx, bias, temb, rope)
            samples.append(proj(h) * conditioning_scale)
        if not return_dict:
            return tuple(samples)
        return QwenImageControlNetOutput(controlnet_block_samples=tuple(samples))


class QwenImageMultiControlNetModel(nn.Module):
    """Several QwenImageControlNetModels whose residuals are summed (JAX
    `:135-155`): each gets its own condition and scale."""

    def __init__(self, controlnets: Sequence[QwenImageControlNetModel]):
        super().__init__()
        self.nets = nn.ModuleList(controlnets)

    def forward(self, hidden_states, controlnet_cond: List, conditioning_scale: List[float],
                **kwargs) -> QwenImageControlNetOutput:
        total = None
        for net, cond, scale in zip(self.nets, controlnet_cond, conditioning_scale):
            samples = net(hidden_states, cond, conditioning_scale=scale, return_dict=False, **kwargs)
            total = list(samples) if total is None else [t + s for t, s in zip(total, samples)]
        return QwenImageControlNetOutput(controlnet_block_samples=tuple(total))

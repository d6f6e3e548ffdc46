"""HunyuanVideo15Transformer3DModel: HunyuanVideo 1.5's dual-stream video DiT
(8.3 B at the published widths: 54 dual blocks of 16 heads x 128, 2
token-refiner layers, 2,048 wide; 65 input channels: 32 latent, 32 condition
latent and a mask; 32 out).

Port of `diffusers_tpu/models/transformers/transformer_hunyuan_video15.py`
with upstream diffusers' state-dict names. The dual block and the token
refiner are HunyuanVideo's, the patch embed and the ByT5 projection
HunyuanImage's. What is new:

* `HunyuanVideo15TimeEmbedding` (`:44`): the timestep embedding plus, under
  ``use_meanflow``, the ``timestep_r`` embedding (summed, not averaged);
* `HunyuanVideo15ImageProjection` (`:66`): LayerNorm, Linear, exact GELU,
  Linear, LayerNorm over SigLIP's image tokens;
* `cond_type_embed`: three rows, added to the Qwen (0), ByT5 (1) and image
  (2) streams;
* text-to-video is an all-zero `image_embeds` over the whole batch
  (`:190`): the image stream is then zeroed and masked. The test is a
  device tensor, so no host sync is made;
* `merge_condition_streams` (`:83-94`): ``[valid_image, valid_byt5,
  valid_mllm, invalid_image, 0, 0]``, a stable argsort on the device; the
  invalid text rows are zeroed, the invalid image rows kept;
* the 3-axis RoPE ``(16, 56, 56)``, theta 256, over the token grid.

The kept condition keys are a prefix after the merge, so the joint
attention's f32 key bias (`joint_bias`, JAX's bool mask) is HunyuanVideo's
`validity_bias` of the merged count. On the card every joint attention is
K1 at head_dim 128 (54 launches a call at full depth) and the refiner's two
self attentions are K1 under their 2-D mask: 56 a call.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...ops.module import Embedding, LayerNorm, Linear
from ...utils import BaseOutput
from ..embeddings import TimestepEmbedding, Timesteps
from ..modeling_utils import ModelMixin
from ..normalization import AdaLayerNormContinuous
from .transformer_hunyuan_video import HunyuanVideoTokenRefiner, HunyuanVideoTransformerBlock
from .transformer_hunyuanimage import (
    HunyuanImageByT5TextProjection,
    HunyuanImagePatchEmbed,
    RopeCache,
    _gather_tokens,
    joint_bias,
    token_grid_rope,
)


@dataclass
class Transformer2DModelOutput(BaseOutput):
    sample: torch.Tensor


class HunyuanVideo15TimeEmbedding(nn.Module):
    def __init__(self, embedding_dim: int, use_meanflow: bool = False):
        super().__init__()
        self.time_proj = Timesteps(num_channels=256, flip_sin_to_cos=True, downscale_freq_shift=0)
        self.timestep_embedder = TimestepEmbedding(in_channels=256, time_embed_dim=embedding_dim)
        self.use_meanflow = use_meanflow
        if use_meanflow:
            self.timestep_embedder_r = TimestepEmbedding(in_channels=256, time_embed_dim=embedding_dim)

    def forward(self, timestep, timestep_r=None):
        dtype = self.timestep_embedder.linear_1.weight.dtype
        temb = self.timestep_embedder(self.time_proj(timestep).to(dtype))
        if timestep_r is not None:
            temb = temb + self.timestep_embedder_r(self.time_proj(timestep_r).to(dtype))
        return temb


class HunyuanVideo15ImageProjection(nn.Module):
    def __init__(self, in_channels: int, hidden_size: int):
        super().__init__()
        self.norm_in = LayerNorm(in_channels)
        self.linear_1 = Linear(in_channels, in_channels)
        self.linear_2 = Linear(in_channels, hidden_size)
        self.norm_out = LayerNorm(hidden_size)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.linear_1(self.norm_in(image_embeds)))
        return self.norm_out(self.linear_2(x))


def merge_condition_streams(image, image_mask, text_2, text_mask_2, text, text_mask):
    """``[valid_image, valid_byt5, valid_mllm, invalid_image, 0, 0]`` with the
    bool mask in the same order (JAX `:83-94`)."""
    text_mask_2, text_mask = text_mask_2.bool(), text_mask.bool()
    text_2 = torch.where(text_mask_2[..., None], text_2, torch.zeros((), dtype=text_2.dtype, device=text_2.device))
    text = torch.where(text_mask[..., None], text, torch.zeros((), dtype=text.dtype, device=text.device))
    combined = torch.cat([image, text_2, text], dim=1)
    mask = torch.cat([image_mask, text_mask_2, text_mask], dim=1)
    return _gather_tokens(combined, mask, (~mask).long())


class HunyuanVideo15Transformer3DModel(ModelMixin, ConfigMixin):
    """Input and output are channel-first [B, C, F, H, W]."""

    @register_to_config
    def __init__(
        self,
        in_channels: int = 65,
        out_channels: int = 32,
        num_attention_heads: int = 16,
        attention_head_dim: int = 128,
        num_layers: int = 54,
        num_refiner_layers: int = 2,
        mlp_ratio: float = 4.0,
        patch_size: int = 1,
        patch_size_t: int = 1,
        qk_norm: str = "rms_norm",
        text_embed_dim: int = 3584,
        text_embed_2_dim: int = 1472,
        image_embed_dim: int = 1152,
        rope_theta: float = 256.0,
        rope_axes_dim: Tuple[int, ...] = (16, 56, 56),
        target_size: int = 640,
        task_type: str = "i2v",
        use_meanflow: bool = False,
    ):
        super().__init__()
        inner_dim = num_attention_heads * attention_head_dim
        self.out_channels = out_channels or in_channels
        self.x_embedder = HunyuanImagePatchEmbed((patch_size_t, patch_size, patch_size), in_channels, inner_dim)
        self.image_embedder = HunyuanVideo15ImageProjection(image_embed_dim, inner_dim)
        self.context_embedder = HunyuanVideoTokenRefiner(text_embed_dim, num_attention_heads, attention_head_dim,
                                                         num_layers=num_refiner_layers)
        self.context_embedder_2 = HunyuanImageByT5TextProjection(text_embed_2_dim, 2048, inner_dim)
        self.time_embed = HunyuanVideo15TimeEmbedding(inner_dim, use_meanflow=use_meanflow)
        self.cond_type_embed = Embedding(3, inner_dim)
        self.transformer_blocks = nn.ModuleList([
            HunyuanVideoTransformerBlock(num_attention_heads, attention_head_dim, mlp_ratio, qk_norm)
            for _ in range(num_layers)])
        self.norm_out = AdaLayerNormContinuous(inner_dim, inner_dim, elementwise_affine=False, eps=1e-6)
        self.proj_out = Linear(inner_dim, patch_size_t * patch_size * patch_size * self.out_channels)
        self._rope = RopeCache(rope_axes_dim, rope_theta)

    def post_patch_sizes(self, num_frames: int, height: int, width: int) -> Tuple[int, int, int]:
        c = self.config
        return num_frames // c.patch_size_t, height // c.patch_size, width // c.patch_size

    def rope(self, num_frames: int, height: int, width: int) -> Tuple[np.ndarray, np.ndarray]:
        """Host (cos, sin) tables of the post-patchify token grid of a
        [F, H, W] latent (JAX `rope`)."""
        c = self.config
        return token_grid_rope(c.rope_axes_dim, c.rope_theta, self.post_patch_sizes(num_frames, height, width))

    def condition_tokens(self, encoder_hidden_states, encoder_attention_mask, timestep, encoder_hidden_states_2,
                         encoder_attention_mask_2, image_embeds):
        """The merged condition stream and its bool mask: the refined Qwen
        tokens, the projected ByT5 tokens and the projected image tokens,
        each plus its `cond_type_embed` row."""
        table = self.cond_type_embed.weight
        text = self.context_embedder(encoder_hidden_states, timestep, encoder_attention_mask) + table[0]
        text_2 = self.context_embedder_2(encoder_hidden_states_2) + table[1]
        image = self.image_embedder(image_embeds)
        is_t2v = (image_embeds == 0).all()
        image = torch.where(is_t2v, torch.zeros((), dtype=image.dtype, device=image.device), image) + table[2]
        image_mask = (~is_t2v).expand(image.shape[0], image.shape[1])
        return merge_condition_streams(image, image_mask, text_2, encoder_attention_mask_2, text,
                                       encoder_attention_mask)

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, C, F, H, W]
        timestep: torch.Tensor,  # [B]
        encoder_hidden_states: torch.Tensor,  # [B, S1, text_embed_dim]
        encoder_attention_mask: torch.Tensor,  # [B, S1]
        timestep_r: Optional[torch.Tensor] = None,
        encoder_hidden_states_2: Optional[torch.Tensor] = None,
        encoder_attention_mask_2: Optional[torch.Tensor] = None,
        image_embeds: Optional[torch.Tensor] = None,  # [B, S3, image_embed_dim]
        image_rotary_emb: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        return_dict: bool = True,
    ):
        batch_size, _, num_frames, height, width = hidden_states.shape
        post = self.post_patch_sizes(num_frames, height, width)
        if image_rotary_emb is None:
            image_rotary_emb = self._rope(post, hidden_states.device)

        temb = self.time_embed(timestep, timestep_r)
        hidden_states = self.x_embedder(hidden_states)
        encoder_hidden_states, text_mask = self.condition_tokens(
            encoder_hidden_states, encoder_attention_mask, timestep, encoder_hidden_states_2,
            encoder_attention_mask_2, image_embeds)
        bias = joint_bias(text_mask, hidden_states.shape[1])
        for block in self.transformer_blocks:
            hidden_states, encoder_hidden_states = block(hidden_states, encoder_hidden_states, temb, bias,
                                                         image_rotary_emb)
        hidden_states = self.proj_out(self.norm_out(hidden_states, temb))

        p_t, p = self.config.patch_size_t, self.config.patch_size
        hidden_states = hidden_states.reshape(batch_size, *post, self.out_channels, p_t, p, p)
        out = hidden_states.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(
            batch_size, self.out_channels, post[0] * p_t, post[1] * p, post[2] * p)
        if not return_dict:
            return (out,)
        return Transformer2DModelOutput(sample=out)

"""HunyuanImageTransformer2DModel: HunyuanImage-2.1's dual- and single-stream
image DiT (17 B at the published widths: 20 dual and 40 single blocks of 28
heads x 128, 2 token-refiner layers, 3,584 wide, a ByT5 glyph stream 1,472
wide).

Port of `diffusers_tpu/models/transformers/transformer_hunyuanimage.py` with
upstream diffusers' state-dict names. The dual and single blocks and the
token refiner are HunyuanVideo's (`transformer_hunyuan_video.py`); what is
new:

* `HunyuanImagePatchEmbed` (`:48`): a strided `Conv2d` (or `Conv3d` for a
  3-entry patch) to [B, N, C] tokens;
* `HunyuanImageByT5TextProjection` (`:63`): LayerNorm, then three Linears
  with exact GELU between them;
* `HunyuanImageCombinedTimeGuidanceEmbedding` (`:80`): the timestep
  embedding, averaged with the meanflow ``timestep_r`` embedding where it is
  given, plus the distilled guidance through the same sinusoidal projection;
  no pooled text;
* `merge_text_streams` (`:107-118`): the ByT5 and the refined Qwen tokens
  ordered ``[valid_byt5, valid_mllm, invalid_byt5, invalid_mllm]`` by a
  stable argsort of group keys, on the device (no host round trip);
* the 2-axis RoPE over the token grid (``rope_axes_dim=(64, 64)``, theta
  256, `:166`), made on the host in f64 and kept a shape on the model's
  device;
* the unpatchify (`:222-232`).

The joint attention's keys are the image tokens, then the text; the
dropped text keys reach kernel K1 as an f32 ``[B, 1, 1, N]`` ``-inf`` bias
(`joint_bias`), JAX's bool mask. After the merge the kept text keys are a
prefix, so the bias is HunyuanVideo's `validity_bias` of the merged count.
On the card every joint attention is K1 at head_dim 128 (60 launches a call
at full depth) and the refiner's two self attentions are K1 under their
2-D mask: 62 a call.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...ops.module import Conv2d, Conv3d, LayerNorm, Linear
from ...utils import BaseOutput
from ..embeddings import TimestepEmbedding, Timesteps
from ..modeling_utils import ModelMixin
from ..normalization import AdaLayerNormContinuous
from .transformer_hunyuan_video import (
    HunyuanVideoSingleTransformerBlock,
    HunyuanVideoTokenRefiner,
    HunyuanVideoTransformerBlock,
    grid_rope_tables,
)


@dataclass
class Transformer2DModelOutput(BaseOutput):
    sample: torch.Tensor


class HunyuanImagePatchEmbed(nn.Module):
    """NC(F)HW latents -> [B, N, C] tokens through one strided convolution."""

    def __init__(self, patch_size: Sequence[int], in_chans: int, embed_dim: int):
        super().__init__()
        conv = Conv2d if len(patch_size) == 2 else Conv3d
        self.proj = conv(in_chans, embed_dim, kernel_size=tuple(patch_size), stride=tuple(patch_size))

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        return self.proj(hidden_states).flatten(2).transpose(1, 2)


class HunyuanImageByT5TextProjection(nn.Module):
    def __init__(self, in_features: int, hidden_size: int, out_features: int):
        super().__init__()
        self.norm = LayerNorm(in_features)
        self.linear_1 = Linear(in_features, hidden_size)
        self.linear_2 = Linear(hidden_size, hidden_size)
        self.linear_3 = Linear(hidden_size, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.linear_1(self.norm(x)))
        return self.linear_3(F.gelu(self.linear_2(x)))


class HunyuanImageCombinedTimeGuidanceEmbedding(nn.Module):
    def __init__(self, embedding_dim: int, guidance_embeds: bool = False, use_meanflow: bool = False):
        super().__init__()
        self.time_proj = Timesteps(num_channels=256, flip_sin_to_cos=True, downscale_freq_shift=0)
        self.timestep_embedder = TimestepEmbedding(in_channels=256, time_embed_dim=embedding_dim)
        self.use_meanflow = use_meanflow
        if use_meanflow:
            self.timestep_embedder_r = TimestepEmbedding(in_channels=256, time_embed_dim=embedding_dim)
        self.guidance_embedder = (TimestepEmbedding(in_channels=256, time_embed_dim=embedding_dim)
                                  if guidance_embeds else None)

    def _embed(self, embedder, t):
        return embedder(self.time_proj(t).to(self.timestep_embedder.linear_1.weight.dtype))

    def forward(self, timestep, timestep_r=None, guidance=None):
        temb = self._embed(self.timestep_embedder, timestep)
        if timestep_r is not None:
            temb = (temb + self._embed(self.timestep_embedder_r, timestep_r)) / 2
        if self.guidance_embedder is not None:
            temb = temb + self._embed(self.guidance_embedder, guidance)
        return temb


def _gather_tokens(tokens: torch.Tensor, mask: torch.Tensor, group: torch.Tensor):
    """(tokens, mask) reordered along axis 1 by a stable argsort of `group`."""
    order = torch.argsort(group, dim=1, stable=True)
    merged = torch.gather(tokens, 1, order[..., None].expand(-1, -1, tokens.shape[-1]))
    return merged, torch.gather(mask, 1, order)


def merge_text_streams(text, text_mask, text_2, text_mask_2):
    """The ByT5 and Qwen streams as ``[valid_byt5, valid_mllm, invalid_byt5,
    invalid_mllm]``, with the bool mask in the same order (JAX `:107-118`)."""
    combined = torch.cat([text_2, text], dim=1)
    mask = torch.cat([text_mask_2.bool(), text_mask.bool()], dim=1)
    is_mllm = (torch.arange(combined.shape[1], device=mask.device) >= text_2.shape[1]).long()[None]
    group = torch.where(mask, 0, 2) + is_mllm
    return _gather_tokens(combined, mask, group)


def joint_bias(text_mask: torch.Tensor, img_len: int) -> torch.Tensor:
    """The joint sequence's f32 [B, 1, 1, S_img + S_txt] key bias: 0 on every
    image key and on the text keys `text_mask` keeps, ``-inf`` on the others
    (JAX's bool mask, `:205-207`)."""
    keep = torch.cat([torch.ones((text_mask.shape[0], img_len), dtype=torch.bool, device=text_mask.device),
                      text_mask.bool()], dim=1)
    zero = torch.zeros((), dtype=torch.float32, device=text_mask.device)
    return torch.where(keep, zero, -math.inf)[:, None, None, :]


def token_grid_rope(axes_dim, theta: float, sizes: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """The RoPE tables of a token grid of `sizes` (JAX `rope` `:166`)."""
    return grid_rope_tables(axes_dim, theta, [np.arange(n) for n in sizes])


class RopeCache:
    """The RoPE tables of a token grid, made once a (grid, device)."""

    def __init__(self, axes_dim, theta: float):
        self.axes_dim, self.theta = tuple(axes_dim), theta
        self._tables: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def __call__(self, sizes: Sequence[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
        key = (tuple(sizes), str(device))
        if key not in self._tables:
            cos, sin = token_grid_rope(self.axes_dim, self.theta, sizes)
            self._tables[key] = (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))
        return self._tables[key]


class HunyuanImageTransformer2DModel(ModelMixin, ConfigMixin):
    @register_to_config
    def __init__(
        self,
        in_channels: int = 64,
        out_channels: int = 64,
        num_attention_heads: int = 28,
        attention_head_dim: int = 128,
        num_layers: int = 20,
        num_single_layers: int = 40,
        num_refiner_layers: int = 2,
        mlp_ratio: float = 4.0,
        patch_size: Tuple[int, ...] = (1, 1),
        qk_norm: str = "rms_norm",
        guidance_embeds: bool = False,
        text_embed_dim: int = 3584,
        text_embed_2_dim: Optional[int] = None,
        rope_theta: float = 256.0,
        rope_axes_dim: Tuple[int, ...] = (64, 64),
        use_meanflow: bool = False,
    ):
        super().__init__()
        inner_dim = num_attention_heads * attention_head_dim
        self.out_channels = out_channels or in_channels
        self.x_embedder = HunyuanImagePatchEmbed(tuple(patch_size), in_channels, inner_dim)
        self.context_embedder = HunyuanVideoTokenRefiner(text_embed_dim, num_attention_heads, attention_head_dim,
                                                         num_layers=num_refiner_layers)
        self.context_embedder_2 = (HunyuanImageByT5TextProjection(text_embed_2_dim, 2048, inner_dim)
                                   if text_embed_2_dim is not None else None)
        self.time_guidance_embed = HunyuanImageCombinedTimeGuidanceEmbedding(inner_dim, guidance_embeds, use_meanflow)
        self.transformer_blocks = nn.ModuleList([
            HunyuanVideoTransformerBlock(num_attention_heads, attention_head_dim, mlp_ratio, qk_norm)
            for _ in range(num_layers)])
        self.single_transformer_blocks = nn.ModuleList([
            HunyuanVideoSingleTransformerBlock(num_attention_heads, attention_head_dim, mlp_ratio, qk_norm)
            for _ in range(num_single_layers)])
        self.norm_out = AdaLayerNormContinuous(inner_dim, inner_dim, elementwise_affine=False, eps=1e-6)
        self.proj_out = Linear(inner_dim, math.prod(patch_size) * self.out_channels)
        self._rope = RopeCache(rope_axes_dim, rope_theta)

    def post_patch_sizes(self, sizes: Sequence[int]) -> Tuple[int, ...]:
        return tuple(d // p for d, p in zip(sizes, self.config.patch_size))

    def rope(self, *sizes: int) -> Tuple[np.ndarray, np.ndarray]:
        """Host (cos, sin) tables of the post-patchify grid of a latent of
        `sizes` (JAX `:166`)."""
        c = self.config
        return token_grid_rope(c.rope_axes_dim, c.rope_theta, self.post_patch_sizes(sizes))

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, C, H, W] (or [B, C, F, H, W])
        timestep: torch.Tensor,  # [B]
        encoder_hidden_states: torch.Tensor,  # [B, S1, text_embed_dim]
        encoder_attention_mask: torch.Tensor,  # [B, S1]
        timestep_r: Optional[torch.Tensor] = None,
        encoder_hidden_states_2: Optional[torch.Tensor] = None,
        encoder_attention_mask_2: Optional[torch.Tensor] = None,
        guidance: Optional[torch.Tensor] = None,
        image_rotary_emb: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        return_dict: bool = True,
    ):
        batch_size = hidden_states.shape[0]
        post = self.post_patch_sizes(hidden_states.shape[2:])
        if image_rotary_emb is None:
            image_rotary_emb = self._rope(post, hidden_states.device)

        temb = self.time_guidance_embed(timestep, timestep_r, guidance)
        hidden_states = self.x_embedder(hidden_states)
        encoder_hidden_states = self.context_embedder(encoder_hidden_states, timestep, encoder_attention_mask)
        text_mask = encoder_attention_mask.bool()
        if self.context_embedder_2 is not None and encoder_hidden_states_2 is not None:
            encoder_hidden_states, text_mask = merge_text_streams(
                encoder_hidden_states, text_mask, self.context_embedder_2(encoder_hidden_states_2),
                encoder_attention_mask_2)
        bias = joint_bias(text_mask, hidden_states.shape[1])

        for block in self.transformer_blocks:
            hidden_states, encoder_hidden_states = block(hidden_states, encoder_hidden_states, temb, bias,
                                                         image_rotary_emb)
        for block in self.single_transformer_blocks:
            hidden_states, encoder_hidden_states = block(hidden_states, encoder_hidden_states, temb, bias,
                                                         image_rotary_emb)
        hidden_states = self.proj_out(self.norm_out(hidden_states, temb))

        p = tuple(self.config.patch_size)
        n = len(post)
        hidden_states = hidden_states.reshape(batch_size, *post, self.out_channels, *p)
        perm = [0, n + 1] + [a for i in range(n) for a in (i + 1, n + 2 + i)]
        out = hidden_states.permute(*perm).reshape(batch_size, self.out_channels,
                                                   *[a * b for a, b in zip(post, p)])
        if not return_dict:
            return (out,)
        return Transformer2DModelOutput(sample=out)

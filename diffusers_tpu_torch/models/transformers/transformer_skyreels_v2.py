"""SkyReelsV2Transformer3DModel: Skywork's Wan-derived video DiT.

Port of `diffusers_tpu/models/transformers/transformer_skyreels_v2.py`
(`SkyReelsV2Transformer3DModel` `:42`): Wan blocks plus
  * a block-causal self-attention keep-mask over frame blocks of
    `num_frame_per_block` latent frames (`_causal_mask` `:102-113`, a bool
    [1, 1, N, N] made on the host; none at the default of 1);
  * fps conditioning under `inject_sample_info` (`fps_embedding`, and
    `fps_projection`'s Linear + SiLU added to the timestep projection);
  * diffusion forcing (`enable_diffusion_forcing`): [B, F'] timesteps, one a
    latent frame, broadcast to a modulation per token, [B, 6, N, D], for
    every block (`:157-163`) and [B, N, D] for the head (`:170-175`).
On the card the mask reaches K1 as an additive float32 [1, 1, N, N] tensor
that every head reads (10.4 GB at 51,000 tokens), so masked runs are held at
small sizes; the diffusion-forcing modulation is float32 [B, 6, N, D] a
block (6.3 GB at 51,000 x 5,120).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...ops.module import Conv3d, Embedding, LayerNorm, Linear
from ..attention_blocks import FeedForward
from ..modeling_utils import ModelMixin
from .transformer_wan import (
    Transformer3DModelOutput,
    WanRotaryMixin,
    WanRotaryPosEmbed,
    WanTimeTextImageEmbedding,
    WanTransformerBlock,
    wan_output,
)


class SkyReelsV2Transformer3DModel(WanRotaryMixin, ModelMixin, ConfigMixin):
    @register_to_config
    def __init__(
        self,
        patch_size: Tuple[int, ...] = (1, 2, 2),
        num_attention_heads: int = 16,
        attention_head_dim: int = 128,
        in_channels: int = 16,
        out_channels: int = 16,
        text_dim: int = 4096,
        freq_dim: int = 256,
        ffn_dim: int = 8192,
        num_layers: int = 32,
        cross_attn_norm: bool = True,
        qk_norm: Optional[str] = "rms_norm_across_heads",
        eps: float = 1e-6,
        image_dim: Optional[int] = None,
        added_kv_proj_dim: Optional[int] = None,
        rope_max_seq_len: int = 1024,
        pos_embed_seq_len: Optional[int] = None,
        inject_sample_info: bool = False,
        num_frame_per_block: int = 1,
    ):
        super().__init__()
        patch_size = tuple(patch_size)
        self.inner_dim = inner_dim = num_attention_heads * attention_head_dim
        self.out_channels = out_channels or in_channels
        self.rope = WanRotaryPosEmbed(attention_head_dim, patch_size, rope_max_seq_len)
        self.patch_embedding = Conv3d(in_channels, inner_dim, kernel_size=patch_size, stride=patch_size)
        self.condition_embedder = WanTimeTextImageEmbedding(
            dim=inner_dim, time_freq_dim=freq_dim, time_proj_dim=inner_dim * 6, text_embed_dim=text_dim,
            image_embed_dim=image_dim, pos_embed_seq_len=pos_embed_seq_len)
        self.blocks = nn.ModuleList([
            WanTransformerBlock(inner_dim, ffn_dim, num_attention_heads, qk_norm, cross_attn_norm, eps,
                                added_kv_proj_dim)
            for _ in range(num_layers)
        ])
        self.norm_out = LayerNorm(inner_dim, eps=eps, use_scale=False, use_bias=False)
        self.proj_out = Linear(inner_dim, self.out_channels * math.prod(patch_size))
        if inject_sample_info:
            self.fps_embedding = Embedding(2, inner_dim)
            self.fps_projection = FeedForward(inner_dim, inner_dim * 6, mult=1, activation_fn="linear-silu")
        self.scale_shift_table = nn.Parameter(torch.randn(1, 2, inner_dim) / inner_dim**0.5)

    def causal_mask(self, ppf: int, pph: int, ppw: int) -> Optional[np.ndarray]:
        """The block-causal bool keep-mask [1, 1, N, N] over a (ppf, pph, ppw)
        token grid: a token sees the tokens of its own and earlier frame
        blocks. None when `num_frame_per_block` <= 1."""
        nfb = self.config.num_frame_per_block
        if nfb <= 1:
            return None
        if ppf % nfb:
            raise ValueError(f"{ppf} latent frames do not split into blocks of num_frame_per_block={nfb}")
        block = np.repeat(np.arange(ppf // nfb), nfb)
        causal = block[None, :] <= block[:, None]  # [f, f]
        n = ppf * pph * ppw
        mask = np.broadcast_to(causal[:, None, None, :, None, None], (ppf, pph, ppw, ppf, pph, ppw)).reshape(n, n)
        return mask[None, None]

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, C, F, H, W]
        timestep: torch.Tensor,  # [B], or [B, F'] with diffusion forcing
        encoder_hidden_states: torch.Tensor,
        encoder_hidden_states_image: Optional[torch.Tensor] = None,
        enable_diffusion_forcing: bool = False,
        fps: Optional[torch.Tensor] = None,
        rotary_emb: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        return_dict: bool = True,
    ) -> Union[Transformer3DModelOutput, tuple]:
        b, _, f, h, w = hidden_states.shape
        p_t, p_h, p_w = self.config.patch_size
        ppf, pph, ppw = grid = (f // p_t, h // p_h, w // p_w)
        if rotary_emb is None:
            rotary_emb = self.rotary_tables(hidden_states)
        x = self.patch_embedding(hidden_states).flatten(2).transpose(1, 2)  # [B, tokens, D], (f, h, w) order

        mask = self.causal_mask(ppf, pph, ppw)
        attention_mask = None if mask is None else torch.from_numpy(np.ascontiguousarray(mask)).to(x.device)

        ts = timestep.reshape(-1) if enable_diffusion_forcing else timestep
        temb, timestep_proj, text, image = self.condition_embedder(ts, encoder_hidden_states,
                                                                   encoder_hidden_states_image)
        timestep_proj = timestep_proj.reshape(timestep_proj.shape[0], 6, -1)
        context = text if image is None else torch.cat([image, text], dim=1)

        if self.config.inject_sample_info:
            if fps is None:
                raise ValueError("a SkyReels-V2 model with `inject_sample_info` needs `fps` (0 or 1 a sample)")
            fps = torch.as_tensor(fps, dtype=torch.long, device=x.device).reshape(-1)
            fps_proj = self.fps_projection(self.fps_embedding(fps)).reshape(-1, 6, self.inner_dim)
            if enable_diffusion_forcing:
                fps_proj = fps_proj.repeat(timestep.shape[1], 1, 1)
            timestep_proj = timestep_proj + fps_proj

        if enable_diffusion_forcing:  # a frame's modulation for each of its tokens: [B * F', 6, D] -> [B, 6, N, D]
            fl, tokens = timestep.shape[1], pph * ppw
            temb = temb.reshape(b, fl, 1, -1).expand(b, fl, tokens, temb.shape[-1]).reshape(b, fl * tokens, -1)
            tp = timestep_proj.reshape(b, fl, 1, 6, -1).expand(b, fl, tokens, 6, timestep_proj.shape[-1])
            timestep_proj = tp.reshape(b, fl * tokens, 6, -1).transpose(1, 2)

        for block in self.blocks:
            x = block(x, context, timestep_proj, rotary_emb, attention_mask=attention_mask)

        output = wan_output(self, x, temb, grid)
        return Transformer3DModelOutput(sample=output) if return_dict else (output,)

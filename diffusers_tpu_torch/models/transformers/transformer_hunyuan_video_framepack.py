"""HunyuanVideoFramepackTransformer3DModel: HunyuanVideo's DiT with FramePack's
history conditioning (next-frame-section prediction).

Port of `diffusers_tpu/models/transformers/transformer_hunyuan_video_framepack.py`:
HunyuanVideo's dual and single blocks (the port's
`HunyuanVideoTransformer3DModel`, whose config this one extends) plus

* the history patch embeds (`HunyuanVideoHistoryPatchEmbed`): clean latents
  at 1x (kernel 1 x 2 x 2), 2x (2 x 4 x 4) and 4x (4 x 8 x 8), the
  downsampled streams replicate-padded to their kernel first (`:44`);
* the SigLIP image projection (`FramepackClipVisionProjection`), whose
  tokens come before the text in the joined sequence and count as valid;
* the RoPE from explicit frame indices (`rope`), the downsampled streams'
  tables centre-averaged over their kernel (`_pad_rotary_emb`), and the
  packed table in the [4x, 2x, clean, latents] order the streams are
  prepended in (`pack_rope`);
* the prediction sliced back to the current section's tokens.

On the card each joint attention is kernel K1 under the key-padding bias, as
in HunyuanVideo.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...configuration_utils import register_to_config
from ...ops.module import Conv3d, Linear
from .transformer_hunyuan_video import (
    HunyuanVideoTransformer3DModel,
    Transformer2DModelOutput,
    rope_tables,
    validity_bias,
)


def _pad_for_3d_conv(x: torch.Tensor, kernel_size) -> torch.Tensor:
    """Replicate-pad NCDHW so each of (T, H, W) divides the kernel."""
    _, _, t, h, w = x.shape
    pt, ph, pw = kernel_size
    return F.pad(x, (0, (pw - w % pw) % pw, 0, (ph - h % ph) % ph, 0, (pt - t % pt) % pt), mode="replicate")


class FramepackClipVisionProjection(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.up = Linear(in_channels, out_channels * 3)
        self.down = Linear(out_channels * 3, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.up(x)))


class HunyuanVideoHistoryPatchEmbed(nn.Module):
    def __init__(self, in_channels: int, inner_dim: int):
        super().__init__()
        self.proj = Conv3d(in_channels, inner_dim, kernel_size=(1, 2, 2), stride=(1, 2, 2))
        self.proj_2x = Conv3d(in_channels, inner_dim, kernel_size=(2, 4, 4), stride=(2, 4, 4))
        self.proj_4x = Conv3d(in_channels, inner_dim, kernel_size=(4, 8, 8), stride=(4, 8, 8))

    @staticmethod
    def _embed(x, kernel, conv):
        if x is None:
            return None
        if kernel is not None:
            x = _pad_for_3d_conv(x, kernel)
        return conv(x).flatten(2).transpose(1, 2)

    def forward(self, latents_clean=None, latents_2x=None, latents_4x=None):
        return (self._embed(latents_clean, None, self.proj), self._embed(latents_2x, (2, 4, 4), self.proj_2x),
                self._embed(latents_4x, (4, 8, 8), self.proj_4x))


class HunyuanVideoFramepackTransformer3DModel(HunyuanVideoTransformer3DModel):
    @register_to_config
    def __init__(
        self,
        in_channels: int = 16,
        out_channels: int = 16,
        num_attention_heads: int = 24,
        attention_head_dim: int = 128,
        num_layers: int = 20,
        num_single_layers: int = 40,
        num_refiner_layers: int = 2,
        mlp_ratio: float = 4.0,
        patch_size: int = 2,
        patch_size_t: int = 1,
        qk_norm: str = "rms_norm",
        guidance_embeds: bool = True,
        text_embed_dim: int = 4096,
        pooled_projection_dim: int = 768,
        rope_theta: float = 256.0,
        rope_axes_dim: Tuple[int, ...] = (16, 56, 56),
        image_condition_type: Optional[str] = None,
        has_image_proj: bool = False,
        image_proj_dim: int = 1152,
        has_clean_x_embedder: bool = False,
    ):
        super().__init__(in_channels=in_channels, out_channels=out_channels, num_attention_heads=num_attention_heads,
                         attention_head_dim=attention_head_dim, num_layers=num_layers,
                         num_single_layers=num_single_layers, num_refiner_layers=num_refiner_layers,
                         mlp_ratio=mlp_ratio, patch_size=patch_size, patch_size_t=patch_size_t, qk_norm=qk_norm,
                         guidance_embeds=guidance_embeds, text_embed_dim=text_embed_dim,
                         pooled_projection_dim=pooled_projection_dim, rope_theta=rope_theta,
                         rope_axes_dim=rope_axes_dim, image_condition_type=image_condition_type)
        self.clean_x_embedder = HunyuanVideoHistoryPatchEmbed(in_channels, self.inner_dim) if has_clean_x_embedder else None
        self.image_projection = (FramepackClipVisionProjection(image_proj_dim, self.inner_dim) if has_image_proj
                                 else None)

    # ------------------------------------------------------------------ rope
    def rope(self, frame_indices, height: int, width: int) -> Tuple[np.ndarray, np.ndarray]:
        """Host (cos, sin) tables over (frame_indices x H/p x W/p) (JAX
        `:116-134`)."""
        c = self.config
        return rope_tables(c.rope_axes_dim, c.rope_theta, np.asarray(frame_indices).reshape(-1),
                           height // c.patch_size, width // c.patch_size)

    @staticmethod
    def _pad_rotary_emb(emb, height: int, width: int, kernel):
        """Centre-average a full-resolution table down to a history stream's
        token grid: replicate pad, then the mean over each kernel window
        (JAX `:158-170`)."""
        def pool(f):
            t = f.shape[0] // (height * width)
            x = f.T.reshape(1, -1, t, height, width)
            pads = [(0, 0), (0, 0)] + [(0, (k - s % k) % k) for s, k in zip(x.shape[2:], kernel)]
            x = np.pad(x, pads, mode="edge")
            _, c, tt, hh, ww = x.shape
            kt, kh, kw = kernel
            x = x.reshape(c, tt // kt, kt, hh // kh, kh, ww // kw, kw).mean(axis=(2, 4, 6))
            return x.reshape(c, -1).T

        return pool(emb[0]), pool(emb[1])

    def pack_rope(self, height: int, width: int, indices_latents, indices_clean=None, indices_2x=None,
                  indices_4x=None) -> Tuple[np.ndarray, np.ndarray]:
        """The packed sequence's table in the [4x, 2x, clean, latents] order
        (JAX `:136-156`)."""
        post_h, post_w = height // self.config.patch_size, width // self.config.patch_size
        parts = []
        if indices_4x is not None:
            parts.append(self._pad_rotary_emb(self.rope(indices_4x, height, width), post_h, post_w, (4, 4, 4)))
        if indices_2x is not None:
            parts.append(self._pad_rotary_emb(self.rope(indices_2x, height, width), post_h, post_w, (2, 2, 2)))
        if indices_clean is not None:
            parts.append(self.rope(indices_clean, height, width))
        parts.append(self.rope(indices_latents, height, width))
        return np.concatenate([c for c, _ in parts], axis=0), np.concatenate([s for _, s in parts], axis=0)

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, C, F, H, W]
        timestep: torch.Tensor,  # [B]
        encoder_hidden_states: torch.Tensor,
        encoder_attention_mask: torch.Tensor,
        pooled_projections: torch.Tensor,
        image_embeds: torch.Tensor,
        indices_latents=None,
        guidance: Optional[torch.Tensor] = None,
        latents_clean: Optional[torch.Tensor] = None,
        indices_latents_clean=None,
        latents_history_2x: Optional[torch.Tensor] = None,
        indices_latents_history_2x=None,
        latents_history_4x: Optional[torch.Tensor] = None,
        indices_latents_history_4x=None,
        image_rotary_emb: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        return_dict: bool = True,
    ):
        """`image_rotary_emb`, when given, is the whole packed sequence's
        table (`pack_rope`) on the device; else it is made from the indices
        of the streams given."""
        batch_size, _, num_frames, height, width = hidden_states.shape
        p, p_t = self.config.patch_size, self.config.patch_size_t
        post_f, post_h, post_w = num_frames // p_t, height // p, width // p
        section_tokens = post_f * post_h * post_w
        device = hidden_states.device

        hidden = self.x_embedder(hidden_states)
        if image_rotary_emb is None:
            streams = {}
            if self.clean_x_embedder is not None:
                streams = dict(indices_clean=indices_latents_clean if latents_clean is not None else None,
                               indices_2x=indices_latents_history_2x if latents_history_2x is not None else None,
                               indices_4x=indices_latents_history_4x if latents_history_4x is not None else None)
            cos, sin = self.pack_rope(height, width,
                                      np.arange(num_frames) if indices_latents is None else indices_latents,
                                      **streams)
            image_rotary_emb = (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))
        if self.clean_x_embedder is not None:
            for emb in self.clean_x_embedder(latents_clean, latents_history_2x, latents_history_4x):
                if emb is not None:  # prepended in the order clean, 2x, 4x (JAX `_pack_history_states`)
                    hidden = torch.cat([emb, hidden], dim=1)

        temb, token_replace_emb = self.time_text_embed(timestep, pooled_projections, guidance)
        encoder_hidden = self.context_embedder(encoder_hidden_states, timestep, encoder_attention_mask)
        if self.image_projection is not None:  # the image tokens before the text (JAX `:243-248`)
            image_tokens = self.image_projection(image_embeds)
            encoder_hidden = torch.cat([image_tokens, encoder_hidden], dim=1)
            encoder_attention_mask = torch.cat([
                torch.ones(image_tokens.shape[:2], dtype=encoder_attention_mask.dtype, device=device),
                encoder_attention_mask], dim=1)

        bias = validity_bias(encoder_attention_mask, hidden.shape[1])
        hidden, _ = self.run_blocks(hidden, encoder_hidden, temb, bias, image_rotary_emb, token_replace_emb,
                                    post_h * post_w)
        out = self.unpatchify(hidden[:, -section_tokens:], temb, batch_size, post_f, post_h, post_w)
        if not return_dict:
            return (out,)
        return Transformer2DModelOutput(sample=out)

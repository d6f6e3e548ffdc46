"""QwenImageTransformer2DModel: Qwen-Image's double-stream DiT (20.4 B at
the published widths: 60 blocks of 24 heads x 128, joint dim 3584).

Port of `diffusers_tpu/models/transformers/transformer_qwenimage.py`:
`QwenEmbedRope` (`:49-99`: centre-symmetric image positions with
``scale_rope``, the text positions after the largest image index, f64 angle
tables made on the host, f32 cos / sin), the interleaved rotation
(`_rotate_interleaved` `:37`), the double-stream attention (`:102-160`:
per-head RMSNorms on q/k and on the added q/k, the text stream concatenated
before the image stream, one joint attention under an f32 ``[B, 1, 1, S]``
key-padding bias of ``-inf`` on padded text keys), the block (`:178-225`:
modulation in the order shift, scale, gate, which is not Flux's
`AdaLayerNormZero` order), `QwenTimestepProjEmbeddings`, the
`AdaLayerNormContinuous` output and `controlnet_block_samples`, added after
each block by the interval rule (`:294-297`).

The joint attention goes through the dispatch layer: on the card it is
kernel K1 at head_dim 128, one launch a block, the bias read through its
broadcast strides. The RoPE tables are made once a (image shapes, text
length) and kept on the model's device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...ops.attention import dispatch_attention_fn
from ...ops.module import LayerNorm, Linear, RMSNorm
from ...utils import BaseOutput
from ..attention_blocks import FeedForward
from ..embeddings import TimestepEmbedding, Timesteps
from ..modeling_utils import ModelMixin
from ..normalization import AdaLayerNormContinuous


@dataclass
class Transformer2DModelOutput(BaseOutput):
    sample: torch.Tensor


def rotate_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The complex interleaved rotation of ``x`` [B, S, H, D] by ``cos`` /
    ``sin`` [S, D/2], in f32, cast back (JAX `_rotate_interleaved`)."""
    xf = x.float()
    x_even, x_odd = xf[..., 0::2], xf[..., 1::2]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.stack([x_even * c - x_odd * s, x_even * s + x_odd * c], dim=-1).reshape(x.shape).to(x.dtype)


class QwenEmbedRope:
    """3-axis (frame, height, width) RoPE with centre-symmetric spatial
    positions, made on the host in f64 (JAX `QwenEmbedRope`)."""

    def __init__(self, theta: int, axes_dim: Sequence[int], scale_rope: bool = False):
        self.theta = theta
        self.axes_dim = list(axes_dim)
        self.scale_rope = scale_rope
        self._tables: Dict[tuple, tuple] = {}

    def _angles(self, index: np.ndarray, dim: int) -> np.ndarray:
        freqs = 1.0 / (self.theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
        return np.outer(index.astype(np.float64), freqs)

    def angles(self, video_fhw, max_txt_seq_len: int) -> Tuple[np.ndarray, np.ndarray]:
        """(image angles [S_img, D/2], text angles [S_txt, D/2]) in f64."""
        video_fhw = list(video_fhw)
        if video_fhw and isinstance(video_fhw[0], int):  # one (f, h, w)
            video_fhw = [tuple(video_fhw)]
        d_f, d_h, d_w = self.axes_dim
        vid, max_vid_index = [], 0
        for idx, (frame, height, width) in enumerate(video_fhw):
            a_f = self._angles(np.arange(idx, idx + frame), d_f)
            if self.scale_rope:
                rows = np.concatenate([np.arange(-(height - height // 2), 0), np.arange(height // 2)])
                cols = np.concatenate([np.arange(-(width - width // 2), 0), np.arange(width // 2)])
                max_vid_index = max(height // 2, width // 2, max_vid_index)
            else:
                rows, cols = np.arange(height), np.arange(width)
                max_vid_index = max(height, width, max_vid_index)
            a_h, a_w = self._angles(rows, d_h), self._angles(cols, d_w)
            grid = np.concatenate([
                np.broadcast_to(a_f[:, None, None, :], (frame, height, width, a_f.shape[-1])),
                np.broadcast_to(a_h[None, :, None, :], (frame, height, width, a_h.shape[-1])),
                np.broadcast_to(a_w[None, None, :, :], (frame, height, width, a_w.shape[-1])),
            ], axis=-1)
            vid.append(grid.reshape(frame * height * width, -1))
        txt_index = np.arange(max_vid_index, max_vid_index + max_txt_seq_len)
        txt = np.concatenate([self._angles(txt_index, d) for d in self.axes_dim], axis=-1)
        return np.concatenate(vid, axis=0), txt

    def __call__(self, video_fhw, max_txt_seq_len: int, device=None):
        """((img cos, img sin), (txt cos, txt sin)), f32 on `device`, made once
        a (shapes, text length, device)."""
        key = (tuple(tuple(s) for s in (video_fhw if not isinstance(video_fhw[0], int) else [video_fhw])),
               int(max_txt_seq_len), str(device))
        if key not in self._tables:
            vid, txt = self.angles(video_fhw, max_txt_seq_len)

            def pair(a):
                return (torch.from_numpy(np.cos(a).astype(np.float32)).to(device),
                        torch.from_numpy(np.sin(a).astype(np.float32)).to(device))

            self._tables[key] = (pair(vid), pair(txt))
        return self._tables[key]


class QwenDoubleStreamAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, eps: float = 1e-6):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        inner = heads * dim_head
        self.to_q = Linear(dim, inner)
        self.to_k = Linear(dim, inner)
        self.to_v = Linear(dim, inner)
        self.add_q_proj = Linear(dim, inner)
        self.add_k_proj = Linear(dim, inner)
        self.add_v_proj = Linear(dim, inner)
        self.norm_q = RMSNorm(dim_head, eps=eps)
        self.norm_k = RMSNorm(dim_head, eps=eps)
        self.norm_added_q = RMSNorm(dim_head, eps=eps)
        self.norm_added_k = RMSNorm(dim_head, eps=eps)
        self.to_out = nn.ModuleList([Linear(inner, dim)])
        self.to_add_out = Linear(inner, dim)

    def forward(self, hidden_states, encoder_hidden_states, attn_bias=None, image_rotary_emb=None):
        """(image out, text out). `attn_bias`: the f32 [B, 1, 1, S_txt + S_img]
        key-padding bias, or None."""
        b, seq_txt = hidden_states.shape[0], encoder_hidden_states.shape[1]

        def heads(t):
            return t.reshape(b, -1, self.heads, self.dim_head)

        q = self.norm_q(heads(self.to_q(hidden_states)))
        k = self.norm_k(heads(self.to_k(hidden_states)))
        v = heads(self.to_v(hidden_states))
        tq = self.norm_added_q(heads(self.add_q_proj(encoder_hidden_states)))
        tk = self.norm_added_k(heads(self.add_k_proj(encoder_hidden_states)))
        tv = heads(self.add_v_proj(encoder_hidden_states))
        if image_rotary_emb is not None:
            (img_cos, img_sin), (txt_cos, txt_sin) = image_rotary_emb
            q, k = rotate_interleaved(q, img_cos, img_sin), rotate_interleaved(k, img_cos, img_sin)
            tq, tk = rotate_interleaved(tq, txt_cos, txt_sin), rotate_interleaved(tk, txt_cos, txt_sin)
        out = dispatch_attention_fn(torch.cat([tq, q], dim=1), torch.cat([tk, k], dim=1), torch.cat([tv, v], dim=1),
                                    attn_mask=attn_bias)
        out = out.reshape(b, out.shape[1], self.heads * self.dim_head).to(q.dtype)
        return self.to_out[0](out[:, seq_txt:]), self.to_add_out(out[:, :seq_txt])


def _mod_linear(dim: int, out_dim: int) -> nn.Sequential:
    """Upstream's ``nn.Sequential(SiLU(), Linear(...))``: the Linear's keys
    under ``<name>.1``."""
    return nn.Sequential(nn.SiLU(), Linear(dim, out_dim))


class QwenImageTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_attention_heads: int, attention_head_dim: int, eps: float = 1e-6):
        super().__init__()
        self.img_mod = _mod_linear(dim, 6 * dim)
        self.txt_mod = _mod_linear(dim, 6 * dim)
        self.attn = QwenDoubleStreamAttention(dim, num_attention_heads, attention_head_dim, eps=eps)
        self.img_norm1 = LayerNorm(dim, eps=eps, use_scale=False, use_bias=False)
        self.img_norm2 = LayerNorm(dim, eps=eps, use_scale=False, use_bias=False)
        self.txt_norm1 = LayerNorm(dim, eps=eps, use_scale=False, use_bias=False)
        self.txt_norm2 = LayerNorm(dim, eps=eps, use_scale=False, use_bias=False)
        self.img_mlp = FeedForward(dim=dim, dim_out=dim, activation_fn="gelu-approximate")
        self.txt_mlp = FeedForward(dim=dim, dim_out=dim, activation_fn="gelu-approximate")

    @staticmethod
    def _modulate(x, mod):
        shift, scale, gate = mod.chunk(3, dim=-1)
        return x * (1 + scale[:, None]) + shift[:, None], gate[:, None]

    def forward(self, hidden_states, encoder_hidden_states, attn_bias, temb, image_rotary_emb=None):
        """(text stream, image stream)."""
        silu = F.silu(temb)
        img_mod1, img_mod2 = self.img_mod[1](silu).chunk(2, dim=-1)
        txt_mod1, txt_mod2 = self.txt_mod[1](silu).chunk(2, dim=-1)

        img_modulated, img_gate1 = self._modulate(self.img_norm1(hidden_states), img_mod1)
        txt_modulated, txt_gate1 = self._modulate(self.txt_norm1(encoder_hidden_states), txt_mod1)
        img_attn, txt_attn = self.attn(img_modulated, txt_modulated, attn_bias, image_rotary_emb)
        hidden_states = hidden_states + img_gate1 * img_attn
        encoder_hidden_states = encoder_hidden_states + txt_gate1 * txt_attn

        img_modulated2, img_gate2 = self._modulate(self.img_norm2(hidden_states), img_mod2)
        hidden_states = hidden_states + img_gate2 * self.img_mlp(img_modulated2)
        txt_modulated2, txt_gate2 = self._modulate(self.txt_norm2(encoder_hidden_states), txt_mod2)
        encoder_hidden_states = encoder_hidden_states + txt_gate2 * self.txt_mlp(txt_modulated2)
        return encoder_hidden_states, hidden_states


class QwenTimestepProjEmbeddings(nn.Module):
    def __init__(self, embedding_dim: int):
        super().__init__()
        self.time_proj = Timesteps(256, flip_sin_to_cos=True, downscale_freq_shift=0, scale=1000)
        self.timestep_embedder = TimestepEmbedding(256, embedding_dim)

    def forward(self, timestep: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.timestep_embedder(self.time_proj(timestep).to(dtype))


def key_padding_bias(mask: Optional[torch.Tensor], seq_img: int) -> Optional[torch.Tensor]:
    """The joint attention's f32 [B, 1, 1, S_txt + S_img] bias: 0 where a key
    is kept, ``-inf`` on the padded text keys (JAX `:146-153`)."""
    if mask is None:
        return None
    keep = torch.cat([mask.bool(), torch.ones((mask.shape[0], seq_img), dtype=torch.bool, device=mask.device)], dim=1)
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(keep, zero, -math.inf)[:, None, None, :]


class QwenImageTransformer2DModel(ModelMixin, ConfigMixin):
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
        guidance_embeds: bool = False,
        axes_dims_rope: Tuple[int, int, int] = (16, 56, 56),
    ):
        super().__init__()
        self.out_channels = out_channels or in_channels
        self.inner_dim = num_attention_heads * attention_head_dim
        self.pos_embed = QwenEmbedRope(theta=10000, axes_dim=list(axes_dims_rope), scale_rope=True)
        self.time_text_embed = QwenTimestepProjEmbeddings(self.inner_dim)
        self.txt_norm = RMSNorm(joint_attention_dim, eps=1e-6)
        self.img_in = Linear(in_channels, self.inner_dim)
        self.txt_in = Linear(joint_attention_dim, self.inner_dim)
        self.transformer_blocks = nn.ModuleList([
            QwenImageTransformerBlock(self.inner_dim, num_attention_heads, attention_head_dim)
            for _ in range(num_layers)])
        self.norm_out = AdaLayerNormContinuous(self.inner_dim, self.inner_dim, elementwise_affine=False, eps=1e-6)
        self.proj_out = Linear(self.inner_dim, patch_size * patch_size * self.out_channels)

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, image_seq, in_channels] packed latents
        encoder_hidden_states: torch.Tensor,  # [B, text_seq, joint_attention_dim]
        encoder_hidden_states_mask: Optional[torch.Tensor],  # [B, text_seq] 1 = kept
        timestep: torch.Tensor,  # [B] in [0, 1]
        img_shapes: Optional[List[Tuple[int, int, int]]] = None,
        controlnet_block_samples: Optional[Sequence[torch.Tensor]] = None,
        return_dict: bool = True,
    ):
        h = self.img_in(hidden_states)
        ctx = self.txt_in(self.txt_norm(encoder_hidden_states))
        temb = self.time_text_embed(timestep.to(h.dtype), h.dtype)
        rope = self.pos_embed(img_shapes, ctx.shape[1], device=h.device)
        bias = key_padding_bias(encoder_hidden_states_mask, h.shape[1])
        num_blocks = len(self.transformer_blocks)
        for i, block in enumerate(self.transformer_blocks):
            ctx, h = block(h, ctx, bias, temb, rope)
            if controlnet_block_samples is not None:
                h = h + controlnet_block_samples[i // math.ceil(num_blocks / len(controlnet_block_samples))]
        output = self.proj_out(self.norm_out(h, temb))
        if not return_dict:
            return (output,)
        return Transformer2DModelOutput(sample=output)

"""WanAnimateTransformer3DModel: Wan2.2-Animate (character animation and
replacement).

Port of `diffusers_tpu/models/transformers/transformer_wan_animate.py`:
the Wan block stack plus Animate's conditioning:
  * a StyleGAN-lineage motion encoder over the face frames
    (`WanAnimateMotionEncoder` `:183`): scaled convolutions (`MotionConv2d`
    `:67`, weight x 1 / sqrt(fan_in)) with an FIR blur before each strided
    one (a depthwise convolution with the asymmetric padding `:86-87`), a
    fused leaky ReLU x sqrt(2) with a channel bias (`_fused_leaky_relu`
    `:46`), residual blocks scaled by 1 / sqrt(2), an MLP of `MotionLinear`s
    (`:134`), and the linear motion decomposition through the Q of a QR of
    the synthesis basis in float32 (`:228-235`);
  * a face encoder (`WanAnimateFaceEncoder` `:238`): causal `Conv1d`s over
    time with edge padding (strides 1, 2, 2), LayerNorm + SiLU, a projection
    to per-frame multi-head motion tokens, and a learned padding token;
  * the pose latents patchified by their own `Conv3d` and added to patch
    frames 1 and later (`:439-441`);
  * a face adapter after every `inject_face_latents_blocks`-th block
    (`WanAnimateFaceBlockCrossAttention` `:285`): each latent frame's S / T
    tokens attend to that frame's N + 1 motion tokens, per head with RMSNorm
    of q and k.
Activations are NCHW (JAX's motion encoder runs NHWC). `MotionConv2d`
keeps upstream's OIHW `weight` (JAX holds HWIO under the same name).

The QR runs on the host (LAPACK, float32), whatever device the model is on:
the 512 x 20 basis is factored once a call, and the factor's column signs
then do not depend on the device's solver (`motion_vec` would flip with
them).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...ops.attention import dispatch_attention_fn
from ...ops.module import Conv1d, Conv3d, LayerNorm, Linear, RMSNorm
from ..modeling_utils import ModelMixin
from .transformer_wan import (
    Transformer3DModelOutput,
    WanRotaryMixin,
    WanRotaryPosEmbed,
    WanTimeTextImageEmbedding,
    WanTransformerBlock,
    wan_output,
)

WAN_ANIMATE_MOTION_ENCODER_CHANNEL_SIZES = {
    "4": 512, "8": 512, "16": 512, "32": 512, "64": 256, "128": 128, "256": 64, "512": 32, "1024": 16,
}


def _fused_leaky_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None, negative_slope: float = 0.2,
                      scale: float = 2**0.5) -> torch.Tensor:
    """(x + bias) -> leaky ReLU x sqrt(2); the bias is per channel: dim 1 of
    an NCHW map, the last dim of a row batch."""
    if bias is not None:
        x = x + (bias.reshape(1, -1, 1, 1) if x.ndim == 4 else bias).to(x.dtype)
    return F.leaky_relu(x, negative_slope) * scale


class _FusedLeakyReLU(nn.Module):
    """Channel bias + leaky ReLU x sqrt(2), a child module so that the
    `act_fn.bias` checkpoint keys resolve."""

    def __init__(self, channels: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self) -> None:
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _fused_leaky_relu(x, self.bias)


class MotionConv2d(nn.Module):
    """Scaled convolution (weight x 1 / sqrt(in x k²)), an optional FIR blur
    before it, and an optional fused leaky ReLU with a channel bias. NCHW;
    `weight` OIHW."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1, padding: int = 0,
                 bias: bool = True, blur_kernel=None, blur_upsample_factor: int = 1, use_activation: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.scale = 1 / math.sqrt(in_channels * kernel_size**2)
        self.weight = nn.Parameter(torch.randn(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias and not use_activation else None
        self.act_fn = _FusedLeakyReLU(out_channels) if use_activation else None
        self.blur_kernel = None
        if blur_kernel is not None:
            p = (len(blur_kernel) - stride) + (kernel_size - 1)
            self.blur_padding = ((p + 1) // 2, p // 2)
            k = np.asarray(blur_kernel, np.float32)
            k = k[None, :] * k[:, None]
            k = k / k.sum()
            if blur_upsample_factor > 1:
                k = k * blur_upsample_factor**2
            self.blur_kernel = k

    def reset_parameters(self) -> None:
        nn.init.normal_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def jax_leaf_to_torch(self, name: str, array: np.ndarray):
        """JAX keeps the weight HWIO under the torch name."""
        return name, array.transpose(3, 2, 0, 1) if name == "weight" else array

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.blur_kernel is not None:
            c = x.shape[1]
            kernel = torch.from_numpy(self.blur_kernel).to(device=x.device, dtype=x.dtype)
            lo, hi = self.blur_padding
            x = F.conv2d(F.pad(x, (lo, hi, lo, hi)), kernel.expand(c, 1, *kernel.shape), groups=c)
        x = F.conv2d(x, (self.weight * self.scale).to(x.dtype), stride=self.stride, padding=self.padding)
        if self.bias is not None:
            x = x + self.bias.reshape(1, -1, 1, 1).to(x.dtype)
        if self.act_fn is not None:
            x = self.act_fn(x)
        return x


class MotionLinear(nn.Module):
    """x @ (weight x 1 / sqrt(in)).T, then a bias or a fused leaky ReLU."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True, use_activation: bool = False):
        super().__init__()
        self.scale = 1 / math.sqrt(in_dim)
        self.weight = nn.Parameter(torch.randn(out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if bias and not use_activation else None
        self.act_fn = _FusedLeakyReLU(out_dim) if use_activation else None

    def reset_parameters(self) -> None:
        nn.init.normal_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x @ (self.weight.to(x.dtype) * self.scale).T
        if self.bias is not None:
            out = out + self.bias.to(x.dtype)
        if self.act_fn is not None:
            out = self.act_fn(out)
        return out


class MotionEncoderResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, kernel_size_skip: int = 1,
                 blur_kernel=(1, 3, 3, 1), downsample_factor: int = 2):
        super().__init__()
        self.conv1 = MotionConv2d(in_channels, in_channels, kernel_size, stride=1, padding=kernel_size // 2)
        self.conv2 = MotionConv2d(in_channels, out_channels, kernel_size, stride=downsample_factor, padding=0,
                                  blur_kernel=blur_kernel)
        self.conv_skip = MotionConv2d(in_channels, out_channels, kernel_size_skip, stride=downsample_factor,
                                      padding=0, bias=False, blur_kernel=blur_kernel, use_activation=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (self.conv2(self.conv1(x)) + self.conv_skip(x)) / math.sqrt(2)


class WanAnimateMotionEncoder(nn.Module):
    def __init__(self, size: int = 512, style_dim: int = 512, motion_dim: int = 20, out_dim: int = 512,
                 motion_blocks: int = 5, channels: Optional[Dict[str, int]] = None):
        super().__init__()
        self.size = size
        channels = channels or WAN_ANIMATE_MOTION_ENCODER_CHANNEL_SIZES
        self.conv_in = MotionConv2d(3, channels[str(size)], 1)
        blocks, in_channels = [], channels[str(size)]
        for i in range(int(math.log(size, 2)), 2, -1):
            blocks.append(MotionEncoderResBlock(in_channels, channels[str(2 ** (i - 1))]))
            in_channels = channels[str(2 ** (i - 1))]
        self.res_blocks = nn.ModuleList(blocks)
        self.conv_out = MotionConv2d(in_channels, style_dim, 4, padding=0, bias=False, use_activation=False)
        self.motion_network = nn.ModuleList([MotionLinear(style_dim, style_dim) for _ in range(motion_blocks - 1)]
                                            + [MotionLinear(style_dim, motion_dim)])
        self.motion_synthesis_weight = nn.Parameter(torch.randn(out_dim, motion_dim))

    def reset_parameters(self) -> None:
        nn.init.normal_(self.motion_synthesis_weight)

    def forward(self, face_image: torch.Tensor) -> torch.Tensor:
        """face_image [N, 3, size, size] -> motion vectors [N, out_dim]."""
        if tuple(face_image.shape[-2:]) != (self.size, self.size):
            raise ValueError(f"face frames must be {self.size}x{self.size}, got {tuple(face_image.shape)}")
        x = self.conv_in(face_image)
        for block in self.res_blocks:
            x = block(x)
        motion_feat = self.conv_out(x).reshape(x.shape[0], -1)  # 1 x 1 left
        for lin in self.motion_network:
            motion_feat = lin(motion_feat)
        # the linear motion decomposition: Q of the synthesis basis, on the host in float32
        q = torch.linalg.qr(self.motion_synthesis_weight.detach().float().cpu() + 1e-8)[0].to(face_image.device)
        return (motion_feat.float() @ q.T).to(motion_feat.dtype)


class WanAnimateFaceEncoder(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int = 1024, num_heads: int = 4, kernel_size: int = 3,
                 eps: float = 1e-6):
        super().__init__()
        self.num_heads, self.kernel_size = num_heads, kernel_size
        self.conv1_local = Conv1d(in_dim, hidden_dim * num_heads, kernel_size=kernel_size, stride=1)
        self.conv2 = Conv1d(hidden_dim, hidden_dim, kernel_size, stride=2)
        self.conv3 = Conv1d(hidden_dim, hidden_dim, kernel_size, stride=2)
        self.norm1 = LayerNorm(hidden_dim, eps=eps, use_scale=False, use_bias=False)
        self.norm2 = LayerNorm(hidden_dim, eps=eps, use_scale=False, use_bias=False)
        self.norm3 = LayerNorm(hidden_dim, eps=eps, use_scale=False, use_bias=False)
        self.out_proj = Linear(hidden_dim, out_dim)
        self.padding_tokens = nn.Parameter(torch.zeros(1, 1, 1, out_dim))

    def reset_parameters(self) -> None:
        nn.init.zeros_(self.padding_tokens)

    def _causal(self, conv: nn.Conv1d, h: torch.Tensor) -> torch.Tensor:
        """[B, T, C] -> [B, T', C'] through `conv` after edge-padding T by k - 1 in front."""
        h = F.pad(h.transpose(1, 2), (self.kernel_size - 1, 0), mode="replicate")
        return conv(h).transpose(1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, in_dim] -> [B, T', num_heads + 1, out_dim]."""
        b, n = x.shape[0], self.num_heads
        h = self._causal(self.conv1_local, x)  # [B, T, N * hidden]
        t = h.shape[1]
        h = h.reshape(b, t, n, -1).permute(0, 2, 1, 3).reshape(b * n, t, -1)
        h = F.silu(self.norm1(h))
        h = F.silu(self.norm2(self._causal(self.conv2, h)))
        h = F.silu(self.norm3(self._causal(self.conv3, h)))
        h = self.out_proj(h)
        h = h.reshape(b, n, h.shape[1], -1).permute(0, 2, 1, 3)  # [B, T', N, out]
        padding = self.padding_tokens.to(h.dtype).expand(b, h.shape[1], 1, h.shape[-1])
        return torch.cat([h, padding], dim=-2)


class WanAnimateFaceBlockCrossAttention(nn.Module):
    """Each temporal group of S / T latent tokens attends to its frame's N + 1
    motion tokens."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, eps: float = 1e-6,
                 cross_attention_dim_head: Optional[int] = None, bias: bool = True):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = dim_head * heads
        kv_inner = inner if cross_attention_dim_head is None else cross_attention_dim_head * heads
        self.pre_norm_q = LayerNorm(dim, eps=eps, use_scale=False, use_bias=False)
        self.pre_norm_kv = LayerNorm(dim, eps=eps, use_scale=False, use_bias=False)
        self.to_q = Linear(dim, inner, use_bias=bias)
        self.to_k = Linear(dim, kv_inner, use_bias=bias)
        self.to_v = Linear(dim, kv_inner, use_bias=bias)
        self.to_out = Linear(inner, dim, use_bias=bias)
        self.norm_q = RMSNorm(dim_head, eps=eps)
        self.norm_k = RMSNorm(dim_head, eps=eps)

    def forward(self, hidden_states: torch.Tensor, motion_vec: torch.Tensor) -> torch.Tensor:
        b, s, _ = hidden_states.shape
        _, t, n, _ = motion_vec.shape
        if s % t:
            raise ValueError(f"latent sequence {s} must divide by motion frames {t}")
        kv_in = self.pre_norm_kv(motion_vec).reshape(b, t * n, -1)
        q = self.norm_q(self.to_q(self.pre_norm_q(hidden_states)).reshape(b, s, self.heads, -1))
        k = self.norm_k(self.to_k(kv_in).reshape(b, t, n, self.heads, -1))
        v = self.to_v(kv_in).reshape(b, t, n, self.heads, -1)
        q = q.reshape(b * t, s // t, self.heads, -1)
        k, v = k.reshape(b * t, n, self.heads, -1), v.reshape(b * t, n, self.heads, -1)
        return self.to_out(dispatch_attention_fn(q, k, v).reshape(b, s, -1))


class WanAnimateTransformer3DModel(WanRotaryMixin, ModelMixin, ConfigMixin):
    @register_to_config
    def __init__(
        self,
        patch_size: Tuple[int, ...] = (1, 2, 2),
        num_attention_heads: int = 40,
        attention_head_dim: int = 128,
        in_channels: Optional[int] = 36,
        latent_channels: Optional[int] = 16,
        out_channels: Optional[int] = 16,
        text_dim: int = 4096,
        freq_dim: int = 256,
        ffn_dim: int = 13824,
        num_layers: int = 40,
        cross_attn_norm: bool = True,
        qk_norm: Optional[str] = "rms_norm_across_heads",
        eps: float = 1e-6,
        image_dim: Optional[int] = 1280,
        added_kv_proj_dim: Optional[int] = None,
        rope_max_seq_len: int = 1024,
        pos_embed_seq_len: Optional[int] = None,
        motion_encoder_channel_sizes: Optional[Dict[str, int]] = None,
        motion_encoder_size: int = 512,
        motion_style_dim: int = 512,
        motion_dim: int = 20,
        motion_encoder_dim: int = 512,
        face_encoder_hidden_dim: int = 1024,
        face_encoder_num_heads: int = 4,
        inject_face_latents_blocks: int = 5,
        motion_encoder_batch_size: int = 8,
    ):
        super().__init__()
        if in_channels is None and latent_channels is not None:
            in_channels = 2 * latent_channels + 4
        elif in_channels is not None and latent_channels is None:
            latent_channels = (in_channels - 4) // 2
        elif in_channels is None:
            raise ValueError("one of in_channels / latent_channels is required")
        if in_channels != 2 * latent_channels + 4:
            raise ValueError("in_channels should be 2 * latent_channels + 4")
        patch_size = tuple(patch_size)
        self.inner_dim = inner_dim = num_attention_heads * attention_head_dim
        self.out_channels = out_channels or latent_channels
        self.rope = WanRotaryPosEmbed(attention_head_dim, patch_size, rope_max_seq_len)
        self.patch_embedding = Conv3d(in_channels, inner_dim, kernel_size=patch_size, stride=patch_size)
        self.pose_patch_embedding = Conv3d(latent_channels, inner_dim, kernel_size=patch_size, stride=patch_size)
        self.condition_embedder = WanTimeTextImageEmbedding(
            dim=inner_dim, time_freq_dim=freq_dim, time_proj_dim=inner_dim * 6, text_embed_dim=text_dim,
            image_embed_dim=image_dim, pos_embed_seq_len=pos_embed_seq_len)
        self.motion_encoder = WanAnimateMotionEncoder(size=motion_encoder_size, style_dim=motion_style_dim,
                                                      motion_dim=motion_dim, out_dim=motion_encoder_dim,
                                                      channels=motion_encoder_channel_sizes)
        self.face_encoder = WanAnimateFaceEncoder(in_dim=motion_encoder_dim, out_dim=inner_dim,
                                                  hidden_dim=face_encoder_hidden_dim,
                                                  num_heads=face_encoder_num_heads)
        self.blocks = nn.ModuleList([
            WanTransformerBlock(inner_dim, ffn_dim, num_attention_heads, qk_norm, cross_attn_norm, eps,
                                added_kv_proj_dim)
            for _ in range(num_layers)
        ])
        self.face_adapter = nn.ModuleList([
            WanAnimateFaceBlockCrossAttention(dim=inner_dim, heads=num_attention_heads,
                                              dim_head=inner_dim // num_attention_heads, eps=eps,
                                              cross_attention_dim_head=inner_dim // num_attention_heads)
            for _ in range(num_layers // inject_face_latents_blocks)
        ])
        self.norm_out = LayerNorm(inner_dim, eps=eps, use_scale=False, use_bias=False)
        self.proj_out = Linear(inner_dim, self.out_channels * math.prod(patch_size))
        self.scale_shift_table = nn.Parameter(torch.randn(1, 2, inner_dim) / inner_dim**0.5)

    def encode_face_motion(self, face_pixel_values: torch.Tensor) -> torch.Tensor:
        """Face frames [B, 3, S, size, size] -> motion tokens [B, T' + 1, N + 1,
        D]: the motion encoder over every frame, the face encoder, then a zero
        frame in front."""
        fb, fc, ft, fh, fw = face_pixel_values.shape
        frames = face_pixel_values.transpose(1, 2).reshape(fb * ft, fc, fh, fw)
        motion_vec = self.face_encoder(self.motion_encoder(frames).reshape(fb, ft, -1))
        return torch.cat([torch.zeros_like(motion_vec[:, :1]), motion_vec], dim=1)

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, 2 C + 4, T + 1, H, W]
        timestep: torch.Tensor,  # [B]
        encoder_hidden_states: torch.Tensor,
        encoder_hidden_states_image: Optional[torch.Tensor] = None,
        pose_hidden_states: Optional[torch.Tensor] = None,  # [B, C, T, H, W]
        face_pixel_values: Optional[torch.Tensor] = None,  # [B, 3, S, size, size]
        motion_vec: Optional[torch.Tensor] = None,  # [B, T' + 1, N + 1, D], `encode_face_motion`'s
        rotary_emb: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        return_dict: bool = True,
    ) -> Union[Transformer3DModelOutput, tuple]:
        if pose_hidden_states is None or pose_hidden_states.shape[2] + 1 != hidden_states.shape[2]:
            raise ValueError("pose frames must be one less than hidden_states frames")
        b, _, f, h, w = hidden_states.shape
        p_t, p_h, p_w = self.config.patch_size
        grid = (f // p_t, h // p_h, w // p_w)
        if rotary_emb is None:
            rotary_emb = self.rotary_tables(hidden_states)

        x = self.patch_embedding(hidden_states)  # [B, D, F', H', W']
        x = torch.cat([x[:, :, :1], x[:, :, 1:] + self.pose_patch_embedding(pose_hidden_states)], dim=2)
        x = x.flatten(2).transpose(1, 2)  # [B, tokens, D], (f, h, w) order
        temb, timestep_proj, text, image = self.condition_embedder(timestep, encoder_hidden_states,
                                                                   encoder_hidden_states_image)
        timestep_proj = timestep_proj.reshape(b, 6, -1)
        context = text if image is None else torch.cat([image, text], dim=1)
        if motion_vec is None:  # step-invariant: a pipeline encodes it once a segment
            motion_vec = self.encode_face_motion(face_pixel_values)

        inject = self.config.inject_face_latents_blocks
        for i, block in enumerate(self.blocks):
            x = block(x, context, timestep_proj, rotary_emb)
            if i % inject == 0:
                x = self.face_adapter[i // inject](x, motion_vec) + x

        output = wan_output(self, x, temb, grid)
        return Transformer3DModelOutput(sample=output) if return_dict else (output,)

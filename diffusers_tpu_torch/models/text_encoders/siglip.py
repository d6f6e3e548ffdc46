"""SigLIP vision tower (transformers' `SiglipVisionModel` checkpoint layout).

Port of `diffusers_tpu/models/text_encoders/siglip.py`: a patch Conv2d
(with bias) plus a learned position table (no class token), pre-LN encoder
layers with tanh-GELU MLPs, `post_layernorm`, and, with `vision_use_head`,
the multihead-attention pooling head: a learned `probe` query attending over
the sequence through a torch `nn.MultiheadAttention` layout (packed
``in_proj_weight`` [3 D, D] / ``in_proj_bias``, an ``out_proj`` Linear; JAX
`:81-133`), then LayerNorm and a residual MLP. Flux Redux reads
`last_hidden_state` (so400m-patch14-384: 729 tokens of 1152, 27 layers).
Attention goes through the dispatch layer: so400m's 16 heads of 72 run
`native` on the card (kernel K1 takes head dims 64 and 128), as JAX's gate
(d % 64 == 0) sends them to XLA. `from_pretrained` / `save_pretrained` take
transformers' `model.safetensors` under ``vision_model.``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...ops.attention import dispatch_attention_fn
from ...ops.module import Conv2d, Embedding, LayerNorm, Linear
from ...utils import BaseOutput
from ..modeling_utils import ModelMixin


@dataclass
class SiglipVisionOutput(BaseOutput):
    last_hidden_state: torch.Tensor
    pooler_output: Optional[torch.Tensor] = None


def _heads_attention(q, k, v, num_heads):
    b, nq, d = q.shape
    out = dispatch_attention_fn(q.reshape(b, nq, num_heads, d // num_heads),
                                k.reshape(b, k.shape[1], num_heads, d // num_heads),
                                v.reshape(b, v.shape[1], num_heads, d // num_heads))
    return out.reshape(b, nq, d)


class SiglipAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Linear(dim, dim)
        self.k_proj = Linear(dim, dim)
        self.v_proj = Linear(dim, dim)
        self.out_proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_proj(_heads_attention(self.q_proj(x), self.k_proj(x), self.v_proj(x), self.num_heads))


class SiglipMLP(nn.Module):
    def __init__(self, dim: int, intermediate: int):
        super().__init__()
        self.fc1 = Linear(dim, intermediate)
        self.fc2 = Linear(intermediate, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class SiglipEncoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, intermediate: int, eps: float):
        super().__init__()
        self.layer_norm1 = LayerNorm(dim, eps=eps)
        self.self_attn = SiglipAttention(dim, num_heads)
        self.layer_norm2 = LayerNorm(dim, eps=eps)
        self.mlp = SiglipMLP(dim, intermediate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class TorchMultiheadAttention(nn.Module):
    """torch `nn.MultiheadAttention`'s checkpoint layout (batch first, no
    mask): the packed q/k/v projection and `out_proj`."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = Linear(dim, dim)
        self.reset_parameters()

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.in_proj_weight.normal_(std=0.02)
            self.in_proj_bias.zero_()

    def forward(self, query: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        wq, wk, wv = self.in_proj_weight.to(query.dtype).chunk(3, dim=0)
        bq, bk, bv = self.in_proj_bias.to(query.dtype).chunk(3, dim=0)
        out = _heads_attention(F.linear(query, wq, bq), F.linear(kv, wk, bk), F.linear(kv, wv, bv), self.num_heads)
        return self.out_proj(out)


class SiglipMultiheadAttentionPoolingHead(nn.Module):
    def __init__(self, dim: int, num_heads: int, intermediate: int, eps: float):
        super().__init__()
        self.probe = nn.Parameter(torch.empty(1, 1, dim))
        self.attention = TorchMultiheadAttention(dim, num_heads)
        self.layernorm = LayerNorm(dim, eps=eps)
        self.mlp = SiglipMLP(dim, intermediate)
        self.reset_parameters()

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.probe.normal_(std=0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.attention(self.probe.to(x.dtype).expand(x.shape[0], 1, -1), x)
        out = out + self.mlp(self.layernorm(out))
        return out[:, 0]


class SiglipVisionEmbeddings(nn.Module):
    def __init__(self, dim: int, image_size: int, patch_size: int, num_channels: int):
        super().__init__()
        self.patch_embedding = Conv2d(num_channels, dim, kernel_size=patch_size, stride=patch_size)
        self.position_embedding = Embedding((image_size // patch_size) ** 2, dim)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = self.patch_embedding(pixel_values.to(self.patch_embedding.weight.dtype)).flatten(2).transpose(1, 2)
        return x + self.position_embedding.weight[:x.shape[1]].to(x.dtype)


class _SiglipEncoder(nn.Module):
    def __init__(self, dim, num_heads, intermediate, eps, num_layers):
        super().__init__()
        self.layers = nn.ModuleList([SiglipEncoderLayer(dim, num_heads, intermediate, eps) for _ in range(num_layers)])


class SiglipVisionTransformer(nn.Module):
    def __init__(self, hidden_size, intermediate_size, num_hidden_layers, num_attention_heads, num_channels,
                 image_size, patch_size, layer_norm_eps, vision_use_head):
        super().__init__()
        self.embeddings = SiglipVisionEmbeddings(hidden_size, image_size, patch_size, num_channels)
        self.encoder = _SiglipEncoder(hidden_size, num_attention_heads, intermediate_size, layer_norm_eps,
                                      num_hidden_layers)
        self.post_layernorm = LayerNorm(hidden_size, eps=layer_norm_eps)
        self.head = (SiglipMultiheadAttentionPoolingHead(hidden_size, num_attention_heads, intermediate_size,
                                                         layer_norm_eps) if vision_use_head else None)

    def forward(self, pixel_values):
        x = self.embeddings(pixel_values)
        for layer in self.encoder.layers:
            x = layer(x)
        x = self.post_layernorm(x)
        return x, (self.head(x) if self.head is not None else None)


class SiglipVisionModel(ModelMixin, ConfigMixin):
    """Matches the transformers.SiglipVisionModel checkpoint layout."""

    _weights_name = "model.safetensors"
    _weights_index_name = "model.safetensors.index.json"
    _default_max_shard_size = "5GB"
    _keep_key_prefixes = ("vision_model.",)
    _drop_key_suffixes = ("position_ids",)

    @register_to_config
    def __init__(
        self,
        hidden_size: int = 768,
        intermediate_size: int = 3072,
        num_hidden_layers: int = 12,
        num_attention_heads: int = 12,
        num_channels: int = 3,
        image_size: int = 224,
        patch_size: int = 16,
        layer_norm_eps: float = 1e-6,
        vision_use_head: bool = True,
        **kwargs,
    ):
        super().__init__()
        self.vision_model = SiglipVisionTransformer(hidden_size, intermediate_size, num_hidden_layers,
                                                    num_attention_heads, num_channels, image_size, patch_size,
                                                    layer_norm_eps, vision_use_head)

    def forward(self, pixel_values: torch.Tensor, return_dict: bool = True):
        """pixel_values: [B, 3, H, W], normalized by the image processor."""
        last_hidden, pooled = self.vision_model(pixel_values)
        if not return_dict:
            return (last_hidden, pooled)
        return SiglipVisionOutput(last_hidden_state=last_hidden, pooler_output=pooled)

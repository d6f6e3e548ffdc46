"""T5 text encoders: `T5EncoderModel`, the long-prompt tower of Flux and SD3,
and `UMT5EncoderModel`, Wan's.

Port of `diffusers_tpu/models/text_encoders/t5.py`: pre-norm (RMSNorm)
blocks, bidirectional relative-position bias computed by block 0 and shared by
every block (UMT5: every block owns and computes its own, JAX `:170-176`), no
1/sqrt(d) attention scaling, gated-GELU or ReLU feed-forward.
Attention runs the ``native`` backend, as in JAX (`t5.py:87`): the additive
[1, H, S, S] bias is not a shape the flash kernel takes. Submodule names
(``encoder.block.N.layer.0.SelfAttention.q`` ...) match the transformers state
dict. `from_pretrained` and `save_pretrained` take transformers' layout
(JAX `t5.py:227-271`): a transformers `config.json` and `model.safetensors`,
or 5 GB shards with `model.safetensors.index.json`; of a checkpoint's keys
only those under ``shared`` and ``encoder`` are read (a full T5's decoder is
skipped), less the ``encoder.embed_tokens.weight`` alias of ``shared``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...ops.attention import dispatch_attention_fn
from ...ops.module import Embedding, Linear, RMSNorm
from ...utils import BaseOutput
from ..modeling_utils import ModelMixin


@dataclass
class T5EncoderOutput(BaseOutput):
    last_hidden_state: torch.Tensor


def _relative_position_bucket(relative_position: torch.Tensor, bidirectional: bool = True, num_buckets: int = 32,
                              max_distance: int = 128) -> torch.Tensor:
    """transformers `T5Attention._relative_position_bucket` (f32 log, truncation)."""
    relative_buckets = torch.zeros_like(relative_position)
    if bidirectional:
        num_buckets //= 2
        relative_buckets = relative_buckets + (relative_position > 0).to(relative_position.dtype) * num_buckets
        relative_position = relative_position.abs()
    else:
        relative_position = -torch.clamp(relative_position, max=0)
    max_exact = num_buckets // 2
    is_small = relative_position < max_exact
    if_large = max_exact + (
        torch.log(relative_position.float() / max_exact) / math.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).to(relative_position.dtype)
    if_large = torch.clamp(if_large, max=num_buckets - 1)
    return relative_buckets + torch.where(is_small, relative_position, if_large)


class T5Attention(nn.Module):
    def __init__(self, d_model: int, d_kv: int, num_heads: int, has_relative_bias: bool,
                 relative_attention_num_buckets: int = 32, relative_attention_max_distance: int = 128):
        super().__init__()
        self.num_heads = num_heads
        self.d_kv = d_kv
        inner = num_heads * d_kv
        self.q = Linear(d_model, inner, use_bias=False)
        self.k = Linear(d_model, inner, use_bias=False)
        self.v = Linear(d_model, inner, use_bias=False)
        self.o = Linear(inner, d_model, use_bias=False)
        self.relative_attention_num_buckets = relative_attention_num_buckets
        self.relative_attention_max_distance = relative_attention_max_distance
        if has_relative_bias:
            self.relative_attention_bias = Embedding(relative_attention_num_buckets, num_heads)

    def compute_bias(self, seq_len: int, device) -> torch.Tensor:
        pos = torch.arange(seq_len, device=device)
        buckets = _relative_position_bucket(
            pos[None, :] - pos[:, None],
            bidirectional=True,
            num_buckets=self.relative_attention_num_buckets,
            max_distance=self.relative_attention_max_distance,
        )
        bias = self.relative_attention_bias(buckets)  # [S, S, H]
        return bias.permute(2, 0, 1)[None]  # [1, H, S, S]

    def forward(self, x: torch.Tensor, position_bias: Optional[torch.Tensor]) -> torch.Tensor:
        b, s, _ = x.shape
        q = self.q(x).reshape(b, s, self.num_heads, self.d_kv)
        k = self.k(x).reshape(b, s, self.num_heads, self.d_kv)
        v = self.v(x).reshape(b, s, self.num_heads, self.d_kv)
        out = dispatch_attention_fn(q, k, v, attn_mask=position_bias, scale=1.0, backend="native")
        return self.o(out.reshape(b, s, self.num_heads * self.d_kv))


class T5DenseGatedActDense(nn.Module):
    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.wi_0 = Linear(d_model, d_ff, use_bias=False)
        self.wi_1 = Linear(d_model, d_ff, use_bias=False)
        self.wo = Linear(d_ff, d_model, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class T5DenseActDense(nn.Module):
    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.wi = Linear(d_model, d_ff, use_bias=False)
        self.wo = Linear(d_ff, d_model, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(F.relu(self.wi(x)))


class _SelfAttnLayer(nn.Module):
    def __init__(self, cfg, has_relative_bias):
        super().__init__()
        self.SelfAttention = T5Attention(cfg["d_model"], cfg["d_kv"], cfg["num_heads"], has_relative_bias,
                                         cfg["relative_attention_num_buckets"],
                                         cfg["relative_attention_max_distance"])
        self.layer_norm = RMSNorm(cfg["d_model"], eps=cfg["layer_norm_epsilon"])

    def forward(self, x, position_bias):
        return x + self.SelfAttention(self.layer_norm(x), position_bias)


class _FFLayer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        gated = "gated" in cfg["feed_forward_proj"]
        dense = T5DenseGatedActDense if gated else T5DenseActDense
        self.DenseReluDense = dense(cfg["d_model"], cfg["d_ff"])
        self.layer_norm = RMSNorm(cfg["d_model"], eps=cfg["layer_norm_epsilon"])

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, cfg, has_relative_bias):
        super().__init__()
        self.layer = nn.ModuleList([_SelfAttnLayer(cfg, has_relative_bias), _FFLayer(cfg)])

    def forward(self, x, position_bias):
        return self.layer[1](self.layer[0](x, position_bias))


class T5Stack(nn.Module):
    def __init__(self, cfg, per_layer_relative_bias: bool = False):
        super().__init__()
        self.per_layer_relative_bias = per_layer_relative_bias
        self.block = nn.ModuleList([T5Block(cfg, has_relative_bias=(per_layer_relative_bias or i == 0))
                                    for i in range(cfg["num_layers"])])
        self.final_layer_norm = RMSNorm(cfg["d_model"], eps=cfg["layer_norm_epsilon"])

    def forward(self, hidden: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        s, mask = hidden.shape[1], None
        if attention_mask is not None:
            # [B, S] keep-mask -> additive [B, 1, 1, S]
            keep = attention_mask[:, None, None, :].to(torch.float32)
            mask = (1.0 - keep) * torch.finfo(torch.float32).min

        def bias(block):
            b = block.layer[0].SelfAttention.compute_bias(s, hidden.device)
            return b if mask is None else b + mask

        position_bias = None if self.per_layer_relative_bias else bias(self.block[0])
        for block in self.block:
            hidden = block(hidden, bias(block) if self.per_layer_relative_bias else position_bias)
        return self.final_layer_norm(hidden)


class T5EncoderModel(ModelMixin, ConfigMixin):
    _per_layer_relative_bias = False
    _weights_name = "model.safetensors"
    _weights_index_name = "model.safetensors.index.json"
    _default_max_shard_size = "5GB"
    _keep_key_prefixes = ("shared", "encoder")
    _drop_key_suffixes = ("encoder.embed_tokens.weight",)

    @register_to_config
    def __init__(
        self,
        vocab_size: int = 32128,
        d_model: int = 512,
        d_kv: int = 64,
        d_ff: int = 2048,
        num_layers: int = 6,
        num_heads: int = 8,
        relative_attention_num_buckets: int = 32,
        relative_attention_max_distance: int = 128,
        layer_norm_epsilon: float = 1e-6,
        feed_forward_proj: str = "relu",
    ):
        super().__init__()
        cfg = dict(
            d_model=d_model, d_kv=d_kv, d_ff=d_ff, num_layers=num_layers, num_heads=num_heads,
            relative_attention_num_buckets=relative_attention_num_buckets,
            relative_attention_max_distance=relative_attention_max_distance,
            layer_norm_epsilon=layer_norm_epsilon, feed_forward_proj=feed_forward_proj,
        )
        self.shared = Embedding(vocab_size, d_model)
        self.encoder = T5Stack(cfg, per_layer_relative_bias=self._per_layer_relative_bias)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> T5EncoderOutput:
        return T5EncoderOutput(last_hidden_state=self.encoder(self.shared(input_ids), attention_mask))


class UMT5EncoderModel(T5EncoderModel):
    """UMT5 (Wan's umt5-xxl; transformers `UMT5EncoderModel` key names): every
    block owns its relative attention bias
    (``encoder.block.N.layer.0.SelfAttention.relative_attention_bias``)."""

    _per_layer_relative_bias = True

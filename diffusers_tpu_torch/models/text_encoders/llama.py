"""LLaMA-style decoder-only text encoder (`LlamaModel`), the trunk of the
Qwen2.5-VL prompt encoder and of HunyuanVideo's.

Port of `diffusers_tpu/models/text_encoders/llama.py`: plain RMSNorm
(``w * x_hat``), half-split RoPE, grouped-query attention, SiLU-gated MLP,
pre-norm residual blocks, with transformers' state-dict names
(``embed_tokens``, ``layers.N.self_attn.q_proj`` ..., ``norm``). Options as
in JAX: ``attention_bias`` (Qwen2 towers: q/k/v biases, o_proj bias-free)
and ``qk_norm`` (Qwen3 towers: per-head q/k RMSNorm before RoPE).

The attention is plain math, as in JAX (`:83-92`): f32 logits, a causal
``tril`` and the padding mask filled with the f32 minimum, f32 softmax cast
back to the input dtype, and GQA by repeating each k/v head
``num_heads / num_kv_heads`` times. It runs no kernel (JAX reaches no Pallas
kernel here).

`from_pretrained` reads transformers' layout (`ModelMixin.from_pretrained`
with this class's key rules): `config.json` (a multimodal wrapper's
``text_config`` is used where present; a ``qwen2*`` model type turns on
``attention_bias``, a ``qwen3*`` one ``qk_norm``, as JAX `:186-200` does),
and `model.safetensors` or its 5 GB shards, whose keys may nest the trunk
under any mix of ``model.`` / ``language_model.`` prefixes; a vision tower,
a projector and ``lm_head.weight`` are skipped. `save_pretrained` writes the
same layout with the trunk's own key names.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...ops.module import Embedding, Linear
from ...utils import BaseOutput
from ..modeling_utils import ModelMixin


@dataclass
class LlamaEncoderOutput(BaseOutput):
    last_hidden_state: torch.Tensor
    hidden_states: Optional[Tuple[torch.Tensor, ...]] = None


class LlamaRMSNorm(nn.Module):
    """``x * rsqrt(mean(x^2) + eps) * weight`` in f32, cast back (transformers
    `LlamaRMSNorm` key: ``weight``)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def reset_parameters(self) -> None:
        nn.init.ones_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        return (xf * self.weight.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split RoPE of ``x`` [B, S, H, D] at integer ``positions`` [B, S]
    (JAX `gemma._rope`), in f32, cast back."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    angles = positions.float()[:, :, None] * freqs[None, None, :]
    cos, sin = torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, hidden_size, num_heads, num_kv_heads, head_dim, rope_theta, attention_bias: bool = False,
                 qk_norm: bool = False, rms_norm_eps: float = 1e-6):
        super().__init__()
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.scale = head_dim**-0.5
        self.rope_theta = rope_theta
        self.q_proj = Linear(hidden_size, num_heads * head_dim, use_bias=attention_bias)
        self.k_proj = Linear(hidden_size, num_kv_heads * head_dim, use_bias=attention_bias)
        self.v_proj = Linear(hidden_size, num_kv_heads * head_dim, use_bias=attention_bias)
        self.o_proj = Linear(num_heads * head_dim, hidden_size, use_bias=False)
        if qk_norm:
            self.q_norm = LlamaRMSNorm(head_dim, rms_norm_eps)
            self.k_norm = LlamaRMSNorm(head_dim, rms_norm_eps)
        else:
            self.q_norm = self.k_norm = None

    def forward(self, x: torch.Tensor, positions: torch.Tensor, attention_mask: Optional[torch.Tensor]):
        b, s, _ = x.shape
        q = self.q_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        q, k = rope(q, positions, self.rope_theta), rope(k, positions, self.rope_theta)
        if self.num_kv_heads != self.num_heads:
            rep = self.num_heads // self.num_kv_heads
            k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * self.scale
        min_value = torch.finfo(torch.float32).min
        causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~causal, min_value)
        if attention_mask is not None:
            logits = logits.masked_fill(~attention_mask[:, None, None, :].bool(), min_value)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, -1)
        return self.o_proj(out)


class LlamaMLP(nn.Module):
    def __init__(self, hidden_size, intermediate_size):
        super().__init__()
        self.gate_proj = Linear(hidden_size, intermediate_size, use_bias=False)
        self.up_proj = Linear(hidden_size, intermediate_size, use_bias=False)
        self.down_proj = Linear(intermediate_size, hidden_size, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, hidden_size, intermediate_size, num_heads, num_kv_heads, head_dim, rms_norm_eps, rope_theta,
                 attention_bias: bool = False, qk_norm: bool = False):
        super().__init__()
        self.self_attn = LlamaAttention(hidden_size, num_heads, num_kv_heads, head_dim, rope_theta,
                                        attention_bias=attention_bias, qk_norm=qk_norm, rms_norm_eps=rms_norm_eps)
        self.mlp = LlamaMLP(hidden_size, intermediate_size)
        self.input_layernorm = LlamaRMSNorm(hidden_size, rms_norm_eps)
        self.post_attention_layernorm = LlamaRMSNorm(hidden_size, rms_norm_eps)

    def forward(self, x, positions, attention_mask):
        x = x + self.self_attn(self.input_layernorm(x), positions, attention_mask)
        return x + self.mlp(self.post_attention_layernorm(x))


class _DecoderTrunk(ModelMixin, ConfigMixin):
    """The shared body of the decoder-only encoders: the embedding, the
    layers, the final norm, transformers' checkpoint layout."""

    _weights_name = "model.safetensors"
    _weights_index_name = "model.safetensors.index.json"
    _default_max_shard_size = "5GB"
    # the checkpoint's model type -> the options it implies (JAX `llama.py:196-200`)
    _model_type_options = (("qwen3", {"qk_norm": True}), ("qwen2", {"attention_bias": True}))

    def _build(self, vocab_size, hidden_size, intermediate_size, num_hidden_layers, num_attention_heads,
               num_key_value_heads, head_dim, rms_norm_eps, rope_theta, attention_bias, qk_norm):
        head_dim = head_dim or hidden_size // num_attention_heads
        self.embed_tokens = Embedding(vocab_size, hidden_size)
        self.layers = nn.ModuleList([
            LlamaDecoderLayer(hidden_size, intermediate_size, num_attention_heads, num_key_value_heads, head_dim,
                              rms_norm_eps, rope_theta, attention_bias=attention_bias, qk_norm=qk_norm)
            for _ in range(num_hidden_layers)])
        self.norm = LlamaRMSNorm(hidden_size, rms_norm_eps)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None, output_hidden_states: bool = False,
                normalize_last_hidden_state: bool = True) -> LlamaEncoderOutput:
        """The final norm's output in ``last_hidden_state``; with
        `output_hidden_states`, the embedding and every layer's output, the
        last replaced by the normed output (transformers' rule) unless
        `normalize_last_hidden_state` is False."""
        x = self.embed_tokens(input_ids)
        positions = (position_ids if position_ids is not None
                     else torch.arange(input_ids.shape[1], device=x.device).expand(input_ids.shape))
        hidden_states = [x] if output_hidden_states else None
        for layer in self.layers:
            x = layer(x, positions, attention_mask)
            if output_hidden_states:
                hidden_states.append(x)
        x = self.norm(x)
        if output_hidden_states and normalize_last_hidden_state:
            hidden_states[-1] = x
        return LlamaEncoderOutput(last_hidden_state=x,
                                  hidden_states=tuple(hidden_states) if output_hidden_states else None)

    @classmethod
    def load_config(cls, pretrained_model_name_or_path, **kwargs):
        """transformers' `config.json`: a wrapper's ``text_config`` where it
        has one, the options its model type implies added."""
        config = dict(super().load_config(pretrained_model_name_or_path, **kwargs))
        text = dict(config.get("text_config") or config)
        model_type = text.get("model_type") or config.get("model_type") or ""
        for prefix, options in cls._model_type_options:
            if model_type.startswith(prefix):
                text.update(options)
        return text

    @classmethod
    def _reads_key(cls, key: str) -> bool:
        parts = key.split(".")
        if any(seg in parts[:3] for seg in ("vision_tower", "visual", "multi_modal_projector")):
            return False
        return key != "lm_head.weight" and not key.endswith("rotary_emb.inv_freq")

    @classmethod
    def _state_key(cls, key: str) -> str:
        # nesting varies by transformers version: model.*, model.language_model.*, language_model.model.*
        while key.startswith(("model.", "language_model.")):
            key = key.removeprefix("model.").removeprefix("language_model.")
        return key


class LlamaModel(_DecoderTrunk):
    @register_to_config
    def __init__(
        self,
        vocab_size: int = 128320,
        hidden_size: int = 4096,
        intermediate_size: int = 14336,
        num_hidden_layers: int = 32,
        num_attention_heads: int = 32,
        num_key_value_heads: int = 8,
        head_dim: Optional[int] = None,
        rms_norm_eps: float = 1e-5,
        rope_theta: float = 500000.0,
        attention_bias: bool = False,
        qk_norm: bool = False,
    ):
        super().__init__()
        self._build(vocab_size, hidden_size, intermediate_size, num_hidden_layers, num_attention_heads,
                    num_key_value_heads, head_dim, rms_norm_eps, rope_theta, attention_bias, qk_norm)

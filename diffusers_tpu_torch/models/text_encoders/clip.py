"""CLIP text encoder.

Port of the text towers of `diffusers_tpu/models/text_encoders/clip.py`
(`CLIPTextModel`, `CLIPTextModelWithProjection`): the transformers state-dict
names (``text_model.encoder.layers.N.self_attn.q_proj`` ...), causal
attention through the dispatch layer, forced to ``native`` with the causal
keep-mask as JAX does (`:58`), and the SD-family contracts: per-layer
`hidden_states` (SDXL reads the penultimate), `pooler_output` at the EOS
position, `text_embeds` for SDXL's pooled embedding. `from_pretrained` and
`save_pretrained` take transformers' layout (JAX `clip.py:231-283`): a
transformers `config.json` and `model.safetensors` (or shards with
`model.safetensors.index.json`); of a checkpoint's keys only those under
``text_model.`` and ``text_projection`` are read, less the legacy
``position_ids`` buffer. The vision tower waits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...ops.attention import dispatch_attention_fn
from ...ops.module import Embedding, LayerNorm, Linear, get_activation
from ...utils import BaseOutput
from ..modeling_utils import ModelMixin


@dataclass
class CLIPTextModelOutput(BaseOutput):
    last_hidden_state: torch.Tensor
    pooler_output: Optional[torch.Tensor] = None
    hidden_states: Optional[Tuple[torch.Tensor, ...]] = None
    text_embeds: Optional[torch.Tensor] = None


class CLIPAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.q_proj = Linear(embed_dim, embed_dim)
        self.k_proj = Linear(embed_dim, embed_dim)
        self.v_proj = Linear(embed_dim, embed_dim)
        self.out_proj = Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor, causal_mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, s, _ = x.shape
        q = self.q_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        v = self.v_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        out = dispatch_attention_fn(q, k, v, attn_mask=causal_mask, backend="native")
        return self.out_proj(out.reshape(b, s, self.embed_dim))


class CLIPMLP(nn.Module):
    def __init__(self, embed_dim: int, intermediate_size: int, hidden_act: str):
        super().__init__()
        self.fc1 = Linear(embed_dim, intermediate_size)
        self.fc2 = Linear(intermediate_size, embed_dim)
        self.act = get_activation(hidden_act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, intermediate_size: int, hidden_act: str, eps: float):
        super().__init__()
        self.self_attn = CLIPAttention(embed_dim, num_heads)
        self.layer_norm1 = LayerNorm(embed_dim, eps=eps)
        self.mlp = CLIPMLP(embed_dim, intermediate_size, hidden_act)
        self.layer_norm2 = LayerNorm(embed_dim, eps=eps)

    def forward(self, x: torch.Tensor, causal_mask: Optional[torch.Tensor]) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int, max_position_embeddings: int):
        super().__init__()
        self.token_embedding = Embedding(vocab_size, embed_dim)
        self.position_embedding = Embedding(max_position_embeddings, embed_dim)

    def forward(self, input_ids: torch.Tensor, position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1], device=input_ids.device)[None, :]
        return self.token_embedding(input_ids) + self.position_embedding(position_ids)


class _CLIPEncoder(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        self.layers = nn.ModuleList(
            [
                CLIPEncoderLayer(
                    config["hidden_size"],
                    config["num_attention_heads"],
                    config["intermediate_size"],
                    config.get("hidden_act", "quick_gelu"),
                    config.get("layer_norm_eps", 1e-5),
                )
                for _ in range(config["num_hidden_layers"])
            ]
        )


class CLIPTextTransformer(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        self.cfg = config
        embed_dim = config["hidden_size"]
        self.embeddings = CLIPTextEmbeddings(config["vocab_size"], embed_dim, config["max_position_embeddings"])
        self.encoder = _CLIPEncoder(config)
        self.final_layer_norm = LayerNorm(embed_dim, eps=config.get("layer_norm_eps", 1e-5))

    def forward(self, input_ids, position_ids=None, output_hidden_states=False):
        hidden = self.embeddings(input_ids, position_ids)
        s = input_ids.shape[-1]
        causal = torch.ones((s, s), dtype=torch.bool, device=input_ids.device).tril()[None, None]  # [1,1,S,S]

        all_hidden = [hidden] if output_hidden_states else None
        for layer in self.encoder.layers:
            hidden = layer(hidden, causal)
            if output_hidden_states:
                all_hidden.append(hidden)

        last_hidden = self.final_layer_norm(hidden)

        eos_token_id = self.cfg.get("eos_token_id", 2)
        if eos_token_id == 2:
            # canonical CLIP: eos has the highest token id (transformers behavior)
            eos_positions = input_ids.argmax(dim=-1)
        else:
            eos_positions = (input_ids == eos_token_id).int().argmax(dim=-1)
        pooled = last_hidden[torch.arange(last_hidden.shape[0], device=last_hidden.device), eos_positions]
        return last_hidden, pooled, tuple(all_hidden) if output_hidden_states else None


class CLIPTextModel(ModelMixin, ConfigMixin):
    """Matches the transformers.CLIPTextModel checkpoint layout."""

    has_projection = False
    _weights_name = "model.safetensors"
    _weights_index_name = "model.safetensors.index.json"
    _default_max_shard_size = "5GB"
    _keep_key_prefixes = ("text_model.", "text_projection")
    _drop_key_suffixes = ("position_ids",)

    @register_to_config
    def __init__(
        self,
        vocab_size: int = 49408,
        hidden_size: int = 512,
        intermediate_size: int = 2048,
        num_hidden_layers: int = 12,
        num_attention_heads: int = 8,
        max_position_embeddings: int = 77,
        hidden_act: str = "quick_gelu",
        layer_norm_eps: float = 1e-5,
        projection_dim: int = 512,
        eos_token_id: int = 2,
        bos_token_id: int = 49406,
        **kwargs,
    ):
        super().__init__()
        cfg = dict(
            vocab_size=vocab_size,
            hidden_size=hidden_size,
            intermediate_size=intermediate_size,
            num_hidden_layers=num_hidden_layers,
            num_attention_heads=num_attention_heads,
            max_position_embeddings=max_position_embeddings,
            hidden_act=hidden_act,
            layer_norm_eps=layer_norm_eps,
            eos_token_id=eos_token_id,
        )
        self.text_model = CLIPTextTransformer(cfg)
        if self.has_projection:
            self.text_projection = Linear(hidden_size, projection_dim, use_bias=False)

    def forward(
        self,
        input_ids: torch.Tensor,
        position_ids: Optional[torch.Tensor] = None,
        output_hidden_states: bool = False,
    ) -> CLIPTextModelOutput:
        last_hidden, pooled, all_hidden = self.text_model(input_ids, position_ids, output_hidden_states)
        text_embeds = self.text_projection(pooled) if self.has_projection else None
        return CLIPTextModelOutput(
            last_hidden_state=last_hidden,
            pooler_output=pooled,
            hidden_states=all_hidden,
            text_embeds=text_embeds,
        )


class CLIPTextModelWithProjection(CLIPTextModel):
    has_projection = True

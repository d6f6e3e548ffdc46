"""Qwen2.5-VL text tower: the Qwen-Image prompt encoder.

Port of `diffusers_tpu/models/text_encoders/qwen2_vl.py`
(`Qwen2_5_VLTextEncoder` `:33-126`): the language model of transformers'
`Qwen2_5_VLForConditionalGeneration`, a Llama trunk with q/k/v biases
(o_proj bias-free) and rope theta 1e6. Its multimodal RoPE (three sections)
sees the same position ids in every section for a text-only input, so plain
RoPE is exact here, as in JAX. ``hidden_states[-1]`` is the final norm's
output (`:75-77`), as in transformers.

`from_pretrained` reads a `Qwen2_5_VLForConditionalGeneration` checkpoint
directory (`config.json` with or without ``text_config``; `model.safetensors`
or shards through `model.safetensors.index.json`), strips the ``model.`` /
``language_model.`` prefixes in any nesting and skips the ``visual.`` tower
and ``lm_head.weight`` (JAX `:106-117`); the vision tower is not needed for
prompt encoding. Runs no kernel (`llama.py`).
"""

from __future__ import annotations

from typing import Optional

from ...configuration_utils import register_to_config
from .llama import LlamaEncoderOutput, _DecoderTrunk

__all__ = ["Qwen2_5_VLTextEncoder", "LlamaEncoderOutput"]


class Qwen2_5_VLTextEncoder(_DecoderTrunk):
    """Text-only Qwen2.5-VL trunk (Qwen-Image's widths by default: 28 layers,
    3584 / 18944, 28 query and 4 key/value heads of 128)."""

    @register_to_config
    def __init__(
        self,
        vocab_size: int = 152064,
        hidden_size: int = 3584,
        intermediate_size: int = 18944,
        num_hidden_layers: int = 28,
        num_attention_heads: int = 28,
        num_key_value_heads: int = 4,
        head_dim: Optional[int] = None,
        rms_norm_eps: float = 1e-6,
        rope_theta: float = 1000000.0,
    ):
        super().__init__()
        self._build(vocab_size, hidden_size, intermediate_size, num_hidden_layers, num_attention_heads,
                    num_key_value_heads, head_dim, rms_norm_eps, rope_theta, attention_bias=True, qk_norm=False)

    @classmethod
    def _reads_key(cls, key: str) -> bool:
        return "visual" not in key.split(".")[:2] and key != "lm_head.weight"

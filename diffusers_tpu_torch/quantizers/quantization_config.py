"""Quantization configs.

The port's own copy of `diffusers_tpu/quantizers/quantization_config.py`
(`:17-77`): the same four dataclasses, fields and defaults, so a config
written for one package means the same in the other. What the port does
with each is in `quantize.py`: `Int8DynamicActConfig` (w8a8, kernel K5) and
`Int4WeightOnlyConfig` (group-wise int4, `Int4Linear`) quantize on load; the
int8 and fp8 weight-only configs and the per-tensor ``impl="xla"`` path
raise until they are ported (ROADMAP A6.2).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class QuantizationConfig:
    """Base: which modules to convert."""

    modules_to_not_convert: List[str] = field(default_factory=list)
    min_weight_size: int = 4096  # skip tiny layers (norm-adjacent projections)

    quant_method = "none"


@dataclass
class Int8WeightOnlyConfig(QuantizationConfig):
    """Per-output-channel symmetric int8 weights, bf16 activations."""

    quant_method = "int8_weight_only"


@dataclass
class Fp8WeightOnlyConfig(QuantizationConfig):
    """fp8-e4m3 weights with a per-channel scale, bf16 compute."""

    quant_method = "fp8_weight_only"


@dataclass
class Int4WeightOnlyConfig(QuantizationConfig):
    """Group-wise symmetric int4 weights, bf16 compute. ``group_size`` is the
    input-dimension block that shares one scale (per [group, out channel]);
    a kernel whose input dimension it does not divide takes one group."""

    quant_method = "int4_weight_only"
    group_size: int = 128


@dataclass
class Int8DynamicActConfig(QuantizationConfig):
    """w8a8: int8 weights and dynamic per-row int8 activations, on the card's
    int8 tensor cores through kernel K5 (`ops/cuda/w8a8_matmul.py`).
    ``impl`` names the Linear's compute path: "pallas" (the default; the
    fused per-row kernel, K5 here) or "xla" (the JAX package's per-tensor
    XLA-native int8 dot, not ported)."""

    quant_method = "int8_dynamic_activation"
    impl: str = "pallas"

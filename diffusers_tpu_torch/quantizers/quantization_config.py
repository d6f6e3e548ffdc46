"""Quantization configs.

The port's own copy of `diffusers_tpu/quantizers/quantization_config.py`
(`:17-77`): the same four dataclasses, fields and defaults, so a config
written for one package means the same in the other. What the port does
with each is in `quantize.py`: `Int8DynamicActConfig` (per-row w8a8 Linears
on kernel K5, or per-tensor ones with ``impl="xla"``, and the int8
convolutions, both on K5's GEMM), `Int8WeightOnlyConfig` and
`Fp8WeightOnlyConfig` (`WeightOnlyLinear`) and `Int4WeightOnlyConfig`
(group-wise int4, `Int4Linear`), in memory (`quantize_model`) or on load.
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
    XLA-native int8 dot; `Int8PerTensorLinear` here, on K5's GEMM). The
    convolutions JAX's `_conv_int8_eligible` takes run int8 under either
    (`Int8Conv2d`)."""

    quant_method = "int8_dynamic_activation"
    impl: str = "pallas"

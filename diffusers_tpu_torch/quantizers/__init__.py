from .auto import PipelineQuantizationConfig, resolve_quantization_config
from .quantization_config import (
    Fp8WeightOnlyConfig,
    Int4WeightOnlyConfig,
    Int8DynamicActConfig,
    Int8WeightOnlyConfig,
    QuantizationConfig,
)
from .quantize import quantize_kernel_int8, quantize_linears, quantize_w8a8, w8a8_linear_names

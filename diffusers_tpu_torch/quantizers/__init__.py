from .auto import PipelineQuantizationConfig, resolve_quantization_config
from .quantization_config import (
    Fp8WeightOnlyConfig,
    Int4WeightOnlyConfig,
    Int8DynamicActConfig,
    Int8WeightOnlyConfig,
    QuantizationConfig,
)
from .quantize import (
    dequantize_int4,
    int4_linear_names,
    pack_int4_rows,
    quantize_int4,
    quantize_int4_linears,
    quantize_kernel_int4,
    quantize_kernel_fp8,
    quantize_kernel_int8,
    quantize_linears,
    quantize_model,
    quantized_module_names,
    quantize_w8a8,
    unpack_int4_rows,
    w8a8_linear_names,
)

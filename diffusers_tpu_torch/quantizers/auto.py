"""Quantization-config resolution and the pipeline-level config.

The port's own copy of `diffusers_tpu/quantizers/auto.py` (`:38-107`):
`resolve_quantization_config` maps a config, a dict
(``{"quant_method": ..., ...}``) or a method name (with the same aliases) to
a dataclass of `quantization_config.py`; `PipelineQuantizationConfig` maps
pipeline component names to configs for `DiffusionPipeline.from_pretrained`.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

from .quantization_config import (
    Fp8WeightOnlyConfig,
    Int4WeightOnlyConfig,
    Int8DynamicActConfig,
    Int8WeightOnlyConfig,
    QuantizationConfig,
)

_METHOD_MAP = {
    "int8_weight_only": Int8WeightOnlyConfig,
    "int4_weight_only": Int4WeightOnlyConfig,
    "fp8_weight_only": Fp8WeightOnlyConfig,
    "int8_dynamic_activation": Int8DynamicActConfig,
    # the reference backends' names -> the nearest regime, as in the JAX package
    "bitsandbytes_8bit": Int8WeightOnlyConfig,
    "bitsandbytes_4bit": Int4WeightOnlyConfig,
    "torchao": Int8DynamicActConfig,
    "gguf": Int8WeightOnlyConfig,
}


def resolve_quantization_config(
    config: Union[QuantizationConfig, Dict, str, None],
) -> Optional[QuantizationConfig]:
    """Accepts a QuantizationConfig, a dict (`{"quant_method": ..., ...}`),
    or a method-name string; returns a QuantizationConfig or None."""
    if config is None or isinstance(config, QuantizationConfig):
        return config
    if isinstance(config, str):
        config = {"quant_method": config}
    if isinstance(config, dict):
        method = config.get("quant_method", "none")
        if method in ("none", None):
            return None
        if method not in _METHOD_MAP:
            raise ValueError(f"unknown quant_method {method!r}; known: {sorted(_METHOD_MAP)}")
        cls = _METHOD_MAP[method]
        allowed = ("modules_to_not_convert", "min_weight_size") + (
            ("group_size",) if cls is Int4WeightOnlyConfig else ()
        )
        return cls(**{k: v for k, v in config.items() if k in allowed})
    raise TypeError(f"cannot resolve quantization config from {type(config)}")


class PipelineQuantizationConfig:
    """Maps pipeline component name -> quantization config, applied during
    `DiffusionPipeline.from_pretrained`.

    Either give per-component configs::

        PipelineQuantizationConfig(quant_mapping={"transformer": Int8DynamicActConfig()})

    or one blanket config limited to some components::

        PipelineQuantizationConfig(
            quant_backend="int8_dynamic_activation", components_to_quantize=["transformer"]
        )
    """

    def __init__(
        self,
        quant_backend: Union[str, QuantizationConfig, None] = None,
        quant_kwargs: Optional[Dict] = None,
        components_to_quantize: Optional[list] = None,
        quant_mapping: Optional[Dict[str, Union[str, QuantizationConfig, Dict]]] = None,
    ):
        if quant_mapping is None and quant_backend is None:
            raise ValueError("provide either quant_backend or quant_mapping")
        if isinstance(quant_backend, str) and quant_kwargs:
            quant_backend = {"quant_method": quant_backend, **quant_kwargs}
        self.default_config = resolve_quantization_config(quant_backend) if quant_backend else None
        self.components_to_quantize = components_to_quantize
        self.quant_mapping = {
            name: resolve_quantization_config(cfg) for name, cfg in (quant_mapping or {}).items()
        }

    def config_for(self, component_name: str) -> Optional[QuantizationConfig]:
        if component_name in self.quant_mapping:
            return self.quant_mapping[component_name]
        if self.default_config is not None and (
            self.components_to_quantize is None or component_name in self.components_to_quantize
        ):
            return self.default_config
        return None

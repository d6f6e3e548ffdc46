"""Weight quantization over a module tree: JAX's rule set and its four
configs, quantized in memory or on load.

Port of `diffusers_tpu/quantizers/quantize.py`: `_quantize_kernel_int8`
`:30-37`, `pack_int4_rows` / `unpack_int4_rows` / `_quantize_kernel_int4`
`:40-78`, `_quantize_kernel_fp8` `:81-86`, `_quantize_conv_kernel_int8`
`:89-97`, `_conv_int8_eligible` `:100-106`, `dequantize_int4` `:205-216`,
and the rules of `_quantize_params_traced` `:127-180` (the host twin the JAX
loader runs, `_host_maybe_quantize` in `models/modeling_utils.py:252-287`,
takes the same). JAX marks a parameter leaf with a scale key; here the layer
is swapped for a quantized one of `ops.module`:

  ===========================================  ==================  =====================
  config, layer                                JAX leaf            port layer
  ===========================================  ==================  =====================
  `Int8DynamicActConfig()`, Linear             kernel_scale_w8a8   `W8A8Linear` (K5)
  `Int8DynamicActConfig(impl="xla")`, Linear   kernel_scale_i8x    `Int8PerTensorLinear`
  `Int8DynamicActConfig` (any impl), Conv2d    kernel_scale_w8a8   `Int8Conv2d`
  `Int8WeightOnlyConfig`, Linear               kernel_scale        `WeightOnlyLinear` int8
  `Fp8WeightOnlyConfig`, Linear                kernel_scale        `WeightOnlyLinear` fp8
  `Int4WeightOnlyConfig`, Linear               kernel_scale_int4   `Int4Linear`
  ===========================================  ==================  =====================

`quantized_module_names(model, config)` is JAX's selection: an `nn.Linear`
or `nn.Conv2d` of at least ``config.min_weight_size`` weight elements whose
path (``root.<module name>``, JAX's) holds none of
``config.modules_to_not_convert``; under `Int8DynamicActConfig` a Linear also
passes JAX's gate ``K >= 2560 or (K >= 1280 and N >= 2560)`` (K in, N out)
and a conv `_conv_int8_eligible` (fan-in ``I * kh * kw``: ``(fan_in >= 2560
or (fan_in >= 1280 and O >= 2560)) and O >= 256``); the weight-only configs
take every such Linear and no conv. `quantize_model(model, config)` is the
in-memory counterpart of JAX's `quantize_params(params, config)`, and
`ModelMixin.from_pretrained(quantization_config=...)` applies the same rule
on load. `w8a8_linear_names` and `int4_linear_names` are the Linear parts of
the rule for their configs. Two more rules are bench.py's:
`quantize_w8a8(model, min_weight_size)` (`bench.py:189-196`: every 2-D
Linear of at least 2^20 elements, no shape gate), which the Flux bench path
builds with, and `quantize_int4(model, min_weight_size=2**20,
group_size=128)` (`build_t5_xxl_int4`, `bench.py:249-258`).

Scales are per output channel (per [output channel, group] for int4): the
f32 absmax over the other axes, ``max(absmax, 1e-8) / q_max`` (127, 448 for
fp8 e4m3fn, 7 for int4) as a true division, then ``w / scale`` rounded half
to even and clipped (int8, int4) or cast with round-to-nearest-even (fp8).
That is JAX's eager rule and its host loader's bit for bit, where JAX's
jitted `quantize_params` may differ in the last bit (XLA turns the division
by a constant into a product with its reciprocal; ROADMAP C3). The int4
format is JAX's: nibble-packed int8, one group spanning the whole input
where ``group_size`` does not divide it, transposed to torch's [out, in].
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.module import Int4Linear, Int8Conv2d, Int8PerTensorLinear, W8A8Linear, WeightOnlyLinear
from .quantization_config import (
    Fp8WeightOnlyConfig,
    Int4WeightOnlyConfig,
    Int8DynamicActConfig,
    Int8WeightOnlyConfig,
    QuantizationConfig,
)

QUANTIZED_LAYERS = (W8A8Linear, Int8PerTensorLinear, Int8Conv2d, WeightOnlyLinear, Int4Linear)
FP8_MAX = 448.0  # float8 e4m3fn's largest normal


def _scale(absmax: torch.Tensor, q_max: float) -> torch.Tensor:
    return absmax.clamp_min(1e-8) / absmax.new_full((), q_max)  # a true division on every device


def quantize_kernel_int8(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[out, ...] float -> int8 of the same shape + per-out-channel f32
    scale: f32 absmax over every axis but the first, ``max(absmax, 1e-8) /
    127``, round half to even, clip to +-127 (`_quantize_kernel_int8` on a
    Linear's transposed kernel, `_quantize_conv_kernel_int8` on a conv's
    OIHW weight)."""
    w = weight.float()
    scale = _scale(w.abs().amax(dim=tuple(range(1, w.ndim))), 127.0)
    q = torch.clamp(torch.round(w / scale.reshape(-1, *(1,) * (w.ndim - 1))), -127, 127).to(torch.int8)
    return q, scale



def quantize_kernel_fp8(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[out, in] float -> float8_e4m3fn [out, in] + per-out-channel f32
    scale ``max(absmax, 1e-8) / 448``; ``w / scale`` cast with
    round-to-nearest-even (`_quantize_kernel_fp8` on the transposed
    kernel)."""
    w = weight.float()
    scale = _scale(w.abs().amax(dim=1), FP8_MAX)
    return (w / scale[:, None]).to(torch.float8_e4m3fn), scale


def _conv_int8_eligible(conv: nn.Conv2d) -> bool:
    """JAX's gate for int8 convs (`_conv_int8_eligible`) on a torch OIHW weight."""
    cout, cin, kh, kw = conv.weight.shape
    fan_in = cin * kh * kw
    return (fan_in >= 2560 or (fan_in >= 1280 and cout >= 2560)) and cout >= 256


def _w8a8_gate(linear: nn.Linear) -> bool:
    k, n = linear.in_features, linear.out_features
    return k >= 2560 or (k >= 1280 and n >= 2560)


_CONFIGS = (Int8DynamicActConfig, Int8WeightOnlyConfig, Fp8WeightOnlyConfig, Int4WeightOnlyConfig)


def quantized_module_names(model: nn.Module, config: QuantizationConfig) -> List[str]:
    """The names of the Linears and convs of `model` that JAX's
    `quantize_params` quantizes under `config` (module docstring)."""
    if not isinstance(config, _CONFIGS):
        raise TypeError(f"{type(config).__name__} is not a quantization config the port runs; it takes "
                        + ", ".join(c.__name__ for c in _CONFIGS))
    dynamic = isinstance(config, Int8DynamicActConfig)
    names = []
    for name, module in model.named_modules():
        if not isinstance(module, (nn.Linear, nn.Conv2d)) or module.weight.numel() < config.min_weight_size:
            continue
        if any(m in f"root.{name}" for m in config.modules_to_not_convert):
            continue
        if isinstance(module, nn.Linear) and (not dynamic or _w8a8_gate(module)):
            names.append(name)
        elif isinstance(module, nn.Conv2d) and dynamic and _conv_int8_eligible(module):
            names.append(name)
    return names


def w8a8_linear_names(model: nn.Module, config: Int8DynamicActConfig) -> List[str]:
    """The Linears `Int8DynamicActConfig` quantizes (per row, or per tensor
    with ``impl="xla"``): `quantized_module_names` without the convs."""
    if not isinstance(config, Int8DynamicActConfig):
        raise TypeError(f"w8a8_linear_names takes an Int8DynamicActConfig, not {type(config).__name__}; "
                        "quantized_module_names takes every config")
    return [n for n in quantized_module_names(model, config) if isinstance(model.get_submodule(n), nn.Linear)]


def int4_linear_names(model: nn.Module, config: Int4WeightOnlyConfig) -> List[str]:
    """The Linears `Int4WeightOnlyConfig` quantizes (module docstring)."""
    return quantized_module_names(model, config)


def _int4_groups(in_features: int, group_size: int) -> int:
    """Scale groups along an input dim: one where `group_size` does not divide it."""
    return in_features // group_size if in_features % group_size == 0 else 1


def quantized_like(module: nn.Module, config: QuantizationConfig) -> nn.Module:
    """The empty quantized layer that stands in for `module` (an `nn.Linear`
    or, under `Int8DynamicActConfig`, an `nn.Conv2d`) under `config`, on its
    device (the module docstring's table)."""
    if isinstance(module, nn.Conv2d):
        if not isinstance(config, Int8DynamicActConfig):
            raise TypeError(f"{type(config).__name__} quantizes no convolution")
        return Int8Conv2d.like(module)
    args = (module.in_features, module.out_features)
    with torch.device(module.weight.device):
        if isinstance(config, Int8DynamicActConfig):
            cls = Int8PerTensorLinear if config.impl == "xla" else W8A8Linear
            return cls(*args, use_bias=module.bias is not None)
        if isinstance(config, Int4WeightOnlyConfig):
            return Int4Linear(*args, _int4_groups(args[0], config.group_size), use_bias=module.bias is not None)
        dtype = torch.float8_e4m3fn if isinstance(config, Fp8WeightOnlyConfig) else torch.int8
        return WeightOnlyLinear(*args, use_bias=module.bias is not None, weight_dtype=dtype)


def quantize_weight(layer: nn.Module, weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(quantized weight, f32 scales) of a float `weight` for the quantized
    `layer` it fills, on the weight's device."""
    if isinstance(layer, Int4Linear):
        return quantize_kernel_int4(weight, layer.in_features // layer.weight_scale.shape[1])
    if isinstance(layer, WeightOnlyLinear) and layer.weight.dtype == torch.float8_e4m3fn:
        return quantize_kernel_fp8(weight)
    return quantize_kernel_int8(weight)


def replace_with_quantized(model: nn.Module, names: Sequence[str], config: QuantizationConfig) -> List[nn.Module]:
    """Replace each named module of `model` by its empty quantized layer
    (`quantized_like`) on its device: the meta device, for a model
    `from_pretrained` is about to fill. Returns the new layers."""
    out = []
    for name in names:  # by name, so each float layer is released once it is swapped
        q = quantized_like(model.get_submodule(name), config)
        parent_name, _, child = name.rpartition(".")
        setattr(model.get_submodule(parent_name) if parent_name else model, child, q)
        out.append(q)
    return out


@torch.no_grad()
def quantize_modules(model: nn.Module, names: Sequence[str], config: QuantizationConfig) -> nn.Module:
    """Quantize the named modules of `model` in place on their device under
    `config` (the bias kept), freeing each float weight as it goes. Returns
    `model`."""
    for name in names:
        layer = model.get_submodule(name)
        (q,) = replace_with_quantized(model, [name], config)
        weight, scale = quantize_weight(q, layer.weight)
        q.weight = nn.Parameter(weight, requires_grad=False)
        q.weight_scale = scale
        if layer.bias is not None:
            q.bias.data = layer.bias.data
    return model


def quantize_model(model: nn.Module, config: QuantizationConfig) -> nn.Module:
    """JAX's `quantize_params(params, config)` on a built module: every layer
    `quantized_module_names` selects becomes its quantized layer, in place.
    Returns `model`."""
    return quantize_modules(model, quantized_module_names(model, config), config)


def quantize_linears(model: nn.Module, names: Sequence[str]) -> nn.Module:
    """Quantize the named Linears of `model` to `W8A8Linear`s in place."""
    return quantize_modules(model, names, Int8DynamicActConfig())


def quantize_w8a8(model: nn.Module, min_weight_size: int = 2**20) -> nn.Module:
    """bench.py's rule: replace every `nn.Linear` of `model` whose weight has
    at least `min_weight_size` elements by a `W8A8Linear` on the same device.
    Returns `model`."""
    return quantize_linears(model, [name for name, mod in model.named_modules()
                                    if isinstance(mod, nn.Linear) and mod.weight.numel() >= min_weight_size])


# ------------------------------------------------------------------ int4


def pack_int4_rows(q: torch.Tensor) -> torch.Tensor:
    """[out, in] integers in [-8, 7] -> int8 [out, ceil(in / 2)], two nibbles
    a byte: input column 2j in the low nibble, 2j + 1 in the high (JAX's
    `pack_int4_rows` on the transposed kernel; an odd input dim is padded
    with a zero column)."""
    q = q.to(torch.int16)
    if q.shape[1] % 2:
        q = torch.cat([q, q.new_zeros(q.shape[0], 1)], dim=1)
    lo, hi = q[:, 0::2] & 0x0F, q[:, 1::2] & 0x0F
    return (lo | (hi << 4)).to(torch.uint8).view(torch.int8)


def unpack_int4_rows(packed: torch.Tensor, in_features: int, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of `pack_int4_rows`: [out, in_features] nibble values in
    `dtype`, sign-extended (no scales applied)."""
    p = packed.to(torch.int16)
    lo = ((p & 0x0F) ^ 8) - 8
    hi = p >> 4  # the arithmetic shift of the signed byte: the high nibble, sign-extended
    return torch.stack([lo, hi], dim=-1).reshape(packed.shape[0], -1)[:, :in_features].to(dtype)


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype,
                    in_features: Optional[int] = None) -> torch.Tensor:
    """Packed int8 [out, ceil(in / 2)] and scales [out, groups] -> `dtype`
    [out, in]: the nibbles converted to `dtype`, then each group multiplied
    by its scale cast to `dtype` (JAX's `dequantize_int4`)."""
    in_features = in_features if in_features is not None else 2 * packed.shape[1]
    out, groups = scale.shape
    w = unpack_int4_rows(packed, in_features, dtype).reshape(out, groups, in_features // groups)
    return (w * scale.to(dtype)[:, :, None]).reshape(out, in_features)


def quantize_kernel_int4(weight: torch.Tensor, group_size: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """[out, in] float -> (packed int8 [out, ceil(in / 2)], f32 scales [out,
    groups]): groups of `group_size` inputs (one group of the whole input
    where it does not divide), f32 absmax, ``max(absmax, 1e-8) / 7``, round
    half to even, clip to +-7 (`_quantize_kernel_int4` on the transposed
    kernel)."""
    w = weight.float()
    out, in_features = w.shape
    g = group_size if in_features % group_size == 0 else in_features
    wg = w.reshape(out, in_features // g, g)
    absmax = wg.abs().amax(dim=2)
    scale = absmax.clamp_min(1e-8) / absmax.new_full((), 7.0)  # a true division on every device
    q = torch.clamp(torch.round(wg / scale[:, :, None]), -7, 7).reshape(out, in_features)
    return pack_int4_rows(q), scale


def quantize_int4_linears(model: nn.Module, names: Sequence[str], group_size: int = 128) -> nn.Module:
    """Quantize the named Linears of `model` to `Int4Linear`s in place."""
    return quantize_modules(model, names, Int4WeightOnlyConfig(group_size=group_size))


def quantize_int4(model: nn.Module, min_weight_size: int = 2**20, group_size: int = 128) -> nn.Module:
    """bench.py's int4 rule: every `nn.Linear` of `model` whose weight has at
    least `min_weight_size` elements becomes an `Int4Linear` on its device.
    Returns `model`."""
    return quantize_int4_linears(model, [name for name, mod in model.named_modules()
                                         if isinstance(mod, nn.Linear) and mod.weight.numel() >= min_weight_size],
                                 group_size)

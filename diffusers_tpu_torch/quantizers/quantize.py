"""w8a8 and group-wise int4 weight quantization over a module tree.

Port of the w8a8 and int4 parts of `diffusers_tpu/quantizers/quantize.py`
(`_quantize_kernel_int8` `:30-37`, `pack_int4_rows` / `unpack_int4_rows` /
`_quantize_kernel_int4` `:40-78`, `dequantize_int4` `:205-216`, the
`Int8DynamicActConfig` and `Int4WeightOnlyConfig` branches of
`_quantize_params_traced` `:123-176`). JAX marks a Linear's parameter leaf
with ``kernel_scale_w8a8`` or ``kernel_scale_int4``; here a selected `Linear`
becomes a `W8A8Linear` or an `Int4Linear`.

Four selection rules live here, each for its callers:

  * `w8a8_linear_names(model, config)` is JAX's rule for a config: a 2-D
    kernel (an `nn.Linear`) of at least ``config.min_weight_size`` elements,
    whose path (``root.<module name>``, JAX's) holds none of
    ``config.modules_to_not_convert``, and whose shape passes JAX's gate
    ``K >= 2560 or (K >= 1280 and N >= 2560)`` (K in, N out). It is what
    `from_pretrained(quantization_config=Int8DynamicActConfig())` applies.
  * `quantize_w8a8(model, min_weight_size)` is bench.py's rule
    (`bench.py:189-196`: every 2-D Linear of at least 2^20 elements, no shape
    gate), which the Flux bench path builds with.
  * `int4_linear_names(model, config)` is JAX's rule for
    `Int4WeightOnlyConfig`: every `nn.Linear` of at least
    ``config.min_weight_size`` elements (4096 by default) whose path holds
    none of ``config.modules_to_not_convert``; no shape gate.
  * `quantize_int4(model, min_weight_size=2**20, group_size=128)` is
    bench.py's rule for its T5-XXL (`build_t5_xxl_int4`, `bench.py:249-258`:
    every 2-D Linear of at least 2^20 elements).

The int4 format is JAX's: nibble-packed int8, one f32 scale per [group of
``group_size`` inputs, output channel], and one group spanning the whole
input where ``group_size`` does not divide it; the port keeps it transposed
to torch's [out, in] layout. The scales are ``absmax / 7`` as a true
division: JAX's eager `_quantize_kernel_int4` bit for bit, where JAX's
jitted `quantize_params` may differ in the last bit (ROADMAP C3).

The configs the port does not run yet raise `NotImplementedError` rather
than leaving a layer unquantized: `Int8DynamicActConfig(impl="xla")`, a
Conv2d that JAX's `_conv_int8_eligible` takes, and the int8 and fp8
weight-only configs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.module import Int4Linear, W8A8Linear
from .quantization_config import Int4WeightOnlyConfig, Int8DynamicActConfig, QuantizationConfig


def quantize_kernel_int8(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[out, in] float -> int8 [out, in] + per-out-channel f32 scale: f32
    absmax over the input axis, ``max(absmax, 1e-8) / 127``, round half to
    even, clip to +-127 (`_quantize_kernel_int8` on the transposed kernel)."""
    w = weight.float()
    absmax = w.abs().amax(dim=1)
    scale = absmax.clamp_min(1e-8) / absmax.new_full((), 127.0)  # a true division on every device
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def _conv_int8_eligible(conv: nn.Conv2d) -> bool:
    """JAX's gate for int8 convs (`_conv_int8_eligible`) on a torch OIHW weight."""
    cout, cin, kh, kw = conv.weight.shape
    fan_in = cin * kh * kw
    return (fan_in >= 2560 or (fan_in >= 1280 and cout >= 2560)) and cout >= 256


def w8a8_linear_names(model: nn.Module, config: QuantizationConfig) -> List[str]:
    """The names of the Linears of `model` that JAX's `quantize_params` marks
    ``kernel_scale_w8a8`` under `config` (module docstring). Raises
    `NotImplementedError` for what the port does not run yet."""
    if not isinstance(config, Int8DynamicActConfig):
        raise NotImplementedError(f"{type(config).__name__} ({config.quant_method}) is not ported yet (ROADMAP "
                                  "A6.2); the port quantizes on load with Int8DynamicActConfig (w8a8) and "
                                  "Int4WeightOnlyConfig (group-wise int4)")
    if config.impl != "pallas":
        raise NotImplementedError(f"Int8DynamicActConfig(impl={config.impl!r}), the per-tensor int8 path, is not "
                                  "ported yet (ROADMAP A6.2); impl='pallas' is the w8a8 kernel")
    names = []
    for name, module in model.named_modules():
        if not isinstance(module, (nn.Linear, nn.Conv2d)) or module.weight.numel() < config.min_weight_size:
            continue
        if any(m in f"root.{name}" for m in config.modules_to_not_convert):
            continue
        if isinstance(module, nn.Conv2d):
            if _conv_int8_eligible(module):
                raise NotImplementedError(f"{name}: an int8 convolution, which JAX's Int8DynamicActConfig takes "
                                          "at this shape, is not ported yet (ROADMAP A6.2)")
            continue
        k, n = module.in_features, module.out_features
        if k >= 2560 or (k >= 1280 and n >= 2560):
            names.append(name)
    return names


def replace_with_w8a8(model: nn.Module, names: Sequence[str]) -> List[W8A8Linear]:
    """Replace each named `nn.Linear` of `model` by an empty `W8A8Linear` of
    its shape on its device (the meta device, for a model `from_pretrained`
    is about to fill). Returns the new modules."""
    out = []
    for name in names:  # by name, so each float Linear is released once it is swapped
        lin = model.get_submodule(name)
        with torch.device(lin.weight.device):
            q = W8A8Linear(lin.in_features, lin.out_features, use_bias=lin.bias is not None)
        parent_name, _, child = name.rpartition(".")
        setattr(model.get_submodule(parent_name) if parent_name else model, child, q)
        out.append(q)
    return out


@torch.no_grad()
def quantize_linears(model: nn.Module, names: Sequence[str]) -> nn.Module:
    """Quantize the named Linears of `model` to `W8A8Linear`s in place on
    their device (`quantize_kernel_int8`; the bias kept), freeing each float
    weight as it goes. Returns `model`."""
    for name in names:
        lin = model.get_submodule(name)
        (q,) = replace_with_w8a8(model, [name])
        q.weight.data, q.weight_scale.data = quantize_kernel_int8(lin.weight)
        if lin.bias is not None:
            q.bias.data = lin.bias.data
    return model


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


def _int4_groups(in_features: int, group_size: int) -> int:
    """Scale groups along an input dim: one where `group_size` does not divide it."""
    return in_features // group_size if in_features % group_size == 0 else 1


def int4_linear_names(model: nn.Module, config: Int4WeightOnlyConfig) -> List[str]:
    """The names of the Linears of `model` that JAX's `quantize_params` marks
    ``kernel_scale_int4`` under `config` (module docstring)."""
    return [name for name, module in model.named_modules()
            if isinstance(module, nn.Linear) and module.weight.numel() >= config.min_weight_size
            and not any(m in f"root.{name}" for m in config.modules_to_not_convert)]


def replace_with_int4(model: nn.Module, names: Sequence[str], group_size: int) -> List[Int4Linear]:
    """Replace each named `nn.Linear` by an empty `Int4Linear` of its shape
    and group count on its device. Returns the new modules."""
    out = []
    for name in names:
        lin = model.get_submodule(name)
        with torch.device(lin.weight.device):
            q = Int4Linear(lin.in_features, lin.out_features, _int4_groups(lin.in_features, group_size),
                           use_bias=lin.bias is not None)
        parent_name, _, child = name.rpartition(".")
        setattr(model.get_submodule(parent_name) if parent_name else model, child, q)
        out.append(q)
    return out


@torch.no_grad()
def quantize_int4_linears(model: nn.Module, names: Sequence[str], group_size: int = 128) -> nn.Module:
    """Quantize the named Linears of `model` to `Int4Linear`s in place on
    their device (`quantize_kernel_int4`; the bias kept), freeing each float
    weight as it goes. Returns `model`."""
    for name in names:
        lin = model.get_submodule(name)
        (q,) = replace_with_int4(model, [name], group_size)
        q.weight.data, q.weight_scale.data = quantize_kernel_int4(lin.weight, group_size)
        if lin.bias is not None:
            q.bias.data = lin.bias.data
    return model


def quantize_int4(model: nn.Module, min_weight_size: int = 2**20, group_size: int = 128) -> nn.Module:
    """bench.py's int4 rule: every `nn.Linear` of `model` whose weight has at
    least `min_weight_size` elements becomes an `Int4Linear` on its device.
    Returns `model`."""
    return quantize_int4_linears(model, [name for name, mod in model.named_modules()
                                         if isinstance(mod, nn.Linear) and mod.weight.numel() >= min_weight_size],
                                 group_size)

"""w8a8 weight quantization over a module tree.

Port of the w8a8 part of `diffusers_tpu/quantizers/quantize.py`
(`_quantize_kernel_int8` `:30-37`, the `Int8DynamicActConfig` branch of
`_quantize_params_traced` `:123-176`). JAX marks a Linear's parameter leaf
with ``kernel_scale_w8a8``; here a selected `Linear` becomes a `W8A8Linear`.

Two selection rules live here, each for its callers:

  * `w8a8_linear_names(model, config)` is JAX's rule for a config: a 2-D
    kernel (an `nn.Linear`) of at least ``config.min_weight_size`` elements,
    whose path (``root.<module name>``, JAX's) holds none of
    ``config.modules_to_not_convert``, and whose shape passes JAX's gate
    ``K >= 2560 or (K >= 1280 and N >= 2560)`` (K in, N out). It is what
    `from_pretrained(quantization_config=Int8DynamicActConfig())` applies.
  * `quantize_w8a8(model, min_weight_size)` is bench.py's rule
    (`bench.py:189-196`: every 2-D Linear of at least 2^20 elements, no shape
    gate), which the Flux bench path builds with.

The configs the port does not run yet raise `NotImplementedError` rather
than leaving a layer unquantized: `Int8DynamicActConfig(impl="xla")`, a
Conv2d that JAX's `_conv_int8_eligible` takes, and the weight-only configs.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from ..ops.module import W8A8Linear
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
        item = "A6.1" if isinstance(config, Int4WeightOnlyConfig) else "A6.2"
        raise NotImplementedError(f"{type(config).__name__} ({config.quant_method}) is not ported yet (ROADMAP "
                                  f"{item}); the port quantizes on load with Int8DynamicActConfig (w8a8)")
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

"""w8a8 weight quantization over a module tree.

Port of the w8a8 part of `diffusers_tpu/quantizers/quantize.py`
(`_quantize_kernel_int8` `:30-37`, the `Int8DynamicActConfig` branch of
`quantize_params`). JAX marks a Linear's parameter leaf with
``kernel_scale_w8a8``; here `quantize_w8a8` swaps each eligible `Linear` for a
`W8A8Linear` in place. The size rule is the one the Flux bench uses
(`bench.py:189-196`: every 2-D kernel of at least 2^20 elements). JAX's v5e
shape gate (K >= 2560, or K >= 1280 and N >= 2560, `quantize.py:145`) is not
copied: it records where the TPU's int8 path won, and the H100's int8 tensor
cores are a different trade.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops.module import W8A8Linear


def quantize_kernel_int8(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[out, in] float -> int8 [out, in] + per-out-channel f32 scale: f32
    absmax over the input axis, ``max(absmax, 1e-8) / 127``, round half to
    even, clip to +-127 (`_quantize_kernel_int8` on the transposed kernel)."""
    w = weight.float()
    absmax = w.abs().amax(dim=1)
    scale = absmax.clamp_min(1e-8) / absmax.new_full((), 127.0)  # a true division on every device
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def quantize_w8a8(model: nn.Module, min_weight_size: int = 2**20) -> nn.Module:
    """Replace every `nn.Linear` of `model` whose weight has at least
    `min_weight_size` elements by a `W8A8Linear` on the same device, freeing
    the float weight as it goes. Returns `model`."""
    names = [name for name, mod in model.named_modules()
             if isinstance(mod, nn.Linear) and mod.weight.numel() >= min_weight_size]
    for name in names:  # by name, so each float Linear is released once it is swapped
        lin = model.get_submodule(name)
        with torch.device(lin.weight.device):
            q = W8A8Linear(lin.in_features, lin.out_features, use_bias=lin.bias is not None)
        q.weight.data, q.weight_scale.data = quantize_kernel_int8(lin.weight)
        if lin.bias is not None:
            q.bias.data = lin.bias.data
        parent_name, _, child = name.rpartition(".")
        setattr(model.get_submodule(parent_name) if parent_name else model, child, q)
    return model

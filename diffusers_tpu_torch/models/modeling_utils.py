"""Model base class and the weight bridge from the JAX package.

Port of the layout rules of `diffusers_tpu/models/modeling_utils.py`
(`_leaf_convert_to_torch` `:86-99`), extended to the w8a8 Linear branch
(int8 ``kernel`` + ``kernel_scale_w8a8``) and RMSNorm's ``scale``. `from_pretrained` / `save_pretrained`
wait until checkpoint files are in the repository.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..ops.module import RMSNorm, W8A8Linear

CONFIG_NAME = "config.json"


class ModelMixin(nn.Module):
    """Base of every port model: an `nn.Module` with a `config.json` config."""

    config_name = CONFIG_NAME

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype


def _leaf_to_torch(module: nn.Module, name: str, array: np.ndarray):
    """(state-dict name, array in torch layout) for one JAX parameter leaf."""
    if isinstance(module, (nn.Linear, W8A8Linear)) and name == "kernel":  # [in, out] -> [out, in]
        return "weight", array.T
    if isinstance(module, W8A8Linear) and name == "kernel_scale_w8a8":
        return "weight_scale", array
    if isinstance(module, nn.Conv2d) and name == "kernel":  # HWIO -> OIHW
        return "weight", array.transpose(3, 2, 0, 1)
    if isinstance(module, (nn.GroupNorm, nn.LayerNorm, RMSNorm)) and name == "scale":
        return "weight", array
    if isinstance(module, nn.Embedding) and name == "embedding":
        return "weight", array
    return name, array


def load_jax_params(module: nn.Module, tree: Dict[Any, Any]) -> nn.Module:
    """Load a JAX parameter pytree (nested dicts of numpy arrays, integer keys
    for module lists, as `jax.device_get(params)` returns) into `module`,
    walking it to learn each leaf's layer type. A Linear whose leaf carries
    ``kernel_scale_w8a8`` (JAX's w8a8 branch) becomes a `W8A8Linear` in place,
    so one quantized JAX tree drives both packages. Strict: every key must
    match, in both directions. Returns the module."""
    state: Dict[str, torch.Tensor] = {}

    def walk(mod: nn.Module, node: Dict[Any, Any], prefix: str):
        for k, v in node.items():
            if isinstance(v, dict):
                child = mod.get_submodule(str(k))
                if "kernel_scale_w8a8" in v and isinstance(child, nn.Linear):
                    with torch.device(child.weight.device):
                        child = W8A8Linear(child.in_features, child.out_features, use_bias=child.bias is not None)
                    setattr(mod, str(k), child)
                walk(child, v, f"{prefix}{k}.")
                continue
            array = np.asarray(v)
            if array.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch.from_numpy
                array = array.astype(np.float32)
            name, array = _leaf_to_torch(mod, str(k), array)
            state[f"{prefix}{name}"] = torch.from_numpy(np.array(array))  # a writable copy

    walk(module, tree, "")
    module.load_state_dict(state, strict=True)
    return module


def _units(parent: nn.Module, name: str, module: nn.Module):
    """(parent, name, module) of the allocation units under `module`: a module
    list, or a module holding one, is split into its children; anything else
    is one unit."""
    if isinstance(module, nn.ModuleList) or any(isinstance(c, nn.ModuleList) for c in module.children()):
        for child_name, child in module.named_children():
            yield from _units(module, child_name, child)
    else:
        yield parent, name, module


@torch.no_grad()
def materialize_(model: nn.Module, device, dtype: torch.dtype, per_unit: Optional[Callable] = None) -> nn.Module:
    """Allocate a model built on the meta device one unit (a block, an
    embedder) at a time: random init by each module's `reset_parameters` on
    `device`, a cast to `dtype`, then `per_unit(holder)` with the unit at
    ``holder["unit"]`` (`quantize_w8a8`, say) before the next unit is
    allocated, so a full float copy of the model never exists. Returns
    `model`."""
    units = [u for child_name, child in model.named_children() for u in _units(model, child_name, child)]
    for parent, name, unit in units:
        unit.to_empty(device=device)
        for m in unit.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters()
        unit.to(dtype)
        if per_unit is not None:
            holder = nn.ModuleDict({"unit": unit})
            per_unit(holder)
            setattr(parent, name, holder["unit"])
    return model

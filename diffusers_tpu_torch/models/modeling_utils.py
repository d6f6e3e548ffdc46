"""Model base class, checkpoint writing, and the weight bridge from the JAX
package.

Port of the layout rules of `diffusers_tpu/models/modeling_utils.py`
(`_leaf_convert_to_torch` `:86-99`), extended to the w8a8 Linear branch
(int8 ``kernel`` + ``kernel_scale_w8a8``) and RMSNorm's ``scale``, and of
`ModelMixin.save_pretrained` (`:526-560`): `config.json` plus
`diffusion_pytorch_model.safetensors`, sharded with its `.index.json` above
`max_shard_size`. The safetensors files are written with the standard library
and numpy (an 8-byte little-endian header length, the JSON header, then each
tensor's raw little-endian bytes), one tensor at a time, so a model on the
card never has a second full copy on the host. `from_pretrained` waits until
checkpoint files are in the repository.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from ..ops.module import RMSNorm, W8A8Linear

CONFIG_NAME = "config.json"
SAFETENSORS_WEIGHTS_NAME = "diffusion_pytorch_model.safetensors"
SAFETENSORS_INDEX_NAME = "diffusion_pytorch_model.safetensors.index.json"
_SAFETENSORS_DTYPES = {
    torch.float64: "F64", torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
    torch.int64: "I64", torch.int32: "I32", torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8",
    torch.bool: "BOOL",
}


def _parse_size(size: Union[int, str]) -> int:
    if isinstance(size, str):
        units = {"KB": 10**3, "MB": 10**6, "GB": 10**9}
        suffix = size[-2:].upper()
        return int(float(size[:-2]) * units[suffix]) if suffix in units else int(size)
    return int(size)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def save_safetensors(tensors: Dict[str, torch.Tensor], path: Union[str, os.PathLike]) -> None:
    """Write `tensors` (any device) as one safetensors file."""
    header: Dict[str, Any] = {}
    offset = 0
    for name, t in tensors.items():
        header[name] = {"dtype": _SAFETENSORS_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + _nbytes(t)]}
        offset += _nbytes(t)
    header["__metadata__"] = {"format": "pt"}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            t = t.detach().to("cpu").contiguous()
            if t.dtype == torch.bfloat16:  # numpy has no bf16: its bits as int16
                t = t.view(torch.int16)
            f.write(t.numpy().tobytes())  # native order: little-endian on x86-64 and aarch64, as the format needs


class ModelMixin(nn.Module):
    """Base of every port model: an `nn.Module` with a `config.json` config."""

    config_name = CONFIG_NAME

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    def save_pretrained(self, save_directory: Union[str, os.PathLike], max_shard_size: Union[int, str] = "10GB"):
        """Write `config.json` and the state dict as safetensors; above
        `max_shard_size` it shards, in key order, into
        `diffusion_pytorch_model-0000i-of-0000n.safetensors` plus
        `diffusion_pytorch_model.safetensors.index.json`, as the JAX
        package does."""
        os.makedirs(save_directory, exist_ok=True)
        self.save_config(save_directory)
        state_dict = self.state_dict()
        max_bytes = _parse_size(max_shard_size)
        total = sum(_nbytes(t) for t in state_dict.values())
        if total <= max_bytes:
            save_safetensors(state_dict, os.path.join(save_directory, SAFETENSORS_WEIGHTS_NAME))
            return

        # greedy split preserving key order
        shards, current, current_bytes = [], {}, 0
        for k, t in state_dict.items():
            if current and current_bytes + _nbytes(t) > max_bytes:
                shards.append(current)
                current, current_bytes = {}, 0
            current[k] = t
            current_bytes += _nbytes(t)
        if current:
            shards.append(current)

        stem, ext = SAFETENSORS_WEIGHTS_NAME.rsplit(".", 1)
        weight_map = {}
        for i, shard in enumerate(shards, start=1):
            fname = f"{stem}-{i:05d}-of-{len(shards):05d}.{ext}"
            save_safetensors(shard, os.path.join(save_directory, fname))
            weight_map.update(dict.fromkeys(shard, fname))
        index = {"metadata": {"total_size": total}, "weight_map": weight_map}
        with open(os.path.join(save_directory, SAFETENSORS_INDEX_NAME), "w") as f:
            json.dump(index, f, indent=2, sort_keys=True)


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

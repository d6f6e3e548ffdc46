"""Model base class, checkpoint reading and writing, and the weight bridge
from the JAX package.

Port of the layout rules of `diffusers_tpu/models/modeling_utils.py`
(`_leaf_convert_to_torch` `:86-99`), extended to the w8a8 Linear branch
(int8 ``kernel`` + ``kernel_scale_w8a8``), the group-wise int4 branch
(nibble-packed ``kernel`` + ``kernel_scale_int4``, both transposed) and
RMSNorm's ``scale``, of
`ModelMixin.save_pretrained` (`:526-560`): `config.json` plus
`diffusion_pytorch_model[.variant].safetensors`, sharded with its
`.index.json` above `max_shard_size`, and of `ModelMixin.from_pretrained`
(`:439`) with its streaming load (`stream_load_params` `:289`) over the same
files (`_resolve_weight_files` `:174`). A class names its own checkpoint
layout: the text encoders read and write transformers' (`model.safetensors`,
or `model-0000i-of-0000n.safetensors` shards with
`model.safetensors.index.json`) and keep only the keys of their encoder, as
the JAX text encoders' `from_pretrained` do. `quantization_config` quantizes
on load: the Linears and convs the config selects
(`quantizers.quantize.quantized_module_names`, JAX's rules) become their
quantized layers on the meta model (`W8A8Linear`, `Int8PerTensorLinear`,
`Int8Conv2d`, `WeightOnlyLinear`, `Int4Linear`), and each float weight is
quantized on the device as it arrives.

The safetensors files are read and written with the standard library (an
8-byte little-endian header length, the JSON header, then each tensor's raw
little-endian bytes), one tensor at a time: the `safetensors` package is not
needed. A model on the card never has a second full copy on the host, going
out or coming in: `from_pretrained` builds the model on the meta device and
places each tensor, read through a memory map, on its device in its dtype
before it reads the next.
"""
from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..ops.module import Int4Linear, Int8Conv2d, Int8PerTensorLinear, RMSNorm, W8A8Linear, WeightOnlyLinear
from ..quantizers.auto import resolve_quantization_config
from ..quantizers.quantize import QUANTIZED_LAYERS, quantize_weight, quantized_module_names, replace_with_quantized

CONFIG_NAME = "config.json"
SAFETENSORS_WEIGHTS_NAME = "diffusion_pytorch_model.safetensors"
SAFETENSORS_INDEX_NAME = "diffusion_pytorch_model.safetensors.index.json"
_SAFETENSORS_DTYPES = {
    torch.float64: "F64", torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
    torch.int64: "I64", torch.int32: "I32", torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8",
    torch.bool: "BOOL", torch.float8_e4m3fn: "F8_E4M3",
}
_SAFETENSORS_TORCH_DTYPES = {name: dtype for dtype, name in _SAFETENSORS_DTYPES.items()}


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
            elif t.dtype == torch.float8_e4m3fn:  # nor fp8: its bytes
                t = t.view(torch.uint8)
            f.write(t.numpy().tobytes())  # native order: little-endian on x86-64 and aarch64, as the format needs


def _variant_name(name: str, variant: Optional[str]) -> str:
    """`diffusion_pytorch_model.safetensors` -> `diffusion_pytorch_model.fp16.safetensors`
    for variant "fp16" (an index: `...model.fp16.safetensors.index.json`;
    transformers' `model.safetensors` -> `model.fp16.safetensors`)."""
    if not variant:
        return name
    stem, ext, rest = name.partition(".safetensors")
    return f"{stem}.{variant}{ext}{rest}"


def _resolve_weight_files(model_path: str, weights_name: str, index_name: str,
                          variant: Optional[str] = None) -> List[str]:
    """The safetensors files of a checkpoint directory: the shards its index
    names, else the single file (JAX `_resolve_weight_files`)."""
    index_path = os.path.join(model_path, _variant_name(index_name, variant))
    single_path = os.path.join(model_path, _variant_name(weights_name, variant))
    if os.path.isfile(index_path):
        with open(index_path) as f:
            index = json.load(f)
        return [os.path.join(model_path, s) for s in sorted(set(index["weight_map"].values()))]
    if os.path.isfile(single_path):
        return [single_path]
    raise EnvironmentError(f"No safetensors weights found under {model_path} (looked for {single_path} and "
                           f"{index_path})")


def read_safetensors_header(path: Union[str, os.PathLike]) -> Tuple[int, Dict[str, Any]]:
    """(offset of the data, header without `__metadata__`) of one safetensors file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return 8 + n, header


def iter_safetensors(path: Union[str, os.PathLike]) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, CPU tensor) for each tensor of one safetensors file, in file
    order. Each tensor is a view of a copy-on-write memory map of the file,
    which lives as long as a view of it does: the caller copies a tensor
    where it must live and drops the view, so the host holds about one
    tensor at a time."""
    start, header = read_safetensors_header(path)
    with open(path, "rb") as f:
        mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    for name, info in sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0]):
        if info["dtype"] not in _SAFETENSORS_TORCH_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}, which this reader does not know")
        dtype = _SAFETENSORS_TORCH_DTYPES[info["dtype"]]
        itemsize = torch.empty((), dtype=dtype).element_size()
        begin, end = info["data_offsets"]
        count = (end - begin) // itemsize
        if count != int(np.prod(info["shape"], dtype=np.int64)) or start + end > len(mapped):
            raise ValueError(f"{path}: tensor {name} has {end - begin} bytes at {begin}, not its shape "
                             f"{info['shape']}, or lies beyond the file")
        if count == 0:
            t = torch.empty(info["shape"], dtype=dtype)
        elif (start + begin) % itemsize:  # unaligned (files of other writers): copy the bytes
            t = torch.frombuffer(bytearray(mapped[start + begin:start + end]), dtype=dtype)
        else:
            t = torch.frombuffer(mapped, dtype=dtype, count=count, offset=start + begin)
        yield name, t.reshape(info["shape"])


class ModelMixin(nn.Module):
    """Base of every port model: an `nn.Module` with a `config.json` config."""

    config_name = CONFIG_NAME
    # the checkpoint layout: file names (a `variant` goes in before
    # `.safetensors`) and the shard size `save_pretrained` writes by default
    _weights_name = SAFETENSORS_WEIGHTS_NAME
    _weights_index_name = SAFETENSORS_INDEX_NAME
    _default_max_shard_size = "10GB"
    # checkpoint keys `from_pretrained` reads: those under these prefixes (None:
    # every key), less those ending in one of `_drop_key_suffixes`; every key
    # it reads must then match the state dict, in both directions
    _keep_key_prefixes: Optional[Tuple[str, ...]] = None
    _drop_key_suffixes: Tuple[str, ...] = ()
    # state-dict keys that upstream checkpoints hold but the model derives from
    # its config instead (SD3's sin-cos table): `from_pretrained` hands each to
    # `check_derived_tensor`, which raises unless it is what the config gives
    _derived_keys: Tuple[str, ...] = ()

    def check_derived_tensor(self, key: str, tensor: torch.Tensor) -> None:
        raise ValueError(f"{type(self).__name__} derives no checkpoint tensor ({key})")

    @classmethod
    def _reads_key(cls, key: str) -> bool:
        kept = cls._keep_key_prefixes is None or key.startswith(cls._keep_key_prefixes)
        return kept and not key.endswith(cls._drop_key_suffixes)

    @classmethod
    def _state_key(cls, key: str) -> str:
        """The state-dict name of a checkpoint key the class reads: the key
        itself, unless the class's checkpoints nest it under prefixes
        (the decoder-only text encoders)."""
        return key

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    def save_pretrained(self, save_directory: Union[str, os.PathLike], max_shard_size: Union[int, str, None] = None,
                        variant: Optional[str] = None):
        """Write `config.json` and the state dict as safetensors in the
        class's layout (`diffusion_pytorch_model.safetensors`; the text
        encoders `model.safetensors`); above `max_shard_size` (the class's
        default: 10 GB, the text encoders 5 GB, as transformers writes) it
        shards, in key order, into `<stem>-0000i-of-0000n.safetensors` plus
        `<stem>.safetensors.index.json`, as the JAX package does. `variant`
        ("fp16", say) goes into the file names:
        `diffusion_pytorch_model.fp16.safetensors`."""
        os.makedirs(save_directory, exist_ok=True)
        self.save_config(save_directory)
        state_dict = self.state_dict()
        max_bytes = _parse_size(self._default_max_shard_size if max_shard_size is None else max_shard_size)
        total = sum(_nbytes(t) for t in state_dict.values())
        weights_name = _variant_name(self._weights_name, variant)
        if total <= max_bytes:
            save_safetensors(state_dict, os.path.join(save_directory, weights_name))
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

        stem, ext = weights_name.rsplit(".", 1)
        weight_map = {}
        for i, shard in enumerate(shards, start=1):
            fname = f"{stem}-{i:05d}-of-{len(shards):05d}.{ext}"
            save_safetensors(shard, os.path.join(save_directory, fname))
            weight_map.update(dict.fromkeys(shard, fname))
        index = {"metadata": {"total_size": total}, "weight_map": weight_map}
        with open(os.path.join(save_directory, _variant_name(self._weights_index_name, variant)), "w") as f:
            json.dump(index, f, indent=2, sort_keys=True)

    @classmethod
    def from_pretrained(
        cls,
        pretrained_model_name_or_path: Union[str, os.PathLike],
        subfolder: Optional[str] = None,
        dtype: Optional[torch.dtype] = None,
        variant: Optional[str] = None,
        device: Union[str, torch.device] = "cuda",
        quantization_config=None,
        gguf_file: Optional[str] = None,
        mesh=None,
        **kwargs,
    ):
        """Build the model from `config.json` of a local directory (and its
        `subfolder`) and load its safetensors weights in the class's layout
        (sharded through the index, or one file; `variant` selects
        `<stem>.<variant>.safetensors`) onto `device`, floating tensors cast
        to `dtype` when it is given. `kwargs` override config values.

        The model is built on the meta device, and each tensor is copied to
        `device` before the next is read, so the host never holds more than
        about one tensor. The checkpoint keys the class reads (`_reads_key`:
        a text encoder skips a full checkpoint's decoder and its legacy
        aliases) must match the model's state dict exactly, in both
        directions, with their shapes, and no parameter or buffer may be
        left on the meta device. The one exception is a key of the model's
        `_derived_keys`: it may be present, and its tensor must pass
        `check_derived_tensor` (it is not kept). A parameter that its module
        lists in `reshape_on_load` may come in another shape of the same
        size (`WanRMSNorm.gamma`, which the JAX package writes flat).

        `quantization_config` (a config of `diffusers_tpu_torch.quantizers`,
        a dict or a method name) quantizes on load. The layers JAX's
        `quantize_params` would quantize under it
        (`quantizers.quantized_module_names`) become their quantized layers
        before any tensor is read (`W8A8Linear`, or `Int8PerTensorLinear`
        with ``impl="xla"``, and `Int8Conv2d` under `Int8DynamicActConfig`;
        `WeightOnlyLinear` int8 or fp8 under the weight-only configs;
        `Int4Linear` at the config's ``group_size``); a float weight is cast
        to `dtype` and quantized on `device` as it arrives
        (`quantizers.quantize_weight`), and a quantized weight with its
        `weight_scale` (the port's own save of a quantized model) loads as it
        is. `gguf_file` and `mesh` raise `NotImplementedError`. The default
        device is the card: without one this raises; pass ``device="cpu"``
        to load on the CPU."""
        for name, value, item in (("gguf_file", gguf_file, "GGUF checkpoints, ROADMAP A4.5"),
                                  ("mesh", mesh, "mesh placement, ROADMAP A8")):
            if value is not None:
                raise NotImplementedError(f"{cls.__name__}.from_pretrained: `{name}` ({item}) is not ported yet")
        quantization_config = resolve_quantization_config(quantization_config)
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{cls.__name__}.from_pretrained: no CUDA device is visible; pass device='cpu' to "
                               "load on the CPU")
        root = str(pretrained_model_name_or_path)
        model_path = os.path.join(root, subfolder) if subfolder else root
        if not os.path.isdir(model_path):
            raise EnvironmentError(f"{model_path} is not a local directory (loading from the hub is not ported)")

        with torch.device("meta"):
            model = cls.from_config(cls.load_config(model_path), **kwargs)
        quantized = []
        if quantization_config is not None:
            quantized = quantized_module_names(model, quantization_config)
            replace_with_quantized(model, quantized, quantization_config)
        expected = model.state_dict(keep_vars=True)
        files = _resolve_weight_files(model_path, cls._weights_name, cls._weights_index_name, variant)
        dtypes = [(cls._state_key(k), info["dtype"]) for f in files
                  for k, info in read_safetensors_header(f)[1].items() if cls._reads_key(k)]
        keys = dict(dtypes)
        # a quantized layer whose checkpoint weight is float (and has no scale) makes its scale on arrival
        on_arrival = {n for n in quantized if keys.get(f"{n}.weight") in ("F64", "F32", "F16", "BF16")
                      and f"{n}.weight_scale" not in keys}
        derived = keys.keys() & set(model._derived_keys)
        missing = sorted(expected.keys() - keys.keys() - {f"{n}.weight_scale" for n in on_arrival})
        unexpected = sorted(keys.keys() - expected.keys() - derived)
        if missing or unexpected or len(dtypes) != len(keys):
            raise ValueError(f"{cls.__name__}.from_pretrained({model_path}): the checkpoint does not match the "
                             f"model{' quantized by ' + type(quantization_config).__name__ if quantized else ''}: "
                             f"missing {missing[:5]} ({len(missing)}), unexpected {unexpected[:5]} "
                             f"({len(unexpected)}), {len(dtypes) - len(keys)} keys in more than one file")
        for f in files:
            for key, tensor in iter_safetensors(f):
                if not cls._reads_key(key):
                    continue
                key = cls._state_key(key)
                if key in derived:
                    model.check_derived_tensor(key, tensor)
                    continue
                target = expected[key]
                module_name, _, leaf = key.rpartition(".")
                module = model.get_submodule(module_name)
                target_shape = target.shape
                quantized_leaf = isinstance(module, QUANTIZED_LAYERS) and leaf in ("weight", "weight_scale")
                if isinstance(module, Int4Linear) and leaf == "weight" and module_name in on_arrival:
                    target_shape = (module.out_features, module.in_features)  # the float weight, packed below
                if (tensor.shape != target_shape and leaf in getattr(module, "reshape_on_load", ())
                        and tensor.numel() == target.numel()):
                    tensor = tensor.reshape(target_shape)  # e.g. WanRMSNorm.gamma as the JAX package writes it
                if tensor.shape != target_shape:
                    raise ValueError(f"{cls.__name__}.from_pretrained: {key} has shape {tuple(tensor.shape)} in "
                                     f"{f}, the model expects {tuple(target_shape)}")
                cast = dtype if dtype is not None and tensor.is_floating_point() else tensor.dtype
                if quantized_leaf and (leaf == "weight_scale" or module_name not in on_arrival):
                    cast = tensor.dtype  # a quantized weight and the f32 scales, whatever `dtype` is
                value = tensor.to(device=device, dtype=cast, copy=True)
                if quantized_leaf and leaf == "weight":
                    if module_name in on_arrival:
                        value, module._buffers["weight_scale"] = quantize_weight(module, value)
                    elif value.dtype != target.dtype:
                        raise ValueError(f"{cls.__name__}.from_pretrained: {key} is {value.dtype} beside a "
                                         f"weight_scale; {type(module).__name__} holds {target.dtype} weights")
                if leaf in module._parameters:
                    module._parameters[leaf] = nn.Parameter(value, requires_grad=target.requires_grad)
                else:
                    module._buffers[leaf] = value
        left = [n for n, t in (*model.named_parameters(), *model.named_buffers()) if t.is_meta]
        if left:
            raise ValueError(f"{cls.__name__}.from_pretrained: {len(left)} tensors were left on the meta device "
                             f"(not in the checkpoint's state dict), e.g. {left[:5]}")
        return model.eval()


def _leaf_to_torch(module: nn.Module, name: str, array: np.ndarray):
    """(state-dict name, array in torch layout) for one JAX parameter leaf."""
    if isinstance(module, (nn.Linear, W8A8Linear, WeightOnlyLinear)) and name == "kernel":  # [in, out] -> [out, in]
        return "weight", array.T
    if isinstance(module, (W8A8Linear, WeightOnlyLinear, Int8Conv2d)) and name.startswith("kernel_scale"):
        return "weight_scale", array
    if isinstance(module, Int8Conv2d) and name == "kernel":  # HWIO -> OIHW
        return "weight", array.transpose(3, 2, 0, 1)
    if isinstance(module, Int4Linear) and name in ("kernel", "kernel_scale_int4"):  # [.., out] -> [out, ..]
        return ("weight" if name == "kernel" else "weight_scale"), array.T
    if hasattr(module, "jax_leaf_to_torch"):  # a layer that keeps its own JAX layout (Animate's MotionConv2d)
        return module.jax_leaf_to_torch(name, array)
    if isinstance(module, nn.Conv1d) and name == "kernel":  # KIO -> OIK
        return "weight", array.transpose(2, 1, 0)
    if isinstance(module, nn.Conv2d) and name == "kernel":  # HWIO -> OIHW
        return "weight", array.transpose(3, 2, 0, 1)
    if isinstance(module, nn.Conv3d) and name == "kernel":  # DHWIO -> OIDHW
        return "weight", array.transpose(4, 3, 0, 1, 2)
    if isinstance(module, (nn.GroupNorm, nn.LayerNorm, RMSNorm)) and name == "scale":
        return "weight", array
    if isinstance(module, nn.Embedding) and name == "embedding":
        return "weight", array
    return name, array


def load_jax_params(module: nn.Module, tree: Dict[Any, Any]) -> nn.Module:
    """Load a JAX parameter pytree (nested dicts of numpy arrays, integer keys
    for module lists, as `jax.device_get(params)` returns) into `module`,
    walking it to learn each leaf's layer type. A Linear or Conv2d whose
    leaf carries one of JAX's scale keys becomes its quantized layer in place
    (``kernel_scale_w8a8``: `W8A8Linear` or `Int8Conv2d`; ``kernel_scale_i8x``:
    `Int8PerTensorLinear`; ``kernel_scale``: `WeightOnlyLinear` of the
    kernel's dtype; ``kernel_scale_int4``: `Int4Linear`), so one quantized
    JAX tree drives both packages. Strict: every key must match, in both
    directions. Returns the module."""
    state: Dict[str, torch.Tensor] = {}

    def quantized(child: nn.Module, leaf: Dict[Any, Any]) -> Optional[nn.Module]:
        if isinstance(child, nn.Conv2d) and "kernel_scale_w8a8" in leaf:
            return Int8Conv2d.like(child)
        if not isinstance(child, nn.Linear):
            return None
        use_bias = child.bias is not None
        args = (child.in_features, child.out_features)
        with torch.device(child.weight.device):
            if "kernel_scale_w8a8" in leaf:
                return W8A8Linear(*args, use_bias=use_bias)
            if "kernel_scale_i8x" in leaf:
                return Int8PerTensorLinear(*args, use_bias=use_bias)
            if "kernel_scale_int4" in leaf:
                return Int4Linear(*args, np.shape(leaf["kernel_scale_int4"])[0], use_bias=use_bias)
            if "kernel_scale" in leaf:
                fp8 = np.asarray(leaf["kernel"]).dtype.name == "float8_e4m3fn"
                return WeightOnlyLinear(*args, use_bias=use_bias,
                                        weight_dtype=torch.float8_e4m3fn if fp8 else torch.int8)
        return None

    def walk(mod: nn.Module, node: Dict[Any, Any], prefix: str):
        for k, v in node.items():
            if isinstance(v, dict):
                child = mod.get_submodule(str(k))
                swapped = quantized(child, v)
                if swapped is not None:
                    setattr(mod, str(k), swapped)
                    child = swapped
                walk(child, v, f"{prefix}{k}.")
                continue
            array = np.asarray(v)
            if array.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch.from_numpy
                array = array.astype(np.float32)
            name, array = _leaf_to_torch(mod, str(k), array)
            if array.dtype.name == "float8_e4m3fn":  # ml_dtypes fp8: its bytes, viewed as torch's
                tensor = torch.from_numpy(np.array(array).view(np.uint8)).view(torch.float8_e4m3fn)
            else:
                tensor = torch.from_numpy(np.array(array))  # a writable copy
            state[f"{prefix}{name}"] = tensor

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

"""Leaf layers as torch modules in torch layouts.

Port of `diffusers_tpu/ops/module.py` (`Linear` with its w8a8 branch
`:145-150`, its per-tensor int8 branch `:130-143`, its group-wise int4 branch
`:151-158` and its int8 / fp8 weight-only branch `:159-160`, `Conv2d` with its
int8 branch `:206-225`, `Conv3d` `:245`,
`Conv1d` `:296`, `GroupNorm` `:476-510`, `LayerNorm`,
`RMSNorm` `:542-567`, `Embedding`, `get_activation`). The JAX package keeps
parameters in an external pytree in TPU layouts (``kernel`` [in, out], HWIO,
``scale``); here they live on the modules under torch's names and layouts
(``weight`` [out, in], OIK, OIHW, OIDHW), so `state_dict()` keys equal
upstream diffusers' and the JAX package's torch-layout keys. Activations are
NCHW (NCL for 1-D, NCDHW for 3-D; JAX's `Conv1d` takes NLC).

The constructors keep the JAX signatures (``use_bias`` and friends), so model
code reads the same in both packages.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .cuda.w8a8_matmul import w8a8_matmul
from .cuda.group_norm import group_norm
from .int8 import gemm_operands, int8_conv2d, int8_linear_per_tensor


class _QuantizedLayer(nn.Module):
    """A layer whose ``weight`` keeps its quantized dtype and whose
    ``weight_scale`` stays float32 through a dtype cast of the module
    (``.to(torch.bfloat16)`` casts the bias alone; an fp8 weight is a
    floating-point tensor that torch would otherwise cast too)."""

    def _apply(self, fn, recurse=True):
        # detached aliases: torch may cast a parameter by swapping its `.data`
        kept = {name: getattr(self, name).detach() for name in ("weight", "weight_scale")}
        super()._apply(fn, recurse)
        for name, before in kept.items():
            after = getattr(self, name)
            if after.dtype != before.dtype:
                value = before.to(device=after.device)
                if name in self._parameters:
                    self._parameters[name] = nn.Parameter(value, requires_grad=False)
                else:
                    self._buffers[name] = value
        return self

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}, bias={self.bias is not None}"


class _GemmOperands:
    """Caches K5's padded operands (`ops.int8.gemm_operands`) of a layer's
    int8 weight, made again when the weight, its scales or the bias is
    replaced or changed in place (a load, a device move, a dtype cast)."""

    def _operands(self, groups: int = 1):
        tensors = (self.weight, self.weight_scale, self.bias)
        key = tuple((t.data_ptr(), t._version, t.device, t.dtype) if t is not None else None for t in tensors)
        cached = self.__dict__.get("_gemm_cache")
        if cached is None or cached[0] != key:
            cached = self.__dict__["_gemm_cache"] = (key, gemm_operands(self.weight, self.weight_scale, self.bias,
                                                                        groups))
        return cached[1]


class Linear(nn.Linear):
    """y = x @ weight.T + bias; weight [out, in]."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True):
        super().__init__(in_features, out_features, bias=use_bias)


class W8A8Linear(_QuantizedLayer):
    """The w8a8 branch of `Linear` (JAX params ``kernel`` int8 [in, out] +
    ``kernel_scale_w8a8``): an int8 ``weight`` [out, in] with a per-out-channel
    f32 ``weight_scale`` buffer, and x quantized per row at run time. CUDA
    tensors run kernel K5 (`ops/cuda/w8a8_matmul.py`); CPU tensors its plain
    version. A dtype cast of the module (``.to(torch.bfloat16)``) casts the
    bias and leaves the int8 weight and the f32 scale as they are."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.zeros(out_features, in_features, dtype=torch.int8), requires_grad=False)
        self.register_buffer("weight_scale", torch.ones(out_features, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return w8a8_matmul(x, self.weight, self.weight_scale, self.bias)


class Int8PerTensorLinear(_GemmOperands, W8A8Linear):
    """The per-tensor int8 branch of `Linear` (JAX params ``kernel`` int8
    [in, out] + ``kernel_scale_i8x``, `Int8DynamicActConfig(impl="xla")`):
    the state of a `W8A8Linear`, x quantized with one scale for the whole
    tensor at run time, and the product on K5's GEMM (`ops.int8`; CPU
    tensors its plain version). Any K and N: K5's operands are zero-padded
    to multiples of 128 once and cached."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and x.requires_grad:
            raise RuntimeError("Int8PerTensorLinear is inference-only (K5 has no gradient); call it under "
                               "torch.no_grad()")
        return int8_linear_per_tensor(x, self._operands(), self.out_features)


class WeightOnlyLinear(_QuantizedLayer):
    """The int8 / fp8 weight-only branch of `Linear` (JAX params ``kernel``
    int8 or float8_e4m3fn [in, out] + ``kernel_scale`` f32 [out]): ``weight``
    [out, in] in `weight_dtype` and ``weight_scale`` f32 [out]. Each call
    takes ``weight.to(x.dtype) * weight_scale.to(x.dtype)``, one matmul in
    x's dtype, then the bias in x's dtype, in JAX's order. JAX's branch is
    XLA's (no Pallas kernel), and so this one is plain torch on every
    device."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 weight_dtype: torch.dtype = torch.int8):
        super().__init__()
        if weight_dtype not in (torch.int8, torch.float8_e4m3fn):
            raise ValueError(f"WeightOnlyLinear takes int8 or float8_e4m3fn weights, not {weight_dtype}")
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.zeros(out_features, in_features, dtype=weight_dtype), requires_grad=False)
        self.register_buffer("weight_scale", torch.ones(out_features, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = self.weight.to(x.dtype) * self.weight_scale.to(x.dtype)[:, None]
        y = F.linear(x, weight)
        return y if self.bias is None else y + self.bias.to(x.dtype)

    def extra_repr(self) -> str:
        return super().extra_repr() + f", weight_dtype={self.weight.dtype}"


class Int4Linear(_QuantizedLayer):
    """The group-wise int4 weight-only branch of `Linear` (JAX params
    ``kernel`` nibble-packed int8 [ceil(in/2), out] + ``kernel_scale_int4``
    f32 [groups, out]): ``weight`` int8 [out, ceil(in/2)], two input columns
    a byte (column 2j in the low nibble, 2j + 1 in the high), and
    ``weight_scale`` f32 [out, groups], one scale per group of
    ``in / groups`` inputs. Each call unpacks and scales the weight in x's
    dtype (`quantizers.quantize.dequantize_int4`, JAX's op order) and takes
    one matmul; the dequantized weight lives only for that call. A dtype cast
    of the module casts the bias alone."""

    def __init__(self, in_features: int, out_features: int, groups: int = 1, use_bias: bool = True):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.zeros(out_features, (in_features + 1) // 2, dtype=torch.int8),
                                   requires_grad=False)
        self.register_buffer("weight_scale", torch.ones(out_features, groups, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..quantizers.quantize import dequantize_int4

        weight = dequantize_int4(self.weight, self.weight_scale, x.dtype, self.in_features)
        return F.linear(x, weight, None if self.bias is None else self.bias.to(x.dtype))

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"groups={self.weight_scale.shape[1]}, bias={self.bias is not None}")


class Conv2d(nn.Conv2d):
    """2D convolution over NCHW activations; weight OIHW."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Union[int, Tuple[int, int]] = 3,
        stride: Union[int, Tuple[int, int]] = 1,
        padding: Union[int, Tuple[int, int], str] = 0,
        dilation: Union[int, Tuple[int, int]] = 1,
        groups: int = 1,
        use_bias: bool = True,
    ):
        super().__init__(
            in_channels, out_channels, kernel_size, stride=stride, padding=padding,
            dilation=dilation, groups=groups, bias=use_bias,
        )


class Int8Conv2d(_GemmOperands, _QuantizedLayer):
    """The int8 branch of `Conv2d` (JAX params ``kernel`` int8 HWIO +
    ``kernel_scale_w8a8``, the convolutions `Int8DynamicActConfig` takes):
    ``weight`` int8 OIHW, ``weight_scale`` f32 [out] and the bias; x
    quantized with one scale for the whole tensor at run time, and the
    convolution an im2col GEMM on K5 (`ops.int8.int8_conv2d`; CPU tensors
    K5's plain version), one a group, its operands zero-padded to multiples
    of 128 once and cached."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Union[int, Tuple[int, int]] = 3,
                 stride: Union[int, Tuple[int, int]] = 1, padding: Union[int, Tuple[int, int]] = 0,
                 dilation: Union[int, Tuple[int, int]] = 1, groups: int = 1, use_bias: bool = True):
        super().__init__()
        if isinstance(padding, str):
            raise ValueError(f"Int8Conv2d takes int or pair padding, not {padding!r}")
        pair = lambda v: (v, v) if isinstance(v, int) else tuple(v)  # noqa: E731
        self.in_channels, self.out_channels, self.groups = in_channels, out_channels, groups
        self.kernel_size, self.stride, self.dilation = pair(kernel_size), pair(stride), pair(dilation)
        self.padding = pair(padding)
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels // groups, *self.kernel_size,
                                               dtype=torch.int8), requires_grad=False)
        self.register_buffer("weight_scale", torch.ones(out_channels, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None

    @classmethod
    def like(cls, conv: nn.Conv2d) -> "Int8Conv2d":
        """An empty int8 conv of `conv`'s geometry, on its device."""
        with torch.device(conv.weight.device):
            return cls(conv.in_channels, conv.out_channels, conv.kernel_size, conv.stride, conv.padding,
                       conv.dilation, conv.groups, use_bias=conv.bias is not None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and x.requires_grad:
            raise RuntimeError("Int8Conv2d is inference-only (K5 has no gradient); call it under torch.no_grad()")
        return int8_conv2d(x, self._operands(self.groups), self.out_channels, self.kernel_size, self.stride,
                           self.padding, self.dilation, self.groups)

    def extra_repr(self) -> str:
        return (f"{self.in_channels}, {self.out_channels}, kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}, dilation={self.dilation}, groups={self.groups}, "
                f"bias={self.bias is not None}")


class Conv1d(nn.Conv1d):
    """1D convolution over NCL activations; weight OIK (JAX keeps KIO)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: int = 0,
        dilation: int = 1,
        groups: int = 1,
        use_bias: bool = True,
    ):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding,
                         dilation=dilation, groups=groups, bias=use_bias)


class Conv3d(nn.Conv3d):
    """3D convolution over NCDHW activations; weight OIDHW. Convolutions run
    outside any Pallas kernel in JAX too (cuDNN here)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Union[int, Tuple[int, int, int]] = 3,
        stride: Union[int, Tuple[int, int, int]] = 1,
        padding: Union[int, Tuple[int, int, int], str] = 0,
        dilation: Union[int, Tuple[int, int, int]] = 1,
        use_bias: bool = True,
    ):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding,
                         dilation=dilation, bias=use_bias)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over the channel axis (dim 1) of ``[B, C, *spatial]``
    activations, statistics in f32. CUDA tensors run kernel K4
    (`ops/cuda/group_norm.py`, source `csrc/group_norm.cu`); CPU tensors its
    plain version."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5, affine: bool = True):
        super().__init__(num_groups, num_channels, eps=eps, affine=affine)

    def forward(self, x: torch.Tensor, apply_silu: bool = False) -> torch.Tensor:
        return group_norm(x.contiguous(), self.weight, self.bias, self.num_groups, self.eps, apply_silu)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis (torch accumulates half types in f32)."""

    def __init__(self, dim: int, eps: float = 1e-5, use_scale: bool = True, use_bias: bool = True):
        if use_bias and not use_scale:
            raise ValueError("LayerNorm with a bias but no scale has no torch counterpart")
        super().__init__(dim, eps=eps, elementwise_affine=use_scale, bias=use_bias)


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * weight (+ bias) over the last axis, in f32,
    cast back to x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, use_scale: bool = True, use_bias: bool = False):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(dim)) if use_bias else None

    def reset_parameters(self) -> None:
        if self.weight is not None:
            nn.init.ones_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        if self.weight is not None:
            xf = xf * self.weight.float()
        if self.bias is not None:
            xf = xf + self.bias.float()
        return xf.to(x.dtype)


class Embedding(nn.Embedding):
    def __init__(self, num_embeddings: int, features: int):
        super().__init__(num_embeddings, features)


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


ACT2FN: Dict[str, Callable] = {
    "swish": F.silu,
    "silu": F.silu,
    "mish": F.mish,
    "gelu": F.gelu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "relu6": F.relu6,
    "quick_gelu": _quick_gelu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "linear": lambda x: x,
}


def get_activation(name: str) -> Callable:
    name = name.lower()
    if name not in ACT2FN:
        raise ValueError(f"activation {name} not supported; choose from {list(ACT2FN)}")
    return ACT2FN[name]

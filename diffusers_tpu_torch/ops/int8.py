"""The per-tensor int8 routes: a Linear and a 2-D convolution whose int8 x
int8 -> int32 product runs on kernel K5's GEMM.

Port of the two int8 branches of `diffusers_tpu/ops/module.py` that XLA
compiles on the TPU (no Pallas kernel there): `Linear.__call__` with
``kernel_scale_i8x`` (`:130-143`, `Int8DynamicActConfig(impl="xla")`) and
`Conv2d.__call__` with ``kernel_scale_w8a8`` (`:206-225`, the convolutions
`Int8DynamicActConfig` takes where `_conv_int8_eligible` holds). Both take one
scale for the whole activation, ``s = max(max|x|, 1e-8) / 127`` in f32, round
and clip ``x / s`` to int8, sum the int8 products exactly in int32, then
apply the epilogue ``acc * (s * w_scale)`` in f32, cast to x's dtype, and add
the bias in that dtype.

The quantization is elementwise work that XLA fuses in JAX; here it is plain
torch ops. The product runs on K5 (`w8a8_matmul_2d`) with every row scale 1
and the column scales ``s * w_scale``: multiplying by 1.0 is exact, so K5's
epilogue ``(acc * 1) * (s * w_scale)`` is JAX's association bit for bit. The
convolution becomes a GEMM over an im2col of the int8 activation
(`Tensor.unfold`, C-major columns to match the OIHW weight). K5 takes K and
N in multiples of 128, and JAX's int8 dot and conv take any shape, so K and
N are zero-padded: the weight once (`gemm_operands`, cached by the layers),
each im2col written into a buffer of the padded width, and the output's
padded columns sliced off. Zero columns add nothing to the int32 sum, so the
result is the unpadded sum exactly. Groups > 1 take one GEMM a group. CPU
tensors reach K5's plain version through the same wrapper; a CUDA tensor
launches K5 or raises, with no dequantized fallback (JAX has none).

`int8_linear_per_tensor_plain` and `int8_conv2d_plain` are the routes'
oracles: the same function without padding or im2col (the int8 product
summed exactly in float64, a `F.conv2d` for the convolution).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from .cuda.w8a8_matmul import ALIGN, w8a8_matmul_2d, w8a8_matmul_2d_plain

_ONES = {}  # device -> a float32 ones vector, grown as needed (K5's row scales)


def _ones(m: int, device: torch.device) -> torch.Tensor:
    buf = _ONES.get(device)
    if buf is None or buf.numel() < m:
        buf = _ONES[device] = torch.ones(max(m, 4096), dtype=torch.float32, device=device)
    return buf[:m]


def _round_up(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def quantize_tensor(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: (int8 of x's shape, the f32
    0-d scale ``max(max|x|, 1e-8) / 127``); ``x / s`` rounded half to even
    and clipped to +-127, in f32 (JAX's `Linear` / `Conv2d` int8 branches)."""
    absmax = x.abs().amax().float()
    scale = absmax.clamp_min(1e-8) / absmax.new_full((), 127.0)  # a true division on every device
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8), scale


def gemm_operands(weight: torch.Tensor, weight_scale: torch.Tensor, bias: Optional[torch.Tensor], groups: int = 1):
    """K5's operands of an int8 weight [N, ...] (a Linear's [N, K] or a
    conv's OIHW): per group, the weight as [Np, Kp] int8 (K = the product of
    the non-output dims, both padded with zeros to multiples of 128), its
    scales [Np] f32 and its bias [Np] (zeros in the padding; None without a
    bias). Returns a list of (qw, w_scale, bias), one a group; an aligned
    weight is returned as a view, without a copy."""
    n_total = weight.shape[0]
    og = n_total // groups
    k = weight[0].numel()
    kp, np_ = _round_up(k), _round_up(og)
    out = []
    for g in range(groups):
        qw = weight[g * og:(g + 1) * og].reshape(og, k)
        ws = weight_scale[g * og:(g + 1) * og]
        b = bias[g * og:(g + 1) * og] if bias is not None else None
        if (kp, np_) != (k, og):
            qw = F.pad(qw, (0, kp - k, 0, np_ - og))
            ws = F.pad(ws, (0, np_ - og))
            b = F.pad(b, (0, np_ - og)) if b is not None else None
        out.append((qw.contiguous(), ws, b))
    return out


def _gemm(qx: torch.Tensor, operands, scale: torch.Tensor, n: int, out_dtype: torch.dtype,
          skip_k_tile: int = -1) -> torch.Tensor:
    """One K5 GEMM of an int8 [M, Kp] by one group's operands at per-tensor
    scale `scale`: [M, n] in `out_dtype`."""
    qw, ws, bias = operands
    y = w8a8_matmul_2d(qx, qw, _ones(qx.shape[0], qx.device), scale * ws, out_dtype, bias, _skip_k_tile=skip_k_tile)
    return y if y.shape[1] == n else y[:, :n]


def int8_linear_per_tensor(x: torch.Tensor, operands, n: int, _skip_k_tile: int = -1) -> torch.Tensor:
    """The per-tensor int8 Linear: x [..., K] float and `gemm_operands` of
    the int8 weight [N, K] -> [..., N] in x's dtype. `_skip_k_tile` is K5's
    deliberately wrong control (`w8a8_matmul_2d`)."""
    (ops,) = operands
    *lead, k = x.shape
    qx, s = quantize_tensor(x.reshape(-1, k))
    kp = ops[0].shape[1]
    if kp != k:
        qx = F.pad(qx, (0, kp - k))
    return _gemm(qx, ops, s, n, x.dtype, _skip_k_tile).reshape(*lead, n)


def int8_linear_per_tensor_plain(x: torch.Tensor, weight: torch.Tensor, weight_scale: torch.Tensor,
                                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The oracle of `int8_linear_per_tensor`: JAX's branch with the int8
    product summed exactly in float64, unpadded."""
    *lead, k = x.shape
    qx, s = quantize_tensor(x.reshape(-1, k))
    y = w8a8_matmul_2d_plain(qx, weight, _ones(qx.shape[0], qx.device), s * weight_scale, x.dtype, bias)
    return y.reshape(*lead, weight.shape[0])


Pair = Union[int, Sequence[int]]


def _pair(v: Pair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def conv_padding(padding: Pair) -> Tuple[int, int, int, int]:
    """(left, right, top, bottom) zero padding of a conv's int or pair `padding`."""
    ph, pw = _pair(padding)
    return pw, pw, ph, ph


def _im2col(qx: torch.Tensor, kernel_size, stride, pads, dilation, kp: int) -> Tuple[torch.Tensor, int, int]:
    """int8 NCHW -> ([B * Ho * Wo, kp] int8 columns, Ho, Wo): each row the
    receptive field of one output pixel, C-major then kh, kw (the OIHW
    weight's flattening), zero-padded to `kp` columns."""
    b, c, _, _ = qx.shape
    kh, kw = kernel_size
    if any(pads):
        qx = F.pad(qx, pads)
    eh, ew = dilation[0] * (kh - 1) + 1, dilation[1] * (kw - 1) + 1
    patches = qx.unfold(2, eh, stride[0]).unfold(3, ew, stride[1])  # [B, C, Ho, Wo, eh, ew], a view
    if dilation != (1, 1):
        patches = patches[..., ::dilation[0], ::dilation[1]]
    ho, wo = patches.shape[2], patches.shape[3]
    k = c * kh * kw
    cols = torch.empty((b, ho, wo, kp), dtype=torch.int8, device=qx.device)
    cols[..., :k].unflatten(-1, (c, kh, kw)).copy_(patches.permute(0, 2, 3, 1, 4, 5))
    if kp != k:
        cols[..., k:].zero_()
    return cols.reshape(b * ho * wo, kp), ho, wo


def int8_conv2d(x: torch.Tensor, operands, out_channels: int, kernel_size: Tuple[int, int],
                stride: Tuple[int, int], padding, dilation: Tuple[int, int], groups: int = 1,
                _skip_k_tile: int = -1) -> torch.Tensor:
    """The int8 convolution: x NCHW float and `gemm_operands` of the int8
    OIHW weight (one entry a group) -> NCHW in x's dtype. `_skip_k_tile` is
    K5's deliberately wrong control (`w8a8_matmul_2d`)."""
    b, c = x.shape[:2]
    qx, s = quantize_tensor(x)
    pads = conv_padding(padding)
    cg, og = c // groups, out_channels // groups
    outs = []
    for g, ops in enumerate(operands):
        xg = qx if groups == 1 else qx[:, g * cg:(g + 1) * cg]
        cols, ho, wo = _im2col(xg, kernel_size, stride, pads, dilation, ops[0].shape[1])
        outs.append(_gemm(cols, ops, s, og, x.dtype, _skip_k_tile).reshape(b, ho, wo, og))
    y = outs[0] if groups == 1 else torch.cat(outs, dim=-1)
    return y.permute(0, 3, 1, 2).contiguous()


def int8_conv2d_plain(x: torch.Tensor, weight: torch.Tensor, weight_scale: torch.Tensor,
                      bias: Optional[torch.Tensor], stride, padding, dilation, groups: int = 1) -> torch.Tensor:
    """The oracle of `int8_conv2d`: JAX's branch with the int8 convolution
    summed exactly in float64 by `F.conv2d` (|sum| <= 127^2 K < 2^53)."""
    qx, s = quantize_tensor(x)
    acc = F.conv2d(qx.double(), weight.double(), None, stride, padding, dilation, groups).float()
    y = (acc * (s * weight_scale)[None, :, None, None]).to(x.dtype)
    return y if bias is None else y + bias.to(x.dtype)[None, :, None, None]

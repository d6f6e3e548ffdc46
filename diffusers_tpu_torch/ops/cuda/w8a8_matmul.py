"""w8a8 matmul: CUDA kernel K5 and the row quantization that feeds it, their
plain versions, and the wrappers that pick between them by device.

Port of `diffusers_tpu/ops/pallas/quantized_matmul.py` (`quantize_rows` `:31`,
`_w8a8_kernel` / `_w8a8_matmul_2d` `:38,85`, `w8a8_matmul` `:127`). The kernel
source, with its design note (what bounds it on an H100 and what the design
does about it), is `diffusers_tpu_torch/csrc/w8a8_matmul.cu`; it builds and
binds as K1 does (`_build.py`).

Layout: the int8 weight is torch's ``[N, K]`` (``[out, in]``) with a
per-out-channel f32 scale; the JAX package holds ``[K, N]``. The function is
JAX's: dynamic symmetric per-row int8 quantization of x, an exact int32 sum,
the f32 epilogue ``acc * x_scale[m] * w_scale[n]`` cast to x's dtype, then
the bias added in that dtype. Where K or N is not a multiple of 128, JAX's
rule is a dequantized matmul (`quantized_matmul.py:144-146`), and so it is
here, on every device: that is the function's definition. None of JAX's
block picking, padding of M to 32 or v5e shape gate carries over.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build

SOURCE = _build.CSRC / "w8a8_matmul.cu"
DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
ALIGN = 128  # K and N multiples of this take the int8 path
# K5's tile shapes (BM, BN) and the rate, relative to the larger, at which an
# SM works through output elements of each (the smaller tile reloads more
# operand bytes per operation; rates measured on an H100 at Flux's K = 12288
# and 15360 shapes, PERF.md); `pick_tile` weighs the busiest SM's work by it
TILES = {(128, 256): 1.0, (128, 128): 0.8}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (first use, or after the source changed) and load the kernels'
    shared library. A compile error raises with nvcc's output."""
    lib = _build.load(SOURCE)
    lib.w8a8_quantize_rows.argtypes = (
        [ctypes.c_void_p] * 3  # x, qx, x_scale
        + [ctypes.c_int] * 3  # M, K, dtype
        + [ctypes.c_void_p]  # stream
    )
    lib.w8a8_quantize_rows.restype = ctypes.c_int
    lib.w8a8_matmul.argtypes = (
        [ctypes.c_void_p] * 6  # qx, qw, x_scale, w_scale, bias, out
        + [ctypes.c_int] * 6  # M, N, K, dtype, block_n, skip_k_tile
        + [ctypes.c_void_p]  # stream
    )
    lib.w8a8_matmul.restype = ctypes.c_int
    lib.w8a8_matmul_smem_bytes.argtypes = [ctypes.c_int]  # block_n
    lib.w8a8_matmul_smem_bytes.restype = ctypes.c_int
    return lib


def _check_card(fn: str, tensors, what: str) -> None:
    dev = tensors[0].device
    ok = all(t.is_cuda and t.device == dev and t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors)
    if not ok or not _build.is_hopper(dev.index):
        raise ValueError(
            f"{fn}: the sm_90a kernel takes {what}, contiguous, 16-byte aligned, on one Hopper CUDA device; got "
            + ", ".join(f"{tuple(t.shape)} {t.dtype} on {t.device}" for t in tensors)
        )


# ------------------------------------------------------------ quantize_rows


def quantize_rows_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization over the last axis: x ~ qx * scale,
    scale [..., 1] f32 (`quantize_rows`: f32 absmax, ``max(absmax, 1e-8) /
    127``, round half to even, clip to +-127)."""
    absmax = x.abs().float().amax(dim=-1, keepdim=True)
    # a true division on every device: PyTorch's CUDA division by a Python
    # scalar multiplies by its rounded reciprocal instead
    scale = absmax.clamp_min(1e-8) / absmax.new_full((), 127.0)
    qx = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return qx, scale


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`quantize_rows_plain` for a CPU tensor; for a CUDA tensor the row kernel
    of `csrc/w8a8_matmul.cu`, equal to it bit for bit (bf16/fp16/f32 x with a
    last axis that is a multiple of 128), or a ValueError."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x)
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    if x.dtype not in DTYPES or k % ALIGN or x2.shape[0] == 0:
        raise ValueError(f"quantize_rows: the sm_90a kernel takes bf16/fp16/f32 rows of a multiple of {ALIGN} "
                         f"elements; got {tuple(x.shape)} {x.dtype}")
    _check_card("quantize_rows", [x2], "x [M, K]")
    qx = torch.empty(x2.shape, device=x.device, dtype=torch.int8)
    scale = torch.empty((x2.shape[0], 1), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = load_library().w8a8_quantize_rows(
            x2.data_ptr(), qx.data_ptr(), scale.data_ptr(), x2.shape[0], k, DTYPES[x.dtype],
            _build.stream_of(x.device),
        )
    if err != 0:
        raise RuntimeError(f"w8a8_quantize_rows launch failed with cudaError_t {err}")
    quantize_rows.launches += 1
    return qx.reshape(x.shape), scale.reshape(*x.shape[:-1], 1)


quantize_rows.launches = 0


# --------------------------------------------------------------- the matmul


def w8a8_matmul_2d_plain(
    qx: torch.Tensor,  # [M, K] int8
    qw: torch.Tensor,  # [N, K] int8
    x_scale: torch.Tensor,  # [M, 1] f32
    w_scale: torch.Tensor,  # [N] f32
    out_dtype: torch.dtype,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the kernel: the int8 product summed exactly in f64
    (|sum| <= 127^2 K < 2^53), one rounding to f32, JAX's epilogue ``acc *
    x_scale * w_scale`` in f32, the cast, then the bias in the output dtype."""
    acc = (qx.double() @ qw.double().T).float()
    y = (acc * x_scale.reshape(-1, 1).float() * w_scale.float()[None, :]).to(out_dtype)
    return y if bias is None else y + bias.to(out_dtype)


def pick_tile(m: int, n: int, sms: int) -> Tuple[int, int]:
    """K5's output tile (BM, BN) for an [m, n] output (n a multiple of 128)
    on a card with `sms` streaming multiprocessors (K5's persistent grid has
    one block per SM). M <= 64 is bound by the weight's bytes: the narrower
    tile puts the most SMs on streaming it. Otherwise the tile whose busiest
    SM has the least work, ``ceil(tiles / sms) * BM * BN / rate``; ties go to
    the larger tile."""
    if m <= 64:
        return 128, 128
    best, best_cost = None, None
    for (bm, bn), rate in TILES.items():
        if n % bn:
            continue
        tiles = -(-m // bm) * (n // bn)
        cost = -(-tiles // sms) * bm * bn / rate
        if best_cost is None or cost < best_cost:
            best, best_cost = (bm, bn), cost
    return best


def w8a8_matmul_2d(
    qx: torch.Tensor,
    qw: torch.Tensor,
    x_scale: torch.Tensor,
    w_scale: torch.Tensor,
    out_dtype: torch.dtype,
    bias: Optional[torch.Tensor] = None,
    _skip_k_tile: int = -1,
) -> torch.Tensor:
    """The int8 x int8 -> int32 matmul with the f32 epilogue (and the bias)
    fused. CPU tensors take `w8a8_matmul_2d_plain`; CUDA tensors launch K5
    with the tile `pick_tile` chooses, or raise on what it does not take.
    `_skip_k_tile` leaves one 64-wide K slice out of the sum: a deliberately
    wrong result for `chip_smoke.py`'s control."""
    if qx.device.type == "cpu":
        return w8a8_matmul_2d_plain(qx, qw, x_scale, w_scale, out_dtype, bias)
    m, k = qx.shape
    n = qw.shape[0]
    if (qx.dtype != torch.int8 or qw.dtype != torch.int8 or qw.shape != (n, k) or k % ALIGN or n % ALIGN or m == 0
            or x_scale.dtype != torch.float32 or x_scale.numel() != m or w_scale.dtype != torch.float32
            or w_scale.numel() != n or out_dtype not in DTYPES):
        raise ValueError(
            f"w8a8_matmul_2d: the sm_90a kernel takes int8 qx [M, K], int8 qw [N, K] with K, N multiples of {ALIGN}, "
            f"f32 scales [M] and [N] and a bf16/fp16/f32 output; got qx {tuple(qx.shape)} {qx.dtype}, qw "
            f"{tuple(qw.shape)} {qw.dtype}, scales {x_scale.dtype} {w_scale.dtype}, out {out_dtype}"
        )
    if bias is not None:
        bias = bias.to(out_dtype).contiguous()
    _check_card("w8a8_matmul_2d", [qx, qw, x_scale, w_scale] + ([bias] if bias is not None else []),
                "qx, qw, scales and bias")
    _, bn = pick_tile(m, n, _build.sm_count(qx.device.index))
    out = torch.empty((m, n), device=qx.device, dtype=out_dtype)
    with torch.cuda.device(qx.device):
        err = load_library().w8a8_matmul(
            qx.data_ptr(), qw.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            m, n, k, DTYPES[out_dtype], bn, int(_skip_k_tile), _build.stream_of(qx.device),
        )
    if err != 0:
        raise RuntimeError(f"w8a8_matmul launch failed with cudaError_t {err}")
    w8a8_matmul_2d.launches += 1
    return out


w8a8_matmul_2d.launches = 0


def w8a8_matmul(
    x: torch.Tensor,  # [..., K] float
    qw: torch.Tensor,  # [N, K] int8
    w_scale: torch.Tensor,  # [N] f32
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dynamic-activation int8 matmul: ``y = dequant(quant(x) @ qw.T) + bias``
    in x's dtype. K or N not a multiple of 128: ``x @ (qw * w_scale).T +
    bias`` in x's dtype (JAX's rule for shapes that do not tile).

    The int8 path has no gradient, as JAX's Pallas call has no VJP: with grad
    mode on and x or the bias requiring grad it raises, on every device, rather
    than return an output cut off from autograd. Run it under
    `torch.no_grad()`."""
    *lead, k = x.shape
    n = qw.shape[0]
    if k % ALIGN or n % ALIGN:
        y = x @ (qw.to(x.dtype) * w_scale.to(x.dtype)[:, None]).T
        return y if bias is None else y + bias.to(y.dtype)
    if torch.is_grad_enabled() and (x.requires_grad or (bias is not None and bias.requires_grad)):
        raise RuntimeError(
            "w8a8_matmul: the int8 path (K5) is inference-only and has no gradient; call it under "
            "torch.no_grad() or with inputs that do not require grad"
        )
    qx, x_scale = quantize_rows(x.reshape(-1, k).contiguous())
    y = w8a8_matmul_2d(qx, qw, x_scale, w_scale, x.dtype, bias)
    return y.reshape(*lead, n)

"""Flash-attention forward: CUDA kernel K1, its plain version, and the wrapper
that picks between them by device.

Port of the forward half of `diffusers_tpu/ops/pallas/flash_attention_bwd.py`
(`flash_attention_full`, `_flash_fwd_bhsd`, `_fwd_kernel`). The kernel source,
with its design note (what bounds it on an H100 and what the design does about
it), is `diffusers_tpu_torch/csrc/flash_attention_fwd.cu`.

Build and binding (`_build.py`): `nvcc -gencode arch=compute_90a,code=sm_90a`
compiles the source into a shared library with a plain C interface under the
repository's `build/` directory on first use, keyed by a hash of the source
and flags; `ctypes` loads it with `argtypes` declared for every argument. The kernel
launches on PyTorch's current stream and allocates nothing; the wrapper
allocates the outputs and raises on a non-zero `cudaError_t`.

Tensor convention: q/k/v are [batch, seq, heads, head_dim] (BSHD), as in the
JAX package. The kernel reads BSHD through strides; none of the JAX wrapper's
TPU-only constraints (`_fit_block`, the `% 128` lengths of `_supported`,
lane-replicated LSE, `FLASH_SOFTMAX_BF16`) carry over.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30  # the JAX kernel's masked logit: finite, so no inf - inf
HEAD_DIMS = (64, 128)
DTYPES = {torch.bfloat16: 0, torch.float16: 1}

SOURCE = _build.CSRC / "flash_attention_fwd.cu"


def flash_attention_plain(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    attn_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    is_causal: bool = False,
    return_lse: bool = False,
):
    """Plain PyTorch version of the kernel: f32 logits, additive mask (a bool
    mask becomes 0 / NEG_INF), top-left-aligned causal mask (``row >= col``,
    as `_fwd_kernel`), f32 softmax, output in the input dtype; optional f32
    LSE ``[B, H, Sq]``."""
    b, sq, h, d = query.shape
    sk = key.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", query.float(), key.float()) * scale
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            attn_mask = torch.where(attn_mask, 0.0, NEG_INF)
        s = s + attn_mask.float()
    if is_causal:
        row = torch.arange(sq, device=query.device)[:, None]
        col = torch.arange(sk, device=query.device)[None, :]
        s = torch.where(row >= col, s, NEG_INF)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), value.float()).to(query.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (first use, or after the source changed) and load the kernel's
    shared library. A compile error raises with nvcc's output."""
    lib = _build.load(SOURCE)
    fn = lib.flash_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 6  # q, k, v, mask, out, lse
        + [ctypes.c_int] * 6  # batch, heads, seq_q, seq_k, head_dim, dtype
        + [ctypes.c_longlong] * 16  # q/k/v/out (b, s, h) strides, mask (b, h, q, k) strides
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # scale, causal, stream
    )
    fn.restype = ctypes.c_int
    return lib


def kernel_supports(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor) -> bool:
    """Whether the CUDA kernel takes these q/k/v (device, dtype, head_dim,
    layout). `flash_attention_full` raises on CUDA tensors it does not take."""
    if not (query.is_cuda and key.is_cuda and value.is_cuda):
        return False
    if query.dtype not in DTYPES or key.dtype != query.dtype or value.dtype != query.dtype:
        return False
    if query.ndim != 4 or key.shape != value.shape or query.shape[-1] not in HEAD_DIMS:
        return False
    if query.shape[0] != key.shape[0] or query.shape[2:] != key.shape[2:]:
        return False
    if query.shape[0] > 65535 or query.shape[2] > 65535 or query.shape[1] == 0 or key.shape[1] == 0:
        return False
    if torch.cuda.get_device_capability(query.device) != (9, 0):
        return False
    for t in (query, key, value):
        # 16-byte vector loads of head_dim rows
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            return False
    return True


def flash_attention_full(
    query: torch.Tensor,  # [B, Sq, H, D]
    key: torch.Tensor,  # [B, Sk, H, D]
    value: torch.Tensor,
    attn_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    is_causal: bool = False,
    return_lse: bool = False,
):
    """Flash-attention forward (BSHD). A CPU tensor takes
    `flash_attention_plain`; a CUDA tensor launches the kernel, or raises on
    what the kernel does not take (see `kernel_supports`).

    `attn_mask`: additive float bias or bool keep-mask, broadcastable to
    ``[B, H, Sq, Sk]``. Returns the output, and the f32 LSE ``[B, H, Sq]``
    when `return_lse`."""
    if query.device.type == "cpu":
        return flash_attention_plain(query, key, value, attn_mask, scale, is_causal, return_lse)
    if not kernel_supports(query, key, value):
        raise ValueError(
            f"flash_attention_full: the sm_90a kernel takes bf16/fp16 CUDA q/k/v [B,S,H,D] with head_dim in "
            f"{HEAD_DIMS}, unit head_dim stride and 16-byte-aligned rows; got q {tuple(query.shape)} "
            f"{query.dtype} on {query.device}, k {tuple(key.shape)}, v {tuple(value.shape)}"
        )
    b, sq, h, d = query.shape
    sk = key.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    mask_ptr, mask_strides = None, (0, 0, 0, 0)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            attn_mask = torch.where(attn_mask, 0.0, NEG_INF)
        attn_mask = attn_mask.to(device=query.device, dtype=torch.float32).expand(b, h, sq, sk)
        mask_ptr, mask_strides = attn_mask.data_ptr(), attn_mask.stride()
    out = torch.empty_like(query, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, sq), device=query.device, dtype=torch.float32) if return_lse else None

    fn = load_library().flash_attention_fwd
    with torch.cuda.device(query.device):
        err = fn(
            query.data_ptr(), key.data_ptr(), value.data_ptr(), mask_ptr, out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            b, h, sq, sk, d, DTYPES[query.dtype],
            *query.stride()[:3], *key.stride()[:3], *value.stride()[:3], *out.stride()[:3],
            *mask_strides,
            float(scale), int(bool(is_causal)), torch.cuda.current_stream(query.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed with cudaError_t {err}")
    flash_attention_full.launches += 1
    return (out, lse) if return_lse else out


flash_attention_full.launches = 0


def flash_attention(
    query: torch.Tensor,  # [B, Sq, H, D]
    key: torch.Tensor,  # [B, Sk, H, D]
    value: torch.Tensor,
    scale: Optional[float] = None,
    is_causal: bool = False,
) -> torch.Tensor:
    """Forward-only flash attention (BSHD), the counterpart of
    `diffusers_tpu/ops/pallas/flash_attention.py:125` (TPU kernel
    `_flash_kernel`, K6). K1's kernel computes the same function, so a CUDA
    tensor launches it (counted in `flash_attention_full.launches`) and a CPU
    tensor takes its plain version. Causal is top-left aligned (``row >=
    col``), as `_flash_kernel`; JAX sends the lengths its kernel does not
    tile to its native backend, whose causal mask is bottom-right aligned, so
    the two differ for causal with Sq != Sk."""
    return flash_attention_full(query, key, value, scale=scale, is_causal=is_causal)

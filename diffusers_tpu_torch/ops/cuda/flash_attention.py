"""Flash attention: CUDA kernels K1 (forward), K2 (dK/dV) and K3 (dQ), their
plain versions, the autograd Function that joins them, and the wrapper that
picks between them by device.

Port of `diffusers_tpu/ops/pallas/flash_attention_bwd.py`: the forward
(`flash_attention_full`, `_flash_fwd_bhsd`, `_fwd_kernel`), the backward
(`_flash_bwd_bhsd`, `_bwd_dkdv_kernel`, `_bwd_dq_kernel`) and the custom VJP
that joins them (`flash_attention_vjp`, `_vjp_fwd`, `_vjp_bwd`, `:354-401`),
which becomes `FlashAttentionFunction`. The kernel sources, with their design
notes (what bounds them on an H100 and what the design does about it), are
`diffusers_tpu_torch/csrc/flash_attention_fwd.cu` and
`diffusers_tpu_torch/csrc/flash_attention_bwd.cu`.

Build and binding (`_build.py`): `nvcc -gencode arch=compute_90a,code=sm_90a`
compiles each source into a shared library with a plain C interface under the
repository's `build/` directory on first use, keyed by a hash of the source
and flags; `ctypes` loads it with `argtypes` declared for every argument. The
kernels launch on PyTorch's current stream and allocate nothing; the wrappers
allocate the outputs and raise on a non-zero `cudaError_t`.

Tensor convention: q/k/v are [batch, seq, heads, head_dim] (BSHD), as in the
JAX package. The kernels read and write BSHD through strides; none of the JAX
wrapper's TPU-only constraints (`_fit_block`, the `% 128` lengths of
`_supported`, lane-replicated LSE and delta, `FLASH_SOFTMAX_BF16`) carry over.
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
BWD_SOURCE = _build.CSRC / "flash_attention_bwd.cu"
BWD_KV_TILE = 128  # keys per K2 work item
BWD_SPLIT_BLOCK = 128  # K2's query splits are ranges of blocks of this many queries


def _additive_mask(attn_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A bool keep-mask becomes 0 / NEG_INF; a float mask becomes f32."""
    if attn_mask is None:
        return None
    if attn_mask.dtype == torch.bool:
        attn_mask = torch.where(attn_mask, 0.0, NEG_INF)
    return attn_mask.float()


def _logits(query, key, attn_mask, scale, is_causal):
    """f32 logits ``scale q k^T + mask`` [B, H, Sq, Sk], top-left causal."""
    sq, sk = query.shape[1], key.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", query.float(), key.float()) * scale
    if attn_mask is not None:
        s = s + _additive_mask(attn_mask)
    if is_causal:
        row = torch.arange(sq, device=query.device)[:, None]
        col = torch.arange(sk, device=query.device)[None, :]
        s = torch.where(row >= col, s, NEG_INF)
    return s


def flash_attention_plain(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    attn_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    is_causal: bool = False,
    return_lse: bool = False,
):
    """Plain PyTorch version of K1: f32 logits, additive mask (a bool mask
    becomes 0 / NEG_INF), top-left-aligned causal mask (``row >= col``, as
    `_fwd_kernel`), f32 softmax, output in the input dtype; optional f32 LSE
    ``[B, H, Sq]``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(query.shape[-1])
    s = _logits(query, key, attn_mask, scale, is_causal)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), value.float()).to(query.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def flash_attention_bwd_plain(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    attn_mask: Optional[torch.Tensor],
    out: torch.Tensor,
    lse: torch.Tensor,
    grad_out: torch.Tensor,
    scale: Optional[float] = None,
    is_causal: bool = False,
):
    """Plain PyTorch version of K2 and K3, in the f32 math of the Pallas
    kernels: ``p = exp(s - lse)``, ``dv = p^T dO``, ``ds = p (dO v^T - delta)
    scale`` with ``delta = rowsum(dO * O)``, ``dk = ds^T q``, ``dq = ds k``.
    Returns (dq, dk, dv) in the inputs' dtypes."""
    scale = scale if scale is not None else 1.0 / math.sqrt(query.shape[-1])
    p = torch.exp(_logits(query, key, attn_mask, scale, is_causal) - lse.float()[..., None])
    do = grad_out.float()
    delta = (do * out.float()).sum(-1).transpose(1, 2)  # [B, H, Sq]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, value.float()) - delta[..., None]) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, query.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, key.float())
    return dq.to(query.dtype), dk.to(key.dtype), dv.to(value.dtype)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (first use, or after the source changed) and load K1's shared
    library. A compile error raises with nvcc's output."""
    lib = _build.load(SOURCE)
    fn = lib.flash_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 6  # q, k, v, mask, out, lse
        + [ctypes.c_int] * 6  # batch, heads, seq_q, seq_k, head_dim, dtype
        + [ctypes.c_longlong] * 16  # q/k/v/out (b, s, h) strides, mask (b, h, q, k) strides
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # scale, causal, stream
    )
    fn.restype = ctypes.c_int
    lib.flash_attention_fwd_smem_bytes.argtypes = [ctypes.c_int]  # head_dim
    lib.flash_attention_fwd_smem_bytes.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_bwd_library() -> ctypes.CDLL:
    """Build and load the shared library of K2 and K3 (one entry point that
    launches either or both from one set of tensor maps)."""
    lib = _build.load(BWD_SOURCE)
    fn = lib.flash_attention_bwd
    fn.argtypes = (
        [ctypes.c_void_p] * 11  # q, k, v, dO, mask, lse, delta, dq, dk, dv, workspace
        + [ctypes.c_int] * 6  # batch, heads, seq_q, seq_k, head_dim, dtype
        + [ctypes.c_longlong] * 19  # q/k/v/dO (b, s, h), delta (b, h, q), mask (b, h, q, k) strides
        # scale, causal, splits, which, stream
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.flash_attention_bwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]  # head_dim, kernel (0 K2, 1 K3)
    lib.flash_attention_bwd_smem_bytes.restype = ctypes.c_int
    return lib


def kernel_supports(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor) -> bool:
    """Whether the CUDA kernels take these q/k/v (device, dtype, head_dim,
    layout). `flash_attention_full` raises on CUDA tensors they do not take."""
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
    if not _build.is_hopper(query.device.index):
        return False
    return all(_rows_aligned(t) for t in (query, key, value))


def _rows_aligned(t: torch.Tensor) -> bool:
    # the kernels' TMA loads: unit head_dim stride, 16-byte-aligned base and strides
    st = t.stride()
    return st[3] == 1 and not (st[0] % 8 or st[1] % 8 or st[2] % 8) and t.data_ptr() % 16 == 0


def _check_supported(name: str, query, key, value) -> None:
    if not kernel_supports(query, key, value):
        raise ValueError(
            f"{name}: the sm_90a kernels take bf16/fp16 CUDA q/k/v [B,S,H,D] with head_dim in "
            f"{HEAD_DIMS}, unit head_dim stride and 16-byte-aligned rows; got q {tuple(query.shape)} "
            f"{query.dtype} on {query.device}, k {tuple(key.shape)}, v {tuple(value.shape)}"
        )


def _mask_arg(attn_mask: Optional[torch.Tensor], query: torch.Tensor, key: torch.Tensor):
    """(pointer, (b, h, q, k) strides, tensor) of the additive f32 mask,
    broadcast to ``[B, H, Sq, Sk]`` without a copy; the caller holds the
    tensor until the launch is queued. (None, zeros, None) without a mask."""
    if attn_mask is None:
        return None, (0, 0, 0, 0), None
    b, sq, h, _ = query.shape
    mask = _additive_mask(attn_mask).to(query.device).expand(b, h, sq, key.shape[1])
    return mask.data_ptr(), mask.stride(), mask


def _tma_operand(t: torch.Tensor):
    """(tensor, (b, s, h) strides) as the kernels' tensor maps take them: every
    stride a non-zero multiple of 16 bytes. A dimension of size 1 takes its
    contiguous stride (its coordinate is always 0); a broadcast dimension
    (stride 0 over more than one element) is materialized."""
    st, (b, s, h, d) = t.stride(), t.shape
    if (st[0] == 0 and b > 1) or (st[1] == 0 and s > 1) or (st[2] == 0 and h > 1):
        t = t.contiguous()
        st = t.stride()
    return t, (st[0] if b > 1 else s * h * d, st[1] if s > 1 else h * d, st[2] if h > 1 else d)


def _flash_fwd_cuda(query, key, value, attn_mask, scale, is_causal, return_lse):
    """Launch K1 (counted in `flash_attention_full.launches`)."""
    _check_supported("flash_attention_full", query, key, value)
    b, sq, h, d = query.shape
    (query, q_strides), (key, k_strides), (value, v_strides) = map(_tma_operand, (query, key, value))
    mask_ptr, mask_strides, _mask = _mask_arg(attn_mask, query, key)
    out = torch.empty_like(query, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, sq), device=query.device, dtype=torch.float32) if return_lse else None

    fn = load_library().flash_attention_fwd
    with torch.cuda.device(query.device):
        err = fn(
            query.data_ptr(), key.data_ptr(), value.data_ptr(), mask_ptr, out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            b, h, sq, key.shape[1], d, DTYPES[query.dtype],
            *q_strides, *k_strides, *v_strides, *out.stride()[:3], *mask_strides,
            float(scale), int(bool(is_causal)), _build.stream_of(query.device),
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed with cudaError_t {err}")
    flash_attention_full.launches += 1
    return out, lse


def pick_split(batch: int, heads: int, seq_q: int, seq_k: int, sms: int) -> int:
    """How many parts K2 cuts each work item's query sweep into, on a card
    with `sms` streaming multiprocessors. K2's work items are (128-key kv
    tile, head, batch); where they fill at most half the card (SDXL's 77-key
    cross attention: 10 or 20 items), each item's sweep over the
    ``ceil(seq_q / 128)`` query blocks is cut into even ranges, as many as
    fit the card in one wave, each range at least one block. The parts write
    f32 partials that a second pass sums in split order."""
    items = -(-seq_k // BWD_KV_TILE) * heads * batch
    blocks = -(-seq_q // BWD_SPLIT_BLOCK)
    if 2 * items > sms:
        return 1
    per = -(-blocks // min(blocks, sms // items))
    return -(-blocks // per)


def _bwd_launch(which: int, query, key, value, attn_mask, lse, delta, grad_out, scale, is_causal):
    """Launch K2 (`which` bit 0: dk, dv) and/or K3 (bit 1: dq) on CUDA tensors
    through one C call, which encodes the four tensor maps once for both;
    counts each kernel launched. Returns (dq or None, dk or None, dv or None)
    in BSHD, the inputs' dtype. Raises on what the kernels do not take."""
    _check_supported("flash_attention_bwd", query, key, value)
    device = query.device
    grad_out = grad_out.to(query.dtype)
    if grad_out.shape != query.shape or not _rows_aligned(grad_out):
        grad_out = grad_out.expand(query.shape).contiguous()
    b, sq, h, d = query.shape
    sk = key.shape[1]
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (b, h, sq) or t.dtype != torch.float32 or t.device != device
                or (t is lse and not t.is_contiguous())):
            raise ValueError(f"flash_attention_bwd: {name} must be an f32 [{b}, {h}, {sq}] tensor on {device} "
                             f"(lse contiguous), got {tuple(t.shape)} {t.dtype} on {t.device}")
    (query, q_strides), (key, k_strides), (value, v_strides), (grad_out, do_strides) = map(
        _tma_operand, (query, key, value, grad_out))
    mask_ptr, mask_strides, _mask = _mask_arg(attn_mask, query, key)
    dq = torch.empty_like(query, memory_format=torch.contiguous_format) if which & 2 else None
    dk = dv = workspace = None
    splits = 1
    if which & 1:
        dk = torch.empty_like(key, memory_format=torch.contiguous_format)
        dv = torch.empty_like(value, memory_format=torch.contiguous_format)
        splits = pick_split(b, h, sq, sk, _build.sm_count(device.index))
        if splits > 1:
            workspace = torch.empty((2, splits, b, sk, h, d), device=device, dtype=torch.float32)
    with torch.cuda.device(device):
        err = load_bwd_library().flash_attention_bwd(
            query.data_ptr(), key.data_ptr(), value.data_ptr(), grad_out.data_ptr(), mask_ptr,
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr() if dq is not None else None,
            dk.data_ptr() if dk is not None else None, dv.data_ptr() if dv is not None else None,
            workspace.data_ptr() if workspace is not None else None,
            b, h, sq, sk, d, DTYPES[query.dtype], *q_strides, *k_strides, *v_strides, *do_strides, *delta.stride(),
            *mask_strides, float(scale), int(bool(is_causal)), splits, which, _build.stream_of(device),
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch (which {which}: 1 K2, 2 K3) failed with cudaError_t {err}")
    if which & 1:
        flash_attention_bwd_dkdv.launches += 1
    if which & 2:
        flash_attention_bwd_dq.launches += 1
    return dq, dk, dv


def flash_attention_bwd_dkdv(query, key, value, attn_mask, lse, delta, grad_out, scale, is_causal):
    """Launch K2 on CUDA tensors: (dk, dv) in BSHD, the inputs' dtype, the
    query sweep split as `pick_split` says. `lse` and `delta` are f32
    ``[B, H, Sq]``, `lse` contiguous (`delta` is read through its strides).
    Raises on what the kernel does not take."""
    _, dk, dv = _bwd_launch(1, query, key, value, attn_mask, lse, delta, grad_out, scale, is_causal)
    return dk, dv


flash_attention_bwd_dkdv.launches = 0


def flash_attention_bwd_dq(query, key, value, attn_mask, lse, delta, grad_out, scale, is_causal):
    """Launch K3 on CUDA tensors: dq in BSHD, the inputs' dtype."""
    return _bwd_launch(2, query, key, value, attn_mask, lse, delta, grad_out, scale, is_causal)[0]


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd(query, key, value, attn_mask, out, lse, grad_out, scale=None, is_causal=False):
    """The attention backward (BSHD): (dq, dk, dv). A CPU tensor takes
    `flash_attention_bwd_plain`; a CUDA tensor launches K2 and K3 (one C
    call, counted in both wrappers' counters), or raises. ``delta =
    rowsum(dO * O)`` is a PyTorch op in f32, as in JAX (`:249`): f32
    products (``out`` is upcast inside the multiply), summed over head_dim,
    handed to the kernels as a [B, H, Sq] view of its [B, Sq, H] result."""
    scale = scale if scale is not None else 1.0 / math.sqrt(query.shape[-1])
    if query.device.type == "cpu":
        return flash_attention_bwd_plain(query, key, value, attn_mask, out, lse, grad_out, scale, is_causal)
    delta = (grad_out.float() * out).sum(-1).transpose(1, 2)
    return _bwd_launch(3, query, key, value, attn_mask, lse, delta, grad_out, scale, is_causal)


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention, the counterpart of JAX's
    `flash_attention_vjp`: the forward keeps the f32 LSE (K1 on the card,
    `flash_attention_plain` on the CPU) and saves q, k, v, the mask, out and
    the LSE; the backward is `flash_attention_bwd` (K2 and K3 on the card).
    Returns (out, lse); the LSE carries no gradient. Under `torch.autocast`
    it runs in the dtype its inputs arrive in."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, query, key, value, attn_mask, scale, is_causal):
        mask = _additive_mask(attn_mask)
        if query.device.type == "cpu":
            out, lse = flash_attention_plain(query, key, value, mask, scale, is_causal, return_lse=True)
        else:
            out, lse = _flash_fwd_cuda(query, key, value, mask, scale, is_causal, return_lse=True)
        ctx.save_for_backward(query, key, value, mask, out, lse)
        ctx.scale, ctx.is_causal = scale, is_causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, grad_out, grad_lse):
        query, key, value, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(query, key, value, mask, out, lse, grad_out, ctx.scale, ctx.is_causal)
        return dq, dk, dv, None, None, None


def flash_attention_full(
    query: torch.Tensor,  # [B, Sq, H, D]
    key: torch.Tensor,  # [B, Sk, H, D]
    value: torch.Tensor,
    attn_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    is_causal: bool = False,
    return_lse: bool = False,
):
    """Flash attention (BSHD), differentiable in q, k and v.

    With grad mode on and an input that requires grad, the call goes through
    `FlashAttentionFunction` (K1 with the LSE, then K2 and K3 in the
    backward). Otherwise it is the forward alone, with no LSE write unless
    `return_lse`: a CPU tensor takes `flash_attention_plain`; a CUDA tensor
    launches K1, or raises on what the kernel does not take (see
    `kernel_supports`).

    `attn_mask`: additive float bias or bool keep-mask, broadcastable to
    ``[B, H, Sq, Sk]``. Returns the output, and the f32 LSE ``[B, H, Sq]``
    when `return_lse`."""
    scale = scale if scale is not None else 1.0 / math.sqrt(query.shape[-1])
    if torch.is_grad_enabled() and (query.requires_grad or key.requires_grad or value.requires_grad):
        out, lse = FlashAttentionFunction.apply(query, key, value, attn_mask, scale, is_causal)
        return (out, lse) if return_lse else out
    if query.device.type == "cpu":
        return flash_attention_plain(query, key, value, attn_mask, scale, is_causal, return_lse)
    out, lse = _flash_fwd_cuda(query, key, value, attn_mask, scale, is_causal, return_lse)
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

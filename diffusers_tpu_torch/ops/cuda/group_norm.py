"""GroupNorm with optional fused SiLU: CUDA kernel K4, its plain version, its
planner, the autograd Function and the wrapper that picks between them by
device.

Port of the Pallas TPU kernel `_gn_kernel` / `group_norm_silu`
(`diffusers_tpu/ops/pallas/group_norm.py:30,150`). The kernel source, with its
design note (what bounds it on an H100 and what the design does about it), is
`diffusers_tpu_torch/csrc/group_norm.cu`; it builds and binds as K1 does
(`_build.py`).

What it computes: per (batch, group), the f32 mean and variance over the
group's channels and all spatial positions; then ``(x - mean) * rstd * w[c] +
b[c]``, optionally followed by SiLU, written once in x's dtype. In the port's
NCHW-contiguous layout one (batch, group) is one contiguous span of ``C/G *
H * W`` elements, so the JAX kernel's one-hot ``[C, G]`` matmul collapse
(needed there because NHWC interleaves the groups across lanes) disappears.

`plan_group_norm` chooses, per shape, between the kernel's two regimes: a
thread-block cluster per span that keeps the span in shared memory (one read
of x), or chunk statistics in a workspace merged by a second kernel (two
reads). It is plain Python, so the CPU tests check every plan the main paths
make.

Gradient: `GroupNormFunction` keeps K4 as the forward and differentiates in
PyTorch ops on the saved input (`group_norm_bwd`), as JAX's training path has
XLA differentiate its GroupNorm: `group_norm_silu` has no custom VJP.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

SOURCE = _build.CSRC / "group_norm.cu"
DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
CLUSTER_CHUNK_BYTES = 30 * 1024  # the most of a span one CTA of a cluster holds in shared memory
MAX_CLUSTER = 8  # the portable cluster size
MIN_CLUSTER_CHUNK_BYTES = 4 * 1024  # a cluster grows past its fewest CTAs only while its chunks stay this large
SPLIT_CHUNK_BYTES = 32 * 1024  # a CTA's chunk in the split regime
SMEM_HEADER = 256  # bytes of a CTA's shared memory before its chunk (csrc/group_norm.cu `kHeader`)
MAX_SMEM = 232448  # dynamic shared memory a block may use on sm_90
SM_SMEM = 233472  # shared memory of an SM on sm_90; each resident block also takes 1 KB of it
CTAS_PER_SM = 4  # the kernel's `kMinBlocks`: its registers let at least this many CTAs share an SM


def group_norm_plain(
    x: torch.Tensor,
    weight: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    num_groups: int,
    eps: float = 1e-5,
    apply_silu: bool = False,
) -> torch.Tensor:
    """Plain PyTorch GroupNorm(+SiLU) over ``[B, C, *spatial]``: f32 two-pass
    statistics (the math of `diffusers_tpu.ops.module.GroupNorm`), affine and
    SiLU in f32, one cast back to x's dtype."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, num_groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.ndim - 2)
    if weight is not None:
        xf = xf * weight.float().reshape(shape)
    if bias is not None:
        xf = xf + bias.float().reshape(shape)
    if apply_silu:
        xf = F.silu(xf)
    return xf.to(x.dtype)


def group_norm_bwd(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    grad_out: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
    apply_silu: bool = False,
):
    """The GroupNorm(+SiLU) gradient in PyTorch ops, on the saved input:
    recompute the f32 statistics, then (dx, dweight, dbias) in the dtypes of
    x, weight and bias. The JAX package has no backward kernel for
    `_gn_kernel` either: its training path has XLA differentiate its
    GroupNorm."""
    b, c = x.shape[:2]
    shape = (1, c) + (1,) * (x.ndim - 2)
    xf = x.float().reshape(b, num_groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((xf - mean).square().mean(dim=-1, keepdim=True) + eps)
    xhat = ((xf - mean) * rstd).reshape(x.shape)
    g = grad_out.float()
    if apply_silu:
        y = xhat * weight.float().reshape(shape) + bias.float().reshape(shape)
        sig = torch.sigmoid(y)
        g = g * sig * (1 + y * (1 - sig))
    reduce_dims = [0] + list(range(2, x.ndim))
    dweight = (g * xhat).sum(dim=reduce_dims)
    dbias = g.sum(dim=reduce_dims)
    gx = (g * weight.float().reshape(shape)).reshape(b, num_groups, -1)
    xhat = xhat.reshape(b, num_groups, -1)
    dx = rstd * (gx - gx.mean(dim=-1, keepdim=True) - xhat * (gx * xhat).mean(dim=-1, keepdim=True))
    return dx.reshape(x.shape).to(x.dtype), dweight.to(weight.dtype), dbias.to(bias.dtype)


# ------------------------------------------------------------------ planner


class GroupNormPlan(NamedTuple):
    """How K4 covers a shape. `split` False: one cluster of `parts` CTAs a
    span (the cluster regime); True: `parts` chunks a span, statistics to a
    workspace, then a normalise kernel (the split regime). `chunk`: elements
    a CTA (a multiple of 16 bytes; the last CTAs of a span may hold fewer or
    none). `smem_bytes`: dynamic shared memory a CTA."""

    split: bool
    parts: int
    chunk: int
    smem_bytes: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(chunk: int, itemsize: int) -> int:
    """A CTA's dynamic shared memory for a chunk of `chunk` elements: the
    header, then the chunk with up to a 16-byte word of slack at each end
    (csrc/group_norm.cu `smem_bytes`)."""
    return SMEM_HEADER + _ceil((chunk + 2 * (16 // itemsize)) * itemsize, 16) * 16


@functools.lru_cache(maxsize=None)
def plan_group_norm(shape: Tuple[int, ...], dtype: torch.dtype, num_sms: int, num_groups: int = 32) -> GroupNormPlan:
    """K4's plan for a contiguous ``[B, C, *spatial]`` input on a card with
    `num_sms` streaming multiprocessors.

    A span of at most ``MAX_CLUSTER * CLUSTER_CHUNK_BYTES`` takes the cluster
    regime. Its cluster size is a power of two from the fewest CTAs whose
    chunks fit ``CLUSTER_CHUNK_BYTES`` up to ``MAX_CLUSTER``: the one whose
    grid takes the fewest waves of the card's resident CTAs (shared memory
    and ``CTAS_PER_SM`` allowing), and of those the largest whose chunks
    hold at least ``MIN_CLUSTER_CHUNK_BYTES``, so that more SMs share a wave.
    A larger span takes the split regime, in chunks of about
    ``SPLIT_CHUNK_BYTES``."""
    itemsize = torch.finfo(dtype).bits // 8
    align = 16 // itemsize
    spans = shape[0] * num_groups
    span = shape[1] // num_groups
    for d in shape[2:]:
        span *= d
    span_bytes = span * itemsize
    n = 1
    while n * CLUSTER_CHUNK_BYTES < span_bytes:
        n *= 2
    if n > MAX_CLUSTER:
        chunk = _ceil(_ceil(span, _ceil(span_bytes, SPLIT_CHUNK_BYTES)), align) * align
        return GroupNormPlan(True, _ceil(span, chunk), chunk, smem_bytes(chunk, itemsize))
    best = None
    while n <= MAX_CLUSTER:
        chunk = _ceil(_ceil(span, n), align) * align
        smem = smem_bytes(chunk, itemsize)
        slots = num_sms * min(CTAS_PER_SM, SM_SMEM // (smem + 1024))
        waves = _ceil(spans * n, slots)
        if best is None or (waves <= best[0] and chunk * itemsize >= MIN_CLUSTER_CHUNK_BYTES):
            best = (waves, GroupNormPlan(False, n, chunk, smem))
        n *= 2
    return best[1]


def fast_divisor(d: int) -> Tuple[int, int]:
    """(magic, shift) with ``n // d == (n * magic) >> shift`` for every 0 <= n
    < 2^31: shift = 31 + ceil(log2 d), magic = 2^shift // d + 1 (the kernel's
    channel of a span-local index, without an integer division)."""
    shift = 31 + (d - 1).bit_length()
    return (1 << shift) // d + 1, shift


def chunk_bounds(plan: GroupNormPlan, span: int):
    """The span-local element range [lo, hi) of each CTA of a span, in rank
    (cluster) or chunk (split) order, as the kernel computes it."""
    return [(min(i * plan.chunk, span), min((i + 1) * plan.chunk, span)) for i in range(plan.parts)]


def chunk_copies(start: int, end: int, itemsize: int):
    """How a CTA loads the global elements [start, end) (element indices
    from a 16-byte-aligned base): ``(s0, a0, a1)``, where shared memory holds
    element e at e - s0, a bulk copy moves [a0, a1) and ordinary loads the
    head [start, a0) and the tail [a1, end) (csrc/group_norm.cu
    `load_chunk`)."""
    align = 16 // itemsize
    s0 = start // align * align
    a0 = min(_ceil(start, align) * align, end)
    a1 = max(end // align * align, a0)
    return s0, a0, a1


# ------------------------------------------------------------------ kernel


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (first use, or after the source changed) and load K4's shared
    library. A compile error raises with nvcc's output."""
    lib = _build.load(SOURCE)
    lib.group_norm_fwd.argtypes = (
        [ctypes.c_void_p] * 5  # x, w, b, y, partials
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int]  # spans, groups, cpg, hw
        + [ctypes.c_ulonglong, ctypes.c_int]  # hw_magic, hw_shift
        + [ctypes.c_int] * 5  # dtype, param_f32, split, parts, chunk
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]  # eps, silu, drop, stream
    )
    lib.group_norm_fwd.restype = ctypes.c_int
    return lib


def _group_norm_cuda(x, weight, bias, num_groups, eps, apply_silu, _drop_partial: int = -1):
    """Launch K4 (counted in `group_norm.launches`) with the plan
    `plan_group_norm` makes. `_drop_partial` leaves one cluster rank's or
    chunk's partial out of the statistics: a deliberately wrong result for
    the controls of `chip_smoke.py` and the card tests."""
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: unsupported device {x.device}")
    if x.ndim < 2 or x.shape[1] % num_groups != 0:
        raise ValueError(f"group_norm: channels of {tuple(x.shape)} do not split into {num_groups} groups")
    if x.dtype not in DTYPES:
        raise ValueError(f"group_norm: unsupported dtype {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("group_norm: x must be contiguous NCHW with a 16-byte-aligned start")
    if not _build.is_hopper(x.device.index):
        raise ValueError(f"group_norm: the sm_90a kernel needs a Hopper card, got "
                         f"{torch.cuda.get_device_name(x.device)}")
    b, c = x.shape[:2]
    for name, p in (("weight", weight), ("bias", bias)):
        if p.shape != (c,) or p.device != x.device or p.dtype not in DTYPES:
            raise ValueError(f"group_norm: {name} must be a [{c}] float tensor on {x.device}")
    if weight.dtype == bias.dtype == x.dtype:
        param_f32 = 0
    else:  # another type than x's: both in f32
        weight, bias, param_f32 = weight.float(), bias.float(), 1
    weight, bias = weight.contiguous(), bias.contiguous()
    hw = x[0, 0].numel()
    if c // num_groups * hw >= 2**31:
        raise ValueError(f"group_norm: a group of {tuple(x.shape)} exceeds 2^31 elements")
    plan = plan_group_norm(tuple(x.shape), x.dtype, _build.sm_count(x.device.index), num_groups)
    spans = b * num_groups
    y = torch.empty_like(x)
    partials = (torch.empty(spans * plan.parts * 2, device=x.device, dtype=torch.float32) if plan.split
                else None)
    with torch.cuda.device(x.device):
        err = load_library().group_norm_fwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            partials.data_ptr() if partials is not None else None,
            spans, num_groups, c // num_groups, hw, *fast_divisor(hw), DTYPES[x.dtype], param_f32, int(plan.split),
            plan.parts, plan.chunk, float(eps), int(bool(apply_silu)), int(_drop_partial), _build.stream_of(x.device),
        )
    if err != 0:
        raise RuntimeError(f"group_norm_fwd launch ({plan}) failed with cudaError_t {err}")
    group_norm.launches += 1
    return y


class GroupNormFunction(torch.autograd.Function):
    """Differentiable GroupNorm(+SiLU): the forward is K4 on the card
    (`group_norm_plain` on the CPU) and saves x, weight and bias; the backward
    is `group_norm_bwd`, PyTorch ops on the saved input."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, weight, bias, num_groups, eps, apply_silu):
        if x.device.type == "cpu":
            y = group_norm_plain(x, weight, bias, num_groups, eps, apply_silu)
        else:
            y = _group_norm_cuda(x, weight, bias, num_groups, eps, apply_silu)
        ctx.save_for_backward(x, weight, bias)
        ctx.num_groups, ctx.eps, ctx.apply_silu = num_groups, eps, apply_silu
        return y

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, grad_out):
        x, weight, bias = ctx.saved_tensors
        dx, dweight, dbias = group_norm_bwd(x, weight, bias, grad_out, ctx.num_groups, ctx.eps, ctx.apply_silu)
        return dx, dweight, dbias, None, None, None


def group_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    num_groups: int,
    eps: float = 1e-5,
    apply_silu: bool = False,
) -> torch.Tensor:
    """GroupNorm(+SiLU) over a contiguous ``[B, C, *spatial]`` tensor,
    differentiable in x, weight and bias.

    With grad mode on and an input that requires grad, the call goes through
    `GroupNormFunction`. Otherwise a CPU tensor takes `group_norm_plain` and a
    CUDA tensor launches K4, or raises on what the kernel does not take."""
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, weight, bias))
    if not needs_grad and x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, num_groups, eps, apply_silu)
    c = x.shape[1]
    weight = torch.ones(c, device=x.device, dtype=x.dtype) if weight is None else weight
    bias = torch.zeros(c, device=x.device, dtype=x.dtype) if bias is None else bias
    if needs_grad:
        return GroupNormFunction.apply(x, weight, bias, num_groups, eps, apply_silu)
    return _group_norm_cuda(x, weight, bias, num_groups, eps, apply_silu)


group_norm.launches = 0

"""GroupNorm with optional fused SiLU: Triton kernel K4, its plain version, and
the wrapper that picks between them by device.

Replaces the Pallas TPU kernel `_gn_kernel` / `group_norm_silu`
(`diffusers_tpu/ops/pallas/group_norm.py:30,150`).

What it computes: per (batch, group), the f32 mean and variance over the
group's channels and all spatial positions; then ``(x - mean) * rstd * w[c] +
b[c]``, optionally followed by SiLU, written once in x's dtype.

What bounds it on an H100: bytes. It does no tensor-core work: two reads and
one write of x at ~2 FLOP per byte, far below the card's ~295 FLOP/byte bf16
ridge, so the floor is 3 x bytes(x) / 3.35 TB/s.

What the design does about it: in the port's NCHW-contiguous layout one
(batch, group) is one contiguous span of ``C/G * H * W`` elements, so one
program streams its span with wide masked block loads (`BLOCK` elements per
step) and keeps the statistics in registers. The JAX kernel's one-hot
``[C, G]`` matmul collapse (needed there because NHWC interleaves the groups
across lanes) disappears. Pass 1 accumulates the sum and sum of squares of
``x - x[0]`` in f32 per lane (the shift by the span's first element keeps
``E[d^2] - E[d]^2`` from cancelling when the mean is large against the
spread); pass 2 normalizes, applies the affine and SiLU, and stores.

Gradient: `GroupNormFunction` keeps K4 as the forward and differentiates
in PyTorch ops on the saved input (`group_norm_bwd`), as JAX's training path
has XLA differentiate its GroupNorm: `group_norm_silu` has no custom VJP. A
backward kernel is a later PR's work.

Known limit (a later PR's work): one program per (b, g) runs only ``B * G``
programs, e.g. 64 for the UNet's ``(2, 320, 128, 128)`` map and 32 for the
VAE's ``(1, 128, 1024, 1024)`` map, so most of the 132 SMs idle; a split
reduction across programs would fill the card.
"""

import functools
from typing import Optional

import torch
import torch.nn.functional as F

_BLOCK = 4096
_NUM_WARPS = 16
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


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


@functools.lru_cache(maxsize=None)
def _kernel():
    """The Triton kernel (compiled by Triton on its first launch). Triton is
    imported here, never at module import, so hosts without it can import
    this module and take the plain version."""
    import triton
    import triton.language as tl

    @triton.jit
    def group_norm_kernel(
        x_ptr, w_ptr, b_ptr, y_ptr,
        C, HW, num_groups, eps,
        APPLY_SILU: tl.constexpr,
        BLOCK: tl.constexpr,
    ):
        # one program per (batch, group): a contiguous span of C/G * HW elements
        pid = tl.program_id(0).to(tl.int64)
        batch = pid // num_groups
        group = pid % num_groups
        cpg = C // num_groups
        n = cpg * HW
        base = batch * C * HW + group * cpg * HW
        x_base = x_ptr + base

        # pass 1: f32 sums of the shifted values d = x - x[0]
        shift = tl.load(x_base).to(tl.float32)
        acc1 = tl.zeros([BLOCK], dtype=tl.float32)
        acc2 = tl.zeros([BLOCK], dtype=tl.float32)
        for start in range(0, n, BLOCK):
            offs = start + tl.arange(0, BLOCK)
            m = offs < n
            d = tl.load(x_base + offs, mask=m, other=0.0).to(tl.float32) - shift
            d = tl.where(m, d, 0.0)
            acc1 += d
            acc2 += d * d
        mean_d = tl.sum(acc1, axis=0) / n
        var = tl.maximum(tl.sum(acc2, axis=0) / n - mean_d * mean_d, 0.0)
        rstd = tl.rsqrt(var + eps)
        mean = shift + mean_d

        # pass 2: normalize, per-channel affine, optional SiLU, one store
        for start in range(0, n, BLOCK):
            offs = start + tl.arange(0, BLOCK)
            m = offs < n
            x = tl.load(x_base + offs, mask=m, other=0.0).to(tl.float32)
            ch = group * cpg + offs // HW
            w = tl.load(w_ptr + ch, mask=m, other=0.0).to(tl.float32)
            b = tl.load(b_ptr + ch, mask=m, other=0.0).to(tl.float32)
            y = (x - mean) * rstd * w + b
            if APPLY_SILU:
                y = y * tl.sigmoid(y)
            tl.store(y_ptr + base + offs, y.to(y_ptr.dtype.element_ty), mask=m)

    return group_norm_kernel


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


def _group_norm_cuda(x, weight, bias, num_groups, eps, apply_silu):
    """Launch K4 (counted in `group_norm.launches`)."""
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: unsupported device {x.device}")
    if x.ndim < 2 or x.shape[1] % num_groups != 0:
        raise ValueError(f"group_norm: channels of {tuple(x.shape)} do not split into {num_groups} groups")
    if x.dtype not in _DTYPES:
        raise ValueError(f"group_norm: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("group_norm: x must be contiguous NCHW")
    b, c = x.shape[:2]
    hw = x[0, 0].numel()
    if c // num_groups * hw >= 2**31:
        raise ValueError(f"group_norm: a group of {tuple(x.shape)} exceeds 2^31 elements")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.shape != (c,) or p.device != x.device or not p.is_contiguous():
            raise ValueError(f"group_norm: {name} must be a contiguous [{c}] tensor on {x.device}")

    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _kernel()[(b * num_groups,)](
            x, weight, bias, y, c, hw, num_groups, eps,
            APPLY_SILU=apply_silu, BLOCK=_BLOCK, num_warps=_NUM_WARPS,
        )
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
    CUDA tensor launches the Triton kernel, or raises on what the kernel does
    not take."""
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

"""Attention kernel dispatch.

Port of `diffusers_tpu/ops/attention.py` (registry `:33-61`,
`dispatch_attention_fn` `:267-295`, auto rule `:306-325`). Backends:

  * ``native`` — plain torch math: f32 logits and softmax, the numerics
                 reference of `_native_attention`.
  * ``flash``  — the hand-written sm_90a flash-attention kernels
                 (`ops/cuda/flash_attention.py`, sources `csrc/`): K1
                 forward, and under autograd K2/K3 backward through
                 `FlashAttentionFunction`.

The sequence-parallel ``ring``/``ulysses`` backends wait for the parallelism
port.

Tensor convention: q/k/v are [batch, seq, heads, head_dim] (BSHD).
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Callable, Dict, Optional

import torch

from .cuda.flash_attention import HEAD_DIMS, flash_attention_full

_BACKENDS: Dict[str, Callable] = {}
_active_backend: Optional[str] = None


def register_attention_backend(name: str):
    def deco(fn):
        _BACKENDS[name] = fn
        return fn

    return deco


@contextmanager
def attention_backend(name: str):
    """Select a backend for the calls made inside the context."""
    global _active_backend
    if name not in _BACKENDS:
        raise ValueError(f"unknown attention backend {name!r}; available: {list(_BACKENDS)}")
    prev = _active_backend
    _active_backend = name
    try:
        yield
    finally:
        _active_backend = prev


def available_attention_backends():
    return list(_BACKENDS)


@register_attention_backend("native")
def _native_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    attn_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    is_causal: bool = False,
) -> torch.Tensor:
    """Reference-math attention: f32 logits and softmax. Causal is
    bottom-right aligned (``tril(k=Sk-Sq)``), as in the JAX backend; a bool
    mask blocks with the f32 minimum."""
    b, sq, h, d = query.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", query.float(), key.float()) * scale
    min_value = torch.finfo(torch.float32).min
    if is_causal:
        sk = key.shape[1]
        causal = torch.ones((sq, sk), dtype=torch.bool, device=query.device).tril(diagonal=sk - sq)
        logits = logits.masked_fill(~causal, min_value)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, min_value)
        else:
            logits = logits + attn_mask.float()
    probs = torch.softmax(logits, dim=-1).to(query.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, value)


@register_attention_backend("flash")
def _flash_attention(query, key, value, attn_mask=None, scale=None, is_causal=False):
    """The sm_90a flash-attention kernels, differentiable (plain versions
    for CPU tensors)."""
    return flash_attention_full(query, key, value, attn_mask=attn_mask, scale=scale, is_causal=is_causal)


def dispatch_attention_fn(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    attn_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    is_causal: bool = False,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Route an attention call: explicit `backend` arg, then the ambient
    `attention_backend()` context, then the automatic rule."""
    if not (query.ndim == key.ndim == value.ndim == 4):
        raise ValueError(f"attention expects [B,S,H,D] tensors, got q{tuple(query.shape)} k{tuple(key.shape)} v{tuple(value.shape)}")
    if query.shape[-1] != key.shape[-1] or key.shape[:2] != value.shape[:2]:
        raise ValueError(f"inconsistent attention shapes q{tuple(query.shape)} k{tuple(key.shape)} v{tuple(value.shape)}")
    name = backend or _active_backend or _auto_backend(query, key, value)
    return _BACKENDS[name](query, key, value, attn_mask=attn_mask, scale=scale, is_causal=is_causal)


def _auto_backend(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor) -> str:
    # A CUDA call with a head dim the kernel takes runs the kernel, which
    # raises on a dtype, card or layout it does not take; CPU tensors and
    # other head dims (the VAE mid-block's single head at d=512 over 16k
    # tokens) run native.
    return "flash" if query.is_cuda and query.shape[-1] in HEAD_DIMS else "native"

"""The arithmetic of the port's Hopper kernels K2 (dK, dV) and K3 (dQ), on
the CPU, and K2's split of the query sweep.

K2 and K3 (`csrc/flash_attention_bwd.cu`) cannot run here, so their rounding
order is emulated in PyTorch: f32 logits, ``p = exp2(s * (scale * log2(e))
- lse * log2(e))`` (the masked and causal instances scale and mask first,
then convert to log2 units; the masked ones subtract the natural-log LSE
before the conversion), ``ds = p (dp - delta) scale`` in f32, P and dS
rounded to the input type before their products, dQ summed in f32 and
rounded once. K2 sums each query split's partial dK and dV in f32 over its
range of 128-query blocks (`split_ranges`, as the kernel's `coords`), adds
the partials in split order, then rounds once. The emulation is held
element by element to
`chip_smoke.attention_bwd_bounds` (the limit the card checks hold the
kernels to) and, where the JAX kernel tiles the lengths, JAX's
`_flash_bwd_bhsd` in interpret mode is held to the same bound on the same
inputs. A control shows that the bound rejects a K2 that drops one split's
partial.

`pick_split` must cover every query exactly once, split SDXL's 77-key cross
attention, leave the self-attention and Flux shapes whole, and the card
tests' shapes (`chip_smoke.FLASH_BWD_CARD_CASES`) must reach both paths, on
either H100.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import BWD_EXTRA_CASES, FLASH_BWD_CARD_CASES, SDXL_TRAIN_ATTENTION, attention_bwd_bounds
from diffusers_tpu.ops.pallas.flash_attention_bwd import _flash_bwd_bhsd
from diffusers_tpu_torch.ops.cuda.flash_attention import (
    BWD_KV_TILE,
    BWD_SPLIT_BLOCK,
    NEG_INF,
    flash_attention_plain,
    pick_split,
)
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

LOG2E = 1.4426950408889634
H100_SXM_SMS, H100_PCIE_SMS = 132, 114  # streaming multiprocessors


def split_ranges(seq_q, splits, k0=0, is_causal=False):
    """The query ranges ``[lo, hi)`` of K2's `splits` parts for the work item
    whose keys start at `k0`, as the kernel's `coords` derives them: even
    ranges of 128-query blocks, from the first block that reaches key `k0`
    under a causal mask (else the first). A part may be empty."""
    blocks = -(-seq_q // BWD_SPLIT_BLOCK)
    first = min(k0 // BWD_SPLIT_BLOCK, blocks) if is_causal else 0
    per = -(-(blocks - first) // splits)
    ranges = []
    for s in range(splits):
        lo = min(first + s * per, blocks)
        ranges.append((lo * BWD_SPLIT_BLOCK, min(min(lo + per, blocks) * BWD_SPLIT_BLOCK, seq_q)))
    return ranges


def _emulated_k2_k3(q, k, v, out, lse, grad_out, scale, is_causal=False, mask=None, splits=1, drop_split=None):
    """K2/K3's arithmetic on BSHD inputs: (dq, dk, dv) in the input dtype.
    `drop_split` leaves that split's partial out of K2's sum (the control)."""
    dt = q.dtype
    sq, sk = q.shape[1], k.shape[1]
    qf, kf, vf, dof = (t.float() for t in (q, k, v, grad_out))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    scale32 = torch.tensor(scale, dtype=torch.float32)
    log2e = torch.tensor(LOG2E, dtype=torch.float32)
    lse2 = (lse * log2e)[..., None]
    if is_causal or mask is not None:
        x = s * scale32
        if mask is not None:
            x = x + mask
        if is_causal:
            x = torch.where(torch.arange(sq)[:, None] >= torch.arange(sk)[None, :], x, NEG_INF)
        # the masked instances subtract the natural-log LSE first
        x = (x - lse[..., None]) * log2e if mask is not None else x * log2e - lse2
    else:
        x = s * (scale32 * log2e) - lse2
    p = torch.exp2(x)
    delta = (dof * out.float()).sum(-1).transpose(1, 2)[..., None]  # the wrapper's f32 op
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta) * scale32
    p, ds = p.to(dt).float(), ds.to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf).to(dt)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for k0 in range(0, sk, BWD_KV_TILE):
        keys = slice(k0, k0 + BWD_KV_TILE)
        acc_k = acc_v = None
        for i, (lo, hi) in enumerate(split_ranges(sq, splits, k0, is_causal)):
            part_k = torch.einsum("bhqk,bqhd->bkhd", ds[:, :, lo:hi, keys], qf[:, lo:hi])
            part_v = torch.einsum("bhqk,bqhd->bkhd", p[:, :, lo:hi, keys], dof[:, lo:hi])
            if i == drop_split:
                continue
            acc_k = part_k if acc_k is None else acc_k + part_k
            acc_v = part_v if acc_v is None else acc_v + part_v
        dk[:, keys], dv[:, keys] = acc_k, acc_v
    return dq, dk.to(dt), dv.to(dt)


def _inputs(seed, b, sq, sk, h, d, dtype, is_causal=False, mask=None):
    """q, k, v, dO in `dtype` from numpy, and K1's out (rounded) and f32 LSE."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(2 * rng.randn(b, sq, h, d).astype(np.float32)).to(dtype)
    k, v = (torch.from_numpy(rng.randn(b, sk, h, d).astype(np.float32)).to(dtype) for _ in range(2))
    grad_out = torch.from_numpy(rng.randn(b, sq, h, d).astype(np.float32)).to(dtype)
    out, lse = flash_attention_plain(q.float(), k.float(), v.float(), attn_mask=mask, is_causal=is_causal,
                                     return_lse=True)
    return q, k, v, out.to(dtype), lse, grad_out


def _within(grads, bounds_and_refs):
    refs, bounds = bounds_and_refs
    return [bool(((g.float() - r).abs() <= bd).all()) for g, r, bd in zip(grads, refs, bounds)]


def _jax_grads(q, k, v, out, lse, grad_out, scale, is_causal, mask=None):
    """JAX's `_flash_bwd_bhsd` (interpret mode, 128 x 128 blocks) on the same
    inputs, back in BSHD f32."""
    jdt = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float16
    bhsd = [jnp.asarray(t.float().numpy().transpose(0, 2, 1, 3), dtype=jdt) for t in (q, k, v, out, grad_out)]
    jmask = None if mask is None else jnp.asarray(mask.expand(q.shape[0], q.shape[2], q.shape[1], k.shape[1]).numpy())
    grads = _flash_bwd_bhsd(*bhsd[:3], jmask, bhsd[3], jnp.asarray(lse.numpy()), bhsd[4], scale=scale,
                            is_causal=is_causal, block_q=128, block_k=128, interpret=True)
    return [torch.from_numpy(np.asarray(g, dtype=np.float32).transpose(0, 2, 1, 3)) for g in grads]


@pytest.mark.parametrize(
    "d,dtype,causal,splits",
    [(64, torch.bfloat16, False, 1), (64, torch.bfloat16, False, 2), (128, torch.bfloat16, False, 2),
     (128, torch.float16, False, 1), (64, torch.bfloat16, True, 2), (64, torch.float16, True, 1)],
    ids=["bf16-d64", "bf16-d64-split2", "bf16-d128-split2", "fp16-d128", "bf16-d64-causal-split2",
         "fp16-d64-causal"],
)
def test_k2_k3_emulation_holds_to_the_bound_and_to_jax(d, dtype, causal, splits):
    q, k, v, out, lse, grad_out = _inputs(0, 1, 256, 256, 2, d, dtype, is_causal=causal)
    scale = 1.0 / math.sqrt(d)
    refs, bounds, _ = attention_bwd_bounds(q, k, v, out, lse, grad_out, is_causal=causal)
    grads = _emulated_k2_k3(q, k, v, out, lse, grad_out, scale, is_causal=causal, splits=splits)
    assert all(_within(grads, (refs, bounds)))
    assert all(_within(_jax_grads(q, k, v, out, lse, grad_out, scale, causal), (refs, bounds)))


@pytest.mark.parametrize(
    "shape,dtype,splits",
    [((1, 640, 77, 2, 64), torch.bfloat16, 5), ((2, 300, 77, 2, 128), torch.float16, 3),
     ((3, 1, 5, 1, 64), torch.float16, 1), ((1, 130, 300, 2, 64), torch.bfloat16, 2)],
    ids=["cross-640x77-split5", "cross-300x77-fp16-split3", "1x5-fp16", "130x300-split2"],
)
def test_k2_k3_emulation_holds_at_ragged_lengths(shape, dtype, splits):
    """Lengths the JAX kernel does not tile, SDXL's 77-key cross attention
    among them, split as on the card."""
    b, sq, sk, h, d = shape
    q, k, v, out, lse, grad_out = _inputs(1, b, sq, sk, h, d, dtype)
    refs, bounds, _ = attention_bwd_bounds(q, k, v, out, lse, grad_out)
    grads = _emulated_k2_k3(q, k, v, out, lse, grad_out, 1.0 / math.sqrt(d), splits=splits)
    assert all(_within(grads, (refs, bounds)))


@pytest.mark.parametrize("hidden", [-math.inf, torch.finfo(torch.float32).min], ids=["-inf", "finfo.min"])
def test_k2_k3_emulation_holds_when_a_mask_hides_the_first_kv_tile(hidden):
    """An additive mask over the first 160 keys (more than one 128-key tile)
    of every other row: finite grads within the bound, as JAX's kernel's."""
    mask = torch.zeros(1, 1, 256, 256)
    mask[:, :, ::2, :160] = hidden
    q, k, v, out, lse, grad_out = _inputs(2, 1, 256, 256, 2, 64, torch.bfloat16, mask=mask)
    refs, bounds, _ = attention_bwd_bounds(q, k, v, out, lse, grad_out, attn_mask=mask)
    grads = _emulated_k2_k3(q, k, v, out, lse, grad_out, 0.125, mask=mask, splits=2)
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads)
    assert all(_within(grads, (refs, bounds)))
    assert all(_within(_jax_grads(q, k, v, out, lse, grad_out, 0.125, False, mask), (refs, bounds)))


def test_k2_bound_rejects_a_dropped_split():
    """Control: K2 without one split's partial breaks the bound on dK and dV."""
    q, k, v, out, lse, grad_out = _inputs(3, 1, 512, 77, 2, 64, torch.bfloat16)
    refs, bounds, _ = attention_bwd_bounds(q, k, v, out, lse, grad_out)
    assert all(_within(_emulated_k2_k3(q, k, v, out, lse, grad_out, 0.125, splits=4), (refs, bounds)))
    dropped = _emulated_k2_k3(q, k, v, out, lse, grad_out, 0.125, splits=4, drop_split=1)
    assert _within(dropped, (refs, bounds)) == [True, False, False]


@pytest.mark.parametrize("sms", [H100_SXM_SMS, H100_PCIE_SMS], ids=["sxm", "pcie"])
def test_pick_split_covers_every_query_once(sms):
    shapes = [(b, h, sq, sk) for _, (b, sq, h, _), sk, _, _ in SDXL_TRAIN_ATTENTION + BWD_EXTRA_CASES]
    shapes += [(b, h, sq, sk) for b, sq, sk, h, *_ in FLASH_BWD_CARD_CASES]
    for b, h, sq, sk in shapes:
        splits = pick_split(b, h, sq, sk, sms)
        items = -(-sk // BWD_KV_TILE) * h * b
        assert splits >= 1 and (splits == 1 or items * splits <= sms)
        for k0 in range(0, sk, BWD_KV_TILE):
            for causal in (False, True):
                ranges = split_ranges(sq, splits, k0, causal)
                covered = torch.zeros(sq, dtype=torch.int64)
                for lo, hi in ranges:
                    covered[lo:hi] += 1
                first = min(k0 // 128 * 128, sq) if causal else 0
                assert bool((covered[first:] == 1).all()) and bool((covered[:first] == 0).all()), (b, h, sq, sk)
                if not causal:
                    assert all(lo < hi for lo, hi in ranges)  # no empty part without the causal skip


@pytest.mark.parametrize("sms", [H100_SXM_SMS, H100_PCIE_SMS], ids=["sxm", "pcie"])
def test_pick_split_splits_only_the_cross_attention(sms):
    """SDXL's 77-key cross attention fills the card only when split; its
    self attention and Flux's joint attention have work items enough."""
    for label, (b, sq, h, _), sk, opt, per_step in SDXL_TRAIN_ATTENTION + BWD_EXTRA_CASES:
        if per_step or opt.get("timed"):  # the train step's shapes and Flux's
            assert (pick_split(b, h, sq, sk, sms) > 1) == (sk == 77), label


@pytest.mark.parametrize("sms", [H100_SXM_SMS, H100_PCIE_SMS], ids=["sxm", "pcie"])
def test_card_cases_reach_both_k2_paths(sms):
    """The card tests' shapes hold K2 to its plain version with and without
    the split, on either H100."""
    split = {pick_split(b, h, sq, sk, sms) > 1 for b, sq, sk, h, *_ in FLASH_BWD_CARD_CASES}
    assert split == {True, False}

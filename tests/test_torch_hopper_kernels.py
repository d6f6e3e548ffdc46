"""The arithmetic of the port's Hopper kernels K1 and K5, on the CPU.

K1 (`csrc/flash_attention_fwd.cu`) cannot run here, so its rounding order is
emulated in PyTorch: f32 logits scaled by the f32 product ``scale *
log2(e)``, an online softmax over 128-key tiles in base 2 (``p = exp2(x -
m)``), P rounded to the input type before P.v while the row sum stays f32,
the output rounded once, the LSE ``m ln(2) + ln(l)``. The emulation is held
element by element to `chip_smoke.attention_bounds` (the limit the card
checks hold the kernel to) and, where the JAX kernel tiles the lengths, to
JAX's `_flash_fwd_bhsd` in interpret mode on the same inputs (which is held
to the same bound, and whose LSE agrees within 1e-4: f32 on both sides, exp
against exp2). A control shows the bound rejects a kernel that drops the
last, ragged kv tile.

K5's tile picker (`pick_tile`) must return, for each Flux.1-dev w8a8 shape,
one of the kernel's tiles whose BN divides N, and the card tests' shapes must
reach every tile.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import FLUX_W8A8_SHAPES, W8A8_TILE_CASES, attention_bounds
from diffusers_tpu.ops.pallas.flash_attention_bwd import _flash_fwd_bhsd
from diffusers_tpu_torch.ops.cuda.flash_attention import NEG_INF, flash_attention_plain
from diffusers_tpu_torch.ops.cuda.w8a8_matmul import TILES, pick_tile
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

LOG2E = 1.4426950408889634
BLOCK_N = 128
H100_SXM_SMS, H100_PCIE_SMS = 132, 114  # streaming multiprocessors


def _emulated_k1(q, k, v, scale, is_causal=False, mask=None, drop_last_tile=False):
    """K1's arithmetic on BSHD q/k/v (and an additive f32 mask broadcastable
    to [B, H, Sq, Sk]): (out in the input dtype, f32 LSE [B, H, Sq])."""
    dt = q.dtype
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scale32 = torch.tensor(scale, dtype=torch.float32)
    log2e = torch.tensor(LOG2E, dtype=torch.float32)
    if is_causal or mask is not None:  # these instances scale, mask, then convert to log2 units
        x = s * scale32
        if mask is not None:
            x = x + mask
        if is_causal:
            row = torch.arange(sq)[:, None]
            col = torch.arange(sk)[None, :]
            x = torch.where(row >= col, x, NEG_INF)
        x = x * log2e
    else:
        x = s * (scale32 * log2e)
    m = torch.full(x.shape[:-1], float(torch.tensor(NEG_INF, dtype=torch.float32) * log2e))
    l = torch.zeros(x.shape[:-1])
    o = torch.zeros(*x.shape[:-1], q.shape[-1])
    n_tiles = -(-sk // BLOCK_N) - int(drop_last_tile)
    for j in range(n_tiles):
        xt = x[..., j * BLOCK_N:(j + 1) * BLOCK_N]
        m_new = torch.maximum(m, xt.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(xt - m_new[..., None])
        l = l * corr + p.sum(-1)
        vt = v[:, j * BLOCK_N:(j + 1) * BLOCK_N].float()
        o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p.to(dt).float(), vt)
        m = m_new
    out = (o / l[..., None]).to(dt).transpose(1, 2)
    return out, m * math.log(2) + torch.log(l)


def _inputs(seed, b, sq, sk, h, d, dtype):
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(2 * rng.randn(b, sq, h, d).astype(np.float32)).to(dtype)
    k, v = (torch.from_numpy(rng.randn(b, sk, h, d).astype(np.float32)).to(dtype) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize(
    "d,dtype,causal",
    [(64, torch.bfloat16, False), (128, torch.bfloat16, False), (128, torch.float16, False),
     (64, torch.bfloat16, True)],
    ids=["bf16-d64", "bf16-d128", "fp16-d128", "bf16-d64-causal"],
)
def test_k1_emulation_holds_to_the_bound_and_to_jax(d, dtype, causal):
    q, k, v = _inputs(0, 1, 256, 256, 2, d, dtype)
    scale = 1.0 / math.sqrt(d)
    out, lse = _emulated_k1(q, k, v, scale, causal)
    ref, bound, _ = attention_bounds(q, k, v, is_causal=causal)
    assert bool(((out.float() - ref).abs() <= bound).all())
    _, ref_lse = flash_attention_plain(q.float(), k.float(), v.float(), is_causal=causal, return_lse=True)
    assert float((lse - ref_lse).abs().max()) <= 1e-4

    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    bhsd = [jnp.asarray(t.float().numpy().transpose(0, 2, 1, 3), dtype=jdt) for t in (q, k, v)]
    j_out, j_lse = _flash_fwd_bhsd(*bhsd, None, scale=scale, is_causal=causal, block_q=128, block_k=128,
                                   interpret=True, need_lse=True)
    j_out = torch.from_numpy(np.asarray(j_out, dtype=np.float32).transpose(0, 2, 1, 3))
    assert bool(((j_out - ref).abs() <= bound).all())
    assert float((lse - torch.from_numpy(np.array(j_lse))).abs().max()) <= 1e-4


@pytest.mark.parametrize("sk", [1, 77, 300])
def test_k1_emulation_holds_at_ragged_lengths(sk):
    """Sq and Sk that are not multiples of 128 (the zero-filled tail of the
    last kv tile takes no weight); the JAX kernel does not tile these."""
    q, k, v = _inputs(1, 2, 130, sk, 2, 64, torch.bfloat16)
    out, _ = _emulated_k1(q, k, v, 0.125)
    ref, bound, _ = attention_bounds(q, k, v)
    assert bool(((out.float() - ref).abs() <= bound).all())


@pytest.mark.parametrize("hidden", [-math.inf, torch.finfo(torch.float32).min], ids=["-inf", "finfo.min"])
def test_k1_emulation_holds_when_a_mask_hides_the_first_kv_tile(hidden):
    """An additive mask that hides the first 160 keys (more than one 128-key
    tile) of every other row: the running max starts at the finite masked
    logit, so the hidden tile adds nothing and the output stays finite, within
    the bound and equal to JAX's kernel (interpret mode) within it."""
    q, k, v = _inputs(3, 1, 256, 256, 2, 64, torch.bfloat16)
    mask = torch.zeros(1, 1, 256, 256)
    mask[:, :, ::2, :160] = hidden
    out, lse = _emulated_k1(q, k, v, 0.125, mask=mask)
    ref, bound, _ = attention_bounds(q, k, v, attn_mask=mask)
    assert bool(torch.isfinite(out.float()).all()) and bool(torch.isfinite(lse).all())
    assert bool(((out.float() - ref).abs() <= bound).all())

    bhsd = [jnp.asarray(t.float().numpy().transpose(0, 2, 1, 3), dtype=jnp.bfloat16) for t in (q, k, v)]
    j_mask = jnp.asarray(mask.expand(1, 2, 256, 256).numpy())
    j_out, _ = _flash_fwd_bhsd(*bhsd, j_mask, scale=0.125, is_causal=False, block_q=128, block_k=128,
                               interpret=True, need_lse=True)
    j_out = torch.from_numpy(np.asarray(j_out, dtype=np.float32).transpose(0, 2, 1, 3))
    assert bool(((j_out - ref).abs() <= bound).all())


def test_k1_bound_rejects_a_dropped_last_kv_tile():
    q, k, v = _inputs(2, 1, 128, 300, 2, 64, torch.bfloat16)
    ref, bound, _ = attention_bounds(q, k, v)
    dropped, _ = _emulated_k1(q, k, v, 0.125, drop_last_tile=True)
    assert not bool(((dropped.float() - ref).abs() <= bound).all())


@pytest.mark.parametrize("m,k,n", [s[:3] for s in FLUX_W8A8_SHAPES])
def test_k5_tile_picker_covers_the_flux_shapes(m, k, n):
    bm, bn = pick_tile(m, n, H100_SXM_SMS)
    assert (bm, bn) in TILES and n % bn == 0
    tiles = -(-m // bm) * (n // bn)
    assert tiles * bm >= m * (n // bn) and -(-m // bm) <= 65535
    if m <= 64:  # weight-bound: the narrower tile streams the weight on the most SMs
        assert (bm, bn) == (128, 128)


@pytest.mark.parametrize("sms", [H100_SXM_SMS, H100_PCIE_SMS], ids=["sxm", "pcie"])
def test_k5_tile_cases_reach_every_tile(sms):
    """The card tests' shapes (`W8A8_TILE_CASES`) hold every tile K5 can take
    to its plain version, on either H100."""
    assert {pick_tile(m, n, sms) for m, n in W8A8_TILE_CASES} == set(TILES)

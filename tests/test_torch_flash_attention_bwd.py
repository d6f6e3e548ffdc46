"""The port's differentiable flash attention (`FlashAttentionFunction`, the
counterpart of JAX's `flash_attention_vjp`) and the plain version of kernels
K2/K3 against the JAX package on the CPU.

On the CPU the Function's forward is K1's plain version and its backward
`flash_attention_bwd_plain` (on the card: K1, then K2 and K3). The JAX side
runs its Pallas kernels in interpret mode, or its native attention for the
77-token ragged case that its kernel does not tile (non-causal only: JAX's
native causal mask is bottom-right aligned, the kernels' top-left, ROADMAP C).
Tolerance: `atol 5e-4` on outputs and grads, as tests/test_flash_attention_bwd.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import attention_bwd_bounds
from diffusers_tpu.ops.attention import _native_attention as jax_native_attention
from diffusers_tpu.ops.pallas.flash_attention_bwd import _flash_bwd_bhsd, _flash_fwd_bhsd
from diffusers_tpu.ops.pallas.flash_attention_bwd import flash_attention_full as jax_flash_attention_full
from diffusers_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_bwd_plain,
    flash_attention_full,
    flash_attention_plain,
)
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

ATOL = 5e-4


def _inputs(seed, b, sq, sk, h, d, masked):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k = rng.randn(b, sk, h, d).astype(np.float32)
    v = rng.randn(b, sk, h, d).astype(np.float32)
    g = rng.randn(b, sq, h, d).astype(np.float32)
    mask = np.where(rng.rand(b, 1, sq, sk) < 0.3, -1e4, 0.0).astype(np.float32) if masked else None
    return q, k, v, g, mask


def _port_grads(q, k, v, g, mask, is_causal):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention_full(tq, tk, tv, attn_mask=None if mask is None else torch.from_numpy(mask),
                               is_causal=is_causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    return out.detach().numpy(), [x.numpy() for x in grads]


@pytest.mark.parametrize(
    "sq,sk,d,causal,masked",
    [(128, 128, 64, False, False), (128, 128, 128, False, False), (128, 128, 64, True, False),
     (128, 128, 128, False, True), (256, 128, 64, False, False), (256, 128, 64, True, False)],
    ids=["plain-d64", "plain-d128", "causal", "masked-d128", "rect", "rect-causal"],
)
def test_function_grads_match_jax_pallas_interpret(sq, sk, d, causal, masked):
    q, k, v, g, mask = _inputs(0, 1, sq, sk, 2, d, masked)
    jmask = None if mask is None else jnp.asarray(mask)

    def f(q, k, v):
        return jax_flash_attention_full(q, k, v, attn_mask=jmask, is_causal=causal, block_q=128, block_k=128,
                                        interpret=True)

    ref, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    ref_grads = vjp(jnp.asarray(g))
    out, grads = _port_grads(q, k, v, g, mask, causal)
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)
    for name, a, b in zip(("dq", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("sq,masked", [(256, False), (77, True)], ids=["cross-256x77", "self-77-masked"])
def test_function_grads_match_jax_native_at_77_tokens(sq, masked):
    """SDXL's 77-token text length, which the JAX kernel does not tile."""
    q, k, v, g, mask = _inputs(1, 2, sq, 77, 2, 64, masked)
    jmask = None if mask is None else jnp.asarray(mask)
    ref, vjp = jax.vjp(lambda q, k, v: jax_native_attention(q, k, v, attn_mask=jmask),
                       *(jnp.asarray(a) for a in (q, k, v)))
    ref_grads = vjp(jnp.asarray(g))
    out, grads = _port_grads(q, k, v, g, mask, False)
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)
    for name, a, b in zip(("dq", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False), (False, True)],
                         ids=["plain", "causal", "masked"])
def test_bwd_plain_matches_jax_flash_bwd_bhsd(causal, masked):
    """`flash_attention_bwd_plain` (K2/K3's plain version) against the
    Pallas backward kernels on the same (q, k, v, mask, out, lse, dO)."""
    q, k, v, g, mask = _inputs(2, 1, 256, 128, 2, 64, masked)
    scale = 0.125
    bhsd = [jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v, g)]
    jmask = None if mask is None else jnp.broadcast_to(jnp.asarray(mask), (1, 2, 256, 128))
    out, lse = _flash_fwd_bhsd(*bhsd[:3], jmask, scale=scale, is_causal=causal, block_q=128, block_k=128,
                               interpret=True, need_lse=True)
    ref = _flash_bwd_bhsd(*bhsd[:3], jmask, out, lse, bhsd[3], scale=scale, is_causal=causal, block_q=128,
                          block_k=128, interpret=True)
    out_bshd = torch.from_numpy(np.array(out).transpose(0, 2, 1, 3))
    grads = flash_attention_bwd_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                      None if mask is None else torch.from_numpy(mask), out_bshd,
                                      torch.from_numpy(np.array(lse)), torch.from_numpy(g), scale, causal)
    for name, a, b in zip(("dq", "dk", "dv"), grads, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).transpose(0, 2, 1, 3), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("causal,masked", [(False, True), (True, False)], ids=["masked", "causal"])
def test_function_grads_equal_autograd_through_the_plain_version(causal, masked):
    """The Function's hand-written backward against autograd through K1's
    plain version (f32 math on both sides, summed in other orders: 1e-5)."""
    q, k, v, g, mask = _inputs(3, 2, 50, 70, 3, 64, masked)
    out, grads = _port_grads(q, k, v, g, mask, causal)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ref = flash_attention_plain(tq, tk, tv, attn_mask=None if mask is None else torch.from_numpy(mask),
                                is_causal=causal)
    ref_grads = torch.autograd.grad(ref, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(out, ref.detach().numpy(), atol=1e-5)
    for a, b in zip(grads, ref_grads):
        np.testing.assert_allclose(a, b.numpy(), atol=1e-5)


def test_forward_only_path_keeps_no_graph_and_no_lse():
    q, k, v, _, _ = _inputs(4, 1, 64, 64, 2, 64, False)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = flash_attention_full(tq, tk, tv)
    assert out.grad_fn is None and isinstance(out, torch.Tensor)
    with torch.no_grad():
        out2 = flash_attention_full(tq.requires_grad_(), tk, tv)
    assert out2.grad_fn is None
    torch.testing.assert_close(out, out2, rtol=0, atol=0)


def _emulated_kernel_grads(q, k, v, out, lse, grad_out):
    """K2/K3's arithmetic on the CPU: f32 sums of products of the inputs, P
    in base 2 with the scale folded into log2(e) (``exp2(s scale log2(e) -
    lse log2(e))``), P and dS rounded to the input dtype before their
    products, the outputs rounded once. (Sq <= 128 here: K2 takes no query
    split; `tests/test_torch_hopper_bwd.py` emulates the split.)"""
    dt, scale = q.dtype, q.shape[-1] ** -0.5
    qf, kf, vf, dof = (t.float() for t in (q, k, v, grad_out))
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    p = torch.exp2(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * (torch.tensor(scale, dtype=torch.float32) * log2e)
                   - (lse * log2e)[..., None])
    delta = (dof * out.float()).sum(-1).transpose(1, 2)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta[..., None]) * scale
    p, ds = p.to(dt).float(), ds.to(dt).float()
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kf).to(dt), torch.einsum("bhqk,bqhd->bkhd", ds, qf).to(dt),
            torch.einsum("bhqk,bqhd->bkhd", p, dof).to(dt))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(3, 1, 5, 1, 64), (2, 77, 77, 2, 64)], ids=["1x5", "77x77"])
def test_backward_bound_holds_for_the_emulated_kernel(dtype, shape):
    """`chip_smoke.attention_bwd_bounds`, which the card checks hold K2/K3
    to, is not broken by the kernels' own roundings (emulated here over 20
    seeds, including fp16 grads that go subnormal at Sq = 1), and is broken by
    rounding the outputs to half the precision."""
    b, sq, sk, h, d = shape
    for seed in range(20):
        gen = torch.Generator().manual_seed(seed)
        q = (torch.randn(b, sq, h, d, generator=gen) * 2).to(dtype)
        k, v, grad_out = (torch.randn(b, n, h, d, generator=gen).to(dtype) for n in (sk, sk, sq))
        out, lse = flash_attention_plain(q.float(), k.float(), v.float(), return_lse=True)
        out = out.to(dtype)
        refs, bounds, _ = attention_bwd_bounds(q, k, v, out, lse, grad_out)
        for g, ref, bound in zip(_emulated_kernel_grads(q, k, v, out, lse, grad_out), refs, bounds):
            assert bool(((g.float() - ref).abs() <= bound).all()), seed
    coarse = [(r * 2**4).round() / 2**4 for r in refs]  # 4 fractional bits
    assert not all(bool(((c - r).abs() <= bd).all()) for c, r, bd in zip(coarse, refs, bounds))

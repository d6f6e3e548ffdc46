"""The port's forward-only `flash_attention` (the counterpart of K6,
`diffusers_tpu/ops/pallas/flash_attention.py`) against the JAX Pallas kernel
in interpret mode on the CPU, in the cases of tests/test_flash_attention.py.

On the CPU the port takes K1's plain version (on the card, K1's kernel).
Tolerances are the JAX tests' own: float32 `2e-5` absolute (summation order
and the kernel's online softmax); bf16 `2e-2` (the JAX kernel rounds each
probability to bf16 before P.v, the plain version keeps it f32, and both
round the output to bf16: a few bf16 ulps at outputs of order 1). JAX sends
a causal call at lengths its kernel does not tile to its native backend,
whose causal mask is bottom-right aligned where the kernel's is top-left; the
port routes such a call the same way (`test_flash_attention_routes_causal_
calls_as_jax`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.ops.pallas.flash_attention import flash_attention as jax_flash_attention
from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention, flash_attention_full
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "case",
    [dict(), dict(is_causal=True), dict(scale=0.5), dict(dtype="bfloat16"), dict(d=64, is_causal=True)],
    ids=["plain", "causal", "custom-scale", "bf16", "causal-d64"],
)
def test_flash_attention_matches_pallas_interpret(case):
    rng = np.random.RandomState(0)
    b, s, h, d = 2, 256, 2, case.get("d", 128)
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    dtype = case.get("dtype", "float32")
    jq, jk, jv = (jnp.asarray(a, dtype=dtype) for a in (q, k, v))
    ref = jax_flash_attention(jq, jk, jv, scale=case.get("scale"), is_causal=case.get("is_causal", False),
                              block_q=128, block_k=128, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v))
    flash_attention_full.launches = 0
    out = flash_attention(tq, tk, tv, scale=case.get("scale"), is_causal=case.get("is_causal", False))
    assert flash_attention_full.launches == 0  # a CPU tensor takes the plain version
    assert out.dtype == tq.dtype and out.shape == tq.shape
    atol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, dtype=np.float32), atol=atol)


@pytest.mark.parametrize("sq,sk", [(200, 300), (256, 256)], ids=["untiled-to-native", "tiled-k1"])
def test_flash_attention_routes_causal_calls_as_jax(sq, sk):
    """Causal at Sq=200, Sk=300: JAX's guard (`flash_attention.py:137`) sends
    the call to `_native_attention`, bottom-right aligned, and so does the
    port (its `native` backend). Causal at Sq=Sk=256 stays on the kernel's
    function (K1's plain version here, K1 on the card)."""
    rng = np.random.RandomState(1)
    q = rng.randn(1, sq, 2, 128).astype(np.float32)
    k, v = (rng.randn(1, sk, 2, 128).astype(np.float32) for _ in range(2))
    ref = jax_flash_attention(*map(jnp.asarray, (q, k, v)), is_causal=True, block_q=128, block_k=128,
                              interpret=True)
    out = flash_attention(*map(torch.from_numpy, (q, k, v)), is_causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)

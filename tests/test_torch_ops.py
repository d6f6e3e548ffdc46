"""Port ops (`diffusers_tpu_torch.ops`) against the JAX package on the CPU.

The kernels' plain versions are what CPU tensors take, so these tests hold the
port's flash-attention and GroupNorm(+SiLU) to the JAX Pallas kernels run in
interpret mode, at the JAX tests' tolerances (flash `2e-5`, as
tests/test_flash_attention_bwd.py; GroupNorm `5e-4`, as
tests/test_group_norm_kernel.py). The CUDA kernels themselves are checked
against the same plain versions on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.ops import module as jmod
from diffusers_tpu.ops.attention import _native_attention as jax_native_attention
from diffusers_tpu.ops.pallas.flash_attention_bwd import _flash_attention_fwd_impl, _flash_bwd_bhsd
from diffusers_tpu.ops.pallas.flash_attention_bwd import flash_attention_full as jax_flash_attention_full
from diffusers_tpu.ops.pallas.group_norm import group_norm_silu_nhwc
from diffusers_tpu_torch.models.modeling_utils import load_jax_params
from diffusers_tpu_torch.ops import module as tmod
from diffusers_tpu_torch.ops.attention import _auto_backend, dispatch_attention_fn
from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention_bwd, flash_attention_full
from diffusers_tpu_torch.ops.cuda.group_norm import group_norm
from test_torch_jit_reference import numpy_params
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

FLASH_ATOL = 2e-5
GN_ATOL = 5e-4
ROOT = Path(__file__).resolve().parents[1]


def _qkv(b=1, s=256, h=2, d=64, sk=None, seed=0):
    rng = np.random.RandomState(seed)
    sk = sk or s
    return tuple((rng.randn(b, n, h, d) * 0.3).astype(np.float32) for n in (s, sk, sk))


def _to_torch(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


@pytest.fixture(autouse=True)
def _reset_launch_counts():
    flash_attention_full.launches = 0
    group_norm.launches = 0
    yield
    # CPU tensors take the plain versions: no kernel may have launched
    assert flash_attention_full.launches == 0
    assert group_norm.launches == 0


# ---------------------------------------------------------------- flash (K1)


def _random_mask(kind, shape, seed=1):
    rng = np.random.RandomState(seed)
    if kind == "additive":
        return np.where(rng.rand(*shape) < 0.3, -1e9, 0.0).astype(np.float32)
    return rng.rand(*shape) >= 0.3  # bool keep-mask; no row is fully masked at 256 keys


@pytest.mark.parametrize(
    "case",
    [
        dict(),
        dict(mask="additive", mask_shape=(1, 1, 256, 256)),
        dict(mask="additive", mask_shape=(1, 2, 256, 256)),
        dict(mask="bool", mask_shape=(1, 1, 256, 256)),
        dict(causal=True),
        dict(d=128, s=128, sk=384),
        dict(scale=0.3),
    ],
    ids=["plain", "additive-mask", "additive-mask-per-head", "bool-mask", "causal", "d128-cross", "scale"],
)
def test_flash_plain_matches_pallas_interpret(case):
    q, k, v = _qkv(s=case.get("s", 256), d=case.get("d", 64), sk=case.get("sk"))
    mask = _random_mask(case["mask"], case["mask_shape"]) if "mask" in case else None
    causal = case.get("causal", False)
    scale = case.get("scale")
    ref = jax_flash_attention_full(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        attn_mask=None if mask is None else jnp.asarray(mask), scale=scale, is_causal=causal,
        block_q=128, block_k=128, interpret=True,
    )
    tq, tk, tv = _to_torch(q, k, v)
    out = flash_attention_full(tq, tk, tv, attn_mask=None if mask is None else torch.from_numpy(mask),
                               scale=scale, is_causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FLASH_ATOL)


def test_flash_plain_lse_matches_pallas_interpret():
    q, k, v = _qkv()
    ref_out, ref_lse = _flash_attention_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                 None, 0.125, False, 128, 128, True)
    out, lse = flash_attention_full(*_to_torch(q, k, v), scale=0.125, return_lse=True)
    assert lse.shape == (1, 2, 256) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=FLASH_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=FLASH_ATOL)


def _masked_row_case():
    """q/k/v [1, 128, 1, 64] f32 and a grad, with finfo.min added to every key
    of query row 5: every logit of that row lies below NEG_INF."""
    rng = np.random.RandomState(6)
    q, k, v, do = (rng.randn(1, 128, 1, 64).astype(np.float32) for _ in range(4))
    mask = np.zeros((1, 1, 128, 128), np.float32)
    mask[0, 0, 5, :] = np.finfo(np.float32).min
    return q, k, v, do, mask


def test_flash_plain_fully_masked_row_matches_pallas_interpret():
    """A row whose every logit a finfo.min mask hides: `_fwd_kernel`'s running
    max starts at NEG_INF, so its sum is 0, its output NaN and its LSE -inf.
    K1's plain version follows that rule (K1 does the same on the card); the
    other rows agree to the flash tolerance. The `native` backends keep their
    own rule (a plain softmax: the mean of v), in JAX as in the port."""
    q, k, v, _, mask = _masked_row_case()
    ref_out, ref_lse = _flash_attention_fwd_impl(*map(jnp.asarray, (q, k, v, mask)), 0.125, False, 128, 128, True)
    out, lse = flash_attention_full(*_to_torch(q, k, v), attn_mask=torch.from_numpy(mask), scale=0.125,
                                    return_lse=True)
    assert np.isnan(out.numpy()[0, 5]).all() and not np.isnan(np.delete(out.numpy(), 5, axis=1)).any()
    assert np.isneginf(lse.numpy()[0, 0, 5])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=FLASH_ATOL, equal_nan=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse).reshape(lse.shape), atol=FLASH_ATOL, equal_nan=True)


def test_flash_bwd_plain_fully_masked_row_matches_pallas_interpret():
    """The backward on that row (each side on its own forward's out and LSE):
    JAX's `_flash_bwd_bhsd` gives p = exp(s - lse) = +inf on the row and a
    NaN delta, so NaN dq on the row, NaN dk everywhere and +-inf dv; the
    port's plain backward gives the same pattern, and the finite elements
    agree to the grad tolerance."""
    q, k, v, do, mask = _masked_row_case()
    jq, jk, jv, jdo = (jnp.transpose(jnp.asarray(a), (0, 2, 1, 3)) for a in (q, k, v, do))
    ref_out, ref_lse = _flash_attention_fwd_impl(*map(jnp.asarray, (q, k, v, mask)), 0.125, False, 128, 128, True)
    refs = _flash_bwd_bhsd(jq, jk, jv, jnp.asarray(mask), jnp.transpose(ref_out, (0, 2, 1, 3)),
                           ref_lse.reshape(1, 1, 128), jdo, scale=0.125, is_causal=False, block_q=128,
                           block_k=128, interpret=True)
    tq, tk, tv, tdo = _to_torch(q, k, v, do)
    tmask = torch.from_numpy(mask)
    out, lse = flash_attention_full(tq, tk, tv, attn_mask=tmask, scale=0.125, return_lse=True)
    grads = flash_attention_bwd(tq, tk, tv, tmask, out, lse, tdo, scale=0.125)
    for name, g, ref in zip(("dq", "dk", "dv"), grads, refs):
        ref = np.transpose(np.asarray(ref), (0, 2, 1, 3))
        assert not np.isfinite(ref).all(), name
        np.testing.assert_allclose(g.numpy(), ref, atol=5e-4, equal_nan=True, err_msg=name)


def test_flash_plain_ragged_lengths_match_native():
    """Lengths the Pallas kernel does not tile (it falls back to native there)
    are plain attention for the port: compare with JAX's native backend."""
    q, k, v = _qkv(s=100, sk=77)
    ref = jax_native_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = flash_attention_full(*_to_torch(q, k, v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FLASH_ATOL)


# --------------------------------------------------------- GroupNorm (K4)


@pytest.mark.parametrize(
    "shape,groups,silu",
    [((2, 16, 16, 256), 32, True), ((2, 16, 16, 256), 32, False), ((1, 8, 16, 128), 16, False), ((1, 8, 8, 128), 32, True)],
)
def test_group_norm_plain_matches_pallas_interpret(shape, groups, silu):
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)  # NHWC
    c = shape[-1]
    scale = rng.randn(c).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    ref = group_norm_silu_nhwc(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups,
                               eps=1e-6, apply_silu=silu, interpret=True)
    x_nchw = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    out = group_norm(x_nchw, torch.from_numpy(scale), torch.from_numpy(bias), groups, eps=1e-6, apply_silu=silu)
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), np.asarray(ref), atol=GN_ATOL)


def test_wrappers_raise_on_devices_without_a_kernel():
    x = torch.empty(2, 32, 4, 4, device="meta")
    with pytest.raises(ValueError, match="device"):
        group_norm(x, None, None, 8)
    q = torch.empty(1, 16, 2, 64, device="meta")
    with pytest.raises(ValueError, match="sm_90a"):
        flash_attention_full(q, q, q)


# ------------------------------------------------------------- leaf modules


def _jax_and_torch(jax_module, torch_module, seed=0):
    params = numpy_params(jax_module, seed)
    rng = np.random.RandomState(seed)
    # jitter the 1-D leaves so norm scales/biases are not the trivial 1/0
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.1 * rng.randn(*a.shape).astype(np.float32) if a.ndim == 1 else 0), params)
    load_jax_params(torch_module, tree)
    return jax.tree_util.tree_map(jnp.asarray, tree), torch_module


@pytest.mark.parametrize("use_bias", [True, False])
def test_linear_matches_jax(use_bias):
    params, tm = _jax_and_torch(jmod.Linear(24, 40, use_bias=use_bias), tmod.Linear(24, 40, use_bias=use_bias))
    x = np.random.RandomState(2).randn(3, 5, 24).astype(np.float32)
    ref = jmod.Linear(24, 40, use_bias=use_bias)(params, jnp.asarray(x))
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("kernel_size,stride,padding", [(3, 1, 1), (3, 2, 1), (1, 1, 0), (3, 2, 0)])
def test_conv2d_matches_jax(kernel_size, stride, padding):
    jm = jmod.Conv2d(8, 16, kernel_size=kernel_size, stride=stride, padding=padding)
    params, tm = _jax_and_torch(jm, tmod.Conv2d(8, 16, kernel_size=kernel_size, stride=stride, padding=padding))
    x = np.random.RandomState(3).randn(2, 8, 12, 12).astype(np.float32)  # NCHW
    ref = np.asarray(jm(params, jnp.asarray(x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 96, 5, 7), (2, 64, 9)])
def test_group_norm_module_matches_jax(shape):
    c = shape[1]
    jm = jmod.GroupNorm(32, c, eps=1e-6)
    params, tm = _jax_and_torch(jm, tmod.GroupNorm(32, c, eps=1e-6))
    x = (np.random.RandomState(4).randn(*shape) * 3 + 1).astype(np.float32)
    channels_last = np.moveaxis(x, 1, -1)
    ref = np.moveaxis(np.asarray(jm(params, jnp.asarray(channels_last))), -1, 1)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, atol=GN_ATOL)


def test_layer_norm_and_embedding_match_jax():
    params, tm = _jax_and_torch(jmod.LayerNorm(48, eps=1e-5), tmod.LayerNorm(48, eps=1e-5))
    x = np.random.RandomState(5).randn(2, 7, 48).astype(np.float32) * 2
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jmod.LayerNorm(48)(params, jnp.asarray(x))), atol=1e-5)

    eparams, te = _jax_and_torch(jmod.Embedding(50, 16), tmod.Embedding(50, 16))
    ids = np.array([[0, 3, 49], [7, 7, 1]])
    with torch.no_grad():
        out = te(torch.from_numpy(ids))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jmod.Embedding(50, 16)(eparams, jnp.asarray(ids))))


@pytest.mark.parametrize("name", ["silu", "swish", "gelu", "gelu_tanh", "quick_gelu", "relu", "mish"])
def test_activations_match_jax(name):
    x = np.linspace(-6, 6, 101).astype(np.float32)
    ref = np.asarray(jmod.get_activation(name)(jnp.asarray(x)))
    np.testing.assert_allclose(tmod.get_activation(name)(torch.from_numpy(x)).numpy(), ref, atol=1e-6)


# ----------------------------------------------------------------- dispatch


@pytest.mark.parametrize("case", ["plain", "causal-sq-ne-sk", "bool-mask", "cross"])
def test_dispatch_on_cpu_picks_native_and_matches_jax_native(case):
    # native's causal is bottom-right aligned; Sq != Sk exercises that
    s, sk = {"plain": (64, 64), "causal-sq-ne-sk": (48, 64), "bool-mask": (64, 96), "cross": (64, 96)}[case]
    q, k, v = _qkv(s=s, sk=sk)
    mask = _random_mask("bool", (1, 1, q.shape[1], k.shape[1])) if case == "bool-mask" else None
    causal = case == "causal-sq-ne-sk"
    tq, tk, tv = _to_torch(q, k, v)
    assert _auto_backend(tq, tk, tv) == "native"
    out = dispatch_attention_fn(tq, tk, tv, attn_mask=None if mask is None else torch.from_numpy(mask),
                                is_causal=causal)
    ref = jax_native_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               attn_mask=None if mask is None else jnp.asarray(mask), is_causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FLASH_ATOL)


def test_import_loads_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import diffusers_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(diffusers_tpu_torch.__path__, 'diffusers_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'diffusers_tpu_torch.pipelines.flux.pipeline_flux' in names, names\n"
        "assert 'diffusers_tpu_torch.ops.cuda.w8a8_matmul' in names, names\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'diffusers_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr

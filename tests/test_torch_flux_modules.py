"""The port's Flux building blocks against the JAX package on the CPU:
RMSNorm, the AdaLN norms, FluxPosEmbed + apply_rotary_emb, GELUProj and the
gelu(-approximate) FeedForward, the pooled-text projection and the
time/guidance/text embeddings.

Parameters are initialised in JAX, the 1-D leaves jittered (so norm scales
and biases are not the trivial 1/0), and carried into the port with
`load_jax_params`; inputs are seeded numpy arrays. float32 on both sides, no
quantization: the differences are summation order and the f32 transcendental
implementations, held to `1e-5` (outputs of order 1). The host RoPE tables are
the same float64 numpy code and must agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.models import attention_blocks as jblocks
from diffusers_tpu.models import embeddings as jemb
from diffusers_tpu.models import normalization as jnorm
from diffusers_tpu.ops import module as jmod
from diffusers_tpu_torch.models import attention_blocks as tblocks
from diffusers_tpu_torch.models import embeddings as temb
from diffusers_tpu_torch.models import normalization as tnorm
from diffusers_tpu_torch.models.modeling_utils import load_jax_params
from diffusers_tpu_torch.ops import module as tmod
from test_torch_jit_reference import numpy_params
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

ATOL = 1e-5


def _carry(jax_module, torch_module, seed=0):
    params = numpy_params(jax_module, seed)
    rng = np.random.RandomState(seed)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.1 * rng.randn(*a.shape).astype(np.float32) if a.ndim == 1 else 0), params)
    if tree:
        load_jax_params(torch_module, tree)
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _randn(*shape, seed=1, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _close(out, ref, atol=ATOL):
    out = [o.detach().numpy() for o in (out if isinstance(out, tuple) else (out,))]
    ref = [np.asarray(r) for r in (ref if isinstance(ref, tuple) else (ref,))]
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o, r, atol=atol)


@pytest.mark.parametrize("use_bias", [False, True])
def test_rms_norm_matches_jax(use_bias):
    jm, tm = jmod.RMSNorm(64, eps=1e-6, use_bias=use_bias), tmod.RMSNorm(64, eps=1e-6, use_bias=use_bias)
    params = _carry(jm, tm)
    x = _randn(2, 5, 3, 64, scale=3.0)
    _close(tm(torch.from_numpy(x)), jm(params, jnp.asarray(x)))


@pytest.mark.parametrize("name", ["zero", "zero-single", "continuous"])
def test_ada_layer_norms_match_jax(name):
    dim = 32
    jm, tm = {
        "zero": (jnorm.AdaLayerNormZero(dim), tnorm.AdaLayerNormZero(dim)),
        "zero-single": (jnorm.AdaLayerNormZeroSingle(dim), tnorm.AdaLayerNormZeroSingle(dim)),
        "continuous": (jnorm.AdaLayerNormContinuous(dim, 48, elementwise_affine=False, eps=1e-6),
                       tnorm.AdaLayerNormContinuous(dim, 48, elementwise_affine=False, eps=1e-6)),
    }[name]
    params = _carry(jm, tm)
    x = _randn(2, 7, dim, scale=2.0) + 0.5
    emb = _randn(2, 48 if name == "continuous" else dim, seed=2)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(emb))
    _close(out, jm(params, jnp.asarray(x), jnp.asarray(emb)))


def test_flux_pos_embed_and_rotary_match_jax():
    axes = (8, 12, 12)
    ids = np.concatenate([np.zeros((4, 3)), np.random.RandomState(0).randint(0, 16, (12, 3))]).astype(np.float32)
    jcos, jsin = jemb.FluxPosEmbed(theta=10000, axes_dim=axes)({}, ids)  # numpy ids: the host f64 path
    tcos, tsin = temb.FluxPosEmbed(theta=10000, axes_dim=axes)(torch.from_numpy(ids))
    np.testing.assert_array_equal(tcos.numpy(), jcos)
    np.testing.assert_array_equal(tsin.numpy(), jsin)
    x = _randn(2, 16, 3, 32, scale=2.0)  # [B, S, H, D]
    ref = jemb.apply_rotary_emb(jnp.asarray(x), jnp.asarray(jcos), jnp.asarray(jsin))
    _close(temb.apply_rotary_emb(torch.from_numpy(x), tcos, tsin), ref)


@pytest.mark.parametrize("activation_fn", ["gelu-approximate", "gelu"])
def test_feed_forward_gelu_matches_jax(activation_fn):
    jm = jblocks.FeedForward(dim=32, dim_out=32, activation_fn=activation_fn)
    tm = tblocks.FeedForward(dim=32, dim_out=32, activation_fn=activation_fn)
    params = _carry(jm, tm)
    x = _randn(2, 6, 32)
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), jm(params, jnp.asarray(x)))


def test_gelu_proj_tanh_matches_jax():
    jm, tm = jblocks.GELUProj(24, 40, approximate="tanh"), tblocks.GELUProj(24, 40, approximate="tanh")
    params = _carry(jm, tm)
    x = _randn(3, 24, scale=3.0)
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), jm(params, jnp.asarray(x)))


@pytest.mark.parametrize("act_fn", ["silu", "gelu_tanh", "silu_fp32"])
def test_pixart_text_projection_matches_jax(act_fn):
    jm = jemb.PixArtAlphaTextProjection(24, 32, act_fn=act_fn)
    tm = temb.PixArtAlphaTextProjection(24, 32, act_fn=act_fn)
    params = _carry(jm, tm)
    x = _randn(2, 24)
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), jm(params, jnp.asarray(x)))


@pytest.mark.parametrize("guidance", [False, True], ids=["time-text", "time-guidance-text"])
def test_combined_time_text_embeddings_match_jax(guidance):
    if guidance:
        jm = jemb.CombinedTimestepGuidanceTextProjEmbeddings(embedding_dim=64, pooled_projection_dim=32)
        tm = temb.CombinedTimestepGuidanceTextProjEmbeddings(embedding_dim=64, pooled_projection_dim=32)
    else:
        jm = jemb.CombinedTimestepTextProjEmbeddings(embedding_dim=64, pooled_projection_dim=32)
        tm = temb.CombinedTimestepTextProjEmbeddings(embedding_dim=64, pooled_projection_dim=32)
    params = _carry(jm, tm)
    t = np.array([700.0, 13.0], np.float32)
    g = np.array([3500.0, 1000.0], np.float32)
    pooled = _randn(2, 32)
    args = (t, g, pooled) if guidance else (t, pooled)
    with torch.no_grad():
        out = tm(*[torch.from_numpy(a) for a in args])
    _close(out, jm(params, *[jnp.asarray(a) for a in args]))

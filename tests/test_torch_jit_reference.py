"""The JAX reference made cheaper to run in the port's parity tests, with
the same results: `JitModule` (sub-calls under `jax.jit`) and `fast_randn`
(JAX's normal draws, bit for bit, compiled once a size bucket).

A JAX pipeline jits its denoise loop but calls its text towers, its VAE's
encode and decode and its image encoders eagerly, op by op; in JAX 0.9 each
op is a small jit of its own, compiled once a shape, so an eager text tower
costs seconds where one jit of it costs a fraction of that. `JitModule` wraps
such a module so that its call, `encode` and `decode` run as one jit each
(array arguments traced, anything else static), returning what the module
returns. The function computed is the module's own.

`jax.random.normal` compiles its threefry hash anew for every shape, which
on the CPU takes 0.5-4 s a shape. Its bits depend only on the key and each
element's flat index, so `fast_normal` draws the bits of a power-of-two
bucket of elements (integer operations, compiled at XLA's backend
optimization level 0, where they are exact and compile in a fraction of the
time) and maps them to normals by JAX's own uniform and `erf_inv` rule,
compiled as JAX compiles it; `fast_randn` is `diffusers_tpu`'s
`randn_tensor` on it. `numpy_params` makes a JAX module's params in numpy
from the shapes of its `init`, which draws through `jax.random`.

The fixture `jax_reference_speedups` (autouse in a module that imports it)
stands `fast_randn` in for `randn_tensor` in the JAX package's loaded
modules for one test, so a JAX pipeline's own eager draws take it too, and
turns on JAX's persistent compilation cache in a directory under the
system's temporary directory that the test workers share: most of a port
test's time is the XLA compile of its JAX reference, and workers compile
many of the same programs. A loaded executable is the one the compile would
give. Both are turned off again after the test.

The tests hold the wrapper's plumbing (traced and static arguments, the
posterior rebuilt from its moments) to a plain `jax.jit` of each method on a
tiny CLIP text tower and a tiny AutoencoderKL, and `fast_randn` to
`randn_tensor`, all bit-equal.
"""

import functools
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from diffusers_tpu.models.autoencoders.vae import DiagonalGaussianDistribution
from diffusers_tpu.utils import jax_utils


def _is_array(v) -> bool:
    """Traced: an array, or a container whose leaves are all arrays."""
    leaves = jax.tree.leaves(v)
    return bool(leaves) and all(isinstance(leaf, (jax.Array, np.ndarray)) for leaf in leaves)


def _posterior(out):
    return getattr(out, "latent_dist", out)


class JitModule:
    """A JAX module whose `__call__`, `encode` and `decode` run under
    `jax.jit`, one compile a (method, static arguments, shapes); `encode`
    returns a `DiagonalGaussianDistribution` over the jitted moments (also as
    its `latent_dist`). Anything else is the module's own."""

    def __init__(self, module):
        self._module = module
        self._fns = {}

    def __getattr__(self, name):
        return getattr(self._module, name)

    def _run(self, method, params, args, kwargs, post=None):
        statics = tuple((i, a) for i, a in enumerate(args) if not _is_array(a))
        static_kw = tuple(sorted((k, v) for k, v in kwargs.items() if not _is_array(v)))
        key = (method, repr(statics), repr(static_kw), len(args))
        if key not in self._fns:
            fixed, fixed_kw, n = dict(statics), dict(static_kw), len(args)

            def fn(p, dyn_args, dyn_kwargs):
                it = iter(dyn_args)
                full = [fixed[i] if i in fixed else next(it) for i in range(n)]
                out = getattr(self._module, method)(p, *full, **dyn_kwargs, **fixed_kw)
                return post(out) if post is not None else out

            self._fns[key] = jax.jit(fn)
        return self._fns[key](params, [a for a in args if _is_array(a)],
                              {k: v for k, v in kwargs.items() if _is_array(v)})

    def __call__(self, params, *args, **kwargs):
        return self._run("__call__", params, args, kwargs)

    def encode(self, params, *args, **kwargs):
        dist = DiagonalGaussianDistribution(
            self._run("encode", params, args, kwargs, post=lambda out: _posterior(out).parameters))
        dist.latent_dist = dist
        return (dist,) if kwargs.get("return_dict", True) is False else dist

    def decode(self, params, *args, **kwargs):
        return self._run("decode", params, args, kwargs)


def numpy_params(jax_module, seed: int = 0):
    """Seeded numpy params of `jax_module`'s tree, shaped by `jax.eval_shape` of
    its `init` (nothing compiled; `init` draws each leaf through
    `jax.random`, a compile a shape): kernels uniform in +-1/sqrt(fan-in),
    embeddings standard normal, scales one, biases zero, as `init` makes
    them."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(seed))

    def leaf(path, spec):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("scale", "weight") and len(spec.shape) == 1:
            return np.ones(spec.shape, np.float32)
        if name == "bias":
            return np.zeros(spec.shape, np.float32)
        if name == "embedding":
            return rng.randn(*spec.shape).astype(np.float32)
        bound = 1.0 / np.sqrt(max(1, int(np.prod(spec.shape[:-1]))))
        return rng.uniform(-bound, bound, spec.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _bits(n: int):
    return jax.jit(lambda key: jax.random.bits(key, (n,), jnp.uint32),
                   compiler_options={"xla_backend_optimization_level": 0})


@functools.lru_cache(maxsize=None)
def _normal_from_bits(n: int):
    """JAX's `_uniform` on [nextafter(-1, 0), 1) and `_normal_real` (`sqrt(2)
    erf_inv(u)`) over float32 bits."""
    lo, hi = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32), np.float32(1.0)

    def fn(bits):
        mantissa = lax.shift_right_logical(bits, jnp.array(32 - 23, jnp.uint32))
        mantissa = lax.bitwise_or(mantissa, jnp.asarray(np.array(1.0, np.float32).view(np.uint32), jnp.uint32))
        floats = lax.bitcast_convert_type(mantissa, jnp.float32) - jnp.array(1.0, jnp.float32)
        u = lax.max(lax.convert_element_type(lo, jnp.float32),
                    floats * (lax.convert_element_type(hi, jnp.float32) - lax.convert_element_type(lo, jnp.float32))
                    + lax.convert_element_type(lo, jnp.float32))
        return lax.mul(np.array(np.sqrt(2), np.float32), lax.erf_inv(u))

    return jax.jit(fn)


def fast_normal(key, shape):
    """`jax.random.normal(key, shape)` in float32, bit for bit, for a
    concrete key (a traced one takes `jax.random.normal` itself)."""
    shape = tuple(int(d) for d in shape)
    if isinstance(key, jax.core.Tracer):
        return jax.random.normal(key, shape, jnp.float32)
    n = int(np.prod(shape, dtype=np.int64))
    bucket = max(1024, 1 << (n - 1).bit_length())
    return _normal_from_bits(bucket)(_bits(bucket)(key))[:n].reshape(shape)


_randn_tensor = jax_utils.randn_tensor


def fast_randn(shape, key=None, dtype=jnp.float32, per_sample=False):
    """`diffusers_tpu.utils.jax_utils.randn_tensor` on `fast_normal`."""
    if key is None or (per_sample and len(shape) > 0 and shape[0] > 1):
        return _randn_tensor(shape, key=key, dtype=dtype, per_sample=per_sample)
    return fast_normal(key, shape).astype(dtype)


SHARED_CACHE_DIR = os.path.join(tempfile.gettempdir(), "diffusers_tpu_torch-tests-jax-cache")
# no size limit: with one, every read and write takes a file lock and rescans the directory; an entry
# read while another worker writes it fails to decompress, which JAX reports and compiles instead
_CACHE_OPTIONS = {"jax_compilation_cache_dir": SHARED_CACHE_DIR,
                  "jax_persistent_cache_min_compile_time_secs": 0.1,
                  "jax_persistent_cache_min_entry_size_bytes": 0}


@pytest.fixture(autouse=True)
def jax_reference_speedups(monkeypatch):
    """For one test: `fast_randn` in place of `randn_tensor` in every loaded
    module of the JAX package that holds it; and JAX's persistent
    compilation cache in SHARED_CACHE_DIR, so that a JAX reference one test
    worker compiled (the same program, options and backend) is loaded by the
    others instead of compiled again. Both are restored after the test, so
    the JAX package's own tests run as they always do."""
    from jax._src import compilation_cache

    for name, module in list(sys.modules.items()):
        if name.startswith("diffusers_tpu.") and getattr(module, "randn_tensor", None) is _randn_tensor:
            monkeypatch.setattr(module, "randn_tensor", fast_randn)
    saved = {name: getattr(jax.config, name) for name in _CACHE_OPTIONS}
    for name, value in _CACHE_OPTIONS.items():
        jax.config.update(name, value)
    compilation_cache.reset_cache()  # JAX decides once whether to use the cache: decide anew
    try:
        yield
    finally:
        for name, value in saved.items():
            jax.config.update(name, value)
        compilation_cache.reset_cache()


def test_fast_randn_matches_randn_tensor():
    key = jax.random.split(jax.random.PRNGKey(11))[1]
    for shape in ((1, 4, 8, 8), (3, 5)):
        ref = np.asarray(_randn_tensor(shape, key=key))
        out = np.asarray(fast_randn(shape, key=key))
        assert out.shape == ref.shape and np.array_equal(out, ref)
    assert np.array_equal(np.asarray(fast_randn((2, 3), key=key, dtype=jnp.bfloat16)).astype(np.float32),
                          np.asarray(_randn_tensor((2, 3), key=key, dtype=jnp.bfloat16)).astype(np.float32))
    assert jax_utils.randn_tensor is fast_randn  # the fixture's stand-in, for this test
    assert jax.config.jax_compilation_cache_dir == SHARED_CACHE_DIR


def test_jit_module_matches_a_plain_jit():
    from diffusers_tpu.models.autoencoders.autoencoder_kl import AutoencoderKL as JaxAutoencoderKL
    from diffusers_tpu.models.text_encoders.clip import CLIPTextModelWithProjection as JaxCLIPProj
    from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
    from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModelWithProjection
    from test_torch_qwenimage import carry, seeded

    clip_cfg = dict(vocab_size=100, hidden_size=16, intermediate_size=32, num_hidden_layers=1, num_attention_heads=2,
                    projection_dim=8)
    jm, params = carry(JaxCLIPProj, seeded(CLIPTextModelWithProjection, clip_cfg, seed=0), clip_cfg)
    ids = jnp.asarray(np.random.RandomState(1).randint(1, 99, (2, 7)))
    ref = jax.jit(lambda p, i: jm(p, i, output_hidden_states=True))(params, ids)
    out = JitModule(jm)(params, ids, output_hidden_states=True)
    assert type(out) is type(ref) and len(out.hidden_states) == 2
    for r, o in zip(jax.tree.leaves(ref), jax.tree.leaves(out)):
        assert np.array_equal(np.asarray(o), np.asarray(r))

    vae_cfg = dict(in_channels=3, out_channels=3, block_out_channels=(8,), down_block_types=("DownEncoderBlock2D",),
                   up_block_types=("UpDecoderBlock2D",), latent_channels=4, layers_per_block=1, norm_num_groups=4)
    jv, vparams = carry(JaxAutoencoderKL, seeded(AutoencoderKL, vae_cfg, seed=2), vae_cfg)
    x = jnp.asarray(np.random.RandomState(3).randn(1, 3, 8, 8).astype(np.float32))
    wrapped = JitModule(jv)
    moments = jax.jit(lambda p, v: _posterior(jv.encode(p, v)).parameters)(vparams, x)
    dist = wrapped.encode(vparams, x)
    assert dist.latent_dist is dist and np.array_equal(np.asarray(dist.parameters), np.asarray(moments))
    assert np.array_equal(np.asarray(dist.mode()), np.asarray(moments[:, :4]))
    z = jnp.asarray(np.random.RandomState(4).randn(1, 4, 8, 8).astype(np.float32))
    ref = jax.jit(lambda p, v: jv.decode(p, v, return_dict=False)[0])(vparams, z)
    assert np.array_equal(np.asarray(wrapped.decode(vparams, z, return_dict=False)[0]), np.asarray(ref))

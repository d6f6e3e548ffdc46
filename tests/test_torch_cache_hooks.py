"""The port's denoise-loop cache hooks (`diffusers_tpu_torch.hooks`) against
the JAX ones (`diffusers_tpu.hooks`), unit by unit on the CPU, on random
numpy inputs from a seed.

Tolerances. The host-made schedules (TaylorSeer, MagCache, FasterCache and
PAB masks and weights, the interpolation, the calibration) are copies and
must be element-equal. The tensor functions run in float32 (complex64 for
FasterCache's spectra) on both sides, where only the order of summation can
differ: `1e-5` relative and absolute (TaylorSeer, FirstBlockCache's change
ratio, the FFT split and FasterCache's rebuilt uncond output, whose FFTs of
a 16 x 16 map sum 256 terms).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusers_tpu.hooks as jhooks
from diffusers_tpu.hooks import faster_cache as jfc
from diffusers_tpu.hooks import first_block_cache as jfbc
from diffusers_tpu.hooks import generic_cache as jgeneric
from diffusers_tpu.hooks import mag_cache as jmag
from diffusers_tpu.hooks import pyramid_attention_broadcast as jpab
from diffusers_tpu.pipelines.flux.pipeline_flux import FluxPipeline as JaxFluxPipeline
from diffusers_tpu.pipelines.stable_diffusion_xl.pipeline_stable_diffusion_xl import (
    StableDiffusionXLPipeline as JaxStableDiffusionXLPipeline,
)
import diffusers_tpu_torch.hooks as hooks
from diffusers_tpu_torch.hooks import faster_cache, first_block_cache, mag_cache, pyramid_attention_broadcast
from diffusers_tpu_torch.hooks.generic_cache import TextKVCacheConfig
from diffusers_tpu_torch.pipelines.flux.pipeline_flux import FluxPipeline
from diffusers_tpu_torch.pipelines.stable_diffusion_xl.pipeline_stable_diffusion_xl import StableDiffusionXLPipeline
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

RTOL = ATOL = 1e-5


def close(out, ref):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=RTOL, atol=ATOL)


TAYLORSEER_CONFIGS = [
    dict(cache_interval=10, disable_cache_before_step=2, max_order=2),
    dict(cache_interval=5, disable_cache_before_step=3),
    dict(cache_interval=5, disable_cache_before_step=3, disable_cache_after_step=10),
    dict(cache_interval=1, disable_cache_before_step=0),
    dict(cache_interval=4, disable_cache_before_step=0, max_order=3),
]


@pytest.mark.parametrize("cfg", TAYLORSEER_CONFIGS, ids=lambda c: "-".join(f"{v}" for v in c.values()))
@pytest.mark.parametrize("num_steps", [1, 8, 30, 50])
def test_taylorseer_mask_is_jaxs(cfg, num_steps):
    out = hooks.taylorseer_compute_mask(num_steps, hooks.TaylorSeerCacheConfig(**cfg))
    ref = jhooks.taylorseer_compute_mask(num_steps, jhooks.TaylorSeerCacheConfig(**cfg))
    assert out.dtype == ref.dtype and np.array_equal(out, ref)


def test_taylorseer_headline_mask():
    """bench.py's headline config computes 5 of 30 steps."""
    mask = hooks.taylorseer_compute_mask(30, hooks.TaylorSeerCacheConfig(10, 2, None, 2))
    assert list(np.nonzero(mask)[0]) == [0, 1, 3, 13, 23]


@pytest.mark.parametrize("max_order", [1, 2, 3])
def test_taylorseer_apply_matches_jax(max_order):
    """A sequence of compute and predict steps (the first step a prediction
    from the empty state), outputs and factors after every step."""
    rng = np.random.RandomState(max_order)
    shape = (2, 4, 6)
    ys = [rng.randn(*shape).astype(np.float32) for _ in range(12)]
    pattern = [False, True, True, False, True, False, False, True, False, False, False, True]
    jstate = jhooks.init_taylorseer_state(shape, max_order)
    state = hooks.init_taylorseer_state(shape, max_order)
    calls = []
    for i, compute in enumerate(pattern):
        ref, jstate = jhooks.taylorseer_apply(jstate, jnp.asarray(i, jnp.int32), jnp.asarray(compute),
                                              lambda i=i: jnp.asarray(ys[i]))
        out, state = hooks.taylorseer_apply(state, i, compute,
                                            lambda i=i: calls.append(i) or torch.from_numpy(ys[i]))
        close(out, ref)
        close(state.factors, jstate.factors)
        assert (state.n_updates, state.last_update_step) == (int(jstate.n_updates), int(jstate.last_update_step))
    # a predicted step never calls the model
    assert calls == [i for i, c in enumerate(pattern) if c]


def test_taylorseer_keeps_the_factor_dtype():
    state = hooks.init_taylorseer_state((3,), 2, torch.bfloat16)
    out, state = hooks.taylorseer_apply(state, 0, True, lambda: torch.ones(3, dtype=torch.bfloat16))
    out, state = hooks.taylorseer_apply(state, 1, False, lambda: None)
    assert state.factors.dtype == out.dtype == torch.bfloat16


def test_mag_cache_masks_are_jaxs():
    ratios = tuple(jhooks.FLUX_MAG_RATIOS)
    assert np.array_equal(hooks.FLUX_MAG_RATIOS, jhooks.FLUX_MAG_RATIOS)
    for kw in [dict(), dict(threshold=0.12, max_skip_steps=2), dict(threshold=0.5, max_skip_steps=1,
                                                                   retention_ratio=0.25)]:
        for n in (8, 20, 28, 50):
            for r in (ratios, (1.0,) * n):
                out = hooks.mag_cache_compute_mask(hooks.MagCacheConfig(num_inference_steps=n, mag_ratios=r, **kw))
                ref = jhooks.mag_cache_compute_mask(jhooks.MagCacheConfig(num_inference_steps=n, mag_ratios=r, **kw))
                assert np.array_equal(out, ref), (kw, n)
    assert hooks.mag_cache_compute_mask(hooks.MagCacheConfig(calibrate=True, num_inference_steps=8)).all()
    with pytest.raises(ValueError, match="mag_ratios"):
        hooks.MagCacheConfig()
    for n in (1, 5, 28, 40):
        assert np.array_equal(mag_cache.nearest_interp(ratios, n), jmag.nearest_interp(np.asarray(ratios), n))
    norms = np.random.RandomState(0).rand(9) + 0.1
    assert mag_cache.mag_cache_calibrate_ratios(norms) == jmag.mag_cache_calibrate_ratios(norms)


@pytest.mark.parametrize("kw", [dict(), dict(unconditional_batch_skip_range=3,
                                             unconditional_batch_timestep_skip_range=(-1, 1000))])
def test_faster_cache_schedules_are_jaxs(kw):
    timesteps = np.linspace(999, 1, 30).round()
    out = faster_cache.faster_cache_schedules(timesteps, faster_cache.FasterCacheConfig(**kw))
    ref = jfc.faster_cache_schedules(timesteps, jfc.FasterCacheConfig(**kw))
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype and np.array_equal(o, r)


def test_pab_mask_is_jaxs():
    rng = np.random.RandomState(0)
    for _ in range(5):
        t = np.sort(rng.uniform(0, 1000, 28))[::-1]
        for skip in (2, 3):
            for window in ((100, 800), (100, 950)):
                out = pyramid_attention_broadcast.pab_compute_mask(t, skip, window)
                assert np.array_equal(out, jpab.pab_compute_mask(t, skip, window))


@pytest.mark.parametrize("shape", [(1, 4, 16, 16), (2, 4, 8, 12)])
def test_split_low_high_freq_matches_jax(shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    (low, high), (jlow, jhigh) = faster_cache._split_low_high_freq(torch.from_numpy(x)), jfc._split_low_high_freq(x)
    assert low.dtype == torch.complex64
    close(low, jlow)
    close(high, jhigh)


def test_faster_cache_apply_matches_jax():
    """Full and skipped steps in turn; the state's weighted deltas compound."""
    rng = np.random.RandomState(1)
    shape = (1, 4, 16, 16)
    state = faster_cache.init_faster_cache_state(shape)
    jstate = jfc.init_faster_cache_state(shape)
    calls = []
    for i, (skip, lf, hf) in enumerate([(False, 1.0, 1.0), (True, 1.1, 1.0), (True, 1.1, 1.1), (False, 1.0, 1.1),
                                        (True, 1.0, 1.1)]):
        full = rng.randn(2 * shape[0], *shape[1:]).astype(np.float32)
        cond = rng.randn(*shape).astype(np.float32)
        ref, jstate = jfc.faster_cache_apply(jstate, jnp.asarray(skip), jnp.float32(lf), jnp.float32(hf),
                                             lambda: jnp.asarray(full), lambda: jnp.asarray(cond))
        out, state = faster_cache.faster_cache_apply(
            state, skip, lf, hf, lambda: calls.append("full") or torch.from_numpy(full),
            lambda: calls.append("cond") or torch.from_numpy(cond))
        close(out, ref)
        close(state.low_freq_delta, jstate.low_freq_delta)
        close(state.high_freq_delta, jstate.high_freq_delta)
    assert calls == ["full", "cond", "cond", "full", "cond"]


@pytest.mark.parametrize("scale", [0.0, 0.01, 0.2, 1.0])
def test_fbc_should_compute_matches_jax(scale):
    rng = np.random.RandomState(2)
    prev = rng.randn(1, 16, 32).astype(np.float32)
    residual = prev + scale * rng.randn(1, 16, 32).astype(np.float32)
    config = first_block_cache.FirstBlockCacheConfig()
    for valid in (False, True):
        jstate = dataclasses.replace(jfbc.init_fbc_state(prev.shape, (1, 4, 32)),
                                     prev_first_residual=jnp.asarray(prev), valid=jnp.asarray(valid))
        state = first_block_cache.init_fbc_state(prev.shape, (1, 4, 32))
        state.prev_first_residual, state.valid = torch.from_numpy(prev), valid
        ref = jfbc.fbc_should_compute(jstate, jfbc.FirstBlockCacheConfig(), jnp.asarray(residual))
        out = first_block_cache.fbc_should_compute(state, config, torch.from_numpy(residual))
        assert bool(out) == bool(ref)
    diff = np.mean(np.abs(residual - prev)) / max(np.mean(np.abs(prev)), 1e-12)
    close(first_block_cache.fbc_relative_change(state, torch.from_numpy(residual)), diff)


def _bare(cls):
    """A pipeline object without components: enough for enable_cache."""
    return cls.__new__(cls)


CACHE_CONFIGS = {
    "FasterCacheConfig": (faster_cache.FasterCacheConfig(), jfc.FasterCacheConfig()),
    "TaylorSeerCacheConfig": (hooks.TaylorSeerCacheConfig(), jhooks.TaylorSeerCacheConfig()),
    "MagCacheConfig": (hooks.MagCacheConfig(calibrate=True), jhooks.MagCacheConfig(calibrate=True)),
    "TextKVCacheConfig": (TextKVCacheConfig(), jgeneric.TextKVCacheConfig()),
    "FirstBlockCacheConfig": (hooks.FirstBlockCacheConfig(), jhooks.FirstBlockCacheConfig()),
    "PyramidAttentionBroadcastConfig": (pyramid_attention_broadcast.PyramidAttentionBroadcastConfig(),
                                        jpab.PyramidAttentionBroadcastConfig()),
}


@pytest.mark.parametrize("pipeline", ["sdxl", "flux"])
@pytest.mark.parametrize("name", sorted(CACHE_CONFIGS))
def test_enable_cache_accepts_what_jax_honours(pipeline, name):
    """Each pipeline takes exactly the configs its JAX twin honours, and
    raises TypeError, naming the supported ones, for the rest."""
    cls, jcls = {"sdxl": (StableDiffusionXLPipeline, JaxStableDiffusionXLPipeline),
                 "flux": (FluxPipeline, JaxFluxPipeline)}[pipeline]
    assert cls._supported_cache_configs == jcls._supported_cache_configs
    cfg, _ = CACHE_CONFIGS[name]
    pipe = _bare(cls)
    if name in jcls._supported_cache_configs:
        pipe.enable_cache(cfg)
        assert pipe._cache_config is cfg
        pipe.disable_cache()
        assert pipe._cache_config is None
    else:
        with pytest.raises(TypeError, match="supported here"):
            pipe.enable_cache(cfg)
        assert pipe._cache_config is None


def test_enable_cache_rejects_a_non_config():
    with pytest.raises(TypeError):
        _bare(FluxPipeline).enable_cache(("not", "a", "config"))

"""`callback_on_step_end` on the port's SDXL and Flux pipelines against the
JAX pipelines' (the SDXL and Flux cases of tests/test_callbacks.py), on the
tiny pipeline pairs of tests/test_torch_pipeline_cache.py, 8 steps, on the
CPU.

Tolerance: max-abs `1e-3` on the final latents, float32 on both sides
(summation order only), as in tests/test_torch_pipeline_cache.py. A no-op
callback must also leave the port's output bit-equal to its uncached,
callback-free output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.callbacks import MultiPipelineCallbacks as JaxMultiPipelineCallbacks
from diffusers_tpu.callbacks import SDXLCFGCutoffCallback as JaxSDXLCFGCutoffCallback
from diffusers_tpu_torch import hooks
from diffusers_tpu_torch.callbacks import MultiPipelineCallbacks, SDCFGCutoffCallback, SDXLCFGCutoffCallback
from test_torch_pipeline_cache import ATOL, STEPS, build_flux, build_sdxl
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sdxl():
    return build_sdxl()


@pytest.fixture(scope="module")
def flux():
    return build_flux()


def _close(out, ref):
    assert float(np.abs(np.asarray(out) - np.asarray(ref)).max()) <= ATOL


def test_sdxl_noop_callback(sdxl):
    _, _, run_jax, run, uncached = sdxl
    calls, jcalls = [], []
    out = run(callback_on_step_end=lambda p, i, t, cbk: calls.append(i) or {})
    ref = run_jax(callback_on_step_end=lambda p, i, t, cbk: jcalls.append(i) or {})
    assert calls == jcalls == list(range(STEPS))
    np.testing.assert_array_equal(out.numpy(), uncached)
    _close(out, ref)


def test_sdxl_cfg_cutoff_callback(sdxl):
    """After the cutoff the uncond half is dropped: the conditioning the later
    steps see is halved and the output leaves the full-CFG one, as in JAX."""
    jpipe, tpipe, run_jax, run, uncached = sdxl
    seen, jseen = {}, {}

    def spy(cb, record):
        def fn(p, i, t, cbk):
            cbk = cb(p, i, t, cbk)
            record[i] = tuple(cbk[k].shape[0] for k in ("prompt_embeds", "add_text_embeds", "add_time_ids"))
            return cbk
        return fn

    out = run(callback_on_step_end=spy(SDXLCFGCutoffCallback(cutoff_step_index=2), seen))
    ref = run_jax(callback_on_step_end=spy(JaxSDXLCFGCutoffCallback(cutoff_step_index=2), jseen))
    assert seen == jseen and seen[1] == (2, 2, 2) and seen[2] == (1, 1, 1) and seen[STEPS - 1] == (1, 1, 1)
    assert tpipe._num_timesteps == jpipe._num_timesteps == STEPS
    _close(out, ref)
    assert float(np.abs(out.numpy() - uncached).max()) > ATOL


def test_sd_cfg_cutoff_callback_rule():
    """`_cutoff_step`: an explicit index wins, else int(steps * ratio)."""
    class Pipe:
        _num_timesteps = 30

    cb = SDCFGCutoffCallback(cutoff_step_ratio=0.4)
    kwargs = cb(Pipe(), 12, 0, {"prompt_embeds": torch.zeros(2, 3)})
    assert kwargs["prompt_embeds"].shape[0] == 1 and kwargs["guidance_scale"] == 1.0
    assert SDCFGCutoffCallback(cutoff_step_index=5)._cutoff_step(30) == 5
    with pytest.raises(ValueError):
        SDXLCFGCutoffCallback(cutoff_step_ratio=1.5)


def test_sdxl_callback_latents_mutation(sdxl):
    _, _, _, run, _ = sdxl

    def zero_at_last(p, i, t, cbk):
        return {"latents": torch.zeros_like(cbk["latents"])} if i == p._num_timesteps - 1 else {}

    assert not run(callback_on_step_end=zero_at_last).any()


def test_multi_callbacks_compose(sdxl):
    _, _, run_jax, run, _ = sdxl

    def recorders(base, multi, order):
        class A(base):
            def callback_fn(self, p, i, t, cbk):
                order.append(("a", i))
                return super().callback_fn(p, i, t, cbk)

        class B(base):
            tensor_inputs = []

            def callback_fn(self, p, i, t, cbk):
                order.append(("b", i))
                return cbk

        return multi([A(cutoff_step_index=1), B()])

    order, jorder = [], []
    multi = recorders(SDXLCFGCutoffCallback, MultiPipelineCallbacks, order)
    assert multi.tensor_inputs == ["prompt_embeds", "add_text_embeds", "add_time_ids"]
    out = run(callback_on_step_end=multi)
    ref = run_jax(callback_on_step_end=recorders(JaxSDXLCFGCutoffCallback, JaxMultiPipelineCallbacks, jorder))
    assert order == jorder == [(x, i) for i in range(STEPS) for x in "ab"]
    _close(out, ref)


def test_flux_callback(flux):
    _, _, run_jax, run, uncached = flux
    steps, jsteps, seen = [], [], []

    def callback(p, i, t, cbk):
        steps.append(i)
        seen.append(sorted(cbk))
        return {}

    out = run(callback_on_step_end=callback)
    ref = run_jax(callback_on_step_end=lambda p, i, t, c: jsteps.append(i) or {})
    assert steps == jsteps == list(range(STEPS))
    assert seen[0] == ["guidance", "latents", "pooled_prompt_embeds", "prompt_embeds"]
    np.testing.assert_array_equal(out.numpy(), uncached)
    _close(out, ref)


@pytest.mark.parametrize("pipeline", ["sdxl", "flux"])
@pytest.mark.parametrize("cache", ["TaylorSeerCacheConfig", "TextKVCacheConfig"])
def test_callback_with_a_cache_raises(pipeline, cache, request):
    _, tpipe, _, run, _ = request.getfixturevalue(pipeline)
    tpipe.enable_cache(getattr(hooks, cache)())
    try:
        with pytest.raises(ValueError, match="cannot yet be combined"):
            run(callback_on_step_end=lambda p, i, t, c: {})
    finally:
        tpipe.disable_cache()

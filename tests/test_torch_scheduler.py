"""Port EulerDiscreteScheduler against the JAX one over a full 30-step loop.

Both schedulers get the same config (the SDXL one of bench.py:118-121 by
default: scaled_linear betas, leading spacing, steps_offset=1), the same
initial sample and the same per-step model outputs (numpy, seeded); the test
compares the timestep and sigma ladders, `init_noise_sigma`, the scaled model
inputs and every step's sample. The ladders are the same numpy code, so they
must agree exactly; the per-step float32 arithmetic agrees to `1e-6`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.schedulers.scheduling_euler_discrete import EulerDiscreteScheduler as JaxEuler
from diffusers_tpu_torch.schedulers import EulerDiscreteScheduler

torch.set_num_threads(1)

SDXL_EULER = dict(beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear",
                  timestep_spacing="leading", steps_offset=1)
STEPS = 30


@pytest.mark.parametrize(
    "overrides",
    [
        {},
        {"timestep_spacing": "linspace", "steps_offset": 0},
        {"timestep_spacing": "trailing", "steps_offset": 0},
        {"prediction_type": "v_prediction"},
        {"prediction_type": "sample", "final_sigmas_type": "sigma_min"},
        {"interpolation_type": "log_linear"},
    ],
    ids=["sdxl-leading", "linspace", "trailing", "v-prediction", "sample-sigma-min", "log-linear"],
)
def test_full_loop_matches_jax(overrides):
    cfg = dict(SDXL_EULER, **overrides)
    jsched, tsched = JaxEuler(**cfg), EulerDiscreteScheduler(**cfg)
    jstate, tstate = jsched.set_timesteps(STEPS), tsched.set_timesteps(STEPS)

    np.testing.assert_array_equal(tstate.timesteps.numpy(), np.asarray(jstate.timesteps))
    np.testing.assert_array_equal(tstate.sigmas.numpy(), np.asarray(jstate.sigmas))
    assert tstate.init_noise_sigma == pytest.approx(float(jstate.init_noise_sigma), rel=1e-7)

    rng = np.random.RandomState(0)
    sample0 = rng.randn(2, 4, 8, 8).astype(np.float32)
    outputs = [rng.randn(2, 4, 8, 8).astype(np.float32) for _ in range(STEPS)]
    jsample = jnp.asarray(sample0) * jstate.init_noise_sigma
    tsample = torch.from_numpy(sample0) * tstate.init_noise_sigma
    for i, t in enumerate(tstate.timesteps):
        jt = jstate.timesteps[i]
        np.testing.assert_allclose(tsched.scale_model_input(tstate, tsample, t).numpy(),
                                   np.asarray(jsched.scale_model_input(jstate, jsample, jt)), rtol=1e-6, atol=1e-6)
        jout = jsched.step(jstate, jnp.asarray(outputs[i]), jt, jsample)
        tout = tsched.step(tstate, torch.from_numpy(outputs[i]), t, tsample)
        jsample, tsample = jout.prev_sample, tout.prev_sample
        np.testing.assert_allclose(tsample.numpy(), np.asarray(jsample), rtol=1e-6, atol=1e-6, err_msg=f"step {i}")
        np.testing.assert_allclose(tout.pred_original_sample.numpy(), np.asarray(jout.pred_original_sample),
                                   rtol=1e-6, atol=1e-6)


def test_step_casts_prev_sample_to_the_model_dtype():
    """bf16 latents stay bf16 through a step, rounded as JAX rounds them."""
    jsched, tsched = JaxEuler(**SDXL_EULER), EulerDiscreteScheduler(**SDXL_EULER)
    jstate, tstate = jsched.set_timesteps(STEPS), tsched.set_timesteps(STEPS)
    rng = np.random.RandomState(1)
    sample = rng.randn(1, 4, 8, 8).astype(np.float32)
    output = rng.randn(1, 4, 8, 8).astype(np.float32)
    t = tstate.timesteps[3]
    tout = tsched.step(tstate, torch.from_numpy(output).bfloat16(), t, torch.from_numpy(sample).bfloat16())
    jout = jsched.step(jstate, jnp.asarray(output, jnp.bfloat16), jstate.timesteps[3], jnp.asarray(sample, jnp.bfloat16))
    assert tout.prev_sample.dtype == torch.bfloat16
    np.testing.assert_array_equal(tout.prev_sample.float().numpy(), np.asarray(jout.prev_sample, np.float32))


def test_churn_step_matches_jax_without_noise():
    """s_churn raises sigma_hat; with s_noise=0 the added noise is zero, so
    both sides are deterministic and must agree."""
    import jax

    jsched, tsched = JaxEuler(**SDXL_EULER), EulerDiscreteScheduler(**SDXL_EULER)
    jstate, tstate = jsched.set_timesteps(STEPS), tsched.set_timesteps(STEPS)
    rng = np.random.RandomState(2)
    sample = rng.randn(1, 4, 8, 8).astype(np.float32)
    output = rng.randn(1, 4, 8, 8).astype(np.float32)
    kw = dict(s_churn=2.0, s_tmin=0.0, s_tmax=100.0, s_noise=0.0)
    for i in (0, 5, 29):
        jout = jsched.step(jstate, jnp.asarray(output), jstate.timesteps[i], jnp.asarray(sample),
                           key=jax.random.PRNGKey(0), **kw)
        tout = tsched.step(tstate, torch.from_numpy(output), tstate.timesteps[i], torch.from_numpy(sample),
                           generator=torch.Generator().manual_seed(0), **kw)
        np.testing.assert_allclose(tout.prev_sample.numpy(), np.asarray(jout.prev_sample), rtol=1e-6, atol=1e-6)


def test_scheduler_config_save_and_load(tmp_path):
    sched = EulerDiscreteScheduler(**SDXL_EULER)
    sched.save_pretrained(tmp_path)
    loaded = EulerDiscreteScheduler.from_config(EulerDiscreteScheduler.load_config(tmp_path))
    assert loaded.config.timestep_spacing == "leading" and loaded.config.steps_offset == 1
    np.testing.assert_array_equal(loaded.set_timesteps(STEPS).sigmas.numpy(), sched.set_timesteps(STEPS).sigmas.numpy())


# ------------------------------------------------------- flow-match Euler

from diffusers_tpu.schedulers.scheduling_flow_match_euler_discrete import (  # noqa: E402
    FlowMatchEulerDiscreteScheduler as JaxFlowMatch,
)
from diffusers_tpu.schedulers.scheduling_flow_match_euler_discrete import calculate_shift as jax_calculate_shift  # noqa: E402
from diffusers_tpu_torch.schedulers import FlowMatchEulerDiscreteScheduler  # noqa: E402
from diffusers_tpu_torch.schedulers.scheduling_flow_match_euler_discrete import calculate_shift  # noqa: E402

FLUX_FLOW_MATCH = dict(use_dynamic_shifting=True, base_shift=0.5, max_shift=1.15, shift=3.0)


@pytest.mark.parametrize(
    "cfg,image_seq_len",
    [
        (FLUX_FLOW_MATCH, 4096),  # Flux.1-dev at 1024 px (bench.py:294-296)
        (FLUX_FLOW_MATCH, 16),
        (dict(shift=3.0), None),  # SD3-style static shift
        (dict(shift=1.0, shift_terminal=0.1), None),
        (dict(shift=3.0, invert_sigmas=True), None),
    ],
    ids=["flux-dev-1024", "flux-dev-tiny", "static-shift", "shift-terminal", "inverted"],
)
def test_flow_match_full_loop_matches_jax(cfg, image_seq_len):
    """Tables with the pipeline's mu (exact: the same numpy code) and a
    28-step loop on the same model outputs (float32 step, `1e-6`)."""
    steps = 28
    jsched, tsched = JaxFlowMatch(**cfg), FlowMatchEulerDiscreteScheduler(**cfg)
    if image_seq_len is not None:
        mu = calculate_shift(image_seq_len)
        assert mu == jax_calculate_shift(image_seq_len)
        sigmas = list(np.linspace(1.0, 1.0 / steps, steps))
        jstate, tstate = jsched.set_timesteps(sigmas=sigmas, mu=mu), tsched.set_timesteps(sigmas=sigmas, mu=mu)
    else:
        jstate, tstate = jsched.set_timesteps(steps), tsched.set_timesteps(steps)
    np.testing.assert_array_equal(tstate.timesteps.numpy(), np.asarray(jstate.timesteps))
    np.testing.assert_array_equal(tstate.sigmas.numpy(), np.asarray(jstate.sigmas))

    rng = np.random.RandomState(0)
    sample = rng.randn(1, 16, 64).astype(np.float32)
    jsample, tsample = jnp.asarray(sample), torch.from_numpy(sample)
    for i, t in enumerate(tstate.timesteps):
        out = rng.randn(1, 16, 64).astype(np.float32)
        jsample = jsched.step(jstate, jnp.asarray(out), jstate.timesteps[i], jsample).prev_sample
        tsample = tsched.step(tstate, torch.from_numpy(out), t, tsample).prev_sample
        np.testing.assert_allclose(tsample.numpy(), np.asarray(jsample), rtol=1e-6, atol=1e-6, err_msg=f"step {i}")

"""Port EulerDiscreteScheduler against the JAX one over a full 30-step loop.

Both schedulers get the same config (the SDXL one of bench.py:118-121 by
default: scaled_linear betas, leading spacing, steps_offset=1), the same
initial sample and the same per-step model outputs (numpy, seeded); the test
compares the timestep and sigma ladders, `init_noise_sigma`, the scaled model
inputs and every step's sample. The ladders (the Karras, exponential and
beta ones included, whose timesteps are fractional) are the same numpy code,
so they must agree exactly; the per-step float32 arithmetic and `add_noise`
agree to `1e-6` relative. Also here: `VaeImageProcessor.preprocess` against
JAX's, on numpy and torch inputs, exactly.
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
        {"use_karras_sigmas": True},
        {"use_karras_sigmas": True, "sigma_min": 0.05, "sigma_max": 10.0, "timestep_spacing": "trailing",
         "steps_offset": 0},
        {"use_exponential_sigmas": True},
        {"use_beta_sigmas": True},
    ],
    ids=["sdxl-leading", "linspace", "trailing", "v-prediction", "sample-sigma-min", "log-linear", "karras",
         "karras-min-max-trailing", "exponential", "beta"],
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


@pytest.mark.parametrize("ladder", [{}, {"use_karras_sigmas": True}, {"use_beta_sigmas": True}],
                         ids=["default", "karras", "beta"])
def test_add_noise_matches_jax(ladder):
    """img2img's noising: one timestep for the batch, then one per row (the
    schedule's own, fractional with a ladder), float32 and bf16 samples."""
    cfg = dict(SDXL_EULER, **ladder)
    jsched, tsched = JaxEuler(**cfg), EulerDiscreteScheduler(**cfg)
    jstate, tstate = jsched.set_timesteps(STEPS), tsched.set_timesteps(STEPS)
    rng = np.random.RandomState(3)
    x, noise = rng.randn(2, 4, 8, 8).astype(np.float32), rng.randn(2, 4, 8, 8).astype(np.float32)
    for idx in ([9], [0, 29]):
        ref = jsched.add_noise(jstate, jnp.asarray(x), jnp.asarray(noise), jstate.timesteps[np.array(idx)])
        out = tsched.add_noise(tstate, torch.from_numpy(x), torch.from_numpy(noise), tstate.timesteps[idx])
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    out = tsched.add_noise(tstate, torch.from_numpy(x).bfloat16(), torch.from_numpy(noise).bfloat16(),
                           tstate.timesteps[:1])
    ref = jsched.add_noise(jstate, jnp.asarray(x, jnp.bfloat16), jnp.asarray(noise, jnp.bfloat16), jstate.timesteps[:1])
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("make", [
    lambda rng: rng.rand(16, 24, 3).astype(np.float32),  # HWC in [0, 1]: normalized
    lambda rng: rng.rand(2, 16, 24, 3).astype(np.float32),  # NHWC
    lambda rng: rng.rand(1, 3, 16, 24).astype(np.float32) * 2 - 1,  # NCHW in [-1, 1]: kept
    lambda rng: torch.from_numpy(rng.rand(1, 16, 24, 1).astype(np.float32)),  # a torch NHWC mask-like image
], ids=["hwc", "nhwc", "nchw-signed", "torch-nhwc-1"])
def test_vae_image_processor_preprocess_matches_jax(make):
    from diffusers_tpu.image_processor import VaeImageProcessor as JaxVaeImageProcessor
    from diffusers_tpu_torch.image_processor import VaeImageProcessor

    image = make(np.random.RandomState(4))
    ref = JaxVaeImageProcessor(vae_scale_factor=8).preprocess(np.asarray(image))
    out = VaeImageProcessor(vae_scale_factor=8).preprocess(image)
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


def test_vae_image_processor_helpers():
    from diffusers_tpu_torch.image_processor import VaeImageProcessor
    from diffusers_tpu_torch.pipelines.inpaint_utils import as_mask_array, repeat_to_batch, resize_mask_nearest

    proc = VaeImageProcessor(vae_scale_factor=8)
    assert proc.get_default_height_width(np.zeros((1, 3, 70, 45))) == (64, 40)
    img = np.arange(2 * 4 * 6 * 3, dtype=np.float32).reshape(2, 4, 6, 3)
    np.testing.assert_array_equal(proc.resize(img, 2, 3), img[:, ::2][:, :, ::2])
    np.testing.assert_array_equal(proc.binarize(np.array([0.2, 0.5, 0.9], np.float32)), [0, 0, 1])
    np.testing.assert_array_equal(proc.binarize(torch.tensor([0.5, 0.51])).numpy(), [0, 1])
    x = torch.tensor([[-1.0, 0.0, 1.0]])
    np.testing.assert_array_equal(proc.denormalize(x).numpy(), [[0.0, 0.5, 1.0]])
    mask = as_mask_array(np.array([[0.2, 0.7], [0.51, 0.5]], np.float32))
    assert mask.shape == (1, 1, 2, 2) and mask.ravel().tolist() == [0, 1, 1, 0]
    big = np.random.RandomState(5).rand(1, 1, 64, 48) > 0.5
    np.testing.assert_array_equal(resize_mask_nearest(big, 8, 6), big[:, :, ::8, ::8])
    assert repeat_to_batch(torch.zeros(1, 4), 3).shape == (3, 4)
    with pytest.raises(ValueError, match="not a multiple"):
        repeat_to_batch(np.zeros((2, 4)), 3)


def test_binarize_of_a_pil_mask_matches_jax():
    """Every 8-bit grey level: the port's one threshold (> 0.5) gives JAX's
    PIL `binarize` (>= 0.5) exactly, and `as_mask_array` agrees with it."""
    from PIL import Image

    from diffusers_tpu.image_processor import VaeImageProcessor as JaxVaeImageProcessor
    from diffusers_tpu_torch.image_processor import VaeImageProcessor
    from diffusers_tpu_torch.pipelines.inpaint_utils import as_mask_array

    mask = Image.fromarray(np.arange(256, dtype=np.uint8).reshape(16, 16), mode="L")
    ref = np.asarray(JaxVaeImageProcessor(vae_scale_factor=8).binarize(mask))
    out = np.asarray(VaeImageProcessor.binarize(mask))
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(as_mask_array(mask)[0, 0] * 255, ref)


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

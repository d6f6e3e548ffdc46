"""The port's samplers against the JAX package's, each over a full loop.

Every case gives both schedulers one config, the same seeded numpy sample
and the same per-step model outputs (and, for the stochastic samplers, the
same injected `variance_noise`; JAX's flow-match Euler draws its own from a
PRNG key, and the port is given that draw). It compares the host ladders
(timesteps, sigmas, `init_noise_sigma`) exactly, `scale_model_input` and
every step's sample to `1e-6` of the sample's largest magnitude (`REL`
states the three cases that need `5e-6`), and `add_noise` (or `scale_noise`)
at two timesteps of the schedule to `1e-6`. The configs are
SDXL's and SD 1.5's betas, epsilon and v prediction, the Karras ladder,
orders 1-3, DPM-Solver's flow sigmas at Wan's `flow_shift`, and each
scheduler's own options; the last cases are the UniPC and flow-match Euler
options that the port raised on before.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusers_tpu_torch.schedulers as port
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

SDXL = dict(beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear", timestep_spacing="leading",
            steps_offset=1)
SD15 = dict(beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear")
WAN_DPM = dict(prediction_type="flow_prediction", use_flow_sigmas=True, flow_shift=5.0)
SHAPE = (2, 4, 8, 8)

JAX_MODULES = {
    "DPMSolverMultistepScheduler": "scheduling_dpmsolver_multistep",
    "EulerAncestralDiscreteScheduler": "scheduling_euler_ancestral_discrete",
    "HeunDiscreteScheduler": "scheduling_heun_discrete",
    "DPMSolverSinglestepScheduler": "scheduling_dpmsolver_singlestep",
    "LMSDiscreteScheduler": "scheduling_lms_discrete",
    "KDPM2DiscreteScheduler": "scheduling_k_dpm_2_discrete",
    "KDPM2AncestralDiscreteScheduler": "scheduling_k_dpm_2_ancestral_discrete",
    "DEISMultistepScheduler": "scheduling_deis_multistep",
    "DPMSolverSDEScheduler": "scheduling_dpmsolver_sde",
    "EDMEulerScheduler": "scheduling_edm_euler",
    "EDMDPMSolverMultistepScheduler": "scheduling_edm_dpmsolver_multistep",
    "SASolverScheduler": "scheduling_sasolver",
    "IPNDMScheduler": "scheduling_ipndm",
    "FlowMatchHeunDiscreteScheduler": "scheduling_flow_match_heun_discrete",
    "FlowMatchLCMScheduler": "scheduling_flow_match_lcm",
    "UniPCMultistepScheduler": "scheduling_unipc_multistep",
    "FlowMatchEulerDiscreteScheduler": "scheduling_flow_match_euler_discrete",
}

# the samplers whose step takes noise: injected on both sides
NOISY = {"EulerAncestralDiscreteScheduler", "KDPM2AncestralDiscreteScheduler", "DPMSolverSDEScheduler",
         "SASolverScheduler", "FlowMatchLCMScheduler"}

# (id, class name, config, steps): 10 steps but for the 20-step order-3 case (order 3 to the end) and the
# 11-step singlestep case (an odd count); one count shares the ladders' shapes, and JAX's op-by-op indexing
# of its ladders compiles once a shape
CASES = [
    ("dpm-2m-sdxl", "DPMSolverMultistepScheduler", SDXL, 10),
    ("dpm-2m-karras-sdxl", "DPMSolverMultistepScheduler", dict(SDXL, use_karras_sigmas=True), 10),
    ("dpm-3m-sd15-20", "DPMSolverMultistepScheduler", dict(SD15, solver_order=3), 20),
    ("dpm-1-vpred", "DPMSolverMultistepScheduler", dict(SD15, solver_order=1, prediction_type="v_prediction"), 10),
    ("dpm-sde-2m-karras", "DPMSolverMultistepScheduler",
     dict(SDXL, algorithm_type="sde-dpmsolver++", use_karras_sigmas=True), 10),
    ("dpm-sde-3m-heun", "DPMSolverMultistepScheduler",
     dict(SD15, algorithm_type="sde-dpmsolver++", solver_order=3, solver_type="heun"), 10),
    ("dpmsolver-2-heun-vpred", "DPMSolverMultistepScheduler",
     dict(SD15, algorithm_type="dpmsolver", solver_type="heun", prediction_type="v_prediction"), 10),
    ("dpmsolver-3-sample", "DPMSolverMultistepScheduler",
     dict(SD15, algorithm_type="dpmsolver", solver_order=3, prediction_type="sample"), 10),
    ("dpm-thresholding", "DPMSolverMultistepScheduler",
     dict(SD15, prediction_type="sample", thresholding=True, sample_max_value=1.5), 10),
    ("dpm-exponential-trailing", "DPMSolverMultistepScheduler",
     dict(SD15, use_exponential_sigmas=True, timestep_spacing="trailing"), 10),
    ("dpm-beta", "DPMSolverMultistepScheduler", dict(SD15, use_beta_sigmas=True), 10),
    ("dpm-lu-lambdas", "DPMSolverMultistepScheduler", dict(SD15, use_lu_lambdas=True), 10),
    ("dpm-flow-wan", "DPMSolverMultistepScheduler", WAN_DPM, 10),
    ("dpm-euler-final-sigma-min", "DPMSolverMultistepScheduler",
     dict(SDXL, euler_at_final=True, final_sigmas_type="sigma_min", lambda_min_clipped=-5.1), 10),
    ("dpm-zero-snr-vpred", "DPMSolverMultistepScheduler",
     dict(SD15, rescale_betas_zero_snr=True, prediction_type="v_prediction", timestep_spacing="trailing"), 10),
    ("euler-a-sdxl", "EulerAncestralDiscreteScheduler", SDXL, 10),
    ("euler-a-vpred-zero-snr", "EulerAncestralDiscreteScheduler",
     dict(SD15, prediction_type="v_prediction", rescale_betas_zero_snr=True, timestep_spacing="trailing"), 10),
    ("heun-sdxl", "HeunDiscreteScheduler", SDXL, 10),
    ("heun-karras", "HeunDiscreteScheduler", dict(SD15, use_karras_sigmas=True), 10),
    ("heun-vpred-clip", "HeunDiscreteScheduler",
     dict(SD15, prediction_type="v_prediction", clip_sample=True, clip_sample_range=2.0), 10),
    ("dpm-singlestep", "DPMSolverSinglestepScheduler", SD15, 11),
    ("dpm-singlestep-karras", "DPMSolverSinglestepScheduler", dict(SD15, use_karras_sigmas=True), 10),
    ("dpm-singlestep-heun-sigma-min", "DPMSolverSinglestepScheduler",
     dict(SD15, solver_type="heun", final_sigmas_type="sigma_min", prediction_type="v_prediction"), 10),
    ("lms-sdxl", "LMSDiscreteScheduler", SDXL, 10),
    ("lms-karras-vpred", "LMSDiscreteScheduler", dict(SD15, use_karras_sigmas=True, prediction_type="v_prediction"),
     10),
    ("kdpm2", "KDPM2DiscreteScheduler", SD15, 10),
    ("kdpm2-karras-leading", "KDPM2DiscreteScheduler", dict(SDXL, use_karras_sigmas=True), 10),
    ("kdpm2-a", "KDPM2AncestralDiscreteScheduler", SD15, 10),
    ("kdpm2-a-karras-vpred", "KDPM2AncestralDiscreteScheduler",
     dict(SD15, use_karras_sigmas=True, prediction_type="v_prediction"), 10),
    ("deis", "DEISMultistepScheduler", SD15, 10),
    ("deis-1-thresholding-leading", "DEISMultistepScheduler",
     dict(SDXL, solver_order=1, prediction_type="sample", thresholding=True), 10),
    ("deis-vpred-trailing", "DEISMultistepScheduler",
     dict(SD15, prediction_type="v_prediction", timestep_spacing="trailing"), 10),
    ("dpm-sde", "DPMSolverSDEScheduler", SD15, 10),
    ("dpm-sde-karras-vpred", "DPMSolverSDEScheduler", dict(SDXL, use_karras_sigmas=True,
                                                              prediction_type="v_prediction"), 10),
    ("edm-euler", "EDMEulerScheduler", {}, 10),
    ("edm-euler-exponential-vpred", "EDMEulerScheduler",
     dict(sigma_schedule="exponential", prediction_type="v_prediction", final_sigmas_type="sigma_min"), 10),
    ("edm-dpm", "EDMDPMSolverMultistepScheduler", {}, 10),
    ("edm-sde-dpm-heun", "EDMDPMSolverMultistepScheduler", dict(algorithm_type="sde-dpmsolver++",
                                                                 solver_type="heun"), 10),
    ("sa-solver", "SASolverScheduler", SD15, 10),
    ("sa-solver-karras-vpred", "SASolverScheduler", dict(SD15, use_karras_sigmas=True,
                                                          prediction_type="v_prediction"), 10),
    ("ipndm", "IPNDMScheduler", {}, 10),
    ("flow-match-heun", "FlowMatchHeunDiscreteScheduler", dict(shift=3.0), 10),
    ("flow-match-lcm", "FlowMatchLCMScheduler", dict(shift=3.0), 10),
    ("unipc-3", "UniPCMultistepScheduler", dict(SD15, solver_order=3), 10),
    ("unipc-3-bh1-karras", "UniPCMultistepScheduler", dict(SD15, solver_order=3, solver_type="bh1",
                                                          use_karras_sigmas=True), 10),
    ("unipc-thresholding", "UniPCMultistepScheduler",
     dict(SD15, prediction_type="sample", thresholding=True, sample_max_value=1.5), 10),
    ("unipc-zero-snr-vpred-trailing", "UniPCMultistepScheduler",
     dict(SD15, rescale_betas_zero_snr=True, prediction_type="v_prediction", timestep_spacing="trailing"), 10),
    ("unipc-leading-disable-corrector", "UniPCMultistepScheduler",
     dict(SDXL, solver_order=3, disable_corrector=[0, 4]), 10),
    ("flow-euler-karras", "FlowMatchEulerDiscreteScheduler", dict(shift=3.0, use_karras_sigmas=True), 10),
    ("flow-euler-exponential", "FlowMatchEulerDiscreteScheduler", dict(shift=3.0, use_exponential_sigmas=True), 10),
    ("flow-euler-beta", "FlowMatchEulerDiscreteScheduler", dict(shift=3.0, use_beta_sigmas=True), 10),
    ("flow-euler-stochastic", "FlowMatchEulerDiscreteScheduler", dict(shift=3.0, stochastic_sampling=True), 10),
]


# cases whose error is a few ulp of the host scalars amplified more: the
# third-order extrapolations and DEIS's log-rho coefficients over ~1e-6
REL = {"dpm-3m-sd15-20": 5e-6, "deis-vpred-trailing": 5e-6, "unipc-leading-disable-corrector": 5e-6}


def make_pair(name: str, config: dict):
    jax_cls = getattr(importlib.import_module(f"diffusers_tpu.schedulers.{JAX_MODULES[name]}"), name)
    return jax_cls(**config), getattr(port, name)(**config)


def assert_close(out, ref, what, rel=1e-6):
    """max |out - ref| <= rel * max |ref|: the scalar coefficients are host
    float32 logs and exps, whose last bit can differ between XLA's and
    torch's, so an element's error is a few ulp of the step's largest term."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape, what
    err, scale = float(np.abs(out - ref).max()), float(np.abs(ref).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


def check_ladders(jstate, tstate):
    np.testing.assert_array_equal(tstate.timesteps.numpy(), np.asarray(jstate.timesteps))
    for name in ("sigmas", "alphas", "betas"):
        if hasattr(jstate, name):
            np.testing.assert_array_equal(getattr(tstate, name).numpy(), np.asarray(getattr(jstate, name)))
    assert tstate.init_noise_sigma == pytest.approx(float(jstate.init_noise_sigma), rel=1e-7)


def run_loops(name, jsched, tsched, steps, rel=1e-6):
    """Both loops over the whole schedule; yields (step, port sample, JAX sample, port state, JAX state)."""
    jstate, tstate = jsched.set_timesteps(steps), tsched.set_timesteps(steps)
    check_ladders(jstate, tstate)
    n = int(tstate.timesteps.shape[0])
    rng = np.random.RandomState(0)
    sample0 = rng.randn(*SHAPE).astype(np.float32)
    outputs = rng.randn(n, *SHAPE).astype(np.float32)
    noises = rng.randn(n, *SHAPE).astype(np.float32)
    jsample = jnp.asarray(sample0) * jstate.init_noise_sigma
    tsample = torch.from_numpy(sample0) * tstate.init_noise_sigma
    for i in range(n):
        t, jt = tstate.timesteps[i], jstate.timesteps[i]
        assert_close(tsched.scale_model_input(tstate, tsample, t), jsched.scale_model_input(jstate, jsample, jt),
                     f"scale_model_input {i}", rel)
        jkw, tkw = {}, {}
        if name in NOISY or tsched.config.get("algorithm_type") == "sde-dpmsolver++":
            jkw["variance_noise"], tkw["variance_noise"] = jnp.asarray(noises[i]), torch.from_numpy(noises[i])
        elif getattr(tsched.config, "stochastic_sampling", False):  # JAX draws from its key; the port takes the draw
            key = jax.random.PRNGKey(i)
            jkw["key"] = key
            tkw["variance_noise"] = torch.from_numpy(np.asarray(jax.random.normal(key, SHAPE, jnp.float32)))
        jout = jsched.step(jstate, jnp.asarray(outputs[i]), jt, jsample, **jkw)
        tout = tsched.step(tstate, torch.from_numpy(outputs[i]), t, tsample, **tkw)
        if getattr(jout, "state", None) is not None:
            jstate = jout.state
        jsample, tsample = jout.prev_sample, tout.prev_sample
        yield i, tsample, jsample, tstate, jstate


@pytest.mark.parametrize("case_id,name,config,steps", CASES, ids=[c[0] for c in CASES])
def test_full_loop_matches_jax(case_id, name, config, steps):
    jsched, tsched = make_pair(name, config)
    rel = REL.get(case_id, 1e-6)
    for i, tsample, jsample, tstate, jstate in run_loops(name, jsched, tsched, steps, rel):
        assert tsample.dtype == torch.float32
        assert_close(tsample, jsample, f"step {i}", rel)
    assert np.isfinite(tsample.numpy()).all()
    # the forward process at two timesteps of the schedule, one per batch row
    rng = np.random.RandomState(7)
    x, noise = rng.randn(*SHAPE).astype(np.float32), rng.randn(*SHAPE).astype(np.float32)
    rows = [1, int(tstate.timesteps.shape[0]) - 1]
    if hasattr(jsched, "add_noise"):
        ref = jsched.add_noise(jstate, jnp.asarray(x), jnp.asarray(noise), jstate.timesteps[np.array(rows)])
        out = tsched.add_noise(tstate, torch.from_numpy(x), torch.from_numpy(noise), tstate.timesteps[rows])
        assert_close(out, ref, "add_noise")
    if hasattr(jsched, "scale_noise"):
        t = rows[0]
        ref = jsched.scale_noise(jstate, jnp.asarray(x), jstate.timesteps[t], jnp.asarray(noise))
        out = tsched.scale_noise(tstate, torch.from_numpy(x), tstate.timesteps[t], torch.from_numpy(noise))
        assert_close(out, ref, "scale_noise")

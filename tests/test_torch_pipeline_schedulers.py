"""The sampler layer in the port's SDXL pipelines against JAX's, on the CPU.

The tiny SDXL components of tests/test_torch_pipeline_sdxl.py, built once
for the module (the port's seeded weights carried into JAX), run text-to-
image with DPM-Solver++ 2M Karras and with Heun (also under TaylorSeer,
whose schedule runs per UNet call in both packages) at the whole-model
tolerance (`5e-4` max-abs on the [0, 1] image), and img2img with DPM-Solver++ at
strength 1.0 (the whole schedule: equal to JAX's) and 0.6. At 0.6 JAX's
img2img slices the timesteps but starts the scheduler's step index at 0, so
a step-indexed scheduler steps the head of its sigma ladder while the UNet
is told the tail's timesteps (ROADMAP C4). The port begins the step index
at the tail, as upstream's `set_begin_index` does: it is held to JAX's own
DPM-Solver++ stepping the tail of the ladder from a fresh history (upstream's
rule from JAX's parts), and, begun at 0 instead, to JAX's img2img itself.

Also here: the ancestral and SDE samplers raise in both packages' pipelines
(their loops pass no key and no noise); `from_config` swaps across the
Karras family give the JAX class's config; the loader resolves every new
class name in both packages (by name), once through `DiffusionPipeline.from_pretrained`
of a saved tiny pipeline whose scheduler is DPM-Solver++.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusers_tpu.hooks as jhooks
import diffusers_tpu_torch.hooks as hooks
import diffusers_tpu_torch.schedulers as port_schedulers
from diffusers_tpu.models.autoencoders.autoencoder_kl import AutoencoderKL as JaxAutoencoderKL
from diffusers_tpu.models.text_encoders.clip import CLIPTextModel as JaxCLIPTextModel
from diffusers_tpu.models.text_encoders.clip import CLIPTextModelWithProjection as JaxCLIPTextModelWithProjection
from diffusers_tpu.models.unets.unet_2d_condition import UNet2DConditionModel as JaxUNet2DConditionModel
from diffusers_tpu.pipelines import pipeline_utils as jax_pipeline_utils
from diffusers_tpu.pipelines.stable_diffusion_xl.pipeline_stable_diffusion_xl import (
    StableDiffusionXLPipeline as JaxStableDiffusionXLPipeline,
)
from diffusers_tpu.pipelines.stable_diffusion_xl.pipeline_stable_diffusion_xl_img2img import (
    StableDiffusionXLImg2ImgPipeline as JaxImg2Img,
)
from diffusers_tpu.schedulers import EulerDiscreteScheduler as JaxEulerDiscreteScheduler
from diffusers_tpu.schedulers.scheduling_dpmsolver_multistep import (
    DPMSolverMultistepScheduler as JaxDPMSolverMultistepScheduler,
)
from diffusers_tpu.schedulers.scheduling_dpmsolver_multistep import DPMSolverMultistepSchedulerOutput
from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel, CLIPTextModelWithProjection
from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
from diffusers_tpu_torch.pipelines import pipeline_utils
from diffusers_tpu_torch.pipelines.stable_diffusion_xl import (
    StableDiffusionXLImg2ImgPipeline,
    StableDiffusionXLPipeline,
)
from diffusers_tpu_torch.pipelines.stable_diffusion_xl import pipeline_stable_diffusion_xl_img2img as port_img2img
from diffusers_tpu_torch.schedulers import DPMSolverMultistepScheduler, EulerDiscreteScheduler
from test_torch_pipeline_cache import _parts
from test_torch_pipeline_img2img import IMAGE, PROMPT, SEED, jax_draws
from test_torch_pipeline_sdxl import CLIP, EULER, UNET, VAE, CRCTokenizer
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)
from test_torch_schedulers import JAX_MODULES

torch.set_num_threads(1)

ATOL = 5e-4
STEPS = 4
IMG2IMG = dict(image=IMAGE, num_inference_steps=5, guidance_scale=5.0, output_type="np")

# the EDM pair's ladder is its own: a swap from the SDXL config sets it
EDM = dict(sigma_min=0.002, sigma_max=80.0)


def jax_class(name):
    return getattr(importlib.import_module(f"diffusers_tpu.schedulers.{JAX_MODULES[name]}"), name)


@pytest.fixture(scope="module")
def parts():
    return _parts([
        ("unet", JaxUNet2DConditionModel, UNet2DConditionModel, UNET),
        ("vae", JaxAutoencoderKL, AutoencoderKL, VAE),
        ("text_encoder", JaxCLIPTextModel, CLIPTextModel, CLIP),
        ("text_encoder_2", JaxCLIPTextModelWithProjection, CLIPTextModelWithProjection, CLIP),
    ], seed=0)


def pipelines(parts, jcls, tcls, name, **config):
    """(JAX pipeline, port pipeline) of `jcls` / `tcls` with the scheduler
    `name` made by `from_config` of the SDXL Euler config."""
    jax_parts, torch_parts = parts
    jsched = jax_class(name).from_config(JaxEulerDiscreteScheduler(**EULER).config, **config)
    tsched = getattr(port_schedulers, name).from_config(EulerDiscreteScheduler(**EULER).config, **config)
    jpipe = jcls(tokenizer=CRCTokenizer(), tokenizer_2=CRCTokenizer(), scheduler=jsched, **jax_parts)
    tpipe = tcls(tokenizer=CRCTokenizer(), tokenizer_2=CRCTokenizer(), scheduler=tsched, device="cpu",
                 **torch_parts)
    return jpipe, tpipe


@pytest.mark.parametrize("name,config,cache", [
    ("DPMSolverMultistepScheduler", dict(use_karras_sigmas=True), False),
    ("HeunDiscreteScheduler", {}, False),
    ("HeunDiscreteScheduler", {}, True),
], ids=["dpm-2m-karras", "heun", "heun-taylorseer"])
def test_sdxl_with_scheduler_matches_jax(parts, name, config, cache):
    """With `cache`, TaylorSeer(2, 1, 1): in both packages its mask runs over
    the schedule's entries, so under Heun it computes or replays per UNet
    call (7 for 4 steps), not per step."""
    jpipe, tpipe = pipelines(parts, JaxStableDiffusionXLPipeline, StableDiffusionXLPipeline, name, **config)
    if cache:
        jpipe.enable_cache(jhooks.TaylorSeerCacheConfig(cache_interval=2, disable_cache_before_step=1, max_order=1))
        tpipe.enable_cache(hooks.TaylorSeerCacheConfig(cache_interval=2, disable_cache_before_step=1, max_order=1))
    latents = np.random.RandomState(0).randn(1, 4, 8, 8).astype(np.float32)
    kwargs = dict(num_inference_steps=STEPS, guidance_scale=5.0, output_type="np")
    ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(latents), **kwargs).images)
    calls = []
    handle = tpipe.unet.register_forward_hook(lambda *a: calls.append(1))
    try:
        out = tpipe(PROMPT, latents=torch.from_numpy(latents), **kwargs).images
    finally:
        handle.remove()
    n = STEPS * tpipe.scheduler.order - (tpipe.scheduler.order - 1)  # Heun: 2N - 1 UNet calls
    computed = hooks.taylorseer_compute_mask(n, tpipe._cache_config) if cache else [True] * n
    assert len(calls) == int(np.sum(computed)) and (len(calls) < n) == cache
    assert out.shape == (1, 8, 8, 3) and np.isfinite(out).all()
    assert float(np.abs(out - ref).max()) < ATOL, float(np.abs(out - ref).max())


class TailDPM(JaxDPMSolverMultistepScheduler):
    """JAX's DPM-Solver++ stepping the ladders from index `begin` with a fresh
    history: upstream's `set_begin_index` rule, made of JAX's step."""

    begin = 0

    def step(self, state, model_output, timestep, sample, **kwargs):
        tail = state.replace(timesteps=state.timesteps[self.begin:], sigmas=state.sigmas[self.begin:])
        out = super().step(tail, model_output, timestep, sample, **kwargs)
        return DPMSolverMultistepSchedulerOutput(
            prev_sample=out.prev_sample, state=out.state.replace(timesteps=state.timesteps, sigmas=state.sigmas))


def _port_img2img(tpipe, monkeypatch, strength):
    draws = jax_draws((1, 4, 8, 8))
    monkeypatch.setattr(port_img2img.torch_utils, "randn_tensor",
                        lambda shape, generator=None, device=None: torch.from_numpy(draws.pop(0)).to(device))
    out = tpipe(PROMPT, strength=strength, **IMG2IMG).images
    assert not draws
    return out


@pytest.fixture(scope="module")
def img2img(parts):
    return pipelines(parts, JaxImg2Img, StableDiffusionXLImg2ImgPipeline, "DPMSolverMultistepScheduler")


def _jax_img2img(jpipe, strength):
    return np.asarray(jpipe(PROMPT, key=jax.random.PRNGKey(SEED), strength=strength, **IMG2IMG).images)


def test_img2img_whole_schedule_matches_jax(img2img, monkeypatch):
    jpipe, tpipe = img2img
    out = _port_img2img(tpipe, monkeypatch, 1.0)
    assert out.shape == (1, 8, 8, 3) and np.isfinite(out).all()
    assert float(np.abs(out - _jax_img2img(jpipe, 1.0)).max()) < ATOL


def test_img2img_steps_the_tail_c4(parts, img2img, monkeypatch):
    """strength 0.6 of 5 steps keeps the last 3. The port equals upstream's
    rule from JAX's parts and differs from JAX's img2img; begun at step
    index 0 (JAX's way) it equals JAX's img2img."""
    jpipe, tpipe = img2img
    ref_jax = _jax_img2img(jpipe, 0.6)
    tail = TailDPM.from_config(jpipe.scheduler.config)
    tail.begin = 2
    jtail = JaxImg2Img(tokenizer=CRCTokenizer(), tokenizer_2=CRCTokenizer(), scheduler=tail, **parts[0])
    ref_upstream = _jax_img2img(jtail, 0.6)
    out = _port_img2img(tpipe, monkeypatch, 0.6)
    assert float(np.abs(out - ref_upstream).max()) < ATOL
    assert float(np.abs(out - ref_jax).max()) > 1e-2

    begin_at_zero = port_img2img.strength_timesteps

    def head(scheduler, state, n, strength):
        timesteps = begin_at_zero(scheduler, state, n, strength)
        state.step_index = 0
        return timesteps

    monkeypatch.setattr(port_img2img, "strength_timesteps", head)
    assert float(np.abs(_port_img2img(tpipe, monkeypatch, 0.6) - ref_jax).max()) < ATOL


def test_jax_dpm_step_reads_its_index_not_the_timestep():
    """The scheduler side of the C4 finding: JAX's step at the tail's first
    timestep, on a fresh state, is its step at the head's."""
    jsched = JaxDPMSolverMultistepScheduler(**EULER)
    state = jsched.set_timesteps(5)
    x, out = jnp.ones((1, 4, 2, 2)), jnp.full((1, 4, 2, 2), 0.5)
    at_tail = jsched.step(state, out, state.timesteps[2], x).prev_sample
    at_head = jsched.step(state, out, state.timesteps[0], x).prev_sample
    np.testing.assert_array_equal(np.asarray(at_tail), np.asarray(at_head))
    tsched = DPMSolverMultistepScheduler(**EULER)
    tstate = tsched.set_timesteps(5)
    tstate.step_index = 2
    port_tail = tsched.step(tstate, torch.full((1, 4, 2, 2), 0.5), tstate.timesteps[2], torch.ones(1, 4, 2, 2))
    assert not np.allclose(port_tail.prev_sample.numpy(), np.asarray(at_head))


@pytest.mark.parametrize("name,config", [
    ("EulerAncestralDiscreteScheduler", {}), ("KDPM2AncestralDiscreteScheduler", {}),
    ("DPMSolverSDEScheduler", {}), ("DPMSolverMultistepScheduler", dict(algorithm_type="sde-dpmsolver++")),
    ("SASolverScheduler", {}),
], ids=["euler-a", "kdpm2-a", "dpm-sde", "sde-dpmsolver++", "sa-solver"])
def test_noisy_samplers_raise_in_both_pipelines(parts, name, config):
    jpipe, tpipe = pipelines(parts, JaxStableDiffusionXLPipeline, StableDiffusionXLPipeline, name, **config)
    latents = np.zeros((1, 4, 8, 8), np.float32)
    with pytest.raises(ValueError, match="variance_noise"):
        jpipe(PROMPT, latents=jnp.asarray(latents), num_inference_steps=2, output_type="latent")
    with pytest.raises(ValueError, match="variance_noise"):
        tpipe(PROMPT, latents=torch.from_numpy(latents), num_inference_steps=2, output_type="latent")


def test_from_config_swaps_give_the_jax_config():
    """Each sampler made from the SDXL Euler config keeps JAX's keys and
    values, and `compatibles` lists the class itself, as JAX's does."""
    jbase, tbase = JaxEulerDiscreteScheduler(**EULER).config, EulerDiscreteScheduler(**EULER).config
    for name in sorted(JAX_MODULES):
        kw = EDM if name.startswith("EDM") else {}
        jsched = jax_class(name).from_config(jbase, **kw)
        tsched = getattr(port_schedulers, name).from_config(tbase, **kw)
        jcfg = {k: v for k, v in dict(jsched.config).items() if not k.startswith("_")}
        tcfg = {k: v for k, v in dict(tsched.config).items() if not k.startswith("_")}
        assert json.loads(json.dumps(tcfg, default=str)) == json.loads(json.dumps(jcfg, default=str)), name
        assert tsched.compatibles == [type(tsched)] and jsched.compatibles == [type(jsched)]
        assert type(tsched).order == type(jsched).order, name
        assert sorted(getattr(tsched, "_compatibles", [])) == sorted(getattr(jsched, "_compatibles", [])), name


def test_loader_resolves_the_new_names(parts, tmp_path):
    for name in sorted(JAX_MODULES):
        cls, kind = pipeline_utils.resolve_component_class("diffusers", name)
        assert cls is getattr(port_schedulers, name) and kind == "config"
        jcls, _ = jax_pipeline_utils.resolve_component_class("diffusers", name)
        assert jcls is jax_class(name)

    _, tpipe = pipelines(parts, JaxStableDiffusionXLPipeline, StableDiffusionXLPipeline,
                         "DPMSolverMultistepScheduler", use_karras_sigmas=True)
    tpipe.save_pretrained(tmp_path)
    with open(tmp_path / "scheduler" / "scheduler_config.json") as f:
        assert json.load(f)["_class_name"] == "DPMSolverMultistepScheduler"
    loaded = pipeline_utils.DiffusionPipeline.from_pretrained(str(tmp_path), device="cpu", tokenizer=CRCTokenizer(),
                                                              tokenizer_2=CRCTokenizer())
    assert type(loaded) is StableDiffusionXLPipeline
    assert JaxDPMSolverMultistepScheduler.from_pretrained(str(tmp_path), subfolder="scheduler").config.use_karras_sigmas
    assert type(loaded.scheduler) is DPMSolverMultistepScheduler and loaded.scheduler.config.use_karras_sigmas
    np.testing.assert_array_equal(loaded.scheduler.set_timesteps(STEPS).sigmas.numpy(),
                                  tpipe.scheduler.set_timesteps(STEPS).sigmas.numpy())

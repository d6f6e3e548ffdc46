"""The port's UNet class embeddings, the LCM and TCD schedulers, the LCM and
TCD pipelines and the x4 upscaler against the JAX package on the CPU.

* Class embeddings: each `class_embed_type` (and the `num_class_embeds`
  table, and `class_embeddings_concat`) on a tiny SD UNet against JAX's,
  float32, within 5e-4.
* Schedulers step by step against JAX's given the same noise tensor (the
  port draws from a `torch.Generator`, JAX from a key folded with the step
  index: ROADMAP C3), within 2e-6 of the sample's scale.
* The pipelines end to end against JAX's `__call__`: the port's one
  `utils.torch_utils.randn_tensor` returns JAX's draws in JAX's order (the
  upscaler's low-res noise, then its latents; LCM's and TCD's step noise,
  drawn in JAX with `fold_in(noise_key, i)`), so the multi-step stochastic
  paths are held whole; LCM at one step and TCD at ``eta = 0`` draw nothing.
  Images within 5e-4 (float32 both sides; summation order).
* A `model_index.json` round trip of the upscaler through
  `DiffusionPipeline.from_pretrained`, which picks the class the file names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.models.autoencoders.autoencoder_kl import AutoencoderKL as JaxAutoencoderKL
from diffusers_tpu.models.text_encoders.clip import CLIPTextModel as JaxCLIPTextModel
from diffusers_tpu.models.unets.unet_2d_condition import UNet2DConditionModel as JaxUNet2DConditionModel
from diffusers_tpu.pipelines.latent_consistency_models.pipeline_latent_consistency_text2img import (
    LatentConsistencyModelPipeline as JaxLCMPipeline,
)
from diffusers_tpu.pipelines.latent_consistency_models.pipeline_latent_consistency_text2img import (
    get_guidance_scale_embedding as jax_w_embedding,
)
from diffusers_tpu.pipelines.stable_diffusion.pipeline_stable_diffusion_upscale import (
    StableDiffusionUpscalePipeline as JaxUpscalePipeline,
)
from diffusers_tpu.pipelines.tcd.pipeline_tcd import TCDPipeline as JaxTCDPipeline
from diffusers_tpu.schedulers import DDIMScheduler as JaxDDIM
from diffusers_tpu.schedulers import DDPMScheduler as JaxDDPM
from diffusers_tpu.schedulers import LCMScheduler as JaxLCMScheduler
from diffusers_tpu.schedulers import TCDScheduler as JaxTCDScheduler
from diffusers_tpu_torch import (
    DiffusionPipeline,
    LatentConsistencyModelPipeline,
    StableDiffusionUpscalePipeline,
    TCDPipeline,
)
from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel
from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
from diffusers_tpu_torch.pipelines.latent_consistency_models import get_guidance_scale_embedding
from diffusers_tpu_torch.schedulers import DDIMScheduler, DDPMScheduler, LCMScheduler, TCDScheduler
from diffusers_tpu_torch.utils import torch_utils
from test_torch_pipeline_cache import _parts
from test_torch_pipeline_sdxl import CLIP, VAE, CRCTokenizer
from test_torch_stable_diffusion import IMAGE_ATOL, MODEL_ATOL, STEP_ATOL, UNET_SD
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)
from test_torch_jit_reference import fast_randn as jax_randn

torch.set_num_threads(1)

PROMPT = "a lighthouse at dawn"
SEED = 5
LCM_UNET = dict(UNET_SD, time_cond_proj_dim=12)
LCM_SCHED = dict(beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear", original_inference_steps=50)
# the x4 upscaler's layout at tiny widths: 7 input channels (latents + the low-res image), a noise-level table
# of 1000 classes, only-cross-attention in the cross-attention blocks, a 3-block VAE (4x)
UPSCALE_UNET = dict(UNET_SD, in_channels=7, num_class_embeds=1000, only_cross_attention=True,
                    use_linear_projection=True)
UPSCALE_VAE = dict(VAE, block_out_channels=(8, 8, 8), down_block_types=("DownEncoderBlock2D",) * 3,
                   up_block_types=("UpDecoderBlock2D",) * 3, scaling_factor=0.08333)
UPSCALE_DDIM = dict(beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear", clip_sample=False,
                    set_alpha_to_one=False, steps_offset=1, prediction_type="v_prediction")
UPSCALE_DDPM = dict(beta_start=0.0001, beta_end=0.02, beta_schedule="scaled_linear")
LOW_RES = np.random.RandomState(1).rand(6, 6, 3).astype(np.float32)  # HWC in [0, 1]
LATENTS = np.random.RandomState(0).randn(1, 4, 8, 8).astype(np.float32)


def _max_diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def _queue(monkeypatch, draws):
    """The port's `randn_tensor` returns `draws`, in order."""
    queue = [np.asarray(d) for d in draws]

    def randn_tensor(shape, generator=None, device=None):
        out = queue.pop(0)
        assert tuple(shape) == out.shape
        return torch.from_numpy(out).to(device)

    monkeypatch.setattr(torch_utils, "randn_tensor", randn_tensor)
    return queue


# ---------------------------------------------------------------------------- class embeddings

CLASS_CASES = {
    "table": (dict(num_class_embeds=10), lambda rng: rng.randint(0, 10, size=2)),
    "timestep": (dict(class_embed_type="timestep"), lambda rng: rng.randint(0, 1000, size=2)),
    "identity": (dict(class_embed_type="identity"), lambda rng: rng.randn(2, 32).astype(np.float32)),
    "projection": (dict(class_embed_type="projection", projection_class_embeddings_input_dim=12),
                   lambda rng: rng.randn(2, 12).astype(np.float32)),
    "simple_projection": (dict(class_embed_type="simple_projection", projection_class_embeddings_input_dim=12),
                          lambda rng: rng.randn(2, 12).astype(np.float32)),
    "concat": (dict(class_embed_type="projection", projection_class_embeddings_input_dim=12,
                    class_embeddings_concat=True), lambda rng: rng.randn(2, 12).astype(np.float32)),
}


@pytest.mark.parametrize("case", list(CLASS_CASES))
def test_class_embeddings_match_jax(case):
    extra, labels = CLASS_CASES[case]
    jax_parts, torch_parts = _parts([("unet", JaxUNet2DConditionModel, UNet2DConditionModel,
                                      dict(UNET_SD, **extra))], seed=2)
    (jm, params), unet = jax_parts["unet"], torch_parts["unet"]
    if case == "concat":  # every resnet's time projection reads the doubled width
        assert unet.down_blocks[0].resnets[0].time_emb_proj.in_features == 2 * 32
    rng = np.random.RandomState(3)
    sample, ehs, class_labels = rng.randn(2, 4, 8, 8).astype(np.float32), rng.randn(2, 77, 16).astype(np.float32), \
        labels(rng)
    ref = jax.jit(lambda p, x, e, c: jm(p, x, jnp.asarray([500, 20]), e, class_labels=c).sample)(
        params, jnp.asarray(sample), jnp.asarray(ehs), jnp.asarray(class_labels))
    with torch.no_grad():
        out = unet(torch.from_numpy(sample), torch.tensor([500, 20]), torch.from_numpy(ehs),
                   class_labels=torch.from_numpy(class_labels)).sample
        other = unet(torch.from_numpy(sample), torch.tensor([500, 20]), torch.from_numpy(ehs),
                       class_labels=torch.from_numpy(labels(np.random.RandomState(11)))).sample
    assert _max_diff(out, ref) <= MODEL_ATOL
    assert _max_diff(out, other) > 1e-4  # the labels condition the output
    with pytest.raises(ValueError, match="class_labels"):
        unet(torch.from_numpy(sample), torch.tensor([500, 20]), torch.from_numpy(ehs))


# ---------------------------------------------------------------------------- schedulers


@pytest.mark.parametrize("prediction_type, steps", [("epsilon", 4), ("v_prediction", 6), ("sample", 1)])
def test_lcm_scheduler_matches_jax_step_by_step(prediction_type, steps):
    cfg = dict(LCM_SCHED, prediction_type=prediction_type, clip_sample=prediction_type == "sample")
    jsched, tsched = JaxLCMScheduler(**cfg), LCMScheduler(**cfg)
    jstate, tstate = jsched.set_timesteps(steps), tsched.set_timesteps(steps)
    np.testing.assert_array_equal(np.asarray(jstate.timesteps), tstate.timesteps.numpy())
    rng = np.random.RandomState(4)
    sample = rng.randn(2, 4, 8, 8).astype(np.float32)
    jsample, tsample = jnp.asarray(sample), torch.from_numpy(sample)
    for i, t in enumerate(tstate.timesteps):
        out, noise = rng.randn(2, 2, 4, 8, 8).astype(np.float32)
        jres = jsched.step(jstate, jnp.asarray(out), jnp.asarray(int(t)), jsample, variance_noise=jnp.asarray(noise))
        tres = tsched.step(tstate, torch.from_numpy(out), t, tsample, variance_noise=torch.from_numpy(noise))
        scale = max(1.0, float(np.abs(np.asarray(jres.prev_sample)).max()))
        assert _max_diff(tres.prev_sample, jres.prev_sample) <= STEP_ATOL * scale
        assert _max_diff(tres.denoised, jres.denoised) <= STEP_ATOL * scale
        assert tsched.last_step(tstate, t) == (i == steps - 1)
        jsample, tsample = jres.prev_sample, tres.prev_sample
    assert torch.equal(tres.prev_sample, tres.denoised)  # the last step returns the denoised sample
    np.testing.assert_array_equal(tsched.set_timesteps(timesteps=[999, 499, 99]).timesteps.numpy(),
                                  np.asarray(jsched.set_timesteps(timesteps=[999, 499, 99]).timesteps))
    np.testing.assert_array_equal(tsched.set_timesteps(4, strength=0.5).timesteps.numpy(),
                                  np.asarray(jsched.set_timesteps(4, strength=0.5).timesteps))
    with pytest.raises(ValueError, match="original_inference_steps"):
        tsched.set_timesteps(51)
    drawn = tsched.step(tstate, torch.from_numpy(out), tstate.timesteps[0], torch.from_numpy(sample),
                        generator=torch.Generator().manual_seed(1)).prev_sample
    given = tsched.step(tstate, torch.from_numpy(out), tstate.timesteps[0], torch.from_numpy(sample),
                        variance_noise=torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(1))).prev_sample
    assert torch.equal(drawn, given)


@pytest.mark.parametrize("eta, prediction_type", [(0.0, "epsilon"), (0.3, "epsilon"), (1.0, "v_prediction"),
                                                  (0.5, "sample")])
def test_tcd_scheduler_matches_jax_step_by_step(eta, prediction_type):
    cfg = dict(LCM_SCHED, prediction_type=prediction_type)
    jsched, tsched = JaxTCDScheduler(**cfg), TCDScheduler(**cfg)
    steps = 60  # TCD, unlike LCM, takes more steps than original_inference_steps
    jstate, tstate = jsched.set_timesteps(steps), tsched.set_timesteps(steps)
    np.testing.assert_array_equal(np.asarray(jstate.timesteps), tstate.timesteps.numpy())
    jstate, tstate = jsched.set_timesteps(5), tsched.set_timesteps(5)
    rng = np.random.RandomState(5)
    sample = rng.randn(2, 4, 8, 8).astype(np.float32)
    jsample, tsample = jnp.asarray(sample), torch.from_numpy(sample)
    for t in tstate.timesteps:
        out, noise = rng.randn(2, 2, 4, 8, 8).astype(np.float32)
        jres = jsched.step(jstate, jnp.asarray(out), jnp.asarray(int(t)), jsample, eta=eta,
                           variance_noise=jnp.asarray(noise))
        tres = tsched.step(tstate, torch.from_numpy(out), t, tsample, eta=eta,
                           variance_noise=torch.from_numpy(noise) if tsched.takes_noise(tstate, t, eta) else None)
        scale = max(1.0, float(np.abs(np.asarray(jres.prev_sample)).max()))
        assert _max_diff(tres.prev_sample, jres.prev_sample) <= STEP_ATOL * scale
        assert _max_diff(tres.pred_noised_sample, jres.pred_noised_sample) <= STEP_ATOL * scale
        jsample, tsample = jres.prev_sample, tres.prev_sample
    if eta > 0:
        with pytest.raises(ValueError, match="generator"):
            tsched.step(tstate, torch.from_numpy(out), tstate.timesteps[0], torch.from_numpy(sample), eta=eta)


def test_guidance_scale_embedding_matches_jax():
    """Within two f32 ulps of the largest sine argument, ``1000 |w|``: torch's
    and XLA's `exp` may round a frequency one ulp apart."""
    w = np.array([7.5, 0.0, -1.0], np.float32)
    tol = 2 * float(np.spacing(np.float32(1000 * np.abs(w).max())))
    for dim in (256, 12, 7):
        np.testing.assert_allclose(get_guidance_scale_embedding(torch.from_numpy(w), dim).numpy(),
                                   np.asarray(jax_w_embedding(jnp.asarray(w), dim)), rtol=0, atol=tol)


# ---------------------------------------------------------------------------- pipelines


def _sd_pair(jcls, tcls, unet_cfg, scheduler_pair, vae_cfg=VAE, seed=3, **extra):
    jax_parts, torch_parts = _parts([
        ("unet", JaxUNet2DConditionModel, UNet2DConditionModel, unet_cfg),
        ("vae", JaxAutoencoderKL, AutoencoderKL, vae_cfg),
        ("text_encoder", JaxCLIPTextModel, CLIPTextModel, dict(CLIP, hidden_size=16)),
    ], seed=seed)
    (jsched_cls, tsched_cls, cfg) = scheduler_pair
    jextra = {k: v[0] for k, v in extra.items()}
    textra = {k: v[1] for k, v in extra.items()}
    jpipe = jcls(tokenizer=CRCTokenizer(), scheduler=jsched_cls(**cfg), **jax_parts, **jextra)
    tpipe = tcls(tokenizer=CRCTokenizer(), scheduler=tsched_cls(**cfg), device="cpu", **torch_parts, **textra)
    return jpipe, tpipe


@pytest.fixture(scope="module")
def lcm():
    return _sd_pair(JaxLCMPipeline, LatentConsistencyModelPipeline, LCM_UNET, (JaxLCMScheduler, LCMScheduler,
                                                                               LCM_SCHED))


@pytest.fixture(scope="module")
def tcd():
    return _sd_pair(JaxTCDPipeline, TCDPipeline, LCM_UNET, (JaxTCDScheduler, TCDScheduler, LCM_SCHED))


def _step_draws(seed, steps, shape):
    """JAX's consistency pipelines' draws: (latents, [step noise for step i])."""
    _, latent_key, noise_key = jax.random.split(jax.random.PRNGKey(seed), 3)
    return (np.array(jax_randn(shape, key=latent_key)),
            [np.array(jax_randn(shape, key=jax.random.fold_in(noise_key, i), dtype=jnp.float32))
             for i in range(steps)])


@pytest.mark.parametrize("steps", [1, 4])
def test_lcm_pipeline_matches_jax(lcm, monkeypatch, steps):
    jpipe, tpipe = lcm
    kwargs = dict(num_inference_steps=steps, guidance_scale=8.5, output_type="np")
    ref = np.asarray(jpipe(PROMPT, key=jax.random.PRNGKey(SEED), **kwargs).images)
    latents, noise = _step_draws(SEED, steps, (1, 4, 8, 8))
    queue = _queue(monkeypatch, [latents] + noise[:steps - 1])  # no noise on the last step
    out = tpipe(PROMPT, **kwargs).images
    assert not queue and out.shape == (1, 8, 8, 3) and np.isfinite(out).all()
    assert _max_diff(out, ref) <= IMAGE_ATOL


def test_lcm_pipeline_one_step_is_deterministic_and_refuses_a_plain_unet(lcm):
    jpipe, tpipe = lcm
    kwargs = dict(num_inference_steps=1, guidance_scale=4.0, output_type="latent")
    ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), **kwargs).images)
    out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).images
    assert _max_diff(out, ref) <= IMAGE_ATOL
    plain = LatentConsistencyModelPipeline(vae=tpipe.vae, text_encoder=tpipe.text_encoder, tokenizer=tpipe.tokenizer,
                                           unet=UNet2DConditionModel(**UNET_SD), scheduler=tpipe.scheduler,
                                           device="cpu")
    with pytest.raises(ValueError, match="time_cond_proj_dim"):
        plain(PROMPT, num_inference_steps=1)


@pytest.mark.parametrize("eta", [0.0, 0.3])
def test_tcd_pipeline_matches_jax(tcd, monkeypatch, eta):
    jpipe, tpipe = tcd
    kwargs = dict(num_inference_steps=4, guidance_scale=3.0, eta=eta, output_type="np")
    ref = np.asarray(jpipe(PROMPT, key=jax.random.PRNGKey(SEED), **kwargs).images)
    latents, noise = _step_draws(SEED, 4, (1, 4, 8, 8))
    queue = _queue(monkeypatch, [latents] + (noise[:3] if eta > 0 else []))
    out = tpipe(PROMPT, **kwargs).images
    assert not queue and out.shape == (1, 8, 8, 3) and np.isfinite(out).all()
    assert _max_diff(out, ref) <= IMAGE_ATOL


@pytest.fixture(scope="module")
def upscale():
    return _sd_pair(JaxUpscalePipeline, StableDiffusionUpscalePipeline, UPSCALE_UNET, (JaxDDIM, DDIMScheduler,
                                                                                       UPSCALE_DDIM),
                    vae_cfg=UPSCALE_VAE, low_res_scheduler=(JaxDDPM(**UPSCALE_DDPM), DDPMScheduler(**UPSCALE_DDPM)))


@pytest.mark.parametrize("given_latents", [False, True], ids=["drawn", "given"])
def test_upscale_pipeline_matches_jax(upscale, monkeypatch, given_latents):
    jpipe, tpipe = upscale
    kwargs = dict(image=LOW_RES, num_inference_steps=3, guidance_scale=9.0, noise_level=20, output_type="np")
    _, lr_key, lat_key = jax.random.split(jax.random.PRNGKey(SEED), 3)
    lr_noise = np.array(jax_randn((1, 3, 6, 6), key=lr_key))
    latents = np.array(jax_randn((1, 4, 6, 6), key=lat_key))
    if given_latents:
        kwargs["latents"] = latents
        ref = np.asarray(jpipe(PROMPT, key=jax.random.PRNGKey(SEED), **dict(kwargs, latents=jnp.asarray(latents))
                               ).images)
        kwargs["latents"] = torch.from_numpy(latents)
        queue = _queue(monkeypatch, [lr_noise])
    else:
        ref = np.asarray(jpipe(PROMPT, key=jax.random.PRNGKey(SEED), **kwargs).images)
        queue = _queue(monkeypatch, [lr_noise, latents])
    out = tpipe(PROMPT, **kwargs).images
    assert not queue and out.shape == (1, 24, 24, 3) and np.isfinite(out).all()  # 6 x 6 -> 24 x 24
    assert _max_diff(out, ref) <= IMAGE_ATOL


def test_upscale_model_index_round_trip(upscale, tmp_path):
    _, tpipe = upscale
    tpipe.save_pretrained(tmp_path / "pipe")
    loaded = DiffusionPipeline.from_pretrained(tmp_path / "pipe", device="cpu", tokenizer=tpipe.tokenizer)
    assert type(loaded) is StableDiffusionUpscalePipeline
    assert type(loaded.low_res_scheduler) is DDPMScheduler and type(loaded.scheduler) is DDIMScheduler
    assert loaded.unet.config.num_class_embeds == 1000 and loaded.unet.class_embedding.weight.shape == (1000, 32)
    for name in ("unet", "vae", "text_encoder"):
        for (k, a), (k2, b) in zip(getattr(tpipe, name).state_dict().items(),
                                   getattr(loaded, name).state_dict().items()):
            assert k == k2 and torch.equal(a, b), f"{name} {k}"
    kwargs = dict(image=LOW_RES, num_inference_steps=2, latents=torch.from_numpy(LATENTS[:, :, :6, :6].copy()),
                  generator=torch.Generator().manual_seed(0), output_type="np")
    first = tpipe(PROMPT, **kwargs).images
    kwargs["generator"] = torch.Generator().manual_seed(0)
    np.testing.assert_array_equal(loaded(PROMPT, **kwargs).images, first)

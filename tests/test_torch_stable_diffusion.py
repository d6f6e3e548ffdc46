"""The port's Stable Diffusion 1.x slice against the JAX package on the CPU:
PNDM and DDIM step by step, the SD 1.5 UNet configuration (1x1-conv
`proj_in` / `proj_out`, no added embedding), the text-to-image, img2img and
both inpaint pipelines, `SDCFGCutoffCallback`, and `from_pretrained` of a
directory in `stable-diffusion-v1-5/stable-diffusion-v1-5`'s layout.

The port's models are made from a seed and carried into JAX with
`convert_torch_state_dict` (`test_torch_pipeline_cache._parts`); both
pipelines get the same numpy latents, or the same random draws through the
port's `utils.torch_utils.randn_tensor` (`test_torch_pipeline_img2img.draws`).

Tolerances (the README's): a scheduler step 2e-6 (float32, the same
formulas, the scalars in float32 on both sides); a whole model 5e-4; a
pipeline's [0, 1] image or latents 5e-4 (float32 on both sides, so the
differences are summation order carried through CLIP, the loop and the
VAE).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.callbacks import SDCFGCutoffCallback as JaxSDCFGCutoffCallback
from diffusers_tpu.models.autoencoders.autoencoder_kl import AutoencoderKL as JaxAutoencoderKL
from diffusers_tpu.models.text_encoders.clip import CLIPTextModel as JaxCLIPTextModel
from diffusers_tpu.models.unets.unet_2d_condition import UNet2DConditionModel as JaxUNet2DConditionModel
from diffusers_tpu.pipelines.stable_diffusion.pipeline_stable_diffusion import (
    StableDiffusionPipeline as JaxStableDiffusionPipeline,
)
from diffusers_tpu.pipelines.stable_diffusion.pipeline_stable_diffusion_img2img import (
    StableDiffusionImg2ImgPipeline as JaxImg2Img,
)
from diffusers_tpu.pipelines.stable_diffusion.pipeline_stable_diffusion_inpaint import (
    StableDiffusionInpaintPipeline as JaxInpaint,
)
from diffusers_tpu.schedulers.scheduling_ddim import DDIMScheduler as JaxDDIM
from diffusers_tpu.schedulers.scheduling_pndm import PNDMScheduler as JaxPNDM
from diffusers_tpu_torch.callbacks import SDCFGCutoffCallback
from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel
from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
from diffusers_tpu_torch.ops.module import Conv2d
from diffusers_tpu_torch.pipelines.stable_diffusion import (
    StableDiffusionImg2ImgPipeline,
    StableDiffusionInpaintPipeline,
    StableDiffusionPipeline,
)
from diffusers_tpu_torch.schedulers import DDIMScheduler, PNDMScheduler
from diffusers_tpu_torch.utils import torch_utils
from test_torch_pipeline_cache import _parts
from test_torch_pipeline_img2img import IMAGE, MASK, SEED, draws, jax_draws  # noqa: F401 (draws: a fixture)
from test_torch_pipeline_sdxl import CLIP, VAE, CRCTokenizer
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

STEP_ATOL = 2e-6
MODEL_ATOL = 5e-4
IMAGE_ATOL = 5e-4
PROMPT = "a lighthouse on a cliff at dusk"
# SD 1.5's UNet shape at tiny widths: cross attention at the top level, 1x1-conv projections, no added embedding
UNET_SD = dict(
    sample_size=8, in_channels=4, out_channels=4,
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"), up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    block_out_channels=(8, 16), layers_per_block=1, attention_head_dim=2, cross_attention_dim=16,
    norm_num_groups=4, use_linear_projection=False,
)
BETAS = dict(beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear")
PNDM = dict(BETAS, skip_prk_steps=True, set_alpha_to_one=False, steps_offset=1)  # SD 1.5's scheduler_config.json
DDIM = dict(BETAS, clip_sample=False, set_alpha_to_one=False, steps_offset=1)
SCHEDULERS = {"pndm": (JaxPNDM, PNDMScheduler, PNDM), "ddim": (JaxDDIM, DDIMScheduler, DDIM)}
LATENTS = np.random.RandomState(0).randn(1, 4, 8, 8).astype(np.float32)


def sd_parts(in_channels=4, seed=1):
    return _parts([
        ("unet", JaxUNet2DConditionModel, UNet2DConditionModel, dict(UNET_SD, in_channels=in_channels)),
        ("vae", JaxAutoencoderKL, AutoencoderKL, VAE),
        ("text_encoder", JaxCLIPTextModel, CLIPTextModel, CLIP),
    ], seed=seed)


def sd_pipelines(jcls=JaxStableDiffusionPipeline, tcls=StableDiffusionPipeline, scheduler="pndm", in_channels=4):
    jsched, tsched, cfg = SCHEDULERS[scheduler]
    jax_parts, torch_parts = sd_parts(in_channels)
    jpipe = jcls(tokenizer=CRCTokenizer(), scheduler=jsched(**cfg), **jax_parts)
    tpipe = tcls(tokenizer=CRCTokenizer(), scheduler=tsched(**cfg), device="cpu", **torch_parts)
    return jpipe, tpipe


@pytest.fixture(scope="module")
def t2i():
    return {name: sd_pipelines(scheduler=name) for name in SCHEDULERS}


def _max_diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


# ---------------------------------------------------------------------------- schedulers


@pytest.mark.parametrize("prediction_type,spacing,steps", [("epsilon", "leading", 7), ("v_prediction", "trailing", 5),
                                                            ("epsilon", "linspace", 4)])
def test_pndm_matches_jax_step_by_step(prediction_type, spacing, steps):
    cfg = dict(PNDM, prediction_type=prediction_type, timestep_spacing=spacing)
    jsched, tsched = JaxPNDM(**cfg), PNDMScheduler(**cfg)
    jstate, tstate = jsched.set_timesteps(steps), tsched.set_timesteps(steps)
    np.testing.assert_array_equal(np.asarray(jstate.timesteps), tstate.timesteps.numpy())
    assert len(tstate.timesteps) == steps + 1  # skip_prk_steps repeats the second-to-last timestep
    rng = np.random.RandomState(1)
    sample = rng.randn(2, 4, 8, 8).astype(np.float32)
    jsample, tsample = jnp.asarray(sample), torch.from_numpy(sample)
    for t in tstate.timesteps:
        out = rng.randn(2, 4, 8, 8).astype(np.float32)
        jres = jsched.step(jstate, jnp.asarray(out), jnp.asarray(int(t)), jsample)
        jsample, jstate = jres.prev_sample, jres.state
        tsample = tsched.step(tstate, torch.from_numpy(out), t, tsample).prev_sample
        assert _max_diff(tsample, jsample) <= STEP_ATOL * max(1.0, float(np.abs(np.asarray(jsample)).max()))
    assert tstate.counter == len(tstate.timesteps) and len(tstate.ets) == 4
    noise = rng.randn(2, 4, 8, 8).astype(np.float32)
    ts = np.array([981, 1])
    ref = jsched.add_noise(jstate, jnp.asarray(sample), jnp.asarray(noise), jnp.asarray(ts))
    assert _max_diff(tsched.add_noise(tstate, torch.from_numpy(sample), torch.from_numpy(noise), torch.from_numpy(ts)),
                     ref) <= STEP_ATOL
    with pytest.raises(NotImplementedError, match="PRK"):
        PNDMScheduler(**dict(PNDM, skip_prk_steps=False)).set_timesteps(10)
    with pytest.raises(NotImplementedError, match="PRK"):
        JaxPNDM(**dict(PNDM, skip_prk_steps=False)).set_timesteps(10)


@pytest.mark.parametrize("spacing,eta,prediction_type,extra", [
    ("leading", 0.0, "epsilon", {}),
    ("trailing", 0.7, "epsilon", {"clip_sample": True}),
    ("linspace", 1.0, "v_prediction", {"thresholding": True, "sample_max_value": 1.5}),
    ("leading", 0.3, "sample", {"rescale_betas_zero_snr": True, "set_alpha_to_one": True}),
])
def test_ddim_matches_jax_step_by_step(spacing, eta, prediction_type, extra):
    cfg = dict(DDIM, timestep_spacing=spacing, prediction_type=prediction_type, **extra)
    jsched, tsched = JaxDDIM(**cfg), DDIMScheduler(**cfg)
    jstate, tstate = jsched.set_timesteps(6), tsched.set_timesteps(6)
    np.testing.assert_array_equal(np.asarray(jstate.timesteps), tstate.timesteps.numpy())
    rng = np.random.RandomState(2)
    sample = rng.randn(2, 4, 8, 8).astype(np.float32)
    jsample, tsample = jnp.asarray(sample), torch.from_numpy(sample)
    for t in tstate.timesteps:
        out, noise = rng.randn(2, 2, 4, 8, 8).astype(np.float32)
        jres = jsched.step(jstate, jnp.asarray(out), jnp.asarray(int(t)), jsample, eta=eta,
                           variance_noise=jnp.asarray(noise))
        tres = tsched.step(tstate, torch.from_numpy(out), t, tsample, eta=eta, variance_noise=torch.from_numpy(noise))
        scale = max(1.0, float(np.abs(np.asarray(jres.prev_sample)).max()))
        assert _max_diff(tres.prev_sample, jres.prev_sample) <= STEP_ATOL * scale
        assert _max_diff(tres.pred_original_sample, jres.pred_original_sample) <= STEP_ATOL * scale
        jsample, tsample = jres.prev_sample, tres.prev_sample
    velocity = tsched.get_velocity(tstate, torch.from_numpy(sample), torch.from_numpy(out), torch.tensor([500, 20]))
    ref = jsched.get_velocity(jstate, jnp.asarray(sample), jnp.asarray(out), jnp.asarray([500, 20]))
    assert _max_diff(velocity, ref) <= STEP_ATOL


def test_ddim_eta_draws_from_the_generator():
    sched = DDIMScheduler(**DDIM)
    state = sched.set_timesteps(10)
    sample, out = torch.randn(1, 4, 8, 8), torch.randn(1, 4, 8, 8)
    t = state.timesteps[3]
    drawn = sched.step(state, out, t, sample, eta=0.5, generator=torch.Generator().manual_seed(7)).prev_sample
    noise = torch.randn(1, 4, 8, 8, generator=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(drawn.numpy(), sched.step(state, out, t, sample, eta=0.5,
                                                            variance_noise=noise).prev_sample.numpy())
    with pytest.raises(ValueError, match="eta > 0"):
        sched.step(state, out, t, sample, eta=0.5)


# ---------------------------------------------------------------------------- the SD 1.5 UNet


def test_sd15_unet_config_matches_jax():
    """SD 1.5's UNet shape: 1x1-conv proj_in / proj_out, heads of d = channels / 2, no added embedding;
    the output within 5e-4 of JAX's, and the batch-2 CFG call too."""
    jax_parts, torch_parts = sd_parts()
    (jax_unet, jax_params), unet = jax_parts["unet"], torch_parts["unet"]
    t2d = unet.down_blocks[0].attentions[0]
    assert isinstance(t2d.proj_in, Conv2d) and isinstance(t2d.proj_out, Conv2d) and not t2d.use_linear_projection
    assert t2d.transformer_blocks[0].attn1.dim_head == 4 and unet.up_blocks[1].attentions[0].transformer_blocks[
        0].attn2.dim_head == 4
    assert not hasattr(unet, "add_embedding") and unet.encoder_hid_proj is None
    rng = np.random.RandomState(3)
    sample = rng.randn(2, 4, 8, 8).astype(np.float32)
    ehs = rng.randn(2, 77, 16).astype(np.float32)
    ref = jax.jit(lambda p, x, e: jax_unet(p, x, jnp.asarray([981, 981]), encoder_hidden_states=e).sample)(
        jax_params, jnp.asarray(sample), jnp.asarray(ehs))
    with torch.no_grad():
        out = unet(torch.from_numpy(sample), torch.tensor([981, 981]), torch.from_numpy(ehs)).sample
    assert _max_diff(out, ref) <= MODEL_ATOL


# ---------------------------------------------------------------------------- pipelines


@pytest.mark.parametrize("scheduler", list(SCHEDULERS))
def test_sd_text_to_image_matches_jax(t2i, scheduler):
    jpipe, tpipe = t2i[scheduler]
    kwargs = dict(num_inference_steps=4, guidance_scale=7.5, output_type="np")
    ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), **kwargs).images)
    out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).images
    assert out.shape == (1, 8, 8, 3) and out.dtype == np.float32 and np.isfinite(out).all()
    assert _max_diff(out, ref) <= IMAGE_ATOL


def test_sd_text_to_image_batch_negative_and_outputs(t2i):
    """Two images a prompt and a negative prompt, without CFG too; "latent" and "pil" outputs."""
    jpipe, tpipe = t2i["pndm"]
    latents = np.concatenate([LATENTS, LATENTS[:, ::-1]])
    for guidance in (7.5, 1.0):
        kwargs = dict(num_inference_steps=3, guidance_scale=guidance, negative_prompt="blurry", output_type="latent",
                      num_images_per_prompt=2)
        ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(latents), **kwargs).images)
        out = tpipe(PROMPT, latents=torch.from_numpy(latents.copy()), **kwargs).images
        assert out.shape == (2, 4, 8, 8) and _max_diff(out, ref) <= IMAGE_ATOL
    images = tpipe(PROMPT, num_inference_steps=2, generator=torch.Generator().manual_seed(0)).images
    assert len(images) == 1 and np.asarray(images[0]).shape == (8, 8, 3)
    from diffusers_tpu_torch.hooks import TaylorSeerCacheConfig

    with pytest.raises(TypeError):
        tpipe.enable_cache(TaylorSeerCacheConfig())
    with pytest.raises(NotImplementedError, match="safety checker"):
        StableDiffusionPipeline(**dict(tpipe.components, safety_checker=object(), device="cpu"))
    assert tpipe.config.safety_checker == (None, None) and tpipe.config.requires_safety_checker is False


def test_sd_cfg_cutoff_callback_matches_jax(t2i):
    jpipe, tpipe = t2i["ddim"]
    seen, jseen = {}, {}

    def spy(cb, record):
        def fn(pipe, i, t, cbk):
            cbk = cb(pipe, i, t, cbk)
            record[i] = int(cbk["prompt_embeds"].shape[0])
            return cbk
        return fn

    kwargs = dict(num_inference_steps=5, guidance_scale=7.5, output_type="latent")
    ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), **kwargs,
                           callback_on_step_end=spy(JaxSDCFGCutoffCallback(cutoff_step_index=2), jseen)).images)
    out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs,
                callback_on_step_end=spy(SDCFGCutoffCallback(cutoff_step_index=2), seen)).images
    assert seen == jseen == {0: 2, 1: 2, 2: 1, 3: 1, 4: 1}
    assert _max_diff(out, ref) <= IMAGE_ATOL
    dense = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).images
    assert _max_diff(out, dense) > IMAGE_ATOL  # the cutoff changed the result


def test_sd_img2img_matches_jax(draws):  # noqa: F811
    jpipe, tpipe = sd_pipelines(JaxImg2Img, StableDiffusionImg2ImgPipeline, scheduler="pndm")
    kwargs = dict(image=IMAGE, strength=0.75, num_inference_steps=4, guidance_scale=7.5, output_type="np")
    ref = np.asarray(jpipe(PROMPT, key=jax.random.PRNGKey(SEED), **kwargs).images)
    out = tpipe(PROMPT, **kwargs).images
    assert not draws  # the port drew the encoder's sample, then the noise
    assert out.shape == (1, 8, 8, 3) and np.isfinite(out).all()
    assert _max_diff(out, ref) <= IMAGE_ATOL


def test_sd_inpaint_9_channel_matches_jax(draws):  # noqa: F811
    jpipe, tpipe = sd_pipelines(JaxInpaint, StableDiffusionInpaintPipeline, scheduler="ddim", in_channels=9)
    kwargs = dict(image=IMAGE, mask_image=MASK, num_inference_steps=3, guidance_scale=7.5, output_type="np")
    ref = np.asarray(jpipe(PROMPT, key=jax.random.PRNGKey(SEED), **kwargs).images)
    out = tpipe(PROMPT, **kwargs).images
    assert not draws
    assert out.shape == (1, 8, 8, 3) and _max_diff(out, ref) <= IMAGE_ATOL


def _upstream_blend_loop(jpipe, steps, guidance_scale):
    """SD's 4-channel inpaint loop at upstream diffusers' rule, composed from
    the JAX pipeline's own CLIP, UNet, VAE and PNDM: after step i the known
    region is the init latents noised to timesteps[i + 1], after the last
    step the clean init latents. Returns (final latents, clean init latents)."""
    unet, unet_params = jpipe.unet
    vae, vae_params = jpipe.vae
    sched = jpipe.scheduler
    init = jnp.asarray(jpipe.image_processor.preprocess(IMAGE))
    embeds = jpipe.encode_prompt(PROMPT)
    enc_draw, noise = (jnp.asarray(d) for d in jax_draws((1, 4, 8, 8)))
    posterior = vae.encode(vae_params, init)
    init_latents = (posterior.mean + posterior.std * enc_draw) * vae.config.scaling_factor
    mask = jnp.asarray((MASK > 0.5).astype(np.float32))[None, None]
    state = sched.set_timesteps(steps)
    timesteps = state.timesteps
    unet_call = jax.jit(lambda p, x, t: unet(p, x, jnp.broadcast_to(t, (2,)), encoder_hidden_states=embeds).sample)
    latents = noise * state.init_noise_sigma
    for i, t in enumerate(timesteps):
        uncond, text = jnp.split(unet_call(unet_params, jnp.concatenate([latents, latents]), t), 2)
        out = sched.step(state, uncond + guidance_scale * (text - uncond), t, latents)
        latents, state = out.prev_sample, out.state
        known = init_latents if i == len(timesteps) - 1 else sched.add_noise(state, init_latents, noise,
                                                                             timesteps[i + 1:i + 2])
        latents = (1 - mask) * known + mask * latents
    return np.asarray(latents), np.asarray(init_latents)


def test_sd_inpaint_4_channel_blend_upstream_rule_and_jax_fault(monkeypatch):
    """The port's 4-channel blend is upstream's (held to a loop composed from
    JAX's parts; the known region comes back as the clean init latents);
    JAX's pipeline noises the known region to the current timestep after
    each step and leaves noise there at the end (ROADMAP C4)."""
    jpipe, tpipe = sd_pipelines(JaxInpaint, StableDiffusionInpaintPipeline, scheduler="pndm")
    ref_latents, init_latents = _upstream_blend_loop(jpipe, steps=3, guidance_scale=7.5)
    queue = jax_draws((1, 4, 8, 8))
    monkeypatch.setattr(torch_utils, "randn_tensor", lambda shape, g=None, d=None: torch.from_numpy(queue.pop(0)))
    kwargs = dict(image=IMAGE, mask_image=MASK, num_inference_steps=3, guidance_scale=7.5, output_type="latent")
    latents = tpipe(PROMPT, **kwargs).images.numpy()
    assert _max_diff(latents, ref_latents) <= IMAGE_ATOL
    known = np.broadcast_to(MASK <= 0.5, latents.shape)
    assert np.max(np.abs(latents[known] - init_latents[known])) <= 1e-5
    assert np.max(np.abs(latents[~known] - init_latents[~known])) > 0.1
    # JAX's rule: after the last step (t = 1) the known region is init latents noised to t = 1
    jax_latents = np.asarray(jpipe(PROMPT, key=jax.random.PRNGKey(SEED), **kwargs).images)
    _, noise = jax_draws((1, 4, 8, 8))
    acp = PNDMScheduler(**PNDM).alphas_cumprod[1]
    expected = np.sqrt(acp) * init_latents + np.sqrt(1 - acp) * noise
    np.testing.assert_allclose(jax_latents[known], expected[known], atol=1e-5)
    assert np.max(np.abs(jax_latents[known] - init_latents[known])) > 1e-3


# ---------------------------------------------------------------------------- from_pretrained


def test_sd15_layout_from_pretrained(tmp_path, t2i):
    """A directory in stable-diffusion-v1-5/stable-diffusion-v1-5's layout
    (its model_index.json, a transformers-layout CLIPTextModel, a real CLIP
    tokenizer, PNDM's published scheduler_config.json, a safety_checker and
    a feature_extractor entry) loads into the port, bit-equal to the
    in-memory pipeline and giving the same image."""
    from chip_smoke import clip_tokenizer

    _, tpipe = t2i["pndm"]
    root = tmp_path / "sd15"
    tpipe.unet.save_pretrained(root / "unet")
    tpipe.vae.save_pretrained(root / "vae")
    tpipe.text_encoder.save_pretrained(root / "text_encoder")
    tokenizer = clip_tokenizer(root / "tokenizer")
    (root / "scheduler").mkdir()
    (root / "scheduler" / "scheduler_config.json").write_text(json.dumps({
        "_class_name": "PNDMScheduler", "_diffusers_version": "0.6.0", "beta_end": 0.012,
        "beta_schedule": "scaled_linear", "beta_start": 0.00085, "num_train_timesteps": 1000,
        "set_alpha_to_one": False, "skip_prk_steps": True, "steps_offset": 1, "trained_betas": None,
        "clip_sample": False}))
    (root / "safety_checker").mkdir()
    (root / "safety_checker" / "config.json").write_text(json.dumps({"architectures": ["StableDiffusionSafetyChecker"]}))
    (root / "feature_extractor").mkdir()
    (root / "feature_extractor" / "preprocessor_config.json").write_text(json.dumps({
        "crop_size": 224, "do_center_crop": True, "do_convert_rgb": True, "do_normalize": True, "do_resize": True,
        "feature_extractor_type": "CLIPFeatureExtractor", "image_mean": [0.48145466, 0.4578275, 0.40821073],
        "image_std": [0.26862954, 0.26130258, 0.27577711], "resample": 3, "size": 224}))
    (root / "model_index.json").write_text(json.dumps({
        "_class_name": "StableDiffusionPipeline", "_diffusers_version": "0.6.0",
        "feature_extractor": ["transformers", "CLIPImageProcessor"],
        "safety_checker": ["stable_diffusion", "StableDiffusionSafetyChecker"],
        "scheduler": ["diffusers", "PNDMScheduler"], "text_encoder": ["transformers", "CLIPTextModel"],
        "tokenizer": ["transformers", "CLIPTokenizer"], "unet": ["diffusers", "UNet2DConditionModel"],
        "vae": ["diffusers", "AutoencoderKL"], "requires_safety_checker": True}))
    loaded = StableDiffusionPipeline.from_pretrained(root, device="cpu")
    assert isinstance(loaded.scheduler, PNDMScheduler) and loaded.scheduler.config.skip_prk_steps
    assert loaded.safety_checker is None and loaded.config.requires_safety_checker is True
    assert loaded.feature_extractor is not None and loaded.image_encoder is None
    for name in ("unet", "vae", "text_encoder"):
        a, b = getattr(loaded, name).state_dict(), getattr(tpipe, name).state_dict()
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    kwargs = dict(latents=torch.from_numpy(LATENTS), num_inference_steps=2, output_type="np")
    direct = StableDiffusionPipeline(**dict(tpipe.components, tokenizer=tokenizer, device="cpu"))
    np.testing.assert_array_equal(loaded(PROMPT, **kwargs).images, direct(PROMPT, **kwargs).images)

"""The port's SDXL img2img and inpaint pipelines against the JAX ones, end to
end on the CPU.

The tiny components of tests/test_torch_pipeline_sdxl.py (the 9-channel
inpainting UNet: the same widths with `in_channels=9`), the port's seeded
weights carried into JAX with `convert_torch_state_dict`, as
tests/test_torch_pipeline_cache.py does. Both pipelines get the same random
draws: the JAX pipeline splits its key into (key, encoder key, noise key)
and draws the encoder's sample, then the noise; the port's one
`utils.torch_utils.randn_tensor` is made to return those two draws in that
order.

Tolerance: max-abs `1e-3` on the [0, 1] image (and on the latents), the
existing pipeline tests' limit; float32 on both sides, so the differences
are summation order.

The 4-channel inpaint blend follows upstream diffusers, not JAX (ROADMAP C):
the port is held to a loop composed here from JAX's own UNet, VAE and
scheduler at upstream's rule, and its final latents equal the clean init
latents exactly outside the mask, where the JAX pipeline leaves
sigma(t_last) of noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.models.autoencoders.autoencoder_kl import AutoencoderKL as JaxAutoencoderKL
from diffusers_tpu.models.text_encoders.clip import CLIPTextModel as JaxCLIPTextModel
from diffusers_tpu.models.text_encoders.clip import CLIPTextModelWithProjection as JaxCLIPTextModelWithProjection
from diffusers_tpu.models.unets.unet_2d_condition import UNet2DConditionModel as JaxUNet2DConditionModel
from diffusers_tpu.pipelines.stable_diffusion_xl.pipeline_stable_diffusion_xl_img2img import (
    StableDiffusionXLImg2ImgPipeline as JaxImg2Img,
)
from diffusers_tpu.pipelines.stable_diffusion_xl.pipeline_stable_diffusion_xl_inpaint import (
    StableDiffusionXLInpaintPipeline as JaxInpaint,
)
from diffusers_tpu.schedulers import EulerDiscreteScheduler as JaxEulerDiscreteScheduler
from diffusers_tpu.utils.jax_utils import randn_tensor as jax_randn
from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel, CLIPTextModelWithProjection
from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
from diffusers_tpu_torch.pipelines.stable_diffusion_xl import (
    StableDiffusionXLImg2ImgPipeline,
    StableDiffusionXLInpaintPipeline,
)
from diffusers_tpu_torch.schedulers import EulerDiscreteScheduler
from diffusers_tpu_torch.utils import torch_utils
from test_torch_pipeline_cache import _parts
from test_torch_pipeline_sdxl import CLIP, EULER, UNET, VAE, CRCTokenizer

torch.set_num_threads(1)

ATOL = 1e-3
PROMPT = "a red barn in the snow"
SEED = 3
RNG = np.random.RandomState(0)
IMAGE = RNG.rand(8, 8, 3).astype(np.float32)  # HWC in [0, 1]: the tiny VAE keeps 8 x 8 latents
MASK = np.zeros((8, 8), np.float32)
MASK[2:6, 1:5] = 0.8  # binarized at 0.5: repaint a 4 x 4 square


def _pipelines(jcls, tcls, in_channels=4):
    jax_parts, torch_parts = _parts([
        ("unet", JaxUNet2DConditionModel, UNet2DConditionModel, dict(UNET, in_channels=in_channels)),
        ("vae", JaxAutoencoderKL, AutoencoderKL, VAE),
        ("text_encoder", JaxCLIPTextModel, CLIPTextModel, CLIP),
        ("text_encoder_2", JaxCLIPTextModelWithProjection, CLIPTextModelWithProjection, CLIP),
    ], seed=in_channels)
    jpipe = jcls(tokenizer=CRCTokenizer(), tokenizer_2=CRCTokenizer(), scheduler=JaxEulerDiscreteScheduler(**EULER),
                 **jax_parts)
    tpipe = tcls(tokenizer=CRCTokenizer(), tokenizer_2=CRCTokenizer(), scheduler=EulerDiscreteScheduler(**EULER),
                 device="cpu", **torch_parts)
    return jpipe, tpipe


def jax_draws(shape, seed=SEED):
    """The JAX pipelines' (encoder sample, noise) draws for PRNGKey(seed)."""
    _, enc_key, noise_key = jax.random.split(jax.random.PRNGKey(seed), 3)
    return [np.array(jax_randn(shape, key=enc_key)), np.array(jax_randn(shape, key=noise_key))]


@pytest.fixture
def draws(monkeypatch):
    """Makes the port's `randn_tensor` return JAX's draws, in order."""
    queue = jax_draws((1, 4, 8, 8))

    def randn_tensor(shape, generator=None, device=None):
        out = queue.pop(0)
        assert tuple(shape) == out.shape
        return torch.from_numpy(out).to(device)

    monkeypatch.setattr(torch_utils, "randn_tensor", randn_tensor)
    return queue


def test_img2img_matches_jax(draws):
    jpipe, tpipe = _pipelines(JaxImg2Img, StableDiffusionXLImg2ImgPipeline)
    kwargs = dict(image=IMAGE, strength=0.7, num_inference_steps=3, guidance_scale=5.0, output_type="np")
    ref = np.asarray(jpipe(PROMPT, key=jax.random.PRNGKey(SEED), **kwargs).images)
    out = tpipe(PROMPT, **kwargs).images
    assert not draws  # the port drew the encoder's sample and the noise
    assert out.shape == (1, 8, 8, 3) and np.isfinite(out).all()
    assert np.max(np.abs(out - ref)) <= ATOL


def test_inpaint_9_channel_matches_jax(draws):
    jpipe, tpipe = _pipelines(JaxInpaint, StableDiffusionXLInpaintPipeline, in_channels=9)
    kwargs = dict(image=IMAGE, mask_image=MASK, num_inference_steps=2, guidance_scale=5.0, output_type="np")
    ref = np.asarray(jpipe(PROMPT, key=jax.random.PRNGKey(SEED), **kwargs).images)
    out = tpipe(PROMPT, **kwargs).images
    assert not draws
    assert out.shape == (1, 8, 8, 3) and np.isfinite(out).all()
    assert np.max(np.abs(out - ref)) <= ATOL


def _upstream_blend_loop(jpipe, steps, guidance_scale):
    """The 4-channel inpaint loop at upstream diffusers' rule, composed from
    the JAX pipeline's own encoders, UNet, VAE and scheduler: after step i
    the known region is the init latents noised to timesteps[i + 1], after
    the last step the clean init latents. Returns (final latents, [0, 1]
    image, clean init latents)."""
    unet, unet_params = jpipe.unet
    vae, vae_params = jpipe.vae
    sched = jpipe.scheduler
    init = jnp.asarray(jpipe.image_processor.preprocess(IMAGE))
    embeds, neg, pooled, neg_pooled = jpipe.encode_prompt(PROMPT, None, None, None, True)
    time_ids = jpipe._get_add_time_ids((8, 8), (0, 0), (8, 8), 1)
    embeds, text_embeds = jnp.concatenate([neg, embeds]), jnp.concatenate([neg_pooled, pooled])
    time_ids = jnp.concatenate([time_ids, time_ids])
    enc_draw, noise = (jnp.asarray(d) for d in jax_draws((1, 4, 8, 8)))
    posterior = vae.encode(vae_params, init)
    init_latents = (posterior.mean + posterior.std * enc_draw) * vae.config.scaling_factor
    mask = jnp.asarray((MASK > 0.5).astype(np.float32))[None, None]
    state = sched.set_timesteps(steps)
    timesteps = state.timesteps
    unet_call = jax.jit(lambda p, x, t: unet(p, x, jnp.broadcast_to(t, (2,)), encoder_hidden_states=embeds,
                                             added_cond_kwargs={"text_embeds": text_embeds, "time_ids": time_ids}).sample)
    latents = noise * state.init_noise_sigma
    for i, t in enumerate(timesteps):
        x = sched.scale_model_input(state, jnp.concatenate([latents, latents]), t)
        uncond, text = jnp.split(unet_call(unet_params, x, t), 2)
        latents = sched.step(state, uncond + guidance_scale * (text - uncond), t, latents).prev_sample
        known = init_latents if i == len(timesteps) - 1 else sched.add_noise(state, init_latents, noise,
                                                                             timesteps[i + 1:i + 2])
        latents = (1 - mask) * known + mask * latents
    image = vae.decode(vae_params, latents / vae.config.scaling_factor).sample
    image = np.clip(np.asarray(image) / 2 + 0.5, 0, 1).transpose(0, 2, 3, 1)
    return np.asarray(latents), image, np.asarray(init_latents)


def test_inpaint_4_channel_blend_matches_upstream_rule(monkeypatch):
    jpipe, tpipe = _pipelines(JaxInpaint, StableDiffusionXLInpaintPipeline)
    ref_latents, ref_image, init_latents = _upstream_blend_loop(jpipe, steps=2, guidance_scale=5.0)
    outs = {}
    for output_type in ("latent", "np"):
        queue = jax_draws((1, 4, 8, 8))
        monkeypatch.setattr(torch_utils, "randn_tensor", lambda shape, g=None, d=None: torch.from_numpy(queue.pop(0)))
        outs[output_type] = tpipe(PROMPT, image=IMAGE, mask_image=MASK, num_inference_steps=2, guidance_scale=5.0,
                                  output_type=output_type).images
    latents = outs["latent"].numpy()
    assert np.max(np.abs(latents - ref_latents)) <= ATOL
    assert np.max(np.abs(outs["np"] - ref_image)) <= ATOL
    # the known region came back (to JAX's VAE's summation order; bit for bit against the port's own
    # init latents in the next test), the masked one was repainted
    known = np.broadcast_to(MASK <= 0.5, latents.shape)
    assert np.max(np.abs(latents[known] - init_latents[known])) <= 1e-5
    assert np.max(np.abs(latents[~known] - init_latents[~known])) > 0.1


def test_jax_inpaint_blend_leaves_noise_in_the_known_region(monkeypatch):
    """The fault the port does not copy: JAX's 4-channel loop noises the
    known region to the current timestep after each step, so its final
    latents hold sigma(t_last) * noise there; the port's hold none."""
    jpipe, tpipe = _pipelines(JaxInpaint, StableDiffusionXLInpaintPipeline)
    kwargs = dict(image=IMAGE, mask_image=MASK, num_inference_steps=2, guidance_scale=5.0, output_type="latent")
    ref = np.asarray(jpipe(PROMPT, key=jax.random.PRNGKey(SEED), **kwargs).images)
    enc_draw, noise = jax_draws((1, 4, 8, 8))
    queue = [enc_draw, noise]
    monkeypatch.setattr(torch_utils, "randn_tensor", lambda shape, g=None, d=None: torch.from_numpy(queue.pop(0)))
    out = tpipe(PROMPT, **kwargs).images.numpy()
    with torch.no_grad():
        posterior = tpipe.vae.encode(torch.from_numpy(tpipe.image_processor.preprocess(IMAGE)))
        init_latents = ((posterior.mean + posterior.std * torch.from_numpy(enc_draw))
                        * tpipe.vae.config.scaling_factor).numpy()
    known = np.broadcast_to(MASK <= 0.5, out.shape)
    np.testing.assert_array_equal(out[known], init_latents[known])
    sigma_last = float(EulerDiscreteScheduler(**EULER).set_timesteps(2).sigmas[1])
    residual = ref[known] - init_latents[known]
    np.testing.assert_allclose(residual, sigma_last * noise[known], rtol=1e-3, atol=1e-4)
    assert np.max(np.abs(residual)) > 0.1


def test_image_pipelines_refuse_caches_and_bad_strength():
    _, tpipe = _pipelines(JaxImg2Img, StableDiffusionXLImg2ImgPipeline)
    from diffusers_tpu_torch.hooks import TaylorSeerCacheConfig

    with pytest.raises(TypeError):
        tpipe.enable_cache(TaylorSeerCacheConfig())
    with pytest.raises(ValueError, match="zero denoise steps"):
        tpipe(PROMPT, image=IMAGE, strength=0.1, num_inference_steps=3, output_type="latent")
    inpaint = StableDiffusionXLInpaintPipeline(
        tokenizer=CRCTokenizer(), tokenizer_2=CRCTokenizer(), scheduler=EulerDiscreteScheduler(**EULER), device="cpu",
        unet=tpipe.unet, vae=tpipe.vae, text_encoder=tpipe.text_encoder, text_encoder_2=tpipe.text_encoder_2)
    for pipe, extra in ((tpipe, {}), (inpaint, {"mask_image": MASK})):
        for strength in (-0.1, 5.0):
            with pytest.raises(ValueError, match="strength must be in"):
                pipe(PROMPT, image=IMAGE, strength=strength, num_inference_steps=3, output_type="latent", **extra)
    gen = torch.Generator().manual_seed(0)
    images = tpipe(PROMPT, image=IMAGE, strength=0.7, num_inference_steps=3, generator=gen, output_type="pil").images
    assert len(images) == 1 and np.asarray(images[0]).shape == (8, 8, 3)

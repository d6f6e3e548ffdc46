"""The port's ControlNetModel, the UNet's ControlNet residuals and the SDXL
ControlNet pipeline against the JAX ones on the CPU.

The SDXL-shaped tiny components of tests/test_torch_pipeline_sdxl.py and the
tiny SDXL ControlNet of tests/test_controlnet.py (its widths; the
conditioning embedding halves the image, so a 16 x 16 edge map steers 8 x 8
latents), the port's seeded weights carried into JAX with
`convert_torch_state_dict`. Tolerances: models max-abs `< 5e-4`,
pipelines `1e-3` on the [0, 1] image (float32 on both sides).

Guess mode under CFG follows upstream diffusers, not JAX (ROADMAP C): the
ControlNet sees the conditional half only and the unconditional half's
residuals are zeros. The port is held to a loop composed here from JAX's own
ControlNet, UNet and scheduler at that rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.models.autoencoders.autoencoder_kl import AutoencoderKL as JaxAutoencoderKL
from diffusers_tpu.models.controlnets.controlnet import ControlNetModel as JaxControlNetModel
from diffusers_tpu.models.modeling_utils import convert_torch_state_dict
from diffusers_tpu.models.text_encoders.clip import CLIPTextModel as JaxCLIPTextModel
from diffusers_tpu.models.text_encoders.clip import CLIPTextModelWithProjection as JaxCLIPTextModelWithProjection
from diffusers_tpu.models.unets.unet_2d_condition import UNet2DConditionModel as JaxUNet2DConditionModel
from diffusers_tpu.pipelines.controlnet.pipeline_controlnet_sd_xl import (
    StableDiffusionXLControlNetPipeline as JaxControlNetPipeline,
)
from diffusers_tpu.schedulers import EulerDiscreteScheduler as JaxEulerDiscreteScheduler
from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
from diffusers_tpu_torch.models.controlnets import ControlNetModel
from diffusers_tpu_torch.models.modeling_utils import load_jax_params
from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel, CLIPTextModelWithProjection
from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
from diffusers_tpu_torch.pipelines.controlnet import StableDiffusionXLControlNetPipeline
from diffusers_tpu_torch.schedulers import EulerDiscreteScheduler
from test_torch_pipeline_cache import _parts
from test_torch_pipeline_sdxl import CLIP, EULER, UNET, VAE, CRCTokenizer

torch.set_num_threads(1)

MODEL_ATOL = 5e-4
IMAGE_ATOL = 1e-3
PROMPT = "a glass house on a cliff"
# tests/test_controlnet.py's SDXL ControlNet widths (text_time; cross attention over both CLIP towers)
CN = dict(
    in_channels=4, down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"), block_out_channels=(8, 16),
    layers_per_block=1, attention_head_dim=(2, 4), transformer_layers_per_block=(1, 2), use_linear_projection=True,
    cross_attention_dim=32, addition_embed_type="text_time", addition_time_embed_dim=8,
    projection_class_embeddings_input_dim=16 + 6 * 8, norm_num_groups=4, conditioning_embedding_out_channels=(8, 16),
)
RNG = np.random.RandomState(0)
EDGES = (RNG.rand(16, 16, 3) > 0.7).astype(np.float32)  # a binary edge map, HWC
LATENTS = RNG.randn(1, 4, 8, 8).astype(np.float32)
X = RNG.randn(2, 4, 8, 8).astype(np.float32)
EHS = RNG.randn(2, 77, 32).astype(np.float32)
COND = RNG.rand(2, 3, 16, 16).astype(np.float32)
ADDED = {"text_embeds": RNG.randn(2, 16).astype(np.float32),
         "time_ids": np.array([[16, 16, 0, 0, 16, 16]] * 2, np.float32)}


def _controlnets(**overrides):
    """(JAX ControlNet, its params, port ControlNet), the port's seeded weights, 1-D ones jittered."""
    torch.manual_seed(11)
    cfg = dict(CN, **overrides)
    tm = ControlNetModel(**cfg).eval()
    rng = np.random.RandomState(11)
    with torch.no_grad():
        for p in tm.parameters():
            if p.ndim == 1:
                p.add_(torch.from_numpy(0.1 * rng.randn(*p.shape).astype(np.float32)))
    jm = JaxControlNetModel(**cfg)
    return jm, convert_torch_state_dict(jm, {k: v.numpy() for k, v in tm.state_dict().items()}), tm


def _run_both(jm, params, tm, **kwargs):
    jout = jm(params, jnp.asarray(X), 421.0, jnp.asarray(EHS), jnp.asarray(COND),
              added_cond_kwargs={k: jnp.asarray(v) for k, v in ADDED.items()}, **kwargs)
    with torch.no_grad():
        tout = tm(torch.from_numpy(X), 421.0, torch.from_numpy(EHS), torch.from_numpy(COND),
                  added_cond_kwargs={k: torch.from_numpy(v) for k, v in ADDED.items()}, **kwargs)
    return jout, tout


@pytest.mark.parametrize("config, kwargs", [
    ({}, dict(conditioning_scale=0.7)),
    ({}, dict(conditioning_scale=0.7, guess_mode=True)),
    ({"global_pool_conditions": True}, dict(conditioning_scale=1.3)),
    ({"controlnet_conditioning_channel_order": "bgr"}, dict(conditioning_scale=0.5)),
], ids=["scale", "guess-mode", "global-pool", "bgr"])
def test_controlnet_model_matches_jax(config, kwargs):
    jout, tout = _run_both(*_controlnets(**config), **kwargs)
    assert len(tout.down_block_res_samples) == len(jout.down_block_res_samples) == 4
    for mine, ref in zip((*tout.down_block_res_samples, tout.mid_block_res_sample),
                         (*jout.down_block_res_samples, jout.mid_block_res_sample)):
        assert mine.shape == ref.shape
        assert np.max(np.abs(mine.numpy() - np.asarray(ref))) < MODEL_ATOL


def test_unet_with_residuals_matches_jax():
    jm, params, tm = _controlnets()
    jres, tres = _run_both(jm, params, tm, conditioning_scale=0.8)
    jax_parts, torch_parts = _parts([("unet", JaxUNet2DConditionModel, UNet2DConditionModel, UNET)], seed=5)
    (ju, jp), tu = jax_parts["unet"], torch_parts["unet"]
    added = {k: jnp.asarray(v) for k, v in ADDED.items()}
    ref = ju(jp, jnp.asarray(X), 421.0, jnp.asarray(EHS), added_cond_kwargs=added,
             down_block_additional_residuals=jres.down_block_res_samples,
             mid_block_additional_residual=jres.mid_block_res_sample).sample
    with torch.no_grad():
        out = tu(torch.from_numpy(X), 421.0, torch.from_numpy(EHS),
                 added_cond_kwargs={k: torch.from_numpy(v) for k, v in ADDED.items()},
                 down_block_additional_residuals=tres.down_block_res_samples,
                 mid_block_additional_residual=tres.mid_block_res_sample).sample
        plain = tu(torch.from_numpy(X), 421.0, torch.from_numpy(EHS),
                   added_cond_kwargs={k: torch.from_numpy(v) for k, v in ADDED.items()}).sample
    assert np.max(np.abs(out.numpy() - np.asarray(ref))) < MODEL_ATOL
    assert float((out - plain).abs().max()) > 10 * MODEL_ATOL  # the residuals act


def test_load_jax_params_carries_a_jax_controlnet():
    """A JAX ControlNet's parameter tree (here: the port's weights through
    JAX's `convert_torch_state_dict`, then moved) loads into the port with
    `load_jax_params`, and JAX's `convert_torch_state_dict` carries the
    port's state dict back: both exact."""
    jm, params, tm = _controlnets()
    moved = jax.tree_util.tree_map(lambda a: np.asarray(a) * 1.5 - 0.25, params)
    fresh = load_jax_params(ControlNetModel(**CN), moved)
    back = convert_torch_state_dict(jm, {k: v.numpy() for k, v in fresh.state_dict().items()})
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)), back, moved)
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(fresh.state_dict()[k].numpy(), v.numpy() * 1.5 - 0.25, rtol=1e-6, atol=1e-6)


def _pipelines(controlnet_dir=None):
    jax_parts, torch_parts = _parts([
        ("unet", JaxUNet2DConditionModel, UNet2DConditionModel, UNET),
        ("vae", JaxAutoencoderKL, AutoencoderKL, VAE),
        ("text_encoder", JaxCLIPTextModel, CLIPTextModel, CLIP),
        ("text_encoder_2", JaxCLIPTextModelWithProjection, CLIPTextModelWithProjection, CLIP),
    ], seed=7)
    jm, params, tm = _controlnets()
    if controlnet_dir is not None:  # a ControlNet from from_pretrained drops in as it is
        tm.save_pretrained(controlnet_dir)
        tm = ControlNetModel.from_pretrained(controlnet_dir, device="cpu")
    jpipe = JaxControlNetPipeline(tokenizer=CRCTokenizer(), tokenizer_2=CRCTokenizer(), controlnet=(jm, params),
                                  scheduler=JaxEulerDiscreteScheduler(**EULER), **jax_parts)
    tpipe = StableDiffusionXLControlNetPipeline(tokenizer=CRCTokenizer(), tokenizer_2=CRCTokenizer(), controlnet=tm,
                                                scheduler=EulerDiscreteScheduler(**EULER), device="cpu",
                                                **torch_parts)
    return jpipe, tpipe


def test_controlnet_pipeline_matches_jax(tmp_path):
    jpipe, tpipe = _pipelines(tmp_path)
    kwargs = dict(image=EDGES, height=8, width=8, num_inference_steps=2, guidance_scale=5.0,
                  controlnet_conditioning_scale=0.8, output_type="np")
    ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), **kwargs).images)
    out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).images
    assert out.shape == (1, 8, 8, 3) and np.isfinite(out).all()
    assert np.max(np.abs(out - ref)) <= IMAGE_ATOL
    assert tpipe.controlnet in tpipe.components.values()


def _upstream_guess_mode_loop(jpipe, steps, guidance_scale, scale):
    """Guess mode under CFG at upstream diffusers' rule, composed from the
    JAX pipeline's own encoders, ControlNet, UNet and scheduler: the
    ControlNet runs on the conditional half (its latents, embeddings and
    micro-conditioning) and the unconditional half's residuals are zeros.
    Returns the final latents."""
    unet, unet_params = jpipe.unet
    cn, cn_params = jpipe.controlnet
    sched = jpipe.scheduler
    cond = jnp.asarray(jpipe.image_processor.preprocess(EDGES))
    cond = jnp.clip((cond + 1) / 2, 0, 1)
    embeds, neg, pooled, neg_pooled = jpipe.encode_prompt(PROMPT, None, None, None, True)
    time_ids = jpipe._get_add_time_ids((8, 8), (0, 0), (8, 8), 1)
    added = {"text_embeds": jnp.concatenate([neg_pooled, pooled]), "time_ids": jnp.concatenate([time_ids, time_ids])}
    all_embeds = jnp.concatenate([neg, embeds])

    @jax.jit
    def noise_pred(latents, t, state):
        x = sched.scale_model_input(state, jnp.concatenate([latents, latents]), t)
        res = cn(cn_params, sched.scale_model_input(state, latents, t), jnp.broadcast_to(t, (1,)), embeds, cond,
                 conditioning_scale=scale, guess_mode=True, added_cond_kwargs={"text_embeds": pooled,
                                                                               "time_ids": time_ids})
        down = tuple(jnp.concatenate([jnp.zeros_like(r), r]) for r in res.down_block_res_samples)
        mid = jnp.concatenate([jnp.zeros_like(res.mid_block_res_sample), res.mid_block_res_sample])
        out = unet(unet_params, x, jnp.broadcast_to(t, (2,)), encoder_hidden_states=all_embeds,
                   added_cond_kwargs=added, down_block_additional_residuals=down,
                   mid_block_additional_residual=mid).sample
        uncond, text = jnp.split(out, 2)
        return uncond + guidance_scale * (text - uncond)

    state = sched.set_timesteps(steps)
    latents = jnp.asarray(LATENTS) * state.init_noise_sigma
    for t in state.timesteps:
        latents = sched.step(state, noise_pred(latents, t, state), t, latents).prev_sample
    return np.asarray(latents)


def test_guess_mode_under_cfg_follows_upstream():
    jpipe, tpipe = _pipelines()
    ref = _upstream_guess_mode_loop(jpipe, steps=2, guidance_scale=5.0, scale=0.8)
    seen = []
    hook = tpipe.unet.register_forward_pre_hook(
        lambda mod, args, kwargs: seen.append((kwargs["down_block_additional_residuals"],
                                               kwargs["mid_block_additional_residual"])), with_kwargs=True)
    try:
        out = tpipe(PROMPT, image=EDGES, height=8, width=8, num_inference_steps=2, guidance_scale=5.0,
                    controlnet_conditioning_scale=0.8, guess_mode=True, latents=torch.from_numpy(LATENTS),
                    output_type="latent").images
    finally:
        hook.remove()
    assert np.max(np.abs(out.numpy() - ref)) <= IMAGE_ATOL
    assert len(seen) == 2
    for down, mid in seen:  # the unconditional half's residuals are zeros, the conditional half's are not
        for r in (*down, mid):
            assert r.shape[0] == 2 and not r[0].any() and r[1].abs().max() > 0

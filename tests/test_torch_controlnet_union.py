"""The port's SDXL ControlNet img2img and inpaint, ControlNet-Union and its
multi model, and the three Union pipelines against the JAX package on the
CPU.

tests/test_torch_controlnet.py's tiny SDXL components and ControlNet widths
(the conditioning embedding halves a 16 x 16 edge map to the 8 x 8 latents),
with the Union fields at widths that fit them (4 control types, a
transformer 8 wide with 2 heads); the port's seeded weights, 1-D ones and
`spatial_ch_projs` jittered off their zero init, carried into JAX with
`convert_torch_state_dict`. Tolerances: models max-abs `< 5e-4`, pipelines
1e-3 on the [0, 1] image or the latents (the SDXL ControlNet twin's, float32
on both sides); img2img and inpaint get JAX's random draws
(`test_torch_pipeline_img2img.draws`).

Guess mode under CFG follows upstream, not JAX (ROADMAP C4), held to a loop
composed here from JAX's Union net, UNet and scheduler. JAX's Union
pipelines cannot run a `MultiControlNetUnionModel` (ROADMAP C4); the port's
take upstream's nested inputs, held to the same composed loop around JAX's
`MultiControlNetUnionModel`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.models.autoencoders.autoencoder_kl import AutoencoderKL as JaxAutoencoderKL
from diffusers_tpu.models.controlnets.controlnet import ControlNetModel as JaxControlNetModel
from diffusers_tpu.models.controlnets.controlnet_union import ControlNetUnionModel as JaxUnion
from diffusers_tpu.models.controlnets.multicontrolnet_union import MultiControlNetUnionModel as JaxMultiUnion
from diffusers_tpu.models.text_encoders.clip import CLIPTextModel as JaxCLIPTextModel
from diffusers_tpu.models.text_encoders.clip import CLIPTextModelWithProjection as JaxCLIPTextModelWithProjection
from diffusers_tpu.models.unets.unet_2d_condition import UNet2DConditionModel as JaxUNet2DConditionModel
from diffusers_tpu.pipelines.controlnet.pipeline_controlnet_inpaint_sd_xl import (
    StableDiffusionXLControlNetInpaintPipeline as JaxInpaint,
)
from diffusers_tpu.pipelines.controlnet.pipeline_controlnet_sd_xl_img2img import (
    StableDiffusionXLControlNetImg2ImgPipeline as JaxImg2Img,
)
from diffusers_tpu.pipelines.controlnet.pipeline_controlnet_union_inpaint_sd_xl import (
    StableDiffusionXLControlNetUnionInpaintPipeline as JaxUnionInpaint,
)
from diffusers_tpu.pipelines.controlnet.pipeline_controlnet_union_sd_xl import (
    StableDiffusionXLControlNetUnionPipeline as JaxUnionT2I,
)
from diffusers_tpu.pipelines.controlnet.pipeline_controlnet_union_sd_xl_img2img import (
    StableDiffusionXLControlNetUnionImg2ImgPipeline as JaxUnionImg2Img,
)
from diffusers_tpu.schedulers import EulerDiscreteScheduler as JaxEulerDiscreteScheduler
from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
from diffusers_tpu_torch.models.controlnets import ControlNetModel, ControlNetUnionModel, MultiControlNetUnionModel
from diffusers_tpu_torch.models.modeling_utils import load_jax_params
from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel, CLIPTextModelWithProjection
from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
from diffusers_tpu_torch.pipelines.controlnet import (
    StableDiffusionXLControlNetImg2ImgPipeline,
    StableDiffusionXLControlNetInpaintPipeline,
    StableDiffusionXLControlNetUnionImg2ImgPipeline,
    StableDiffusionXLControlNetUnionInpaintPipeline,
    StableDiffusionXLControlNetUnionPipeline,
)
from diffusers_tpu_torch.pipelines.pipeline_utils import resolve_component_class
from diffusers_tpu_torch.schedulers import EulerDiscreteScheduler
from test_torch_controlnet import ADDED, CN, COND, EDGES, EHS, X
from test_torch_controlnet_sd import jit_vae, seeded_controlnet, to_jax
from test_torch_pipeline_cache import _parts
from test_torch_pipeline_img2img import IMAGE, MASK, SEED, draws  # noqa: F401 (draws: a fixture)
from test_torch_pipeline_sdxl import CLIP, EULER, UNET, VAE, CRCTokenizer

torch.set_num_threads(1)

MODEL_ATOL = 5e-4
IMAGE_ATOL = 1e-3
PROMPT = "a glass house on a cliff"
UNION = dict(CN, num_control_type=4, num_trans_channel=8, num_trans_head=2, num_proj_channel=8)
RNG = np.random.RandomState(7)
EDGES_2 = (RNG.rand(16, 16, 3) > 0.5).astype(np.float32)
LATENTS = RNG.randn(1, 4, 8, 8).astype(np.float32)
COND_2 = RNG.rand(2, 3, 16, 16).astype(np.float32)


def seeded_union(seed=21):
    """A port Union net from `seed`, 1-D weights and the zero-initialised
    `spatial_ch_projs` jittered so every branch acts."""
    model = seeded_controlnet(ControlNetUnionModel, UNION, seed)
    rng = np.random.RandomState(seed + 1)
    with torch.no_grad():
        model.spatial_ch_projs.weight.add_(torch.from_numpy(0.3 * rng.randn(8, 8).astype(np.float32)))
    return model


def _mask(modes, rows=2):
    ct = np.zeros((rows, UNION["num_control_type"]), np.float32)
    ct[:, modes] = 1.0
    return ct


def _added(lib):
    return {k: lib(v) for k, v in ADDED.items()}


# ---------------------------------------------------------------------------- models


@pytest.mark.parametrize("modes,kwargs", [([2], dict(conditioning_scale=0.7)),
                                          ([1, 3], dict(conditioning_scale=[0.8, 0.2], guess_mode=True)),
                                          ([0, 3], dict(conditioning_scale=1.1))],
                         ids=["one-task", "two-tasks-guess", "two-tasks"])
def test_union_model_matches_jax(modes, kwargs):
    tm = seeded_union()
    jm = JaxUnion(**UNION)
    params = to_jax(jm, tm)
    conds = [COND, COND_2][:len(modes)]
    ref = jax.jit(lambda p: jm(p, jnp.asarray(X), 421.0, jnp.asarray(EHS), [jnp.asarray(c) for c in conds],
                               control_type=jnp.asarray(_mask(modes)), control_type_idx=modes,
                               added_cond_kwargs=_added(jnp.asarray), **kwargs))(params)
    with torch.no_grad():
        out = tm(torch.from_numpy(X), 421.0, torch.from_numpy(EHS), [torch.from_numpy(c) for c in conds],
                 control_type=torch.from_numpy(_mask(modes)), control_type_idx=modes,
                 added_cond_kwargs=_added(torch.from_numpy), **kwargs)
    for a, b in zip((*out.down_block_res_samples, out.mid_block_res_sample),
                    (*ref.down_block_res_samples, ref.mid_block_res_sample)):
        assert a.shape == b.shape and float(np.abs(a.numpy() - np.asarray(b)).max()) < MODEL_ATOL


def test_union_state_dict_crosses_both_ways():
    """The packed `in_proj_weight` / `in_proj_bias`, `task_embedding` and the
    misspelt `transformer_layes` cross through `convert_torch_state_dict` and
    `load_jax_params` unchanged; the port's fresh net starts with
    `spatial_ch_projs` at zero and `task_embedding` ~ sqrt(C) N(0, 1)."""
    tm = seeded_union()
    jm = JaxUnion(**UNION)
    params = to_jax(jm, tm)
    assert params["transformer_layes"][0]["attn"]["in_proj_weight"].shape == (24, 8)
    assert params["task_embedding"].shape == (4, 8)
    fresh = load_jax_params(ControlNetUnionModel(**UNION), jax.tree_util.tree_map(np.asarray, params))
    for k, v in tm.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    torch.manual_seed(0)
    new = ControlNetUnionModel(**UNION)
    assert not new.spatial_ch_projs.weight.any() and not new.spatial_ch_projs.bias.any()
    assert 1.0 < float(new.task_embedding.detach().std()) < 5.0  # sqrt(8) = 2.83
    assert resolve_component_class("diffusers", "ControlNetUnionModel")[0] is ControlNetUnionModel


def test_multi_union_model_matches_jax():
    """Two nets, their own images, masks, tasks and scales, summed; a net at
    scale 0.0 is skipped."""
    nets = [seeded_union(21), seeded_union(31)]
    jnets = [JaxUnion(**UNION) for _ in nets]
    params = [to_jax(j, t) for j, t in zip(jnets, nets)]
    multi, jmulti = MultiControlNetUnionModel(nets), JaxMultiUnion(jnets)
    args = dict(control_type_idx=[[1], [0, 2]], conditioning_scale=[0.9, 0.4])
    ref = jax.jit(lambda p: jmulti(p, jnp.asarray(X), 421.0, jnp.asarray(EHS),
                                   [[jnp.asarray(COND)], [jnp.asarray(COND), jnp.asarray(COND_2)]],
                                   control_type=[jnp.asarray(_mask([1])), jnp.asarray(_mask([0, 2]))],
                                   added_cond_kwargs=_added(jnp.asarray), **args))(params)
    with torch.no_grad():
        out = multi(torch.from_numpy(X), 421.0, torch.from_numpy(EHS),
                    [[torch.from_numpy(COND)], [torch.from_numpy(COND), torch.from_numpy(COND_2)]],
                    control_type=[torch.from_numpy(_mask([1])), torch.from_numpy(_mask([0, 2]))],
                    added_cond_kwargs=_added(torch.from_numpy), **args)
        skipped = multi(torch.from_numpy(X), 421.0, torch.from_numpy(EHS), [[torch.from_numpy(COND)], [None]],
                        control_type=[torch.from_numpy(_mask([1])), None], control_type_idx=[[1], [0]],
                        conditioning_scale=[0.9, 0.0], added_cond_kwargs=_added(torch.from_numpy))
        alone = nets[0](torch.from_numpy(X), 421.0, torch.from_numpy(EHS), [torch.from_numpy(COND)],
                        control_type=torch.from_numpy(_mask([1])), control_type_idx=[1], conditioning_scale=0.9,
                        added_cond_kwargs=_added(torch.from_numpy))
    for a, b in zip((*out.down_block_res_samples, out.mid_block_res_sample),
                    (*ref.down_block_res_samples, ref.mid_block_res_sample)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) < MODEL_ATOL
    assert torch.equal(skipped.mid_block_res_sample, alone.mid_block_res_sample)


# ---------------------------------------------------------------------------- pipelines


def sdxl_pipelines(jcls, tcls, controlnets):
    """(JAX pipeline, port pipeline) on the tiny SDXL components with the
    port `controlnets` (one, or a list: the port's multi model) and their JAX
    twins (a (model, params) pair for one; None for a list)."""
    jax_parts, torch_parts = _parts([
        ("unet", JaxUNet2DConditionModel, UNet2DConditionModel, UNET),
        ("vae", JaxAutoencoderKL, AutoencoderKL, VAE),
        ("text_encoder", JaxCLIPTextModel, CLIPTextModel, CLIP),
        ("text_encoder_2", JaxCLIPTextModelWithProjection, CLIPTextModelWithProjection, CLIP),
    ], seed=7)
    jnet = None
    if not isinstance(controlnets, list):
        jm = (JaxUnion if isinstance(controlnets, ControlNetUnionModel) else JaxControlNetModel)(
            **(UNION if isinstance(controlnets, ControlNetUnionModel) else CN))
        jnet = (jm, to_jax(jm, controlnets))
    jpipe = jit_vae(jcls(tokenizer=CRCTokenizer(), tokenizer_2=CRCTokenizer(), controlnet=jnet,
                         scheduler=JaxEulerDiscreteScheduler(**EULER), **jax_parts)) if jcls else None
    tpipe = tcls(tokenizer=CRCTokenizer(), tokenizer_2=CRCTokenizer(), controlnet=controlnets,
                 scheduler=EulerDiscreteScheduler(**EULER), device="cpu", **torch_parts)
    return jpipe, tpipe


def _run(jpipe, tpipe, output_type="np", **kwargs):
    kwargs = dict(num_inference_steps=3, guidance_scale=5.0, output_type=output_type, **kwargs)
    ref = np.asarray(jpipe(PROMPT, key=jax.random.PRNGKey(SEED), **kwargs).images)
    out = tpipe(PROMPT, **kwargs).images
    out = out.numpy() if isinstance(out, torch.Tensor) else out
    assert out.shape == ref.shape and np.isfinite(out).all()
    return float(np.abs(out - ref).max())


@pytest.mark.parametrize("kind", ["img2img", "inpaint"])
def test_sdxl_controlnet_image_pipelines_match_jax(draws, kind):  # noqa: F811
    jcls, tcls = ((JaxImg2Img, StableDiffusionXLControlNetImg2ImgPipeline) if kind == "img2img" else
                  (JaxInpaint, StableDiffusionXLControlNetInpaintPipeline))
    jpipe, tpipe = sdxl_pipelines(jcls, tcls, seeded_controlnet(ControlNetModel, CN, 11))
    kwargs = dict(image=IMAGE, control_image=EDGES, controlnet_conditioning_scale=0.8)
    kwargs.update(strength=0.7) if kind == "img2img" else kwargs.update(mask_image=MASK)
    assert _run(jpipe, tpipe, **kwargs) <= IMAGE_ATOL
    assert not draws  # the port drew the encoder's sample, then the noise


@pytest.mark.parametrize("kind", ["text2image", "img2img", "inpaint", "negative_prompts"])
def test_union_pipelines_match_jax(request, kind):
    """`negative_prompts` is text-to-image with `negative_prompt` and a
    different `negative_prompt_2`. Both pipelines hand the second to the
    SDXL `encode_prompt`, which reads `negative_prompt` for both text
    encoders in JAX and in the port (ROADMAP C3: `prompt_2` is unused), so
    the image is the one without it."""
    jcls, tcls = {"text2image": (JaxUnionT2I, StableDiffusionXLControlNetUnionPipeline),
                  "negative_prompts": (JaxUnionT2I, StableDiffusionXLControlNetUnionPipeline),
                  "img2img": (JaxUnionImg2Img, StableDiffusionXLControlNetUnionImg2ImgPipeline),
                  "inpaint": (JaxUnionInpaint, StableDiffusionXLControlNetUnionInpaintPipeline)}[kind]
    jpipe, tpipe = sdxl_pipelines(jcls, tcls, seeded_union())
    kwargs = dict(control_image=[EDGES, EDGES_2], control_mode=[3, 1], controlnet_conditioning_scale=0.7)
    if kind in ("text2image", "negative_prompts"):
        t2i = dict(height=8, width=8, num_inference_steps=3, guidance_scale=5.0, output_type="np")
        if kind == "negative_prompts":
            kwargs.update(negative_prompt="blurry", negative_prompt_2="a dark cellar")
            one_negative = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **t2i,
                                 **dict(kwargs, negative_prompt_2=None)).images
        out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **t2i, **kwargs).images
        ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), **t2i, **kwargs).images)
        diff = float(np.abs(out - ref).max())
        if kind == "negative_prompts":
            assert np.array_equal(out, one_negative)
    else:
        queue = request.getfixturevalue("draws")
        kwargs.update(image=IMAGE, strength=0.7) if kind == "img2img" else kwargs.update(image=IMAGE, mask_image=MASK)
        diff = _run(jpipe, tpipe, **kwargs)
        assert not queue
    assert diff <= IMAGE_ATOL
    # one task a control image, on both sides (JAX `pipeline_controlnet_union_inpaint_sd_xl.py:115`)
    bad = dict(kwargs, control_mode=[3])
    with pytest.raises(ValueError, match="one task index per control_image"):
        jpipe(PROMPT, num_inference_steps=1, **bad)
    with pytest.raises(ValueError, match="one task index per control_image"):
        tpipe(PROMPT, num_inference_steps=1, **bad)


def _composed_loop(jpipe, residuals, steps=3, guidance_scale=5.0):
    """SDXL text-to-image latents from LATENTS, composed from the JAX
    pipeline's encoders, UNet and Euler, the UNet given
    `residuals(x, x_cond, t, embeds, cond_embeds, added, cond_added)`."""
    unet, unet_params = jpipe.unet
    sched = jpipe.scheduler
    embeds, neg, pooled, neg_pooled = jpipe.encode_prompt(PROMPT, None, None, None, True)
    time_ids = jpipe._get_add_time_ids((8, 8), (0, 0), (8, 8), 1)
    added = {"text_embeds": jnp.concatenate([neg_pooled, pooled]), "time_ids": jnp.concatenate([time_ids, time_ids])}
    all_embeds = jnp.concatenate([neg, embeds])

    @jax.jit
    def noise_pred(latents, t, state):
        x = sched.scale_model_input(state, jnp.concatenate([latents, latents]), t)
        down, mid = residuals(x, sched.scale_model_input(state, latents, t), t, all_embeds, embeds, added,
                              {"text_embeds": pooled, "time_ids": time_ids})
        out = unet(unet_params, x, jnp.broadcast_to(t, (2,)), encoder_hidden_states=all_embeds, added_cond_kwargs=added,
                   down_block_additional_residuals=down, mid_block_additional_residual=mid).sample
        uncond, text = jnp.split(out, 2)
        return uncond + guidance_scale * (text - uncond)

    state = sched.set_timesteps(steps)
    latents = jnp.asarray(LATENTS) * state.init_noise_sigma
    for t in state.timesteps:
        latents = sched.step(state, noise_pred(latents, t, state), t, latents).prev_sample
    return np.asarray(latents)


def _cond(jpipe, image):
    return jnp.clip((jnp.asarray(jpipe.image_processor.preprocess(image)) + 1) / 2, 0, 1)


def test_union_guess_mode_under_cfg_follows_upstream():
    jpipe, tpipe = sdxl_pipelines(JaxUnionT2I, StableDiffusionXLControlNetUnionPipeline, seeded_union())
    jm, params = jpipe.controlnet
    conds = [_cond(jpipe, EDGES), _cond(jpipe, EDGES_2)]

    def residuals(x, x_cond, t, embeds, cond_embeds, added, cond_added):
        res = jm(params, x_cond, jnp.broadcast_to(t, (1,)), cond_embeds, conds,
                 control_type=jnp.asarray(_mask([3, 1], 1)), control_type_idx=[3, 1], conditioning_scale=0.7,
                 guess_mode=True, added_cond_kwargs=cond_added)
        down = tuple(jnp.concatenate([jnp.zeros_like(r), r]) for r in res.down_block_res_samples)
        return down, jnp.concatenate([jnp.zeros_like(res.mid_block_res_sample), res.mid_block_res_sample])

    ref = _composed_loop(jpipe, residuals)
    kwargs = dict(control_image=[EDGES, EDGES_2], control_mode=[3, 1], height=8, width=8, num_inference_steps=3,
                  guidance_scale=5.0, controlnet_conditioning_scale=0.7, guess_mode=True, output_type="latent")
    out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).images.numpy()
    assert float(np.abs(out - ref).max()) <= IMAGE_ATOL
    jax_out = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), **kwargs).images)
    assert float(np.abs(jax_out - ref).max()) > 100 * IMAGE_ATOL  # JAX's both-halves rule (ROADMAP C4)


def test_multi_union_pipeline_and_the_jax_fault():
    """The port's Union pipeline with two Union nets (upstream's nested
    inputs: an image list and a mode list a net) against the composed loop
    around JAX's `MultiControlNetUnionModel`; JAX's own Union pipeline
    cannot run the multi model."""
    nets = [seeded_union(21), seeded_union(31)]
    jnets = [JaxUnion(**UNION) for _ in nets]
    params = [to_jax(j, t) for j, t in zip(jnets, nets)]
    jmulti = JaxMultiUnion(jnets)
    jpipe, tpipe = sdxl_pipelines(None, StableDiffusionXLControlNetUnionPipeline, nets)
    assert isinstance(tpipe.controlnet, MultiControlNetUnionModel)
    jpipe, _ = sdxl_pipelines(JaxUnionT2I, StableDiffusionXLControlNetUnionPipeline, seeded_union())
    conds = [[_cond(jpipe, EDGES)], [_cond(jpipe, EDGES), _cond(jpipe, EDGES_2)]]

    def residuals(x, x_cond, t, embeds, cond_embeds, added, cond_added):
        res = jmulti(params, x, jnp.broadcast_to(t, (2,)), embeds,
                     [[jnp.concatenate([c, c]) for c in net] for net in conds],
                     control_type=[jnp.asarray(_mask([2])), jnp.asarray(_mask([0, 3]))],
                     control_type_idx=[[2], [0, 3]], conditioning_scale=[0.8, 0.5], added_cond_kwargs=added)
        return res.down_block_res_samples, res.mid_block_res_sample

    ref = _composed_loop(jpipe, residuals)
    kwargs = dict(control_image=[EDGES, [EDGES, EDGES_2]], control_mode=[2, [0, 3]], height=8, width=8,
                  num_inference_steps=3, guidance_scale=5.0, controlnet_conditioning_scale=[0.8, 0.5],
                  output_type="latent")
    out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).images.numpy()
    assert float(np.abs(out - ref).max()) <= IMAGE_ATOL
    with pytest.raises(ValueError, match="one control_image and control_mode entry"):
        tpipe(PROMPT, **dict(kwargs, control_mode=[2]))
    # JAX: its Union pipeline reads `config.num_control_type` of the net, which the multi model lacks (ROADMAP C4)
    jpipe.controlnet = (jmulti, params)
    with pytest.raises(AttributeError, match="config"):
        jpipe(PROMPT, latents=jnp.asarray(LATENTS), **dict(kwargs, control_image=[EDGES, EDGES_2], control_mode=[2, 0]))

"""The port's Flux family against the JAX package on the CPU: the twelve
image-conditioned pipelines (img2img, also under TaylorSeer and
FirstBlockCache, inpaint, Fill, Kontext, Kontext inpaint, Control and its
img2img and inpaint, ControlNet, plain and Union, and its img2img and
inpaint) end to end, their cache rules and JAX's behaviour under caches
(tests/test_torch_controlnet_flux.py holds the models).

Tiny components: a Flux transformer of 1 dual and 1 single block with 2
heads of 16 and guidance embeds (in_channels 16; Fill's 48 = 16 + 16 + 4 x
2^2 and Control's 32, out_channels 16), a 32-wide CLIP, a tiny T5 and a VAE
of 2 blocks (vae_scale_factor 2, 4 latent channels, Flux's scaling and
shift factors) on a 16 x 16 image: 8 x 8 latents, 16 packed tokens. The
port's seeded weights (1-D ones jittered; the ControlNet's zero residual
projections made random, so the residuals act) are carried into JAX with
`convert_torch_state_dict`. Both pipelines get the same numpy latents and a
deterministic tokenizer; the port's `randn_tensor` returns JAX's draws (the
encoder samples and the noise) in JAX's order of use. JAX's loops run
jitted (the pipelines' own `_jit`).

Tolerance: `5e-4` on the [0, 1] image (the whole-pipeline bound of
README.md), float32 on both sides, so the differences are summation order
(measured at most 1e-6); the module tests of tests/test_torch_controlnet_flux.py hold
`1e-5`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusers_tpu.pipelines.flux as jflux
from diffusers_tpu.models.controlnets.controlnet_flux import FluxControlNetModel as JaxFluxControlNet
from diffusers_tpu.models.modeling_utils import convert_torch_state_dict
from diffusers_tpu.models.transformers.transformer_flux import FluxTransformer2DModel as JaxFlux
from diffusers_tpu.utils.jax_utils import randn_tensor as jax_randn
import diffusers_tpu_torch.hooks as hooks
import diffusers_tpu_torch.pipelines.flux as tflux
from diffusers_tpu_torch import FluxFillPipeline as RootFill
from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
from diffusers_tpu_torch.models.controlnets.controlnet_flux import FluxControlNetModel, FluxMultiControlNetModel
from diffusers_tpu_torch.models.transformers.transformer_flux import FluxTransformer2DModel
from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention_full
from diffusers_tpu_torch.ops.cuda.group_norm import group_norm
from diffusers_tpu_torch.schedulers import FlowMatchEulerDiscreteScheduler
from diffusers_tpu_torch.utils import torch_utils
from diffusers_tpu.models.autoencoders.autoencoder_kl import AutoencoderKL as JaxAutoencoderKL
from diffusers_tpu.models.text_encoders.clip import CLIPTextModel as JaxCLIPTextModel
from diffusers_tpu.models.text_encoders.t5 import T5EncoderModel as JaxT5EncoderModel
from diffusers_tpu.schedulers import FlowMatchEulerDiscreteScheduler as JaxFlowMatch
from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel
from diffusers_tpu_torch.models.text_encoders.t5 import T5EncoderModel
from test_torch_pipeline_flux import FLOW_MATCH, CRCTokenizer

torch.set_num_threads(1)

ATOL = 5e-4
MODULE_ATOL = 1e-5
PROMPT = "a red fox in fresh snow"
TXT_LEN = 8
STEPS = 3
TINY = dict(patch_size=1, in_channels=16, num_layers=1, num_single_layers=1, attention_head_dim=16,
            num_attention_heads=2, joint_attention_dim=32, pooled_projection_dim=32, guidance_embeds=True,
            axes_dims_rope=(4, 6, 6))
FILL = dict(TINY, in_channels=48, out_channels=16)
CONTROL = dict(TINY, in_channels=32, out_channels=16)
CONTROLNET = dict(TINY, num_layers=2, num_single_layers=2)  # 2 residuals for 1 block: the interval rule's ceil
VAE = dict(in_channels=3, out_channels=3, block_out_channels=(32, 32), down_block_types=("DownEncoderBlock2D",) * 2,
           up_block_types=("UpDecoderBlock2D",) * 2, latent_channels=4, layers_per_block=1, norm_num_groups=32,
           sample_size=16, scaling_factor=0.3611, shift_factor=0.1159, use_quant_conv=False,
           use_post_quant_conv=False)
CLIP = dict(vocab_size=1000, hidden_size=32, intermediate_size=64, num_hidden_layers=1, num_attention_heads=2,
            max_position_embeddings=77, projection_dim=32)
T5 = dict(vocab_size=1000, d_model=32, d_kv=8, d_ff=32, num_layers=1, num_heads=2, feed_forward_proj="gated-gelu")
IMAGE = np.random.RandomState(0).rand(16, 16, 3).astype(np.float32)  # HWC in [0, 1]
REFERENCE = np.random.RandomState(5).rand(16, 16, 3).astype(np.float32)
CONTROL_IMAGE = (np.random.RandomState(6).rand(16, 16, 3) > 0.7).astype(np.float32)  # an edge map
MASK = np.zeros((16, 16), np.float32)
MASK[3:11, 2:10] = 0.8  # binarized at 0.5 (Fill takes 1.0)
LATENTS = np.random.RandomState(1).randn(1, 16, 16).astype(np.float32)  # packed 8 x 8 x 4 latents
LAT_SHAPE, PACKED_SHAPE = (1, 4, 8, 8), (1, 16, 16)
KEY_SEED = 4


def _randomize(model, seed):
    """The seeded port model's 1-D weights jittered (every weight random,
    the zero-initialized residual paths too)."""
    torch.manual_seed(seed)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 1 or (p.abs().max() == 0):
                p.add_(torch.from_numpy((0.1 * rng.randn(*p.shape)).astype(np.float32)))
    return model.eval()


def _pair(jcls, tcls, cfg, seed):
    """(JAX model, params, port model) with the port's weights."""
    torch.manual_seed(seed)
    tm = _randomize(tcls(**cfg), seed)
    jm = jcls(**cfg)
    return jm, convert_torch_state_dict(jm, {k: v.numpy() for k, v in tm.state_dict().items()}), tm


def _components(transformer_cfg):
    jax_parts, torch_parts = {}, {}
    for seed, (name, jcls, tcls, cfg) in enumerate([
        ("vae", JaxAutoencoderKL, AutoencoderKL, VAE), ("text_encoder", JaxCLIPTextModel, CLIPTextModel, CLIP),
        ("text_encoder_2", JaxT5EncoderModel, T5EncoderModel, T5),
        ("transformer", JaxFlux, FluxTransformer2DModel, transformer_cfg),
    ]):
        jm, params, tm = _pair(jcls, tcls, cfg, seed)
        jax_parts[name], torch_parts[name] = (jm, params), tm
    tokenizers = dict(tokenizer=CRCTokenizer(), tokenizer_2=CRCTokenizer())
    return jax_parts, torch_parts, tokenizers


def _controlnet_pair(seed=7, **overrides):
    return _pair(JaxFluxControlNet, FluxControlNetModel, dict(CONTROLNET, **overrides), seed)


@functools.lru_cache(maxsize=None)
def _built(name, controlnet_kind=None):
    """`build` once per (class, ControlNet kind), so cases of one class share
    the JAX pipeline's compiled loop."""
    controlnet = None if controlnet_kind is None else _controlnet_pair(
        num_mode=10 if controlnet_kind == "union" else None)
    return build(name, controlnet)


def build(name, controlnet=None):
    """(JAX pipeline, port pipeline) of pipeline class `name`."""
    cfg = {"FluxFillPipeline": FILL}.get(name, CONTROL if "Control" in name and "ControlNet" not in name else TINY)
    jax_parts, torch_parts, tokenizers = _components(cfg)
    if controlnet is not None:
        jm, params, tm = controlnet
        jax_parts["controlnet"], torch_parts["controlnet"] = (jm, params), tm
    jpipe = getattr(jflux, name)(scheduler=JaxFlowMatch(**FLOW_MATCH), **tokenizers, **jax_parts)
    tpipe = getattr(tflux, name)(scheduler=FlowMatchEulerDiscreteScheduler(**FLOW_MATCH), device="cpu", **tokenizers,
                                 **torch_parts)
    return jpipe, tpipe


def _draws(monkeypatch, plan):
    """The port's `randn_tensor` returns JAX's draws: `plan` is the key split
    (n) of PRNGKey(KEY_SEED) and [(key index, shape)] in the port's order."""
    n, order = plan
    keys = jax.random.split(jax.random.PRNGKey(KEY_SEED), n) if n > 1 else [jax.random.PRNGKey(KEY_SEED)]
    queue = [np.array(jax_randn(shape, key=keys[i])) for i, shape in order]

    def randn_tensor(shape, generator=None, device=None):
        out = queue.pop(0)
        assert tuple(shape) == out.shape
        return torch.from_numpy(out).to(device)

    monkeypatch.setattr(torch_utils, "randn_tensor", randn_tensor)
    return queue


ENC, NOISE = (1, LAT_SHAPE), (2, PACKED_SHAPE)
# name: (extra kwargs, passes latents, JAX key split and the port's draws)
CASES = {
    "FluxImg2ImgPipeline": (dict(image=IMAGE, strength=0.7), False, (3, [ENC, NOISE])),
    "FluxImg2ImgPipeline+taylorseer": (dict(image=IMAGE, strength=1.0), False, (3, [ENC, NOISE])),
    "FluxImg2ImgPipeline+fbc": (dict(image=IMAGE, strength=1.0), False, (3, [ENC, NOISE])),
    "FluxInpaintPipeline": (dict(image=IMAGE, mask_image=MASK, strength=0.7), False, (3, [ENC, NOISE])),
    "FluxFillPipeline": (dict(image=IMAGE, mask_image=(MASK > 0.5).astype(np.float32)), True, (3, [ENC])),
    "FluxKontextPipeline": (dict(image=REFERENCE), True, (1, [])),
    "FluxKontextInpaintPipeline": (dict(image=IMAGE, mask_image=MASK, strength=0.8), False,
                                   (2, [(1, PACKED_SHAPE)])),
    "FluxKontextInpaintPipeline+reference": (dict(image=IMAGE, mask_image=MASK, image_reference=REFERENCE,
                                                  strength=0.8), False, (2, [(1, PACKED_SHAPE)])),
    "FluxControlPipeline": (dict(control_image=CONTROL_IMAGE, height=16, width=16), True, (3, [ENC])),
    "FluxControlImg2ImgPipeline": (dict(image=IMAGE, control_image=CONTROL_IMAGE, strength=0.7), False,
                                   (4, [ENC, (2, LAT_SHAPE), (3, PACKED_SHAPE)])),
    "FluxControlInpaintPipeline": (dict(image=IMAGE, control_image=CONTROL_IMAGE, mask_image=MASK, strength=0.7),
                                   False, (4, [ENC, (2, LAT_SHAPE), (3, PACKED_SHAPE)])),
    "FluxControlNetPipeline": (dict(control_image=CONTROL_IMAGE, height=16, width=16,
                                    controlnet_conditioning_scale=0.7), True, (2, [ENC])),
    "FluxControlNetPipeline+union": (dict(control_image=CONTROL_IMAGE, height=16, width=16, control_mode=3), True,
                                     (2, [ENC])),
    "FluxControlNetImg2ImgPipeline": (dict(image=IMAGE, control_image=CONTROL_IMAGE, strength=0.7,
                                           controlnet_conditioning_scale=0.7), False,
                                      (4, [(2, LAT_SHAPE), ENC, (3, PACKED_SHAPE)])),
    "FluxControlNetInpaintPipeline": (dict(image=IMAGE, mask_image=MASK, control_image=CONTROL_IMAGE, strength=0.7),
                                      False, (4, [(2, LAT_SHAPE), ENC, (3, PACKED_SHAPE)])),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_matches_jax(case, monkeypatch):
    name, _, variant = case.partition("+")
    kwargs, passes_latents, plan = CASES[case]
    jpipe, tpipe = _built(name, ("union" if variant == "union" else "plain") if "ControlNet" in name else None)
    jpipe.disable_cache()
    tpipe.disable_cache()
    if variant in ("taylorseer", "fbc"):  # img2img runs the text-to-image loop under JAX's caches
        import diffusers_tpu.hooks as jhooks

        jcfg, tcfg = ((jhooks.TaylorSeerCacheConfig(cache_interval=2, disable_cache_before_step=1),
                       hooks.TaylorSeerCacheConfig(cache_interval=2, disable_cache_before_step=1)) if variant ==
                      "taylorseer" else (jhooks.FirstBlockCacheConfig(threshold=0.3),
                                         hooks.FirstBlockCacheConfig(threshold=0.3)))
        jpipe.enable_cache(jcfg)
        tpipe.enable_cache(tcfg)
    queue = _draws(monkeypatch, plan)
    kwargs = dict(kwargs, num_inference_steps=STEPS, max_sequence_length=TXT_LEN, output_type="np",
                  guidance_scale=4.0)
    if passes_latents:
        kwargs_j, kwargs_t = dict(kwargs, latents=jnp.asarray(LATENTS)), dict(kwargs, latents=torch.from_numpy(LATENTS))
    else:
        kwargs_j, kwargs_t = kwargs, kwargs
    ref = np.asarray(jpipe(PROMPT, key=jax.random.PRNGKey(KEY_SEED), **kwargs_j).images)
    flash_attention_full.launches = group_norm.launches = 0
    out = tpipe(PROMPT, **kwargs_t).images
    assert flash_attention_full.launches == group_norm.launches == 0  # CPU tensors took the plain versions
    assert not queue  # the port drew what JAX drew
    assert out.shape == (1, 16, 16, 3) and out.dtype == np.float32 and np.isfinite(out).all()
    err = float(np.abs(out - ref).max())
    assert err <= ATOL, err
    if variant == "fbc":
        assert not all(tpipe.fbc_record["decisions"])  # the cache skipped a step


def test_known_region_is_the_clean_image():
    """After the last step the inpaint blend leaves the clean latents outside
    the mask: the packed latents there equal the encoder's, bit for bit."""
    _, tpipe = build("FluxInpaintPipeline")
    gen = torch.Generator().manual_seed(0)
    out = tpipe(PROMPT, image=IMAGE, mask_image=MASK, strength=1.0, num_inference_steps=2, generator=gen,
                max_sequence_length=TXT_LEN, output_type="latent").images
    gen = torch.Generator().manual_seed(0)
    clean, (lh, lw), _ = tpipe._image_latents(IMAGE, gen, 1)
    mask = tpipe._packed_mask(MASK, 1, clean, lh, lw)
    assert mask.min() == 0 and mask.max() == 1
    assert torch.equal(out[mask == 0], clean[mask == 0]) and not torch.equal(out[mask == 1], clean[mask == 1])


def test_family_cache_rules_and_multi_controlnet():
    """img2img honours the caches JAX's img2img runs (TaylorSeer,
    FirstBlockCache, TextKV) and refuses PAB and MagCache; the other eleven
    family pipelines, whose JAX loops read no cache config, refuse every
    config (ROADMAP C3). The ControlNet pipelines take one
    FluxControlNetModel, as JAX's do."""
    _, tpipe = build("FluxImg2ImgPipeline")
    parts = dict(tpipe.components)
    for config in (hooks.TaylorSeerCacheConfig(), hooks.FirstBlockCacheConfig(), hooks.TextKVCacheConfig()):
        tpipe.enable_cache(config)
    for config in (hooks.PyramidAttentionBroadcastConfig(), hooks.MagCacheConfig(mag_ratios=(1.0,) * 28)):
        with pytest.raises(TypeError, match="does not support cache config"):
            tpipe.enable_cache(config)
    for name in ("FluxInpaintPipeline", "FluxKontextPipeline", "FluxKontextInpaintPipeline", "FluxFillPipeline",
                 "FluxControlPipeline", "FluxControlImg2ImgPipeline", "FluxControlInpaintPipeline"):
        pipe = getattr(tflux, name)(**parts, device="cpu")
        for config in (hooks.TaylorSeerCacheConfig(), hooks.FirstBlockCacheConfig(), hooks.TextKVCacheConfig()):
            with pytest.raises(TypeError, match="does not support cache config"):
                pipe.enable_cache(config)
    controlnet = _controlnet_pair()[2]
    for name in ("FluxControlNetPipeline", "FluxControlNetImg2ImgPipeline", "FluxControlNetInpaintPipeline"):
        pipe = getattr(tflux, name)(**parts, controlnet=controlnet, device="cpu")
        with pytest.raises(TypeError, match="does not support cache config"):
            pipe.enable_cache(hooks.TaylorSeerCacheConfig())
        with pytest.raises(TypeError, match="one FluxControlNetModel"):
            getattr(tflux, name)(**parts, controlnet=FluxMultiControlNetModel([controlnet]), device="cpu")
    assert RootFill is tflux.FluxFillPipeline


def test_jax_family_cache_behaviour():
    """What the rules above stand against (ROADMAP C3): JAX's inpaint takes
    any config and runs its loop uncached, bit for bit; JAX's img2img takes
    PAB in `enable_cache` and raises when called (its loop gets no mask)."""
    import diffusers_tpu.hooks as jhooks
    from diffusers_tpu.hooks.pyramid_attention_broadcast import PyramidAttentionBroadcastConfig

    jpipe, _ = build("FluxInpaintPipeline")
    kwargs = dict(image=IMAGE, mask_image=MASK, strength=1.0, num_inference_steps=2, max_sequence_length=TXT_LEN,
                  output_type="latent", key=jax.random.PRNGKey(0))
    dense = np.asarray(jpipe(PROMPT, **kwargs).images)
    jpipe.enable_cache(jhooks.TaylorSeerCacheConfig(cache_interval=2, disable_cache_before_step=1))
    np.testing.assert_array_equal(np.asarray(jpipe(PROMPT, **kwargs).images), dense)
    img2img = jflux.FluxImg2ImgPipeline(**jpipe.components)
    img2img.enable_cache(PyramidAttentionBroadcastConfig())
    del kwargs["mask_image"]
    with pytest.raises(TypeError, match="cond predicate is None"):
        img2img(PROMPT, **kwargs)


def test_fill_and_control_channel_layouts():
    """Fill's conditioning is [masked-image latents (4 C) ; mask (4 vsf^2)]
    = 32 channels, so latents + conditioning = the Fill transformer's 48
    in_channels; Control's is 16 and its transformer takes 32. Neither needs
    transformer code beyond `in_channels` / `out_channels`."""
    _, fill = build("FluxFillPipeline")
    mask = torch.ones(1, 1, 16, 16)
    cond = fill.prepare_mask_latents(mask, torch.zeros(1, 3, 16, 16), 1)
    assert cond.shape == (1, 16, 32) and torch.equal(cond[..., 16:], torch.ones(1, 16, 16))
    _, control = build("FluxControlPipeline")
    packed = control._encode_pack_control(torch.zeros(1, 4, 8, 8), 16, 16, 1)  # latents are packed as they are
    assert packed.shape == (1, 16, 16) and float(packed.abs().max()) == 0
    assert fill.transformer.x_embedder.in_features == 48 and control.transformer.x_embedder.in_features == 32
    assert fill.transformer.proj_out.out_features == control.transformer.proj_out.out_features == 16

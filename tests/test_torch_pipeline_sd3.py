"""The port's SD3 pipelines (text-to-image, img2img, inpaint), each SD3 cache
and a step callback, against the JAX pipelines end to end on the CPU.

Tiny components: an SD3.5-style transformer (dual attention on its first
layer, qk RMSNorm; an SD3.0-style one for text-to-image too), two
projecting CLIP towers, a tiny T5 and a one-level VAE with SD3's scaling
and shift factors. The port's seeded weights (1-D ones jittered) are carried
into JAX with `convert_torch_state_dict`. Both pipelines get the same numpy
latents and a deterministic tokenizer; for img2img and inpaint the port's
one `randn_tensor` is made to return the JAX pipeline's (encoder sample,
noise) draws in that order.

Tolerance: `2e-3` on the [0, 1] image, as tests/test_torch_pipeline_flux.py;
float32 on both sides, so the differences are summation order (measured at
most 1e-6). Each cached request also differs from the port's uncached image
by more than `ACTS` = 1e-4 (the cache acts: measured 6.6e-4 for FasterCache,
FirstBlockCache and PAB, whose tiny model's branches differ little, up to
4e-2 for TaylorSeer and MagCache), and its transformer calls follow the
cache's schedule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusers_tpu.hooks as jhooks
from diffusers_tpu.hooks.generic_cache import TextKVCacheConfig as JaxTextKVCacheConfig
from diffusers_tpu.hooks.pyramid_attention_broadcast import (
    PyramidAttentionBroadcastConfig as JaxPyramidAttentionBroadcastConfig,
)
from diffusers_tpu.models.autoencoders.autoencoder_kl import AutoencoderKL as JaxAutoencoderKL
from diffusers_tpu.models.text_encoders.clip import CLIPTextModelWithProjection as JaxCLIPWithProjection
from diffusers_tpu.models.text_encoders.t5 import T5EncoderModel as JaxT5EncoderModel
from diffusers_tpu.models.transformers.transformer_sd3 import SD3Transformer2DModel as JaxSD3
from diffusers_tpu.pipelines.stable_diffusion_3 import (
    StableDiffusion3Img2ImgPipeline as JaxImg2Img,
    StableDiffusion3InpaintPipeline as JaxInpaint,
    StableDiffusion3Pipeline as JaxSD3Pipeline,
)
from diffusers_tpu.schedulers import FlowMatchEulerDiscreteScheduler as JaxFlowMatch
import diffusers_tpu_torch.hooks as hooks
from diffusers_tpu_torch import StableDiffusion3Pipeline as RootExport
from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModelWithProjection
from diffusers_tpu_torch.models.text_encoders.t5 import T5EncoderModel
from diffusers_tpu_torch.models.transformers.transformer_sd3 import SD3Transformer2DModel
from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention_full
from diffusers_tpu_torch.ops.cuda.group_norm import group_norm
from diffusers_tpu_torch.pipelines.stable_diffusion_3 import (
    StableDiffusion3Img2ImgPipeline,
    StableDiffusion3InpaintPipeline,
    StableDiffusion3Pipeline,
)
from diffusers_tpu_torch.schedulers import FlowMatchEulerDiscreteScheduler
from diffusers_tpu_torch.utils import torch_utils
from test_torch_pipeline_cache import _parts
from test_torch_pipeline_flux import CRCTokenizer
from test_torch_pipeline_img2img import jax_draws

torch.set_num_threads(1)

ATOL = 2e-3
ACTS = 1e-4
PROMPT = "a lighthouse in a storm"
STEPS = 8
TXT_LEN = 8
SD35 = dict(sample_size=8, patch_size=2, in_channels=4, num_layers=2, attention_head_dim=8, num_attention_heads=2,
            joint_attention_dim=32, caption_projection_dim=16, pooled_projection_dim=32, out_channels=4,
            pos_embed_max_size=96, dual_attention_layers=(0,), qk_norm="rms_norm")
SD30 = {k: v for k, v in SD35.items() if k not in ("dual_attention_layers", "qk_norm")}
VAE = dict(in_channels=3, out_channels=3, block_out_channels=(32,), down_block_types=("DownEncoderBlock2D",),
           up_block_types=("UpDecoderBlock2D",), latent_channels=4, layers_per_block=1, norm_num_groups=32,
           sample_size=8, scaling_factor=1.5305, shift_factor=0.0609, use_quant_conv=False, use_post_quant_conv=False)
CLIP = dict(vocab_size=1000, hidden_size=8, intermediate_size=16, num_hidden_layers=1, num_attention_heads=2,
            max_position_embeddings=77, projection_dim=16)
T5 = dict(vocab_size=1000, d_model=32, d_kv=8, d_ff=32, num_layers=1, num_heads=2, feed_forward_proj="gated-gelu")
IMAGE = np.random.RandomState(0).rand(8, 8, 3).astype(np.float32)  # HWC in [0, 1]: 8 x 8 latents
MASK = np.zeros((8, 8), np.float32)
MASK[2:6, 1:5] = 0.8  # binarized at 0.5: repaint a 4 x 4 square


def build(transformer=SD35, t5=True, jcls=JaxSD3Pipeline, tcls=StableDiffusion3Pipeline, seed=0):
    specs = [("vae", JaxAutoencoderKL, AutoencoderKL, VAE),
             ("text_encoder", JaxCLIPWithProjection, CLIPTextModelWithProjection, CLIP),
             ("text_encoder_2", JaxCLIPWithProjection, CLIPTextModelWithProjection, dict(CLIP, hidden_size=16)),
             ("transformer", JaxSD3, SD3Transformer2DModel, transformer)]
    if t5:
        specs.append(("text_encoder_3", JaxT5EncoderModel, T5EncoderModel, T5))
    jax_parts, torch_parts = _parts(specs, seed=seed)
    tokenizers = dict(tokenizer=CRCTokenizer(), tokenizer_2=CRCTokenizer(), tokenizer_3=CRCTokenizer() if t5 else None)
    jpipe = jcls(scheduler=JaxFlowMatch(shift=3.0), **tokenizers, **jax_parts)
    tpipe = tcls(scheduler=FlowMatchEulerDiscreteScheduler(shift=3.0), device="cpu", **tokenizers, **torch_parts)
    return jpipe, tpipe


LATENTS = np.random.RandomState(1).randn(1, 4, 8, 8).astype(np.float32)


def _run_pair(jpipe, tpipe, steps, **kw):
    kwargs = dict(num_inference_steps=steps, guidance_scale=5.0, max_sequence_length=TXT_LEN, output_type="np", **kw)
    ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), **kwargs).images)
    out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).images
    assert out.shape == (1, 8, 8, 3) and out.dtype == np.float32 and np.isfinite(out).all()
    return ref, out


@pytest.mark.parametrize("style,t5", [("sd3.5", True), ("sd3.0", True), ("sd3.5", False)])
def test_pipeline_matches_jax(style, t5):
    jpipe, tpipe = build(SD35 if style == "sd3.5" else SD30, t5=t5)
    flash_attention_full.launches = group_norm.launches = 0
    ref, out = _run_pair(jpipe, tpipe, steps=2)
    assert flash_attention_full.launches == group_norm.launches == 0  # CPU tensors took the plain versions
    assert float(np.abs(out - ref).max()) <= ATOL, float(np.abs(out - ref).max())


def test_encode_prompt_layout():
    """CLIP-L and CLIP-G penultimate states side by side, zero-padded to T5's
    width, before T5's tokens; pooled = both projections; [negative,
    positive] under CFG."""
    _, tpipe = build(t5=False)
    pe, ne, pooled, npooled = tpipe.encode_prompt(PROMPT, "blurry", True, max_sequence_length=TXT_LEN)
    assert pe.shape == ne.shape == (1, 77 + TXT_LEN, 32) and pooled.shape == npooled.shape == (1, 32)
    assert torch.all(pe[:, :77, 24:] == 0) and torch.all(pe[:, 77:] == 0)
    embeds, _, batch = tpipe._conditioning(PROMPT, "blurry", True, TXT_LEN, 2)
    assert batch == 2 and embeds.shape[0] == 4
    torch.testing.assert_close(embeds[0], ne[0], rtol=0, atol=0)
    torch.testing.assert_close(embeds[3], pe[0], rtol=0, atol=0)


@pytest.fixture(scope="module")
def pair():
    jpipe, tpipe = build(seed=2)
    uncached = _run_pair(jpipe, tpipe, steps=STEPS)[1]
    return jpipe, tpipe, uncached


def _calls(module):
    calls = []
    return calls, module.register_forward_pre_hook(lambda mod, args: calls.append(args[0].shape[0]))


CONFIGS = {
    "taylorseer": lambda m: m.TaylorSeerCacheConfig(cache_interval=3, disable_cache_before_step=2, max_order=2),
    "mag_cache": lambda m: m.MagCacheConfig(threshold=0.5, max_skip_steps=1, retention_ratio=0.25,
                                            num_inference_steps=STEPS, mag_ratios=(1.0,) * STEPS),
    "faster_cache": lambda m: m.FasterCacheConfig(unconditional_batch_skip_range=3,
                                                  unconditional_batch_timestep_skip_range=(-1, 1000)),
    "pab": lambda m: (hooks.PyramidAttentionBroadcastConfig if m is hooks else JaxPyramidAttentionBroadcastConfig)(
        spatial_attention_block_skip_range=2, spatial_attention_timestep_skip_range=(100, 950)),
    "first_block_cache": lambda m: m.FirstBlockCacheConfig(threshold=0.2),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cache_matches_jax(pair, name):
    jpipe, tpipe, uncached = pair
    transformer = tpipe.transformer
    calls, h1 = _calls(transformer)
    tail, h2 = _calls(transformer.transformer_blocks[1])
    attn, h3 = _calls(transformer.transformer_blocks[1].attn)
    jpipe.enable_cache(CONFIGS[name](jhooks))
    tpipe.enable_cache(CONFIGS[name](hooks))
    try:
        ref, out = _run_pair(jpipe, tpipe, steps=STEPS)
    finally:
        jpipe.disable_cache()
        tpipe.disable_cache()
        for h in (h1, h2, h3):
            h.remove()
    assert float(np.abs(out - ref).max()) <= ATOL, float(np.abs(out - ref).max())
    assert float(np.abs(out - uncached).max()) > ACTS, "the cache did not act"
    # a skipped step makes no transformer call, or none of what it skips
    if name == "taylorseer":
        assert calls == [2] * 4
    elif name == "mag_cache":
        assert calls == [2] * 5
    elif name == "faster_cache":  # the uncond branch on steps 0, 3, 6: batch 2; else batch 1
        assert calls == [2, 1, 1, 2, 1, 1, 2, 1]
    elif name == "pab":
        assert len(calls) == len(tail) == STEPS and 0 < len(attn) < STEPS
    else:
        decisions = tpipe.fbc_record["decisions"]
        assert len(calls) == len(decisions) == STEPS and decisions[0] and not all(decisions)
        assert len(tail) == sum(decisions)


def test_text_kv_is_the_uncached_path(pair):
    jpipe, tpipe, uncached = pair
    calls, handle = _calls(tpipe.transformer.context_embedder)
    jpipe.enable_cache(JaxTextKVCacheConfig())
    tpipe.enable_cache(hooks.TextKVCacheConfig())
    try:
        ref, out = _run_pair(jpipe, tpipe, steps=STEPS)
    finally:
        jpipe.disable_cache()
        tpipe.disable_cache()
        handle.remove()
    assert len(calls) == 1  # context_embedder(prompt_embeds) once a request
    np.testing.assert_array_equal(out, uncached)
    assert float(np.abs(out - ref).max()) <= ATOL


def test_callback_matches_jax(pair):
    jpipe, tpipe, uncached = pair
    seen = []

    def callback(pipe, i, t, kwargs):
        seen.append((i, float(t), sorted(kwargs)))
        return {"latents": kwargs["latents"] * 0.5} if i == 3 else {}

    ref, out = _run_pair(jpipe, tpipe, steps=STEPS, callback_on_step_end=callback)
    assert float(np.abs(out - ref).max()) <= ATOL
    assert float(np.abs(out - uncached).max()) > ACTS
    port_seen = seen[len(seen) // 2:]
    assert [s[0] for s in port_seen] == list(range(STEPS)) and all(s[2] == ["latents"] for s in port_seen)
    tpipe.enable_cache(hooks.TaylorSeerCacheConfig())
    try:
        with pytest.raises(ValueError, match="callback_on_step_end cannot"):
            tpipe(PROMPT, num_inference_steps=2, callback_on_step_end=callback, output_type="latent",
                  max_sequence_length=TXT_LEN)
    finally:
        tpipe.disable_cache()


@pytest.fixture
def draws(monkeypatch):
    """Makes the port's `randn_tensor` return JAX's (encoder sample, noise)."""
    queue = jax_draws((1, 4, 8, 8))

    def randn_tensor(shape, generator=None, device=None):
        out = queue.pop(0)
        assert tuple(shape) == out.shape
        return torch.from_numpy(out).to(device)

    monkeypatch.setattr(torch_utils, "randn_tensor", randn_tensor)
    return queue


@pytest.mark.parametrize("kind", ["img2img", "img2img_fbc", "inpaint"])
def test_image_pipelines_match_jax(draws, kind):
    jcls, tcls = (JaxInpaint, StableDiffusion3InpaintPipeline) if kind == "inpaint" else (
        JaxImg2Img, StableDiffusion3Img2ImgPipeline)
    jpipe, tpipe = build(jcls=jcls, tcls=tcls, seed=3)
    kwargs = dict(image=IMAGE, strength=0.7, num_inference_steps=4, guidance_scale=5.0, max_sequence_length=TXT_LEN,
                  output_type="np")
    if kind == "inpaint":
        kwargs["mask_image"] = MASK
    if kind == "img2img_fbc":
        jpipe.enable_cache(jhooks.FirstBlockCacheConfig(threshold=0.2))
        tpipe.enable_cache(hooks.FirstBlockCacheConfig(threshold=0.2))
    ref = np.asarray(jpipe(PROMPT, key=jax.random.PRNGKey(3), **kwargs).images)
    out = tpipe(PROMPT, **kwargs).images
    assert not draws  # the port drew the encoder's sample and the noise
    assert out.shape == (1, 8, 8, 3) and np.isfinite(out).all()
    assert float(np.abs(out - ref).max()) <= ATOL, float(np.abs(out - ref).max())
    if kind == "img2img_fbc":
        assert not all(tpipe.fbc_record["decisions"])


def test_image_pipelines_cache_configs():
    """img2img honours the caches JAX's img2img loop runs; inpaint none."""
    _, img2img = build(jcls=JaxImg2Img, tcls=StableDiffusion3Img2ImgPipeline, t5=False)
    inpaint = StableDiffusion3InpaintPipeline(**img2img.components, device="cpu")
    img2img.enable_cache(hooks.TaylorSeerCacheConfig())
    for pipe, config in ((img2img, hooks.FasterCacheConfig()), (img2img, hooks.PyramidAttentionBroadcastConfig()),
                         (inpaint, hooks.TaylorSeerCacheConfig())):
        with pytest.raises(TypeError, match="does not support cache config"):
            pipe.enable_cache(config)


def test_jax_image_pipelines_and_unhonoured_caches():
    """What the refusals above stand against (ROADMAP C): JAX's img2img
    accepts FasterCache in `enable_cache` and raises only when called; its
    inpaint accepts any config and runs the loop uncached, bit for bit."""
    jpipe = build(jcls=JaxImg2Img, tcls=StableDiffusion3Img2ImgPipeline, t5=False)[0]
    kwargs = dict(image=IMAGE, strength=1.0, num_inference_steps=2, guidance_scale=5.0, max_sequence_length=TXT_LEN,
                  output_type="latent", key=jax.random.PRNGKey(0))
    jpipe.enable_cache(jhooks.FasterCacheConfig())
    with pytest.raises(ValueError, match="does not support cache config FasterCacheConfig"):
        jpipe(PROMPT, **kwargs)
    jpipe = JaxInpaint(**jpipe.components)
    kwargs["mask_image"] = MASK
    dense = np.asarray(jpipe(PROMPT, **kwargs).images)
    jpipe.enable_cache(jhooks.TaylorSeerCacheConfig(cache_interval=2, disable_cache_before_step=1))
    np.testing.assert_array_equal(np.asarray(jpipe(PROMPT, **kwargs).images), dense)


def test_pipeline_defaults_to_the_card(monkeypatch):
    """Built without `device`, the pipeline goes to "cuda"; with no card
    visible it raises instead of running on the CPU. The package root exports
    it, as the server expects."""
    assert RootExport is StableDiffusion3Pipeline
    _, tpipe = build(t5=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StableDiffusion3Pipeline(**tpipe.components)

"""The port's cached SDXL and Flux pipelines against the JAX cached
pipelines, end to end on the CPU, one case per config each pipeline honours.

The SDXL pair has the tiny components of tests/test_torch_pipeline_sdxl.py.
The Flux pair has those of tests/test_torch_pipeline_flux.py with its
transformer in float32 (the same widths, not quantized), so that no int8
rounding flip enters a comparison of 8 steps: the caches act on the
transformer's input and output, which w8a8 does not change. The weights are
the port's initialisation from a seed, 1-D ones jittered, carried into JAX
with `convert_torch_state_dict` (JAX's own eager `init` of the tiny UNet
takes over 20 s on a CPU). Both sides get the same numpy latents and
compare the final latents (`output_type="latent"`).

Tolerance: max-abs `1e-3` on the latents, the existing pipeline tests'
limit; float32 on both sides, so the differences are summation order
(measured at most 3e-5 on the SDXL latents, 2e-6 on Flux's). Each cached
case also differs from the port's uncached output by more than that, so
the cache is shown to act. TextKV
must equal the uncached port output bit for bit, with each cross
attention's K/V (SDXL: every `attn2.to_k`; Flux: `context_embedder`)
computed once a request.
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
from diffusers_tpu.models.modeling_utils import convert_torch_state_dict
from diffusers_tpu.models.text_encoders.clip import CLIPTextModel as JaxCLIPTextModel
from diffusers_tpu.models.text_encoders.clip import CLIPTextModelWithProjection as JaxCLIPTextModelWithProjection
from diffusers_tpu.models.text_encoders.t5 import T5EncoderModel as JaxT5EncoderModel
from diffusers_tpu.models.transformers.transformer_flux import FluxTransformer2DModel as JaxFlux
from diffusers_tpu.models.unets.unet_2d_condition import UNet2DConditionModel as JaxUNet2DConditionModel
from diffusers_tpu.pipelines.flux.pipeline_flux import FluxPipeline as JaxFluxPipeline
from diffusers_tpu.pipelines.stable_diffusion_xl.pipeline_stable_diffusion_xl import (
    StableDiffusionXLPipeline as JaxStableDiffusionXLPipeline,
)
from diffusers_tpu.schedulers import EulerDiscreteScheduler as JaxEulerDiscreteScheduler
from diffusers_tpu.schedulers import FlowMatchEulerDiscreteScheduler as JaxFlowMatch
import diffusers_tpu_torch.hooks as hooks
from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel, CLIPTextModelWithProjection
from diffusers_tpu_torch.models.text_encoders.t5 import T5EncoderModel
from diffusers_tpu_torch.models.transformers.transformer_flux import FluxTransformer2DModel
from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
from diffusers_tpu_torch.pipelines.flux.pipeline_flux import FluxPipeline
from diffusers_tpu_torch.pipelines.stable_diffusion_xl.pipeline_stable_diffusion_xl import StableDiffusionXLPipeline
from diffusers_tpu_torch.schedulers import EulerDiscreteScheduler, FlowMatchEulerDiscreteScheduler
from test_torch_flux import W8A8
from test_torch_pipeline_flux import CLIP as FLUX_CLIP, FLOW_MATCH, T5, TXT_LEN, VAE as FLUX_VAE
from test_torch_pipeline_flux import CRCTokenizer as FluxTokenizer
from test_torch_pipeline_sdxl import CLIP, EULER, UNET, VAE, CRCTokenizer
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

ATOL = 1e-3
STEPS = 8
PROMPT = "a crystal fox"


def _parts(specs, seed):
    """Port models from `seed`, 1-D weights jittered, and their JAX twins
    with the same weights: ({name: (jax model, params)}, {name: port model})."""
    torch.manual_seed(seed)
    rng = np.random.RandomState(seed)
    jax_parts, torch_parts = {}, {}
    for name, jcls, tcls, cfg in specs:
        jm, tm = jcls(**cfg), tcls(**cfg).eval()
        with torch.no_grad():
            for p in tm.parameters():
                if p.ndim == 1:
                    p.add_(torch.from_numpy(0.1 * rng.randn(*p.shape).astype(np.float32)))
        state = {k: v.numpy() for k, v in tm.state_dict().items()}
        jax_parts[name], torch_parts[name] = (jm, convert_torch_state_dict(jm, state)), tm
    return jax_parts, torch_parts


def build_sdxl():
    """(JAX pipeline, port pipeline, run JAX, run port, port uncached latents)."""
    jax_parts, torch_parts = _parts([
        ("unet", JaxUNet2DConditionModel, UNet2DConditionModel, UNET),
        ("vae", JaxAutoencoderKL, AutoencoderKL, VAE),
        ("text_encoder", JaxCLIPTextModel, CLIPTextModel, CLIP),
        ("text_encoder_2", JaxCLIPTextModelWithProjection, CLIPTextModelWithProjection, CLIP),
    ], seed=0)
    jpipe = JaxStableDiffusionXLPipeline(tokenizer=CRCTokenizer(), tokenizer_2=CRCTokenizer(),
                                         scheduler=JaxEulerDiscreteScheduler(**EULER), **jax_parts)
    tpipe = StableDiffusionXLPipeline(tokenizer=CRCTokenizer(), tokenizer_2=CRCTokenizer(),
                                      scheduler=EulerDiscreteScheduler(**EULER), device="cpu", **torch_parts)
    latents = np.random.RandomState(0).randn(1, 4, 8, 8).astype(np.float32)
    kwargs = dict(num_inference_steps=STEPS, guidance_scale=5.0, output_type="latent")
    run_jax = lambda **kw: np.asarray(jpipe(PROMPT, latents=jnp.asarray(latents), **kwargs, **kw).images)  # noqa: E731
    run = lambda **kw: tpipe(PROMPT, latents=torch.from_numpy(latents), **kwargs, **kw).images  # noqa: E731
    return jpipe, tpipe, run_jax, run, run().numpy()


def build_flux():
    jax_parts, torch_parts = _parts([
        ("vae", JaxAutoencoderKL, AutoencoderKL, FLUX_VAE),
        ("text_encoder", JaxCLIPTextModel, CLIPTextModel, FLUX_CLIP),
        ("text_encoder_2", JaxT5EncoderModel, T5EncoderModel, T5),
        ("transformer", JaxFlux, FluxTransformer2DModel, W8A8),
    ], seed=1)
    jpipe = JaxFluxPipeline(scheduler=JaxFlowMatch(**FLOW_MATCH), tokenizer=FluxTokenizer(),
                            tokenizer_2=FluxTokenizer(), **jax_parts)
    tpipe = FluxPipeline(scheduler=FlowMatchEulerDiscreteScheduler(**FLOW_MATCH), tokenizer=FluxTokenizer(),
                         tokenizer_2=FluxTokenizer(), device="cpu", **torch_parts)
    latents = np.random.RandomState(0).randn(1, 16, 16).astype(np.float32)  # packed 8x8x4 latents
    kwargs = dict(height=8, width=8, num_inference_steps=STEPS, guidance_scale=3.5, max_sequence_length=TXT_LEN,
                  output_type="latent")
    run_jax = lambda **kw: np.asarray(jpipe(PROMPT, latents=jnp.asarray(latents), **kwargs, **kw).images)  # noqa: E731
    run = lambda **kw: tpipe(PROMPT, latents=torch.from_numpy(latents), **kwargs, **kw).images  # noqa: E731
    return jpipe, tpipe, run_jax, run, run().numpy()


@pytest.fixture(scope="module")
def sdxl():
    return build_sdxl()


@pytest.fixture(scope="module")
def flux():
    return build_flux()


def _cached(pair, cfg, jcfg):
    jpipe, tpipe, run_jax, run, uncached = pair
    jpipe.enable_cache(jcfg)
    tpipe.enable_cache(cfg)
    try:
        ref, out = run_jax(), run()
    finally:
        jpipe.disable_cache()
        tpipe.disable_cache()
    assert out.shape == uncached.shape and torch.isfinite(out).all()
    err = float(np.abs(out.numpy() - ref).max())
    assert err <= ATOL, err
    assert float(np.abs(out.numpy() - uncached).max()) > ATOL, "the cache did not act"
    return out


def _counting(module):
    calls = []
    handle = module.register_forward_hook(lambda *_: calls.append(1))
    return calls, handle


SDXL_CONFIGS = {
    "taylorseer": (dict(cache_interval=3, disable_cache_before_step=2, max_order=2), "TaylorSeerCacheConfig"),
    "faster_cache": (dict(unconditional_batch_skip_range=3, unconditional_batch_timestep_skip_range=(-1, 1000)),
                     "FasterCacheConfig"),
    "mag_cache": (dict(threshold=0.5, max_skip_steps=1, retention_ratio=0.25, num_inference_steps=STEPS,
                       mag_ratios=(1.0,) * STEPS), "MagCacheConfig"),
}


@pytest.mark.parametrize("name", sorted(SDXL_CONFIGS))
def test_sdxl_cache_matches_jax(sdxl, name):
    kw, cls = SDXL_CONFIGS[name]
    unet_calls, handle = _counting(sdxl[1].unet)
    try:
        _cached(sdxl, getattr(hooks, cls)(**kw), getattr(jhooks, cls)(**kw))
    finally:
        handle.remove()
    # a skipped step makes no UNet call (FasterCache: one at batch 1)
    expected = {"taylorseer": 4, "faster_cache": STEPS, "mag_cache": 5}[name]
    assert len(unet_calls) == expected


FLUX_CONFIGS = {
    "taylorseer": lambda m: m.TaylorSeerCacheConfig(cache_interval=3, disable_cache_before_step=2, max_order=2),
    "first_block_cache": lambda m: m.FirstBlockCacheConfig(threshold=0.5),
    "pab": lambda m: (hooks.PyramidAttentionBroadcastConfig if m is hooks else JaxPyramidAttentionBroadcastConfig)(
        spatial_attention_block_skip_range=2, spatial_attention_timestep_skip_range=(100, 950)),
    "mag_cache": lambda m: m.MagCacheConfig(threshold=0.5, max_skip_steps=1, retention_ratio=0.25,
                                            mag_ratios=tuple(m.FLUX_MAG_RATIOS)),
}


@pytest.mark.parametrize("name", sorted(FLUX_CONFIGS))
def test_flux_cache_matches_jax(flux, name):
    transformer = flux[1].transformer
    tail_calls, h1 = _counting(transformer.single_transformer_blocks[0])
    attn_calls, h2 = _counting(transformer.single_transformer_blocks[0].attn)
    try:
        _cached(flux, FLUX_CONFIGS[name](hooks), FLUX_CONFIGS[name](jhooks))
    finally:
        h1.remove()
        h2.remove()
    if name == "first_block_cache":
        decisions = flux[1].fbc_record["decisions"]
        assert len(decisions) == STEPS and decisions[0] and not all(decisions)
        assert len(tail_calls) == sum(decisions)
    elif name == "pab":
        assert len(tail_calls) == STEPS and 0 < len(attn_calls) < STEPS
    else:
        assert len(tail_calls) < STEPS and len(attn_calls) == len(tail_calls)


def test_sdxl_text_kv_is_the_uncached_path(sdxl):
    jpipe, tpipe, run_jax, run, uncached = sdxl
    attn2 = [m.attn2 for m in tpipe.unet.modules() if getattr(m, "attn2", None) is not None]
    hooked = [_counting(a.to_k) for a in attn2]
    tpipe.enable_cache(hooks.TextKVCacheConfig())
    jpipe.enable_cache(JaxTextKVCacheConfig())
    try:
        out = run().numpy()
        ref = run_jax()
    finally:
        tpipe.disable_cache()
        jpipe.disable_cache()
        for _, h in hooked:
            h.remove()
    assert attn2 and all(len(calls) == 1 for calls, _ in hooked)
    np.testing.assert_array_equal(out, uncached)
    assert float(np.abs(out - ref).max()) <= ATOL
    assert all(a.text_kv is None for a in attn2)  # dropped after the request


def test_flux_text_kv_is_the_uncached_path(flux):
    jpipe, tpipe, run_jax, run, uncached = flux
    calls, handle = _counting(tpipe.transformer.context_embedder)
    tpipe.enable_cache(hooks.TextKVCacheConfig())
    jpipe.enable_cache(JaxTextKVCacheConfig())
    try:
        out = run().numpy()
        ref = run_jax()
    finally:
        tpipe.disable_cache()
        jpipe.disable_cache()
        handle.remove()
    assert len(calls) == 1
    np.testing.assert_array_equal(out, uncached)
    assert float(np.abs(out - ref).max()) <= ATOL

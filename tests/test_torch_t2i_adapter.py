"""T2I-Adapter and VAE tiling in the port against the JAX package on the CPU:
the three adapter types and `MultiAdapter`, the UNet's intrablock residuals
(`down_intrablock_additional_residuals`), `StableDiffusionAdapterPipeline`,
`AutoencoderKL.tiled_decode` against JAX's, and the Flux pipeline's tiled
decode branch.

The port's models are made from a seed and carried into JAX with
`convert_torch_state_dict`; inputs are numpy arrays made with a seed.
Tolerances (the README's): an adapter's features and a UNet call 5e-4 (a
whole model); a pipeline's [0, 1] image 5e-4; a decode 2e-5 against JAX's
(the same convolutions and GroupNorms on the same tiles, float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.models.adapter import MultiAdapter as JaxMultiAdapter
from diffusers_tpu.models.adapter import T2IAdapter as JaxT2IAdapter
from diffusers_tpu.models.autoencoders.autoencoder_kl import AutoencoderKL as JaxAutoencoderKL
from diffusers_tpu.models.autoencoders.vae import DecoderOutput
from diffusers_tpu.models.text_encoders.clip import CLIPTextModel as JaxCLIPTextModel
from diffusers_tpu.models.unets.unet_2d_condition import UNet2DConditionModel as JaxUNet2DConditionModel
from diffusers_tpu.pipelines.t2i_adapter.pipeline_stable_diffusion_adapter import (
    StableDiffusionAdapterPipeline as JaxAdapterPipeline,
)
from diffusers_tpu_torch.image_processor import postprocess_np
from diffusers_tpu_torch.models.adapter import MultiAdapter, T2IAdapter
from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel
from diffusers_tpu_torch.models.text_encoders.t5 import T5EncoderModel
from diffusers_tpu_torch.models.transformers.transformer_flux import FluxTransformer2DModel
from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
from diffusers_tpu_torch.pipelines.flux.pipeline_flux import FluxPipeline
from diffusers_tpu_torch.pipelines.t2i_adapter import StableDiffusionAdapterPipeline
from diffusers_tpu_torch.schedulers import FlowMatchEulerDiscreteScheduler
from test_torch_flux import W8A8
from test_torch_pipeline_cache import _parts
from test_torch_pipeline_flux import CLIP as FLUX_CLIP, FLOW_MATCH, T5, TXT_LEN, CRCTokenizer as FluxTokenizer
from test_torch_pipeline_sdxl import CLIP, VAE, CRCTokenizer
from test_torch_stable_diffusion import LATENTS, PROMPT, SCHEDULERS, UNET_SD
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

ATOL = 5e-4
DECODE_ATOL = 2e-5
ADAPTERS = {
    "full_adapter": dict(in_channels=3, channels=(8, 16, 16, 16), num_res_blocks=2, downscale_factor=4),
    "full_adapter_xl": dict(in_channels=1, channels=(8, 16, 16, 16), num_res_blocks=1, downscale_factor=4),
    "light_adapter": dict(in_channels=3, channels=(8, 16, 16), num_res_blocks=1, downscale_factor=2),
}
# the adapter of the pipeline test: the tiny SD UNet's two down blocks (8 ch at 8 x 8, 16 ch at 4 x 4) on an
# 8 x 8 control image (VAE scale 1)
PIPE_ADAPTER = dict(in_channels=3, channels=(8, 16), num_res_blocks=1, downscale_factor=1)


def _max_diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def _adapter_pair(cfg, seed):
    (jax_part,), (port,) = (list(d.values()) for d in _parts([("adapter", JaxT2IAdapter, T2IAdapter, cfg)], seed))
    return jax_part, port


@pytest.mark.parametrize("adapter_type,size", [("full_adapter", 36), ("full_adapter_xl", 32), ("light_adapter", 24)])
def test_adapter_matches_jax(adapter_type, size):
    """Each type's features, one a body block; the odd sizes the pools meet
    (36 / 4 = 9 -> 5 -> 3 -> 2; 24 / 2 = 12 -> 6 -> 3 -> 2) pad as JAX does."""
    cfg = dict(ADAPTERS[adapter_type], adapter_type=adapter_type)
    (jmod, jparams), adapter = _adapter_pair(cfg, seed=2)
    x = np.random.RandomState(3).rand(2, cfg["in_channels"], size, size).astype(np.float32)
    ref = jax.jit(jmod)(jparams, jnp.asarray(x))
    with torch.no_grad():
        out = adapter(torch.from_numpy(x))
    assert len(out) == len(ref) == len(adapter.body) and adapter.total_downscale_factor == jmod.total_downscale_factor
    for o, r in zip(out, ref):
        assert o.shape == r.shape and _max_diff(o, r) <= ATOL


def test_multi_adapter_matches_jax():
    cfg = dict(ADAPTERS["full_adapter"], adapter_type="full_adapter")
    pairs = [_adapter_pair(cfg, seed=s) for s in (4, 5)]
    jmulti = JaxMultiAdapter([p[0][0] for p in pairs])
    jparams = {"adapters": [p[0][1] for p in pairs]}
    multi = MultiAdapter([p[1] for p in pairs])
    x = np.random.RandomState(6).rand(1, 6, 32, 32).astype(np.float32)
    for weights in (None, [0.3, 1.2]):
        ref = jmulti(jparams, jnp.asarray(x), adapter_weights=weights)
        with torch.no_grad():
            out = multi(torch.from_numpy(x), adapter_weights=weights)
        assert all(_max_diff(o, r) <= ATOL for o, r in zip(out, ref))
    with pytest.raises(ValueError):
        MultiAdapter([pairs[0][1]])


def test_unet_intrablock_residuals_match_jax():
    """One feature a cross-attention down block (after its last layer), the
    next where a plain down block's output shape matches, a leftover at the
    mid block's size added before the mid block; NCHW in."""
    (jax_part,), (unet,) = (list(d.values()) for d in _parts(
        [("unet", JaxUNet2DConditionModel, UNet2DConditionModel, UNET_SD)], seed=1))
    jax_unet, jax_params = jax_part
    rng = np.random.RandomState(7)
    sample, ehs = rng.randn(2, 4, 8, 8).astype(np.float32), rng.randn(2, 77, 16).astype(np.float32)
    feats = [rng.randn(2, 8, 8, 8).astype(np.float32), rng.randn(2, 16, 4, 4).astype(np.float32),
             rng.randn(2, 16, 4, 4).astype(np.float32)]
    for n in (2, 3):
        ref = jax.jit(lambda p, x, e, f: jax_unet(p, x, jnp.asarray([300, 300]), encoder_hidden_states=e,
                                                  down_intrablock_additional_residuals=f).sample)(
            jax_params, jnp.asarray(sample), jnp.asarray(ehs), [jnp.asarray(f) for f in feats[:n]])
        residuals = [torch.from_numpy(f) for f in feats[:n]]
        with torch.no_grad():
            out = unet(torch.from_numpy(sample), 300, torch.from_numpy(ehs),
                       down_intrablock_additional_residuals=residuals).sample
            plain = unet(torch.from_numpy(sample), 300, torch.from_numpy(ehs)).sample
        assert len(residuals) == n  # the caller's list is not consumed
        assert _max_diff(out, ref) <= ATOL and _max_diff(out, plain) > ATOL


def _adapter_pipelines(scheduler, adapter):
    jsched, tsched, cfg = SCHEDULERS[scheduler]
    specs = [("unet", JaxUNet2DConditionModel, UNet2DConditionModel, UNET_SD),
             ("vae", JaxAutoencoderKL, AutoencoderKL, VAE),
             ("text_encoder", JaxCLIPTextModel, CLIPTextModel, CLIP)]
    jax_parts, torch_parts = _parts(specs, seed=1)
    jax_parts["adapter"], torch_parts["adapter"] = adapter
    jpipe = JaxAdapterPipeline(tokenizer=CRCTokenizer(), scheduler=jsched(**cfg), **jax_parts)
    tpipe = StableDiffusionAdapterPipeline(tokenizer=CRCTokenizer(), scheduler=tsched(**cfg), device="cpu",
                                           **torch_parts)
    return jpipe, tpipe


@pytest.mark.parametrize("multi", [False, True], ids=["one-adapter", "multi-adapter"])
def test_adapter_pipeline_matches_jax(multi):
    if multi:
        pairs = [_adapter_pair(dict(PIPE_ADAPTER, in_channels=2), seed=s) for s in (8, 9)]
        adapter = ((JaxMultiAdapter([p[0][0] for p in pairs]), {"adapters": [p[0][1] for p in pairs]}),
                   MultiAdapter([p[1] for p in pairs]))
        control, scale = np.random.RandomState(10).rand(1, 4, 8, 8).astype(np.float32), [0.7, 0.4]
    else:
        adapter = _adapter_pair(PIPE_ADAPTER, seed=8)
        control, scale = np.random.RandomState(10).rand(8, 8, 3).astype(np.float32), 0.8
    jpipe, tpipe = _adapter_pipelines("pndm", adapter)
    kwargs = dict(image=control, num_inference_steps=3, guidance_scale=7.5, adapter_conditioning_scale=scale,
                  output_type="np")
    ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), **kwargs).images)
    calls = []
    hook = tpipe.adapter.register_forward_hook(lambda *a: calls.append(1))
    out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).images
    hook.remove()
    assert len(calls) == 1  # the adapter runs once a request
    assert out.shape == (1, 8, 8, 3) and _max_diff(out, ref) <= ATOL
    plain = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **dict(kwargs, adapter_conditioning_scale=0.0 if not multi
                                                                        else [0.0, 0.0])).images
    assert _max_diff(out, plain) > ATOL


# ---------------------------------------------------------------------------- VAE tiling


def test_tiled_decode_matches_jax():
    """Tiles of 16 px (8 latents, a new tile every 6) over a 20 x 28 latent,
    blended over 4 px and cut to 12 px as JAX's `tiled_decode` does."""
    cfg = dict(VAE, block_out_channels=(8, 8), down_block_types=("DownEncoderBlock2D",) * 2,
               up_block_types=("UpDecoderBlock2D",) * 2, sample_size=16)
    (jax_part,), (vae,) = (list(d.values()) for d in _parts([("vae", JaxAutoencoderKL, AutoencoderKL, cfg)], seed=3))
    jvae, jparams = jax_part
    jitted = jax.jit(lambda p, z, decode=jvae.decode: decode(p, z).sample)

    def jax_decode(p, z, return_dict=True):  # JAX's decode, jitted per tile shape
        return DecoderOutput(sample=jitted(p, z))

    jvae.decode = jax_decode
    assert (vae.tile_sample_min_size, vae.tile_latent_min_size) == (jvae.tile_sample_min_size,
                                                                    jvae.tile_latent_min_size) == (16, 8)
    z = np.random.RandomState(4).randn(1, 4, 20, 28).astype(np.float32)
    ref = jvae.tiled_decode(jparams, jnp.asarray(z)).sample
    with torch.no_grad():
        out = vae.tiled_decode(torch.from_numpy(z)).sample
        whole = vae.decode(torch.from_numpy(z)).sample
    assert out.shape == ref.shape == whole.shape == (1, 3, 40, 56) and _max_diff(out, ref) <= DECODE_ATOL
    assert _max_diff(out, whole) > DECODE_ATOL  # the tiles see less context than the whole
    vae.enable_tiling(32)
    assert vae.use_tiling and (vae.tile_sample_min_size, vae.tile_latent_min_size) == (32, 16)
    vae.disable_tiling()
    assert not vae.use_tiling


def test_flux_pipeline_tiled_decode_branch():
    """With `vae.enable_tiling()` the Flux pipeline decodes with
    `tiled_decode` (JAX `pipeline_flux.py:444-447`), else whole."""
    torch.manual_seed(0)
    vae_cfg = dict(VAE, block_out_channels=(32,), norm_num_groups=32, sample_size=8, scaling_factor=0.3611,
                   shift_factor=0.1159, use_quant_conv=False, use_post_quant_conv=False)
    pipe = FluxPipeline(scheduler=FlowMatchEulerDiscreteScheduler(**FLOW_MATCH), tokenizer=FluxTokenizer(),
                        tokenizer_2=FluxTokenizer(), vae=AutoencoderKL(**vae_cfg), text_encoder=CLIPTextModel(**FLUX_CLIP),
                        text_encoder_2=T5EncoderModel(**T5), transformer=FluxTransformer2DModel(**W8A8), device="cpu")
    kwargs = dict(height=16, width=16, num_inference_steps=2, max_sequence_length=TXT_LEN)
    latents = pipe(PROMPT, generator=torch.Generator().manual_seed(0), output_type="latent", **kwargs).images
    z = pipe._unpack_latents(latents, 16, 16, pipe.vae_scale_factor) / pipe.vae.config.scaling_factor
    z = z + pipe.vae.config.shift_factor
    pipe.vae.enable_tiling()
    tiled = pipe(PROMPT, generator=torch.Generator().manual_seed(0), output_type="np", **kwargs).images
    pipe.vae.disable_tiling()
    whole = pipe(PROMPT, generator=torch.Generator().manual_seed(0), output_type="np", **kwargs).images
    with torch.no_grad():
        np.testing.assert_array_equal(tiled, postprocess_np(pipe.vae.tiled_decode(z).sample))
        np.testing.assert_array_equal(whole, postprocess_np(pipe.vae.decode(z).sample))
    assert tiled.shape == whole.shape == (1, 16, 16, 3) and _max_diff(tiled, whole) > 0

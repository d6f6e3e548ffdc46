"""The port's Flux text-to-image pipeline against the JAX one, end to end on
the CPU, and the port pipelines' device default.

Tiny components (the w8a8 transformer of tests/test_torch_flux.py, a
128-wide CLIP, a tiny T5 and a one-level Flux-style VAE: 4 latent channels,
no quant convs, scaling and shift factors) are built in JAX, their parameters
carried into the port with `load_jax_params` (the transformer's w8a8 leaves
included), both pipelines get the same packed numpy latents and a
deterministic tokenizer, and the `output_type="np"` images of a 2-step
request are compared.

Tolerance: `2e-3` on the [0, 1] image, float32 on both sides. Without a
quantization flip the differences are summation order (~1e-6); a flip of one
qx in the transformer moves its output by up to one quantization step (about
2e-3, tests/test_torch_flux.py), and the step and the VAE pass it on at
about that size.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.models.autoencoders.autoencoder_kl import AutoencoderKL as JaxAutoencoderKL
from diffusers_tpu.models.text_encoders.clip import CLIPTextModel as JaxCLIPTextModel
from diffusers_tpu.models.text_encoders.t5 import T5EncoderModel as JaxT5EncoderModel
from diffusers_tpu.models.transformers.transformer_flux import FluxTransformer2DModel as JaxFlux
from diffusers_tpu.pipelines.flux.pipeline_flux import FluxPipeline as JaxFluxPipeline
from diffusers_tpu.schedulers import FlowMatchEulerDiscreteScheduler as JaxFlowMatch
from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
from diffusers_tpu_torch.models.modeling_utils import load_jax_params
from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel
from diffusers_tpu_torch.models.text_encoders.t5 import T5EncoderModel
from diffusers_tpu_torch.models.transformers.transformer_flux import FluxTransformer2DModel
from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention_full
from diffusers_tpu_torch.ops.cuda.w8a8_matmul import w8a8_matmul_2d
from diffusers_tpu_torch.ops.cuda.group_norm import group_norm
from diffusers_tpu_torch.pipelines.flux.pipeline_flux import FluxPipeline
from diffusers_tpu_torch.pipelines.stable_diffusion_xl.pipeline_stable_diffusion_xl import StableDiffusionXLPipeline
from diffusers_tpu_torch.schedulers import EulerDiscreteScheduler, FlowMatchEulerDiscreteScheduler
from test_torch_flux import W8A8, flux_tree
from test_torch_pipeline_sdxl import UNET, _carry
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

IMAGE_ATOL = 2e-3
VAE = dict(in_channels=3, out_channels=3, block_out_channels=(32,), down_block_types=("DownEncoderBlock2D",),
           up_block_types=("UpDecoderBlock2D",), latent_channels=4, layers_per_block=1, norm_num_groups=32,
           sample_size=8, scaling_factor=0.3611, shift_factor=0.1159, use_quant_conv=False,
           use_post_quant_conv=False)
CLIP = dict(vocab_size=1000, hidden_size=128, intermediate_size=256, num_hidden_layers=1, num_attention_heads=2,
            max_position_embeddings=77, projection_dim=128)
T5 = dict(vocab_size=1000, d_model=128, d_kv=32, d_ff=256, num_layers=2, num_heads=4, feed_forward_proj="gated-gelu")
FLOW_MATCH = dict(use_dynamic_shifting=True, base_shift=0.5, max_shift=1.15, shift=3.0)
TXT_LEN = 8


class CRCTokenizer:
    """Deterministic tokenizer stand-in: BOS, ids from a CRC of the prompt,
    EOS (the highest id, where CLIP pools), padding to `max_length`."""

    model_max_length = 77

    def __call__(self, prompts, padding=None, max_length=77, truncation=True, return_tensors="np"):
        class Out:
            pass

        ids = []
        for p in prompts:
            h = zlib.crc32(p.encode("utf-8"))
            ids.append(([998] + [(h + i * 31) % 900 + 2 for i in range(5)] + [999] + [0] * max_length)[:max_length])
        out = Out()
        out.input_ids = np.array(ids, dtype=np.int64)
        return out


def _pipelines():
    jax_parts, torch_parts = {}, {}
    for seed, (name, jcls, tcls, cfg) in enumerate([
        ("vae", JaxAutoencoderKL, AutoencoderKL, VAE),
        ("text_encoder", JaxCLIPTextModel, CLIPTextModel, CLIP),
        ("text_encoder_2", JaxT5EncoderModel, T5EncoderModel, T5),
    ]):
        jm, tm = jcls(**cfg), tcls(**cfg)
        jax_parts[name] = (jm, _carry(jm, tm, seed))
        torch_parts[name] = tm.eval()
    jm, tm = JaxFlux(**W8A8), FluxTransformer2DModel(**W8A8)
    tree = flux_tree(jm, seed=3, w8a8=True)
    load_jax_params(tm, tree)
    jax_parts["transformer"] = (jm, jax.tree_util.tree_map(jnp.asarray, tree))
    torch_parts["transformer"] = tm.eval()
    jpipe = JaxFluxPipeline(scheduler=JaxFlowMatch(**FLOW_MATCH), tokenizer=CRCTokenizer(),
                            tokenizer_2=CRCTokenizer(), **jax_parts)
    tpipe = FluxPipeline(scheduler=FlowMatchEulerDiscreteScheduler(**FLOW_MATCH), tokenizer=CRCTokenizer(),
                         tokenizer_2=CRCTokenizer(), device="cpu", **torch_parts)
    return jpipe, tpipe


def test_flux_pipeline_matches_jax():
    jpipe, tpipe = _pipelines()
    latents = np.random.RandomState(0).randn(1, 16, 16).astype(np.float32)  # packed 8x8x4 latents
    kwargs = dict(height=8, width=8, num_inference_steps=2, guidance_scale=3.5, max_sequence_length=TXT_LEN,
                  output_type="np")
    ref = np.asarray(jpipe("a photo of an astronaut", latents=jnp.asarray(latents), **kwargs).images)
    flash_attention_full.launches = group_norm.launches = w8a8_matmul_2d.launches = 0
    out = tpipe("a photo of an astronaut", latents=torch.from_numpy(latents), **kwargs).images
    # CPU tensors took the plain versions of every kernel
    assert flash_attention_full.launches == group_norm.launches == w8a8_matmul_2d.launches == 0
    assert out.shape == (1, 8, 8, 3) and out.dtype == np.float32 and np.isfinite(out).all()
    assert float(np.abs(out - ref).max()) <= IMAGE_ATOL, float(np.abs(out - ref).max())


def test_flux_pipeline_outputs():
    _, tpipe = _pipelines()
    kwargs = dict(height=8, width=8, num_inference_steps=2, max_sequence_length=TXT_LEN)
    latents = tpipe("a cat", generator=torch.Generator().manual_seed(0), output_type="latent", **kwargs).images
    assert latents.shape == (1, 16, 16) and latents.dtype == torch.float32 and torch.isfinite(latents).all()
    again = tpipe("a cat", generator=torch.Generator().manual_seed(0), output_type="latent", **kwargs).images
    torch.testing.assert_close(latents, again, rtol=0, atol=0)
    images = tpipe("a cat", generator=torch.Generator().manual_seed(0), output_type="pil", **kwargs).images
    assert len(images) == 1 and np.asarray(images[0]).shape == (8, 8, 3) and np.asarray(images[0]).dtype == np.uint8


@pytest.mark.parametrize("pipeline", ["flux", "sdxl"])
def test_pipelines_default_to_the_card_and_raise_without_one(pipeline, monkeypatch):
    """Built without `device`, a pipeline goes to "cuda"; with no card visible
    it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vae = AutoencoderKL(**VAE)
    if pipeline == "flux":
        build = lambda **kw: FluxPipeline(  # noqa: E731
            scheduler=FlowMatchEulerDiscreteScheduler(**FLOW_MATCH), vae=vae, text_encoder=None, tokenizer=None,
            text_encoder_2=None, tokenizer_2=None, transformer=None, **kw)
    else:
        build = lambda **kw: StableDiffusionXLPipeline(  # noqa: E731
            vae=vae, text_encoder=None, text_encoder_2=None, tokenizer=None, tokenizer_2=None,
            unet=UNet2DConditionModel(**UNET), scheduler=EulerDiscreteScheduler(), **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
    assert build(device="cpu").vae.device.type == "cpu"

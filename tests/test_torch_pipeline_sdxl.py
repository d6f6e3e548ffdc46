"""The port's SDXL text-to-image pipeline against the JAX one, end to end on
the CPU.

The tiny components of tests/test_pipeline_sdxl.py are built in the port from
a seed, their parameters carried into JAX with `convert_torch_state_dict`
(`test_torch_models.carry_params`), the pipelines built once a module, both get
the same numpy latents and a deterministic tokenizer, and the
`output_type="np"` images are compared. Tolerance: max-abs `1e-3` on the
[0, 1] image: float32 on both sides, differences are summation order only,
carried through CLIP, the denoise loop and the VAE.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.models.autoencoders.autoencoder_kl import AutoencoderKL as JaxAutoencoderKL
from diffusers_tpu.models.text_encoders.clip import CLIPTextModel as JaxCLIPTextModel
from diffusers_tpu.models.text_encoders.clip import CLIPTextModelWithProjection as JaxCLIPTextModelWithProjection
from diffusers_tpu.models.unets.unet_2d_condition import UNet2DConditionModel as JaxUNet2DConditionModel
from diffusers_tpu.pipelines.stable_diffusion_xl.pipeline_stable_diffusion_xl import (
    StableDiffusionXLPipeline as JaxStableDiffusionXLPipeline,
)
from diffusers_tpu.schedulers import EulerDiscreteScheduler as JaxEulerDiscreteScheduler
from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel, CLIPTextModelWithProjection
from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention_full
from diffusers_tpu_torch.ops.cuda.group_norm import group_norm
from diffusers_tpu_torch.pipelines.stable_diffusion_xl.pipeline_stable_diffusion_xl import StableDiffusionXLPipeline
from diffusers_tpu_torch.schedulers import EulerDiscreteScheduler
from test_torch_models import carry_params

torch.set_num_threads(1)

IMAGE_ATOL = 1e-3

# the tiny components of tests/test_pipeline_sdxl.py
UNET = dict(
    sample_size=8, in_channels=4, out_channels=4,
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"), up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
    block_out_channels=(8, 16), layers_per_block=1, attention_head_dim=(2, 4), transformer_layers_per_block=(1, 2),
    use_linear_projection=True, cross_attention_dim=32, addition_embed_type="text_time", addition_time_embed_dim=8,
    projection_class_embeddings_input_dim=16 + 6 * 8, norm_num_groups=4,
)
VAE = dict(in_channels=3, out_channels=3, block_out_channels=(8,), down_block_types=("DownEncoderBlock2D",),
           up_block_types=("UpDecoderBlock2D",), latent_channels=4, layers_per_block=1, norm_num_groups=4,
           sample_size=16)
CLIP = dict(vocab_size=1000, hidden_size=16, intermediate_size=32, num_hidden_layers=2, num_attention_heads=2,
            max_position_embeddings=77, projection_dim=16)
EULER = dict(beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear", timestep_spacing="leading",
             steps_offset=1)


class CRCTokenizer:
    """Deterministic tokenizer stand-in: BOS, 6 ids from a CRC of the prompt,
    EOS (the highest id, where CLIP pools), padding."""

    model_max_length = 77

    def __call__(self, prompts, padding=None, max_length=77, truncation=True, return_tensors="np"):
        class Out:
            pass

        ids = []
        for p in prompts:
            h = zlib.crc32(p.encode("utf-8"))
            ids.append([998] + [(h + i * 31) % 900 + 2 for i in range(6)] + [999] + [0] * (max_length - 8))
        out = Out()
        out.input_ids = np.array(ids, dtype=np.int64)
        return out


def _carry(jax_model, torch_model, seed):
    """The port's weights from `seed`, 1-D ones jittered, carried into JAX
    (`test_torch_models.carry_params`: JAX's eager `init` of these tiny
    components takes tens of seconds on a CPU); returns the JAX params."""
    return carry_params(jax_model, torch_model, seed)


def _pipelines():
    jax_parts, torch_parts = {}, {}
    for seed, (name, jcls, tcls, cfg) in enumerate([
        ("unet", JaxUNet2DConditionModel, UNet2DConditionModel, UNET),
        ("vae", JaxAutoencoderKL, AutoencoderKL, VAE),
        ("text_encoder", JaxCLIPTextModel, CLIPTextModel, CLIP),
        ("text_encoder_2", JaxCLIPTextModelWithProjection, CLIPTextModelWithProjection, CLIP),
    ]):
        jm, tm = jcls(**cfg), tcls(**cfg)
        jax_parts[name] = (jm, _carry(jm, tm, seed))
        torch_parts[name] = tm.eval()
    jpipe = JaxStableDiffusionXLPipeline(
        tokenizer=CRCTokenizer(), tokenizer_2=CRCTokenizer(), scheduler=JaxEulerDiscreteScheduler(**EULER),
        **jax_parts,
    )
    tpipe = StableDiffusionXLPipeline(
        tokenizer=CRCTokenizer(), tokenizer_2=CRCTokenizer(), scheduler=EulerDiscreteScheduler(**EULER),
        device="cpu", **torch_parts,
    )
    return jpipe, tpipe


@pytest.mark.parametrize("negative_prompt", [None, "ugly, blurry"], ids=["zero-negative", "negative-prompt"])
def test_sdxl_pipeline_matches_jax(negative_prompt):
    flash_attention_full.launches = group_norm.launches = 0
    jpipe, tpipe = _pipelines()
    latents = np.random.RandomState(0).randn(1, 4, 8, 8).astype(np.float32)
    kwargs = dict(num_inference_steps=4, guidance_scale=5.0, negative_prompt=negative_prompt, output_type="np")
    ref = jpipe("a photo of an astronaut", latents=jnp.asarray(latents), **kwargs).images
    out = tpipe("a photo of an astronaut", latents=torch.from_numpy(latents), **kwargs).images
    assert out.shape == (1, 8, 8, 3) and out.dtype == np.float32
    assert np.isfinite(out).all()
    assert np.max(np.abs(out - np.asarray(ref))) <= IMAGE_ATOL
    # CPU tensors took the plain versions of both kernels
    assert flash_attention_full.launches == 0 and group_norm.launches == 0


def test_sdxl_pipeline_outputs():
    _, tpipe = _pipelines()
    gen = torch.Generator().manual_seed(0)
    latents = tpipe("a cat", num_inference_steps=2, generator=gen, output_type="latent").images
    assert latents.shape == (1, 4, 8, 8) and torch.isfinite(latents).all()
    images = tpipe("a cat", num_inference_steps=2, generator=torch.Generator().manual_seed(0),
                   output_type="pil").images
    assert len(images) == 1 and np.asarray(images[0]).shape == (8, 8, 3) and np.asarray(images[0]).dtype == np.uint8
    # the same generator seed gives the same image; no CFG when guidance_scale <= 1
    again = tpipe("a cat", num_inference_steps=2, generator=torch.Generator().manual_seed(0),
                  output_type="pil").images
    np.testing.assert_array_equal(np.asarray(images[0]), np.asarray(again[0]))
    no_cfg = tpipe("a cat", num_inference_steps=2, guidance_scale=1.0, generator=torch.Generator().manual_seed(0),
                   output_type="np").images
    assert no_cfg.shape == (1, 8, 8, 3) and np.isfinite(no_cfg).all()

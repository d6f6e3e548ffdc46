"""The port's InstructPix2Pix pipelines (SD 1.x and SDXL) against the JAX
ones, end to end on the CPU.

The tiny SD components of tests/test_torch_stable_diffusion.py and the tiny
SDXL components of tests/test_torch_pipeline_img2img.py, with 8-channel
UNets, the port's seeded weights carried into JAX with
`convert_torch_state_dict`. With latents given the path draws nothing (the
image latents are the VAE posterior's mode), so each `__call__` is held to
JAX's whole: triple CFG ([text, image, uncond]), and the path without
guidance (``g_img < 1`` turns it off, as JAX's gate).

Tolerance: max-abs `5e-4` on the [0, 1] image (SD's limit, README
"Numerical parity") and `1e-3` on SDXL's (the SDXL image pipelines'),
float32 on both sides, so the differences are summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.pipelines.stable_diffusion.pipeline_stable_diffusion_instruct_pix2pix import (
    StableDiffusionInstructPix2PixPipeline as JaxSDInstructPix2Pix,
)
from diffusers_tpu.pipelines.stable_diffusion_xl.pipeline_stable_diffusion_xl_instruct_pix2pix import (
    StableDiffusionXLInstructPix2PixPipeline as JaxSDXLInstructPix2Pix,
)
from diffusers_tpu_torch import StableDiffusionInstructPix2PixPipeline, StableDiffusionXLInstructPix2PixPipeline
from diffusers_tpu_torch.pipelines.stable_diffusion.pipeline_stable_diffusion_instruct_pix2pix import (
    instruct_pix2pix_guidance,
)
from test_torch_pipeline_img2img import ATOL as SDXL_ATOL
from test_torch_pipeline_img2img import IMAGE
from test_torch_pipeline_img2img import _pipelines as sdxl_pipelines
from test_torch_stable_diffusion import IMAGE_ATOL, LATENTS, sd_pipelines

torch.set_num_threads(1)

PROMPT = "turn the barn into a lighthouse"


def _max_diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


@pytest.fixture(scope="module")
def sd():
    return sd_pipelines(JaxSDInstructPix2Pix, StableDiffusionInstructPix2PixPipeline, scheduler="ddim", in_channels=8)


@pytest.fixture(scope="module")
def sdxl():
    return sdxl_pipelines(JaxSDXLInstructPix2Pix, StableDiffusionXLInstructPix2PixPipeline, in_channels=8)


@pytest.mark.parametrize("guidance, image_guidance, negative", [(7.5, 1.5, None), (7.5, 0.5, None),
                                                                (6.0, 1.2, "blurry")],
                         ids=["triple-cfg", "no-cfg", "negative"])
def test_sd_instruct_pix2pix_matches_jax(sd, guidance, image_guidance, negative):
    jpipe, tpipe = sd
    kwargs = dict(image=IMAGE, num_inference_steps=3, guidance_scale=guidance, image_guidance_scale=image_guidance,
                  negative_prompt=negative, output_type="np")
    ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), **kwargs).images)
    out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).images
    assert out.shape == (1, 8, 8, 3) and np.isfinite(out).all()
    assert _max_diff(out, ref) <= IMAGE_ATOL


@pytest.mark.parametrize("guidance, image_guidance", [(5.0, 1.5), (1.0, 1.5)], ids=["triple-cfg", "no-cfg"])
def test_sdxl_instruct_pix2pix_matches_jax(sdxl, guidance, image_guidance):
    jpipe, tpipe = sdxl
    kwargs = dict(image=IMAGE, num_inference_steps=3, guidance_scale=guidance, image_guidance_scale=image_guidance,
                  output_type="np")
    ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), **kwargs).images)
    out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).images
    assert out.shape == (1, 8, 8, 3) and np.isfinite(out).all()
    assert _max_diff(out, ref) <= SDXL_ATOL


def test_triple_guidance_rule_and_batch_layout(sd):
    """``uncond + g (text - image) + g_img (image - uncond)`` of a [text,
    image, uncond] batch, and the embeddings laid out [prompt, negative,
    negative] under guidance."""
    pred = torch.arange(3 * 4, dtype=torch.float32).reshape(3, 4) ** 1.5
    text, image, uncond = pred
    torch.testing.assert_close(instruct_pix2pix_guidance(pred, 7.5, 1.5)[0],
                               uncond + 7.5 * (text - image) + 1.5 * (image - uncond), rtol=0, atol=0)
    _, tpipe = sd
    embeds = tpipe.encode_prompt_ip2p(PROMPT, "blurry", True)
    negative, text_embeds = tpipe.encode_prompt(PROMPT, "blurry", True).chunk(2)
    assert torch.equal(embeds, torch.cat([text_embeds, negative, negative]))
    assert torch.equal(tpipe.encode_prompt_ip2p(PROMPT, None, False), tpipe.encode_prompt(PROMPT, None, False))

"""The port's SDXL PAG pipelines against the JAX package on the CPU.

`StableDiffusionXLPAG{,Img2Img,Inpaint}Pipeline`'s whole `__call__` against
JAX's on `test_torch_pipeline_img2img`'s tiny SDXL components, the port's
seeded weights carried into JAX with `convert_torch_state_dict`, both fed
the same latents or JAX's random draws. A window narrower than the loop
(`pag_start` / `pag_stop`) holds the skipped perturbed forward on closed
steps to JAX's multiply-by-0 (ROADMAP C3); the inpaint pipeline runs an
inpainting (9-channel) UNet (the 4-channel blend of the port's base
pipelines is upstream's rule, not JAX's: ROADMAP C4). Also: `from_pipe` of
the base pipeline, and the image PAG moves. Tolerance 5e-4 on the [0, 1]
image (the SDXL pipelines' own).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.pipelines import pag as jpag
from diffusers_tpu.schedulers import EulerDiscreteScheduler as JaxEulerDiscreteScheduler
import diffusers_tpu_torch
from diffusers_tpu_torch.pipelines import pag
from diffusers_tpu_torch.pipelines.stable_diffusion_xl import StableDiffusionXLPipeline
from diffusers_tpu_torch.schedulers import EulerDiscreteScheduler
from test_torch_pag import IMAGE_ATOL, LATENTS, PROMPT, _max_diff, _sdxl_parts, jit_vae
from test_torch_pipeline_img2img import IMAGE, MASK, SEED, draws  # noqa: F401 (draws: a fixture)
from test_torch_pipeline_sdxl import EULER, CRCTokenizer
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sdxl_components():
    def build(in_channels):
        jax_parts, torch_parts = _sdxl_parts(in_channels, seed=40 + in_channels)
        tok = dict(tokenizer=CRCTokenizer(), tokenizer_2=CRCTokenizer())
        return (dict(tok, scheduler=JaxEulerDiscreteScheduler(**EULER), **jax_parts),
                dict(tok, scheduler=EulerDiscreteScheduler(**EULER), **torch_parts))

    return {4: build(4), 9: build(9)}


SDXL_CASES = {
    "text2image": (jpag.StableDiffusionXLPAGPipeline, pag.StableDiffusionXLPAGPipeline, 4,
                   dict(pag_start=0.2, pag_stop=0.7, num_inference_steps=5)),
    "img2img": (jpag.StableDiffusionXLPAGImg2ImgPipeline, pag.StableDiffusionXLPAGImg2ImgPipeline, 4,
                dict(image=IMAGE, strength=0.8, num_inference_steps=4, pag_applied_layers=["down_blocks.1", "up"])),
    "inpaint_9ch": (jpag.StableDiffusionXLPAGInpaintPipeline, pag.StableDiffusionXLPAGInpaintPipeline, 9,
                    dict(image=IMAGE, mask_image=MASK, num_inference_steps=3, pag_stop=0.5)),
}


@pytest.mark.parametrize("kind", list(SDXL_CASES))
def test_sdxl_pag_pipelines_match_jax(sdxl_components, draws, kind):  # noqa: F811
    jcls, tcls, channels, kwargs = SDXL_CASES[kind]
    jcomp, tcomp = sdxl_components[channels]
    jpipe, tpipe = jit_vae(jcls(**jcomp)), tcls(device="cpu", **tcomp)
    kwargs = dict(guidance_scale=5.0, pag_scale=2.5, output_type="np", **kwargs)
    if kind == "text2image":
        ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), **kwargs).images)
        out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).images
    else:
        ref = np.asarray(jpipe(PROMPT, key=jax.random.PRNGKey(SEED), **kwargs).images)
        out = tpipe(PROMPT, **kwargs).images
        assert not draws  # the port drew the encoder's sample, then the noise
    assert out.shape == (1, 8, 8, 3) and np.isfinite(out).all()
    assert _max_diff(out, ref) <= IMAGE_ATOL
    if kind == "text2image":  # PAG moved the image, and from_pipe of the base pipeline builds the PAG one
        base = StableDiffusionXLPipeline(device="cpu", **tcomp)
        plain = base(PROMPT, latents=torch.from_numpy(LATENTS), num_inference_steps=5, guidance_scale=5.0,
                     output_type="np").images
        assert _max_diff(out, plain) > 1e-3
        sibling = pag.StableDiffusionXLPAGPipeline.from_pipe(base)
        assert sibling.unet is base.unet and isinstance(sibling, StableDiffusionXLPipeline)
        np.testing.assert_array_equal(sibling(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).images, out)
        assert diffusers_tpu_torch.StableDiffusionXLPAGPipeline is pag.StableDiffusionXLPAGPipeline
        assert tpipe._pag is None  # cleared after the call

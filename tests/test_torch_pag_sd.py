"""The port's Stable Diffusion PAG pipelines against the JAX package on the CPU.

`StableDiffusionPAG{,Img2Img,Inpaint}Pipeline`'s whole `__call__` against
JAX's on the tiny SD 1.5-shaped components of `test_torch_stable_diffusion`
(PNDM, so text-to-image runs one UNet step more than it counts), the port's
seeded weights carried into JAX with `convert_torch_state_dict`, both fed
the same latents or JAX's random draws. The inpaint pipeline runs an
inpainting (9-channel) UNet (the 4-channel blend is upstream's rule,
ROADMAP C4). Also: the package's twelve PAG exports, their cache refusal
(C3) and a pattern that matches no layer. Tolerance 5e-4 on the [0, 1]
image (the SD pipelines' own).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.pipelines import pag as jpag
from diffusers_tpu.schedulers.scheduling_pndm import PNDMScheduler as JaxPNDM
import diffusers_tpu_torch
from diffusers_tpu_torch.pipelines import pag
from diffusers_tpu_torch.schedulers import PNDMScheduler
from test_torch_pag import IMAGE_ATOL, LATENTS, PROMPT, _max_diff, jit_vae
from test_torch_pipeline_img2img import IMAGE, MASK, SEED, draws  # noqa: F401 (draws: a fixture)
from test_torch_pipeline_sdxl import CRCTokenizer
from test_torch_stable_diffusion import PNDM, sd_parts
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sd_components():
    def build(in_channels):
        jax_parts, torch_parts = sd_parts(in_channels, seed=50 + in_channels)
        return (dict(tokenizer=CRCTokenizer(), scheduler=JaxPNDM(**PNDM), **jax_parts),
                dict(tokenizer=CRCTokenizer(), scheduler=PNDMScheduler(**PNDM), **torch_parts))

    return {4: build(4), 9: build(9)}


SD_CASES = {
    "text2image": (jpag.StableDiffusionPAGPipeline, pag.StableDiffusionPAGPipeline, 4,
                   dict(num_inference_steps=4)),
    "img2img": (jpag.StableDiffusionPAGImg2ImgPipeline, pag.StableDiffusionPAGImg2ImgPipeline, 4,
                dict(image=IMAGE, strength=0.75, num_inference_steps=4, pag_start=0.3)),
    "inpaint_9ch": (jpag.StableDiffusionPAGInpaintPipeline, pag.StableDiffusionPAGInpaintPipeline, 9,
                    dict(image=IMAGE, mask_image=MASK, num_inference_steps=3, pag_applied_layers="attn1")),
}


@pytest.mark.parametrize("kind", list(SD_CASES))
def test_sd_pag_pipelines_match_jax(sd_components, draws, kind):  # noqa: F811
    """PNDM: text-to-image runs 5 UNet steps for 4 steps and counts them
    against 4, so its last step runs without the perturbed forward, as JAX's
    gate has it."""
    jcls, tcls, channels, case = SD_CASES[kind]
    jcomp, tcomp = sd_components[channels]
    jpipe, tpipe = jit_vae(jcls(**jcomp)), tcls(device="cpu", **tcomp)
    kwargs = dict(dict(guidance_scale=7.5, pag_scale=3.0, output_type="np", pag_applied_layers="down_blocks.0"),
                  **case)
    calls = []
    hook = tpipe.unet.register_forward_hook(lambda m, a, o: calls.append(a[0].shape[0]))
    try:
        if kind == "text2image":
            ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), **kwargs).images)
            out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).images
        else:
            ref = np.asarray(jpipe(PROMPT, key=jax.random.PRNGKey(SEED), **kwargs).images)
            out = tpipe(PROMPT, **kwargs).images
            assert not draws
    finally:
        hook.remove()
    assert out.shape == (1, 8, 8, 3) and np.isfinite(out).all()
    assert _max_diff(out, ref) <= IMAGE_ATOL
    if kind == "text2image":  # 5 CFG calls, then the perturbed call on steps 0-3 only
        assert calls == [2, 1, 2, 1, 2, 1, 2, 1, 2]


def test_pag_pipeline_names_and_refusals(sd_components):
    """Every PAG pipeline is exported from the package root, takes no cache
    config (C3), and refuses layers that match nothing."""
    names = [n for n in dir(pag) if n.endswith("Pipeline")]
    assert len(names) == 12 and all(getattr(diffusers_tpu_torch, n) is getattr(pag, n) for n in names)
    assert all(getattr(pag, n)._supported_cache_configs == () for n in names)
    _, tcomp = sd_components[4]
    tpipe = pag.StableDiffusionPAGPipeline(device="cpu", **tcomp)
    with pytest.raises(ValueError, match="no self-attention layers matched"):
        tpipe(PROMPT, num_inference_steps=1, pag_applied_layers="single_transformer_blocks")
    assert tpipe._pag is None



def test_pag_inpaint_4_channel_takes_the_base_rule(sd_components):
    """A 4-channel UNet: the PAG inpaint pipeline blends the known region as
    the port's base inpaint pipeline does (upstream's rule; JAX's PAG
    inpaint keeps JAX's, ROADMAP C4): at pag_scale 0 the two agree bit for
    bit, and the known region comes back as the clean init latents."""
    from diffusers_tpu_torch.pipelines.stable_diffusion import StableDiffusionInpaintPipeline

    _, tcomp = sd_components[4]
    kwargs = dict(image=IMAGE, mask_image=MASK, num_inference_steps=3, guidance_scale=7.5, output_type="latent")
    base = StableDiffusionInpaintPipeline(device="cpu", **tcomp)(
        PROMPT, generator=torch.Generator().manual_seed(0), **kwargs).images
    pipe = pag.StableDiffusionPAGInpaintPipeline(device="cpu", **tcomp)
    off = pipe(PROMPT, generator=torch.Generator().manual_seed(0), pag_scale=0.0, **kwargs).images
    on = pipe(PROMPT, generator=torch.Generator().manual_seed(0), **kwargs).images
    torch.testing.assert_close(off, base, rtol=0, atol=0)
    known = torch.from_numpy(np.broadcast_to(MASK <= 0.5, on.shape).copy())
    torch.testing.assert_close(on[known], base[known], rtol=0, atol=0)  # the clean init latents, in both
    assert float((on - base).abs().max()) > 1e-3  # PAG moved the repainted region

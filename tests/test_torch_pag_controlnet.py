"""The port's SD ControlNet PAG pipelines against the JAX package on the CPU.

`StableDiffusionControlNetPAG{,Inpaint}Pipeline`'s whole `__call__` against
JAX's on `test_torch_controlnet_sd`'s tiny SD components and ControlNet
(PNDM), the port's seeded weights carried into JAX with
`convert_torch_state_dict`, both fed the same latents or JAX's random
draws. The perturbed UNet call takes the conditional half of the
ControlNet's residuals where JAX runs the ControlNet again at batch 1 (the
same numbers); the inpaint loop blends at the next timestep's noise level,
JAX's ControlNet rule. Tolerance 5e-4 on the [0, 1] image (the SD
ControlNet pipelines' own).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.models.controlnets.controlnet import ControlNetModel as JaxControlNetModel
from diffusers_tpu.pipelines import pag as jpag
from diffusers_tpu.schedulers.scheduling_pndm import PNDMScheduler as JaxPNDM
import diffusers_tpu_torch
from diffusers_tpu_torch.pipelines import pag
from diffusers_tpu_torch.pipelines.pipeline_utils import DiffusionPipeline
from diffusers_tpu_torch.schedulers import PNDMScheduler
from test_torch_controlnet_sd import CN_SD, EDGES, seeded_controlnet, to_jax
from test_torch_pag import IMAGE_ATOL, LATENTS, PROMPT, _max_diff, jit_vae
from test_torch_pipeline_img2img import IMAGE, MASK, SEED, draws  # noqa: F401 (draws: a fixture)
from test_torch_pipeline_sdxl import CRCTokenizer
from test_torch_stable_diffusion import PNDM, sd_parts
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def components():
    """(JAX components, port components) with one seeded ControlNet."""
    jax_parts, torch_parts = sd_parts(seed=60)
    net = seeded_controlnet(seed=61)
    jnet = JaxControlNetModel(**CN_SD)
    return (dict(tokenizer=CRCTokenizer(), scheduler=JaxPNDM(**PNDM), controlnet=(jnet, to_jax(jnet, net)),
                 **jax_parts),
            dict(tokenizer=CRCTokenizer(), scheduler=PNDMScheduler(**PNDM), controlnet=net, **torch_parts))


CASES = {
    "text2image": (jpag.StableDiffusionControlNetPAGPipeline, pag.StableDiffusionControlNetPAGPipeline,
                   dict(image=EDGES, height=8, width=8, num_inference_steps=3, guidance_scale=7.5,
                        controlnet_conditioning_scale=0.8)),
    "inpaint": (jpag.StableDiffusionControlNetPAGInpaintPipeline, pag.StableDiffusionControlNetPAGInpaintPipeline,
                dict(image=IMAGE, mask_image=MASK, control_image=EDGES, num_inference_steps=3, guidance_scale=7.5,
                     pag_stop=0.5)),
}


@pytest.mark.parametrize("kind", list(CASES))
def test_sd_controlnet_pag_pipelines_match_jax(components, draws, kind):  # noqa: F811
    jcls, tcls, kwargs = CASES[kind]
    jpipe, tpipe = jit_vae(jcls(**components[0])), tcls(device="cpu", **components[1])
    kwargs = dict(pag_scale=2.0, output_type="np", **kwargs)
    if kind == "text2image":
        ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), **kwargs).images)
        out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).images
    else:
        ref = np.asarray(jpipe(PROMPT, key=jax.random.PRNGKey(SEED), **kwargs).images)
        out = tpipe(PROMPT, **kwargs).images
        assert not draws  # the port drew the encoder's sample, then the noise
    assert out.shape == ref.shape == (1, 8, 8, 3) and np.isfinite(out).all()
    assert _max_diff(out, ref) <= IMAGE_ATOL
    assert getattr(diffusers_tpu_torch, tcls.__name__) is tcls and issubclass(tcls, DiffusionPipeline)

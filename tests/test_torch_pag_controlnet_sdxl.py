"""The port's SDXL ControlNet PAG pipelines against the JAX package on the CPU.

`StableDiffusionXLControlNetPAG{,Img2Img}Pipeline`'s whole `__call__`
against JAX's on the tiny SDXL components with `test_torch_controlnet`'s
SDXL ControlNet (Euler), the port's seeded weights carried into JAX with
`convert_torch_state_dict`, both fed the same latents or JAX's random
draws. The perturbed UNet call takes the conditional half of the
ControlNet's residuals and of the micro-conditioning where JAX runs the
ControlNet again at batch 1 (the same numbers). Tolerance 5e-4 on the
[0, 1] image (the SDXL ControlNet pipelines' own).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.models.controlnets.controlnet import ControlNetModel as JaxControlNetModel
from diffusers_tpu.pipelines import pag as jpag
from diffusers_tpu.schedulers import EulerDiscreteScheduler as JaxEulerDiscreteScheduler
import diffusers_tpu_torch
from diffusers_tpu_torch.models.controlnets import ControlNetModel
from diffusers_tpu_torch.pipelines import pag
from diffusers_tpu_torch.pipelines.pipeline_utils import DiffusionPipeline
from diffusers_tpu_torch.schedulers import EulerDiscreteScheduler
from test_torch_controlnet import CN
from test_torch_controlnet_sd import EDGES, seeded_controlnet, to_jax
from test_torch_pag import IMAGE_ATOL, LATENTS, PROMPT, _max_diff, _sdxl_parts, jit_vae
from test_torch_pipeline_img2img import IMAGE, SEED, draws  # noqa: F401 (draws: a fixture)
from test_torch_pipeline_sdxl import EULER, CRCTokenizer
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def components():
    """(JAX components, port components) with one seeded SDXL ControlNet."""
    jax_parts, torch_parts = _sdxl_parts(4, seed=62)
    net = seeded_controlnet(ControlNetModel, CN, seed=63)
    jnet = JaxControlNetModel(**CN)
    tok = dict(tokenizer=CRCTokenizer(), tokenizer_2=CRCTokenizer())
    return (dict(tok, scheduler=JaxEulerDiscreteScheduler(**EULER), controlnet=(jnet, to_jax(jnet, net)),
                 **jax_parts),
            dict(tok, scheduler=EulerDiscreteScheduler(**EULER), controlnet=net, **torch_parts))


CASES = {
    "text2image": (jpag.StableDiffusionXLControlNetPAGPipeline, pag.StableDiffusionXLControlNetPAGPipeline,
                   dict(image=EDGES, height=8, width=8, num_inference_steps=3, guidance_scale=5.0,
                        controlnet_conditioning_scale=0.7, pag_applied_layers=["mid", "up_blocks.0"])),
    "img2img": (jpag.StableDiffusionXLControlNetPAGImg2ImgPipeline, pag.StableDiffusionXLControlNetPAGImg2ImgPipeline,
                dict(image=IMAGE, control_image=EDGES, strength=0.7, num_inference_steps=4, guidance_scale=5.0,
                     controlnet_conditioning_scale=0.8)),
}


@pytest.mark.parametrize("kind", list(CASES))
def test_sdxl_controlnet_pag_pipelines_match_jax(components, draws, kind):  # noqa: F811
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

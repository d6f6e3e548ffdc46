"""The port's SD3 PAG pipelines against the JAX package on the CPU.

`StableDiffusion3PAG{,Img2Img}Pipeline`'s whole `__call__` against JAX's on
`test_torch_pipeline_sd3`'s tiny SD3.5-style components (a dual-attention
block, qk RMSNorm, T5), the port's seeded weights carried into JAX with
`convert_torch_state_dict`, both fed the same latents or JAX's random
draws, and their cache refusal (ROADMAP C3). The perturbed forward masks
block 0's image-to-image joint attention to the identity. Tolerance 2e-3 on
the [0, 1] image (the SD3 pipelines' own).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.pipelines import pag as jpag
from diffusers_tpu_torch.pipelines import pag
from test_torch_pag import PROMPT, RNG, SD3_ATOL, _max_diff
from test_torch_pipeline_img2img import IMAGE, draws  # noqa: F401 (draws: a fixture)
from test_torch_pipeline_sd3 import build as sd3_build
from test_torch_pipeline_sd3 import TXT_LEN
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["text2image", "img2img"])
def test_sd3_pag_pipelines_match_jax(draws, kind):  # noqa: F811
    jcls, tcls = ((jpag.StableDiffusion3PAGPipeline, pag.StableDiffusion3PAGPipeline) if kind == "text2image" else
                  (jpag.StableDiffusion3PAGImg2ImgPipeline, pag.StableDiffusion3PAGImg2ImgPipeline))
    jpipe, tpipe = sd3_build(jcls=jcls, tcls=tcls, seed=3)
    kwargs = dict(num_inference_steps=4, guidance_scale=5.0, pag_scale=2.0, max_sequence_length=TXT_LEN,
                  pag_applied_layers=r"transformer_blocks\.0", output_type="np")
    if kind == "text2image":
        latents = RNG.randn(1, 4, 8, 8).astype(np.float32)
        ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(latents), **kwargs).images)
        out = tpipe(PROMPT, latents=torch.from_numpy(latents), **kwargs).images
    else:
        kwargs.update(image=IMAGE, strength=0.7, pag_stop=0.6)
        ref = np.asarray(jpipe(PROMPT, key=jax.random.PRNGKey(3), **kwargs).images)
        out = tpipe(PROMPT, **kwargs).images
        assert not draws
    assert out.shape == (1, 8, 8, 3) and np.isfinite(out).all()
    assert _max_diff(out, ref) <= SD3_ATOL
    assert tpipe._default_pag_applied_layers == r"transformer_blocks\.13"
    from diffusers_tpu_torch.hooks import TaylorSeerCacheConfig, TextKVCacheConfig

    for config in (TaylorSeerCacheConfig(), TextKVCacheConfig()):  # JAX's PAG loop reads no cache config (C3)
        with pytest.raises(TypeError, match="does not support cache config"):
            tpipe.enable_cache(config)

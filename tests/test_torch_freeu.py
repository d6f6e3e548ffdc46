"""The port's FreeU against the JAX package on the CPU.

`fourier_filter` and `apply_freeu` on even, odd and 1-wide maps (the port
is NCHW, JAX NHWC); a small SD 1.5-shaped UNet (up block 0 an `UpBlock2D`,
then a cross-attention block) and a small SDXL-shaped one (two
cross-attention up blocks) with FreeU on, at an input whose deepest level is
odd (6 x 6: 3 x 3), against JAX's `enable_freeu`; `disable_freeu` giving the
plain output back bit for bit; and an SDXL pipeline's `enable_freeu`
against JAX's pipeline. Tolerances: the filter 2e-5 (float32 FFTs of two
libraries), a UNet 5e-4, a pipeline's [0, 1] image 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.models.unets.unet_2d_condition import UNet2DConditionModel as JaxUNet2DConditionModel
from diffusers_tpu.pipelines.stable_diffusion_xl.pipeline_stable_diffusion_xl import (
    StableDiffusionXLPipeline as JaxStableDiffusionXLPipeline,
)
from diffusers_tpu.schedulers import EulerDiscreteScheduler as JaxEulerDiscreteScheduler
from diffusers_tpu.utils import freeu_utils as jfreeu
from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
from diffusers_tpu_torch.pipelines.stable_diffusion_xl import StableDiffusionXLPipeline
from diffusers_tpu_torch.schedulers import EulerDiscreteScheduler
from diffusers_tpu_torch.utils import freeu_utils
from test_torch_pag import _sdxl_parts
from test_torch_pipeline_cache import _parts
from test_torch_pipeline_sdxl import EULER, UNET, CRCTokenizer
from test_torch_stable_diffusion import UNET_SD
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

FILTER_ATOL = 2e-5
MODEL_ATOL = 5e-4
IMAGE_ATOL = 5e-4
SD15_FREEU = dict(s1=0.9, s2=0.2, b1=1.2, b2=1.4)
SDXL_FREEU = dict(s1=0.6, s2=0.4, b1=1.1, b2=1.2)
RNG = np.random.RandomState(9)


def _to_nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def _to_nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


@pytest.mark.parametrize("h,w,threshold,scale", [(8, 8, 1, 0.6), (7, 5, 1, 0.2), (3, 3, 2, 0.5), (1, 1, 1, 0.9),
                                                 (6, 4, 3, 1.3)])
def test_fourier_filter_matches_jax(h, w, threshold, scale):
    x = RNG.randn(2, 5, h, w).astype(np.float32)
    ref = _to_nchw(jfreeu.fourier_filter(_to_nhwc(x), threshold, scale))
    out = freeu_utils.fourier_filter(torch.from_numpy(x), threshold, scale)
    assert out.dtype == torch.float32 and np.max(np.abs(out.numpy() - ref)) <= FILTER_ATOL
    half = freeu_utils.fourier_filter(torch.from_numpy(x).to(torch.bfloat16), threshold, scale)
    assert half.dtype == torch.bfloat16  # the FFT runs in float32 and comes back in the input's dtype


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_apply_freeu_matches_jax(idx):
    hidden, skip = RNG.randn(2, 6, 5, 5).astype(np.float32), RNG.randn(2, 4, 5, 5).astype(np.float32)
    jh, js = jfreeu.apply_freeu(idx, _to_nhwc(hidden), _to_nhwc(skip), SDXL_FREEU)
    th, ts = freeu_utils.apply_freeu(idx, torch.from_numpy(hidden), torch.from_numpy(skip), SDXL_FREEU)
    assert np.max(np.abs(th.numpy() - _to_nchw(jh))) <= FILTER_ATOL
    assert np.max(np.abs(ts.numpy() - _to_nchw(js))) <= FILTER_ATOL
    if idx == 2:  # a block past the first two passes through
        np.testing.assert_array_equal(th.numpy(), hidden)
        np.testing.assert_array_equal(ts.numpy(), skip)


UNETS = {"sd15": (UNET_SD, SD15_FREEU, 16), "sdxl": (UNET, SDXL_FREEU, 32)}  # (config, factors, text width)


@pytest.mark.parametrize("name", list(UNETS))
def test_unet_with_freeu_matches_jax(name):
    config, factors, ctx_dim = UNETS[name]
    jax_parts, torch_parts = _parts([("unet", JaxUNet2DConditionModel, UNet2DConditionModel, config)], seed=70)
    (jm, params), unet = jax_parts["unet"], torch_parts["unet"]
    kinds = [type(b).__name__ for b in unet.up_blocks]
    assert kinds == (["UpBlock2D", "CrossAttnUpBlock2D"] if name == "sd15" else ["CrossAttnUpBlock2D", "UpBlock2D"])
    x = RNG.randn(2, 4, 6, 6).astype(np.float32)  # the deepest level is 3 x 3
    ehs = RNG.randn(2, 77, ctx_dim).astype(np.float32)
    added = None
    if name == "sdxl":  # the text_time embedding
        added = {"text_embeds": RNG.randn(2, 16).astype(np.float32),
                 "time_ids": np.array([[6, 6, 0, 0, 6, 6]] * 2, np.float32)}
    t = np.array([700.0, 30.0], np.float32)

    def jax_call():
        return jax.jit(lambda p, x, e, a: jm(p, x, jnp.asarray(t), encoder_hidden_states=e,
                                             added_cond_kwargs=a).sample)(
            params, jnp.asarray(x), jnp.asarray(ehs), None if added is None else jax.tree.map(jnp.asarray, added))

    def port_call():
        with torch.no_grad():
            a = None if added is None else {k: torch.from_numpy(v) for k, v in added.items()}
            return unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ehs), added_cond_kwargs=a).sample

    plain = port_call()
    jm.enable_freeu(**factors)
    unet.enable_freeu(**factors)
    assert [b.resolution_idx for b in unet.up_blocks] == [0, 1] and unet.up_blocks[0].freeu == factors
    ref, out = jax_call(), port_call()
    assert np.max(np.abs(out.numpy() - np.asarray(ref))) <= MODEL_ATOL
    assert np.max(np.abs(out.numpy() - plain.numpy())) > 1e-3  # FreeU moved the output
    unet.disable_freeu()
    jm.disable_freeu()
    assert all(b.freeu is None for b in unet.up_blocks)
    torch.testing.assert_close(port_call(), plain, rtol=0, atol=0)


def test_sdxl_pipeline_freeu_matches_jax():
    jax_parts, torch_parts = _sdxl_parts(4, seed=71)
    tok = dict(tokenizer=CRCTokenizer(), tokenizer_2=CRCTokenizer())
    jpipe = JaxStableDiffusionXLPipeline(scheduler=JaxEulerDiscreteScheduler(**EULER), **tok, **jax_parts)
    tpipe = StableDiffusionXLPipeline(scheduler=EulerDiscreteScheduler(**EULER), device="cpu", **tok, **torch_parts)
    latents = RNG.randn(1, 4, 8, 8).astype(np.float32)
    kwargs = dict(num_inference_steps=3, guidance_scale=5.0, output_type="np")
    plain = tpipe("a red fox", latents=torch.from_numpy(latents), **kwargs).images
    jpipe.enable_freeu(**SDXL_FREEU)
    tpipe.enable_freeu(**SDXL_FREEU)
    ref = np.asarray(jpipe("a red fox", latents=jnp.asarray(latents), **kwargs).images)
    out = tpipe("a red fox", latents=torch.from_numpy(latents), **kwargs).images
    assert out.shape == (1, 8, 8, 3) and np.max(np.abs(out - ref)) <= IMAGE_ATOL
    assert np.max(np.abs(out - plain)) > 1e-4
    tpipe.disable_freeu()
    np.testing.assert_array_equal(tpipe("a red fox", latents=torch.from_numpy(latents), **kwargs).images, plain)
    from diffusers_tpu_torch.pipelines.flux.pipeline_flux import FluxPipeline

    with pytest.raises(AttributeError, match="FreeU"):
        FluxPipeline.enable_freeu(object.__new__(FluxPipeline), **SDXL_FREEU)

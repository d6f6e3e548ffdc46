"""Stable Diffusion image-to-image with Perturbed-Attention Guidance.

Port of `diffusers_tpu/pipelines/pag/pipeline_pag_sd_img2img.py`:
`StableDiffusionImg2ImgPipeline` with the perturbed conditional forward of
`pag_utils.PAGMixin`, steps counted against the timesteps the strength keeps.
"""

from __future__ import annotations

from ..stable_diffusion.pipeline_stable_diffusion_img2img import StableDiffusionImg2ImgPipeline
from .pag_utils import PAGMixin


class StableDiffusionPAGImg2ImgPipeline(PAGMixin, StableDiffusionImg2ImgPipeline):
    pass

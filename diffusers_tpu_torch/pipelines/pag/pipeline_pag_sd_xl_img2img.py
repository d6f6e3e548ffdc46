"""SDXL image-to-image with Perturbed-Attention Guidance.

Port of `diffusers_tpu/pipelines/pag/pipeline_pag_sd_xl_img2img.py`:
`StableDiffusionXLImg2ImgPipeline` with the perturbed conditional forward of
`pag_utils.PAGMixin`, steps counted against the timesteps the strength keeps.
"""

from __future__ import annotations

from ..stable_diffusion_xl.pipeline_stable_diffusion_xl_img2img import StableDiffusionXLImg2ImgPipeline
from .pag_utils import PAGMixin


class StableDiffusionXLPAGImg2ImgPipeline(PAGMixin, StableDiffusionXLImg2ImgPipeline):
    pass

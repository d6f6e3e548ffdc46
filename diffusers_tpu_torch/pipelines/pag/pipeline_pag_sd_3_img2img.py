"""Stable Diffusion 3 image-to-image with Perturbed-Attention Guidance.

Port of `diffusers_tpu/pipelines/pag/pipeline_pag_sd_3_img2img.py`:
`StableDiffusion3Img2ImgPipeline` with the perturbed conditional forward of
`pag_utils.PAGMixin`, steps counted against the timesteps the strength keeps;
the default layers are ``transformer_blocks\\.13``.
"""

from __future__ import annotations

from ..stable_diffusion_3.pipeline_stable_diffusion_3_img2img import StableDiffusion3Img2ImgPipeline
from .pag_utils import PAGMixin


class StableDiffusion3PAGImg2ImgPipeline(PAGMixin, StableDiffusion3Img2ImgPipeline):
    _default_pag_applied_layers = r"transformer_blocks\.13"

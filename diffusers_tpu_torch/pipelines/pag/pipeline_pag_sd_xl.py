"""SDXL text-to-image with Perturbed-Attention Guidance.

Port of `diffusers_tpu/pipelines/pag/pipeline_pag_sd_xl.py`:
`StableDiffusionXLPipeline` with the perturbed conditional forward of
`pag_utils.PAGMixin`, steps counted against `num_inference_steps`.
"""

from __future__ import annotations

from ..stable_diffusion_xl.pipeline_stable_diffusion_xl import StableDiffusionXLPipeline
from .pag_utils import PAGMixin


class StableDiffusionXLPAGPipeline(PAGMixin, StableDiffusionXLPipeline):
    pass

"""Stable Diffusion inpainting with Perturbed-Attention Guidance.

Port of `diffusers_tpu/pipelines/pag/pipeline_pag_sd_inpaint.py`:
`StableDiffusionInpaintPipeline` with the perturbed conditional forward of
`pag_utils.PAGMixin`, steps counted against the loop's timesteps; an
inpainting UNet's perturbed call gets the conditional half of the mask
channels, and a 4-channel UNet's latents are blended at the base pipeline's
rule (upstream's, ROADMAP C4).
"""

from __future__ import annotations

from ..stable_diffusion.pipeline_stable_diffusion_inpaint import StableDiffusionInpaintPipeline
from .pag_utils import PAGMixin


class StableDiffusionPAGInpaintPipeline(PAGMixin, StableDiffusionInpaintPipeline):
    pass

"""SDXL inpainting with Perturbed-Attention Guidance.

Port of `diffusers_tpu/pipelines/pag/pipeline_pag_sd_xl_inpaint.py`:
`StableDiffusionXLInpaintPipeline` with the perturbed conditional forward of
`pag_utils.PAGMixin`, steps counted against the loop's timesteps; an
inpainting UNet's perturbed call gets the conditional half of the mask
channels, and a 4-channel UNet's latents are blended at the base pipeline's
rule (upstream's, ROADMAP C4).
"""

from __future__ import annotations

from ..stable_diffusion_xl.pipeline_stable_diffusion_xl_inpaint import StableDiffusionXLInpaintPipeline
from .pag_utils import PAGMixin


class StableDiffusionXLPAGInpaintPipeline(PAGMixin, StableDiffusionXLInpaintPipeline):
    pass

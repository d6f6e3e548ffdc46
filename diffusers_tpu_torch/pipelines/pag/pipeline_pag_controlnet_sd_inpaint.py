"""Stable Diffusion ControlNet inpainting with Perturbed-Attention Guidance.

Port of `diffusers_tpu/pipelines/pag/pipeline_pag_controlnet_sd_inpaint.py`:
`StableDiffusionControlNetInpaintPipeline` with the perturbed conditional
forward of `pag_utils.PAGMixin`, steps counted against the loop's timesteps;
the perturbed UNet call takes the conditional half of the ControlNet's
residuals, and the latents are blended at the next timestep's noise level as
in the base pipeline.
"""

from __future__ import annotations

from ..controlnet.pipeline_controlnet_inpaint import StableDiffusionControlNetInpaintPipeline
from .pag_utils import PAGMixin


class StableDiffusionControlNetPAGInpaintPipeline(PAGMixin, StableDiffusionControlNetInpaintPipeline):
    pass

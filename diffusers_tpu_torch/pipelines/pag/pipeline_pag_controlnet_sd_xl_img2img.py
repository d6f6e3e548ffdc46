"""SDXL + ControlNet image-to-image with Perturbed-Attention Guidance.

Port of
`diffusers_tpu/pipelines/pag/pipeline_pag_controlnet_sd_xl_img2img.py`:
`StableDiffusionXLControlNetImg2ImgPipeline` with the perturbed conditional
forward of `pag_utils.PAGMixin`, steps counted against the timesteps the
strength keeps; the perturbed UNet call takes the conditional half of the
ControlNet's residuals and of the micro-conditioning.
"""

from __future__ import annotations

from ..controlnet.pipeline_controlnet_sd_xl_img2img import StableDiffusionXLControlNetImg2ImgPipeline
from .pag_utils import PAGMixin


class StableDiffusionXLControlNetPAGImg2ImgPipeline(PAGMixin, StableDiffusionXLControlNetImg2ImgPipeline):
    pass

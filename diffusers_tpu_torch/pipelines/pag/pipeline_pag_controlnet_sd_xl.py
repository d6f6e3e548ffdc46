"""SDXL + ControlNet with Perturbed-Attention Guidance.

Port of `diffusers_tpu/pipelines/pag/pipeline_pag_controlnet_sd_xl.py`:
`StableDiffusionXLControlNetPipeline` with the perturbed conditional forward
of `pag_utils.PAGMixin`, steps counted against `num_inference_steps`; the
perturbed UNet call takes the conditional half of the ControlNet's residuals
and of the micro-conditioning.
"""

from __future__ import annotations

from ..controlnet.pipeline_controlnet_sd_xl import StableDiffusionXLControlNetPipeline
from .pag_utils import PAGMixin


class StableDiffusionXLControlNetPAGPipeline(PAGMixin, StableDiffusionXLControlNetPipeline):
    pass

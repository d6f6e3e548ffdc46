"""Stable Diffusion + ControlNet with Perturbed-Attention Guidance.

Port of `diffusers_tpu/pipelines/pag/pipeline_pag_controlnet_sd.py`:
`StableDiffusionControlNetPipeline` with the perturbed conditional forward of
`pag_utils.PAGMixin`, steps counted against `num_inference_steps`; the
perturbed UNet call takes the conditional half of the ControlNet's residuals.
"""

from __future__ import annotations

from ..controlnet.pipeline_controlnet import StableDiffusionControlNetPipeline
from .pag_utils import PAGMixin


class StableDiffusionControlNetPAGPipeline(PAGMixin, StableDiffusionControlNetPipeline):
    pass

"""Stable Diffusion text-to-image with Perturbed-Attention Guidance.

Port of `diffusers_tpu/pipelines/pag/pipeline_pag_sd.py`:
`StableDiffusionPipeline` with the perturbed conditional forward of
`pag_utils.PAGMixin`, steps counted against `num_inference_steps`, so under
PNDM (one timestep more than the steps) the last call runs without the
perturbed forward, as in JAX.
"""

from __future__ import annotations

from ..stable_diffusion.pipeline_stable_diffusion import StableDiffusionPipeline
from .pag_utils import PAGMixin


class StableDiffusionPAGPipeline(PAGMixin, StableDiffusionPipeline):
    pass

"""Stable Diffusion 3 text-to-image with Perturbed-Attention Guidance.

Port of `diffusers_tpu/pipelines/pag/pipeline_pag_sd_3.py`:
`StableDiffusion3Pipeline` with the perturbed conditional forward of
`pag_utils.PAGMixin`, steps counted against the schedule's timesteps. The
perturbed forward masks the selected blocks' image-to-image joint attention to
the identity (`JointAttention.pag_identity`); the default layers are
``transformer_blocks\\.13``.
"""

from __future__ import annotations

from ..stable_diffusion_3.pipeline_stable_diffusion_3 import StableDiffusion3Pipeline
from .pag_utils import PAGMixin


class StableDiffusion3PAGPipeline(PAGMixin, StableDiffusion3Pipeline):
    _default_pag_applied_layers = r"transformer_blocks\.13"

"""Guiders: how a denoise step combines its model predictions.

Port of `diffusers_tpu/guiders/`. Each guider is a `ConfigMixin` (saved as
`guider_config.json`) whose ``__call__(pred_cond, pred_uncond, ..., step,
num_steps)`` returns the guided prediction; the start / stop gates take a
Python or a tensor step. PAG, Skip Layer Guidance and SEG also give the
context managers that flip their perturbation flags on a model's modules
(`pag_perturbed`, `layers_skipped`, `seg_blurred`) and the selectors of
those modules.
"""

from .guider_utils import BaseGuidance, rescale_noise_cfg
from .classifier_free_guidance import ClassifierFreeGuidance
from .classifier_free_zero_star_guidance import ClassifierFreeZeroStarGuidance
from .adaptive_projected_guidance import AdaptiveProjectedGuidance
from .perturbed_attention_guidance import PerturbedAttentionGuidance, pag_perturbed, select_pag_layers
from .skip_layer_guidance import SkipLayerGuidance, layers_skipped, select_skip_blocks
from .adaptive_projected_guidance_mix import AdaptiveProjectedMixGuidance
from .auto_guidance import AutoGuidance
from .frequency_decoupled_guidance import FrequencyDecoupledGuidance
from .magnitude_aware_guidance import MagnitudeAwareGuidance
from .smoothed_energy_guidance import SmoothedEnergyGuidance, seg_blurred, seg_gaussian_blur_2d
from .tangential_classifier_free_guidance import TangentialClassifierFreeGuidance

"""ReduxImageEncoder: Flux Redux's image embedder.

Port of `diffusers_tpu/pipelines/flux/modeling_flux.py`: SigLIP's
last hidden state -> `redux_up` (to 3 x the T5 width) -> SiLU ->
`redux_down` (to the T5 width), image tokens that `FluxPriorReduxPipeline`
appends to the T5 prompt embeds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ...configuration_utils import ConfigMixin, register_to_config
from ...models.modeling_utils import ModelMixin
from ...ops.module import Linear
from ...utils import BaseOutput


@dataclass
class ReduxImageEncoderOutput(BaseOutput):
    image_embeds: Optional[torch.Tensor] = None


class ReduxImageEncoder(ModelMixin, ConfigMixin):
    @register_to_config
    def __init__(self, redux_dim: int = 1152, txt_in_features: int = 4096):
        super().__init__()
        self.redux_up = Linear(redux_dim, txt_in_features * 3)
        self.redux_down = Linear(txt_in_features * 3, txt_in_features)

    def forward(self, x: torch.Tensor) -> ReduxImageEncoderOutput:
        return ReduxImageEncoderOutput(image_embeds=self.redux_down(F.silu(self.redux_up(x))))

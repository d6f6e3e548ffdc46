"""Multi-ControlNet-Union: several ControlNet-Unions whose residuals are summed.

Port of `diffusers_tpu/models/controlnets/multicontrolnet_union.py`
(`:21-65`): each net gets its own list of conditioning images, control-type
mask, active task indices and scale; a net whose scale is 0.0 is skipped;
the residual stacks are summed in net order. Saving and loading follow
`MultiControlNetModel` (`dir`, `dir_1`, ...), reading `ControlNetUnionModel`s.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from .controlnet_union import ControlNetUnionModel
from .multicontrolnet import MultiControlNetModel, sum_residuals


class MultiControlNetUnionModel(MultiControlNetModel):
    _controlnet_cls = ControlNetUnionModel

    def forward(
        self,
        sample: torch.Tensor,
        timestep,
        encoder_hidden_states: torch.Tensor,
        controlnet_cond: Sequence,  # a net: its list of conditioning images (one an active task)
        control_type: Sequence[torch.Tensor],  # a net: its [B, num_control_type] mask
        control_type_idx: Sequence[Sequence[int]],  # a net: its active task indices
        conditioning_scale: Union[float, Sequence[float]] = 1.0,
        added_cond_kwargs: Optional[dict] = None,
        guess_mode: bool = False,
        return_dict: bool = True,
    ):
        if not isinstance(conditioning_scale, (list, tuple)):
            conditioning_scale = [conditioning_scale] * len(self.nets)
        out = sum_residuals(
            net(sample, timestep, encoder_hidden_states, images, control_type=ctype, control_type_idx=list(idx),
                conditioning_scale=scale, added_cond_kwargs=added_cond_kwargs, guess_mode=guess_mode)
            for net, images, ctype, idx, scale in zip(self.nets, controlnet_cond, control_type, control_type_idx,
                                                      conditioning_scale)
            if scale != 0.0)
        if not return_dict:
            return out.down_block_res_samples, out.mid_block_res_sample
        return out

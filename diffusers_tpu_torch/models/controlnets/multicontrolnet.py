"""Multi-ControlNet: several ControlNets whose residuals are summed.

Port of `diffusers_tpu/models/controlnets/multicontrolnet.py` (`:26-97`):
each net gets its own conditioning image and scale (one scale for all when a
float is given), a length mismatch raises `ValueError` (`:57-61`), and the
down and mid residual stacks are summed in net order. The nets sit in an
`nn.ModuleList`, so a pipeline's `.to` moves them. `save_pretrained(dir)`
writes the first net to `dir` and net i to `dir_i` (`:79-84`);
`from_pretrained(dir)` reads `dir`, `dir_1`, ... while they exist.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

import torch
from torch import nn

from ...utils import logging
from .controlnet import ControlNetModel, ControlNetOutput

logger = logging.get_logger(__name__)


def sum_residuals(outputs) -> ControlNetOutput:
    """The element-wise sum of several `ControlNetOutput`s, in their order."""
    down, mid = None, None
    for out in outputs:
        if down is None:
            down, mid = list(out.down_block_res_samples), out.mid_block_res_sample
        else:
            down = [a + b for a, b in zip(down, out.down_block_res_samples)]
            mid = mid + out.mid_block_res_sample
    return ControlNetOutput(down_block_res_samples=tuple(down), mid_block_res_sample=mid)


class MultiControlNetModel(nn.Module):
    _controlnet_cls = ControlNetModel

    def __init__(self, controlnets: Sequence[nn.Module]):
        super().__init__()
        self.nets = nn.ModuleList(controlnets)

    def __len__(self):
        return len(self.nets)

    @property
    def device(self) -> torch.device:
        return self.nets[0].device

    @property
    def dtype(self) -> torch.dtype:
        return self.nets[0].dtype

    def forward(
        self,
        sample: torch.Tensor,
        timestep,
        encoder_hidden_states: torch.Tensor,
        controlnet_cond: Sequence[torch.Tensor],  # one conditioning image a net
        conditioning_scale: Union[float, Sequence[float]] = 1.0,
        added_cond_kwargs: Optional[dict] = None,
        guess_mode: bool = False,
        return_dict: bool = True,
    ):
        if not isinstance(conditioning_scale, (list, tuple)):
            conditioning_scale = [conditioning_scale] * len(self.nets)
        if len(controlnet_cond) != len(self.nets) or len(conditioning_scale) != len(self.nets):
            raise ValueError(f"Expected {len(self.nets)} conditioning images/scales, got {len(controlnet_cond)} "
                             f"images and {len(conditioning_scale)} scales.")
        out = sum_residuals(
            net(sample, timestep, encoder_hidden_states, image, conditioning_scale=scale,
                added_cond_kwargs=added_cond_kwargs, guess_mode=guess_mode)
            for net, image, scale in zip(self.nets, controlnet_cond, conditioning_scale))
        if not return_dict:
            return out.down_block_res_samples, out.mid_block_res_sample
        return out

    # ----------------------------------------------------- the upstream directory layout
    def save_pretrained(self, save_directory: Union[str, os.PathLike], **kwargs):
        """Net 0 to `save_directory`, net i to `save_directory_i`."""
        for i, net in enumerate(self.nets):
            net.save_pretrained(str(save_directory) + ("" if i == 0 else f"_{i}"), **kwargs)

    @classmethod
    def from_pretrained(cls, pretrained_model_path: Union[str, os.PathLike], controlnet_cls=None, **kwargs):
        """The nets of `dir`, `dir_1`, `dir_2`, ... (each through
        `controlnet_cls.from_pretrained(path, **kwargs)`) while they exist."""
        controlnet_cls = controlnet_cls or cls._controlnet_cls
        nets: List[nn.Module] = []
        path = str(pretrained_model_path)
        while os.path.isdir(path):
            nets.append(controlnet_cls.from_pretrained(path, **kwargs))
            path = f"{pretrained_model_path}_{len(nets)}"
        if not nets:
            raise ValueError(f"No ControlNets found under {pretrained_model_path}.")
        logger.info("%d controlnets loaded from %s.", len(nets), pretrained_model_path)
        return cls(nets)

"""SDXL + ControlNet-Union text-to-image pipeline.

Port of `diffusers_tpu/pipelines/controlnet/pipeline_controlnet_union_sd_xl.py`
(`:26-164`): one `ControlNetUnionModel` serves several control tasks;
`control_image` is a list (or one image) aligned with `control_mode`, the
task indices (default 0, 1, ...; an int for one), and a mismatch raises
`ValueError` (`:115`). The active-task mask [B, num_control_type] feeds the
net's control-type embedding and repeats over the CFG batch with the
images. Guess mode under CFG follows upstream (`controlnet_utils`; JAX runs
the net on both halves, ROADMAP C4).

A `MultiControlNetUnionModel` (or a list of Union nets, wrapped in one)
takes upstream's nested form: `control_image` a list with one entry a net
(an image or a list of images), `control_mode` likewise (an int, a list or
None a net), `controlnet_conditioning_scale` a float or one a net (a net at
0.0 is skipped). JAX's Union pipelines cannot run the multi model (ROADMAP
C4); JAX's `MultiControlNetUnionModel` is what the port's is held to.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ...models.controlnets.multicontrolnet_union import MultiControlNetUnionModel
from ...utils import torch_utils
from .controlnet_utils import ControlNetCall, conditioning_image
from .pipeline_controlnet_sd_xl import StableDiffusionXLControlNetPipeline


class StableDiffusionXLControlNetUnionPipeline(StableDiffusionXLControlNetPipeline):
    def _union_controls(self, control_image, control_mode) -> dict:
        """`ControlNetCall`'s keywords `cond`, `control_type` ([1,
        num_control_type] masks) and `control_type_idx` for one Union net,
        or nested one a net for a multi model."""

        def one(net, images, modes):
            images = list(images) if isinstance(images, (list, tuple)) else [images]
            modes = list(range(len(images))) if modes is None else [modes] if isinstance(modes, int) else list(modes)
            if len(modes) != len(images):
                raise ValueError("control_mode must list one task index per control_image")
            mask = np.zeros((1, net.config.num_control_type), np.float32)
            mask[:, modes] = 1.0
            return [conditioning_image(self.image_processor, im) for im in images], torch.from_numpy(mask), modes

        if not isinstance(self.controlnet, MultiControlNetUnionModel):
            cond, mask, modes = one(self.controlnet, control_image, control_mode)
            return {"cond": cond, "control_type": mask, "control_type_idx": modes}
        control_mode = control_mode if control_mode is not None else [None] * len(self.controlnet.nets)
        if len(control_image) != len(self.controlnet.nets) or len(control_mode) != len(self.controlnet.nets):
            raise ValueError(f"Expected one control_image and control_mode entry for each of the "
                             f"{len(self.controlnet.nets)} nets")
        per_net = [one(net, im, mode) for net, im, mode in zip(self.controlnet.nets, control_image, control_mode)]
        return {"cond": [c for c, _, _ in per_net], "control_type": [m for _, m, _ in per_net],
                "control_type_idx": [i for _, _, i in per_net]}

    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        prompt_2: Optional[Union[str, List[str]]] = None,
        control_image=None,
        control_mode: Union[int, List[int], None] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        negative_prompt_2: Optional[Union[str, List[str]]] = None,
        controlnet_conditioning_scale: Union[float, List[float]] = 1.0,
        guess_mode: bool = False,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        original_size: Optional[Tuple[int, int]] = None,
        crops_coords_top_left: Tuple[int, int] = (0, 0),
        target_size: Optional[Tuple[int, int]] = None,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Text-to-image steered by `control_image` for the tasks of
        `control_mode`, at the first image's size unless `height` /
        `width` are given."""
        device, dtype = self.unet.device, self.unet.dtype
        controls = self._union_controls(control_image, control_mode)
        first = controls["cond"][0]
        first = first[0] if isinstance(first, list) else first
        height = height or first.shape[-2]
        width = width or first.shape[-1]
        do_cfg = guidance_scale > 1.0
        prompt_embeds, added, batch_size = self._sdxl_conditioning(
            prompt, prompt_2, negative_prompt, do_cfg, height, width, original_size, crops_coords_top_left,
            target_size, negative_prompt_2)
        cn = ControlNetCall(self.controlnet, conditioning_scale=controlnet_conditioning_scale, guess_mode=guess_mode,
                            do_cfg=do_cfg, batch_size=batch_size, prompt_embeds=prompt_embeds, added=added,
                            **controls)
        shape = (batch_size, self.unet.config.in_channels, height // self.vae_scale_factor,
                 width // self.vae_scale_factor)
        if latents is None:
            latents = torch_utils.randn_tensor(shape, generator, device)
        state, latents, _ = self._start(latents.to(device=device, dtype=dtype), num_inference_steps)
        latents = self._loop(cn, state, state.timesteps, latents, prompt_embeds, guidance_scale, added)
        return self._output(latents, output_type, return_dict)

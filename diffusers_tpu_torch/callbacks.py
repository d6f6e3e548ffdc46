"""Pipeline callbacks for `callback_on_step_end`.

Port of `diffusers_tpu/callbacks.py`: `PipelineCallback`,
`MultiPipelineCallbacks` and the CFG-cutoff callbacks. A callback is called
after each scheduler step as ``callback(pipeline, step_index, timestep,
callback_kwargs)`` and returns the tensors it replaces.
"""

from __future__ import annotations

from typing import Any, Dict, List

from .configuration_utils import ConfigMixin, register_to_config

CONFIG_NAME = "pipeline_callback_config.json"


class PipelineCallback(ConfigMixin):
    config_name = CONFIG_NAME

    @register_to_config
    def __init__(self, cutoff_step_ratio: float = 1.0, cutoff_step_index: int = None):
        if cutoff_step_index is None and not (0.0 <= cutoff_step_ratio <= 1.0):
            raise ValueError("cutoff_step_ratio must be in [0, 1]")

    @property
    def tensor_inputs(self) -> List[str]:
        return []

    def callback_fn(self, pipeline, step_index, timestep, callback_kwargs) -> Dict[str, Any]:
        raise NotImplementedError

    def __call__(self, pipeline, step_index, timestep, callback_kwargs) -> Dict[str, Any]:
        return self.callback_fn(pipeline, step_index, timestep, callback_kwargs)

    def _cutoff_step(self, num_steps: int) -> int:
        idx = self.config.cutoff_step_index
        return idx if idx is not None else int(num_steps * self.config.cutoff_step_ratio)


class MultiPipelineCallbacks:
    def __init__(self, callbacks: List[PipelineCallback]):
        self.callbacks = callbacks

    @property
    def tensor_inputs(self) -> List[str]:
        return [inp for cb in self.callbacks for inp in cb.tensor_inputs]

    def __call__(self, pipeline, step_index, timestep, callback_kwargs):
        for cb in self.callbacks:
            callback_kwargs = cb(pipeline, step_index, timestep, callback_kwargs)
        return callback_kwargs


class SDCFGCutoffCallback(PipelineCallback):
    """Disable CFG after the cutoff step."""

    tensor_inputs = ["prompt_embeds"]

    def callback_fn(self, pipeline, step_index, timestep, callback_kwargs):
        if step_index == self._cutoff_step(pipeline._num_timesteps):
            prompt_embeds = callback_kwargs["prompt_embeds"]
            callback_kwargs["prompt_embeds"] = prompt_embeds[-(prompt_embeds.shape[0] // 2):]
            callback_kwargs["guidance_scale"] = 1.0
        return callback_kwargs


class SDXLCFGCutoffCallback(PipelineCallback):
    """Disable CFG after the cutoff step, dropping the uncond half of all
    three conditioning tensors."""

    tensor_inputs = ["prompt_embeds", "add_text_embeds", "add_time_ids"]

    def callback_fn(self, pipeline, step_index, timestep, callback_kwargs):
        if step_index == self._cutoff_step(pipeline._num_timesteps):
            for name in self.tensor_inputs:
                t = callback_kwargs[name]
                callback_kwargs[name] = t[-(t.shape[0] // 2):]
            callback_kwargs["guidance_scale"] = 1.0
        return callback_kwargs

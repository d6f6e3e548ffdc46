"""DiffusionPipeline: component container.

Port of the container part of `diffusers_tpu/pipelines/pipeline_utils.py`
(`register_modules`, config, `components`). JAX pipelines hold
``(module, params)`` pairs; here a weight-bearing component is one
`nn.Module`, and `.to(device, dtype)` moves them all. A pipeline runs on the
card unless its caller asks for the CPU: every pipeline takes ``device``
(default ``"cuda"``) and moves its components there when it is built, and it
raises there if no CUDA device is visible. `enable_cache` /
`disable_cache` store a config from `diffusers_tpu_torch.hooks` that the
pipeline's denoise loop honours. A model that `ModelMixin.from_pretrained`
loaded drops in as a component. The pipeline-level `from_pretrained`
(`model_index.json`), `save_pretrained` and LoRA wait.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
from torch import nn

from ..configuration_utils import ConfigMixin

PIPELINE_CONFIG_NAME = "model_index.json"


class DiffusionPipeline(ConfigMixin):
    """Base pipeline. Subclasses declare components via `register_modules` in
    __init__ and implement `__call__`."""

    config_name = PIPELINE_CONFIG_NAME
    _optional_components: list = []

    def register_modules(self, **kwargs):
        for name, module in kwargs.items():
            if module is None:
                register_dict = {name: (None, None)}
            else:
                library = "diffusers_tpu_torch"
                cls_name = module.__class__.__name__
                if cls_name.endswith("Tokenizer") or cls_name.endswith("TokenizerFast"):
                    library = "transformers"
                register_dict = {name: (library, cls_name)}
            self.register_to_config(**register_dict)
            setattr(self, name, module)

    @classmethod
    def from_pretrained(cls, *args, **kwargs):
        raise NotImplementedError(
            f"{cls.__name__}.from_pretrained (model_index.json) is not ported yet: it waits for the CLIP and T5 "
            "tokenizers (ROADMAP A3). Load each model with ModelMixin.from_pretrained and build the pipeline "
            "from them."
        )

    @property
    def device(self) -> torch.device:
        """The device of the pipeline's models (its first `nn.Module` component's)."""
        for module in self.components.values():
            if isinstance(module, nn.Module):
                return next(module.parameters()).device
        return torch.device("cpu")

    @property
    def components(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self.config.keys() if not k.startswith("_")}

    def _place(self, device: Union[str, torch.device]) -> None:
        """Move the components to `device` at construction; a CUDA device
        with no card visible raises (pass ``device="cpu"`` to run on the CPU)."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{type(self).__name__}: no CUDA device is visible; pass device='cpu' to run this pipeline on the CPU"
            )
        self.to(device=device)

    def to(self, device: Optional[torch.device] = None, dtype: Optional[torch.dtype] = None):
        """Move every `nn.Module` component to `device` and/or `dtype`."""
        for module in self.components.values():
            if isinstance(module, nn.Module):
                module.to(device=device, dtype=dtype)
        return self

    # ---------------------------------------------------------------- caches
    # cache-config class names this pipeline's denoise loop honours
    _supported_cache_configs: tuple = ()
    _cache_config = None

    def enable_cache(self, config):
        """Enable a timestep cache for the denoise loop. `config` is one of
        the frozen configs of `diffusers_tpu_torch.hooks`. Raises TypeError
        when this pipeline's loop does not honour it."""
        name = type(config).__name__
        if name not in self._supported_cache_configs:
            raise TypeError(
                f"{type(self).__name__} does not support cache config {name}; "
                f"supported here: {list(self._supported_cache_configs) or 'none'}"
            )
        self._cache_config = config

    def disable_cache(self):
        self._cache_config = None

"""What the PAG pipelines share: `PAGMixin`.

Port of `diffusers_tpu/pipelines/pag/pag_utils.py`. A PAG pipeline is its
base pipeline with two forwards a step, as in JAX: the model runs on the
CFG batch (uncond first, or the conditional batch alone without CFG), then
once more on the conditional half with the identity attention map in the
selected self-attentions (`guiders.pag_perturbed`), and

    pred = uncond + g (cond - uncond) + pag_scale (cond - perturbed)

while step i of n has ``pag_start <= i / n < pag_stop`` (float32, JAX's
fractional gate). The mixin overrides the base pipelines' guidance seam
(`DiffusionPipeline._cfg_predict`), which each base loop calls with the
step's (index, count): text-to-image loops count `num_inference_steps`,
the others the timesteps they run, as the JAX loops do. Every batched input
of the model call (latents, embeddings, micro-conditioning, ControlNet
residuals, image embeds) is cut to its conditional half for the perturbed
forward, so a ControlNet's residuals are its conditional half's, not a
second ControlNet run at batch 1 (JAX runs it again; the numbers are the
same). On a step the gate closes the perturbed forward is not run: JAX runs
it and multiplies it by 0 (ROADMAP C3). JAX's PAG loops read no cache
config, so `enable_cache` raises `TypeError` on every PAG pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Union

import numpy as np
import torch

from ...guiders.perturbed_attention_guidance import pag_perturbed, select_pag_layers


def cond_half(x, batch: int):
    """The conditional (second) half of every tensor of `x` whose leading
    dim is the CFG batch `batch`, through dicts, lists and tuples; anything
    else as it is."""
    if isinstance(x, torch.Tensor):
        return x[batch // 2:] if x.ndim and x.shape[0] == batch else x
    if isinstance(x, dict):
        return {k: cond_half(v, batch) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(cond_half(v, batch) for v in x)
    return x


@dataclass(frozen=True)
class PAGSettings:
    """One request's PAG: the perturbed layers, the scale and the window."""

    layers: tuple
    scale: float
    start: float
    stop: float

    def on(self, i: int, n: int) -> bool:
        """Whether step i of n is inside ``[start, stop)``, in float32 as JAX gates it."""
        frac = np.float32(i) / np.float32(max(n, 1))
        return bool(frac >= np.float32(self.start)) and bool(frac < np.float32(self.stop))


class PAGMixin:
    """Mixin over a base pipeline class: `__call__` takes the PAG knobs and
    defers everything else to the base."""

    _supported_cache_configs = ()
    _default_pag_applied_layers: Union[str, List[str]] = "mid"
    _pag = None

    def _pag_model(self):
        for attr in ("unet", "transformer"):
            model = getattr(self, attr, None)
            if model is not None:
                return model
        raise ValueError(f"{type(self).__name__} has neither a unet nor a transformer")

    def __call__(
        self,
        *args,
        pag_scale: float = 3.0,
        pag_applied_layers: Union[str, List[str], None] = None,
        pag_start: float = 0.0,
        pag_stop: float = 1.0,
        **kwargs,
    ):
        """The base pipeline's call with PAG: `pag_applied_layers` (default
        "mid"; r"transformer_blocks\\.13" on SD3) are matched against the
        self-attentions' dotted names (`guiders.select_pag_layers`)."""
        layers = select_pag_layers(self._pag_model(), pag_applied_layers or self._default_pag_applied_layers)
        self._pag = PAGSettings(tuple(layers), float(pag_scale), float(pag_start), float(pag_stop))
        try:
            return super().__call__(*args, **kwargs)
        finally:
            self._pag = None

    def _cfg_predict(self, model_fn, guidance_scale: float, cfg: bool, step, *inputs) -> torch.Tensor:
        noise_pred = model_fn(*inputs)
        if cfg:
            uncond, cond = noise_pred.chunk(2, dim=0)
            pred = uncond + guidance_scale * (cond - uncond)
        else:
            cond = pred = noise_pred
        pag = self._pag
        if pag is None:
            return pred
        if step is None:
            raise RuntimeError(f"{type(self).__name__}: a PAG step needs its (index, count)")
        if not pag.on(*step):
            return pred
        with pag_perturbed(pag.layers):
            perturbed = model_fn(*cond_half(inputs, noise_pred.shape[0])) if cfg else model_fn(*inputs)
        return pred + pag.scale * (cond - perturbed)

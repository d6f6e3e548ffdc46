"""Perturbed-Attention Guidance (PAG): the guider, the layer selection and
the flag's context manager.

Port of `diffusers_tpu/guiders/perturbed_attention_guidance.py`:

    pred = pred_uncond + g (pred_cond - pred_uncond) + g_pag (pred_cond - pred_perturbed)

where `pred_perturbed` is the conditional forward with the identity
attention map in the selected self-attentions (`pag_identity` on
`models.attention.Attention` and the SD3 `JointAttention`). In JAX the flag
is read when the forward is traced; here it is a plain attribute read on
every call, so `pag_perturbed` sets it on entry and clears it on exit, an
exception included.
"""

from __future__ import annotations

import re
from typing import List, Optional, Union

import torch

from ..configuration_utils import register_to_config
from .guider_utils import BaseGuidance, in_window, rescale_noise_cfg, step_fraction


class PerturbedAttentionGuidance(BaseGuidance):
    _input_predictions = ["pred_cond", "pred_uncond", "pred_cond_skip"]

    @register_to_config
    def __init__(
        self,
        guidance_scale: float = 7.5,
        perturbed_guidance_scale: float = 2.8,
        perturbed_guidance_start: float = 0.01,
        perturbed_guidance_stop: float = 0.2,
        perturbed_guidance_layers: Optional[Union[str, List[str]]] = "mid",
        guidance_rescale: float = 0.0,
        use_original_formulation: bool = False,
        start: float = 0.0,
        stop: float = 1.0,
    ):
        pass

    @property
    def num_conditions(self) -> int:
        return 3

    def __call__(
        self,
        pred_cond: torch.Tensor,
        pred_uncond: Optional[torch.Tensor] = None,
        pred_cond_skip: Optional[torch.Tensor] = None,
        step=0,
        num_steps: int = 1,
    ):
        cfg = self.config
        frac = step_fraction(step, num_steps, pred_cond.device)
        if pred_uncond is not None:
            base = pred_cond if cfg.use_original_formulation else pred_uncond
            pred = base + cfg.guidance_scale * (pred_cond - pred_uncond)
        else:
            pred = pred_cond
        if pred_cond_skip is not None:
            pag_on = in_window(frac, cfg.perturbed_guidance_start, cfg.perturbed_guidance_stop)
            pred = pred + torch.where(pag_on, cfg.perturbed_guidance_scale, 0.0) * (pred_cond - pred_cond_skip)
        if cfg.guidance_rescale > 0.0:
            pred = rescale_noise_cfg(pred, pred_cond, cfg.guidance_rescale)
        return torch.where(self._enabled(step, num_steps, pred.device), pred, pred_cond)


def iter_self_attention_names(model):
    """(dotted name, self-attention module) for every perturbable
    self-attention: a UNet's transformer blocks' `attn1` (down, mid, up), a
    DiT's `transformer_blocks.{k}.attn`, a HunyuanDiT-style `blocks.{k}.attn1`."""
    if hasattr(model, "down_blocks"):  # UNet family
        blocks = [(f"down_blocks.{i}", b) for i, b in enumerate(model.down_blocks)]
        blocks.append(("mid_block", model.mid_block))
        blocks += [(f"up_blocks.{i}", b) for i, b in enumerate(model.up_blocks)]
        for prefix, block in blocks:
            for j, t2d in enumerate(getattr(block, "attentions", None) or []):
                for k, tb in enumerate(t2d.transformer_blocks):
                    if getattr(tb, "attn1", None) is not None:
                        yield f"{prefix}.attentions.{j}.transformer_blocks.{k}.attn1", tb.attn1
        return
    if hasattr(model, "transformer_blocks"):  # DiT family (SD3, ...)
        for k, tb in enumerate(model.transformer_blocks):
            attn = getattr(tb, "attn", None) or getattr(tb, "attn1", None)
            if attn is not None and hasattr(type(attn), "pag_identity"):
                yield f"transformer_blocks.{k}.attn", attn
        return
    if hasattr(model, "blocks"):  # HunyuanDiT-style `blocks.{k}.attn1`
        for k, tb in enumerate(model.blocks):
            attn = getattr(tb, "attn1", None)
            if attn is not None and hasattr(type(attn), "pag_identity"):
                yield f"blocks.{k}.attn1", attn
        return
    raise ValueError(f"{type(model).__name__} has no PAG-perturbable attention layers")


def select_pag_layers(model, patterns: Union[str, List[str]]):
    """The self-attention modules whose dotted name matches any pattern
    (``re.search``: "mid", "down_blocks.1", r"transformer_blocks\\.13", ...)."""
    if isinstance(patterns, str):
        patterns = [patterns]
    selected = [attn for name, attn in iter_self_attention_names(model) if any(re.search(p, name) for p in patterns)]
    if not selected:
        raise ValueError(f"no self-attention layers matched {patterns}")
    return selected


class pag_perturbed:
    """Context manager: `pag_identity` on the selected layers around the
    perturbed forward, cleared on exit (an exception included)."""

    def __init__(self, layers):
        self.layers = list(layers)

    def __enter__(self):
        for m in self.layers:
            m.pag_identity = True

    def __exit__(self, *exc):
        for m in self.layers:
            m.pag_identity = False
        return False

"""Flux Prior Redux pipeline: an image -> Flux conditioning embeds.

Port of `diffusers_tpu/pipelines/flux/pipeline_flux_prior_redux.py`: the
SigLIP tower's last hidden state goes through `ReduxImageEncoder`; its
image tokens are appended to the T5 prompt embeds (or to 512 zero tokens
without text encoders) and the embeds are scaled by `prompt_embeds_scale`,
the pooled ones by `pooled_prompt_embeds_scale`; with several images and a
list of scales the rows are summed into one (image mixing). The output feeds
`FluxPipeline.__call__` through ``prompt_embeds=`` and
``pooled_prompt_embeds=``. Preprocessing is JAX's: a `feature_extractor`
(transformers' `SiglipImageProcessor`) is called on the host; without one
the image is taken as pixel values, [H, W, C] or [B, C, H, W] as given
(ROADMAP C3). The embeds are scaled in float32, as JAX scales them, and
returned in the image embedder's dtype, where JAX returns float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from ...utils import BaseOutput, logging
from ..pipeline_utils import DiffusionPipeline
from .pipeline_flux import FluxPipeline

logger = logging.get_logger(__name__)


@dataclass
class FluxPriorReduxPipelineOutput(BaseOutput):
    prompt_embeds: torch.Tensor
    pooled_prompt_embeds: torch.Tensor


class FluxPriorReduxPipeline(DiffusionPipeline):
    _optional_components = ["feature_extractor", "text_encoder", "tokenizer", "text_encoder_2", "tokenizer_2"]
    tokenizer_max_length = 77
    _ids = FluxPipeline._ids
    encode_prompt = FluxPipeline.encode_prompt

    def __init__(self, image_encoder, image_embedder, feature_extractor=None, text_encoder=None, tokenizer=None,
                 text_encoder_2=None, tokenizer_2=None, device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.register_modules(image_encoder=image_encoder, image_embedder=image_embedder,
                              feature_extractor=feature_extractor, text_encoder=text_encoder, tokenizer=tokenizer,
                              text_encoder_2=text_encoder_2, tokenizer_2=tokenizer_2)
        self._place(device)

    @torch.no_grad()
    def encode_image(self, image) -> torch.Tensor:
        """SigLIP's last hidden state [B, tokens, width] of `image`."""
        if self.feature_extractor is not None:
            pixel_values = np.asarray(self.feature_extractor(images=image, do_resize=True, return_tensors="np",
                                                             do_convert_rgb=True)["pixel_values"])
        else:
            pixel_values = np.asarray(image.detach().cpu() if isinstance(image, torch.Tensor) else image, np.float32)
            if pixel_values.ndim == 3:
                pixel_values = pixel_values[None]
        encoder = self.image_encoder
        pixels = torch.from_numpy(np.ascontiguousarray(pixel_values, dtype=np.float32)).to(device=encoder.device,
                                                                                           dtype=encoder.dtype)
        return encoder(pixels).last_hidden_state

    @torch.no_grad()
    def __call__(
        self,
        image,
        prompt: Union[str, List[str], None] = None,
        prompt_2: Optional[Union[str, List[str]]] = None,
        prompt_embeds_scale: Union[float, List[float]] = 1.0,
        pooled_prompt_embeds_scale: Union[float, List[float]] = 1.0,
        return_dict: bool = True,
    ):
        """(prompt_embeds [B, 512 + image tokens, T5 width], pooled [B, 768])
        for `FluxPipeline`; B is 1 when several images are mixed by a list of
        scales."""
        image_embeds = self.image_embedder(self.encode_image(image)).image_embeds
        batch_size = image_embeds.shape[0]
        if prompt is not None and self.text_encoder is not None:
            prompt_embeds, pooled, _ = self.encode_prompt(prompt, prompt_2, 512)
        else:
            if prompt is not None:
                logger.warning("prompt input is ignored when text encoders are not loaded to the pipeline.")
            width = self.image_embedder.config.txt_in_features
            prompt_embeds = image_embeds.new_zeros((batch_size, 512, width))
            pooled = image_embeds.new_zeros((batch_size, 768))
        dtype = image_embeds.dtype
        prompt_embeds = torch.cat([prompt_embeds.to(dtype), image_embeds], dim=1)
        pe_scale = torch.as_tensor(prompt_embeds_scale, dtype=torch.float32, device=image_embeds.device)
        pp_scale = torch.as_tensor(pooled_prompt_embeds_scale, dtype=torch.float32, device=image_embeds.device)
        # scaled in float32, as in JAX, and returned in the embedder's dtype (the transformer's input dtype)
        prompt_embeds = (prompt_embeds.float() * pe_scale.reshape(-1, 1, 1)).to(dtype)
        pooled = (pooled.float() * pp_scale.reshape(-1, 1)).to(dtype)
        if batch_size > 1 and np.ndim(prompt_embeds_scale) > 0:  # weighted image mixing (JAX `:97-100`)
            prompt_embeds = prompt_embeds.sum(dim=0, keepdim=True)
            pooled = pooled.sum(dim=0, keepdim=True)
        if not return_dict:
            return (prompt_embeds, pooled)
        return FluxPriorReduxPipelineOutput(prompt_embeds=prompt_embeds, pooled_prompt_embeds=pooled)

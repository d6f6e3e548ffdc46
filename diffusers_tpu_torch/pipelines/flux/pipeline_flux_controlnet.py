"""Flux ControlNet pipelines.

Port of `diffusers_tpu/pipelines/flux/pipeline_flux_controlnet.py`: each
step runs the `FluxControlNetModel` on the latents and the control condition
(InstantX-style: the control image's packed latents, the posterior's sample;
XLabs-style, a model with an `input_hint_block`: the NCHW image, and the
dual residuals by the repeat rule), then the transformer with its residuals
(`controlnet_block_samples`, `controlnet_single_block_samples`), both with
the same timestep and guidance. A Union ControlNet takes `control_mode` (one
int for the request), and its RoPE table has one more text row (the first
text id repeated). `FluxControlNetImg2ImgPipeline` and
`FluxControlNetInpaintPipeline` (`pipeline_flux_controlnet_image_to_image.py`,
`pipeline_flux_controlnet_inpainting.py`) add img2img's start and inpaint's
blend. A numpy array or PIL control image is preprocessed; a torch tensor is
taken as given (NCHW in [-1, 1]). The pipelines take one `FluxControlNetModel`
(JAX's take no `FluxMultiControlNetModel` either). `enable_cache` raises.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ...models.controlnets.controlnet_flux import FluxControlNetModel
from ...utils import torch_utils
from .pipeline_flux import FluxPipeline


class FluxControlNetPipeline(FluxPipeline):
    _supported_cache_configs = ()

    def __init__(self, scheduler, vae, text_encoder, tokenizer, text_encoder_2, tokenizer_2, transformer, controlnet,
                 image_encoder=None, feature_extractor=None, device: Union[str, torch.device] = "cuda"):
        if not isinstance(controlnet, FluxControlNetModel):
            raise TypeError(f"{type(self).__name__} takes one FluxControlNetModel, got {type(controlnet).__name__}")
        super().__init__(scheduler=scheduler, vae=vae, text_encoder=text_encoder, tokenizer=tokenizer,
                         text_encoder_2=text_encoder_2, tokenizer_2=tokenizer_2, transformer=transformer,
                         image_encoder=image_encoder, feature_extractor=feature_extractor, device=device)
        self.register_modules(controlnet=controlnet)
        self._place(device)

    def _control_condition(self, control_image, control_mode, height, width, batch_size, generator):
        """(the ControlNet's condition, its mode [B, 1] or None): the packed
        latents of the control image (the posterior's sample), or with a hint
        block the NCHW image itself."""
        controlnet = self.controlnet
        if isinstance(control_image, torch.Tensor):
            pixels = control_image.to(device=self.vae.device, dtype=self.vae.dtype)
        else:
            pixels = self._preprocess(control_image, height, width)
        if pixels.shape[0] < batch_size:
            pixels = pixels.repeat(batch_size // pixels.shape[0], 1, 1, 1)
        cond = pixels if controlnet.input_hint_block is not None else self._pack_latents(
            self._encode_image(pixels, generator))
        mode = None
        if controlnet.union:
            if control_mode is None:
                raise ValueError("`control_mode` is required for a ControlNet-Union model")
            mode = torch.full((batch_size, 1), int(control_mode), dtype=torch.long, device=pixels.device)
        return cond, mode

    def _controlnet_predict(self, cond, mode, scale, prompt_embeds, pooled, guidance, txt_ids, img_ids):
        """predict(latents, i, t) of `_loop`: the ControlNet, then the
        transformer with its residuals."""
        dtype = prompt_embeds.dtype
        rope = self._rope(txt_ids, img_ids)
        cn_rope = self._rope(txt_ids[:1], txt_ids, img_ids) if self.controlnet.union else rope
        cond = cond.to(dtype)
        blocks_repeat = self.controlnet.input_hint_block is not None

        def predict(latents, i, t):
            x = latents.to(dtype)
            residuals = self.controlnet(x, cond, controlnet_mode=mode, conditioning_scale=scale,
                                        encoder_hidden_states=prompt_embeds, pooled_projections=pooled, timestep=t,
                                        guidance=guidance, image_rotary_emb=cn_rope)
            return self.transformer(
                x, encoder_hidden_states=prompt_embeds, pooled_projections=pooled, timestep=t, guidance=guidance,
                image_rotary_emb=rope, controlnet_block_samples=residuals.controlnet_block_samples,
                controlnet_single_block_samples=residuals.controlnet_single_block_samples,
                controlnet_blocks_repeat=blocks_repeat).sample

        return predict

    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        prompt_2: Optional[Union[str, List[str]]] = None,
        control_image=None,
        control_mode: Optional[int] = None,
        controlnet_conditioning_scale: float = 1.0,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 28,
        guidance_scale: float = 3.5,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        prompt_embeds: Optional[torch.Tensor] = None,
        pooled_prompt_embeds: Optional[torch.Tensor] = None,
        max_sequence_length: int = 512,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Text-to-image under `control_image` through the ControlNet, its
        residuals times `controlnet_conditioning_scale`. `latents`, when
        given, are packed ([B, seq, 4 C])."""
        height = height or self.default_sample_size * self.vae_scale_factor
        width = width or self.default_sample_size * self.vae_scale_factor
        prompt_embeds, pooled, txt_ids, batch_size = self._prompt(
            prompt, prompt_2, prompt_embeds, pooled_prompt_embeds, max_sequence_length, 1)
        cond, mode = self._control_condition(control_image, control_mode, height, width, batch_size, generator)
        lh = 2 * (height // (self.vae_scale_factor * 2))
        lw = 2 * (width // (self.vae_scale_factor * 2))
        if latents is None:
            latents = self._pack_latents(torch_utils.randn_tensor(
                (batch_size, self.transformer.config.in_channels // 4, lh, lw), generator, cond.device))
        latents = latents.to(device=cond.device, dtype=torch.float32)
        state = self._schedule(latents.shape[1], num_inference_steps)
        predict = self._controlnet_predict(cond, mode, controlnet_conditioning_scale, prompt_embeds, pooled,
                                           self._guidance(batch_size, guidance_scale), txt_ids,
                                           self._prepare_latent_image_ids(lh // 2, lw // 2))
        latents = self._loop(latents, state, state.timesteps, predict)
        return self._decode(latents, height, width, output_type, return_dict)


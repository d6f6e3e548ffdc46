"""Stable Diffusion (1.x) text-to-image pipeline.

Port of `diffusers_tpu/pipelines/stable_diffusion/pipeline_stable_diffusion.py`:
one CLIP text tower whose last hidden state (after its final LayerNorm)
conditions the UNet, CFG as batch 2 (the empty prompt's embeddings first),
`num_images_per_prompt`, then the VAE decode. Where JAX scans the loop
inside one jitted program, the port runs it step by step; latents run in the
UNet's dtype, as in the SDXL pipeline. Any scheduler of the port drops in
(SD 1.5 publishes PNDM; DDIM is the usual swap).

`safety_checker` is not ported (nor in the JAX package, whose
``requires_safety_checker=False`` runs none): it is registered as
``[null, null]``, and `from_pretrained` loads a published directory's
`safety_checker` entry as None, with a warning. JAX's SD loop reads no cache
config, so `enable_cache` raises `TypeError`. `callback_on_step_end` runs the
loop of `hooks.generic_cache.denoise_loop_with_callback` and is shown
"latents", "prompt_embeds" and "guidance_scale" (`SDCFGCutoffCallback`
halves the batch mid-loop).

IP-Adapter (`loaders.ip_adapter.IPAdapterPipelineMixin`): `ip_adapter_image`
or `ip_adapter_image_embeds` conditions every UNet call, on the callback
path too, as upstream diffusers does; JAX's callback loop (`_denoise_eager`,
`:136-175`) drops the image embeds and gives the text-only result there
(ROADMAP C4, fault (h)).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from ...hooks.generic_cache import denoise_loop, denoise_loop_with_callback
from ...image_processor import VaeImageProcessor
from ...loaders.ip_adapter import IPAdapterPipelineMixin, match_batch
from ...utils import BaseOutput, torch_utils
from ..pipeline_utils import DiffusionPipeline
from ..stable_diffusion_xl.pipeline_stable_diffusion_xl import StableDiffusionXLPipeline


@dataclass
class StableDiffusionPipelineOutput(BaseOutput):
    images: Union[List, np.ndarray, torch.Tensor]


class StableDiffusionPipeline(DiffusionPipeline, IPAdapterPipelineMixin):
    _optional_components = ["safety_checker", "feature_extractor", "image_encoder"]
    _unported_components = ("safety_checker",)

    def __init__(
        self,
        vae,
        text_encoder,
        tokenizer,
        unet,
        scheduler,
        safety_checker=None,
        feature_extractor=None,
        image_encoder=None,
        requires_safety_checker: bool = False,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        if safety_checker is not None:
            raise NotImplementedError(f"{type(self).__name__}: the safety checker is not ported (the JAX package "
                                      "runs none); pass safety_checker=None")
        self.register_modules(vae=vae, text_encoder=text_encoder, tokenizer=tokenizer, unet=unet, scheduler=scheduler,
                              safety_checker=None)
        self._register_image_encoder(image_encoder, feature_extractor)
        self.register_to_config(requires_safety_checker=requires_safety_checker)
        self.vae_scale_factor = 2 ** (len(self.vae.config.block_out_channels) - 1) if vae is not None else 8
        self.image_processor = VaeImageProcessor(vae_scale_factor=self.vae_scale_factor)
        self._place(device)

    _preprocess = StableDiffusionXLPipeline._preprocess
    _encode = StableDiffusionXLPipeline._encode

    # ---------------------------------------------------------------- text
    def _embed(self, texts: List[str]) -> torch.Tensor:
        inputs = self.tokenizer(texts, padding="max_length", max_length=self.tokenizer.model_max_length,
                                truncation=True, return_tensors="np")
        ids = torch.as_tensor(np.asarray(inputs.input_ids), dtype=torch.long, device=self.unet.device)
        return self.text_encoder(ids).last_hidden_state

    @torch.no_grad()
    def encode_prompt(self, prompt, negative_prompt=None, do_classifier_free_guidance: bool = True) -> torch.Tensor:
        """[2B or B, S, D] embeddings, the negative batch first under CFG
        (the empty prompt's when no negative prompt is given)."""
        prompt = [prompt] if isinstance(prompt, str) else list(prompt)
        prompt_embeds = self._embed(prompt)
        if not do_classifier_free_guidance:
            return prompt_embeds
        if negative_prompt is None:
            negative_prompt = [""] * len(prompt)
        elif isinstance(negative_prompt, str):
            negative_prompt = [negative_prompt] * len(prompt)
        return torch.cat([self._embed(negative_prompt), prompt_embeds], dim=0)

    def _conditioning(self, prompt, negative_prompt, do_cfg: bool, num_images_per_prompt: int = 1):
        """(prompt_embeds, batch_size) with each prompt's rows repeated
        `num_images_per_prompt` times."""
        prompt_embeds = self.encode_prompt(prompt, negative_prompt, do_cfg)
        batch_size = prompt_embeds.shape[0] // (2 if do_cfg else 1) * num_images_per_prompt
        if num_images_per_prompt != 1:
            prompt_embeds = prompt_embeds.repeat_interleave(num_images_per_prompt, dim=0)
        return prompt_embeds, batch_size

    def _output(self, latents: torch.Tensor, output_type: str, return_dict: bool):
        """The final latents ("latent"), or their decode postprocessed ("np", "pil")."""
        if output_type == "latent":
            image = latents
        else:
            decoded = self.vae.decode(latents.to(self.vae.dtype) / self.vae.config.scaling_factor).sample
            image = self.image_processor.postprocess(decoded, output_type)
        if not return_dict:
            return (image,)
        return StableDiffusionPipelineOutput(images=image)

    # ------------------------------------------------------------- denoise
    def _noise(self, state, t, t_device, latents, prompt_embeds, guidance_scale, image_embeds=None, **unet_kwargs):
        """One step's noise prediction; with CFG (the embeddings hold twice
        the latents' batch, uncond first) the two halves are combined.
        `unet_kwargs` go to the UNet as they are (the adapter features)."""
        cfg = prompt_embeds.shape[0] == 2 * latents.shape[0]
        latent_input = torch.cat([latents, latents], dim=0) if cfg else latents
        latent_input = self.scheduler.scale_model_input(state, latent_input, t)
        image_embeds = match_batch(image_embeds, prompt_embeds.shape[0])
        added = {"image_embeds": image_embeds} if image_embeds is not None else None
        noise_pred = self.unet(latent_input, t_device, encoder_hidden_states=prompt_embeds, added_cond_kwargs=added,
                               **unet_kwargs).sample
        if cfg:
            uncond, text = noise_pred.chunk(2, dim=0)
            noise_pred = uncond + guidance_scale * (text - uncond)
        return noise_pred

    @torch.no_grad()
    def _denoise(self, prompt_embeds, latents, guidance_scale, num_inference_steps, image_embeds=None,
                 callback=None, **unet_kwargs):
        state = self.scheduler.set_timesteps(num_inference_steps)
        latents = latents * state.init_noise_sigma
        timesteps_device = state.timesteps.to(latents.device)
        if callback is None:
            def forward(latents, i, t):
                return self._noise(state, t, timesteps_device[i], latents, prompt_embeds, guidance_scale,
                                   image_embeds, **unet_kwargs)

            return denoise_loop(forward, self.scheduler, latents, state, state.timesteps)

        def forward_cb(latents, i, t, cb):
            return self._noise(state, t, timesteps_device[i], latents, cb["prompt_embeds"], cb["guidance_scale"],
                               image_embeds, **unet_kwargs)

        return denoise_loop_with_callback(forward_cb, self.scheduler, latents, state, state.timesteps, self, callback,
                                          {"prompt_embeds": prompt_embeds, "guidance_scale": guidance_scale})

    # ------------------------------------------------------------ __call__
    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        num_images_per_prompt: int = 1,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        prompt_embeds: Optional[torch.Tensor] = None,
        ip_adapter_image=None,
        ip_adapter_image_embeds: Optional[List[torch.Tensor]] = None,
        output_type: str = "pil",
        return_dict: bool = True,
        callback_on_step_end=None,
        callback_on_step_end_tensor_inputs: Optional[List[str]] = None,
    ):
        """Text-to-image. `output_type`: "pil", "np" (float32 NHWC in [0,
        1]) or "latent". `prompt_embeds` (the CFG batch included) stands in
        for `prompt`. `callback_on_step_end(pipe, i, t, callback_kwargs)`
        may return replacements for "latents", "prompt_embeds" and
        "guidance_scale" (`callback_on_step_end_tensor_inputs` is accepted
        for API parity; every tensor is shown)."""
        height = height or self.unet.config.sample_size * self.vae_scale_factor
        width = width or self.unet.config.sample_size * self.vae_scale_factor
        device, dtype = self.unet.device, self.unet.dtype
        do_cfg = guidance_scale > 1.0
        if prompt_embeds is None:
            prompt_embeds, batch_size = self._conditioning(prompt, negative_prompt, do_cfg, num_images_per_prompt)
        else:
            prompt_embeds = prompt_embeds.to(device)
            batch_size = prompt_embeds.shape[0] // (2 if do_cfg else 1) * num_images_per_prompt
            prompt_embeds = prompt_embeds.repeat_interleave(num_images_per_prompt, dim=0)
        shape = (batch_size, self.unet.config.in_channels, height // self.vae_scale_factor,
                 width // self.vae_scale_factor)
        if latents is None:
            latents = torch_utils.randn_tensor(shape, generator, device)
        latents = latents.to(device=device, dtype=dtype)
        image_embeds = self._image_embeds(ip_adapter_image, ip_adapter_image_embeds, batch_size, do_cfg)
        latents = self._denoise(prompt_embeds, latents, guidance_scale, num_inference_steps, image_embeds,
                                callback=callback_on_step_end)
        return self._output(latents, output_type, return_dict)

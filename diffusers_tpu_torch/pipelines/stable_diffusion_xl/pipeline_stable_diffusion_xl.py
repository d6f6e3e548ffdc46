"""SDXL text-to-image pipeline.

Port of `diffusers_tpu/pipelines/stable_diffusion_xl/pipeline_stable_diffusion_xl.py`:
dual CLIP encoders (penultimate hidden states concatenated), pooled embeds
from encoder 2, micro-conditioning time_ids, CFG as batch 2. Where JAX
compiles prep + denoise + decode into one jitted `lax.scan`, the port runs an
eager Python loop over the timesteps.

The pipeline is built on ``device`` (default ``"cuda"``; see
`DiffusionPipeline._place`). Latents run in the UNet's dtype: noise is drawn in float32 (from
`generator`), cast to the UNet's dtype, and the scheduler casts every step's
`prev_sample` back to it.

`enable_cache` honours FasterCache (with CFG), TaylorSeer, MagCache and
TextKV, as the JAX pipeline does: a step that a cache skips makes no UNet
call (FasterCache's skipped steps call it at batch 1, cond only), and
TextKV computes each cross-attention's K/V of the prompt embeddings once a
request. `callback_on_step_end` runs the loop of
`hooks.generic_cache.denoise_loop_with_callback`. The prompt conditioning,
the VAE encode of an input image and the decode are shared with the
image-conditioned pipelines (img2img, inpaint, ControlNet). Every random draw
goes through `utils.torch_utils.randn_tensor`. `from_pretrained` (the base
class's) loads it from a saved directory.

IP-Adapter (`loaders.ip_adapter.IPAdapterPipelineMixin`): after
`load_ip_adapter(path)`, `ip_adapter_image` (encoded by `image_encoder`, a
`CLIPVisionModelWithProjection`) or `ip_adapter_image_embeds` (one tensor
per adapter, the negative half first under CFG) conditions every UNet call
through ``added_cond_kwargs["image_embeds"]``. As in JAX (`:189`, `:389`),
FasterCache is not applied to a request with image embeds (it runs uncached);
TaylorSeer, MagCache and TextKV are. On the callback path the image embeds
follow the text: once a callback drops the CFG batch, the UNet gets their
positive half.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ...hooks.faster_cache import FasterCacheConfig, faster_cache_apply, faster_cache_schedules, init_faster_cache_state
from ...hooks.generic_cache import TextKVCacheConfig, denoise_loop, denoise_loop_with_callback, text_kv_cache
from ...image_processor import VaeImageProcessor
from ...loaders.ip_adapter import IPAdapterPipelineMixin, match_batch
from ...utils import BaseOutput, torch_utils
from ..pipeline_utils import DiffusionPipeline


@dataclass
class StableDiffusionXLPipelineOutput(BaseOutput):
    images: Union[List, np.ndarray, torch.Tensor]


class StableDiffusionXLPipeline(DiffusionPipeline, IPAdapterPipelineMixin):
    _optional_components = ["image_encoder", "feature_extractor"]
    _supported_cache_configs = (
        "FasterCacheConfig", "TaylorSeerCacheConfig", "MagCacheConfig", "TextKVCacheConfig",
    )

    def __init__(
        self,
        vae,
        text_encoder,
        text_encoder_2,
        tokenizer,
        tokenizer_2,
        unet,
        scheduler,
        image_encoder=None,
        feature_extractor=None,
        force_zeros_for_empty_prompt: bool = True,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        self.register_modules(
            vae=vae,
            text_encoder=text_encoder,
            text_encoder_2=text_encoder_2,
            tokenizer=tokenizer,
            tokenizer_2=tokenizer_2,
            unet=unet,
            scheduler=scheduler,
        )
        self._register_image_encoder(image_encoder, feature_extractor)
        self.register_to_config(force_zeros_for_empty_prompt=force_zeros_for_empty_prompt)
        self.vae_scale_factor = 2 ** (len(self.vae.config.block_out_channels) - 1) if vae is not None else 8
        self.default_sample_size = self.unet.config.sample_size
        self.image_processor = VaeImageProcessor(vae_scale_factor=self.vae_scale_factor)
        self._place(device)

    # ---------------------------------------------------------------- text
    @torch.no_grad()
    def encode_prompt(self, prompt, prompt_2=None, negative_prompt=None, negative_prompt_2=None, do_cfg=True):
        """Returns (prompt_embeds, negative_embeds, pooled, negative_pooled).
        As in the JAX pipeline, both towers read `prompt` (`prompt_2` and
        `negative_prompt_2` are accepted for API parity)."""
        if isinstance(prompt, str):
            prompt = [prompt]
        batch = len(prompt)
        device = self.unet.device

        def encode(texts):
            embeds_list, pooled = [], None
            for enc, tok in ((self.text_encoder, self.tokenizer), (self.text_encoder_2, self.tokenizer_2)):
                if enc is None:
                    continue
                inputs = tok(texts, padding="max_length", max_length=77, truncation=True, return_tensors="np")
                ids = torch.as_tensor(np.asarray(inputs.input_ids), dtype=torch.long, device=device)
                out = enc(ids, output_hidden_states=True)
                # penultimate hidden state (the clip_skip=None path)
                embeds_list.append(out.hidden_states[-2])
                pooled = out.text_embeds if out.text_embeds is not None else out.pooler_output
            return torch.cat(embeds_list, dim=-1), pooled

        prompt_embeds, pooled_prompt_embeds = encode(prompt)
        if not do_cfg:
            return prompt_embeds, None, pooled_prompt_embeds, None

        if negative_prompt is None and self.config.force_zeros_for_empty_prompt:
            negative_embeds = torch.zeros_like(prompt_embeds)
            negative_pooled = torch.zeros_like(pooled_prompt_embeds)
        else:
            negative_prompt = negative_prompt or ""
            if isinstance(negative_prompt, str):
                negative_prompt = [negative_prompt] * batch
            negative_embeds, negative_pooled = encode(negative_prompt)
        return prompt_embeds, negative_embeds, pooled_prompt_embeds, negative_pooled

    @staticmethod
    def _get_add_time_ids(original_size, crops_coords_top_left, target_size, batch: int, device) -> torch.Tensor:
        add_time_ids = list(original_size + crops_coords_top_left + target_size)
        return torch.tensor([add_time_ids] * batch, dtype=torch.float32, device=device)

    def _conditioning(self, prompt, prompt_2, negative_prompt, negative_prompt_2, do_cfg, original_size,
                      crops_coords_top_left, target_size, num_images_per_prompt: int = 1):
        """(prompt_embeds, add_text_embeds, add_time_ids, batch_size): with
        CFG each holds the negative batch first, then the positive one."""
        prompt_embeds, negative_embeds, pooled, negative_pooled = self.encode_prompt(
            prompt, prompt_2, negative_prompt, negative_prompt_2, do_cfg
        )
        batch_size = prompt_embeds.shape[0] * num_images_per_prompt
        add_time_ids = self._get_add_time_ids(original_size, crops_coords_top_left, target_size, batch_size,
                                              self.unet.device)
        if num_images_per_prompt != 1:
            prompt_embeds = prompt_embeds.repeat_interleave(num_images_per_prompt, dim=0)
            pooled = pooled.repeat_interleave(num_images_per_prompt, dim=0)
            if do_cfg:
                negative_embeds = negative_embeds.repeat_interleave(num_images_per_prompt, dim=0)
                negative_pooled = negative_pooled.repeat_interleave(num_images_per_prompt, dim=0)
        if not do_cfg:
            return prompt_embeds, pooled, add_time_ids, batch_size
        return (torch.cat([negative_embeds, prompt_embeds], dim=0), torch.cat([negative_pooled, pooled], dim=0),
                torch.cat([add_time_ids, add_time_ids], dim=0), batch_size)

    def _preprocess(self, image) -> torch.Tensor:
        """An input image (PIL, array or tensor; see `VaeImageProcessor.preprocess`)
        -> NCHW in [-1, 1] on the VAE's device, in its dtype."""
        return torch.from_numpy(self.image_processor.preprocess(image)).to(device=self.vae.device,
                                                                          dtype=self.vae.dtype)

    def _encode(self, image: torch.Tensor, generator: Optional[torch.Generator] = None,
                sample: bool = True) -> torch.Tensor:
        """VAE latents of a preprocessed image, scaled: the posterior's sample
        (drawn from `generator`), or its mode."""
        posterior = self.vae.encode(image)
        latents = posterior.sample(generator) if sample else posterior.mode()
        return latents * self.vae.config.scaling_factor

    def _output(self, latents: torch.Tensor, output_type: str, return_dict: bool):
        """The final latents ("latent"), or their decode postprocessed ("np", "pil")."""
        if output_type == "latent":
            image = latents
        else:
            decoded = self.vae.decode(latents.to(self.vae.dtype) / self.vae.config.scaling_factor).sample
            image = self.image_processor.postprocess(decoded, output_type)
        if not return_dict:
            return (image,)
        return StableDiffusionXLPipelineOutput(images=image)

    # ------------------------------------------------------------- denoise
    def _unet(self, latent_input, t, prompt_embeds, text_embeds, time_ids, image_embeds=None):
        cond = {"text_embeds": text_embeds, "time_ids": time_ids}
        if image_embeds is not None:
            cond["image_embeds"] = image_embeds
        return self.unet(latent_input, t, encoder_hidden_states=prompt_embeds, added_cond_kwargs=cond).sample

    def _noise(self, state, t, t_device, latents, prompt_embeds, text_embeds, time_ids, guidance_scale,
               image_embeds=None, extra=None, step=None):
        """One step's noise prediction; with CFG (the embeddings hold twice
        the latents' batch, uncond first) the two halves are combined
        (`_cfg_predict`, given `step`). `extra` (an inpainting UNet's mask
        and masked-image latents, at the CFG batch) joins the scaled latents
        on the channel axis."""
        cfg = prompt_embeds.shape[0] == 2 * latents.shape[0]
        latent_input = torch.cat([latents, latents], dim=0) if cfg else latents
        latent_input = self.scheduler.scale_model_input(state, latent_input, t)
        if extra is not None:
            latent_input = torch.cat([latent_input, extra], dim=1)

        def unet(x, embeds, text, time, image):
            return self._unet(x, t_device, embeds, text, time, image)

        return self._cfg_predict(unet, guidance_scale, cfg, step, latent_input, prompt_embeds, text_embeds, time_ids,
                                 match_batch(image_embeds, prompt_embeds.shape[0]))

    def _start(self, latents, num_inference_steps):
        """(scheduler state, scaled initial latents, the timesteps on the
        latents' device: one copy, no per-step host-to-device copy)."""
        state = self.scheduler.set_timesteps(num_inference_steps)
        return state, latents * state.init_noise_sigma, state.timesteps.to(latents.device)

    @torch.no_grad()
    def _denoise(self, prompt_embeds, add_text_embeds, add_time_ids, latents, guidance_scale,
                 num_inference_steps, do_cfg, image_embeds=None):
        scheduler = self.scheduler
        state, latents, timesteps_device = self._start(latents, num_inference_steps)
        cache_cfg = self._cache_config
        if isinstance(cache_cfg, FasterCacheConfig):
            if do_cfg and image_embeds is None:
                return self._denoise_faster_cache(prompt_embeds, add_text_embeds, add_time_ids, latents,
                                                  guidance_scale, state, timesteps_device, cache_cfg)
            cache_cfg = None  # FasterCache caches the uncond branch: not without CFG, nor with an image prompt

        def forward(latents, i, t):
            return self._noise(state, t, timesteps_device[i], latents, prompt_embeds, add_text_embeds, add_time_ids,
                               guidance_scale, image_embeds, step=(i, num_inference_steps))

        text_kv = text_kv_cache(self.unet) if isinstance(cache_cfg, TextKVCacheConfig) else contextlib.nullcontext()
        with text_kv:
            return denoise_loop(forward, scheduler, latents, state, state.timesteps, cache_cfg)

    @torch.no_grad()
    def _denoise_with_callback(self, prompt_embeds, add_text_embeds, add_time_ids, latents, guidance_scale,
                               num_inference_steps, callback, image_embeds=None):
        """The loop that fires `callback_on_step_end` after each scheduler
        step. It reads the conditioning and the guidance scale from the
        callback's tensors every step and detects CFG by batch shape, so
        `SDXLCFGCutoffCallback` halves the batch mid-loop."""
        state, latents, timesteps_device = self._start(latents, num_inference_steps)

        def forward_cb(latents, i, t, cb):
            return self._noise(state, t, timesteps_device[i], latents, cb["prompt_embeds"], cb["add_text_embeds"],
                               cb["add_time_ids"], cb["guidance_scale"], image_embeds, step=(i, num_inference_steps))

        cb_tensors = {"prompt_embeds": prompt_embeds, "add_text_embeds": add_text_embeds,
                      "add_time_ids": add_time_ids, "guidance_scale": guidance_scale}
        return denoise_loop_with_callback(forward_cb, self.scheduler, latents, state, state.timesteps, self, callback,
                                          cb_tensors, cache_cfg=self._cache_config)

    def _denoise_faster_cache(self, prompt_embeds, add_text_embeds, add_time_ids, latents, guidance_scale, state,
                              timesteps_device, cache_cfg):
        """CFG-cached denoise (FasterCache): the uncond branch runs only on
        the steps the schedule keeps; in between, the UNet runs at batch 1
        and the uncond output is rebuilt from the cached frequency deltas."""
        scheduler = self.scheduler
        skip, lf_w, hf_w = faster_cache_schedules(state.timesteps.numpy(), cache_cfg)
        b = latents.shape[0]
        cond = (prompt_embeds[b:], add_text_embeds[b:], add_time_ids[b:])
        fc = init_faster_cache_state(latents.shape, latents.device)
        for i, t in enumerate(state.timesteps):
            def full():
                li = scheduler.scale_model_input(state, torch.cat([latents, latents], dim=0), t)
                return self._unet(li, timesteps_device[i], prompt_embeds, add_text_embeds, add_time_ids)

            def cond_only():
                return self._unet(scheduler.scale_model_input(state, latents, t), timesteps_device[i], *cond)

            noise_pred, fc = faster_cache_apply(fc, bool(skip[i]), float(lf_w[i]), float(hf_w[i]), full, cond_only)
            uncond, text = noise_pred.chunk(2, dim=0)
            noise_pred = uncond + guidance_scale * (text - uncond)
            latents = scheduler.step(state, noise_pred, t, latents).prev_sample
        return latents

    # ------------------------------------------------------------ __call__
    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        prompt_2: Optional[Union[str, List[str]]] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        negative_prompt_2: Optional[Union[str, List[str]]] = None,
        num_images_per_prompt: int = 1,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        ip_adapter_image=None,
        ip_adapter_image_embeds: Optional[List[torch.Tensor]] = None,
        original_size: Optional[Tuple[int, int]] = None,
        crops_coords_top_left: Tuple[int, int] = (0, 0),
        target_size: Optional[Tuple[int, int]] = None,
        output_type: str = "pil",
        return_dict: bool = True,
        callback_on_step_end=None,
        callback_on_step_end_tensor_inputs: Optional[List[str]] = None,
    ):
        """Text-to-image. `output_type`: "pil" (uint8 quantized on the device,
        then PIL), "np" (float32 NHWC in [0, 1]), "latent" (the final
        latents). `callback_on_step_end(pipe, i, t, callback_kwargs)` is
        shown "latents", "prompt_embeds", "add_text_embeds", "add_time_ids"
        and "guidance_scale" after each step, and may return replacements
        (`callback_on_step_end_tensor_inputs` is accepted for API parity;
        every tensor is shown). It cannot be combined with a cache.
        `ip_adapter_image` / `ip_adapter_image_embeds`: the image prompt of a
        loaded IP-Adapter (see the module's docstring)."""
        height = height or self.default_sample_size * self.vae_scale_factor
        width = width or self.default_sample_size * self.vae_scale_factor
        original_size = original_size or (height, width)
        target_size = target_size or (height, width)
        device, dtype = self.unet.device, self.unet.dtype

        do_cfg = guidance_scale > 1.0
        prompt_embeds, add_text_embeds, add_time_ids, batch_size = self._conditioning(
            prompt, prompt_2, negative_prompt, negative_prompt_2, do_cfg, original_size, crops_coords_top_left,
            target_size, num_images_per_prompt,
        )
        shape = (batch_size, self.unet.config.in_channels, height // self.vae_scale_factor, width // self.vae_scale_factor)
        if latents is None:
            latents = torch_utils.randn_tensor(shape, generator, device)
        latents = latents.to(device=device, dtype=dtype)
        image_embeds = self._image_embeds(ip_adapter_image, ip_adapter_image_embeds, batch_size, do_cfg)

        if callback_on_step_end is not None:
            latents = self._denoise_with_callback(prompt_embeds, add_text_embeds, add_time_ids, latents,
                                                  guidance_scale, num_inference_steps, callback_on_step_end,
                                                  image_embeds)
        else:
            latents = self._denoise(prompt_embeds, add_text_embeds, add_time_ids, latents, guidance_scale,
                                    num_inference_steps, do_cfg, image_embeds)
        return self._output(latents, output_type, return_dict)

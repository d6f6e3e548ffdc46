"""Stable Diffusion 3 / 3.5 text-to-image pipeline.

Port of `diffusers_tpu/pipelines/stable_diffusion_3/pipeline_stable_diffusion_3.py`
(`:32-281`): the penultimate hidden states and the pooled (projected)
embeddings of both CLIP towers, the CLIP states concatenated on the feature
axis, zero-padded to T5's width and put before T5's tokens on the sequence
axis (zeros stand in for T5 when `text_encoder_3` is None), flow-match
denoise with CFG as batch 2 (`[negative, positive]`), then the VAE decode of
``z / scaling_factor + shift_factor``. Where JAX scans the loop inside one
jitted program, the port runs it step by step.

Latents stay float32; each step casts them to the transformer's dtype for
the call and its output back to float32, and the scheduler steps in float32,
as the Flux port does. The pipeline is built on ``device`` (default
``"cuda"``; see `DiffusionPipeline._place`).

`enable_cache` honours TaylorSeer, MagCache and TextKV through the generic
`denoise_loop`, FasterCache's batch-2 CFG form (a skipped step calls the
transformer at batch 1, cond only), Pyramid Attention Broadcast (the
transformer's per-block attention cache) and the single-stream
FirstBlockCache (`fbc_single_gate` inside the transformer; the last
request's decisions and ratios stay in `fbc_record`), as the JAX pipeline
does; a step a cache skips calls nothing it skips. Their state is in the
hidden stream's dtype. TextKV hoists the only loop-invariant text
computation, `context_embedder(prompt_embeds)`, out of the loop: the text
stream is modulated by the timestep inside every block. Without CFG,
FasterCache raises, as JAX's loop does. `callback_on_step_end` runs the loop
of `hooks.generic_cache.denoise_loop_with_callback`; as in JAX, the callback
sees and may replace "latents". The VAE encode of an input image and the
decode are shared with img2img and inpaint; every random draw goes through
`utils.torch_utils.randn_tensor`. `from_pretrained` (the base class's) loads
it from a saved directory, `text_encoder_3` / `tokenizer_3` optional as in
the JAX pipeline; the HTTP server loads SD3.5 Medium that way. The PAG
pipelines (`pipelines.pag`) build on it; Skip Layer Guidance is the
`guiders` package's `layers_skipped` around a transformer call.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ...hooks.faster_cache import FasterCacheConfig, faster_cache_apply, faster_cache_schedules, init_faster_cache_state
from ...hooks.first_block_cache import FirstBlockCacheConfig, init_fbc_single_state
from ...hooks.generic_cache import TextKVCacheConfig, denoise_loop, denoise_loop_with_callback
from ...hooks.pyramid_attention_broadcast import PyramidAttentionBroadcastConfig, pab_compute_mask
from ...image_processor import VaeImageProcessor
from ...utils import BaseOutput, torch_utils
from ..pipeline_utils import DiffusionPipeline


@dataclass
class StableDiffusion3PipelineOutput(BaseOutput):
    images: Union[List, np.ndarray, torch.Tensor]


class StableDiffusion3Pipeline(DiffusionPipeline):
    _optional_components = ["text_encoder_3", "tokenizer_3"]
    _supported_cache_configs = (
        "TaylorSeerCacheConfig", "MagCacheConfig", "TextKVCacheConfig", "FirstBlockCacheConfig",
        "FasterCacheConfig", "PyramidAttentionBroadcastConfig",
    )
    fbc_record = None

    def __init__(
        self,
        transformer,
        scheduler,
        vae,
        text_encoder,
        tokenizer,
        text_encoder_2,
        tokenizer_2,
        text_encoder_3=None,
        tokenizer_3=None,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        self.register_modules(
            vae=vae,
            text_encoder=text_encoder,
            text_encoder_2=text_encoder_2,
            text_encoder_3=text_encoder_3,
            tokenizer=tokenizer,
            tokenizer_2=tokenizer_2,
            tokenizer_3=tokenizer_3,
            transformer=transformer,
            scheduler=scheduler,
        )
        self.vae_scale_factor = 2 ** (len(self.vae.config.block_out_channels) - 1) if vae is not None else 8
        self.image_processor = VaeImageProcessor(vae_scale_factor=self.vae_scale_factor)
        self.default_sample_size = self.transformer.config.sample_size
        self._place(device)

    # ---------------------------------------------------------------- text
    def _ids(self, tokenizer, texts: List[str], max_length: int) -> torch.Tensor:
        inputs = tokenizer(texts, padding="max_length", max_length=max_length, truncation=True, return_tensors="np")
        return torch.as_tensor(np.asarray(inputs.input_ids), dtype=torch.long, device=self.transformer.device)

    def _clip_embeds(self, encoder, tokenizer, texts: List[str]):
        out = encoder(self._ids(tokenizer, texts, 77), output_hidden_states=True)
        pooled = out.text_embeds if out.text_embeds is not None else out.pooler_output
        return out.hidden_states[-2], pooled

    @torch.no_grad()
    def encode_prompt(self, prompt, negative_prompt=None, do_cfg=True, max_sequence_length: int = 256):
        """Returns (prompt_embeds [B, 77 + max_sequence_length, T5 width],
        negative_embeds, pooled [B, CLIP-L + CLIP-G widths], negative_pooled);
        the negatives are None without CFG."""
        if isinstance(prompt, str):
            prompt = [prompt]

        def encode(texts):
            e1, p1 = self._clip_embeds(self.text_encoder, self.tokenizer, texts)
            e2, p2 = self._clip_embeds(self.text_encoder_2, self.tokenizer_2, texts)
            clip_embeds, pooled = torch.cat([e1, e2], dim=-1), torch.cat([p1, p2], dim=-1)
            if self.text_encoder_3 is not None:
                ids = self._ids(self.tokenizer_3, texts, max_sequence_length)
                t5_embeds = self.text_encoder_3(ids).last_hidden_state
            else:
                t5_embeds = clip_embeds.new_zeros((clip_embeds.shape[0], max_sequence_length,
                                                   self.transformer.config.joint_attention_dim))
            clip_embeds = F.pad(clip_embeds, (0, t5_embeds.shape[-1] - clip_embeds.shape[-1]))
            return torch.cat([clip_embeds, t5_embeds], dim=1), pooled

        prompt_embeds, pooled = encode(prompt)
        if not do_cfg:
            return prompt_embeds, None, pooled, None
        negative_prompt = negative_prompt or ""
        if isinstance(negative_prompt, str):
            negative_prompt = [negative_prompt] * len(prompt)
        negative_embeds, negative_pooled = encode(negative_prompt)
        return prompt_embeds, negative_embeds, pooled, negative_pooled

    def _conditioning(self, prompt, negative_prompt, do_cfg, max_sequence_length, num_images_per_prompt):
        """(prompt_embeds, pooled, batch_size): with CFG each holds the negative
        batch first, then the positive one."""
        prompt_embeds, negative_embeds, pooled, negative_pooled = self.encode_prompt(
            prompt, negative_prompt, do_cfg, max_sequence_length)
        batch_size = prompt_embeds.shape[0] * num_images_per_prompt
        if num_images_per_prompt != 1:
            prompt_embeds = prompt_embeds.repeat_interleave(num_images_per_prompt, dim=0)
            pooled = pooled.repeat_interleave(num_images_per_prompt, dim=0)
            if do_cfg:
                negative_embeds = negative_embeds.repeat_interleave(num_images_per_prompt, dim=0)
                negative_pooled = negative_pooled.repeat_interleave(num_images_per_prompt, dim=0)
        if do_cfg:
            prompt_embeds = torch.cat([negative_embeds, prompt_embeds], dim=0)
            pooled = torch.cat([negative_pooled, pooled], dim=0)
        return prompt_embeds, pooled, batch_size

    # --------------------------------------------------------------- image
    def _preprocess(self, image) -> torch.Tensor:
        """An input image (PIL, array or tensor; see `VaeImageProcessor.preprocess`)
        -> NCHW in [-1, 1] on the VAE's device, in its dtype."""
        return torch.from_numpy(self.image_processor.preprocess(image)).to(device=self.vae.device,
                                                                          dtype=self.vae.dtype)

    def _encode(self, image: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Float32 latents of a preprocessed image: the posterior's sample
        (drawn from `generator`), ``(z - shift_factor) * scaling_factor``."""
        latents = self.vae.encode(image).sample(generator).float()
        if self.vae.config.get("shift_factor") is not None:
            latents = latents - self.vae.config.shift_factor
        return latents * self.vae.config.scaling_factor

    def _output(self, latents: torch.Tensor, output_type: str, return_dict: bool):
        """The final latents ("latent"), or the decode of ``z / scaling_factor
        + shift_factor`` postprocessed ("np", "pil")."""
        if output_type == "latent":
            image = latents
        else:
            z = latents / self.vae.config.scaling_factor
            if self.vae.config.get("shift_factor") is not None:
                z = z + self.vae.config.shift_factor
            image = self.image_processor.postprocess(self.vae.decode(z.to(self.vae.dtype)).sample, output_type)
        if not return_dict:
            return (image,)
        return StableDiffusion3PipelineOutput(images=image)

    # ------------------------------------------------------------- denoise
    def _forward(self, latents, t, prompt_embeds, pooled, guidance_scale, context=None, step=None, **cache):
        """One step's noise prediction in the latents' dtype, and the cache
        state the transformer returns beside it when `cache` passes one
        (FirstBlockCache, PAB). With CFG (the embeddings hold twice the
        latents' batch, uncond first) the two halves are combined
        (`_cfg_predict`, given `step`)."""
        cfg = prompt_embeds.shape[0] == 2 * latents.shape[0]
        x = torch.cat([latents, latents], dim=0) if cfg else latents
        states = []

        def transformer(x, embeds, pooled, context):
            out = self.transformer(x.to(self.transformer.dtype), embeds, pooled, t.expand(x.shape[0]),
                                   context=context, **cache)
            if cache:
                out, state = out
                states.append(state)
            return out.sample.to(latents.dtype)

        noise_pred = self._cfg_predict(transformer, guidance_scale, cfg, step, x, prompt_embeds, pooled, context)
        return noise_pred, (states[0] if cache else None)

    @torch.no_grad()
    def _denoise(self, latents, prompt_embeds, pooled, state, timesteps, guidance_scale):
        """The loop over `timesteps` (the schedule's, or the tail img2img keeps)
        honouring the cache config."""
        transformer, scheduler, cfg = self.transformer, self.scheduler, self._cache_config
        ts = timesteps.to(latents.device)  # one copy: no per-step host-to-device copy
        context = transformer.context_embedder(prompt_embeds) if isinstance(cfg, TextKVCacheConfig) else None

        def step(lat, i, noise_pred):
            return scheduler.step(state, noise_pred, timesteps[i], lat).prev_sample

        if isinstance(cfg, FasterCacheConfig) and prompt_embeds.shape[0] == 2 * latents.shape[0]:
            skip, lf_w, hf_w = faster_cache_schedules(timesteps.numpy(), cfg)
            b = latents.shape[0]
            fc = init_faster_cache_state(latents.shape, latents.device)
            for i in range(len(timesteps)):
                def full():
                    x = torch.cat([latents, latents], dim=0).to(transformer.dtype)
                    return transformer(x, prompt_embeds, pooled, ts[i].expand(2 * b)).sample.to(latents.dtype)

                def cond_only():
                    return self._forward(latents, ts[i], prompt_embeds[b:], pooled[b:], guidance_scale)[0]

                noise_pred, fc = faster_cache_apply(fc, bool(skip[i]), float(lf_w[i]), float(hf_w[i]), full, cond_only)
                uncond, text = noise_pred.chunk(2, dim=0)
                latents = step(latents, i, uncond + guidance_scale * (text - uncond))
            return latents

        if isinstance(cfg, (FirstBlockCacheConfig, PyramidAttentionBroadcastConfig)):
            p, dtype = transformer.config.patch_size, transformer.dtype
            batch, tokens = prompt_embeds.shape[0], (latents.shape[2] // p) * (latents.shape[3] // p)
            if isinstance(cfg, FirstBlockCacheConfig):
                cache = dict(fbc_state=init_fbc_single_state((batch, tokens, transformer.inner_dim), dtype,
                                                             latents.device), fbc_config=cfg)
            else:
                mask = pab_compute_mask(timesteps.numpy(), cfg.spatial_attention_block_skip_range,
                                        cfg.spatial_attention_timestep_skip_range)
                cache = dict(pab_cache=transformer.init_pab_cache(batch, tokens, prompt_embeds.shape[1], dtype,
                                                                  latents.device))
            for i in range(len(timesteps)):
                if "pab_cache" in cache:
                    cache["pab_compute"] = bool(mask[i])
                noise_pred, new_state = self._forward(latents, ts[i], prompt_embeds, pooled, guidance_scale, **cache)
                cache["fbc_state" if "fbc_state" in cache else "pab_cache"] = new_state
                latents = step(latents, i, noise_pred)
            if "fbc_state" in cache:
                self.fbc_record = {"decisions": cache["fbc_state"].decisions, "ratios": cache["fbc_state"].ratios}
            return latents

        def forward(lat, i, t):
            return self._forward(lat, ts[i], prompt_embeds, pooled, guidance_scale, context=context,
                                 step=(i, len(timesteps)))[0]

        return denoise_loop(forward, scheduler, latents, state, timesteps, cfg)

    @torch.no_grad()
    def _denoise_with_callback(self, latents, prompt_embeds, pooled, state, guidance_scale, callback):
        """The loop that fires `callback_on_step_end(pipe, i, t, {"latents": ...})`
        after each scheduler step."""
        ts = state.timesteps.to(latents.device)

        def forward_cb(lat, i, t, cb):
            return self._forward(lat, ts[i], prompt_embeds, pooled, guidance_scale, step=(i, len(ts)))[0]

        return denoise_loop_with_callback(forward_cb, self.scheduler, latents, state, state.timesteps, self,
                                          callback, {}, cache_cfg=self._cache_config)

    # ------------------------------------------------------------ __call__
    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 28,
        guidance_scale: float = 7.0,
        num_images_per_prompt: int = 1,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        max_sequence_length: int = 256,
        output_type: str = "pil",
        return_dict: bool = True,
        callback_on_step_end=None,
        callback_on_step_end_tensor_inputs: Optional[List[str]] = None,
    ):
        """Text-to-image. `output_type`: "pil" (uint8 quantized on the device,
        then PIL), "np" (float32 NHWC in [0, 1]), "latent" (the final
        latents). `callback_on_step_end(pipe, i, t, callback_kwargs)` is shown
        "latents" after each step and may return a replacement
        (`callback_on_step_end_tensor_inputs` is accepted for API parity). It
        cannot be combined with a cache."""
        height = height or self.default_sample_size * self.vae_scale_factor
        width = width or self.default_sample_size * self.vae_scale_factor
        device = self.transformer.device
        do_cfg = guidance_scale > 1.0
        prompt_embeds, pooled, batch_size = self._conditioning(prompt, negative_prompt, do_cfg, max_sequence_length,
                                                               num_images_per_prompt)
        shape = (batch_size, self.transformer.config.in_channels, height // self.vae_scale_factor,
                 width // self.vae_scale_factor)
        if latents is None:
            latents = torch_utils.randn_tensor(shape, generator, device)
        latents = latents.to(device=device, dtype=torch.float32)

        state = self.scheduler.set_timesteps(num_inference_steps)
        if callback_on_step_end is not None:
            latents = self._denoise_with_callback(latents, prompt_embeds, pooled, state, guidance_scale,
                                                  callback_on_step_end)
        else:
            latents = self._denoise(latents, prompt_embeds, pooled, state, state.timesteps, guidance_scale)
        return self._output(latents, output_type, return_dict)

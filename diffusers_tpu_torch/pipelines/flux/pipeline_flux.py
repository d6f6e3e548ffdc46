"""Flux text-to-image pipeline.

Port of `diffusers_tpu/pipelines/flux/pipeline_flux.py` (`FluxPipeline`):
CLIP pooled embeds plus T5 last hidden states, 2x2-packed latents with their
position ids, the resolution-dependent mu shift of the flow-match schedule,
distilled guidance fed to the transformer (no CFG batch), an eager Python
denoise loop, then unpack, VAE decode (``z / scaling + shift``) and
postprocess. Where JAX scans the loop inside one jitted program, the port
runs it step by step.

Latents stay float32; each step casts them to the prompt embeddings' dtype
for the transformer, casts its output back to float32, and the scheduler
steps in float32 (`pipeline_flux.py`'s `forward`). The pipeline is built on
``device`` (default ``"cuda"``; see `DiffusionPipeline._place`).

`enable_cache` honours TaylorSeer, FirstBlockCache, Pyramid Attention
Broadcast, MagCache and TextKV, as the JAX pipeline does. Where JAX's
FirstBlockCache, PAB and MagCache branches feed the float32 latents to the
transformer and keep their state in the latents' dtype, the port casts the
latents to the prompt embeddings' dtype, as its plain branch does, and keeps
the state in that dtype, the hidden stream's (a bf16 Linear takes no
float32 input); on the CPU both are float32. TextKV hoists the only
loop-invariant text computation, `context_embedder(prompt_embeds)`, out of
the loop: the text stream is modulated by the timestep inside every block.
The last FirstBlockCache request's per-step decisions and relative changes
stay in `fbc_record`. `callback_on_step_end` runs the loop of
`hooks.generic_cache.denoise_loop_with_callback`. `from_pretrained` (the
base class's) loads it from a saved directory, the transformer w8a8 on load
with ``quantization_config=PipelineQuantizationConfig(quant_mapping=
{"transformer": Int8DynamicActConfig()})``.

The image-conditioned Flux pipelines (`pipeline_flux_img2img.py` and its
siblings) subclass this one and share its helpers: `_prompt` (encode or take
the embeds, repeat per image), `_schedule` (the mu-shifted sigmas),
`_strength_timesteps`, `_preprocess` and `_encode_image` (the VAE posterior's
sample or mode, ``(z - shift_factor) * scaling_factor``), `_guidance`,
`_rope`, `_loop` (an eager step loop with an optional per-step blend) and
`_decode`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from ...hooks.first_block_cache import FirstBlockCacheConfig, flux_forward_with_fbc, init_fbc_state
from ...hooks.generic_cache import TextKVCacheConfig, denoise_loop, denoise_loop_with_callback
from ...hooks.mag_cache import MagCacheConfig, flux_forward_with_magcache, init_mag_cache_state, mag_cache_compute_mask
from ...hooks.pyramid_attention_broadcast import PyramidAttentionBroadcastConfig, pab_compute_mask
from ...hooks.taylorseer import TaylorSeerCacheConfig
from ...image_processor import VaeImageProcessor, numpy_to_pil, postprocess_np, postprocess_uint8
from ...schedulers.scheduling_flow_match_euler_discrete import calculate_shift
from ...utils import BaseOutput, torch_utils
from ..inpaint_utils import as_mask_array, check_strength_and_schedule, prepare_packed_mask, repeat_to_batch
from ..pipeline_utils import DiffusionPipeline


@dataclass
class FluxPipelineOutput(BaseOutput):
    images: Union[List, np.ndarray, torch.Tensor]


class FluxPipeline(DiffusionPipeline):
    _optional_components = ["image_encoder", "feature_extractor"]
    _supported_cache_configs = (
        "TaylorSeerCacheConfig", "FirstBlockCacheConfig", "PyramidAttentionBroadcastConfig",
        "MagCacheConfig", "TextKVCacheConfig",
    )
    fbc_record = None

    def __init__(
        self,
        scheduler,
        vae,
        text_encoder,
        tokenizer,
        text_encoder_2,
        tokenizer_2,
        transformer,
        image_encoder=None,
        feature_extractor=None,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        self.register_modules(
            vae=vae,
            text_encoder=text_encoder,
            text_encoder_2=text_encoder_2,
            tokenizer=tokenizer,
            tokenizer_2=tokenizer_2,
            transformer=transformer,
            scheduler=scheduler,
        )
        # registered and never read, as in JAX (which has no Flux IP-Adapter)
        self.register_modules(image_encoder=image_encoder, feature_extractor=feature_extractor)
        self.vae_scale_factor = 2 ** (len(self.vae.config.block_out_channels) - 1) if vae is not None else 8
        self.image_processor = VaeImageProcessor(vae_scale_factor=self.vae_scale_factor * 2)
        self.tokenizer_max_length = 77
        self.default_sample_size = 128
        self._place(device)

    # ---------------------------------------------------------------- text
    def _ids(self, tokenizer, prompt: List[str], max_length: int) -> torch.Tensor:
        inputs = tokenizer(prompt, padding="max_length", max_length=max_length, truncation=True, return_tensors="np")
        return torch.as_tensor(np.asarray(inputs.input_ids), dtype=torch.long, device=self.text_encoder.device)

    @torch.no_grad()
    def encode_prompt(self, prompt, prompt_2=None, max_sequence_length: int = 512):
        """Returns (prompt_embeds [B, S, D] from T5, pooled [B, D] from CLIP,
        txt_ids [S, 3] zeros)."""
        prompt = [prompt] if isinstance(prompt, str) else prompt
        prompt_2 = prompt_2 or prompt
        prompt_2 = [prompt_2] if isinstance(prompt_2, str) else prompt_2
        pooled = self.text_encoder(self._ids(self.tokenizer, prompt, self.tokenizer_max_length)).pooler_output
        prompt_embeds = self.text_encoder_2(self._ids(self.tokenizer_2, prompt_2, max_sequence_length)).last_hidden_state
        txt_ids = np.zeros((prompt_embeds.shape[1], 3), dtype=np.float32)
        return prompt_embeds, pooled, txt_ids

    # ------------------------------------------------------------- latents
    @staticmethod
    def _prepare_latent_image_ids(height: int, width: int) -> np.ndarray:
        ids = np.zeros((height, width, 3), dtype=np.float32)
        ids[..., 1] += np.arange(height)[:, None]
        ids[..., 2] += np.arange(width)[None, :]
        return ids.reshape(height * width, 3)

    @staticmethod
    def _pack_latents(latents: torch.Tensor) -> torch.Tensor:
        b, c, h, w = latents.shape
        latents = latents.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5)
        return latents.reshape(b, (h // 2) * (w // 2), c * 4)

    @staticmethod
    def _unpack_latents(latents: torch.Tensor, height: int, width: int, vae_scale_factor: int) -> torch.Tensor:
        b, _, channels = latents.shape
        h = 2 * (int(height) // (vae_scale_factor * 2))
        w = 2 * (int(width) // (vae_scale_factor * 2))
        latents = latents.reshape(b, h // 2, w // 2, channels // 4, 2, 2).permute(0, 3, 1, 4, 2, 5)
        return latents.reshape(b, channels // 4, h, w)

    # ------------------------------------------------------------- helpers
    def _prompt(self, prompt, prompt_2, prompt_embeds, pooled_prompt_embeds, max_sequence_length: int,
                num_images_per_prompt: int):
        """(prompt_embeds, pooled, txt_ids, batch_size): encoded unless both
        embeds are given, each row repeated `num_images_per_prompt` times."""
        if prompt_embeds is None or pooled_prompt_embeds is None:
            prompt_embeds, pooled_prompt_embeds, txt_ids = self.encode_prompt(prompt, prompt_2, max_sequence_length)
        else:
            txt_ids = np.zeros((prompt_embeds.shape[1], 3), dtype=np.float32)
        if num_images_per_prompt != 1:
            prompt_embeds = prompt_embeds.repeat_interleave(num_images_per_prompt, dim=0)
            pooled_prompt_embeds = pooled_prompt_embeds.repeat_interleave(num_images_per_prompt, dim=0)
        return prompt_embeds, pooled_prompt_embeds, txt_ids, prompt_embeds.shape[0]

    def _schedule(self, image_seq_len: int, num_inference_steps: int):
        """The scheduler state: linear sigmas from 1 to 1 / steps, shifted by
        the mu of `image_seq_len` where the scheduler shifts dynamically."""
        config = self.scheduler.config
        if not config.use_dynamic_shifting:
            return self.scheduler.set_timesteps(num_inference_steps)
        sigmas = np.linspace(1.0, 1.0 / num_inference_steps, num_inference_steps)
        mu = calculate_shift(image_seq_len, config.get("base_image_seq_len", 256),
                             config.get("max_image_seq_len", 4096), config.get("base_shift", 0.5),
                             config.get("max_shift", 1.15))
        return self.scheduler.set_timesteps(sigmas=list(sigmas), mu=mu)

    @staticmethod
    def _strength_timesteps(state, num_inference_steps: int, strength: float) -> torch.Tensor:
        """The tail of the schedule that `strength` keeps; raises when it is
        empty or `strength` is outside [0, 1]."""
        init_timestep = min(int(num_inference_steps * strength), num_inference_steps)
        timesteps = state.timesteps[max(num_inference_steps - init_timestep, 0):]
        check_strength_and_schedule(strength, timesteps)
        return timesteps

    def _guidance(self, batch_size: int, guidance_scale: float):
        """The distilled guidance [B] for a transformer with guidance embeds, else None."""
        if not self.transformer.config.guidance_embeds:
            return None
        return torch.full((batch_size,), guidance_scale, dtype=torch.float32, device=self.transformer.device)

    def _rope(self, *ids):
        """RoPE (cos, sin) of the concatenated position ids, made on the host
        in float64 (FluxPosEmbed), on the transformer's device."""
        cos, sin = self.transformer.pos_embed(np.concatenate(ids, axis=0))
        return cos.to(self.transformer.device), sin.to(self.transformer.device)

    def _preprocess(self, image, height=None, width=None) -> torch.Tensor:
        """An input image (PIL, array or tensor; `VaeImageProcessor.preprocess`)
        -> NCHW in [-1, 1] on the VAE's device, in its dtype."""
        return torch.from_numpy(self.image_processor.preprocess(image, height, width)).to(
            device=self.vae.device, dtype=self.vae.dtype)

    def _encode_image(self, image: torch.Tensor, generator=None, sample: bool = True) -> torch.Tensor:
        """Float32 latents of a preprocessed image: the posterior's sample
        (drawn from `generator`) or, with ``sample=False``, its mode, then
        ``(z - shift_factor) * scaling_factor``."""
        posterior = self.vae.encode(image)
        latents = (posterior.sample(generator) if sample else posterior.mode()).float()
        if self.vae.config.get("shift_factor") is not None:
            latents = latents - self.vae.config.shift_factor
        return latents * self.vae.config.scaling_factor

    def _image_latents(self, image, generator, batch_size, height=None, width=None, sample: bool = True):
        """(packed clean latents of `image`, their latent size, the image's
        size): the posterior's sample (or mode), repeated up to `batch_size`."""
        pixels = self._preprocess(image, height, width)
        return (*self._packed_latents(pixels, generator, batch_size, sample), tuple(pixels.shape[2:]))

    def _packed_latents(self, pixels: torch.Tensor, generator, batch_size: int, sample: bool = True):
        """(packed latents, latent size) of a preprocessed image."""
        latents = repeat_to_batch(self._encode_image(pixels, generator, sample), batch_size, what="image")
        return self._pack_latents(latents), tuple(latents.shape[2:])

    def _noised(self, packed, strength: float, num_inference_steps: int, generator):
        """(scheduler state, kept timesteps, noise, noised latents): the
        schedule of `packed`'s token count, the tail `strength` keeps, and
        `scale_noise` of the clean latents at its first timestep."""
        state = self._schedule(packed.shape[1], num_inference_steps)
        timesteps = self._strength_timesteps(state, num_inference_steps, strength)
        noise = torch_utils.randn_tensor(packed.shape, generator, packed.device)
        return state, timesteps, noise, self.scheduler.scale_noise(state, packed, timesteps[:1], noise)

    def _predict(self, prompt_embeds, pooled, guidance, rope, **kwargs):
        """predict(latents, i, t) of `_loop`: the transformer on the latents
        in the embeds' dtype (`kwargs` go to the transformer)."""
        return lambda latents, i, t: self.transformer(
            latents.to(prompt_embeds.dtype), encoder_hidden_states=prompt_embeds, pooled_projections=pooled,
            timestep=t, guidance=guidance, image_rotary_emb=rope, **kwargs).sample

    @torch.no_grad()
    def _loop(self, latents, state, timesteps, predict, blend=None):
        """The eager denoise loop of the image-conditioned pipelines:
        ``predict(latents, i, t_model)`` is step i's noise prediction (t_model
        = t / 1000 on the device, one per row), the scheduler steps in
        float32, and ``blend(latents, i)``, when given, runs after each step."""
        t_model = (timesteps / 1000.0).to(latents.device)
        for i, t in enumerate(timesteps):
            noise_pred = predict(latents, i, t_model[i].expand(latents.shape[0]))
            latents = self.scheduler.step(state, noise_pred.to(latents.dtype), t, latents).prev_sample
            if blend is not None:
                latents = blend(latents, i)
        return latents

    def _packed_mask(self, mask_image, batch_size: int, packed, lh: int, lw: int) -> torch.Tensor:
        """The binarized pixel mask at the latent size (`lh` x `lw`), over the
        latent channels, packed like `packed`, on its device."""
        return prepare_packed_mask(as_mask_array(mask_image), batch_size, packed.shape[2] // 4, lh, lw,
                                   self._pack_latents).to(packed.device)

    def _inpaint_blend(self, state, timesteps, image_latents, noise, mask):
        """The blend after step i: outside the mask (1 where repainted), the
        clean latents noised to the next step's timestep, after the last step
        the clean latents (JAX `pipeline_flux_inpaint.py`)."""
        n = len(timesteps)

        def blend(latents, i):
            proper = (self.scheduler.scale_noise(state, image_latents, timesteps[i + 1:i + 2], noise) if i + 1 < n
                      else image_latents)
            return (1.0 - mask) * proper + mask * latents

        return blend

    def _decode(self, latents, height: int, width: int, output_type: str, return_dict: bool):
        """The final packed latents ("latent"), or their VAE decode of ``z /
        scaling_factor + shift_factor`` (tiled where the VAE has tiling on),
        postprocessed ("np", "pil")."""
        if output_type == "latent":
            image = latents
        else:
            z = self._unpack_latents(latents, height, width, self.vae_scale_factor) / self.vae.config.scaling_factor
            if self.vae.config.get("shift_factor") is not None:
                z = z + self.vae.config.shift_factor
            z = z.to(self.vae.dtype)
            # JAX `:444-447`: a VAE with tiling on decodes 512 px tiles, bounding the decode's memory to one tile's
            decoded = (self.vae.tiled_decode(z) if self.vae.use_tiling else self.vae.decode(z)).sample
            if output_type == "np":
                image = postprocess_np(decoded)
            elif output_type == "pil":
                image = numpy_to_pil(postprocess_uint8(decoded))
            else:
                raise ValueError(f"unsupported output_type {output_type!r}; choose 'pil', 'np' or 'latent'")
        if not return_dict:
            return (image,)
        return FluxPipelineOutput(images=image)

    # ------------------------------------------------------------- denoise
    @torch.no_grad()
    def _denoise(self, latents, prompt_embeds, pooled_prompt_embeds, rope, state, guidance, schedule=None):
        """The denoise loop over `schedule` (default: the whole of
        `state.timesteps`; img2img passes the tail its strength keeps) under
        the pipeline's cache config."""
        transformer, scheduler = self.transformer, self.scheduler
        schedule = state.timesteps if schedule is None else schedule
        # the timestep fed to the transformer, t / 1000, divided on the host
        # (a true f32 division, as in JAX) and moved to the card once
        timesteps = (schedule / 1000.0).to(latents.device)
        batch, dtype = latents.shape[0], prompt_embeds.dtype
        cfg = self._cache_config
        context = transformer.context_embedder(prompt_embeds) if isinstance(cfg, TextKVCacheConfig) else None
        cond = dict(encoder_hidden_states=prompt_embeds, pooled_projections=pooled_prompt_embeds,
                    guidance=guidance, image_rotary_emb=rope, context=context)

        def forward(latents, i, t):
            return transformer(latents.to(dtype), timestep=timesteps[i].expand(batch), **cond).sample.to(latents.dtype)

        if cfg is None or isinstance(cfg, (TextKVCacheConfig, TaylorSeerCacheConfig)):
            return denoise_loop(forward, scheduler, latents, state, schedule, cfg)

        def loop(cached_forward, cache):
            """The loop of the model-internal caches: cached_forward(latents
            in the hidden dtype, timestep, i, cache) -> (sample, cache)."""
            lat = latents
            for i, t in enumerate(schedule):
                noise_pred, cache = cached_forward(lat.to(dtype), timesteps[i].expand(batch), i, cache)
                lat = scheduler.step(state, noise_pred.to(lat.dtype), t, lat).prev_sample
            return lat, cache

        # their state is in the hidden stream's dtype
        inner, img_seq, txt_seq = transformer.inner_dim, latents.shape[1], prompt_embeds.shape[1]
        hidden_shape, context_shape = (batch, img_seq, inner), (batch, txt_seq, inner)
        if isinstance(cfg, FirstBlockCacheConfig):
            latents, fbc = loop(
                lambda x, ts, i, st: flux_forward_with_fbc(transformer, st, cfg, x, timestep=ts, **cond),
                init_fbc_state(hidden_shape, context_shape, dtype, latents.device))
            self.fbc_record = {"decisions": fbc.decisions, "ratios": fbc.ratios}
            return latents

        if isinstance(cfg, PyramidAttentionBroadcastConfig):
            mask = pab_compute_mask(schedule.numpy(), cfg.spatial_attention_block_skip_range,
                                    cfg.spatial_attention_timestep_skip_range)
            n_dual, n_single = len(transformer.transformer_blocks), len(transformer.single_transformer_blocks)
            pab_cache = {
                "dual_attn": torch.zeros((n_dual, *hidden_shape), dtype=dtype, device=latents.device),
                "dual_ctx": torch.zeros((n_dual, *context_shape), dtype=dtype, device=latents.device),
                "single_attn": torch.zeros((n_single, batch, txt_seq + img_seq, inner), dtype=dtype,
                                           device=latents.device),
            }
            return loop(lambda x, ts, i, c: transformer(x, timestep=ts, pab_compute=bool(mask[i]), pab_cache=c, **cond),
                        pab_cache)[0]

        if isinstance(cfg, MagCacheConfig):
            num_steps = int(schedule.shape[0])
            if cfg.num_inference_steps != num_steps:
                cfg = dataclasses.replace(cfg, num_inference_steps=num_steps)
            mask = mag_cache_compute_mask(cfg)

            def magcache(x, ts, i, st):
                return flux_forward_with_magcache(transformer, st, bool(mask[i]), x, timestep=ts, **cond)

            return loop(magcache, init_mag_cache_state(hidden_shape, context_shape, dtype, latents.device))[0]

        raise ValueError(f"FluxPipeline does not support cache config {type(cfg).__name__}")

    @torch.no_grad()
    def _denoise_with_callback(self, latents, prompt_embeds, pooled_prompt_embeds, rope, state, guidance, callback):
        """The loop that fires `callback_on_step_end` after each scheduler
        step; the transformer reads "prompt_embeds", "pooled_prompt_embeds"
        and "guidance" from the callback's tensors every step."""
        timesteps = (state.timesteps / 1000.0).to(latents.device)

        def forward_cb(latents, i, t, cb):
            pe = cb["prompt_embeds"]
            return self.transformer(
                latents.to(pe.dtype), encoder_hidden_states=pe, pooled_projections=cb["pooled_prompt_embeds"],
                timestep=timesteps[i].expand(latents.shape[0]), guidance=cb.get("guidance"), image_rotary_emb=rope,
            ).sample.to(latents.dtype)

        cb_tensors = {"prompt_embeds": prompt_embeds, "pooled_prompt_embeds": pooled_prompt_embeds,
                      "guidance": guidance}
        return denoise_loop_with_callback(forward_cb, self.scheduler, latents, state, state.timesteps, self,
                                          callback, cb_tensors, cache_cfg=self._cache_config)

    # ------------------------------------------------------------ __call__
    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        prompt_2: Optional[Union[str, List[str]]] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 28,
        guidance_scale: float = 3.5,
        num_images_per_prompt: int = 1,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        prompt_embeds: Optional[torch.Tensor] = None,
        pooled_prompt_embeds: Optional[torch.Tensor] = None,
        max_sequence_length: int = 512,
        output_type: str = "pil",
        return_dict: bool = True,
        callback_on_step_end=None,
        callback_on_step_end_tensor_inputs: Optional[List[str]] = None,
    ):
        """Text-to-image. `latents`, when given, are packed ([B, seq, 4 C]).
        `output_type`: "pil" (uint8 quantized on the device, then PIL), "np"
        (float32 NHWC in [0, 1]), "latent" (the final packed latents).
        `callback_on_step_end(pipe, i, t, callback_kwargs)` is shown
        "latents", "prompt_embeds", "pooled_prompt_embeds" and "guidance"
        after each step and may return replacements
        (`callback_on_step_end_tensor_inputs` is accepted for API parity). It
        cannot be combined with a cache."""
        height = height or self.default_sample_size * self.vae_scale_factor
        width = width or self.default_sample_size * self.vae_scale_factor
        device = self.transformer.device

        prompt_embeds, pooled_prompt_embeds, txt_ids, batch_size = self._prompt(
            prompt, prompt_2, prompt_embeds, pooled_prompt_embeds, max_sequence_length, num_images_per_prompt)

        # latents (packed 2x2 patches), float32
        num_channels_latents = self.transformer.config.in_channels // 4
        lh = 2 * (height // (self.vae_scale_factor * 2))
        lw = 2 * (width // (self.vae_scale_factor * 2))
        if latents is None:
            noise_device = generator.device if generator is not None else device
            latents = torch.randn((batch_size, num_channels_latents, lh, lw), generator=generator,
                                  device=noise_device, dtype=torch.float32)
            latents = self._pack_latents(latents)
        latents = latents.to(device=device, dtype=torch.float32)
        img_ids = self._prepare_latent_image_ids(lh // 2, lw // 2)

        rope = self._rope(txt_ids, img_ids)
        # timestep schedule with the resolution-dependent mu shift
        state = self._schedule(latents.shape[1], num_inference_steps)
        guidance = self._guidance(batch_size, guidance_scale)

        if callback_on_step_end is not None:
            latents = self._denoise_with_callback(latents, prompt_embeds, pooled_prompt_embeds, rope, state, guidance,
                                                  callback_on_step_end)
        else:
            latents = self._denoise(latents, prompt_embeds, pooled_prompt_embeds, rope, state, guidance)

        return self._decode(latents, height, width, output_type, return_dict)

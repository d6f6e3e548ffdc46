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
{"transformer": Int8DynamicActConfig()})``. img2img, inpaint, fill and
kontext wait.
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
from ...image_processor import numpy_to_pil, postprocess_np, postprocess_uint8
from ...schedulers.scheduling_flow_match_euler_discrete import calculate_shift
from ...utils import BaseOutput
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
        if image_encoder is not None or feature_extractor is not None:
            raise NotImplementedError("FluxPipeline: image_encoder / feature_extractor (Flux's IP-Adapter) are not "
                                      "ported yet (ROADMAP A4.1)")
        self.register_modules(image_encoder=None, feature_extractor=None)
        self.vae_scale_factor = 2 ** (len(self.vae.config.block_out_channels) - 1) if vae is not None else 8
        self.tokenizer_max_length = 77
        self.default_sample_size = 128
        self._place(device)

    # ---------------------------------------------------------------- text
    def _ids(self, tokenizer, prompt: List[str], max_length: int) -> torch.Tensor:
        inputs = tokenizer(prompt, padding="max_length", max_length=max_length, truncation=True, return_tensors="np")
        return torch.as_tensor(np.asarray(inputs.input_ids), dtype=torch.long, device=self.transformer.device)

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

    # ------------------------------------------------------------- denoise
    @torch.no_grad()
    def _denoise(self, latents, prompt_embeds, pooled_prompt_embeds, rope, state, guidance):
        transformer, scheduler = self.transformer, self.scheduler
        # the timestep fed to the transformer, t / 1000, divided on the host
        # (a true f32 division, as in JAX) and moved to the card once
        timesteps = (state.timesteps / 1000.0).to(latents.device)
        batch, dtype = latents.shape[0], prompt_embeds.dtype
        cfg = self._cache_config
        context = transformer.context_embedder(prompt_embeds) if isinstance(cfg, TextKVCacheConfig) else None
        cond = dict(encoder_hidden_states=prompt_embeds, pooled_projections=pooled_prompt_embeds,
                    guidance=guidance, image_rotary_emb=rope, context=context)

        def forward(latents, i, t):
            return transformer(latents.to(dtype), timestep=timesteps[i].expand(batch), **cond).sample.to(latents.dtype)

        if cfg is None or isinstance(cfg, (TextKVCacheConfig, TaylorSeerCacheConfig)):
            return denoise_loop(forward, scheduler, latents, state, state.timesteps, cfg)

        def loop(cached_forward, cache):
            """The loop of the model-internal caches: cached_forward(latents
            in the hidden dtype, timestep, i, cache) -> (sample, cache)."""
            lat = latents
            for i, t in enumerate(state.timesteps):
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
            mask = pab_compute_mask(state.timesteps.numpy(), cfg.spatial_attention_block_skip_range,
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
            num_steps = int(state.timesteps.shape[0])
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

        if prompt_embeds is None or pooled_prompt_embeds is None:
            prompt_embeds, pooled_prompt_embeds, txt_ids = self.encode_prompt(prompt, prompt_2, max_sequence_length)
        else:
            txt_ids = np.zeros((prompt_embeds.shape[1], 3), dtype=np.float32)
        batch_size = prompt_embeds.shape[0] * num_images_per_prompt
        if num_images_per_prompt != 1:
            prompt_embeds = prompt_embeds.repeat_interleave(num_images_per_prompt, dim=0)
            pooled_prompt_embeds = pooled_prompt_embeds.repeat_interleave(num_images_per_prompt, dim=0)

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

        # RoPE tables: host float64 (FluxPosEmbed), one copy to the device
        cos, sin = self.transformer.pos_embed(np.concatenate([txt_ids, img_ids], axis=0))
        rope = (cos.to(device), sin.to(device))

        # timestep schedule with the resolution-dependent mu shift
        config = self.scheduler.config
        sigmas = np.linspace(1.0, 1.0 / num_inference_steps, num_inference_steps)
        mu = calculate_shift(latents.shape[1], config.get("base_image_seq_len", 256),
                             config.get("max_image_seq_len", 4096), config.get("base_shift", 0.5),
                             config.get("max_shift", 1.15))
        if config.use_dynamic_shifting:
            state = self.scheduler.set_timesteps(sigmas=list(sigmas), mu=mu)
        else:
            state = self.scheduler.set_timesteps(num_inference_steps)

        guidance = None
        if self.transformer.config.guidance_embeds:
            guidance = torch.full((batch_size,), guidance_scale, dtype=torch.float32, device=device)

        if callback_on_step_end is not None:
            latents = self._denoise_with_callback(latents, prompt_embeds, pooled_prompt_embeds, rope, state, guidance,
                                                  callback_on_step_end)
        else:
            latents = self._denoise(latents, prompt_embeds, pooled_prompt_embeds, rope, state, guidance)

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

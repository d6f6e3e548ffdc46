"""LTX-Video text-to-video pipeline.

Port of `diffusers_tpu/pipelines/ltx/pipeline_ltx.py`: T5 prompt encoding at
128 tokens (the embeddings past each prompt's length zeroed, the mask kept
for the cross attention), packed ``[B, F' H' W', C]`` video tokens
(`_pack_latents` / `_unpack_latents`, `_normalize_latents` /
`_denormalize_latents` `:75-102`), CFG as one batch-2 transformer call a step
(``[negative, positive]``) with ``guidance_rescale`` (`rescale_noise_cfg`),
the flow-match schedule shifted by `calculate_shift`'s mu of the token count
where the scheduler shifts dynamically (`:300-311`), then the latents
de-normalized with the VAE's ``latents_mean`` / ``latents_std`` buffers and
decoded whole; a timestep-conditioned VAE decodes at ``decode_timestep``
from latents noised by ``decode_noise_scale`` (`:340-357`). Frames come out
as float32 ``[B, F, H, W, C]`` in [0, 1] ("np") or as the final packed
latents ("latent"). Where JAX scans the loop in one jitted program, the
port runs it step by step; the RoPE tables are made once a request.

`enable_cache` honours the six configs of JAX's `_supported_cache_configs`
(`:104-107`): TaylorSeer and MagCache through the generic `denoise_loop`;
TextKV, which makes the caption projection once a request and each cross
attention's K/V once per context (`text_kv_cache`); FirstBlockCache and
PAB over the batch-2 CFG forward, as JAX runs them (one state; the last
request's decisions and ratios in `fbc_record`); FasterCache on the CFG
pair, its frequency split over each frame's ``[H', W']`` token plane (a
skipped step makes the cond call alone, without the rescale, as in JAX).
FasterCache without CFG raises, as JAX's loop does. `callback_on_step_end`
runs the loop of `hooks.generic_cache.denoise_loop_with_callback`, shown
"latents" after each step (JAX's generic callback). Every random draw goes
through `utils.torch_utils.randn_tensor`: the latents, then the decode's
noise, then the decoder's injected noise. The pipeline is built on
``device`` (default ``"cuda"``; see `DiffusionPipeline._place`).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from ...guiders.guider_utils import rescale_noise_cfg
from ...hooks.faster_cache import FasterCacheConfig, denoise_loop_faster_cache
from ...hooks.first_block_cache import FirstBlockCacheConfig, init_fbc_single_state
from ...hooks.generic_cache import TextKVCacheConfig, denoise_loop, denoise_loop_with_callback, text_kv_cache
from ...hooks.pyramid_attention_broadcast import PyramidAttentionBroadcastConfig, pab_compute_mask
from ...schedulers.scheduling_flow_match_euler_discrete import calculate_shift
from ...utils import BaseOutput, torch_utils
from ..pipeline_utils import DiffusionPipeline


@dataclass
class LTXPipelineOutput(BaseOutput):
    frames: Union[np.ndarray, torch.Tensor]


class LTXPipeline(DiffusionPipeline):
    _supported_cache_configs = (
        "TaylorSeerCacheConfig", "MagCacheConfig", "TextKVCacheConfig", "FirstBlockCacheConfig",
        "FasterCacheConfig", "PyramidAttentionBroadcastConfig",
    )
    fbc_record = None

    def __init__(self, scheduler, vae, text_encoder, tokenizer, transformer,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.register_modules(vae=vae, text_encoder=text_encoder, tokenizer=tokenizer, transformer=transformer,
                              scheduler=scheduler)
        self.vae_spatial_compression_ratio = vae.spatial_compression_ratio if vae is not None else 32
        self.vae_temporal_compression_ratio = vae.temporal_compression_ratio if vae is not None else 8
        self.transformer_spatial_patch_size = transformer.config.patch_size if transformer is not None else 1
        self.transformer_temporal_patch_size = transformer.config.patch_size_t if transformer is not None else 1
        self._place(device)

    # ---------------------------------------------------------------- text
    def _get_t5_prompt_embeds(self, prompt: List[str], max_sequence_length: int = 128):
        inputs = self.tokenizer(prompt, padding="max_length", max_length=max_sequence_length, truncation=True,
                                return_tensors="np")
        device = self.text_encoder.device
        ids = torch.as_tensor(np.asarray(inputs.input_ids), dtype=torch.long, device=device)
        mask = (torch.as_tensor(np.asarray(inputs.attention_mask), dtype=torch.long, device=device)
                if hasattr(inputs, "attention_mask") else (ids != 0).long())
        embeds = self.text_encoder(ids, attention_mask=mask).last_hidden_state
        return embeds * mask[..., None].to(embeds.dtype), mask

    @torch.no_grad()
    def encode_prompt(self, prompt, negative_prompt=None, do_cfg: bool = True, max_sequence_length: int = 128):
        """(embeds, mask, negative embeds, negative mask); the negative pair
        is None without CFG. The negative prompt defaults to ``""``."""
        prompt = [prompt] if isinstance(prompt, str) else prompt
        embeds, mask = self._get_t5_prompt_embeds(prompt, max_sequence_length)
        if not do_cfg:
            return embeds, mask, None, None
        negative_prompt = negative_prompt or ""
        if isinstance(negative_prompt, str):
            negative_prompt = [negative_prompt] * len(prompt)
        return (embeds, mask, *self._get_t5_prompt_embeds(negative_prompt, max_sequence_length))

    def _prompt(self, prompt, negative_prompt, do_cfg: bool, max_sequence_length: int, prompt_embeds=None,
                prompt_attention_mask=None, negative_prompt_embeds=None, negative_prompt_attention_mask=None):
        """(embeds, mask, batch size): under CFG the pair ``[negative, positive]``."""
        if prompt_embeds is None:
            prompt_embeds, prompt_attention_mask, negative_prompt_embeds, negative_prompt_attention_mask = (
                self.encode_prompt(prompt, negative_prompt, do_cfg, max_sequence_length))
        if do_cfg:
            return (torch.cat([negative_prompt_embeds, prompt_embeds]),
                    torch.cat([negative_prompt_attention_mask, prompt_attention_mask]), prompt_embeds.shape[0])
        return prompt_embeds, prompt_attention_mask, prompt_embeds.shape[0]

    # ------------------------------------------------------------- latents
    @staticmethod
    def _pack_latents(latents: torch.Tensor, patch_size: int = 1, patch_size_t: int = 1) -> torch.Tensor:
        b, c, f, h, w = latents.shape
        latents = latents.reshape(b, c, f // patch_size_t, patch_size_t, h // patch_size, patch_size,
                                  w // patch_size, patch_size).permute(0, 2, 4, 6, 1, 3, 5, 7)
        return latents.reshape(b, (f // patch_size_t) * (h // patch_size) * (w // patch_size), -1)

    @staticmethod
    def _unpack_latents(latents, num_frames, height, width, patch_size: int = 1, patch_size_t: int = 1):
        b = latents.shape[0]
        latents = latents.reshape(b, num_frames, height, width, -1, patch_size_t, patch_size, patch_size)
        latents = latents.permute(0, 4, 1, 5, 2, 6, 3, 7)
        return latents.reshape(b, latents.shape[1], num_frames * patch_size_t, height * patch_size,
                               width * patch_size)

    @staticmethod
    def _denormalize_latents(latents, latents_mean, latents_std, scaling_factor: float = 1.0):
        mean = latents_mean.reshape(1, -1, 1, 1, 1).to(latents)
        std = latents_std.reshape(1, -1, 1, 1, 1).to(latents)
        return latents * std / scaling_factor + mean

    @staticmethod
    def _normalize_latents(latents, latents_mean, latents_std, scaling_factor: float = 1.0):
        mean = latents_mean.reshape(1, -1, 1, 1, 1).to(latents)
        std = latents_std.reshape(1, -1, 1, 1, 1).to(latents)
        return (latents - mean) * scaling_factor / std

    def _latent_grid(self, height: int, width: int, num_frames: int):
        """(latent frames, latent height, latent width) of a request."""
        return ((num_frames - 1) // self.vae_temporal_compression_ratio + 1,
                height // self.vae_spatial_compression_ratio, width // self.vae_spatial_compression_ratio)

    def _rope(self, latent_frames: int, latent_height: int, latent_width: int, frame_rate: float):
        """(cos, sin) [1, S, D] of the token grid, made once a request."""
        p, pt = self.transformer_spatial_patch_size, self.transformer_temporal_patch_size
        scale = (self.vae_temporal_compression_ratio / frame_rate, self.vae_spatial_compression_ratio,
                 self.vae_spatial_compression_ratio)
        return self.transformer.rotary_emb(1, latent_frames // pt, latent_height // p, latent_width // p, scale,
                                           self.transformer.device)

    def _schedule(self, video_seq_len: int, num_inference_steps: int):
        config = self.scheduler.config
        if not config.get("use_dynamic_shifting", False):
            return self.scheduler.set_timesteps(num_inference_steps)
        sigmas = np.linspace(1.0, 1.0 / num_inference_steps, num_inference_steps)
        mu = calculate_shift(video_seq_len, config.get("base_image_seq_len", 256),
                             config.get("max_image_seq_len", 4096), config.get("base_shift", 0.5),
                             config.get("max_shift", 1.15))
        return self.scheduler.set_timesteps(sigmas=list(sigmas), mu=mu)

    @staticmethod
    def _guide(noise_pred, do_cfg: bool, guidance_scale: float, guidance_rescale: float):
        """The CFG combination of a batch-2 prediction (uncond first), rescaled
        when `guidance_rescale` > 0."""
        if not do_cfg:
            return noise_pred
        uncond, text = noise_pred.chunk(2)
        guided = uncond + guidance_scale * (text - uncond)
        return rescale_noise_cfg(guided, text, guidance_rescale) if guidance_rescale > 0 else guided

    # ------------------------------------------------------------- denoise
    @torch.no_grad()
    def _denoise(self, latents, embeds, mask, rope, state, guidance_scale, guidance_rescale, do_cfg, latent_grid,
                 callback=None):
        """The loop over the schedule of `state`, honouring the cache config."""
        transformer, scheduler, cfg = self.transformer, self.scheduler, self._cache_config
        timesteps = state.timesteps
        ts = timesteps.to(latents.device)
        dtype = embeds.dtype

        def call(lat, i, pe, m, **extra):
            out = transformer(lat.to(dtype), pe, ts[i].expand(lat.shape[0]), encoder_attention_mask=m,
                              image_rotary_emb=rope, **extra)
            return (out[0].sample.float(), out[1]) if isinstance(out, tuple) else (out.sample.float(), None)

        def cfg_input(lat):
            return torch.cat([lat, lat]) if do_cfg else lat

        if callback is not None:
            def forward_cb(lat, i, t, cb):
                return self._guide(call(cfg_input(lat), i, embeds, mask)[0], do_cfg, guidance_scale,
                                   guidance_rescale)

            return denoise_loop_with_callback(forward_cb, scheduler, latents, state, timesteps, self, callback, {},
                                              cache_cfg=cfg)

        if isinstance(cfg, FasterCacheConfig) and do_cfg:
            b = latents.shape[0]
            f, h, w = latent_grid
            c = latents.shape[-1]

            def fwd(lat, i, half):
                rows = slice(0, b) if half == 0 else slice(b, 2 * b)
                return call(lat, i, embeds[rows], mask[rows])[0]

            return denoise_loop_faster_cache(
                lambda lat, i, t: (fwd(lat, i, 0), fwd(lat, i, 1)), lambda lat, i, t: fwd(lat, i, 1),
                lambda uncond, cond: uncond + guidance_scale * (cond - uncond), scheduler, latents, state, timesteps,
                cfg,
                # tokens -> [B, F C, H, W] so the frequency split runs over each frame's plane
                reshape_in=lambda x: x.reshape(x.shape[0], f, h, w, c).permute(0, 1, 4, 2, 3).reshape(
                    x.shape[0], f * c, h, w),
                reshape_out=lambda x: x.reshape(x.shape[0], f, c, h, w).permute(0, 1, 3, 4, 2).reshape(
                    x.shape[0], f * h * w, c))

        if isinstance(cfg, (FirstBlockCacheConfig, PyramidAttentionBroadcastConfig)):
            b, tokens = latents.shape[0] * (2 if do_cfg else 1), latents.shape[1]
            if isinstance(cfg, FirstBlockCacheConfig):
                extra = dict(fbc_state=init_fbc_single_state((b, tokens, transformer.inner_dim), dtype,
                                                             latents.device), fbc_config=cfg)
                key = "fbc_state"
            else:
                pab_mask = pab_compute_mask(timesteps.numpy(), cfg.spatial_attention_block_skip_range,
                                            cfg.spatial_attention_timestep_skip_range)
                extra = dict(pab_cache=transformer.init_pab_cache(b, tokens, dtype, latents.device))
                key = "pab_cache"
            for i, t in enumerate(timesteps):
                if key == "pab_cache":
                    extra["pab_compute"] = bool(pab_mask[i])
                noise_pred, extra[key] = call(cfg_input(latents), i, embeds, mask, **extra)
                noise_pred = self._guide(noise_pred, do_cfg, guidance_scale, guidance_rescale)
                latents = scheduler.step(state, noise_pred, t, latents).prev_sample
            if key == "fbc_state":
                self.fbc_record = {"decisions": extra[key].decisions, "ratios": extra[key].ratios}
            return latents

        text_kv = isinstance(cfg, TextKVCacheConfig)
        context = transformer.text_context(embeds) if text_kv else None

        def forward(lat, i, t):
            kwargs = dict(context=context) if text_kv else {}
            return self._guide(call(cfg_input(lat), i, embeds, mask, **kwargs)[0], do_cfg, guidance_scale,
                               guidance_rescale)

        with text_kv_cache(transformer) if text_kv else contextlib.nullcontext():
            return denoise_loop(forward, scheduler, latents, state, timesteps, cfg)

    @torch.no_grad()
    def _decode(self, latents, latent_grid, generator, decode_timestep: float, decode_noise_scale, output_type: str,
                return_dict: bool):
        """The final packed latents ("latent"), or the VAE's decode of the
        de-normalized latents as float32 frames [B, F, H, W, C] in [0, 1]."""
        if output_type == "latent":
            video = latents
        else:
            p, pt = self.transformer_spatial_patch_size, self.transformer_temporal_patch_size
            f, h, w = latent_grid
            video = self._unpack_latents(latents, f // pt, h // p, w // p, p, pt)
            video = self.decode_latents(video, generator, decode_timestep, decode_noise_scale)
        if not return_dict:
            return (video,)
        return LTXPipelineOutput(frames=video)

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor, generator=None, decode_timestep: float = 0.0,
                       decode_noise_scale: Optional[float] = None) -> np.ndarray:
        """Normalized latents [B, C, F', H', W'] -> float32 frames [B, F, H, W, C]
        in [0, 1]: de-normalized, then (a timestep-conditioned VAE) noised by
        ``decode_noise_scale`` (default `decode_timestep`) and decoded at
        `decode_timestep`."""
        vae = self.vae
        latents = self._denormalize_latents(latents.float(), vae.latents_mean, vae.latents_std,
                                            vae.config.scaling_factor)
        return self.decode_video(latents, generator, decode_timestep, decode_noise_scale)

    @torch.no_grad()
    def decode_video(self, latents: torch.Tensor, generator=None, decode_timestep: float = 0.0,
                     decode_noise_scale: Optional[float] = None) -> np.ndarray:
        """`decode_latents` of de-normalized latents."""
        vae = self.vae
        latents = latents.float()
        temb = None
        if vae.config.timestep_conditioning:
            noise = torch_utils.randn_tensor(latents.shape, generator, latents.device)
            scale = decode_timestep if decode_noise_scale is None else decode_noise_scale
            latents = (1 - scale) * latents + scale * noise
            temb = torch.full((latents.shape[0],), decode_timestep, dtype=vae.dtype, device=latents.device)
        video = vae.decode(latents.to(vae.dtype), temb, generator=generator).sample
        return (video.float() / 2 + 0.5).clamp(0, 1).permute(0, 2, 3, 4, 1).cpu().numpy()

    # ------------------------------------------------------------ __call__
    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        height: int = 512,
        width: int = 704,
        num_frames: int = 161,
        frame_rate: int = 25,
        num_inference_steps: int = 50,
        guidance_scale: float = 3.0,
        guidance_rescale: float = 0.0,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        prompt_embeds: Optional[torch.Tensor] = None,
        prompt_attention_mask: Optional[torch.Tensor] = None,
        negative_prompt_embeds: Optional[torch.Tensor] = None,
        negative_prompt_attention_mask: Optional[torch.Tensor] = None,
        decode_timestep: float = 0.0,
        decode_noise_scale: Optional[float] = None,
        max_sequence_length: int = 128,
        output_type: str = "np",
        return_dict: bool = True,
        callback_on_step_end=None,
        callback_on_step_end_tensor_inputs: Optional[List[str]] = None,
    ):
        """Text-to-video. `latents`, when given, are packed ([B, S, C]).
        `callback_on_step_end(pipe, i, t, {"latents": ...})` may return new
        latents (`callback_on_step_end_tensor_inputs` is accepted for API
        parity); it cannot be combined with a cache."""
        device = self.transformer.device
        do_cfg = guidance_scale > 1.0
        embeds, mask, batch_size = self._prompt(prompt, negative_prompt, do_cfg, max_sequence_length, prompt_embeds,
                                                prompt_attention_mask, negative_prompt_embeds,
                                                negative_prompt_attention_mask)
        grid = self._latent_grid(height, width, num_frames)
        if latents is None:
            shape = (batch_size, self.transformer.config.in_channels, *grid)
            latents = self._pack_latents(torch_utils.randn_tensor(shape, generator, device),
                                         self.transformer_spatial_patch_size, self.transformer_temporal_patch_size)
        latents = latents.to(device=device, dtype=torch.float32)
        rope = self._rope(*grid, frame_rate)
        state = self._schedule(latents.shape[1], num_inference_steps)
        p, pt = self.transformer_spatial_patch_size, self.transformer_temporal_patch_size
        token_grid = (grid[0] // pt, grid[1] // p, grid[2] // p)
        latents = self._denoise(latents, embeds, mask, rope, state, guidance_scale, guidance_rescale, do_cfg,
                                token_grid, callback=callback_on_step_end)
        return self._decode(latents, grid, generator, decode_timestep, decode_noise_scale, output_type, return_dict)

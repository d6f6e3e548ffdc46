"""Wan 2.1 text-to-video pipeline.

Port of `diffusers_tpu/pipelines/wan/pipeline_wan.py` (`WanPipeline` `:32`):
UMT5 text encoding with the embeddings past each prompt's length zeroed,
flow-prediction denoising over [B, 16, 1 + (F - 1) / 4, H / 8, W / 8]
latents with CFG as two batch-1 transformer calls a step (cond, then
uncond), de-normalisation with the VAE's per-channel `latents_mean` /
`latents_std`, and the VAE's causal decode. Frames come out as [B, F, H, W,
C] in [0, 1] ("np") or as the final latents ("latent"). Where JAX scans the
loop inside one jitted program, the port runs it step by step.

`max_sequence_length` defaults to 512, upstream diffusers' default and
Wan's trained text length; JAX's `__call__` defaults to 226. Wan's cross
attention has no mask, so the zeroed padding counts and the two lengths give
different videos (ROADMAP C).

Latents stay float32; each call casts them to the transformer's dtype and
its output back, and UniPC steps in float32. `enable_cache` honours the six
configs JAX's pipeline does: TaylorSeer and MagCache through the generic
`denoise_loop`; TextKV, which makes the text embedder's output once a
request and each cross attention's K/V once per context (cond and uncond);
FirstBlockCache and PAB with separate cond and uncond states (JAX
`:90-111`, `:146-176`; the last request's decisions and ratios of each
stream stay in `fbc_record`); FasterCache's pair form (a skipped step makes
the cond call alone). Without CFG, FasterCache leaves the loop dense, as in
JAX. `callback_on_step_end` runs the loop of
`hooks.generic_cache.denoise_loop_with_callback` and shows the callback
"latents", "prompt_embeds", "negative_prompt_embeds" and "guidance_scale".
FreeInit (`enable_free_init`) runs the loop once a pass. Every random draw
goes through `utils.torch_utils.randn_tensor`. The pipeline is built on
``device`` (default ``"cuda"``; see `DiffusionPipeline._place`).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from ...hooks.faster_cache import FasterCacheConfig, denoise_loop_faster_cache
from ...hooks.first_block_cache import FirstBlockCacheConfig, init_fbc_single_state
from ...hooks.generic_cache import TextKVCacheConfig, denoise_loop, denoise_loop_with_callback, text_kv_cache
from ...hooks.pyramid_attention_broadcast import PyramidAttentionBroadcastConfig, pab_compute_mask
from ...utils import BaseOutput, torch_utils
from ..free_init_utils import FreeInitMixin
from ..pipeline_utils import DiffusionPipeline


@dataclass
class WanPipelineOutput(BaseOutput):
    frames: Union[np.ndarray, torch.Tensor]


class WanPipeline(DiffusionPipeline, FreeInitMixin):
    _supported_cache_configs = (
        "TaylorSeerCacheConfig", "MagCacheConfig", "TextKVCacheConfig", "FirstBlockCacheConfig",
        "FasterCacheConfig", "PyramidAttentionBroadcastConfig",
    )
    fbc_record = None

    def __init__(self, tokenizer, text_encoder, transformer, vae, scheduler, device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.register_modules(vae=vae, text_encoder=text_encoder, tokenizer=tokenizer, transformer=transformer,
                              scheduler=scheduler)
        self.vae_scale_factor_temporal = vae.config.scale_factor_temporal if vae is not None else 4
        self.vae_scale_factor_spatial = vae.config.scale_factor_spatial if vae is not None else 8
        self._place(device)

    # ---------------------------------------------------------------- text
    def _get_t5_prompt_embeds(self, prompt: List[str], max_sequence_length: int) -> torch.Tensor:
        inputs = self.tokenizer(prompt, padding="max_length", max_length=max_sequence_length, truncation=True,
                                return_tensors="np")
        device = self.text_encoder.device
        ids = torch.as_tensor(np.asarray(inputs.input_ids), dtype=torch.long, device=device)
        mask = (torch.as_tensor(np.asarray(inputs.attention_mask), device=device)
                if hasattr(inputs, "attention_mask") else (ids != 0).long())
        embeds = self.text_encoder(ids, attention_mask=mask).last_hidden_state
        return embeds * mask[..., None].to(embeds.dtype)  # zero the positions past each prompt's length

    @torch.no_grad()
    def encode_prompt(self, prompt, negative_prompt=None, do_cfg: bool = True, max_sequence_length: int = 512):
        """(prompt_embeds [B, max_sequence_length, d_model], negative_embeds or None without CFG)."""
        if isinstance(prompt, str):
            prompt = [prompt]
        prompt_embeds = self._get_t5_prompt_embeds(prompt, max_sequence_length)
        if not do_cfg:
            return prompt_embeds, None
        negative_prompt = negative_prompt or ""
        if isinstance(negative_prompt, str):
            negative_prompt = [negative_prompt] * len(prompt)
        return prompt_embeds, self._get_t5_prompt_embeds(negative_prompt, max_sequence_length)

    # ------------------------------------------------------------- denoise
    def _predict(self, latents, t, embeds, rope, context=None, **cache):
        """One transformer call: the float32 prediction (and the cache state
        the transformer returns beside it when `cache` passes one)."""
        out = self.transformer(latents.to(self.transformer.dtype), t.expand(latents.shape[0]), embeds,
                               rotary_emb=rope, context=context, **cache)
        out, state = out if cache else (out, None)
        return out.sample.float(), state

    @torch.no_grad()
    def _denoise(self, latents, prompt_embeds, negative_embeds, rope, state, guidance_scale):
        """The loop over the schedule of `state`, honouring the cache config."""
        transformer, scheduler, cfg = self.transformer, self.scheduler, self._cache_config
        timesteps = state.timesteps
        ts = timesteps.to(latents.device)  # one copy: no per-step host-to-device copy
        do_cfg = negative_embeds is not None

        def combine(uncond, cond):
            return uncond + guidance_scale * (cond - uncond)

        if isinstance(cfg, FasterCacheConfig) and do_cfg:
            def fwd(lat, i, embeds):
                return self._predict(lat, ts[i], embeds, rope)[0]

            return denoise_loop_faster_cache(
                lambda lat, i, t: (fwd(lat, i, negative_embeds), fwd(lat, i, prompt_embeds)),
                lambda lat, i, t: fwd(lat, i, prompt_embeds), combine, scheduler, latents, state, timesteps, cfg)

        if isinstance(cfg, (FirstBlockCacheConfig, PyramidAttentionBroadcastConfig)):
            p_t, p_h, p_w = transformer.config.patch_size
            b, _, f, h, w = latents.shape
            tokens, dtype = (f // p_t) * (h // p_h) * (w // p_w), transformer.dtype
            if isinstance(cfg, FirstBlockCacheConfig):
                states = [dict(fbc_state=init_fbc_single_state((b, tokens, transformer.inner_dim), dtype,
                                                               latents.device), fbc_config=cfg)
                          for _ in range(1 + do_cfg)]
            else:
                mask = pab_compute_mask(timesteps.numpy(), cfg.spatial_attention_block_skip_range,
                                        cfg.spatial_attention_timestep_skip_range)
                states = [dict(pab_cache=transformer.init_pab_cache(b, tokens, dtype, latents.device))
                          for _ in range(1 + do_cfg)]
            key = "fbc_state" if isinstance(cfg, FirstBlockCacheConfig) else "pab_cache"
            for i, t in enumerate(timesteps):
                preds = []
                for cache, embeds in zip(states, (prompt_embeds, negative_embeds)):  # cond, then uncond
                    if key == "pab_cache":
                        cache["pab_compute"] = bool(mask[i])
                    pred, cache[key] = self._predict(latents, ts[i], embeds, rope, **cache)
                    preds.append(pred)
                noise_pred = combine(preds[1], preds[0]) if do_cfg else preds[0]
                latents = scheduler.step(state, noise_pred, t, latents).prev_sample
            if key == "fbc_state":
                self.fbc_record = {name: {"decisions": s["fbc_state"].decisions, "ratios": s["fbc_state"].ratios}
                                   for name, s in zip(("cond", "uncond"), states)}
            return latents

        text_kv = isinstance(cfg, TextKVCacheConfig)
        contexts = [transformer.text_context(e) if text_kv and e is not None else None
                    for e in (prompt_embeds, negative_embeds)]

        def forward(lat, i, t):
            cond = self._predict(lat, ts[i], prompt_embeds, rope, contexts[0])[0]
            if not do_cfg:
                return cond
            return combine(self._predict(lat, ts[i], negative_embeds, rope, contexts[1])[0], cond)

        generic = None if isinstance(cfg, FasterCacheConfig) else cfg  # FasterCache without CFG: dense
        with text_kv_cache(transformer) if text_kv else contextlib.nullcontext():
            return denoise_loop(forward, scheduler, latents, state, timesteps, generic)

    @torch.no_grad()
    def _denoise_with_callback(self, latents, prompt_embeds, negative_embeds, rope, state, guidance_scale, callback):
        """The loop that fires `callback_on_step_end(pipe, i, t, kwargs)` after
        each scheduler step; the conditioning is read from `kwargs` each step."""
        ts = state.timesteps.to(latents.device)

        def forward_cb(lat, i, t, cb):
            cond = self._predict(lat, ts[i], cb["prompt_embeds"], rope)[0]
            if cb.get("negative_prompt_embeds") is None:
                return cond
            uncond = self._predict(lat, ts[i], cb["negative_prompt_embeds"], rope)[0]
            return uncond + cb["guidance_scale"] * (cond - uncond)

        cb_tensors = {"prompt_embeds": prompt_embeds, "negative_prompt_embeds": negative_embeds,
                      "guidance_scale": guidance_scale}
        return denoise_loop_with_callback(forward_cb, self.scheduler, latents, state, state.timesteps, self,
                                          callback, cb_tensors, cache_cfg=self._cache_config)

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> np.ndarray:
        """Final latents -> float32 frames [B, F, H, W, C] in [0, 1]: de-normalised
        with the VAE's `latents_mean` / `latents_std` when it has them, then
        the VAE's chunked decode."""
        lm, ls = self.vae.config.get("latents_mean"), self.vae.config.get("latents_std")
        if lm is not None and ls is not None:  # latents / (1 / std) + mean
            latents = (latents * torch.tensor(ls, device=latents.device).reshape(1, -1, 1, 1, 1)
                       + torch.tensor(lm, device=latents.device).reshape(1, -1, 1, 1, 1))
        video = self.vae.decode(latents.to(self.vae.dtype)).sample
        return (video.float() / 2 + 0.5).clamp(0, 1).permute(0, 2, 3, 4, 1).cpu().numpy()

    # ------------------------------------------------------------ __call__
    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        height: int = 480,
        width: int = 832,
        num_frames: int = 81,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        max_sequence_length: int = 512,
        output_type: str = "np",
        return_dict: bool = True,
        callback_on_step_end=None,
        callback_on_step_end_tensor_inputs: Optional[List[str]] = None,
    ):
        """Text-to-video. `output_type`: "np" (float32 frames [B, F, H, W, C] in
        [0, 1]) or "latent" (the final latents). `callback_on_step_end(pipe,
        i, t, callback_kwargs)` may return replacements for what it is shown
        (`callback_on_step_end_tensor_inputs` is accepted for API parity); it
        cannot be combined with a cache."""
        device = self.transformer.device
        do_cfg = guidance_scale > 1.0
        prompt_embeds, negative_embeds = self.encode_prompt(prompt, negative_prompt, do_cfg, max_sequence_length)
        frames = (num_frames - 1) // self.vae_scale_factor_temporal + 1
        shape = (prompt_embeds.shape[0], self.transformer.config.in_channels, frames,
                 height // self.vae_scale_factor_spatial, width // self.vae_scale_factor_spatial)
        if latents is None:
            latents = torch_utils.randn_tensor(shape, generator, device)
        latents = latents.to(device=device, dtype=torch.float32)
        rope = self.transformer.rotary_tables(latents)

        initial_noise = latents
        for it, steps in self._free_init_iterations(num_inference_steps):
            if it > 0:
                latents = self._free_init_reinit_latents(latents, initial_noise, generator)
            state = self.scheduler.set_timesteps(steps)
            if callback_on_step_end is not None:
                latents = self._denoise_with_callback(latents, prompt_embeds, negative_embeds, rope, state,
                                                      guidance_scale, callback_on_step_end)
            else:
                latents = self._denoise(latents, prompt_embeds, negative_embeds, rope, state, guidance_scale)

        video = latents if output_type == "latent" else self.decode_latents(latents)
        if not return_dict:
            return (video,)
        return WanPipelineOutput(frames=video)

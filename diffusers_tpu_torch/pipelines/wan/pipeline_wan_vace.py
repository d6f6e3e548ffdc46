"""Wan-VACE all-in-one video creation and editing pipeline.

Port of `diffusers_tpu/pipelines/wan/pipeline_wan_vace.py` (`WanVACEPipeline`
`:38`): the conditioning video is split into its inactive `video * (1 -
mask)` and reactive `video * mask` halves, each VAE-encoded chunk by chunk
(`mode()`) and normalised with the VAE's `latents_mean` / `latents_std`; the
mask is folded space-to-depth into (VAE spatial scale)² channels and
resized along frames to the latent frame count by nearest-exact indices
floor((i + 0.5) F / F') (`prepare_control_latents` `:78-106`). The control
latents [inactive | reactive | mask] ride every transformer call, scaled per
VACE layer by `conditioning_scale` (a float or one per layer). UMT5 text
conditioning as `WanPipeline`'s; CFG as one batch-2 call a step (uncond,
then cond), then a scheduler step in float32; the VAE decode as
`WanPipeline`'s. The VAE's scale factors come from its `dim_mult` and
`temperal_downsample`, as in JAX.

Inputs: `video` [B, 3, F, H, W] in [-1, 1] and `mask` [B, 1, F, H, W] in [0,
1] (arrays or tensors); without them, a zero video and an all-ones mask (pure
text-to-video). F must be 1 + 4 k frames (the chunked encode's rule).

Where the port differs from JAX (ROADMAP C3/C4): `max_sequence_length`
defaults to 512, as `WanPipeline` (JAX: 226; the port equals JAX at 226);
with `num_videos_per_prompt` > 1 the port repeats each prompt's embeddings
once per video, as upstream does; JAX never repeats them, and its cross
attention then spreads one prompt's text rows over several videos.
Upstream's `reference_images` is not ported (nor in JAX). Every random draw
goes through `utils.torch_utils.randn_tensor`; the pipeline is built on
``device`` (default ``"cuda"``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ...utils import torch_utils
from ..pipeline_utils import DiffusionPipeline
from .pipeline_wan import WanPipeline, WanPipelineOutput


def _as_video(x, device) -> torch.Tensor:
    x = x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x, np.float32))
    return x.to(device=device, dtype=torch.float32)


def nearest_indices(n_in: int, n_out: int) -> np.ndarray:
    """Nearest-exact resize indices along one axis, floor((i + 0.5) * n_in /
    n_out), in float32 as JAX computes them (VACE's mask frames,
    `jax.image.resize`'s "nearest" for Animate's replace mask)."""
    i = np.arange(n_out, dtype=np.float32)
    return np.floor((i + np.float32(0.5)) * np.float32(n_in) / np.float32(n_out)).astype(np.int64)


class WanVACEPipeline(DiffusionPipeline):
    _supported_cache_configs = ()  # JAX's VACE loop reads no cache config

    def __init__(self, tokenizer, text_encoder, transformer, vae, scheduler,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.register_modules(tokenizer=tokenizer, text_encoder=text_encoder, transformer=transformer, vae=vae,
                              scheduler=scheduler)
        cfg = vae.config if vae is not None else {}
        self.vae_scale_factor_spatial = 2 ** (len(cfg.get("dim_mult", (1, 2, 4, 4))) - 1)
        self.vae_scale_factor_temporal = 2 ** sum(bool(b) for b in cfg.get("temperal_downsample", (False, True, True)))
        self._place(device)

    _get_t5_prompt_embeds = WanPipeline._get_t5_prompt_embeds
    encode_prompt = WanPipeline.encode_prompt
    decode_latents = WanPipeline.decode_latents

    def _normalize(self, latents: torch.Tensor) -> torch.Tensor:
        lm, ls = self.vae.config.get("latents_mean"), self.vae.config.get("latents_std")
        if lm is None or ls is None:
            return latents
        mean = torch.tensor(lm, device=latents.device).reshape(1, -1, 1, 1, 1)
        std = torch.tensor(ls, device=latents.device).reshape(1, -1, 1, 1, 1)
        return (latents - mean) / std

    @torch.no_grad()
    def prepare_control_latents(self, video: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """[B, 2 z + s², F', H / s, W / s] float32: the normalised latents of
        the inactive and the reactive video, then the space-to-depth mask
        resized to the F' latent frames."""
        vae = self.vae
        lat_inactive = self._normalize(vae.encode((video * (1 - mask)).to(vae.dtype)).mode().float())
        lat_reactive = self._normalize(vae.encode((video * mask).to(vae.dtype)).mode().float())
        b, _, f, h, w = mask.shape
        s, p = self.vae_scale_factor_spatial, self.transformer.config.patch_size[1]
        lf = lat_inactive.shape[2]  # the encoder's own causal frame count
        nh, nw = h // (s * p) * p, w // (s * p) * p
        m = mask[:, 0].reshape(b, f, nh, s, nw, s).permute(0, 3, 5, 1, 2, 4).reshape(b, s * s, f, nh, nw)
        m = m[:, :, torch.from_numpy(nearest_indices(f, lf)).to(m.device)]
        return torch.cat([lat_inactive, lat_reactive, m], dim=1)

    def _predict(self, latents, t, embeds, control, scale, rope) -> torch.Tensor:
        tr = self.transformer
        out = tr(latents.to(tr.dtype), t.expand(latents.shape[0]), embeds, control_hidden_states=control.to(tr.dtype),
                 control_hidden_states_scale=scale, rotary_emb=rope)
        return out.sample.float()

    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        video=None,
        mask=None,
        conditioning_scale: Union[float, Sequence[float]] = 1.0,
        height: int = 480,
        width: int = 832,
        num_frames: int = 81,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        num_videos_per_prompt: int = 1,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        max_sequence_length: int = 512,
        output_type: str = "np",
        return_dict: bool = True,
    ):
        """Video generation under VACE control. `output_type`: "np" (float32
        frames [B, F, H, W, C] in [0, 1]) or "latent"."""
        device = self.transformer.device
        do_cfg = guidance_scale > 1.0
        prompt_embeds, negative_embeds = self.encode_prompt(prompt, negative_prompt, do_cfg, max_sequence_length)
        prompt_embeds = prompt_embeds.repeat_interleave(num_videos_per_prompt, dim=0)
        batch_size = prompt_embeds.shape[0]
        if do_cfg:
            prompt_embeds = torch.cat([negative_embeds.repeat_interleave(num_videos_per_prompt, dim=0),
                                       prompt_embeds], dim=0)

        video = (torch.zeros((batch_size, 3, num_frames, height, width), device=device) if video is None
                 else _as_video(video, device))
        mask = (torch.ones((batch_size, 1, num_frames, height, width), device=device) if mask is None
                else _as_video(mask, device))
        control = self.prepare_control_latents(video, mask * torch.ones_like(video[:, :1]))

        n_vace = len(self.transformer.config.vace_layers)
        if isinstance(conditioning_scale, (int, float)):
            scale = torch.full((n_vace,), float(conditioning_scale), device=device)
        else:
            scale = torch.as_tensor(conditioning_scale, dtype=torch.float32, device=device)

        shape = (batch_size, self.transformer.config.in_channels, control.shape[2],
                 height // self.vae_scale_factor_spatial, width // self.vae_scale_factor_spatial)
        if latents is None:
            latents = torch_utils.randn_tensor(shape, generator, device)
        latents = latents.to(device=device, dtype=torch.float32)
        rope = self.transformer.rotary_tables(latents)
        control_in = torch.cat([control, control]) if do_cfg else control
        state = self.scheduler.set_timesteps(num_inference_steps)
        ts = state.timesteps.to(device)
        for i, t in enumerate(state.timesteps):
            latent_in = torch.cat([latents, latents]) if do_cfg else latents
            noise_pred = self._predict(latent_in, ts[i], prompt_embeds, control_in, scale, rope)
            if do_cfg:
                uncond, cond = noise_pred.chunk(2)
                noise_pred = uncond + guidance_scale * (cond - uncond)
            latents = self.scheduler.step(state, noise_pred, t, latents).prev_sample

        frames = latents if output_type == "latent" else self.decode_latents(latents)
        if not return_dict:
            return (frames,)
        return WanPipelineOutput(frames=frames)

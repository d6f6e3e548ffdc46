"""Wan video-to-video pipeline.

Port of `diffusers_tpu/pipelines/wan/pipeline_wan_video2video.py`
(`WanVideoToVideoPipeline` `:29`): the video (`VideoProcessor.preprocess_video`'s
layouts) is VAE-encoded chunk by chunk (`mode()`), normalised with the
VAE's `latents_mean` / `latents_std`, noised by the scheduler's `add_noise`
to the first timestep that `strength` keeps, and denoised by `WanPipeline`'s
loop over the rest of the schedule; then decoded as `WanPipeline` does.

The kept steps run as upstream diffusers runs them: the scheduler's ladder
is cut at the first kept step (upstream finds its step index from the
timestep), so the sigmas stepped are those of the kept timesteps and the
last step ends at sigma 0. JAX passes the cut timesteps with a step index
starting at 0 and so steps the head of the ladder (ROADMAP C4).
`max_sequence_length` defaults to 512, as in `WanPipeline` (JAX: 226).

The caches are those JAX's V2V honours through `WanPipeline._denoise`:
TaylorSeer, MagCache, TextKV and FirstBlockCache. FasterCache (which JAX
runs dense here: its schedule is made only in `WanPipeline.__call__`) and
PAB (which JAX's loop refuses without that call's mask) raise TypeError in
`enable_cache`; FreeInit raises ValueError, as JAX's V2V ignores it. Every
random draw goes through `utils.torch_utils.randn_tensor`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import torch

from ...utils import torch_utils
from ...video_processor import VideoProcessor
from ..inpaint_utils import check_strength_and_schedule
from .pipeline_wan import WanPipeline, WanPipelineOutput


class WanVideoToVideoPipeline(WanPipeline):
    _supported_cache_configs = ("TaylorSeerCacheConfig", "MagCacheConfig", "TextKVCacheConfig",
                                "FirstBlockCacheConfig")

    def __init__(self, tokenizer, text_encoder, transformer, vae, scheduler, device: Union[str, torch.device] = "cuda"):
        super().__init__(tokenizer=tokenizer, text_encoder=text_encoder, transformer=transformer, vae=vae,
                         scheduler=scheduler, device=device)
        self.video_processor = VideoProcessor(vae_scale_factor=self.vae_scale_factor_spatial)

    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        video=None,
        strength: float = 0.8,
        height: int = 480,
        width: int = 832,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        max_sequence_length: int = 512,
        output_type: str = "np",
        return_dict: bool = True,
    ):
        """Video-to-video over the last int(`num_inference_steps` x
        `strength`) steps. `latents`, when given, are the noised start (the
        video is then not encoded). `output_type`: "np" (float32 frames [B,
        F, H, W, C] in [0, 1]) or "latent"."""
        if self.free_init_enabled:
            raise ValueError("FreeInit is not honoured by video-to-video (JAX's V2V ignores it); disable it")
        if not 0 <= strength <= 1:
            raise ValueError(f"strength must be in [0, 1], got {strength}")
        device = self.transformer.device
        do_cfg = guidance_scale > 1.0
        prompt_embeds, negative_embeds = self.encode_prompt(prompt, negative_prompt, do_cfg, max_sequence_length)
        batch_size = prompt_embeds.shape[0]

        video = torch.from_numpy(self.video_processor.preprocess_video(video, height=height, width=width)).to(device)
        frames = (video.shape[2] - 1) // self.vae_scale_factor_temporal + 1
        shape = (batch_size, self.transformer.config.in_channels, frames, height // self.vae_scale_factor_spatial,
                 width // self.vae_scale_factor_spatial)

        state = self.scheduler.set_timesteps(num_inference_steps)
        t_start = max(num_inference_steps - min(int(num_inference_steps * strength), num_inference_steps), 0)
        state = dataclasses.replace(state, timesteps=state.timesteps[t_start:], sigmas=state.sigmas[t_start:],
                                    num_inference_steps=num_inference_steps - t_start)
        check_strength_and_schedule(strength, state.timesteps)

        if latents is None:
            vae = self.vae
            init = vae.encode(video.to(vae.dtype)).mode().float()
            init = init.repeat_interleave(batch_size // init.shape[0], dim=0) if init.shape[0] < batch_size else init
            mean = torch.tensor(vae.config.latents_mean, device=device).reshape(1, -1, 1, 1, 1)
            std = torch.tensor(vae.config.latents_std, device=device).reshape(1, -1, 1, 1, 1)
            noise = torch_utils.randn_tensor(shape, generator, device)
            latents = self.scheduler.add_noise(state, (init - mean) / std, noise, state.timesteps[:1])
        latents = latents.to(device=device, dtype=torch.float32)

        rope = self.transformer.rotary_tables(latents)
        latents = self._denoise(latents, prompt_embeds, negative_embeds, rope, state, guidance_scale)

        out = latents if output_type == "latent" else self.decode_latents(latents)
        if not return_dict:
            return (out,)
        return WanPipelineOutput(frames=out)

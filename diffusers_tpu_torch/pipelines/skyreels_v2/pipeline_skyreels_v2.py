"""SkyReels-V2 text-to-video pipeline.

Port of `diffusers_tpu/pipelines/skyreels_v2/pipeline_skyreels_v2.py`
(`SkyReelsV2Pipeline` `:34`): UMT5 text encoding with the embeddings past
each prompt's length zeroed (`WanPipeline`'s), the standard synchronous
schedule over [B, 16, 1 + (F - 1) / 4, H / 8, W / 8] latents with CFG as two
batch-1 transformer calls a step (cond, then uncond), a scheduler step in
float32, and the VAE's chunked decode. Defaults as JAX's: 544 x 960 x 97
frames, 50 steps, guidance 6.0, 512 text tokens.

The transformer's diffusion forcing and block-causal mask are held by its
own tests; the diffusion-forcing pipelines are not ported (nor in JAX). A
transformer with `inject_sample_info` needs an fps that this pipeline does
not pass, so the port raises ValueError up front where JAX fails inside the
transformer (ROADMAP C4). No cache config is accepted (JAX's loop reads
none). Every random draw goes through `utils.torch_utils.randn_tensor`; the
pipeline is built on ``device`` (default ``"cuda"``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from ...utils import BaseOutput, torch_utils
from ..pipeline_utils import DiffusionPipeline
from ..wan.pipeline_wan import WanPipeline


@dataclass
class SkyReelsV2PipelineOutput(BaseOutput):
    frames: Union[np.ndarray, torch.Tensor]


class SkyReelsV2Pipeline(DiffusionPipeline):
    _supported_cache_configs = ()

    def __init__(self, tokenizer, text_encoder, transformer, vae, scheduler,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.register_modules(vae=vae, text_encoder=text_encoder, tokenizer=tokenizer, transformer=transformer,
                              scheduler=scheduler)
        self.vae_scale_factor_temporal = vae.config.scale_factor_temporal if vae is not None else 4
        self.vae_scale_factor_spatial = vae.config.scale_factor_spatial if vae is not None else 8
        self._place(device)

    _get_t5_prompt_embeds = WanPipeline._get_t5_prompt_embeds
    encode_prompt = WanPipeline.encode_prompt
    decode_latents = WanPipeline.decode_latents

    def _predict(self, latents, t, embeds, rope) -> torch.Tensor:
        tr = self.transformer
        return tr(latents.to(tr.dtype), t.expand(latents.shape[0]), embeds, rotary_emb=rope).sample.float()

    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        height: int = 544,
        width: int = 960,
        num_frames: int = 97,
        num_inference_steps: int = 50,
        guidance_scale: float = 6.0,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        max_sequence_length: int = 512,
        output_type: str = "np",
        return_dict: bool = True,
    ):
        """Text-to-video. `output_type`: "np" (float32 frames [B, F, H, W, C]
        in [0, 1]) or "latent"."""
        if self.transformer.config.get("inject_sample_info"):
            raise ValueError("the transformer has `inject_sample_info`, which needs an fps this pipeline does not "
                             "pass (the diffusion-forcing pipelines that pass one are not ported)")
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

        state = self.scheduler.set_timesteps(num_inference_steps)
        ts = state.timesteps.to(device)
        for i, t in enumerate(state.timesteps):
            noise_pred = self._predict(latents, ts[i], prompt_embeds, rope)
            if do_cfg:
                uncond = self._predict(latents, ts[i], negative_embeds, rope)
                noise_pred = uncond + guidance_scale * (noise_pred - uncond)
            latents = self.scheduler.step(state, noise_pred, t, latents).prev_sample

        video = latents if output_type == "latent" else self.decode_latents(latents)
        if not return_dict:
            return (video,)
        return SkyReelsV2PipelineOutput(frames=video)

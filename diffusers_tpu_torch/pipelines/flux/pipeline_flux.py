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

Callbacks, the PAB/MagCache/TaylorSeer/FirstBlock caches, img2img, inpaint,
fill, kontext and `from_pretrained` wait.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from ...image_processor import numpy_to_pil, postprocess_np, postprocess_uint8
from ...schedulers.scheduling_flow_match_euler_discrete import calculate_shift
from ...utils import BaseOutput
from ..pipeline_utils import DiffusionPipeline


@dataclass
class FluxPipelineOutput(BaseOutput):
    images: Union[List, np.ndarray, torch.Tensor]


class FluxPipeline(DiffusionPipeline):
    def __init__(
        self,
        scheduler,
        vae,
        text_encoder,
        tokenizer,
        text_encoder_2,
        tokenizer_2,
        transformer,
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
        # the timestep fed to the transformer, t / 1000, divided on the host
        # (a true f32 division, as in JAX) and moved to the card once
        timesteps = (state.timesteps / 1000.0).to(latents.device)
        batch = latents.shape[0]
        for i, t in enumerate(state.timesteps):
            noise_pred = self.transformer(
                latents.to(prompt_embeds.dtype),
                encoder_hidden_states=prompt_embeds,
                pooled_projections=pooled_prompt_embeds,
                timestep=timesteps[i].expand(batch),
                guidance=guidance,
                image_rotary_emb=rope,
            ).sample.to(latents.dtype)
            latents = self.scheduler.step(state, noise_pred, t, latents).prev_sample
        return latents

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
    ):
        """Text-to-image. `latents`, when given, are packed ([B, seq, 4 C]).
        `output_type`: "pil" (uint8 quantized on the device, then PIL), "np"
        (float32 NHWC in [0, 1]), "latent" (the final packed latents)."""
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

        latents = self._denoise(latents, prompt_embeds, pooled_prompt_embeds, rope, state, guidance)

        if output_type == "latent":
            image = latents
        else:
            z = self._unpack_latents(latents, height, width, self.vae_scale_factor) / self.vae.config.scaling_factor
            if self.vae.config.get("shift_factor") is not None:
                z = z + self.vae.config.shift_factor
            decoded = self.vae.decode(z.to(self.vae.dtype)).sample
            if output_type == "np":
                image = postprocess_np(decoded)
            elif output_type == "pil":
                image = numpy_to_pil(postprocess_uint8(decoded))
            else:
                raise ValueError(f"unsupported output_type {output_type!r}; choose 'pil', 'np' or 'latent'")

        if not return_dict:
            return (image,)
        return FluxPipelineOutput(images=image)

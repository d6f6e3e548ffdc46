"""HunyuanVideo text-to-video pipeline.

Port of `diffusers_tpu/pipelines/hunyuan_video/pipeline_hunyuan_video.py`:
the prompt goes into the Llama template, the tower runs with
``output_hidden_states`` and the pipeline reads ``hidden_states[-3]`` from
``crop_start`` on (the template's own token count less 2 when the template
gives none, `:58-76`), with the mask cropped the same way; CLIP-L's
``pooler_output`` is the pooled text (`:78-83`). The distilled guidance is
``guidance_scale * 1000`` (`:170`), given to every call, and true CFG
(``true_cfg_scale`` > 1 with a negative prompt) is a second transformer call
a step (`:111-116`). The flow-match schedule takes linspace sigmas
(`:166-168`); the latents are decoded at ``z / scaling_factor``. Frames come
out as float32 ``[B, F, H, W, C]`` in [0, 1] ("np") or as the final latents
("latent"). Where JAX scans the loop in one jitted program, the port runs it
step by step; the RoPE tables are made once a shape on the model's device.

`enable_cache` honours JAX's `_supported_cache_configs` (`:96`): TaylorSeer
and MagCache through the generic `denoise_loop`; TextKV, under which a
request makes each prompt's timestep-independent refiner half
(`HunyuanVideoTransformer3DModel.text_context`) once. `callback_on_step_end`
runs `denoise_loop_with_callback`, shown "latents" after each step. The
latents are drawn through `utils.torch_utils.randn_tensor`. The pipeline is
built on ``device`` (default ``"cuda"``; see `DiffusionPipeline._place`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ...hooks.generic_cache import TextKVCacheConfig, denoise_loop, denoise_loop_with_callback
from ...utils import BaseOutput, torch_utils
from ..pipeline_utils import DiffusionPipeline

DEFAULT_PROMPT_TEMPLATE = {
    "template": (
        "<|start_header_id|>system<|end_header_id|>\n\nDescribe the video by detailing the following aspects: "
        "1. The main content and theme of the video."
        "2. The color, shape, size, texture, quantity, text, and spatial relationships of the objects."
        "3. Actions, events, behaviors temporal relationships, physical movement changes of the objects."
        "4. background environment, light, style and atmosphere."
        "5. camera angles, movements, and transitions used in the video:<|eot_id|>"
        "<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>"
    ),
    "crop_start": 95,
}


@dataclass
class HunyuanVideoPipelineOutput(BaseOutput):
    frames: Union[np.ndarray, torch.Tensor]


@dataclass
class HunyuanPrompt:
    """One prompt's conditioning: the Llama embeds and mask after the crop,
    CLIP-L's pooled output, and (under TextKV) the refiner's cached half."""

    embeds: torch.Tensor
    pooled: torch.Tensor
    mask: torch.Tensor
    context: Any = None


class HunyuanVideoPipeline(DiffusionPipeline):
    _supported_cache_configs = ("TaylorSeerCacheConfig", "MagCacheConfig", "TextKVCacheConfig")

    def __init__(self, text_encoder, tokenizer, transformer, vae, scheduler, text_encoder_2, tokenizer_2,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.register_modules(vae=vae, text_encoder=text_encoder, tokenizer=tokenizer, transformer=transformer,
                              scheduler=scheduler, text_encoder_2=text_encoder_2, tokenizer_2=tokenizer_2)
        self.vae_scale_factor_temporal = vae.config.temporal_compression_ratio if vae is not None else 4
        self.vae_scale_factor_spatial = vae.config.spatial_compression_ratio if vae is not None else 8
        self._place(device)

    # ---------------------------------------------------------------- text
    def crop_start(self, prompt_template: Dict[str, Any], max_sequence_length: int) -> int:
        """The template's ``crop_start``, or, where it gives None, the token
        count of the template itself less 2 (JAX `:63-67`)."""
        crop_start = prompt_template.get("crop_start", None)
        if crop_start is None:
            ids = self.tokenizer(prompt_template["template"], padding="max_length", max_length=max_sequence_length,
                                 truncation=False, return_tensors="np").input_ids
            crop_start = np.asarray(ids).shape[-1] - 2
        return crop_start

    def _get_llama_prompt_embeds(self, prompt: List[str], prompt_template: Dict[str, Any],
                                 max_sequence_length: int = 256, num_hidden_layers_to_skip: int = 2):
        prompt = [prompt_template["template"].format(p) for p in prompt]
        crop_start = self.crop_start(prompt_template, max_sequence_length)
        inputs = self.tokenizer(prompt, padding="max_length", max_length=max_sequence_length + crop_start,
                                truncation=True, return_tensors="np")
        device = self.text_encoder.device
        ids = torch.as_tensor(np.asarray(inputs.input_ids), dtype=torch.long, device=device)
        mask = torch.as_tensor(np.asarray(getattr(inputs, "attention_mask", np.ones_like(inputs.input_ids))),
                               dtype=torch.long, device=device)
        out = self.text_encoder(ids, attention_mask=mask, output_hidden_states=True)
        embeds = out.hidden_states[-(num_hidden_layers_to_skip + 1)]
        return embeds[:, crop_start:], mask[:, crop_start:]

    def _get_clip_prompt_embeds(self, prompt: List[str]) -> torch.Tensor:
        inputs = self.tokenizer_2(prompt, padding="max_length", max_length=77, truncation=True, return_tensors="np")
        ids = torch.as_tensor(np.asarray(inputs.input_ids), dtype=torch.long, device=self.text_encoder_2.device)
        return self.text_encoder_2(ids).pooler_output

    @torch.no_grad()
    def encode_prompt(self, prompt, prompt_2=None, prompt_template=DEFAULT_PROMPT_TEMPLATE,
                      max_sequence_length: int = 256):
        """(Llama embeds, CLIP pooled, mask), as JAX returns them."""
        prompt = [prompt] if isinstance(prompt, str) else prompt
        prompt_2 = prompt_2 or prompt
        prompt_2 = [prompt_2] if isinstance(prompt_2, str) else prompt_2
        embeds, mask = self._get_llama_prompt_embeds(prompt, prompt_template, max_sequence_length)
        return embeds, self._get_clip_prompt_embeds(prompt_2), mask

    def _prompts(self, prompt, prompt_2, negative_prompt, true_cfg_scale, prompt_template, max_sequence_length):
        """(positive, negative or None) `HunyuanPrompt`s on the transformer's
        dtype, each with its refiner half under TextKV."""
        def make(p, p2):
            embeds, pooled, mask = self.encode_prompt(p, p2, prompt_template, max_sequence_length)
            dtype = self.transformer.dtype
            out = HunyuanPrompt(embeds.to(dtype), pooled.to(dtype), mask)
            if isinstance(self._cache_config, TextKVCacheConfig):
                out.context = self.transformer.text_context(out.embeds, mask)
            return out

        positive = make(prompt, prompt_2)
        negative = make(negative_prompt, None) if true_cfg_scale > 1.0 and negative_prompt is not None else None
        return positive, negative

    def _predict(self, latents, t, prompt: HunyuanPrompt, guidance, rope, **extra):
        timestep = t.to(latents.device).expand(latents.shape[0])
        return self.transformer(latents.to(self.transformer.dtype), timestep, prompt.embeds, prompt.mask,
                                prompt.pooled, guidance=guidance, image_rotary_emb=rope,
                                text_context=prompt.context, **extra).sample.float()

    @torch.no_grad()
    def _denoise(self, latents, positive, negative, guidance, rope, state, true_cfg_scale, callback=None):
        def forward(lat, i, t):
            pred = self._predict(lat, t, positive, guidance, rope)
            if negative is not None:
                neg = self._predict(lat, t, negative, guidance, rope)
                pred = neg + true_cfg_scale * (pred - neg)
            return pred

        if callback is not None:
            return denoise_loop_with_callback(lambda lat, i, t, cb: forward(lat, i, t), self.scheduler, latents,
                                              state, state.timesteps, self, callback, {},
                                              cache_cfg=self._cache_config)
        return denoise_loop(forward, self.scheduler, latents, state, state.timesteps, self._cache_config)

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> np.ndarray:
        """Latents [B, C, F', H', W'] -> float32 frames [B, F, H, W, C] in [0, 1]."""
        vae = self.vae
        video = vae.decode((latents / vae.config.scaling_factor).to(vae.dtype)).sample
        return (video.float() / 2 + 0.5).clamp(0, 1).permute(0, 2, 3, 4, 1).cpu().numpy()

    def _guidance(self, batch_size: int, guidance_scale: float, device) -> torch.Tensor:
        return torch.full((batch_size,), guidance_scale * 1000.0, dtype=torch.float32, device=device)

    def _schedule(self, num_inference_steps: int, sigmas=None):
        if sigmas is None:
            sigmas = np.linspace(1.0, 0.0, num_inference_steps + 1)[:-1]
        return self.scheduler.set_timesteps(sigmas=list(sigmas))

    # ------------------------------------------------------------ __call__
    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        prompt_2: Optional[Union[str, List[str]]] = None,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        height: int = 720,
        width: int = 1280,
        num_frames: int = 129,
        num_inference_steps: int = 50,
        sigmas: Optional[List[float]] = None,
        true_cfg_scale: float = 1.0,
        guidance_scale: float = 6.0,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        prompt_template: Dict[str, Any] = DEFAULT_PROMPT_TEMPLATE,
        max_sequence_length: int = 256,
        output_type: str = "np",
        return_dict: bool = True,
        callback_on_step_end=None,
        callback_on_step_end_tensor_inputs: Optional[List[str]] = None,
    ):
        """Text-to-video. `callback_on_step_end(pipe, i, t, {"latents": ...})`
        may return new latents (`callback_on_step_end_tensor_inputs` is
        accepted for API parity); it cannot be combined with a cache."""
        device = self.transformer.device
        positive, negative = self._prompts(prompt, prompt_2, negative_prompt, true_cfg_scale, prompt_template,
                                           max_sequence_length)
        batch_size = positive.embeds.shape[0]
        latent_frames = (num_frames - 1) // self.vae_scale_factor_temporal + 1
        lh, lw = height // self.vae_scale_factor_spatial, width // self.vae_scale_factor_spatial
        if latents is None:
            shape = (batch_size, self.transformer.config.in_channels, latent_frames, lh, lw)
            latents = torch_utils.randn_tensor(shape, generator, device)
        latents = latents.to(device=device, dtype=torch.float32)
        state = self._schedule(num_inference_steps, sigmas)
        guidance = self._guidance(batch_size, guidance_scale, device)
        rope = self.transformer._device_rope(latent_frames, lh, lw, device)
        latents = self._denoise(latents, positive, negative, guidance, rope, state, true_cfg_scale,
                                callback=callback_on_step_end)
        video = latents if output_type == "latent" else self.decode_latents(latents)
        if not return_dict:
            return (video,)
        return HunyuanVideoPipelineOutput(frames=video)

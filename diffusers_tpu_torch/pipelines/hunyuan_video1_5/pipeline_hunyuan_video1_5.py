"""HunyuanVideo 1.5 text-to-video pipeline.

Port of `diffusers_tpu/pipelines/hunyuan_video1_5/pipeline_hunyuan_video1_5.py`:

* the Qwen prompt through the tokenizer's chat template with the generation
  prompt, or, where the tokenizer has no template, JAX's Qwen2 template
  string (`:121-138`); 1,000 + 108 tokens, the tower's
  ``hidden_states[-3]`` with the 108-token system prefix cropped, and the
  mask cropped alike;
* the ByT5 glyph prompt of each prompt's quoted spans
  (`extract_glyph_texts`) over 256 tokens, or zeros under a zero mask
  (`:144-163`);
* the zero condition latents and mask (32 + 1 channels) concatenated to the
  latents, and 729 zero image tokens: text-to-video (`:195-198`, `:285`);
* CFG through ``guider``, or a `ClassifierFreeGuidance` of
  ``guidance_scale`` > 1: the cond/uncond pair as one batch-2 transformer
  call a step, ``[cond, uncond]``;
* `calculate_default_height_width`: the aspect ratio's closest bucket
  around ``target_size`` when neither side is given;
* the linspace sigmas ``[1, 0)``, the decode of ``z / scaling_factor``, and
  frames as float32 ``[B, F, H, W, C]`` in [0, 1].

JAX's pipeline never passes ``timestep_r``, nor does this one. Caches
(ROADMAP C3): TaylorSeer and MagCache run on the guidance-free path; on the
CFG path, whose JAX loop ignores them, the port raises `TypeError`.
`callback_on_step_end` runs on both paths (JAX fires it on the plain path
only). Latents are float32 and drawn through `utils.torch_utils.randn_tensor`.
The pipeline is built on ``device`` (default ``"cuda"``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from ...guiders import ClassifierFreeGuidance
from ...utils import BaseOutput, torch_utils
from ...video_processor import VideoProcessor
from ..hunyuan_image.pipeline_hunyuanimage import guided_loop, linspace_schedule, refuse_cache, tokens_on
from ..pipeline_utils import DiffusionPipeline

DEFAULT_SYSTEM_MESSAGE = (
    "You are a helpful assistant. Describe the video by detailing the following aspects: "
    "        1. The main content and theme of the video. "
    "        2. The color, shape, size, texture, quantity, text, and spatial relationships of the objects. "
    "        3. Actions, events, behaviors temporal relationships, physical movement changes of the objects. "
    "        4. background environment, light, style and atmosphere. "
    "        5. camera angles, movements, and transitions used in the video."
)


def extract_glyph_texts(prompt: str) -> Optional[str]:
    """The double-quoted spans of `prompt`, each once, as the ByT5 glyph
    prompt, or None (JAX `:46`)."""
    matches = re.findall(r"\"(.*?)\"|“(.*?)”", prompt)
    result = [m[0] or m[1] for m in matches]
    if len(result) > 1:
        result = list(dict.fromkeys(result))
    if not result:
        return None
    return ". ".join([f'Text "{t}"' for t in result]) + ". "


def generate_crop_size_list(base_size: int = 256, patch_size: int = 16, max_ratio: float = 4.0):
    """(width, height) buckets of about ``base_size ** 2`` pixels (JAX `:58`)."""
    num_patches = round((base_size / patch_size) ** 2)
    crop_size_list = []
    wp, hp = num_patches, 1
    while wp > 0:
        if max(wp, hp) / min(wp, hp) <= max_ratio:
            crop_size_list.append((wp * patch_size, hp * patch_size))
        if (hp + 1) * wp <= num_patches:
            hp += 1
        else:
            wp -= 1
    return crop_size_list


def calculate_default_height_width(height: int, width: int, target_size: int, patch_size: int):
    """The bucket whose ratio is closest to ``height / width`` on the same
    side of 1 (JAX `:74`); returns the bucket's pair as JAX does."""
    buckets = generate_crop_size_list(base_size=target_size, patch_size=patch_size)
    ratios = np.array([round(float(h) / float(w), 5) for h, w in buckets])
    aspect = float(height) / float(width)
    diff = ratios - aspect
    candidates = [(i, d) for i, d in enumerate(diff) if (d <= 0 if aspect >= 1 else d >= 0)]
    return buckets[min(candidates, key=lambda p: abs(p[1]))[0]]


@dataclass
class HunyuanVideo15PipelineOutput(BaseOutput):
    frames: Union[np.ndarray, torch.Tensor]


class HunyuanVideo15Pipeline(DiffusionPipeline):
    _supported_cache_configs = ("TaylorSeerCacheConfig", "MagCacheConfig")
    _optional_components = ["guider"]

    def __init__(self, text_encoder, tokenizer, transformer, vae, scheduler, text_encoder_2, tokenizer_2,
                 guider=None, device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.register_modules(vae=vae, text_encoder=text_encoder, tokenizer=tokenizer, transformer=transformer,
                              scheduler=scheduler, text_encoder_2=text_encoder_2, tokenizer_2=tokenizer_2,
                              guider=guider)
        self.vae_scale_factor_temporal = vae.config.temporal_compression_ratio if vae is not None else 4
        self.vae_scale_factor_spatial = vae.config.spatial_compression_ratio if vae is not None else 16
        self.video_processor = VideoProcessor(vae_scale_factor=self.vae_scale_factor_spatial)
        self.target_size = transformer.config.target_size if transformer is not None else 640
        self.vision_states_dim = transformer.config.image_embed_dim if transformer is not None else 1152
        self.num_channels_latents = vae.config.latent_channels if vae is not None else 32
        self.system_message = DEFAULT_SYSTEM_MESSAGE
        self.prompt_template_encode_start_idx = 108
        self.tokenizer_max_length = 1000
        self.tokenizer_2_max_length = 256
        self.vision_num_semantic_tokens = 729
        self.default_aspect_ratio = (16, 9)
        self._place(device)

    # ---------------------------------------------------------------- text
    def _tokenize_chat(self, prompt: List[str], max_len: int):
        conversations = [[{"role": "system", "content": self.system_message},
                          {"role": "user", "content": p if p else " "}] for p in prompt]
        try:
            return self.tokenizer.apply_chat_template(
                conversations, add_generation_prompt=True, tokenize=True, return_dict=True, padding="max_length",
                max_length=max_len, truncation=True, return_tensors="np")
        except Exception:  # no template: JAX's Qwen2 template string (`:128-135`)
            texts = [f"<|im_start|>system\n{self.system_message}<|im_end|>\n"
                     f"<|im_start|>user\n{p if p else ' '}<|im_end|>\n<|im_start|>assistant\n" for p in prompt]
            return self.tokenizer(texts, max_length=max_len, padding="max_length", truncation=True,
                                  return_tensors="np")

    def _get_mllm_prompt_embeds(self, prompt: List[str], num_hidden_layers_to_skip: int = 2):
        crop = self.prompt_template_encode_start_idx
        inputs = self._tokenize_chat(prompt, self.tokenizer_max_length + crop)
        ids, mask = tokens_on(inputs, self.text_encoder.device)
        hidden = self.text_encoder(ids, attention_mask=mask, output_hidden_states=True).hidden_states
        return hidden[-(num_hidden_layers_to_skip + 1)][:, crop:], mask[:, crop:]

    def _get_byt5_prompt_embeds(self, prompt: List[str]):
        encoder, max_len = self.text_encoder_2, self.tokenizer_2_max_length
        d2 = encoder.config.get("d_model", 1472)
        rows, masks = [], []
        for p in prompt:
            glyph = extract_glyph_texts(p)
            if glyph is None:
                rows.append(torch.zeros((1, max_len, d2), dtype=encoder.dtype, device=encoder.device))
                masks.append(torch.zeros((1, max_len), dtype=torch.long, device=encoder.device))
                continue
            inputs = self.tokenizer_2(glyph, padding="max_length", max_length=max_len, truncation=True,
                                      add_special_tokens=True, return_tensors="np")
            ids, m = tokens_on(inputs, encoder.device)
            rows.append(encoder(ids, attention_mask=m).last_hidden_state)
            masks.append(m)
        return torch.cat(rows), torch.cat(masks)

    @torch.no_grad()
    def encode_prompt(self, prompt: Union[str, List[str]]):
        """(Qwen embeds, mask, ByT5 embeds, ByT5 mask)."""
        prompt = [""] if prompt is None else ([prompt] if isinstance(prompt, str) else prompt)
        embeds, mask = self._get_mllm_prompt_embeds(prompt)
        embeds_2, mask_2 = self._get_byt5_prompt_embeds(prompt)
        return embeds, mask, embeds_2.to(embeds.device), mask_2.to(embeds.device)

    # ------------------------------------------------------------- helpers
    def _guider(self, guidance_scale):
        guider = self.guider
        if guider is None and guidance_scale is not None and guidance_scale > 1.0:
            guider = ClassifierFreeGuidance(guidance_scale=guidance_scale)
        return guider, guider is not None and getattr(guider, "num_conditions", 1) > 1

    def _conditioning(self, prompt, negative_prompt, do_cfg: bool):
        """(Qwen embeds, mask, ByT5 embeds, ByT5 mask, batch size), under CFG
        the batch-2 pair ``[cond, uncond]``; the negative prompt defaults to
        ``""``."""
        embeds, mask, embeds_2, mask_2 = self.encode_prompt(prompt)
        batch_size = embeds.shape[0]
        if do_cfg:
            negative_prompt = negative_prompt if negative_prompt is not None else ""
            if isinstance(negative_prompt, str):
                negative_prompt = [negative_prompt] * batch_size
            neg = self.encode_prompt(negative_prompt)
            embeds, mask, embeds_2, mask_2 = (torch.cat([a, b]) for a, b in zip((embeds, mask, embeds_2, mask_2), neg))
        dtype = self.transformer.dtype
        return embeds.to(dtype), mask, embeds_2.to(dtype), mask_2, batch_size

    def _latents(self, batch_size, num_frames, height, width, generator, latents):
        if latents is None:
            shape = (batch_size, self.num_channels_latents, (num_frames - 1) // self.vae_scale_factor_temporal + 1,
                     int(height) // self.vae_scale_factor_spatial, int(width) // self.vae_scale_factor_spatial)
            latents = torch_utils.randn_tensor(shape, generator, self.transformer.device)
        return latents.to(device=self.transformer.device, dtype=torch.float32)

    def prepare_cond_latents_and_mask(self, latents):
        """Zero condition latents and a zero mask: text-to-video (JAX `:195-198`)."""
        b, _, f, h, w = latents.shape
        return torch.zeros_like(latents), torch.zeros((b, 1, f, h, w), dtype=latents.dtype, device=latents.device)

    @torch.no_grad()
    def _denoise(self, latents, cond_latents, mask_latents, image_embeds, conditioning, state, guider, do_cfg,
                 callback=None):
        transformer = self.transformer
        embeds, mask, embeds_2, mask_2, _ = conditioning
        device, dtype = transformer.device, transformer.dtype
        n_steps = len(state.timesteps)
        if do_cfg:
            refuse_cache(self, "CFG")
            image_embeds = torch.cat([image_embeds, image_embeds])
        image_embeds = image_embeds.to(dtype)

        def forward(lat, i, t):
            hidden = torch.cat([lat, cond_latents, mask_latents], dim=1)
            if do_cfg:
                hidden = torch.cat([hidden, hidden])
            timestep = t.to(device=device, dtype=torch.float32).expand(hidden.shape[0])
            pred = transformer(hidden.to(dtype), timestep, embeds, mask, encoder_hidden_states_2=embeds_2,
                               encoder_attention_mask_2=mask_2, image_embeds=image_embeds).sample.float()
            if not do_cfg:
                return pred
            cond, uncond = pred.chunk(2)
            return guider(cond, uncond, step=i, num_steps=n_steps)

        return guided_loop(self, forward, latents, state, callback, self._cache_config)

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> np.ndarray:
        """Latents [B, C, F', H', W'] -> float32 frames [B, F, H, W, C] in [0, 1]."""
        vae = self.vae
        video = vae.decode((latents / vae.config.scaling_factor).to(vae.dtype)).sample
        return (video.float() / 2 + 0.5).clamp(0, 1).permute(0, 2, 3, 4, 1).cpu().numpy()

    # ------------------------------------------------------------ __call__
    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_frames: int = 121,
        num_inference_steps: int = 50,
        sigmas: Optional[List[float]] = None,
        guidance_scale: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        output_type: str = "np",
        return_dict: bool = True,
        callback_on_step_end=None,
        callback_on_step_end_tensor_inputs: Optional[List[str]] = None,
    ):
        """Text-to-video: frames [B, F, H, W, C] ("np") or the final latents
        ("latent"). `callback_on_step_end(pipe, i, t, {"latents": ...})` may
        return new latents."""
        if height is None and width is None:
            height, width = calculate_default_height_width(self.default_aspect_ratio[1], self.default_aspect_ratio[0],
                                                           self.target_size, self.vae_scale_factor_spatial)
        guider, do_cfg = self._guider(guidance_scale)
        conditioning = self._conditioning(prompt, negative_prompt, do_cfg)
        state = linspace_schedule(self.scheduler, num_inference_steps, sigmas)
        latents = self._latents(conditioning[-1], num_frames, height, width, generator, latents)
        cond_latents, mask_latents = self.prepare_cond_latents_and_mask(latents)
        image_embeds = torch.zeros((latents.shape[0], self.vision_num_semantic_tokens, self.vision_states_dim),
                                   dtype=torch.float32, device=latents.device)
        latents = self._denoise(latents, cond_latents, mask_latents, image_embeds, conditioning, state, guider,
                                do_cfg, callback_on_step_end)
        video = latents if output_type == "latent" else self.decode_latents(latents)
        if not return_dict:
            return (video,)
        return HunyuanVideo15PipelineOutput(frames=video)

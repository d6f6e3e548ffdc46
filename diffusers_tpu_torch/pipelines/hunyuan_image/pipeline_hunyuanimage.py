"""HunyuanImage-2.1 text-to-image pipeline.

Port of `diffusers_tpu/pipelines/hunyuan_image/pipeline_hunyuanimage.py`:

* the Qwen prompt: the template, tokenized to ``max_sequence_length + 34``
  tokens (1,000 + 34 by default), the tower's ``hidden_states[-3]`` with the
  template's first 34 positions dropped, and the mask cropped alike
  (`:80-92`);
* the ByT5 glyph prompt: the quoted spans of each prompt
  (`extract_glyph_text`) as ``Text "..."`` sentences over 128 tokens, or all
  zeros and a zero mask where a prompt quotes nothing (`:94-119`);
* the guider (`:214-222`): ``ocr_guider`` when a prompt has glyph text,
  else ``guider``, else none (a distilled model runs guidance-free). A guider
  of two conditions runs the cond/uncond pair as one batch-2 transformer
  call a step, ``[cond, uncond]``, and `AdaptiveProjectedMixGuidance`'s
  momentum is carried from step to step (`init_momentum`);
* the distilled switches: ``guidance = distilled_guidance_scale * 1000``
  given to every call; under ``use_meanflow`` the reference timestep
  ``timestep_r`` is the schedule's next timestep by position, 0 at the last
  step (`:130-135`);
* the linspace sigmas ``[1, 0)``, and the decode of ``z / scaling_factor``.

Caches (ROADMAP C3): `enable_cache` takes TaylorSeer and MagCache, which
run on the guidance-free path that is not meanflow, as in JAX (`:185`);
JAX's CFG and meanflow loops ignore a cache config, and the port raises
`TypeError` there instead. `callback_on_step_end` runs on every path and
is shown "latents" after each step; JAX fires it on the plain path only
(ROADMAP C3). Latents stay float32 and are drawn through
`utils.torch_utils.randn_tensor`; each step casts them to the transformer's
dtype. The pipeline is built on ``device`` (default ``"cuda"``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from ...hooks.generic_cache import denoise_loop, denoise_loop_with_callback
from ...image_processor import VaeImageProcessor
from ...utils import BaseOutput, torch_utils
from ..pipeline_utils import DiffusionPipeline

PROMPT_TEMPLATE = (
    "<|im_start|>system\nDescribe the image by detailing the color, shape, size, texture, "
    "quantity, text, spatial relationships of the objects and background:<|im_end|>\n"
    "<|im_start|>user\n{}<|im_end|>"
)
TEMPLATE_START_IDX = 34


def extract_glyph_text(prompt: str) -> Optional[str]:
    """The quoted spans of `prompt` as the ByT5 glyph prompt, or None (JAX `:44`)."""
    spans = []
    for pattern in (r"\'(.*?)\'", r"\"(.*?)\"", r"‘(.*?)’", r"“(.*?)”"):
        spans.extend(re.findall(pattern, prompt))
    if not spans:
        return None
    return ". ".join([f'Text "{t}"' for t in spans]) + ". "


def tokens_on(inputs, device):
    """(ids, mask) long tensors on `device` of a tokenizer's numpy output."""
    ids = np.atleast_2d(np.asarray(inputs["input_ids"]))
    mask = np.atleast_2d(np.asarray(inputs["attention_mask"]))
    return (torch.as_tensor(ids, dtype=torch.long, device=device),
            torch.as_tensor(mask, dtype=torch.long, device=device))


@dataclass
class HunyuanImagePipelineOutput(BaseOutput):
    images: Union[List, np.ndarray, torch.Tensor]


def guided_loop(pipe, forward, latents, state, callback=None, cache_cfg=None):
    """The eager denoise loop of the HunyuanImage and HunyuanVideo 1.5
    pipelines: `forward(latents, i, t)`, a cache through `denoise_loop`, a
    callback through `denoise_loop_with_callback`."""
    if callback is not None:
        return denoise_loop_with_callback(lambda lat, i, t, cb: forward(lat, i, t), pipe.scheduler, latents, state,
                                          state.timesteps, pipe, callback, {}, cache_cfg=cache_cfg)
    return denoise_loop(forward, pipe.scheduler, latents, state, state.timesteps, cache_cfg)


def refuse_cache(pipe, path: str) -> None:
    """`TypeError` when a cache config is set on a path whose JAX loop
    ignores it."""
    if pipe._cache_config is not None:
        raise TypeError(f"{type(pipe).__name__}: {type(pipe._cache_config).__name__} runs on the guidance-free path "
                        f"only; this request takes the {path} path, whose JAX loop ignores caches. Call "
                        "disable_cache() first")


def linspace_schedule(scheduler, num_inference_steps: int, sigmas=None):
    """The scheduler state over `sigmas`, by default ``linspace(1, 0)`` less
    its last point; the scheduler's own spacing where it refuses sigmas
    (JAX `:245-249`)."""
    if sigmas is None:
        sigmas = np.linspace(1.0, 0.0, num_inference_steps + 1)[:-1]
    try:
        return scheduler.set_timesteps(num_inference_steps, sigmas=list(sigmas))
    except (TypeError, ValueError):
        return scheduler.set_timesteps(num_inference_steps)


class HunyuanImagePipeline(DiffusionPipeline):
    _optional_components = ["guider", "ocr_guider"]
    _supported_cache_configs = ("TaylorSeerCacheConfig", "MagCacheConfig")

    def __init__(self, transformer, vae, text_encoder, tokenizer, text_encoder_2, tokenizer_2, scheduler,
                 guider=None, ocr_guider=None, device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.register_modules(transformer=transformer, vae=vae, text_encoder=text_encoder, tokenizer=tokenizer,
                              text_encoder_2=text_encoder_2, tokenizer_2=tokenizer_2, scheduler=scheduler,
                              guider=guider, ocr_guider=ocr_guider)
        self.vae_scale_factor = vae.config.get("spatial_compression_ratio", 32) if vae is not None else 32
        self.image_processor = VaeImageProcessor(vae_scale_factor=self.vae_scale_factor)
        self.tokenizer_max_length = 1000
        self.tokenizer_2_max_length = 128
        self.default_sample_size = 64
        self.prompt_template_encode = PROMPT_TEMPLATE
        self.prompt_template_encode_start_idx = TEMPLATE_START_IDX
        self._place(device)

    # ---------------------------------------------------------------- text
    def _get_qwen_prompt_embeds(self, prompt: List[str], max_sequence_length: Optional[int] = None,
                                hidden_state_skip_layer: int = 2):
        drop = self.prompt_template_encode_start_idx
        inputs = self.tokenizer([self.prompt_template_encode.format(p) for p in prompt],
                                max_length=(max_sequence_length or self.tokenizer_max_length) + drop,
                                padding="max_length", truncation=True, return_tensors="np")
        ids, mask = tokens_on(inputs, self.text_encoder.device)
        hidden = self.text_encoder(ids, attention_mask=mask, output_hidden_states=True).hidden_states
        return hidden[-(hidden_state_skip_layer + 1)][:, drop:], mask[:, drop:]

    def _get_byt5_prompt_embeds(self, glyph_text: str):
        inputs = self.tokenizer_2(glyph_text, padding="max_length", max_length=self.tokenizer_2_max_length,
                                  truncation=True, add_special_tokens=True, return_tensors="np")
        ids, mask = tokens_on(inputs, self.text_encoder_2.device)
        return self.text_encoder_2(ids, attention_mask=mask).last_hidden_state, mask

    @torch.no_grad()
    def encode_prompt(self, prompt, max_sequence_length: Optional[int] = None):
        """(Qwen embeds, mask, ByT5 embeds, ByT5 mask): the ByT5 rows of a
        prompt without glyph text are zeros under a zero mask."""
        prompt = [prompt] if isinstance(prompt, str) else prompt
        embeds, mask = self._get_qwen_prompt_embeds(prompt, max_sequence_length)
        d2 = self.text_encoder_2.config.get("d_model", 1472)
        rows, masks = [], []
        for p in prompt:
            glyph = extract_glyph_text(p)
            if glyph is None:
                rows.append(torch.zeros((1, self.tokenizer_2_max_length, d2), dtype=embeds.dtype, device=embeds.device))
                masks.append(torch.zeros((1, self.tokenizer_2_max_length), dtype=torch.long, device=embeds.device))
            else:
                e2, m2 = self._get_byt5_prompt_embeds(glyph)
                rows.append(e2.to(embeds.device))
                masks.append(m2.to(embeds.device))
        return embeds, mask, torch.cat(rows), torch.cat(masks)

    def select_guider(self, prompt):
        """``ocr_guider`` when a prompt has glyph text and there is one, else
        ``guider`` (JAX `:214-222`; None: guidance-free)."""
        prompt = [prompt] if isinstance(prompt, str) else prompt
        if any(extract_glyph_text(p) is not None for p in prompt) and self.ocr_guider is not None:
            return self.ocr_guider
        return self.guider

    # ------------------------------------------------------------ __call__
    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 50,
        sigmas: Optional[List[float]] = None,
        distilled_guidance_scale: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        max_sequence_length: Optional[int] = None,
        output_type: str = "pil",
        return_dict: bool = True,
        callback_on_step_end=None,
        callback_on_step_end_tensor_inputs: Optional[List[str]] = None,
    ):
        """Text-to-image. `output_type`: "pil", "np" (float32 NHWC in
        [0, 1]) or "latent". `callback_on_step_end(pipe, i, t, {"latents":
        ...})` may return new latents (`callback_on_step_end_tensor_inputs`
        is accepted for API parity)."""
        transformer = self.transformer
        device, dtype = transformer.device, transformer.dtype
        height = height or self.default_sample_size * self.vae_scale_factor
        width = width or self.default_sample_size * self.vae_scale_factor
        embeds, mask, embeds_2, mask_2 = self.encode_prompt(prompt, max_sequence_length)
        batch_size = embeds.shape[0]
        guider = self.select_guider(prompt)
        do_cfg = guider is not None and guider.num_conditions > 1
        if do_cfg:
            negative_prompt = negative_prompt if negative_prompt is not None else ""
            if isinstance(negative_prompt, str):
                negative_prompt = [negative_prompt] * batch_size
            neg = self.encode_prompt(negative_prompt, max_sequence_length)
            embeds, mask, embeds_2, mask_2 = (torch.cat([a, b]) for a, b in zip((embeds, mask, embeds_2, mask_2), neg))
        embeds, embeds_2 = embeds.to(dtype), embeds_2.to(dtype)

        if latents is None:
            shape = (batch_size, transformer.config.in_channels, height // self.vae_scale_factor,
                     width // self.vae_scale_factor)
            latents = torch_utils.randn_tensor(shape, generator, device)
        latents = latents.to(device=device, dtype=torch.float32)
        state = linspace_schedule(self.scheduler, num_inference_steps, sigmas)
        timesteps = state.timesteps
        n_steps = len(timesteps)
        rows = 2 * batch_size if do_cfg else batch_size

        guidance = None
        if transformer.config.guidance_embeds:
            if distilled_guidance_scale is None:
                raise ValueError("`distilled_guidance_scale` is required for a guidance-distilled model.")
            guidance = torch.full((rows,), distilled_guidance_scale * 1000.0, dtype=torch.float32, device=device)
        use_meanflow = bool(transformer.config.get("use_meanflow", False))
        if do_cfg or use_meanflow:
            refuse_cache(self, "guided" if do_cfg else "meanflow")
        momentum = (guider.init_momentum(latents.shape, device=device)
                    if do_cfg and hasattr(guider, "init_momentum") else None)

        def forward(lat, i, t):
            nonlocal momentum
            timestep_r = None
            if use_meanflow:
                nxt = timesteps[i + 1] if i + 1 < n_steps else torch.zeros(())
                timestep_r = nxt.to(device=device, dtype=torch.float32).expand(rows)
            latent_in = torch.cat([lat, lat]) if do_cfg else lat
            pred = transformer(latent_in.to(dtype), t.to(device=device, dtype=torch.float32).expand(rows), embeds,
                               mask, timestep_r=timestep_r, encoder_hidden_states_2=embeds_2,
                               encoder_attention_mask_2=mask_2, guidance=guidance).sample.float()
            if not do_cfg:
                return pred
            cond, uncond = pred.chunk(2)
            if momentum is None:
                return guider(cond, uncond, step=i, num_steps=n_steps)
            pred, momentum = guider(cond, uncond, step=i, num_steps=n_steps, momentum=momentum)
            return pred

        latents = guided_loop(self, forward, latents, state, callback_on_step_end, self._cache_config)
        if output_type == "latent":
            image = latents
        else:
            decoded = self.vae.decode((latents / self.vae.config.scaling_factor).to(self.vae.dtype)).sample
            image = self.image_processor.postprocess(decoded, output_type=output_type)
        if not return_dict:
            return (image,)
        return HunyuanImagePipelineOutput(images=image)

"""Qwen-Image text-to-image pipeline.

Port of `diffusers_tpu/pipelines/qwenimage/pipeline_qwenimage.py`: the
prompt goes through Qwen's chat template, is tokenized to
``max_sequence_length + 34`` tokens with ``padding="max_length"``, encoded by
the Qwen2.5-VL tower, and its first 34 positions (the template's system
prefix) are dropped with their mask (`:60-77`); JAX's padding to 1,024 text
tokens is kept (the padded keys are masked, so trimming would give the same
image: ROADMAP B). True CFG: the negative prompt defaults to ``" "`` and the
pair runs as one batch-2 transformer call a step, ``[negative, positive]``
(`:90-109`). Latents are packed 2 x 2 as Flux's; the schedule is
``linspace(1, 1 / n, n)`` shifted by `calculate_shift`'s mu (`:168-180`).
The decode de-normalizes with the VAE's ``latents_mean`` / ``latents_std``
where its config has them and decodes one frame through a Wan-family 3-D
VAE, or decodes ``z / scaling_factor`` through a 2-D `AutoencoderKL`
(`:111-129`).

Only the text tower's last hidden state is kept (its final norm's output,
``hidden_states[-1]`` in JAX): the encode asks for no other layer's. Latents
stay float32; each step casts them to the prompt embeddings' dtype for the
transformer and steps the scheduler in float32. Where JAX scans the loop in
one jitted program, the port runs it step by step. The pipeline is built on
``device`` (default ``"cuda"``; see `DiffusionPipeline._place`). JAX's
pipeline honours no cache config, nor does this one.

The image-conditioned pipelines (`pipeline_qwenimage_img2img.py`,
`pipeline_qwenimage_inpaint.py`) subclass this one and share `_prompt`,
`_schedule`, `_loop` and `_decode`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from ...image_processor import VaeImageProcessor
from ...schedulers.scheduling_flow_match_euler_discrete import calculate_shift
from ...utils import BaseOutput, torch_utils
from ..flux.pipeline_flux import FluxPipeline
from ..pipeline_utils import DiffusionPipeline

PROMPT_TEMPLATE = (
    "<|im_start|>system\nDescribe the image by detailing the color, shape, size, texture, "
    "quantity, text, spatial relationships of the objects and background:<|im_end|>\n"
    "<|im_start|>user\n{}<|im_end|>\n<|im_start|>assistant\n"
)
PROMPT_TEMPLATE_START_IDX = 34


@dataclass
class QwenImagePipelineOutput(BaseOutput):
    images: Union[List, np.ndarray, torch.Tensor]


class QwenImagePipeline(DiffusionPipeline):
    def __init__(self, scheduler, vae, text_encoder, tokenizer, transformer,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.register_modules(vae=vae, text_encoder=text_encoder, tokenizer=tokenizer, transformer=transformer,
                              scheduler=scheduler)
        self.vae_scale_factor = vae.config.get("scale_factor_spatial", 8) if vae is not None else 8
        self.image_processor = VaeImageProcessor(vae_scale_factor=self.vae_scale_factor * 2)
        self.prompt_template_encode = PROMPT_TEMPLATE
        self.prompt_template_encode_start_idx = PROMPT_TEMPLATE_START_IDX
        self._place(device)

    _pack_latents = staticmethod(FluxPipeline._pack_latents)
    _unpack_latents = staticmethod(FluxPipeline._unpack_latents)

    # ---------------------------------------------------------------- text
    def _get_qwen_prompt_embeds(self, prompt: List[str], max_sequence_length: int):
        """(embeds [B, max_sequence_length, D], mask [B, max_sequence_length])
        of the templated prompts, the template's prefix dropped."""
        drop = self.prompt_template_encode_start_idx
        inputs = self.tokenizer([self.prompt_template_encode.format(p) for p in prompt],
                                max_length=max_sequence_length + drop, padding="max_length", truncation=True,
                                return_tensors="np")
        device = self.text_encoder.device
        ids = torch.as_tensor(np.asarray(inputs.input_ids), dtype=torch.long, device=device)
        mask = torch.as_tensor(np.asarray(inputs.attention_mask), dtype=torch.long, device=device)
        hidden = self.text_encoder(ids, attention_mask=mask).last_hidden_state
        return hidden[:, drop:], mask[:, drop:]

    @torch.no_grad()
    def encode_prompt(self, prompt, negative_prompt=None, do_cfg: bool = True, max_sequence_length: int = 1024):
        """(embeds, mask, negative embeds, negative mask); the negative pair
        is None without CFG. The negative prompt defaults to ``" "``."""
        prompt = [prompt] if isinstance(prompt, str) else prompt
        embeds, mask = self._get_qwen_prompt_embeds(prompt, max_sequence_length)
        if not do_cfg:
            return embeds, mask, None, None
        negative_prompt = negative_prompt or " "
        if isinstance(negative_prompt, str):
            negative_prompt = [negative_prompt] * len(prompt)
        return (embeds, mask, *self._get_qwen_prompt_embeds(negative_prompt, max_sequence_length))

    # ------------------------------------------------------------- helpers
    def _prompt(self, prompt, negative_prompt, true_cfg_scale: float, max_sequence_length: int):
        """(embeds, mask, batch size, do_cfg): under CFG the batch-2 pair
        ``[negative, positive]``."""
        do_cfg = true_cfg_scale > 1.0
        embeds, mask, neg_embeds, neg_mask = self.encode_prompt(prompt, negative_prompt, do_cfg,
                                                                max_sequence_length)
        batch_size = embeds.shape[0]
        if do_cfg:
            embeds, mask = torch.cat([neg_embeds, embeds]), torch.cat([neg_mask, mask])
        return embeds, mask, batch_size, do_cfg

    def _schedule(self, image_seq_len: int, num_inference_steps: int):
        """The scheduler state over ``linspace(1, 1 / n, n)``, shifted by the
        mu of `image_seq_len` where the scheduler shifts dynamically."""
        config = self.scheduler.config
        sigmas = np.linspace(1.0, 1 / num_inference_steps, num_inference_steps)
        mu = calculate_shift(image_seq_len, config.get("base_image_seq_len", 256),
                             config.get("max_image_seq_len", 4096), config.get("base_shift", 0.5),
                             config.get("max_shift", 1.15))
        return self.scheduler.set_timesteps(num_inference_steps, sigmas=list(sigmas), mu=mu)

    @torch.no_grad()
    def _loop(self, latents, embeds, mask, state, timesteps, img_shapes, true_cfg_scale: float, do_cfg: bool,
              blend=None):
        """The eager denoise loop over `timesteps`: one transformer call a
        step (the batch-2 CFG pair under CFG), the scheduler in float32, and
        ``blend(latents, i)``, when given, after each step."""
        t_model = (timesteps / 1000.0).to(latents.device)
        for i, t in enumerate(timesteps):
            latent_input = torch.cat([latents, latents]) if do_cfg else latents
            noise_pred = self.transformer(latent_input.to(embeds.dtype), embeds, mask,
                                          t_model[i].expand(latent_input.shape[0]), img_shapes=img_shapes).sample
            noise_pred = noise_pred.float()
            if do_cfg:
                uncond, cond = noise_pred.chunk(2)
                noise_pred = uncond + true_cfg_scale * (cond - uncond)
            latents = self.scheduler.step(state, noise_pred, t, latents).prev_sample
            if blend is not None:
                latents = blend(latents, i)
        return latents

    def _latent_stats(self, device):
        """(mean, std) [1, C, 1, 1] of the VAE's config, or None."""
        lm, ls = self.vae.config.get("latents_mean"), self.vae.config.get("latents_std")
        if lm is None or ls is None:
            return None
        return (torch.tensor(list(lm), dtype=torch.float32, device=device).reshape(1, -1, 1, 1),
                torch.tensor(list(ls), dtype=torch.float32, device=device).reshape(1, -1, 1, 1))

    def _is_video_vae(self) -> bool:
        config = dict(self.vae.config)
        return "temperal_downsample" in config or "scale_factor_temporal" in config

    @torch.no_grad()
    def _decode(self, latents, height: int, width: int, output_type: str, return_dict: bool):
        """The final packed latents ("latent"), or their decode ("np": float32
        NHWC in [0, 1]; "pil")."""
        if output_type == "latent":
            image = latents
        else:
            z = self._unpack_latents(latents, height, width, self.vae_scale_factor)
            stats = self._latent_stats(z.device)
            if stats is not None:
                z = z * stats[1] + stats[0]
            if self._is_video_vae():  # Wan-family 3-D VAE: one frame
                decoded = self.vae.decode(z[:, :, None].to(self.vae.dtype)).sample[:, :, 0]
            else:
                decoded = self.vae.decode((z / self.vae.config.scaling_factor).to(self.vae.dtype)).sample
            image = self.image_processor.postprocess(decoded, output_type=output_type)
        if not return_dict:
            return (image,)
        return QwenImagePipelineOutput(images=image)

    # ------------------------------------------------------------ __call__
    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 50,
        true_cfg_scale: float = 4.0,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        max_sequence_length: int = 1024,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Text-to-image. `latents`, when given, are packed ([B, seq, 4 C]).
        `output_type`: "pil", "np" (float32 NHWC in [0, 1]) or "latent" (the
        final packed latents)."""
        device = self.transformer.device
        embeds, mask, batch_size, do_cfg = self._prompt(prompt, negative_prompt, true_cfg_scale,
                                                        max_sequence_length)
        lh = 2 * (height // (self.vae_scale_factor * 2))
        lw = 2 * (width // (self.vae_scale_factor * 2))
        if latents is None:
            shape = (batch_size, self.transformer.config.in_channels // 4, lh, lw)
            latents = self._pack_latents(torch_utils.randn_tensor(shape, generator, device))
        latents = latents.to(device=device, dtype=torch.float32)
        state = self._schedule(latents.shape[1], num_inference_steps)
        latents = self._loop(latents, embeds, mask, state, state.timesteps, [(1, lh // 2, lw // 2)], true_cfg_scale,
                             do_cfg)
        return self._decode(latents, height, width, output_type, return_dict)

"""HunyuanVideo FramePack image-to-video pipeline (sectioned long video).

Port of `diffusers_tpu/pipelines/hunyuan_video/pipeline_hunyuan_video_framepack.py`:
the video is made in sections of `latent_window_size` latent frames. Each
section conditions on the image's latents and a [1x, 2x, 4x] history
pyramid with explicit frame indices: `INVERTED_ANTI_DRIFTING` makes the
sections back to front, the history of sizes [1, 2, 16] in front of the
made frames; `VANILLA` front to back, [16, 2, 1] behind them. The SigLIP
image embeds (averaged with `last_image`'s, whose latents then stand for the
first section's 1x history) go in as image tokens, the guidance is the
distilled ``guidance_scale * 1000``, and true CFG is a second call a step.
Every section takes the same schedule (the flow-match shift of its token
count where the scheduler shifts dynamically). Each section's frames are
decoded and joined to the others by `_soft_append`'s linear crossfade over
the overlap. Frames come out as float32 ``[B, F, H, W, C]`` in [0, 1] ("np")
or as the whole history of latents ("latent").

Random draws go through `utils.torch_utils.randn_tensor` in the order JAX
uses its keys: the image's posterior sample, `last_image`'s, then each
section's latents. JAX's `_supported_cache_configs` is empty, so
`enable_cache` raises `TypeError`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ...schedulers.scheduling_flow_match_euler_discrete import calculate_shift
from ...utils import torch_utils
from ...video_processor import VideoProcessor
from .pipeline_hunyuan_video import DEFAULT_PROMPT_TEMPLATE, HunyuanVideoPipeline, HunyuanVideoPipelineOutput


@torch.no_grad()
def siglip_image_embeds(image_encoder, feature_extractor, image: np.ndarray) -> torch.Tensor:
    """SigLIP's last hidden state of a [-1, 1] NCHW image (JAX `:60-69`):
    the image mapped to [0, 1] through the feature extractor (no rescale)
    where there is one, else the raw pixels."""
    img01 = np.asarray(image) * 0.5 + 0.5
    if feature_extractor is not None:
        pixel_values = np.asarray(feature_extractor(images=img01, return_tensors="np", do_rescale=False)["pixel_values"])
    else:
        pixel_values = img01 * 2.0 - 1.0
    pixels = torch.as_tensor(pixel_values, dtype=image_encoder.dtype, device=image_encoder.device)
    return image_encoder(pixels).last_hidden_state


class FramepackSamplingType:
    VANILLA = "vanilla"
    INVERTED_ANTI_DRIFTING = "inverted_anti_drifting"


class HunyuanVideoFramepackPipeline(HunyuanVideoPipeline):
    _supported_cache_configs = ()

    def __init__(self, text_encoder, tokenizer, transformer, vae, scheduler, text_encoder_2, tokenizer_2,
                 image_encoder, feature_extractor=None, device: Union[str, torch.device] = "cuda"):
        super().__init__(text_encoder=text_encoder, tokenizer=tokenizer, transformer=transformer, vae=vae,
                         scheduler=scheduler, text_encoder_2=text_encoder_2, tokenizer_2=tokenizer_2, device=device)
        self.register_modules(image_encoder=image_encoder, feature_extractor=feature_extractor)
        self.video_processor = VideoProcessor(vae_scale_factor=self.vae_scale_factor_spatial)
        self._place(device)

    # --------------------------------------------------------------- image
    @torch.no_grad()
    def encode_image(self, image: np.ndarray) -> torch.Tensor:
        return siglip_image_embeds(self.image_encoder, self.feature_extractor, image)

    @torch.no_grad()
    def _encode_image_latents(self, image: np.ndarray, generator) -> torch.Tensor:
        vae = self.vae
        x = torch.as_tensor(image, dtype=vae.dtype, device=vae.device)[:, :, None]
        return vae.encode(x).latent_dist.sample(generator).float() * vae.config.scaling_factor

    @staticmethod
    def _soft_append(history: np.ndarray, current: np.ndarray, overlap: int = 0) -> np.ndarray:
        """Linear crossfade over `overlap` frames (JAX `:105-112`)."""
        if overlap <= 0:
            return np.concatenate([history, current], axis=2)
        w = np.linspace(1, 0, overlap, dtype=history.dtype).reshape(1, 1, -1, 1, 1)
        blended = w * history[:, :, -overlap:] + (1 - w) * current[:, :, :overlap]
        return np.concatenate([history[:, :, :-overlap], blended, current[:, :, overlap:]], axis=2)

    def _decode_section(self, latents: torch.Tensor) -> np.ndarray:
        vae = self.vae
        video = vae.decode((latents / vae.config.scaling_factor).to(vae.dtype)).sample
        return video.float().cpu().numpy()

    def _section_schedule(self, num_inference_steps, sigmas, latent_window_size, lh, lw):
        if sigmas is None:
            sigmas = np.linspace(1.0, 0.0, num_inference_steps + 1)[:-1]
        config = self.scheduler.config
        if not config.get("use_dynamic_shifting", False):
            return self.scheduler.set_timesteps(sigmas=list(sigmas))
        seq_len = latent_window_size * lh * lw / self.transformer.config.patch_size ** 2
        mu = calculate_shift(seq_len, config.get("base_image_seq_len", 256), config.get("max_image_seq_len", 4096),
                             config.get("base_shift", 0.5), config.get("max_shift", 1.15))
        return self.scheduler.set_timesteps(sigmas=list(sigmas), mu=min(mu, math.log(7.0)))

    @staticmethod
    def section_layout(k: int, num_sections: int, latent_window_size: int, inverted: bool):
        """(frame indices of the section's latents, clean, 2x and 4x history)
        of section `k` (JAX `:214-242`)."""
        if inverted:
            paddings = list(reversed(range(num_sections)))
            if num_sections > 4:
                paddings = [3] + [2] * (num_sections - 3) + [1, 0]
            splits = [1, paddings[k] * latent_window_size, latent_window_size, 1, 2, 16]
            offs = np.cumsum([0] + splits)
            prefix, latents_idx, idx_1x, idx_2x, idx_4x = (
                np.arange(offs[0], offs[1]), np.arange(offs[2], offs[3]), np.arange(offs[3], offs[4]),
                np.arange(offs[4], offs[5]), np.arange(offs[5], offs[6]))
        else:
            splits = [1, 16, 2, 1, latent_window_size]
            offs = np.cumsum([0] + splits)
            prefix, idx_4x, idx_2x, idx_1x, latents_idx = (np.arange(offs[i], offs[i + 1]) for i in range(5))
        return latents_idx, np.concatenate([prefix, idx_1x]), idx_2x, idx_4x

    def _predict_section(self, latents, t, prompt, image_embeds, guidance, rope, history):
        timestep = t.to(latents.device).expand(latents.shape[0])
        dtype = self.transformer.dtype
        clean, h2x, h4x = (h.to(dtype) for h in history)
        return self.transformer(latents.to(dtype), timestep, prompt.embeds, prompt.mask, prompt.pooled,
                                image_embeds=image_embeds, guidance=guidance, latents_clean=clean,
                                latents_history_2x=h2x, latents_history_4x=h4x,
                                image_rotary_emb=rope).sample.float()

    @torch.no_grad()
    def _denoise_section(self, latents, positive, negative, image_embeds, guidance, rope, history, state,
                         true_cfg_scale):
        for t in state.timesteps:
            pred = self._predict_section(latents, t, positive, image_embeds, guidance, rope, history)
            if negative is not None:
                neg = self._predict_section(latents, t, negative, image_embeds, guidance, rope, history)
                pred = neg + true_cfg_scale * (pred - neg)
            latents = self.scheduler.step(state, pred, t, latents).prev_sample
        return latents

    # ------------------------------------------------------------ __call__
    @torch.no_grad()
    def __call__(
        self,
        image=None,
        last_image=None,
        prompt: Union[str, List[str]] = None,
        prompt_2: Optional[Union[str, List[str]]] = None,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        height: int = 720,
        width: int = 1280,
        num_frames: int = 129,
        latent_window_size: int = 9,
        num_inference_steps: int = 50,
        sigmas: Optional[List[float]] = None,
        true_cfg_scale: float = 1.0,
        guidance_scale: float = 6.0,
        generator: Optional[torch.Generator] = None,
        prompt_template: Dict[str, Any] = DEFAULT_PROMPT_TEMPLATE,
        max_sequence_length: int = 256,
        sampling_type: str = FramepackSamplingType.INVERTED_ANTI_DRIFTING,
        output_type: str = "np",
        return_dict: bool = True,
    ):
        """Image-to-video from `image` (and `last_image`) in sections."""
        if sampling_type not in (FramepackSamplingType.VANILLA, FramepackSamplingType.INVERTED_ANTI_DRIFTING):
            raise ValueError(f"invalid sampling_type {sampling_type!r}")
        device = self.transformer.device
        positive, negative = self._prompts(prompt, prompt_2, negative_prompt, true_cfg_scale, prompt_template,
                                           max_sequence_length)
        batch_size = positive.embeds.shape[0]

        image = self.video_processor.preprocess(image, height, width)
        image_embeds = self.encode_image(image)
        image_latents = self._encode_image_latents(image, generator)
        last_image_latents = None
        if last_image is not None:
            last_image = self.video_processor.preprocess(last_image, height, width)
            image_embeds = (image_embeds + self.encode_image(last_image)) / 2
            last_image_latents = self._encode_image_latents(last_image, generator)
        image_embeds = image_embeds.expand(batch_size, *image_embeds.shape[1:]).to(self.transformer.dtype)

        channels = self.transformer.config.in_channels
        window_num_frames = (latent_window_size - 1) * self.vae_scale_factor_temporal + 1
        num_sections = max(1, (num_frames + window_num_frames - 1) // window_num_frames)
        lh, lw = height // self.vae_scale_factor_spatial, width // self.vae_scale_factor_spatial
        inverted = sampling_type == FramepackSamplingType.INVERTED_ANTI_DRIFTING
        history_sizes = [1, 2, 16] if inverted else [16, 2, 1]
        history = torch.zeros((batch_size, channels, sum(history_sizes), lh, lw), dtype=torch.float32, device=device)
        if not inverted:
            history = torch.cat([history, image_latents], dim=2)
        total_generated = 0 if inverted else 1

        guidance = self._guidance(batch_size, guidance_scale, device)
        state = self._section_schedule(num_inference_steps, sigmas, latent_window_size, lh, lw)
        overlap = (latent_window_size - 1) * self.vae_scale_factor_temporal + 1
        video = None
        for k in range(num_sections):
            is_first, is_last = k == 0, k == num_sections - 1
            idx_latents, idx_clean, idx_2x, idx_4x = self.section_layout(k, num_sections, latent_window_size,
                                                                         inverted)
            pyramid = history[:, :, :sum(history_sizes)] if inverted else history[:, :, -sum(history_sizes):]
            parts = torch.split(pyramid, history_sizes, dim=2)
            h1x, h2x, h4x = parts if inverted else parts[::-1]
            if inverted and last_image_latents is not None and is_first:
                h1x = last_image_latents
            clean = torch.cat([image_latents, h1x], dim=2)
            cos, sin = self.transformer.pack_rope(lh, lw, idx_latents, idx_clean, idx_2x, idx_4x)
            rope = (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))

            latents = torch_utils.randn_tensor((batch_size, channels, latent_window_size, lh, lw), generator,
                                               device).to(torch.float32)
            latents = self._denoise_section(latents, positive, negative, image_embeds, guidance, rope,
                                            (clean, h2x, h4x), state, true_cfg_scale)

            if inverted:
                if is_last:
                    latents = torch.cat([image_latents, latents], dim=2)
                total_generated += latents.shape[2]
                history = torch.cat([latents, history], dim=2)
                real_history = history[:, :, :total_generated]
                section = real_history[:, :, :latent_window_size * 2 + (1 if is_last else 0)]
            else:
                total_generated += latents.shape[2]
                history = torch.cat([history, latents], dim=2)
                real_history = history[:, :, -total_generated:]
                section = real_history[:, :, -latent_window_size * 2:]

            if output_type == "latent":
                video = real_history
            elif video is None:
                video = self._decode_section(real_history)
            else:
                current = self._decode_section(section)
                video = (self._soft_append(current, video, overlap) if inverted
                         else self._soft_append(video, current, overlap))

        if output_type != "latent":
            n = (video.shape[2] - 1) // self.vae_scale_factor_temporal * self.vae_scale_factor_temporal + 1
            video = np.transpose(np.clip(video[:, :, :n] / 2 + 0.5, 0, 1), (0, 2, 3, 4, 1))
        if not return_dict:
            return (video,)
        return HunyuanVideoPipelineOutput(frames=video)

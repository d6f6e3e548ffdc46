"""LTX-Video condition pipeline (LTX-Video 0.9.5's multi-conditioning).

Port of `diffusers_tpu/pipelines/ltx/pipeline_ltx_condition.py`: image and
video conditions (`LTXVideoCondition`) are VAE-encoded, normalized and
lerped into the noise by their strength at their latent frames; a
condition at a nonzero ``frame_index`` adds its first two latent frames as
prefix tokens, lerped from their own noise, with video ids scaled to pixel
and frame units and shifted by the index (`_scale_video_ids`, `:61-79`),
and lerps any later frames into the video at ``frame_index / 8 + 2``. Each
step clamps every token's timestep to ``(1 - conditioning_mask) 1000``,
steps each token from its own sigma (`FlowMatchEulerDiscreteScheduler.step`
with ``per_token_timesteps``) and updates only the tokens whose noise level
is at or above the step's (`:93-143`); before the step, the hard
conditioning tokens (strength 1) may be re-noised from the clean condition
by ``image_cond_noise_scale (t / 1000)^2``. The default schedule is Mochi's
linear-quadratic ladder; ``denoise_strength`` < 1 starts from given latents
part way down it. The conditioning mask, the ids and the packing are made
on the host.

Every draw comes from one `torch.Generator` through
`utils.torch_utils.randn_tensor`, in the order: the base noise; for each
condition its encoder sample, then (at a nonzero index) its prefix noise;
one re-noising draw a step; the decode's noise and the decoder's injected
noise. JAX draws them from split keys (ROADMAP C3). JAX's loop here reads no
cache config, and this pipeline accepts none.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Union

import numpy as np
import torch

from ...utils import torch_utils
from ...video_processor import VideoProcessor
from .pipeline_ltx import LTXPipeline, LTXPipelineOutput


@dataclass
class LTXVideoCondition:
    """One conditioning item: an image or a video placed at `frame_index`
    with blend `strength`."""

    image: Any = None
    video: Any = None
    frame_index: int = 0
    strength: float = 1.0


def linear_quadratic_schedule(num_steps, threshold_noise, linear_steps=None):
    """Mochi's sigma ladder (JAX `pipelines/mochi/pipeline_mochi.py:34`)."""
    if num_steps == 1:
        return [1.0]
    if linear_steps is None:
        linear_steps = num_steps // 2
    linear_sigma_schedule = [i * threshold_noise / linear_steps for i in range(linear_steps)]
    threshold_noise_step_diff = linear_steps - threshold_noise * num_steps
    quadratic_steps = num_steps - linear_steps
    quadratic_coef = threshold_noise_step_diff / (linear_steps * quadratic_steps**2)
    linear_coef = threshold_noise / linear_steps - 2 * threshold_noise_step_diff / (quadratic_steps**2)
    const = quadratic_coef * (linear_steps**2)
    quadratic_sigma_schedule = [quadratic_coef * (i**2) + linear_coef * i + const
                                for i in range(linear_steps, num_steps)]
    return [1.0 - x for x in linear_sigma_schedule + quadratic_sigma_schedule]


class LTXConditionPipeline(LTXPipeline):
    _supported_cache_configs = ()

    def __init__(self, scheduler, vae, text_encoder, tokenizer, transformer,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(scheduler=scheduler, vae=vae, text_encoder=text_encoder, tokenizer=tokenizer,
                         transformer=transformer, device=device)
        self.video_processor = VideoProcessor(vae_scale_factor=self.vae_spatial_compression_ratio)

    @staticmethod
    def _prepare_video_ids(batch_size, num_frames, height, width, patch_size=1, patch_size_t=1):
        gf, gh, gw = np.meshgrid(np.arange(0, num_frames, patch_size_t), np.arange(0, height, patch_size),
                                 np.arange(0, width, patch_size), indexing="ij")
        coords = np.stack([gf, gh, gw], axis=0).reshape(3, -1)
        return np.broadcast_to(coords[None], (batch_size, 3, coords.shape[-1])).astype(np.float32).copy()

    @staticmethod
    def _scale_video_ids(video_ids, scale_factor=32, scale_factor_t=8, frame_index=0):
        scaled = video_ids * np.array([scale_factor_t, scale_factor, scale_factor], dtype=np.float32)[None, :, None]
        scaled[:, 0] = np.clip(scaled[:, 0] + 1 - scale_factor_t, 0, None)
        scaled[:, 0] += frame_index
        return scaled

    def trim_conditioning_sequence(self, start_frame: int, sequence_num_frames: int, target_num_frames: int) -> int:
        """The frames of a condition video kept so that it ends inside the
        output and keeps the ``k * ratio + 1`` form."""
        scale = self.vae_temporal_compression_ratio
        num_frames = min(sequence_num_frames, target_num_frames - start_frame)
        return (num_frames - 1) // scale * scale + 1

    def _encode_condition(self, tensor: np.ndarray, generator) -> torch.Tensor:
        vae = self.vae
        pixels = torch.from_numpy(np.ascontiguousarray(tensor, dtype=np.float32)).to(device=vae.device,
                                                                                      dtype=vae.dtype)
        lat = vae.encode(pixels).latent_dist.sample(generator).float()
        return self._normalize_latents(lat, vae.latents_mean, vae.latents_std, vae.config.scaling_factor)

    @staticmethod
    def _conditions(conditions, image, video, frame_index, strength):
        """(images, videos, frame indices, strengths), one entry a condition."""
        if conditions is not None:
            conditions = conditions if isinstance(conditions, list) else [conditions]
            return ([c.image for c in conditions], [c.video for c in conditions],
                    [c.frame_index for c in conditions], [c.strength for c in conditions])
        if image is None and video is None:
            return [], [], [], []
        images = image if isinstance(image, list) else ([image] if image is not None else [])
        videos = video if isinstance(video, list) else ([video] if video is not None else [])
        n = max(len(images), len(videos))
        return (images or [None] * n, videos or [None] * n,
                frame_index if isinstance(frame_index, list) else [frame_index] * n,
                strength if isinstance(strength, list) else [strength] * n)

    @torch.no_grad()
    def _denoise_condition(self, latents, init_latents, conditioning_mask, embeds, mask, video_coords, timesteps,
                           state, generator, guidance_scale, do_cfg, image_cond_noise_scale):
        has_cond = conditioning_mask is not None
        dtype = embeds.dtype
        cmask2 = torch.cat([conditioning_mask] * 2) if has_cond and do_cfg else conditioning_mask
        for t in timesteps:
            t_dev = t.to(latents.device)
            lat = latents
            if has_cond and image_cond_noise_scale > 0:
                noise = torch_utils.randn_tensor(latents.shape, generator, latents.device)
                hard = (conditioning_mask > 1.0 - 1e-6)[..., None]
                lat = torch.where(hard, init_latents + image_cond_noise_scale * noise * (t_dev / 1000.0) ** 2,
                                  latents)
            latent_in = torch.cat([lat, lat]) if do_cfg else lat
            tt = t_dev.expand(latent_in.shape[0], 1).float()
            if has_cond:
                tt = torch.minimum(tt, (1.0 - cmask2) * 1000.0)
            noise_pred = self.transformer(latent_in.to(dtype), embeds, tt, encoder_attention_mask=mask,
                                          video_coords=video_coords).sample.float()
            if do_cfg:
                uncond, text = noise_pred.chunk(2)
                noise_pred = uncond + guidance_scale * (text - uncond)
                tt = tt[: lat.shape[0]]
            denoised = self.scheduler.step(state, noise_pred, t, lat,
                                           per_token_timesteps=tt if has_cond else None).prev_sample
            if has_cond:
                to_denoise = ((t_dev / 1000.0 - 1e-6) < (1.0 - conditioning_mask))[..., None]
                latents = torch.where(to_denoise, denoised, lat)
            else:
                latents = denoised
        return latents

    @torch.no_grad()
    def __call__(
        self,
        conditions: Optional[Union[LTXVideoCondition, List[LTXVideoCondition]]] = None,
        image=None,
        video=None,
        frame_index: Union[int, List[int]] = 0,
        strength: Union[float, List[float]] = 1.0,
        denoise_strength: float = 1.0,
        prompt: Union[str, List[str]] = None,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        height: int = 512,
        width: int = 704,
        num_frames: int = 161,
        frame_rate: int = 25,
        num_inference_steps: int = 50,
        timesteps: Optional[List[float]] = None,
        guidance_scale: float = 3.0,
        image_cond_noise_scale: float = 0.15,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        decode_timestep: float = 0.0,
        decode_noise_scale: Optional[float] = None,
        max_sequence_length: int = 128,
        output_type: str = "np",
        return_dict: bool = True,
    ):
        """Video generation under `conditions` (or `image` / `video` with
        `frame_index` and `strength`, one value or a list). `latents`
        (normalized, [B, C, F', H', W']) start the loop, noised to the
        schedule's sigma where `denoise_strength` < 1."""
        if not 0 <= denoise_strength <= 1:
            raise ValueError(f"denoise_strength must be in [0, 1], got {denoise_strength}")
        device = self.transformer.device
        images, videos, frame_index, strength = self._conditions(conditions, image, video, frame_index, strength)
        do_cfg = guidance_scale > 1.0
        embeds, mask, batch_size = self._prompt(prompt, negative_prompt, do_cfg, max_sequence_length)
        ratio_t, ratio_s = self.vae_temporal_compression_ratio, self.vae_spatial_compression_ratio

        tensors = []  # pixel-space conditions [B, C, T, H, W]
        for img, vid, fi in zip(images, videos, frame_index):
            if img is not None:
                t_in = self.video_processor.preprocess(img, height=height, width=width)
                t_in = t_in[:, :, None] if t_in.ndim == 4 else t_in
            elif vid is not None:
                t_in = self.video_processor.preprocess_video(vid, height=height, width=width)
                t_in = t_in[:, :, : self.trim_conditioning_sequence(fi, t_in.shape[2], num_frames)]
            else:
                raise ValueError("Each condition needs `image` or `video`.")
            if t_in.shape[2] % ratio_t != 1:
                raise ValueError(f"Condition frames must be k*{ratio_t}+1, got {t_in.shape[2]}")
            tensors.append(t_in)
        has_cond = bool(tensors)

        f_lat, h_lat, w_lat = self._latent_grid(height, width, num_frames)
        p, pt = self.transformer_spatial_patch_size, self.transformer_temporal_patch_size
        if timesteps is None:
            timesteps = np.asarray(linear_quadratic_schedule(num_inference_steps, 0.025)) * 1000.0
        state = self.scheduler.set_timesteps(timesteps=list(np.asarray(timesteps)))
        sched_timesteps, latent_sigma = state.timesteps, None
        if denoise_strength < 1:
            start = max(num_inference_steps - min(int(num_inference_steps * denoise_strength), num_inference_steps), 0)
            sched_timesteps, latent_sigma = sched_timesteps[start:], float(state.sigmas[start])

        shape = (batch_size, self.transformer.config.in_channels, f_lat, h_lat, w_lat)
        noise = torch_utils.randn_tensor(shape, generator, device)
        if latents is not None:
            latents = latents.to(device=device, dtype=torch.float32)
            base = latent_sigma * noise + (1 - latent_sigma) * latents if latent_sigma is not None else latents
        else:
            base = noise.clone()

        cond_frames_mask = np.zeros((batch_size, f_lat), np.float32)
        extra_latents, extra_ids, extra_masks = [], [], []
        for tensor, s, fi in zip(tensors, strength, frame_index):
            cond_lat = self._encode_condition(tensor, generator).to(device)
            if cond_lat.shape[0] < batch_size:
                cond_lat = cond_lat.repeat_interleave(batch_size // cond_lat.shape[0], dim=0)
            ncf = cond_lat.shape[2]
            if fi == 0:
                base[:, :, :ncf] = base[:, :, :ncf] + s * (cond_lat - base[:, :, :ncf])
                cond_frames_mask[:, :ncf] = s
                continue
            n_prefix = 2
            if tensor.shape[2] > 1:
                if ncf < n_prefix:
                    raise ValueError(f"Condition video needs >= {n_prefix} latent frames, got {ncf}")
                if ncf > n_prefix:
                    sf = fi // ratio_t + n_prefix
                    ef = sf + ncf - n_prefix
                    base[:, :, sf:ef] = base[:, :, sf:ef] + s * (cond_lat[:, :, n_prefix:] - base[:, :, sf:ef])
                    cond_frames_mask[:, sf:ef] = s
                    cond_lat = cond_lat[:, :, :n_prefix]
            cnoise = torch_utils.randn_tensor(cond_lat.shape, generator, device)
            cond_lat = cnoise + s * (cond_lat - cnoise)
            ids = self._prepare_video_ids(batch_size, cond_lat.shape[2], h_lat, w_lat, patch_size=p, patch_size_t=pt)
            extra_ids.append(self._scale_video_ids(ids, ratio_s, ratio_t, frame_index=fi))
            packed = self._pack_latents(cond_lat, p, pt)
            extra_latents.append(packed)
            extra_masks.append(np.full((batch_size, packed.shape[1]), s, np.float32))

        video_ids = self._prepare_video_ids(batch_size, f_lat, h_lat, w_lat, patch_size=p, patch_size_t=pt)
        conditioning_mask = (np.take_along_axis(cond_frames_mask, video_ids[:, 0].astype(np.int64), axis=1)
                             if has_cond else None)
        video_ids = self._scale_video_ids(video_ids, ratio_s, ratio_t, frame_index=0)
        packed_latents = self._pack_latents(base, p, pt)
        extra_num = 0
        if extra_latents:
            extra_num = int(sum(e.shape[1] for e in extra_latents))
            packed_latents = torch.cat([*extra_latents, packed_latents], dim=1)
            video_ids = np.concatenate([*extra_ids, video_ids], axis=2)
            conditioning_mask = np.concatenate([*extra_masks, conditioning_mask], axis=1)

        video_coords = video_ids.astype(np.float32)
        video_coords[:, 0] *= 1.0 / frame_rate
        if do_cfg:
            video_coords = np.concatenate([video_coords, video_coords], axis=0)
        cmask = torch.from_numpy(conditioning_mask).to(device) if has_cond else None
        latents = self._denoise_condition(packed_latents, packed_latents if has_cond else None, cmask, embeds, mask,
                                          torch.from_numpy(video_coords).to(device), sched_timesteps, state,
                                          generator, guidance_scale, do_cfg, float(image_cond_noise_scale))
        latents = self._unpack_latents(latents[:, extra_num:], f_lat // pt, h_lat // p, w_lat // p, p, pt)
        if output_type == "latent":
            video_out = latents
        else:
            video_out = self.decode_latents(latents, generator, decode_timestep, decode_noise_scale)
        if not return_dict:
            return (video_out,)
        return LTXPipelineOutput(frames=video_out)

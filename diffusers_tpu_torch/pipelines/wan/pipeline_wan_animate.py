"""Wan-Animate pipeline (character animation and replacement).

Port of `diffusers_tpu/pipelines/wan/pipeline_wan_animate.py`
(`WanAnimatePipeline` `:34`): the video is made in segments of
`segment_frame_length` frames (1 + 4 k), each after the first starting on
the last `prev_segment_conditioning_frames` frames of the one before; the
pose and face videos are padded by reflection to a whole number of segments
(`pad_video_frames` `:80`, geometry `:160-166`). A segment's transformer
input stacks, on the channel axis, the noisy latents and the reference
latents: in frame 0 the character image's latents behind the image-to-video
mask (`get_i2v_mask` `:65`), then the previous-segment conditioning video's
latents behind its mask (zeros in animate mode; in replace mode the
background video, with the inverted person mask resized to the latent grid
by nearest indices). The character image also gives the CLIP image context
(the vision tower's penultimate hidden states, through
`clip_image_preprocess`, unless `image_embeds` is given); the pose video's
latents are added to patch frames 1 and later; the face video becomes the
motion tokens, encoded once a segment (`encode_face_motion`). CFG: a cond
and an uncond batch-1 call a step, the uncond one with the face frames
blanked to -1. Each segment's decode drops the reference frame and, after
the first segment, the conditioning frames; the video is cut to the pose
video's length.

Inputs: `image` a PIL image or an HWC array at `height` x `width` (the VAE
takes it through `VideoProcessor.preprocess`: PIL in 0..255, arrays in [0, 1]
or [-1, 1]); `pose_video`, `face_video` (at the motion encoder's size),
`background_video` and `mask_video` as frame lists or [1, C, T, H, W]
arrays (`VideoProcessor.preprocess_video`'s rules). No cache config is
accepted (JAX `_supported_cache_configs = ()`). `max_sequence_length`
defaults to 512 (JAX: 226); with an image branch (`added_kv_proj_dim`) any
other length raises ValueError, as in `WanImageToVideoPipeline`. Every random draw goes
through `utils.torch_utils.randn_tensor`; the pipeline is built on
``device`` (default ``"cuda"``).
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from ...models.text_encoders.clip import clip_image_preprocess, clip_processor_numbers
from ...models.transformers.transformer_wan import TEXT_CONTEXT_LENGTH
from ...utils import torch_utils
from ...video_processor import VideoProcessor
from ..pipeline_utils import DiffusionPipeline
from .pipeline_wan import WanPipeline, WanPipelineOutput
from .pipeline_wan_i2v import WanImageToVideoPipeline
from .pipeline_wan_vace import nearest_indices


class WanAnimatePipeline(DiffusionPipeline):
    _optional_components = ["image_encoder", "image_processor"]
    _supported_cache_configs = ()

    def __init__(self, tokenizer, text_encoder, transformer, vae, scheduler, image_encoder=None, image_processor=None,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.register_modules(vae=vae, text_encoder=text_encoder, tokenizer=tokenizer, transformer=transformer,
                              scheduler=scheduler, image_encoder=image_encoder, image_processor=image_processor)
        self.vae_scale_factor_temporal = vae.config.scale_factor_temporal if vae is not None else 4
        self.vae_scale_factor_spatial = vae.config.scale_factor_spatial if vae is not None else 8
        self.video_processor = VideoProcessor(vae_scale_factor=self.vae_scale_factor_spatial)
        self._place(device)

    _get_t5_prompt_embeds = WanPipeline._get_t5_prompt_embeds
    encode_prompt = WanPipeline.encode_prompt

    # ------------------------------------------------------------- helpers
    @torch.no_grad()
    def encode_image(self, image) -> torch.Tensor:
        """The CLIP vision tower's penultimate hidden states [N, tokens, D]."""
        encoder = self.image_encoder
        pixels = clip_image_preprocess(image, device=encoder.device, **clip_processor_numbers(self.image_processor))
        return encoder(pixels.to(encoder.dtype), output_hidden_states=True).hidden_states[-2]

    def _latent_stats(self, device):
        cfg = self.vae.config
        return (torch.tensor(cfg.latents_mean, device=device).reshape(1, -1, 1, 1, 1),
                torch.tensor(cfg.latents_std, device=device).reshape(1, -1, 1, 1, 1))

    @torch.no_grad()
    def _encode_video_latents(self, video: torch.Tensor) -> torch.Tensor:
        """Normalised `mode()` latents of `video` [B, 3, T, H, W], float32."""
        mean, std = self._latent_stats(video.device)
        return (self.vae.encode(video.to(self.vae.dtype)).mode().float() - mean) / std

    def get_i2v_mask(self, batch_size: int, latent_t: int, latent_h: int, latent_w: int, mask_len: int = 1,
                     mask_pixel_values: Optional[np.ndarray] = None) -> np.ndarray:
        """The image-to-video mask folded to the temporal scale's channels:
        float32 [B, s, latent_t, H, W], ones on the first `mask_len` frames
        (frame 0 repeated s times), zeros or `mask_pixel_values` after."""
        s = self.vae_scale_factor_temporal
        if mask_pixel_values is None:
            mask = np.zeros((batch_size, 1, (latent_t - 1) * s + 1, latent_h, latent_w), np.float32)
        else:
            mask = np.array(mask_pixel_values, np.float32)
        mask[:, :, :mask_len] = 1
        mask = np.concatenate([np.repeat(mask[:, :, 0:1], s, axis=2), mask[:, :, 1:]], axis=2)
        return np.ascontiguousarray(mask.reshape(batch_size, -1, s, latent_h, latent_w).transpose(0, 2, 1, 3, 4))

    @staticmethod
    def pad_video_frames(frames, num_target_frames: int) -> list:
        """Frames padded to `num_target_frames` by walking back and forth."""
        idx, flip, out = 0, False, []
        while len(out) < num_target_frames:
            out.append(frames[idx])
            idx = idx - 1 if flip else idx + 1
            if idx == 0 or idx == len(frames) - 1:
                flip = not flip
        return out

    @staticmethod
    def _frames(video) -> list:
        if isinstance(video, (list, tuple)):
            return list(video)
        video = video.detach().cpu().numpy() if isinstance(video, torch.Tensor) else np.asarray(video)
        return list(np.moveaxis(video[0], 1, 0))  # [1, C, T, H, W] -> T frames of [C, H, W]

    def _video(self, frames, height: int, width: int, device) -> torch.Tensor:
        return torch.from_numpy(self.video_processor.preprocess_video(frames, height=height, width=width)).to(device)

    def _predict(self, latent_in, t, embeds, image_embeds, pose_latents, motion_vec, rope) -> torch.Tensor:
        tr = self.transformer
        out = tr(latent_in.to(tr.dtype), t.expand(latent_in.shape[0]), embeds,
                 encoder_hidden_states_image=image_embeds.to(tr.dtype), pose_hidden_states=pose_latents.to(tr.dtype),
                 motion_vec=motion_vec, rotary_emb=rope)
        return out.sample.float()

    # ------------------------------------------------------------ __call__
    @torch.no_grad()
    def __call__(
        self,
        image=None,
        pose_video=None,
        face_video=None,
        background_video=None,
        mask_video=None,
        prompt: Union[str, List[str]] = None,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        height: int = 720,
        width: int = 1280,
        segment_frame_length: int = 77,
        prev_segment_conditioning_frames: int = 1,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        mode: str = "animate",
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        image_embeds: Optional[torch.Tensor] = None,
        max_sequence_length: int = 512,
        output_type: str = "np",
        return_dict: bool = True,
    ):
        """Character animation (`mode="animate"`) or replacement
        (`mode="replace"`, with `background_video` and `mask_video`).
        `latents`, when given, start the first segment. `output_type`: "np"
        (float32 frames [B, T, H, W, C] in [0, 1], T the pose video's length)
        or "latent" (the last segment's latents)."""
        if mode not in ("animate", "replace"):
            raise ValueError(f"mode must be 'animate' or 'replace', got {mode!r}")
        if mode == "replace" and (background_video is None or mask_video is None):
            raise ValueError("replace mode requires background_video and mask_video")
        tr, device = self.transformer, self.transformer.device
        if WanImageToVideoPipeline._has_image_branch(tr) and max_sequence_length != TEXT_CONTEXT_LENGTH:
            raise ValueError(f"with an image branch the transformer takes the tokens before the last "
                             f"{TEXT_CONTEXT_LENGTH} as the image's: max_sequence_length must be "
                             f"{TEXT_CONTEXT_LENGTH}, got {max_sequence_length}")
        rt, prev_n = self.vae_scale_factor_temporal, prev_segment_conditioning_frames
        if segment_frame_length % rt != 1:
            segment_frame_length = max(segment_frame_length // rt * rt + 1, 1)

        do_cfg = guidance_scale > 1.0
        prompt_embeds, negative_embeds = self.encode_prompt(prompt, negative_prompt, do_cfg, max_sequence_length)
        batch_size = prompt_embeds.shape[0]

        # the segment geometry (JAX `:160-166`)
        pose_frames, face_frames = self._frames(pose_video), self._frames(face_video)
        cond_video_frames = len(pose_frames)
        effective = segment_frame_length - prev_n
        last = (cond_video_frames - prev_n) % effective
        num_target_frames = cond_video_frames + (0 if last == 0 else effective - last)
        num_segments = num_target_frames // effective

        # the character image: CLIP context and reference latents
        img = torch.from_numpy(self.video_processor.preprocess(image, height=height, width=width)).to(device)
        if image_embeds is None:
            image_embeds = self.encode_image(image)
        image_embeds = image_embeds.to(device).expand(batch_size, *image_embeds.shape[1:])

        face_size = tr.config.motion_encoder_size
        pose = self._video(self.pad_video_frames(pose_frames, num_target_frames), height, width, device)
        face = self._video(self.pad_video_frames(face_frames, num_target_frames), face_size, face_size, device)
        background = mask = None
        if mode == "replace":
            background = self._video(self.pad_video_frames(self._frames(background_video), num_target_frames),
                                     height, width, device)
            mask = self._video(self.pad_video_frames(self._frames(mask_video), num_target_frames), height, width,
                               device)
            mask = (mask[:, :1] + 1) / 2  # [-1, 1] -> [0, 1], one channel

        lh, lw = height // self.vae_scale_factor_spatial, width // self.vae_scale_factor_spatial
        num_latent_frames = (segment_frame_length - 1) // rt + 1
        z = self.vae.config.z_dim
        ref_lat = self._encode_video_latents(img[:, :, None])
        ref_lat = ref_lat.repeat_interleave(batch_size // ref_lat.shape[0], dim=0)
        ref_mask = torch.from_numpy(self.get_i2v_mask(batch_size, 1, lh, lw, 1)).to(device)
        reference_image_latents = torch.cat([ref_mask, ref_lat], dim=1)

        def to_batch(x):
            return x.repeat_interleave(batch_size // x.shape[0], dim=0) if x.shape[0] < batch_size else x

        outputs, start, end, prev_cond_video = [], 0, segment_frame_length, None
        mean, std = self._latent_stats(device)
        for seg in range(num_segments):
            shape = (batch_size, z, num_latent_frames + 1, lh, lw)
            seg_latents = (latents if seg == 0 and latents is not None
                           else torch_utils.randn_tensor(shape, generator, device)).to(device=device,
                                                                                         dtype=torch.float32)
            pose_latents = to_batch(self._encode_video_latents(pose[:, :, start:end]))
            face_seg = to_batch(face[:, :, start:end])

            # the previous-segment conditioning video (JAX `:245-273`)
            if mode == "replace":
                bg_seg, mask_seg = to_batch(background[:, :, start:end]), to_batch(mask[:, :, start:end])
                prev = bg_seg[:, :, :prev_n] if prev_cond_video is None else prev_cond_video
                remaining = bg_seg[:, :, prev_n:]
                inv = (1 - mask_seg)[:, :, :, torch.from_numpy(nearest_indices(height, lh)).to(device)]
                inv = inv[..., torch.from_numpy(nearest_indices(width, lw)).to(device)]
                mask_pixel_values = inv.cpu().numpy()
            else:
                zeros = torch.zeros((batch_size, 3, segment_frame_length, height, width), device=device)
                prev = zeros[:, :, :prev_n] if prev_cond_video is None else prev_cond_video
                remaining = zeros[:, :, prev_n:]
                mask_pixel_values = None
            prev_cond_latents = to_batch(self._encode_video_latents(torch.cat([prev, remaining], dim=2)))
            prev_mask = self.get_i2v_mask(batch_size, num_latent_frames, lh, lw, prev_n if start > 0 else 0,
                                          mask_pixel_values)
            prev_cond_latents = torch.cat([torch.from_numpy(prev_mask).to(device), prev_cond_latents], dim=1)
            reference_latents = torch.cat([reference_image_latents, prev_cond_latents], dim=2)

            motion_vec = tr.encode_face_motion(face_seg.to(tr.dtype))
            motion_vec_uncond = tr.encode_face_motion((face_seg * 0 - 1).to(tr.dtype)) if do_cfg else None

            state = self.scheduler.set_timesteps(num_inference_steps)
            ts = state.timesteps.to(device)
            rope = tr.rotary_tables(seg_latents)
            for i, t in enumerate(state.timesteps):
                latent_in = torch.cat([seg_latents, reference_latents], dim=1)
                noise_pred = self._predict(latent_in, ts[i], prompt_embeds, image_embeds, pose_latents, motion_vec,
                                           rope)
                if do_cfg:
                    uncond = self._predict(latent_in, ts[i], negative_embeds, image_embeds, pose_latents,
                                           motion_vec_uncond, rope)
                    noise_pred = uncond + guidance_scale * (noise_pred - uncond)
                seg_latents = self.scheduler.step(state, noise_pred, t, seg_latents).prev_sample

            out_frames = self.vae.decode((seg_latents * std + mean)[:, :, 1:].to(self.vae.dtype)).sample.float()
            if start > 0:
                out_frames = out_frames[:, :, prev_n:]
            outputs.append(out_frames)
            prev_cond_video = out_frames[:, :, -prev_n:]
            start, end = start + effective, end + effective

        if output_type == "latent":
            video = seg_latents
        else:
            video = torch.cat(outputs, dim=2)[:, :, :cond_video_frames]
            video = (video / 2 + 0.5).clamp(0, 1).permute(0, 2, 3, 4, 1).cpu().numpy()
        if not return_dict:
            return (video,)
        return WanPipelineOutput(frames=video)

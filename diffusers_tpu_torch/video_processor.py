"""Video preprocessing.

Port of `diffusers_tpu/video_processor.py` (`VideoProcessor.preprocess_video`
`:28`): the same input layouts, normalised to the channels-first video batch
[B, C, T, H, W] the pipelines take. It runs on the host in numpy, as JAX's
does; torch tensors are accepted too (moved to the host). An array whose
minimum is >= 0 is taken as [0, 1] and mapped to [-1, 1]. PIL frames go
through `VaeImageProcessor.preprocess` (resized to `height` x `width`);
arrays keep their size, as in JAX. `postprocess_video` waits: the Wan
pipelines return their frames themselves.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .image_processor import VaeImageProcessor, _is_pil


class VideoProcessor(VaeImageProcessor):
    def preprocess_video(self, video, height: Optional[int] = None, width: Optional[int] = None) -> np.ndarray:
        """Takes one of: a list of PIL frames (one video); a list of lists of
        PIL frames (a batch); a 4-D array [T, H, W, C] or [T, C, H, W] (one
        video); a list of 4-D arrays (a batch); a 5-D array [B, T, H, W, C],
        [B, T, C, H, W] or [B, C, T, H, W]. Returns float32 [B, C, T, H, W],
        in [-1, 1] when the input was in [0, 1]."""
        if isinstance(video, list) and video and _is_pil(video[0]):
            video = [video]
        if isinstance(video, list) and video and isinstance(video[0], list) and _is_pil(video[0][0]):
            return np.stack([np.stack([self.preprocess(f, height=height, width=width)[0] for f in frames], axis=1)
                             for frames in video], axis=0)

        if isinstance(video, torch.Tensor):
            video = video.detach().cpu().float().numpy()
        if isinstance(video, list):
            video = np.stack([v.detach().cpu().float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                              for v in video], axis=0)
        video = np.asarray(video, dtype=np.float32)
        if video.ndim == 4:  # one video
            video = video[None]
        if video.ndim != 5:
            raise ValueError(f"expected a 4-D or 5-D video, got shape {video.shape}")

        if video.shape[-1] in (1, 3):  # [B, T, H, W, C]
            video = video.transpose(0, 4, 1, 2, 3)
        elif video.shape[2] in (1, 3) and video.shape[1] not in (1, 3):  # [B, T, C, H, W]
            video = video.transpose(0, 2, 1, 3, 4)
        if video.min() >= 0:
            video = self.normalize(video)
        return np.ascontiguousarray(video, dtype=np.float32)

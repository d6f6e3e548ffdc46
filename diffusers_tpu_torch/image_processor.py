"""Image pre- and postprocessing.

Port of `diffusers_tpu/image_processor.py`: `VaeImageProcessor`
(`normalize`, `denormalize`, `get_default_height_width`, `preprocess`,
nearest `resize` of arrays, `binarize`, `postprocess`; `:59-300`) and the
postprocess helpers (`:21-48`). Preprocessing runs on the host in numpy,
with JAX's rules: an array is channels-last when its last axis is 1, 3 or 4
and its second is not, and it is normalized to [-1, 1] only when its minimum
is >= 0. numpy arrays and torch tensors need no PIL; PIL is imported only
when a PIL image is passed (JAX imports it for every input). Postprocessing
(denormalize, NCHW -> NHWC, and for uint8 the quantization) runs on the
device before the one host transfer. PIL's resampling filters, `blur`,
`apply_overlay` and the crop helpers wait.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _is_pil(image) -> bool:
    """Whether `image` is a PIL image, without importing PIL for anything else."""
    return type(image).__module__.startswith("PIL.")


def numpy_to_pil(images: np.ndarray):
    """[B, H, W, C] float array in [0,1] (or uint8) -> list of PIL images."""
    from PIL import Image

    if images.ndim == 3:
        images = images[None, ...]
    if images.dtype != np.uint8:
        images = (images * 255).round().astype("uint8")
    if images.shape[-1] == 1:
        return [Image.fromarray(image.squeeze(), mode="L") for image in images]
    return [Image.fromarray(image) for image in images]


def pil_to_numpy(images) -> np.ndarray:
    """PIL image(s) -> float32 [B, H, W, 3] in [0, 1]."""
    if _is_pil(images):
        images = [images]
    return np.stack([np.array(im.convert("RGB")).astype(np.float32) / 255.0 for im in images], axis=0)


def postprocess_np(image: torch.Tensor) -> np.ndarray:
    """[B, C, H, W] in [-1, 1] -> float32 [B, H, W, C] in [0, 1]."""
    x = (image.float() / 2 + 0.5).clamp(0.0, 1.0)
    return x.permute(0, 2, 3, 1).cpu().numpy()


def postprocess_uint8(image: torch.Tensor) -> np.ndarray:
    """[B, C, H, W] in [-1, 1] -> uint8 [B, H, W, C]; quantized on the device
    so the host transfer is a quarter of the float one."""
    x = (image.float() / 2 + 0.5).clamp(0.0, 1.0)
    return torch.round(x * 255.0).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()


class VaeImageProcessor:
    """JAX's defaults held fixed: PIL input is resized with the Lanczos
    filter (or `resample`: "bicubic" for the x4 upscaler, as JAX's), and any
    input whose minimum is >= 0 is normalized to [-1, 1]."""

    def __init__(self, vae_scale_factor: int = 8, resample: str = "lanczos"):
        self.vae_scale_factor = vae_scale_factor
        self.resample = resample

    @staticmethod
    def normalize(images):
        """[0,1] -> [-1,1]."""
        return 2.0 * images - 1.0

    @staticmethod
    def denormalize(images):
        """[-1,1] -> [0,1]."""
        if isinstance(images, torch.Tensor):
            return (images / 2 + 0.5).clamp(0, 1)
        return np.clip(images / 2 + 0.5, 0, 1)

    def get_default_height_width(self, image, height: Optional[int] = None, width: Optional[int] = None):
        """(height, width) of `image` (PIL, or an array whose last two axes
        are H, W) unless given, rounded down to a multiple of the VAE's
        scale factor."""
        if height is None:
            height = image.height if _is_pil(image) else image.shape[-2]
        if width is None:
            width = image.width if _is_pil(image) else image.shape[-1]
        sf = self.vae_scale_factor
        return height - height % sf, width - width % sf

    def resize(self, image, height: int, width: int):
        """A PIL image with the processor's filter (Lanczos by default), or a
        numpy [B, H, W, C] batch by nearest neighbour (index maps on the
        host, as JAX)."""
        if _is_pil(image):
            from PIL import Image

            return image.resize((width, height), resample=getattr(Image, self.resample.upper()))
        arr = np.asarray(image)
        _, h, w, _ = arr.shape
        yi = (np.arange(height) * (h / height)).astype(np.int64).clip(0, h - 1)
        xi = (np.arange(width) * (w / width)).astype(np.int64).clip(0, w - 1)
        return arr[:, yi][:, :, xi]

    @staticmethod
    def binarize(image):
        """A mask to {0, 1}, 1 where the value is > 0.5: a PIL mask (as
        grayscale / 255, returned as a {0, 255} PIL mask, as JAX; 8-bit grey
        never equals 0.5 there, so this is JAX's `>= 0.5` exactly) or an
        array or tensor in [0, 1] (as JAX's `as_mask_array`). The one
        threshold of the port's masks."""
        if _is_pil(image):
            from PIL import Image

            arr = np.asarray(image.convert("L"), dtype=np.float32) / 255.0
            return Image.fromarray(((arr > 0.5) * 255).astype(np.uint8), mode="L")
        if isinstance(image, torch.Tensor):
            return (image > 0.5).to(image.dtype)
        image = np.asarray(image)
        return (image > 0.5).astype(image.dtype)

    def preprocess(self, image, height: Optional[int] = None, width: Optional[int] = None) -> np.ndarray:
        """PIL image(s), or a numpy array or torch tensor HWC / NHWC / NCHW
        -> normalized NCHW float32 numpy. PIL images are resized to
        (`height`, `width`) (default: their own size rounded down to the
        VAE's scale factor); arrays keep their size, as in JAX."""
        if _is_pil(image) or (isinstance(image, list) and image and _is_pil(image[0])):
            images = [image] if _is_pil(image) else image
            height, width = self.get_default_height_width(images[0], height, width)
            images = [self.resize(im, height, width) for im in images]
            image = pil_to_numpy(images).transpose(0, 3, 1, 2)
        else:
            if isinstance(image, torch.Tensor):
                image = image.detach().cpu().float().numpy()
            image = np.asarray(image, dtype=np.float32)
            if image.ndim == 3:
                image = image[None]
            if image.shape[-1] in (1, 3, 4) and image.shape[1] not in (1, 3, 4):  # channels-last
                image = image.transpose(0, 3, 1, 2)
        if image.min() >= 0:
            image = self.normalize(image)
        return np.ascontiguousarray(image, dtype=np.float32)

    def postprocess(self, image: torch.Tensor, output_type: str = "pil"):
        """NCHW tensor in [-1, 1] -> "np" (float32 NHWC in [0, 1]) or "pil"
        (uint8 quantized on the device, then PIL images)."""
        if output_type == "np":
            return postprocess_np(image)
        if output_type == "pil":
            return numpy_to_pil(postprocess_uint8(image))
        raise ValueError(f"unsupported output_type {output_type!r}; choose 'pil', 'np' or 'latent'")

"""Qwen-Image image-to-image pipeline.

Port of `diffusers_tpu/pipelines/qwenimage/pipeline_qwenimage_img2img.py`:
the input image is encoded by the VAE (one frame through a Wan-family 3-D
VAE, then ``(z - latents_mean) / latents_std``; or a 2-D `AutoencoderKL`'s
sample times its scaling factor), packed 2 x 2, noised by `scale_noise` to
the first timestep `strength` keeps, and the text-to-image loop runs over
the tail of the mu-shifted schedule. Where JAX splits one key three ways,
the port draws the encoder's sample, then the noise, from one
`torch.Generator` through `utils.torch_utils.randn_tensor`.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ...utils import torch_utils
from ..inpaint_utils import check_strength_and_schedule, repeat_to_batch
from .pipeline_qwenimage import QwenImagePipeline


class QwenImageImg2ImgPipeline(QwenImagePipeline):
    def _encode_vae_image(self, image: torch.Tensor, generator=None) -> torch.Tensor:
        """Normalized float32 latents NCHW of a preprocessed NCHW image."""
        if self._is_video_vae():
            latents = self.vae.encode(image[:, :, None]).sample(generator)[:, :, 0].float()
        else:
            latents = self.vae.encode(image).sample(generator).float() * self.vae.config.scaling_factor
        stats = self._latent_stats(latents.device)
        if stats is not None:
            latents = (latents - stats[0]) / stats[1]
        return latents

    def _prepare_image(self, image, height, width, batch_size: int, generator):
        """(packed clean latents, latent height, latent width, pixel height,
        pixel width) of the input image, repeated up to `batch_size`."""
        init = torch.from_numpy(self.image_processor.preprocess(image, height, width)).to(
            device=self.vae.device, dtype=self.vae.dtype)
        image_latents = repeat_to_batch(self._encode_vae_image(init, generator), batch_size, what="image")
        lh, lw = image_latents.shape[2:]
        return (self._pack_latents(image_latents).to(self.transformer.device), lh, lw, height or init.shape[-2],
                width or init.shape[-1])

    def _strength_start(self, packed, num_inference_steps: int, strength: float, generator):
        """(state, kept timesteps, noise, noised latents)."""
        state = self._schedule(packed.shape[1], num_inference_steps)
        init_timestep = min(int(num_inference_steps * strength), num_inference_steps)
        timesteps = state.timesteps[max(num_inference_steps - init_timestep, 0):]
        check_strength_and_schedule(strength, timesteps)
        noise = torch_utils.randn_tensor(packed.shape, generator, packed.device)
        return state, timesteps, noise, self.scheduler.scale_noise(state, packed, timesteps[:1], noise)

    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        image=None,
        strength: float = 0.6,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 50,
        true_cfg_scale: float = 4.0,
        generator: Optional[torch.Generator] = None,
        max_sequence_length: int = 1024,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Image-to-image. `image`: PIL, or an array or tensor (HWC, NHWC or
        NCHW; values in [0, 1] are normalized to [-1, 1])."""
        embeds, mask, batch_size, do_cfg = self._prompt(prompt, negative_prompt, true_cfg_scale,
                                                        max_sequence_length)
        packed, lh, lw, height, width = self._prepare_image(image, height, width, batch_size, generator)
        state, timesteps, _, latents = self._strength_start(packed, num_inference_steps, strength, generator)
        latents = self._loop(latents, embeds, mask, state, timesteps, [(1, lh // 2, lw // 2)], true_cfg_scale,
                             do_cfg)
        return self._decode(latents, height, width, output_type, return_dict)

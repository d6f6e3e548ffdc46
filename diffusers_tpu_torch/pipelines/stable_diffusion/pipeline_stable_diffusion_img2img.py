"""Stable Diffusion (1.x) image-to-image pipeline.

Port of `diffusers_tpu/pipelines/stable_diffusion/pipeline_stable_diffusion_img2img.py`,
on the rules of the port's SDXL img2img: the input image is encoded with the
VAE posterior's sample, the latents are noised to the first timestep that
`strength` keeps (`t_start = n - min(int(n * strength), n)`), and the denoise
loop runs from there. The encoder's sample, then the noise, are drawn from
one `torch.Generator` (JAX splits one key three ways). JAX's loop reads no
cache config; the port accepts none.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ...hooks.generic_cache import denoise_loop
from ...utils import torch_utils
from ..inpaint_utils import repeat_to_batch
from ..stable_diffusion_xl.pipeline_stable_diffusion_xl_img2img import strength_timesteps
from .pipeline_stable_diffusion import StableDiffusionPipeline


class StableDiffusionImg2ImgPipeline(StableDiffusionPipeline):
    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        image=None,
        strength: float = 0.8,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        num_images_per_prompt: int = 1,
        generator: Optional[torch.Generator] = None,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Image-to-image. `image`: PIL, or an array or tensor (HWC, NHWC or
        NCHW; values in [0, 1] are normalized to [-1, 1])."""
        device, dtype = self.unet.device, self.unet.dtype
        do_cfg = guidance_scale > 1.0
        prompt_embeds, batch_size = self._conditioning(prompt, negative_prompt, do_cfg, num_images_per_prompt)
        init_latents = repeat_to_batch(self._encode(self._preprocess(image), generator).float(), batch_size,
                                       what="image")
        state = self.scheduler.set_timesteps(num_inference_steps)
        timesteps = strength_timesteps(self.scheduler, state, num_inference_steps, strength)
        noise = torch_utils.randn_tensor(init_latents.shape, generator, device)
        latents = self.scheduler.add_noise(state, init_latents, noise, timesteps[:1]).to(dtype)
        timesteps_device = timesteps.to(device)

        def forward(latents, i, t):
            return self._noise(state, t, timesteps_device[i], latents, prompt_embeds, guidance_scale)

        latents = denoise_loop(forward, self.scheduler, latents, state, timesteps)
        return self._output(latents, output_type, return_dict)

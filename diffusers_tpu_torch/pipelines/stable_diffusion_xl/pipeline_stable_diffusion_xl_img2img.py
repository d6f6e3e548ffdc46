"""SDXL image-to-image pipeline.

Port of `diffusers_tpu/pipelines/stable_diffusion_xl/pipeline_stable_diffusion_xl_img2img.py`
(`:19-114`): the input image is encoded with the VAE posterior's sample, the
latents are noised to the first timestep the strength keeps (`t_start = n -
min(int(n * strength), n)`), and the eager denoise loop runs from there.
Where JAX splits one key three ways, the port draws the encoder's sample,
then the noise, from one `torch.Generator`, both through
`utils.torch_utils.randn_tensor`. JAX's loop reads no cache config; the port
accepts none (`enable_cache` raises).
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from ...hooks.generic_cache import denoise_loop
from ...utils import torch_utils
from ..inpaint_utils import check_strength_and_schedule, repeat_to_batch
from .pipeline_stable_diffusion_xl import StableDiffusionXLPipeline


def strength_timesteps(scheduler, state, num_inference_steps: int, strength: float) -> torch.Tensor:
    """The tail of the schedule that `strength` keeps (JAX `:89-92`)."""
    init_timestep = min(int(num_inference_steps * strength), num_inference_steps)
    t_start = max(num_inference_steps - init_timestep, 0)
    timesteps = state.timesteps[t_start * scheduler.order:]
    check_strength_and_schedule(strength, timesteps)
    return timesteps


class StableDiffusionXLImg2ImgPipeline(StableDiffusionXLPipeline):
    _supported_cache_configs = ()

    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        prompt_2: Optional[Union[str, List[str]]] = None,
        image=None,
        strength: float = 0.3,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        negative_prompt_2: Optional[Union[str, List[str]]] = None,
        generator: Optional[torch.Generator] = None,
        original_size: Optional[Tuple[int, int]] = None,
        crops_coords_top_left: Tuple[int, int] = (0, 0),
        target_size: Optional[Tuple[int, int]] = None,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Image-to-image. `image`: PIL, or an array or tensor (HWC, NHWC or
        NCHW; values in [0, 1] are normalized to [-1, 1]). `output_type` as
        for text-to-image."""
        device, dtype = self.unet.device, self.unet.dtype
        init = self._preprocess(image)
        height, width = init.shape[-2], init.shape[-1]
        do_cfg = guidance_scale > 1.0
        prompt_embeds, add_text_embeds, add_time_ids, batch_size = self._conditioning(
            prompt, prompt_2, negative_prompt, negative_prompt_2, do_cfg, original_size or (height, width),
            crops_coords_top_left, target_size or (height, width),
        )

        init_latents = repeat_to_batch(self._encode(init, generator).float(), batch_size, what="image")
        state = self.scheduler.set_timesteps(num_inference_steps)
        timesteps = strength_timesteps(self.scheduler, state, num_inference_steps, strength)
        noise = torch_utils.randn_tensor(init_latents.shape, generator, device)
        latents = self.scheduler.add_noise(state, init_latents, noise, timesteps[:1]).to(dtype)

        timesteps_device = timesteps.to(device)

        def forward(latents, i, t):
            return self._noise(state, t, timesteps_device[i], latents, prompt_embeds, add_text_embeds, add_time_ids,
                               guidance_scale, step=(i, len(timesteps)))

        latents = denoise_loop(forward, self.scheduler, latents, state, timesteps)
        return self._output(latents, output_type, return_dict)

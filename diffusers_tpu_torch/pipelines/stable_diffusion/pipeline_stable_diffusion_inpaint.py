"""Stable Diffusion (1.x) inpainting pipeline.

Port of `diffusers_tpu/pipelines/stable_diffusion/pipeline_stable_diffusion_inpaint.py`,
on the rules of the port's SDXL inpaint. The mask (1 where the image is
repainted) is binarized at 0.5 and taken to the latent size by nearest
neighbour. A UNet with `in_channels == 9` (`stable-diffusion-inpainting`)
gets the mask and the masked image's latents (the posterior's mode) as 5
more input channels, tiled for CFG. A 4-channel UNet gets the blend at
upstream diffusers' rule: after step i the known region is the init latents
noised to the *next* timestep, ``timesteps[i + 1]``, and after the last step
the clean init latents. JAX's loop (`:51-55`) noises to the current timestep
instead and leaves sigma(t_last) of noise there (ROADMAP C4). Randomness as
in img2img: the encoder's sample, then the noise, from one `torch.Generator`.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ...utils import torch_utils
from ..inpaint_utils import as_mask_array, check_strength_and_schedule, repeat_to_batch, resize_mask_nearest
from ..stable_diffusion_xl.pipeline_stable_diffusion_xl_img2img import strength_timesteps
from .pipeline_stable_diffusion import StableDiffusionPipeline


class StableDiffusionInpaintPipeline(StableDiffusionPipeline):
    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        image=None,
        mask_image=None,
        strength: float = 1.0,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        generator: Optional[torch.Generator] = None,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Inpainting. `image` as for img2img; `mask_image` (PIL, or an array
        or tensor [H, W], [1, H, W] or [B, 1, H, W] in [0, 1]) is 1 where the
        image is repainted. With `strength` < 1 the loop starts from the
        noised image, as img2img does."""
        device, dtype = self.unet.device, self.unet.dtype
        state = self.scheduler.set_timesteps(num_inference_steps)
        timesteps = state.timesteps
        check_strength_and_schedule(strength, timesteps)
        do_cfg = guidance_scale > 1.0
        prompt_embeds, batch_size = self._conditioning(prompt, negative_prompt, do_cfg)
        init = self._preprocess(image)
        mask = as_mask_array(mask_image)
        init_latents = repeat_to_batch(self._encode(init, generator).float(), batch_size, what="image")
        mask_latent = torch.from_numpy(resize_mask_nearest(mask, *init_latents.shape[2:])).to(device)

        is_inpaint_unet = self.unet.config.in_channels == 9
        noise = torch_utils.randn_tensor(init_latents.shape, generator, device)
        if strength >= 1.0:
            latents = noise * state.init_noise_sigma
        else:
            timesteps = strength_timesteps(self.scheduler, state, num_inference_steps, strength)
            latents = self.scheduler.add_noise(state, init_latents, noise, timesteps[:1])
        latents = latents.to(dtype)

        mask_input = None
        if is_inpaint_unet:
            masked_image = init * (1 - torch.from_numpy(mask).to(device=init.device, dtype=init.dtype))
            masked_latents = self._encode(masked_image, sample=False)
            mask_input = torch.cat([repeat_to_batch(mask_latent, batch_size, what="mask"),
                                    repeat_to_batch(masked_latents.float(), batch_size, what="image")], dim=1)
            mask_input = torch.cat([mask_input] * (2 if do_cfg else 1)).to(dtype)

        timesteps_device = timesteps.to(device)
        n = len(timesteps)
        for i, t in enumerate(timesteps):
            noise_pred = self._noise(state, t, timesteps_device[i], latents, prompt_embeds, guidance_scale,
                                     extra=mask_input, step=(i, n))
            latents = self.scheduler.step(state, noise_pred, t, latents).prev_sample
            if not is_inpaint_unet:  # upstream's blend: the known region at the next timestep's noise level
                known = (init_latents if i == n - 1
                         else self.scheduler.add_noise(state, init_latents, noise, timesteps[i + 1:i + 2]))
                latents = ((1 - mask_latent) * known + mask_latent * latents).to(dtype)
        return self._output(latents, output_type, return_dict)

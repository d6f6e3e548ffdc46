"""What the SD and SDXL ControlNet pipelines share.

The conditioning image's preparation (JAX's `_prep`: preprocess, then back
to [0, 1]), the ControlNet call of one denoise step with its residuals for
the UNet (`ControlNetCall`), the noise prediction of a step
(`controlnet_noise`), the inpaint loop's blend (`blend_loop`), and the
pipelines' shared steps (`ControlNetPipelineMixin`: the control images, the
img2img start, the two loops). A list or tuple of ControlNets passed to a
pipeline becomes one multi model (`as_controlnet`).

Img2img and inpaint take `strength` and the first timestep from the port's
`strength_timesteps`, which also refuses a strength that leaves no step
(JAX's SDXL ControlNet img2img then decodes the noised latents). As in
JAX's ControlNet pipelines, inpaint noises the init latents to that first
timestep at any strength (the port's plain SD / SDXL inpaint starts from
pure noise at strength 1, as their JAX twins do), and runs a 4-channel UNet
only (JAX's loop has no masked-image input; a 9-channel UNet raises).

Guess mode under CFG follows upstream diffusers (``guess_mode and
self.do_classifier_free_guidance``): the ControlNet runs on the conditional
half only (its latents, embeddings and micro-conditioning), its guess-mode
scales act there, and the unconditional half's residuals are zeros. Every
JAX ControlNet pipeline runs it on both halves (ROADMAP C4).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...hooks.generic_cache import denoise_loop
from ...models.controlnets.controlnet_union import ControlNetUnionModel
from ...models.controlnets.multicontrolnet import MultiControlNetModel
from ...models.controlnets.multicontrolnet_union import MultiControlNetUnionModel
from ...utils import torch_utils
from ..inpaint_utils import as_mask_array, repeat_to_batch, resize_mask_nearest
from ..stable_diffusion_xl.pipeline_stable_diffusion_xl_img2img import strength_timesteps


def conditioning_image(image_processor, image) -> torch.Tensor:
    """A conditioning image, NCHW float32 on the CPU in [0, 1]: PIL or an
    array is preprocessed (normalized to [-1, 1]) and mapped back; a tensor
    is taken as it is, mapped to [0, 1] when it holds negative values."""
    if isinstance(image, torch.Tensor):
        cond = image.float()
        return ((cond + 1) / 2).clamp(0, 1) if float(cond.min()) < 0 else cond
    cond = image_processor.preprocess(image)
    return torch.from_numpy(np.clip((cond + 1) / 2, 0, 1) if cond.min() < 0 else cond)


class ControlNetCall:
    """One request's ControlNet: the per-step call and its residuals.

    `cond` is a conditioning image (NCHW tensor) or a list of them, nested
    as the ControlNet takes them (one a net for `MultiControlNetModel`; one
    a task for `ControlNetUnionModel`; a list a net for
    `MultiControlNetUnionModel`). Every tensor of `cond`, and the union's
    `control_type` masks, repeat in place up to `batch_size` and, under CFG,
    twice over (once with guess mode under CFG). `prompt_embeds` and
    `added` (SDXL's micro-conditioning) hold the CFG batch, uncond first."""

    def __init__(self, controlnet, cond, conditioning_scale, guess_mode: bool, do_cfg: bool, batch_size: int,
                 prompt_embeds: torch.Tensor, added: Optional[dict] = None, **union):
        self.controlnet, self.scale, self.guess_mode = controlnet, conditioning_scale, guess_mode
        self.cond_only = guess_mode and do_cfg
        copies = 2 if do_cfg and not self.cond_only else 1

        def batch(x, dtype):
            if isinstance(x, (list, tuple)):
                return [batch(v, dtype) for v in x]
            x = repeat_to_batch(x, batch_size, what="control image")
            return torch.cat([x] * copies).to(device=controlnet.device, dtype=dtype)

        self.cond = batch(cond, controlnet.dtype)
        self.union = dict(union)
        if "control_type" in union:
            self.union["control_type"] = batch(union["control_type"], torch.float32)
        self.embeds, self.added = prompt_embeds, added
        if self.cond_only:
            self.embeds = prompt_embeds[batch_size:]
            self.added = {k: v[batch_size:] for k, v in added.items()} if added is not None else None

    def __call__(self, scheduler, state, t, t_device, latents, latent_input) -> dict:
        """The UNet's residual kwargs for this step; `latent_input` is the
        scaled CFG batch of `latents`."""
        x = scheduler.scale_model_input(state, latents, t) if self.cond_only else latent_input
        down, mid = self.controlnet(x, t_device, self.embeds, self.cond, conditioning_scale=self.scale,
                                    guess_mode=self.guess_mode, added_cond_kwargs=self.added, return_dict=False,
                                    **self.union)
        if self.cond_only:
            down = [torch.cat([torch.zeros_like(d), d]) for d in down]
            mid = torch.cat([torch.zeros_like(mid), mid])
        return {"down_block_additional_residuals": down, "mid_block_additional_residual": mid}


def controlnet_noise(pipe, controlnet_call: ControlNetCall, state, t, t_device, latents, prompt_embeds,
                     guidance_scale: float, added: Optional[dict] = None) -> torch.Tensor:
    """One step's noise prediction: the ControlNet, then the UNet with its
    residuals; with CFG (the embeddings hold twice the latents' batch,
    uncond first) the two halves are combined."""
    cfg = prompt_embeds.shape[0] == 2 * latents.shape[0]
    latent_input = torch.cat([latents, latents], dim=0) if cfg else latents
    latent_input = pipe.scheduler.scale_model_input(state, latent_input, t)
    residuals = controlnet_call(pipe.scheduler, state, t, t_device, latents, latent_input)
    noise_pred = pipe.unet(latent_input, t_device, encoder_hidden_states=prompt_embeds, added_cond_kwargs=added,
                           **residuals).sample
    if cfg:
        uncond, text = noise_pred.chunk(2, dim=0)
        noise_pred = uncond + guidance_scale * (text - uncond)
    return noise_pred


def blend_loop(forward, scheduler, state, timesteps, latents, init_latents, noise, mask, dtype) -> torch.Tensor:
    """The 4-channel inpaint loop (JAX's ControlNet inpaint rule, which is
    upstream's): after step i the known region (mask 0) is the init latents
    noised to the next timestep, ``timesteps[i + 1]``, and after the last
    step the clean init latents. `forward(latents, i, t)` gives the noise
    prediction."""
    n = len(timesteps)
    for i, t in enumerate(timesteps):
        latents = scheduler.step(state, forward(latents, i, t), t, latents).prev_sample
        known = init_latents if i == n - 1 else scheduler.add_noise(state, init_latents, noise, timesteps[i + 1:i + 2])
        latents = ((1 - mask) * known + mask * latents).to(dtype)
    return latents


def as_controlnet(controlnet):
    """A list or tuple of ControlNets becomes one `MultiControlNetModel`
    (a `MultiControlNetUnionModel` when they are Union nets)."""
    if not isinstance(controlnet, (list, tuple)):
        return controlnet
    union = all(isinstance(net, ControlNetUnionModel) for net in controlnet)
    return (MultiControlNetUnionModel if union else MultiControlNetModel)(controlnet)


def latent_mask(mask_image, init_latents: torch.Tensor) -> torch.Tensor:
    """The binarized mask (1 where the image is repainted) at the latents'
    size, by nearest neighbour, on their device."""
    mask = resize_mask_nearest(as_mask_array(mask_image), *init_latents.shape[2:])
    return torch.from_numpy(mask).to(init_latents.device)


class ControlNetPipelineMixin:
    """The steps the SD and SDXL ControlNet pipelines share; `added` is
    SDXL's micro-conditioning (None for SD)."""

    def _control_images(self, image):
        """One conditioning image, or one a net for a `MultiControlNetModel`."""
        if isinstance(self.controlnet, MultiControlNetModel):
            return [conditioning_image(self.image_processor, im) for im in image]
        return conditioning_image(self.image_processor, image)

    def _loop(self, cn, state, timesteps, latents, prompt_embeds, guidance_scale, added=None):
        """The denoise loop over `timesteps` with the ControlNet call `cn`."""
        ts = timesteps.to(latents.device)

        def forward(lat, i, t):
            return controlnet_noise(self, cn, state, t, ts[i], lat, prompt_embeds, guidance_scale, added)

        return denoise_loop(forward, self.scheduler, latents, state, timesteps)

    def _inpaint_loop(self, cn, state, timesteps, latents, init_latents, noise, mask, prompt_embeds, guidance_scale,
                      added=None):
        """The loop with the blend of `blend_loop`."""
        if self.unet.config.in_channels != 4:
            raise ValueError(f"the ControlNet inpaint pipelines blend a 4-channel UNet's latents; this UNet takes "
                             f"{self.unet.config.in_channels} channels")
        ts = timesteps.to(latents.device)

        def forward(lat, i, t):
            return controlnet_noise(self, cn, state, t, ts[i], lat, prompt_embeds, guidance_scale, added)

        return blend_loop(forward, self.scheduler, state, timesteps, latents, init_latents, noise, mask,
                          self.unet.dtype)

    def _image_latents(self, init, strength, num_inference_steps, batch_size, generator):
        """(the init latents of the preprocessed image `init` at `batch_size`
        (float32), the noise, the scheduler state, the kept timesteps, the
        noised latents in the UNet's dtype). The encoder's sample, then the
        noise, come from `generator`."""
        init_latents = repeat_to_batch(self._encode(init, generator).float(), batch_size, what="image")
        state = self.scheduler.set_timesteps(num_inference_steps)
        timesteps = strength_timesteps(self.scheduler, state, num_inference_steps, strength)
        noise = torch_utils.randn_tensor(init_latents.shape, generator, self.unet.device)
        latents = self.scheduler.add_noise(state, init_latents, noise, timesteps[:1]).to(self.unet.dtype)
        return init_latents, noise, state, timesteps, latents

"""SD3 / SD3.5 + ControlNet text-to-image pipeline.

Port of `diffusers_tpu/pipelines/controlnet_sd3/pipeline_stable_diffusion_3_controlnet.py`
(`:25-148`) on the port's SD3 pipeline. The control image is preprocessed
at the output size and VAE-encoded once (the posterior's sample), then
scaled; with the ControlNet's ``force_zeros_for_pooled_projection`` (the
default: InstantX's nets were trained that way) the VAE's shift is not
subtracted and the ControlNet's pooled input is zeros (`:104-121`), else
the shift is subtracted and it gets `controlnet_pooled_projections` or the
prompt's pooled embeddings. The control latents repeat over the CFG batch.
Each step the ControlNet runs on the 4-D latent input before the
transformer, which adds its residuals after each block
(`block_controlnet_hidden_states`). Defaults as JAX's: 28 steps, CFG 7.0,
`max_sequence_length` 256. The encoder's sample, then the latents, are
drawn from one `torch.Generator` (JAX splits one key two ways).

Like JAX, the pipeline gives the ControlNet latents, so it runs the
joint-block kind and a single-block net that has its own `pos_embed`; a net
built with ``use_pos_embed=False`` (SD3.5 Large's layout) needs the
transformer's patch tokens, which JAX's loop never makes (it fails there,
ROADMAP C4), and the port raises `ValueError` for it. An
`SD3MultiControlNetModel` raises `TypeError` (JAX's pipeline reads a config
the multi model lacks). JAX's loop reads no cache config; `enable_cache`
raises `TypeError`.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ...hooks.generic_cache import denoise_loop
from ...models.controlnets.controlnet_sd3 import SD3ControlNetModel
from ...utils import torch_utils
from ..inpaint_utils import repeat_to_batch
from ..stable_diffusion_3.pipeline_stable_diffusion_3 import StableDiffusion3Pipeline


class StableDiffusion3ControlNetPipeline(StableDiffusion3Pipeline):
    _supported_cache_configs = ()

    def __init__(self, transformer, scheduler, vae, text_encoder, tokenizer, text_encoder_2, tokenizer_2,
                 text_encoder_3=None, tokenizer_3=None, controlnet=None, device: Union[str, torch.device] = "cuda"):
        if controlnet is not None and not isinstance(controlnet, SD3ControlNetModel):
            raise TypeError(f"{type(self).__name__}: controlnet must be an SD3ControlNetModel, got "
                            f"{type(controlnet).__name__} (JAX's pipeline cannot run a multi model either)")
        self.register_modules(controlnet=controlnet)  # before the base places the components
        super().__init__(transformer=transformer, scheduler=scheduler, vae=vae, text_encoder=text_encoder,
                         tokenizer=tokenizer, text_encoder_2=text_encoder_2, tokenizer_2=tokenizer_2,
                         text_encoder_3=text_encoder_3, tokenizer_3=tokenizer_3, device=device)

    def _control_latents(self, control_image, height: int, width: int, force_zeros: bool, batch: int,
                         generator) -> torch.Tensor:
        """The control image's VAE latents (the posterior's sample),
        ``(z - shift) * scaling_factor`` with no shift under
        `force_zeros`, repeated to `batch`, float32."""
        image = torch.from_numpy(self.image_processor.preprocess(control_image, height=height, width=width))
        latents = self.vae.encode(image.to(device=self.vae.device, dtype=self.vae.dtype)).sample(generator).float()
        shift = 0.0 if force_zeros else (self.vae.config.get("shift_factor") or 0.0)
        return repeat_to_batch((latents - shift) * self.vae.config.scaling_factor, batch, what="control image")

    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        control_image=None,
        controlnet_conditioning_scale: float = 1.0,
        controlnet_pooled_projections: Optional[torch.Tensor] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 28,
        guidance_scale: float = 7.0,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        max_sequence_length: int = 256,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Text-to-image steered by `control_image` (PIL, array or tensor;
        resized to the output size if PIL). `output_type` as for
        text-to-image."""
        controlnet = self.controlnet
        if not controlnet.config.use_pos_embed:
            raise ValueError(f"{type(self).__name__}: this ControlNet has no pos_embed (use_pos_embed=False) and "
                             "takes the transformer's patch tokens; the pipeline gives it latents, as JAX's does")
        height = height or self.default_sample_size * self.vae_scale_factor
        width = width or self.default_sample_size * self.vae_scale_factor
        device, dtype = self.transformer.device, self.transformer.dtype
        do_cfg = guidance_scale > 1.0
        prompt_embeds, pooled, batch_size = self._conditioning(prompt, negative_prompt, do_cfg, max_sequence_length, 1)
        force_zeros = controlnet.config.get("force_zeros_for_pooled_projection", True)
        control = self._control_latents(control_image, height, width, force_zeros, batch_size, generator)
        control = torch.cat([control] * (2 if do_cfg else 1)).to(device=device, dtype=controlnet.dtype)
        if force_zeros:
            cn_pooled = torch.zeros_like(pooled)
        else:
            cn_pooled = pooled if controlnet_pooled_projections is None else controlnet_pooled_projections.to(device)

        shape = (batch_size, self.transformer.config.in_channels, height // self.vae_scale_factor,
                 width // self.vae_scale_factor)
        if latents is None:
            latents = torch_utils.randn_tensor(shape, generator, device)
        latents = latents.to(device=device, dtype=torch.float32)
        state = self.scheduler.set_timesteps(num_inference_steps)
        ts = state.timesteps.to(device)

        def forward(lat, i, t):
            x = torch.cat([lat, lat], dim=0) if do_cfg else lat
            timestep = ts[i].expand(x.shape[0])
            residuals = controlnet(x.to(controlnet.dtype), control, conditioning_scale=controlnet_conditioning_scale,
                                   encoder_hidden_states=prompt_embeds, pooled_projections=cn_pooled,
                                   timestep=timestep).controlnet_block_samples
            noise_pred = self.transformer(x.to(dtype), prompt_embeds, pooled, timestep,
                                          block_controlnet_hidden_states=[r.to(dtype) for r in residuals]).sample
            noise_pred = noise_pred.to(lat.dtype)
            if do_cfg:
                uncond, text = noise_pred.chunk(2, dim=0)
                noise_pred = uncond + guidance_scale * (text - uncond)
            return noise_pred

        latents = denoise_loop(forward, self.scheduler, latents, state, state.timesteps)
        return self._output(latents, output_type, return_dict)

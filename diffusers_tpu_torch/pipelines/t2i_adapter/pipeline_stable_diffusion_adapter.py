"""Stable Diffusion (1.x) text-to-image with T2I-Adapter control.

Port of `diffusers_tpu/pipelines/t2i_adapter/pipeline_stable_diffusion_adapter.py`:
the adapter runs once a request on the control image (its features do not
depend on the timestep), its features are scaled by
`adapter_conditioning_scale` (a `MultiAdapter` takes a list as its
``adapter_weights``), doubled for CFG, and added inside the UNet's down
blocks at every step through `down_intrablock_additional_residuals`. The
control image is preprocessed as the VAE's input and taken back to [0, 1]
where it came out in [-1, 1], as JAX does.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ...image_processor import VaeImageProcessor
from ...models.adapter import MultiAdapter
from ...utils import torch_utils
from ..pipeline_utils import DiffusionPipeline
from ..stable_diffusion.pipeline_stable_diffusion import StableDiffusionPipeline


class StableDiffusionAdapterPipeline(StableDiffusionPipeline):
    _optional_components = []

    def __init__(self, vae, text_encoder, tokenizer, unet, adapter, scheduler,
                 device: Union[str, torch.device] = "cuda"):
        DiffusionPipeline.__init__(self)
        self.register_modules(vae=vae, text_encoder=text_encoder, tokenizer=tokenizer, unet=unet, adapter=adapter,
                              scheduler=scheduler)
        self.vae_scale_factor = 2 ** (len(self.vae.config.block_out_channels) - 1)
        self.image_processor = VaeImageProcessor(vae_scale_factor=self.vae_scale_factor)
        self._place(device)

    def _control(self, image, height: Optional[int] = None, width: Optional[int] = None) -> torch.Tensor:
        """The control image as NCHW in [0, 1] on the adapter's device."""
        control = torch.from_numpy(self.image_processor.preprocess(image, height=height, width=width))
        if control.min() < 0:
            control = control / 2 + 0.5  # the adapter reads [0, 1]
        return control.to(device=self.adapter.device, dtype=self.adapter.dtype)

    @torch.no_grad()
    def adapter_features(self, control: torch.Tensor,
                         adapter_conditioning_scale: Union[float, List[float]] = 1.0) -> List[torch.Tensor]:
        """The adapter's features of a control image from `_control`, scaled
        (one NCHW map a UNet down block, before the CFG doubling)."""
        if isinstance(self.adapter, MultiAdapter):
            weights = adapter_conditioning_scale if isinstance(adapter_conditioning_scale, list) else None
            return self.adapter(control, adapter_weights=weights)
        return [f * adapter_conditioning_scale for f in self.adapter(control)]

    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        image=None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        adapter_conditioning_scale: Union[float, List[float]] = 1.0,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Text-to-image under the control image `image` (PIL, or an array or
        tensor HWC / NHWC / NCHW), whose size sets the output's."""
        device, dtype = self.unet.device, self.unet.dtype
        do_cfg = guidance_scale > 1.0
        prompt_embeds, batch_size = self._conditioning(prompt, negative_prompt, do_cfg)
        control = self._control(image, height, width)
        features = self.adapter_features(control, adapter_conditioning_scale)
        if do_cfg:
            features = [torch.cat([f, f], dim=0) for f in features]
        shape = (batch_size, self.vae.config.latent_channels, control.shape[-2] // self.vae_scale_factor,
                 control.shape[-1] // self.vae_scale_factor)
        if latents is None:
            latents = torch_utils.randn_tensor(shape, generator, device)
        latents = latents.to(device=device, dtype=dtype)
        latents = self._denoise(prompt_embeds, latents, guidance_scale, num_inference_steps,
                                down_intrablock_additional_residuals=[f.to(dtype) for f in features])
        return self._output(latents, output_type, return_dict)

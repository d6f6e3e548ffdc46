"""Trajectory consistency distillation (TCD) text-to-image.

Port of `diffusers_tpu/pipelines/tcd/pipeline_tcd.py`: the LCM pipeline's
conditioning (no CFG; the guidance scale as the LCM w-embedding through the
UNet's `time_cond_proj_dim`, none for a UNet without it) and the TCD
scheduler's strategic stochastic step with ``eta`` (TCD's gamma: 0 is
deterministic). The image decodes the final latents.

Random draws go through `utils.torch_utils.randn_tensor`, from `generator`:
the initial latents (unless given), then, with ``eta > 0``, one noise tensor
for each step but the last. JAX draws the step noise inside its scheduler
from a key folded with the step index (ROADMAP C3); at ``eta = 0`` the path
draws no noise and is JAX's, given the same latents. JAX's loop reads no
cache config; the port accepts none.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ...utils import torch_utils
from ..latent_consistency_models.pipeline_latent_consistency_text2img import (
    LatentConsistencyModelPipeline,
    guidance_embedding,
)


class TCDPipeline(LatentConsistencyModelPipeline):
    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, List[str]] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 4,
        guidance_scale: float = 0.0,
        eta: float = 0.3,
        num_images_per_prompt: int = 1,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        prompt_embeds: Optional[torch.Tensor] = None,
        output_type: str = "pil",
        return_dict: bool = True,
    ):
        """Text-to-image in a few TCD steps; `eta` is TCD's gamma."""
        prompt_embeds, latents = self._prepare(prompt, prompt_embeds, num_images_per_prompt, height, width,
                                               generator, latents)
        w_embedding = guidance_embedding(self.unet, guidance_scale, latents.shape[0], latents.device)
        state = self.scheduler.set_timesteps(num_inference_steps)
        latents = latents * state.init_noise_sigma
        timesteps_device = state.timesteps.to(latents.device)
        for i, t in enumerate(state.timesteps):
            noise_pred = self.unet(latents, timesteps_device[i], encoder_hidden_states=prompt_embeds,
                                   timestep_cond=w_embedding).sample
            noise = (torch_utils.randn_tensor(latents.shape, generator, latents.device)
                     if self.scheduler.takes_noise(state, t, eta) else None)
            latents = self.scheduler.step(state, noise_pred, t, latents, eta=eta, variance_noise=noise).prev_sample
        return self._output(latents, output_type, return_dict)

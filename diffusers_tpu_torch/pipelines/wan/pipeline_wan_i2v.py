"""Wan image-to-video pipeline (first frame, first and last frame, Wan 2.2's two experts).

Port of `diffusers_tpu/pipelines/wan/pipeline_wan_i2v.py`
(`WanImageToVideoPipeline` `:41`): the image (and `last_image` for
first-last-frame) is put into a zero-padded clip, VAE-encoded chunk by chunk
(`mode()`), normalised with the VAE's `latents_mean` / `latents_std`, and
joined with a mask of the given frames (frame 0 repeated
`vae_scale_factor_temporal` times, folded to that many channels) into the
condition that follows the 16 latent channels into the transformer (36
channels at Wan's widths). The CLIP vision tower's penultimate hidden states
are the image context (`encode_image`, preprocessed on the device by
`clip_image_preprocess` with the `image_processor`'s numbers, or Wan2.1-I2V's
when it is None), unless the caller passes `image_embeds`. With
`boundary_ratio` (Wan 2.2) the first k = #(t >= boundary_ratio x
num_train_timesteps) steps run on `transformer` at `guidance_scale`, the
rest on `transformer_2` at `guidance_scale_2`, with no CLIP context. The
prompt encoding is `WanPipeline`'s; each step is CFG as two batch-1
transformer calls (cond, then uncond), then a UniPC step in float32.

Where the port follows upstream diffusers rather than JAX (ROADMAP C3/C4):
  * first-last-frame CLIP-encodes both images (JAX encodes `image` alone,
    which Wan2.1-FLF2V's 514-token image table cannot take); the image
    context is tiled over the batch, [image, last_image] per prompt;
  * no cache config is accepted (`enable_cache` raises TypeError): JAX
    accepts TaylorSeer and MagCache but its loop never reads them;
  * with an image branch the transformer takes the tokens before the last
    512 as the image's, so any other `max_sequence_length` raises
    ValueError (JAX mis-splits silently).
`expand_timesteps` (Wan 2.2 TI2V) raises NotImplementedError, as in JAX.
Every random draw goes through `utils.torch_utils.randn_tensor`. The
pipeline is built on ``device`` (default ``"cuda"``).
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from ...models.text_encoders.clip import clip_image_preprocess, clip_processor_numbers
from ...models.transformers.transformer_wan import TEXT_CONTEXT_LENGTH
from ...utils import logging, torch_utils
from ..pipeline_utils import DiffusionPipeline
from .pipeline_wan import WanPipeline, WanPipelineOutput

logger = logging.get_logger(__name__)


def _to_pixels(image, height: int, width: int, device) -> torch.Tensor:
    """JAX's rule: an HWC image (PIL, array or tensor) of 0..255 values ->
    [1, 3, H, W] in [-1, 1]; a CHW one is taken as already in [-1, 1]."""
    if type(image).__module__.startswith("PIL."):
        image = np.asarray(image.convert("RGB"))
    x = image.detach() if isinstance(image, torch.Tensor) else torch.from_numpy(np.asarray(image, np.float32))
    x = x.to(device=device, dtype=torch.float32)[None]
    if x.shape[-1] == 3:
        x = x.permute(0, 3, 1, 2) / 127.5 - 1.0
    if tuple(x.shape[1:]) != (3, height, width):
        raise ValueError(f"the image is {tuple(x.shape[1:])}; the request is for (3, {height}, {width})")
    return x


class WanImageToVideoPipeline(DiffusionPipeline):
    _optional_components = ["transformer", "transformer_2", "image_encoder", "image_processor"]
    _supported_cache_configs = ()  # JAX's I2V loop reads no cache config (ROADMAP C4)

    def __init__(self, tokenizer, text_encoder, transformer, vae, scheduler, image_encoder=None, image_processor=None,
                 transformer_2=None, boundary_ratio: Optional[float] = None, expand_timesteps: bool = False,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        if expand_timesteps:
            raise NotImplementedError("expand_timesteps (Wan 2.2 TI2V's per-token timesteps) is not ported (nor in "
                                      "the JAX package)")
        self.register_modules(vae=vae, text_encoder=text_encoder, tokenizer=tokenizer, transformer=transformer,
                              scheduler=scheduler, image_encoder=image_encoder, image_processor=image_processor,
                              transformer_2=transformer_2)
        self.register_to_config(boundary_ratio=boundary_ratio, expand_timesteps=expand_timesteps)
        self.vae_scale_factor_temporal = vae.config.scale_factor_temporal if vae is not None else 4
        self.vae_scale_factor_spatial = vae.config.scale_factor_spatial if vae is not None else 8
        self._place(device)

    _get_t5_prompt_embeds = WanPipeline._get_t5_prompt_embeds
    encode_prompt = WanPipeline.encode_prompt
    decode_latents = WanPipeline.decode_latents

    @torch.no_grad()
    def encode_image(self, image) -> torch.Tensor:
        """The CLIP vision tower's penultimate hidden states [N, tokens, D] of
        `image` (one image or a list), preprocessed on the encoder's device."""
        encoder = self.image_encoder
        pixels = clip_image_preprocess(image, device=encoder.device, **clip_processor_numbers(self.image_processor))
        return encoder(pixels.to(encoder.dtype), output_hidden_states=True).hidden_states[-2]

    @torch.no_grad()
    def prepare_latents(self, image: torch.Tensor, batch_size: int, num_channels_latents: int, height: int,
                        width: int, num_frames: int, generator=None, latents: Optional[torch.Tensor] = None,
                        last_image: Optional[torch.Tensor] = None):
        """(latents [B, C, F', H/8, W/8] float32, the condition [B, s + z, F',
        H/8, W/8]: the mask of the given frames, s = the temporal scale, then
        the normalised latents of the zero-padded clip)."""
        device, vae, s = image.device, self.vae, self.vae_scale_factor_temporal
        frames = (num_frames - 1) // s + 1
        lh, lw = height // self.vae_scale_factor_spatial, width // self.vae_scale_factor_spatial
        if latents is None:
            latents = torch_utils.randn_tensor((batch_size, num_channels_latents, frames, lh, lw), generator, device)
        latents = latents.to(device=device, dtype=torch.float32)

        gap = num_frames - 1 if last_image is None else num_frames - 2
        parts = [image[:, :, None], image.new_zeros(image.shape[0], 3, gap, height, width)]
        if last_image is not None:
            parts.append(last_image[:, :, None])
        condition = vae.encode(torch.cat(parts, dim=2).to(vae.dtype)).mode().float()
        condition = condition.repeat_interleave(batch_size // condition.shape[0], dim=0)
        mean = torch.tensor(vae.config.latents_mean, device=device).reshape(1, -1, 1, 1, 1)
        std = torch.tensor(vae.config.latents_std, device=device).reshape(1, -1, 1, 1, 1)
        condition = (condition - mean) / std

        mask = np.ones((batch_size, 1, num_frames, lh, lw), np.float32)
        mask[:, :, 1:] = 0
        if last_image is not None:
            mask[:, :, -1] = 1
        mask = np.concatenate([np.repeat(mask[:, :, :1], s, axis=2), mask[:, :, 1:]], axis=2)
        mask = mask.reshape(batch_size, -1, s, lh, lw).transpose(0, 2, 1, 3, 4)
        return latents, torch.cat([torch.from_numpy(np.ascontiguousarray(mask)).to(device), condition], dim=1)

    def _predict(self, transformer, latents, t, embeds, image_embeds, rope) -> torch.Tensor:
        kwargs = {} if image_embeds is None else {"encoder_hidden_states_image": image_embeds.to(transformer.dtype)}
        out = transformer(latents.to(transformer.dtype), t.expand(latents.shape[0]), embeds, rotary_emb=rope,
                          **kwargs)
        return out.sample.float()

    @staticmethod
    def _has_image_branch(transformer) -> bool:
        return transformer is not None and transformer.config.get("added_kv_proj_dim") is not None

    @torch.no_grad()
    def __call__(
        self,
        image=None,
        prompt: Union[str, List[str]] = None,
        negative_prompt: Optional[Union[str, List[str]]] = None,
        height: int = 480,
        width: int = 832,
        num_frames: int = 81,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        guidance_scale_2: Optional[float] = None,
        image_embeds: Optional[torch.Tensor] = None,
        last_image=None,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        max_sequence_length: int = 512,
        output_type: str = "np",
        return_dict: bool = True,
    ):
        """Image-to-video. `image` (and `last_image`): a PIL image or an HWC
        array or tensor of 0..255 values at `height` x `width` (or CHW in
        [-1, 1]). `output_type`: "np" (float32 frames [B, F, H, W, C] in [0,
        1]) or "latent"."""
        device = self.transformer.device
        boundary_ratio = self.config.get("boundary_ratio")
        if boundary_ratio is None and guidance_scale_2 is not None:
            raise ValueError("`guidance_scale_2` needs a pipeline `boundary_ratio`")
        guidance_scale_2 = guidance_scale if guidance_scale_2 is None else guidance_scale_2
        experts = [t for t in (self.transformer, self.transformer_2) if t is not None]
        if any(map(self._has_image_branch, experts)) and max_sequence_length != TEXT_CONTEXT_LENGTH:
            raise ValueError(f"with an image branch the transformer takes the tokens before the last "
                             f"{TEXT_CONTEXT_LENGTH} as the image's: max_sequence_length must be "
                             f"{TEXT_CONTEXT_LENGTH}, got {max_sequence_length}")
        if num_frames % self.vae_scale_factor_temporal != 1:
            logger.warning("`num_frames - 1` must be a multiple of the VAE's temporal scale; rounding down.")
            num_frames = num_frames // self.vae_scale_factor_temporal * self.vae_scale_factor_temporal + 1
        num_frames = max(num_frames, 1)

        do_cfg = guidance_scale > 1.0
        prompt_embeds, negative_embeds = self.encode_prompt(prompt, negative_prompt, do_cfg, max_sequence_length)
        batch_size = prompt_embeds.shape[0]

        if boundary_ratio is None and image_embeds is None and self.image_encoder is not None:
            image_embeds = self.encode_image(image if last_image is None else [image, last_image])
        if image_embeds is not None:
            if not self._has_image_branch(self.transformer):
                raise ValueError("image_embeds were given to a transformer with no image branch")
            image_embeds = image_embeds.to(device).repeat(batch_size, 1, 1)  # upstream's tiling over the batch

        last = None if last_image is None else _to_pixels(last_image, height, width, device)
        latents, condition = self.prepare_latents(_to_pixels(image, height, width, device), batch_size,
                                                  self.vae.config.z_dim, height, width, num_frames, generator,
                                                  latents, last)
        rope = self.transformer.rotary_tables(latents)
        state = self.scheduler.set_timesteps(num_inference_steps)
        timesteps = state.timesteps
        ts = timesteps.to(device)
        k = len(timesteps)
        if boundary_ratio is not None and self.transformer_2 is not None:
            boundary = boundary_ratio * self.scheduler.config.get("num_train_timesteps", 1000)
            k = int((timesteps >= boundary).sum())

        for i, t in enumerate(timesteps):
            transformer, scale = (self.transformer, guidance_scale) if i < k else (self.transformer_2,
                                                                                    guidance_scale_2)
            latent_in = torch.cat([latents, condition], dim=1)
            noise_pred = self._predict(transformer, latent_in, ts[i], prompt_embeds, image_embeds, rope)
            if do_cfg:
                uncond = self._predict(transformer, latent_in, ts[i], negative_embeds, image_embeds, rope)
                noise_pred = uncond + scale * (noise_pred - uncond)
            latents = self.scheduler.step(state, noise_pred, t, latents).prev_sample

        video = latents if output_type == "latent" else self.decode_latents(latents)
        if not return_dict:
            return (video,)
        return WanPipelineOutput(frames=video)

"""IP-Adapter loading.

Port of `diffusers_tpu/loaders/ip_adapter.py`. A checkpoint (a safetensors
file in `h94/IP-Adapter`'s layout, read with the port's own reader, or a
``{"image_proj": {...}, "ip_adapter": {...}}`` dict of arrays or tensors)
splits into the projection head, whose variant is told by its keys and
shapes (base, Full, FaceID, Plus; JAX `:77-155`), and the per-layer image
K/V projections ``ip_adapter.{2n+1}.to_{k,v}_ip.weight``. The n-th cross
attention counts down -> up -> mid (JAX `:158-171`): the reference UNet
registers ``up_blocks`` before ``mid_block``, so the checkpoint numbers in
that order, whatever order the port's `named_modules()` walks.

`load_ip_adapter` gives each ``attn2`` ``to_k_ip`` / ``to_v_ip`` (one
bias-free Linear per adapter) and a scale of 1.0 per adapter, and makes the
heads the UNet's ``encoder_hid_proj`` (a `MultiIPAdapterImageProjection`),
all on the UNet's device and in its dtype (or `dtype`). `unload_ip_adapter`
takes every one of them away again, leaving the UNet's modules and state as
they were.

`IPAdapterPipelineMixin.prepare_ip_adapter_image_embeds` encodes the image
prompt with the pipeline's CLIP vision tower on its device:
`clip_image_preprocess` with the numbers of the pipeline's
`feature_extractor` (OpenAI CLIP's at 224 px without one), where JAX runs
transformers' processor on the host (ROADMAP C3). An NCHW array or tensor
with 3 channels is taken as pixel values already, as JAX takes an array.
The base head reads the projected image embedding; the Plus and Full heads
the penultimate hidden states (upstream's rule: JAX gives the Full head the
projected embedding, a width it does not take); a FaceID head takes only
`ip_adapter_image_embeds`. The CFG negative is the zero embedding for the
base head and the encoded zero image for the others (JAX `:280-313`).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

from ..models.ip_adapter import (
    ImageProjection,
    IPAdapterFaceIDImageProjection,
    IPAdapterFullImageProjection,
    IPAdapterPlusImageProjection,
    MultiIPAdapterImageProjection,
)
from ..models.modeling_utils import iter_safetensors
from ..models.text_encoders.clip import clip_image_preprocess, clip_processor_numbers
from ..ops.module import Linear
from ..utils import logging

logger = logging.get_logger(__name__)


def _read_checkpoint(src) -> Dict[str, Dict[str, torch.Tensor]]:
    """-> {"image_proj": {...}, "ip_adapter": {...}} of CPU tensors."""
    if isinstance(src, dict) and "image_proj" in src and "ip_adapter" in src:
        return {group: {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
                        for k, v in src[group].items()} for group in ("image_proj", "ip_adapter")}
    if isinstance(src, (str, os.PathLike)):
        out = {"image_proj": {}, "ip_adapter": {}}
        for key, tensor in iter_safetensors(src):
            group, sub = key.split(".", 1)
            if group not in out:
                raise ValueError(f"unexpected IP-Adapter checkpoint key {key!r}")
            out[group][sub] = tensor.clone()
        return out
    raise ValueError("IP-Adapter source must be a safetensors path or a {'image_proj', 'ip_adapter'} dict")


_PLUS_RENAMES = (  # the published resampler's keys -> the port's (layers.N.0 attention, layers.N.1 feed-forward)
    (r"layers\.(\d+)\.0\.norm1\.", r"layers.\1.ln0."),
    (r"layers\.(\d+)\.0\.norm2\.", r"layers.\1.ln1."),
    (r"layers\.(\d+)\.0\.to_q\.", r"layers.\1.attn.to_q."),
    (r"layers\.(\d+)\.0\.to_out\.", r"layers.\1.attn.to_out.0."),
    (r"layers\.(\d+)\.1\.0\.", r"layers.\1.ff.0."),
    (r"layers\.(\d+)\.1\.1\.", r"layers.\1.ff.1.net.0.proj."),
    (r"layers\.(\d+)\.1\.3\.", r"layers.\1.ff.1.net.2."),
)


def convert_image_proj(state: Dict[str, torch.Tensor]):
    """A checkpoint's ``image_proj`` group -> (head module, its state dict in
    the module's names, image tokens per image)."""
    if "proj.weight" in state:  # base
        num_tokens = 4
        clip_dim = state["proj.weight"].shape[-1]
        cross_dim = state["proj.weight"].shape[0] // num_tokens
        module = ImageProjection(image_embed_dim=clip_dim, cross_attention_dim=cross_dim,
                                 num_image_text_embeds=num_tokens)
        return module, {k.replace("proj", "image_embeds"): v for k, v in state.items()}, num_tokens
    if "proj.3.weight" in state:  # Full
        module = IPAdapterFullImageProjection(image_embed_dim=state["proj.0.weight"].shape[0],
                                              cross_attention_dim=state["proj.3.weight"].shape[0])
        renamed = {k.replace("proj.0", "ff.net.0.proj").replace("proj.2", "ff.net.2").replace("proj.3", "norm"): v
                   for k, v in state.items()}
        return module, renamed, 257
    if "norm.weight" in state and "proj.0.weight" in state:  # FaceID
        id_dim_in, id_dim_out = state["proj.0.weight"].shape[1], state["proj.0.weight"].shape[0]
        cross_dim = state["norm.weight"].shape[0]
        num_tokens = state["proj.2.weight"].shape[0] // cross_dim
        module = IPAdapterFaceIDImageProjection(image_embed_dim=id_dim_in, cross_attention_dim=cross_dim,
                                                mult=id_dim_out // id_dim_in, num_tokens=num_tokens)
        renamed = {k.replace("proj.0", "ff.net.0.proj").replace("proj.2", "ff.net.2"): v for k, v in state.items()}
        return module, renamed, num_tokens
    if "latents" in state:  # Plus
        num_tokens, hidden_dims = state["latents"].shape[1], state["latents"].shape[2]
        depth = 1 + max(int(k.split(".")[1]) for k in state if k.startswith("layers."))
        q_key = "layers.0.0.to_q.weight" if "layers.0.0.to_q.weight" in state else "layers.0.attn.to_q.weight"
        module = IPAdapterPlusImageProjection(
            embed_dims=state["proj_in.weight"].shape[1], output_dims=state["proj_out.weight"].shape[0],
            hidden_dims=hidden_dims, depth=depth, heads=state[q_key].shape[0] // 64, num_queries=num_tokens)
        renamed = {}
        for k, v in state.items():
            kv = re.match(r"layers\.(\d+)\.0\.to_kv\.(.*)", k)
            if kv:  # one fused K/V projection -> to_k, to_v
                half = v.shape[0] // 2
                renamed[f"layers.{kv[1]}.attn.to_k.{kv[2]}"] = v[:half]
                renamed[f"layers.{kv[1]}.attn.to_v.{kv[2]}"] = v[half:]
                continue
            for pattern, repl in _PLUS_RENAMES:
                k = re.sub(pattern, repl, k)
            renamed[k] = v
        return module, renamed, num_tokens
    raise ValueError(f"unrecognized IP-Adapter image_proj format (keys: {sorted(state)[:6]} ...)")


def cross_attentions(unet) -> List[nn.Module]:
    """Every ``attn2`` of the UNet in the checkpoint's order: down blocks,
    then up blocks, then the mid block."""
    blocks = list(unet.down_blocks) + list(unet.up_blocks) + [unet.mid_block]
    return [tb.attn2 for block in blocks if block is not None for t2d in getattr(block, "attentions", ())
            for tb in t2d.transformer_blocks if getattr(tb, "attn2", None) is not None]


def load_ip_adapter(unet, sources: Union[str, dict, List[Union[str, dict]]], dtype: Optional[torch.dtype] = None):
    """Load one IP-Adapter or a list of them into a `UNet2DConditionModel`
    (replacing any loaded before). Returns the UNet."""
    if not isinstance(sources, (list, tuple)):
        sources = [sources]
    checkpoints = [_read_checkpoint(s) for s in sources]
    device = next(unet.parameters()).device
    dtype = dtype or next(unet.parameters()).dtype
    attentions = cross_attentions(unet)
    expected = {f"{2 * n + 1}.{name}.weight" for n in range(len(attentions)) for name in ("to_k_ip", "to_v_ip")}
    for ckpt in checkpoints:
        if set(ckpt["ip_adapter"]) != expected:
            raise ValueError(f"the IP-Adapter checkpoint's ip_adapter keys do not match the UNet's "
                             f"{len(attentions)} cross attentions")
    unload_ip_adapter(unet)

    heads = []
    for ckpt in checkpoints:
        module, state, _ = convert_image_proj(ckpt["image_proj"])
        module.load_state_dict(state, strict=True)
        heads.append(module.to(device=device, dtype=dtype))

    for n, attn in enumerate(attentions):
        key_id = 2 * n + 1
        for name in ("to_k_ip", "to_v_ip"):
            linears = []
            for ckpt in checkpoints:
                weight = ckpt["ip_adapter"][f"{key_id}.{name}.weight"]
                linear = Linear(weight.shape[1], weight.shape[0], use_bias=False).to(device=device, dtype=dtype)
                with torch.no_grad():
                    linear.weight.copy_(weight)
                linears.append(linear)
            delattr(attn, name)  # the plain None slot, so the ModuleList registers as a submodule
            setattr(attn, name, nn.ModuleList(linears))
        attn.ip_adapter_scale = [1.0] * len(checkpoints)
    del unet.encoder_hid_proj
    unet.encoder_hid_proj = MultiIPAdapterImageProjection(heads)
    logger.info(f"Loaded {len(checkpoints)} IP-Adapter(s) into the UNet ({len(attentions)} cross attentions)")
    return unet


def set_ip_adapter_scale(unet, scale: Union[float, List[float]]) -> None:
    """The image attention's weight: one float for every adapter, or one a
    loaded adapter. At 0 an adapter's image attention is skipped."""
    for attn in cross_attentions(unet):
        if attn.ip_adapter_scale is None:
            continue
        attn.ip_adapter_scale = list(scale) if isinstance(scale, (list, tuple)) else [scale] * len(
            attn.ip_adapter_scale)


def unload_ip_adapter(unet) -> None:
    """Take every IP-Adapter module off the UNet."""
    if not isinstance(unet.encoder_hid_proj, MultiIPAdapterImageProjection):
        return
    for attn in cross_attentions(unet):
        for name in ("to_k_ip", "to_v_ip"):
            delattr(attn, name)
            setattr(attn, name, None)
        attn.ip_adapter_scale = None
    del unet.encoder_hid_proj
    unet.encoder_hid_proj = None


def match_batch(image_embeds: Optional[List[torch.Tensor]], batch: int) -> Optional[List[torch.Tensor]]:
    """The image embeds for a UNet call of `batch` rows: as they are, or
    their last (positive) `batch` rows once a callback has dropped CFG."""
    if image_embeds is None:
        return None
    return [e if e.shape[0] == batch else e[-batch:] for e in image_embeds]


class IPAdapterPipelineMixin:
    """The pipeline-level IP-Adapter surface of the SD and SDXL pipelines:
    ``self.unet``, ``self.image_encoder`` (a CLIP vision tower with its
    projection) and ``self.feature_extractor`` (a transformers
    `CLIPImageProcessor`, or None)."""

    def load_ip_adapter(self, source, dtype: Optional[torch.dtype] = None):
        load_ip_adapter(self.unet, source, dtype=dtype)

    def set_ip_adapter_scale(self, scale):
        set_ip_adapter_scale(self.unet, scale)

    def unload_ip_adapter(self):
        unload_ip_adapter(self.unet)

    def _image_embeds(self, ip_adapter_image, ip_adapter_image_embeds, batch_size: int,
                      do_cfg: bool) -> Optional[List[torch.Tensor]]:
        """A request's image embeds: those given, on the UNet's device and in
        its dtype, else those of `ip_adapter_image`, else None."""
        if ip_adapter_image_embeds is not None:
            return [torch.as_tensor(e).to(device=self.unet.device, dtype=self.unet.dtype)
                    for e in ip_adapter_image_embeds]
        if ip_adapter_image is not None:
            return self.prepare_ip_adapter_image_embeds(ip_adapter_image, batch_size, do_cfg)
        return None

    @torch.no_grad()
    def prepare_ip_adapter_image_embeds(self, ip_adapter_image, batch_size: int, do_cfg: bool) -> List[torch.Tensor]:
        """One image (or one per adapter) -> per-adapter embeds [2B | B,
        1, (tokens,) D], the negative first under CFG, in the UNet's dtype."""
        heads = self.unet.encoder_hid_proj
        encoder = getattr(self, "image_encoder", None)
        if encoder is None or not isinstance(heads, MultiIPAdapterImageProjection):
            raise ValueError("load_ip_adapter() first, and register an image_encoder to pass raw images")
        if not isinstance(ip_adapter_image, (list, tuple)):
            ip_adapter_image = [ip_adapter_image]
        if len(ip_adapter_image) != heads.num_ip_adapters:
            raise ValueError(f"{len(ip_adapter_image)} images for {heads.num_ip_adapters} IP-Adapters")
        embeds = []
        for layer, image in zip(heads.image_projection_layers, ip_adapter_image):
            if isinstance(image, (np.ndarray, torch.Tensor)) and image.ndim == 4 and image.shape[1] == 3:
                pixels = torch.as_tensor(image).to(device=encoder.device, dtype=torch.float32)
            else:
                pixels = clip_image_preprocess(image, device=encoder.device,
                                               **clip_processor_numbers(getattr(self, "feature_extractor", None)))
            pixels = pixels.to(encoder.dtype)
            if isinstance(layer, IPAdapterFaceIDImageProjection):
                raise ValueError("an IP-Adapter FaceID head reads an InsightFace id embedding: pass it as "
                                 "ip_adapter_image_embeds")
            if not isinstance(layer, ImageProjection):  # Plus and Full read the per-patch states
                pos = encoder(pixels, output_hidden_states=True).hidden_states[-2]
                neg = encoder(torch.zeros_like(pixels), output_hidden_states=True).hidden_states[-2]
            else:
                pos = encoder(pixels).image_embeds
                neg = torch.zeros_like(pos)
            pos = pos[:1].expand(batch_size, *pos.shape[1:])
            neg = neg[:1].expand(batch_size, *neg.shape[1:])
            e = torch.cat([neg, pos]) if do_cfg else pos
            embeds.append(e[:, None].to(self.unet.dtype))
        return embeds

"""CLIP text and vision encoders.

Port of `diffusers_tpu/models/text_encoders/clip.py`: the text towers
(`CLIPTextModel`, `CLIPTextModelWithProjection`) with the transformers state-dict
names (``text_model.encoder.layers.N.self_attn.q_proj`` ...), causal
attention through the dispatch layer, forced to ``native`` with the causal
keep-mask as JAX does (`:58`), and the SD-family contracts: per-layer
`hidden_states` (SDXL reads the penultimate), `pooler_output` at the EOS
position, `text_embeds` for SDXL's pooled embedding. `from_pretrained` and
`save_pretrained` take transformers' layout (JAX `clip.py:231-283`): a
transformers `config.json` and `model.safetensors` (or shards with
`model.safetensors.index.json`); of a checkpoint's keys only those under
``text_model.`` and ``text_projection`` are read, less the legacy
``position_ids`` buffer.

The vision tower (JAX `:292-457`: `CLIPVisionEmbeddings`,
`CLIPVisionTransformer`, `CLIPVisionModel`, `CLIPVisionModelWithProjection`;
Wan's image encoder, a ViT-H/14) shares the text tower's encoder layers:
a bias-free patch Conv2d, the class embedding and the position table, the
checkpoint's (sic) ``pre_layrnorm``, bidirectional attention on ``native``
as JAX forces it (head dim 80 at ViT-H, 257 tokens), ``post_layernorm`` of
the class token as `pooler_output`, and `image_embeds` through
``visual_projection``. It reads and writes transformers' layout under
``vision_model.`` and ``visual_projection``. `clip_image_preprocess` is
transformers' `CLIPImageProcessor` as a torch function on the pipeline's
device (no PIL, no torchvision): bicubic antialiased resize of the shortest
edge, centre crop, rescale and normalise, with the processor's numbers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...configuration_utils import ConfigMixin, register_to_config
from ...ops.attention import dispatch_attention_fn
from ...ops.module import Conv2d, Embedding, LayerNorm, Linear, get_activation
from ...utils import BaseOutput
from ..modeling_utils import ModelMixin


@dataclass
class CLIPTextModelOutput(BaseOutput):
    last_hidden_state: torch.Tensor
    pooler_output: Optional[torch.Tensor] = None
    hidden_states: Optional[Tuple[torch.Tensor, ...]] = None
    text_embeds: Optional[torch.Tensor] = None


class CLIPAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.q_proj = Linear(embed_dim, embed_dim)
        self.k_proj = Linear(embed_dim, embed_dim)
        self.v_proj = Linear(embed_dim, embed_dim)
        self.out_proj = Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor, causal_mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, s, _ = x.shape
        q = self.q_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        v = self.v_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        out = dispatch_attention_fn(q, k, v, attn_mask=causal_mask, backend="native")
        return self.out_proj(out.reshape(b, s, self.embed_dim))


class CLIPMLP(nn.Module):
    def __init__(self, embed_dim: int, intermediate_size: int, hidden_act: str):
        super().__init__()
        self.fc1 = Linear(embed_dim, intermediate_size)
        self.fc2 = Linear(intermediate_size, embed_dim)
        self.act = get_activation(hidden_act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, intermediate_size: int, hidden_act: str, eps: float):
        super().__init__()
        self.self_attn = CLIPAttention(embed_dim, num_heads)
        self.layer_norm1 = LayerNorm(embed_dim, eps=eps)
        self.mlp = CLIPMLP(embed_dim, intermediate_size, hidden_act)
        self.layer_norm2 = LayerNorm(embed_dim, eps=eps)

    def forward(self, x: torch.Tensor, causal_mask: Optional[torch.Tensor]) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int, max_position_embeddings: int):
        super().__init__()
        self.token_embedding = Embedding(vocab_size, embed_dim)
        self.position_embedding = Embedding(max_position_embeddings, embed_dim)

    def forward(self, input_ids: torch.Tensor, position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1], device=input_ids.device)[None, :]
        return self.token_embedding(input_ids) + self.position_embedding(position_ids)


class _CLIPEncoder(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        self.layers = nn.ModuleList(
            [
                CLIPEncoderLayer(
                    config["hidden_size"],
                    config["num_attention_heads"],
                    config["intermediate_size"],
                    config.get("hidden_act", "quick_gelu"),
                    config.get("layer_norm_eps", 1e-5),
                )
                for _ in range(config["num_hidden_layers"])
            ]
        )


class CLIPTextTransformer(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        self.cfg = config
        embed_dim = config["hidden_size"]
        self.embeddings = CLIPTextEmbeddings(config["vocab_size"], embed_dim, config["max_position_embeddings"])
        self.encoder = _CLIPEncoder(config)
        self.final_layer_norm = LayerNorm(embed_dim, eps=config.get("layer_norm_eps", 1e-5))

    def forward(self, input_ids, position_ids=None, output_hidden_states=False):
        hidden = self.embeddings(input_ids, position_ids)
        s = input_ids.shape[-1]
        causal = torch.ones((s, s), dtype=torch.bool, device=input_ids.device).tril()[None, None]  # [1,1,S,S]

        all_hidden = [hidden] if output_hidden_states else None
        for layer in self.encoder.layers:
            hidden = layer(hidden, causal)
            if output_hidden_states:
                all_hidden.append(hidden)

        last_hidden = self.final_layer_norm(hidden)

        eos_token_id = self.cfg.get("eos_token_id", 2)
        if eos_token_id == 2:
            # canonical CLIP: eos has the highest token id (transformers behavior)
            eos_positions = input_ids.argmax(dim=-1)
        else:
            eos_positions = (input_ids == eos_token_id).int().argmax(dim=-1)
        pooled = last_hidden[torch.arange(last_hidden.shape[0], device=last_hidden.device), eos_positions]
        return last_hidden, pooled, tuple(all_hidden) if output_hidden_states else None


class CLIPTextModel(ModelMixin, ConfigMixin):
    """Matches the transformers.CLIPTextModel checkpoint layout."""

    has_projection = False
    _weights_name = "model.safetensors"
    _weights_index_name = "model.safetensors.index.json"
    _default_max_shard_size = "5GB"
    _keep_key_prefixes = ("text_model.", "text_projection")
    _drop_key_suffixes = ("position_ids",)

    @register_to_config
    def __init__(
        self,
        vocab_size: int = 49408,
        hidden_size: int = 512,
        intermediate_size: int = 2048,
        num_hidden_layers: int = 12,
        num_attention_heads: int = 8,
        max_position_embeddings: int = 77,
        hidden_act: str = "quick_gelu",
        layer_norm_eps: float = 1e-5,
        projection_dim: int = 512,
        eos_token_id: int = 2,
        bos_token_id: int = 49406,
        **kwargs,
    ):
        super().__init__()
        cfg = dict(
            vocab_size=vocab_size,
            hidden_size=hidden_size,
            intermediate_size=intermediate_size,
            num_hidden_layers=num_hidden_layers,
            num_attention_heads=num_attention_heads,
            max_position_embeddings=max_position_embeddings,
            hidden_act=hidden_act,
            layer_norm_eps=layer_norm_eps,
            eos_token_id=eos_token_id,
        )
        self.text_model = CLIPTextTransformer(cfg)
        if self.has_projection:
            self.text_projection = Linear(hidden_size, projection_dim, use_bias=False)

    def forward(
        self,
        input_ids: torch.Tensor,
        position_ids: Optional[torch.Tensor] = None,
        output_hidden_states: bool = False,
    ) -> CLIPTextModelOutput:
        last_hidden, pooled, all_hidden = self.text_model(input_ids, position_ids, output_hidden_states)
        text_embeds = self.text_projection(pooled) if self.has_projection else None
        return CLIPTextModelOutput(
            last_hidden_state=last_hidden,
            pooler_output=pooled,
            hidden_states=all_hidden,
            text_embeds=text_embeds,
        )


class CLIPTextModelWithProjection(CLIPTextModel):
    has_projection = True


# ---------------------------------------------------------------------------
# the vision tower
# ---------------------------------------------------------------------------

# OpenAI CLIP's normalisation, the numbers of Wan2.1-I2V-14B-480P's image_processor (224 px)
OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass
class CLIPVisionModelOutput(BaseOutput):
    last_hidden_state: torch.Tensor
    pooler_output: Optional[torch.Tensor] = None
    hidden_states: Optional[Tuple[torch.Tensor, ...]] = None
    image_embeds: Optional[torch.Tensor] = None


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, embed_dim: int, image_size: int, patch_size: int, num_channels: int = 3):
        super().__init__()
        self.embed_dim = embed_dim
        self.class_embedding = nn.Parameter(torch.randn(embed_dim) * embed_dim**-0.5)
        self.patch_embedding = Conv2d(num_channels, embed_dim, kernel_size=patch_size, stride=patch_size,
                                      use_bias=False)
        self.position_embedding = Embedding((image_size // patch_size) ** 2 + 1, embed_dim)

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.class_embedding.normal_().mul_(self.embed_dim**-0.5)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values [B, C, H, W] -> [B, 1 + patches, D]: the class token, then
        the patches in row-major order, each plus its position."""
        patches = self.patch_embedding(pixel_values.to(self.patch_embedding.weight.dtype))
        patches = patches.flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(patches.dtype).expand(patches.shape[0], 1, -1)
        embeds = torch.cat([cls, patches], dim=1)
        return embeds + self.position_embedding.weight[:embeds.shape[1]].to(embeds.dtype)


class CLIPVisionTransformer(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        embed_dim, eps = config["hidden_size"], config.get("layer_norm_eps", 1e-5)
        self.embeddings = CLIPVisionEmbeddings(embed_dim, config["image_size"], config["patch_size"],
                                               config.get("num_channels", 3))
        self.pre_layrnorm = LayerNorm(embed_dim, eps=eps)  # (sic): the transformers checkpoint key
        self.encoder = _CLIPEncoder(config)
        self.post_layernorm = LayerNorm(embed_dim, eps=eps)

    def forward(self, pixel_values, output_hidden_states=False):
        hidden = self.pre_layrnorm(self.embeddings(pixel_values))
        all_hidden = [hidden] if output_hidden_states else None
        for layer in self.encoder.layers:
            hidden = layer(hidden, None)
            if output_hidden_states:
                all_hidden.append(hidden)
        pooled = self.post_layernorm(hidden[:, 0])
        return hidden, pooled, tuple(all_hidden) if output_hidden_states else None


class CLIPVisionModel(ModelMixin, ConfigMixin):
    """Matches the transformers.CLIPVisionModel(WithProjection) checkpoint layout."""

    has_projection = False
    _weights_name = "model.safetensors"
    _weights_index_name = "model.safetensors.index.json"
    _default_max_shard_size = "5GB"
    _keep_key_prefixes = ("vision_model.", "visual_projection")
    _drop_key_suffixes = ("position_ids",)

    @register_to_config
    def __init__(
        self,
        hidden_size: int = 1024,
        intermediate_size: int = 4096,
        num_hidden_layers: int = 24,
        num_attention_heads: int = 16,
        image_size: int = 224,
        patch_size: int = 14,
        num_channels: int = 3,
        hidden_act: str = "quick_gelu",
        layer_norm_eps: float = 1e-5,
        projection_dim: int = 768,
        **kwargs,
    ):
        super().__init__()
        cfg = dict(hidden_size=hidden_size, intermediate_size=intermediate_size, num_hidden_layers=num_hidden_layers,
                   num_attention_heads=num_attention_heads, image_size=image_size, patch_size=patch_size,
                   num_channels=num_channels, hidden_act=hidden_act, layer_norm_eps=layer_norm_eps)
        self.vision_model = CLIPVisionTransformer(cfg)
        if self.has_projection:
            self.visual_projection = Linear(hidden_size, projection_dim, use_bias=False)

    def forward(self, pixel_values: torch.Tensor, output_hidden_states: bool = False) -> CLIPVisionModelOutput:
        last_hidden, pooled, all_hidden = self.vision_model(pixel_values, output_hidden_states)
        return CLIPVisionModelOutput(
            last_hidden_state=last_hidden,
            pooler_output=pooled,
            hidden_states=all_hidden,
            image_embeds=self.visual_projection(pooled) if self.has_projection else None,
        )


class CLIPVisionModelWithProjection(CLIPVisionModel):
    has_projection = True


def _pil_bicubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """PIL's 8-bit bicubic resampling (a = -0.5, support widened by the
    downscale factor) as a [out_size, in_size] matrix of its fixed-point
    coefficients: PIL's `precompute_coeffs`, each row normalised, then scaled
    by 2^22 and rounded half away from zero (`normalize_coeffs_8bpc`)."""

    def bicubic(x):
        x, a = np.abs(x), -0.5
        return np.where(x < 1, ((a + 2) * x - (a + 3)) * x * x + 1,
                        np.where(x < 2, (((x - 5) * x + 8) * x - 4) * a, 0.0))

    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    weights = np.zeros((out_size, in_size))
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo, hi = max(int(center - support + 0.5), 0), min(int(center + support + 0.5), in_size)
        k = bicubic((np.arange(lo, hi) - center + 0.5) / filterscale)
        k = k / k.sum() if k.sum() != 0 else k
        weights[i, lo:hi] = np.trunc(k * (1 << 22) + np.where(k < 0, -0.5, 0.5))
    return weights


def _pil_resize(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """PIL's `Image.resize((width, height), BICUBIC)` of 8-bit values x [B, C,
    H, W]: the horizontal pass, rounded and clipped to 0..255, then the
    vertical one, in float64 (every fixed-point sum is an integer below
    2^53, so exact)."""
    out = x.double()
    for axis, size in ((3, width), (2, height)):
        if out.shape[axis] != size:
            w = torch.from_numpy(_pil_bicubic_weights(out.shape[axis], size)).to(out.device)
            out = torch.movedim(torch.movedim(out, axis, -1) @ w.T, -1, axis)
            out = torch.floor((out + (1 << 21)) / (1 << 22)).clamp(0, 255)
    return out.float()


def clip_image_preprocess(images, device=None, size: int = 224, crop_size: Tuple[int, int] = (224, 224),
                          image_mean: Sequence[float] = OPENAI_CLIP_MEAN, image_std: Sequence[float] = OPENAI_CLIP_STD,
                          rescale_factor: float = 1 / 255) -> torch.Tensor:
    """transformers' `CLIPImageProcessor` (resize, centre crop, rescale,
    normalise) in torch on `device`: images (a PIL image, an HWC array or
    tensor of 0..255 values, or a list of them) -> float32 pixel values [B,
    3, crop_h, crop_w]. The shortest edge goes to `size` and the other to
    int(size x long / short), with PIL's 8-bit bicubic filter
    (`_pil_resize`); the crop is centred, rounding its offsets down."""
    if not isinstance(images, (list, tuple)):
        images = [images]
    batch = []
    for image in images:
        if type(image).__module__.startswith("PIL."):
            image = np.asarray(image.convert("RGB"))
        x = image if isinstance(image, torch.Tensor) else torch.from_numpy(np.asarray(image))
        if x.ndim != 3 or x.shape[-1] != 3:
            raise ValueError(f"clip_image_preprocess takes HWC RGB images, got shape {tuple(x.shape)}")
        x = x.to(device=device, dtype=torch.float64).round().permute(2, 0, 1)[None]
        h, w = x.shape[-2:]
        short, long = min(h, w), max(h, w)
        new_long = int(size * long / short)
        new_h, new_w = (size, new_long) if h <= w else (new_long, size)
        x = _pil_resize(x, new_h, new_w)
        ch, cw = crop_size
        top, left = (new_h - ch) // 2, (new_w - cw) // 2
        batch.append(x[:, :, top:top + ch, left:left + cw])
    x = torch.cat(batch) * rescale_factor
    mean = torch.tensor(image_mean, dtype=torch.float32, device=x.device).reshape(1, -1, 1, 1)
    std = torch.tensor(image_std, dtype=torch.float32, device=x.device).reshape(1, -1, 1, 1)
    return (x - mean) / std


def clip_processor_numbers(processor) -> dict:
    """`clip_image_preprocess`'s keyword arguments from a transformers
    `CLIPImageProcessor` (a dict or an object with attributes), or
    Wan2.1-I2V-14B-480P's (OpenAI CLIP's at 224 px) when it is None."""
    if processor is None:
        return dict(size=224, crop_size=(224, 224), image_mean=OPENAI_CLIP_MEAN, image_std=OPENAI_CLIP_STD,
                    rescale_factor=1 / 255)

    def get(obj, key):
        return obj[key] if isinstance(obj, dict) else getattr(obj, key)

    off = [flag for flag in ("do_resize", "do_center_crop", "do_rescale", "do_normalize")
           if not getattr(processor, flag, True)]
    if off or int(getattr(processor, "resample", 3)) != 3:
        raise NotImplementedError(f"{type(processor).__name__}: only the bicubic resize, centre crop, rescale and "
                                  f"normalisation of CLIP's processor are ported (off: {off}, resample "
                                  f"{getattr(processor, 'resample', None)})")
    crop = processor.crop_size
    return dict(size=int(get(processor.size, "shortest_edge")),
                crop_size=(int(get(crop, "height")), int(get(crop, "width"))),
                image_mean=tuple(processor.image_mean), image_std=tuple(processor.image_std),
                rescale_factor=float(processor.rescale_factor))

"""Single-file checkpoints: the LDM layout of SD 1.x / 2.x / SDXL and the
original layouts of the Flux, SD3, Wan and LTX-Video transformers.

Port of `diffusers_tpu/loaders/single_file.py`. The converters are plain
functions on a flat ``{key: array}`` dict (numpy arrays or torch tensors)
that give the diffusers keys of the port's models, key for key and bit for
bit JAX's (`tests/test_torch_single_file.py`). The LDM UNet map is one
function, `ldm_unet_module_path`, which kohya's SGM-layout LoRA keys
(`loaders.lora`) go through too. The transformer loaders infer the config
from the keys as JAX's do and return a port model on `device` (JAX returns
a ``(model, params)`` pair): the model is built on the meta device and each
tensor is placed on `device`, cast to `dtype` when one is given, before the
next is read. `load_single_file_checkpoint` reads safetensors only (a
pickle raises), through the port's reader: each tensor is a view of a
memory map of the file, so the host holds no second copy.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Union

import torch

from ..utils import logging
from .lora import _cat, _split

logger = logging.get_logger(__name__)


def _shave(d: Dict, prefix: str) -> Dict:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def _swap_scale_shift(w):
    shift, scale = _split(w, 2)
    return _cat([scale, shift])


# ---------------------------------------------------------------------------
# the LDM UNet
# ---------------------------------------------------------------------------

_LDM_UNET_STATIC = {
    "time_embed.0.weight": "time_embedding.linear_1.weight",
    "time_embed.0.bias": "time_embedding.linear_1.bias",
    "time_embed.2.weight": "time_embedding.linear_2.weight",
    "time_embed.2.bias": "time_embedding.linear_2.bias",
    "input_blocks.0.0.weight": "conv_in.weight",
    "input_blocks.0.0.bias": "conv_in.bias",
    "out.0.weight": "conv_norm_out.weight",
    "out.0.bias": "conv_norm_out.bias",
    "out.2.weight": "conv_out.weight",
    "out.2.bias": "conv_out.bias",
    "label_emb.0.0.weight": "add_embedding.linear_1.weight",
    "label_emb.0.0.bias": "add_embedding.linear_1.bias",
    "label_emb.0.2.weight": "add_embedding.linear_2.weight",
    "label_emb.0.2.bias": "add_embedding.linear_2.bias",
}
_LDM_RESNET = {
    "in_layers.0": "norm1", "in_layers.2": "conv1", "emb_layers.1": "time_emb_proj",
    "out_layers.0": "norm2", "out_layers.3": "conv2", "skip_connection": "conv_shortcut",
}


def ldm_unet_module_path(ldm: str, layers_per_block: int, is_attention: bool = False,
                         is_sampler: bool = False) -> Optional[str]:
    """The diffusers UNet module of an LDM block position (``input_blocks.i.j``,
    ``middle_block.j``, ``output_blocks.i.j``): a resnet, an attention (with
    `is_attention`) or a down- / upsampler (with `is_sampler`); None where
    the position holds none of them. Down block b's layer l sits at
    ``input_blocks.{1 + b (L + 1) + l}`` and its downsampler at l = L; up
    block b's layer l at ``output_blocks.{b (L + 1) + l}``, its attention at
    ``.1`` and its upsampler after it."""
    parts = ldm.split(".")
    per = layers_per_block + 1
    if parts[0] == "middle_block":
        return {0: "mid_block.resnets.0", 1: "mid_block.attentions.0", 2: "mid_block.resnets.1"}.get(int(parts[1]))
    i, j = int(parts[1]), int(parts[2])
    if parts[0] == "input_blocks":
        if i == 0:
            return None
        block, layer = divmod(i - 1, per)
        if layer < layers_per_block:
            return {0: f"down_blocks.{block}.resnets.{layer}", 1: f"down_blocks.{block}.attentions.{layer}"}.get(j)
        return f"down_blocks.{block}.downsamplers.0" if j == 0 and is_sampler else None
    if parts[0] == "output_blocks":
        block, layer = divmod(i, per)
        if j == 0:
            return f"up_blocks.{block}.resnets.{layer}"
        if j == 1 and is_attention:
            return f"up_blocks.{block}.attentions.{layer}"
        return f"up_blocks.{block}.upsamplers.0" if is_sampler and j in (1, 2) else None
    return None


def convert_ldm_unet_state_dict(sd: Dict, config: dict) -> Dict:
    """LDM UNet keys (``model.diffusion_model.*``) -> the diffusers
    `UNet2DConditionModel` keys of `config` (its ``layers_per_block`` and
    ``block_out_channels``); JAX `:32-120`."""
    unet = _shave(sd, "model.diffusion_model.")
    out: Dict = {}
    for old, new in _LDM_UNET_STATIC.items():
        if old in unet:
            out[new] = unet.pop(old)
    lpb = config.get("layers_per_block", 2)
    n_blocks = len(config["block_out_channels"])
    per = lpb + 1

    def convert_resnet(src: str, dst: str):
        for o, n in _LDM_RESNET.items():
            for suffix in ("weight", "bias"):
                k = f"{src}.{o}.{suffix}"
                if k in unet:
                    out[f"{dst}.{n}.{suffix}"] = unet.pop(k)

    def convert_attention(src: str, dst: str):
        for k in list(unet.keys()):
            if k.startswith(src + "."):
                out[dst + k[len(src):]] = unet.pop(k)

    def convert_sampler(src: str, dst: str):
        for suffix in ("weight", "bias"):
            k = f"{src}.{suffix}"
            if k in unet:
                out[f"{dst}.conv.{suffix}"] = unet.pop(k)

    for i in range(1, n_blocks * per + 1):
        if (i - 1) % per < lpb:
            convert_resnet(f"input_blocks.{i}.0", ldm_unet_module_path(f"input_blocks.{i}.0", lpb))
            convert_attention(f"input_blocks.{i}.1",
                              ldm_unet_module_path(f"input_blocks.{i}.1", lpb, is_attention=True))
        else:
            convert_sampler(f"input_blocks.{i}.0.op", ldm_unet_module_path(f"input_blocks.{i}.0", lpb, is_sampler=True))

    convert_resnet("middle_block.0", ldm_unet_module_path("middle_block.0", lpb))
    convert_attention("middle_block.1", ldm_unet_module_path("middle_block.1", lpb))
    convert_resnet("middle_block.2", ldm_unet_module_path("middle_block.2", lpb))

    for i in range(n_blocks * per):
        convert_resnet(f"output_blocks.{i}.0", ldm_unet_module_path(f"output_blocks.{i}.0", lpb))
        attn = f"output_blocks.{i}.1"
        has_attn = any(k.startswith((attn + ".transformer_blocks", attn + ".norm", attn + ".proj_in")) for k in unet)
        if has_attn:
            convert_attention(attn, ldm_unet_module_path(attn, lpb, is_attention=True))
        j = 2 if has_attn else 1
        convert_sampler(f"output_blocks.{i}.{j}.conv", ldm_unet_module_path(f"output_blocks.{i}.{j}", lpb,
                                                                            is_sampler=True))

    leftover = [k for k in unet if not k.startswith("label_emb")]
    if leftover:
        logger.warning(f"{len(leftover)} unconverted unet keys, e.g. {leftover[:5]}")
    return out


# ---------------------------------------------------------------------------
# the LDM VAE and CLIP
# ---------------------------------------------------------------------------

_LDM_VAE_STATIC = [
    ("encoder.conv_in", "encoder.conv_in"),
    ("encoder.norm_out", "encoder.conv_norm_out"),
    ("encoder.conv_out", "encoder.conv_out"),
    ("decoder.conv_in", "decoder.conv_in"),
    ("decoder.norm_out", "decoder.conv_norm_out"),
    ("decoder.conv_out", "decoder.conv_out"),
    ("quant_conv", "quant_conv"),
    ("post_quant_conv", "post_quant_conv"),
]


def convert_ldm_vae_state_dict(sd: Dict) -> Dict:
    """LDM VAE keys (``first_stage_model.*``, or unprefixed) -> diffusers
    `AutoencoderKL` keys; the mid block's 1x1 attention convolutions become
    Linears; the decoder's up blocks are reversed (JAX `:123-199`)."""
    vae = _shave(sd, "first_stage_model.")
    if not vae:
        vae = dict(sd)
    out: Dict = {}
    for old, new in _LDM_VAE_STATIC:
        for suffix in ("weight", "bias"):
            k = f"{old}.{suffix}"
            if k in vae:
                out[f"{new}.{suffix}"] = vae.pop(k)

    def convert_vae_resnet(src, dst):
        pairs = {"norm1": "norm1", "conv1": "conv1", "norm2": "norm2", "conv2": "conv2",
                 "nin_shortcut": "conv_shortcut"}
        for o, n in pairs.items():
            for suffix in ("weight", "bias"):
                k = f"{src}.{o}.{suffix}"
                if k in vae:
                    out[f"{dst}.{n}.{suffix}"] = vae.pop(k)

    def convert_vae_attn(src, dst):
        pairs = {"norm": "group_norm", "q": "to_q", "k": "to_k", "v": "to_v", "proj_out": "to_out.0"}
        for o, n in pairs.items():
            for suffix in ("weight", "bias"):
                k = f"{src}.{o}.{suffix}"
                if k in vae:
                    w = vae.pop(k)
                    if n in ("to_q", "to_k", "to_v", "to_out.0") and w.ndim == 4:
                        w = w[:, :, 0, 0]  # 1x1 conv -> linear
                    out[f"{dst}.{n}.{suffix}"] = w

    i = 0
    while any(k.startswith(f"encoder.down.{i}.") for k in vae):
        j = 0
        while any(k.startswith(f"encoder.down.{i}.block.{j}.") for k in vae):
            convert_vae_resnet(f"encoder.down.{i}.block.{j}", f"encoder.down_blocks.{i}.resnets.{j}")
            j += 1
        for suffix in ("weight", "bias"):
            k = f"encoder.down.{i}.downsample.conv.{suffix}"
            if k in vae:
                out[f"encoder.down_blocks.{i}.downsamplers.0.conv.{suffix}"] = vae.pop(k)
        i += 1
    n_up = 0
    while any(k.startswith(f"decoder.up.{n_up}.") for k in vae):
        n_up += 1
    for i in range(n_up):
        dst_i = n_up - 1 - i
        j = 0
        while any(k.startswith(f"decoder.up.{i}.block.{j}.") for k in vae):
            convert_vae_resnet(f"decoder.up.{i}.block.{j}", f"decoder.up_blocks.{dst_i}.resnets.{j}")
            j += 1
        for suffix in ("weight", "bias"):
            k = f"decoder.up.{i}.upsample.conv.{suffix}"
            if k in vae:
                out[f"decoder.up_blocks.{dst_i}.upsamplers.0.conv.{suffix}"] = vae.pop(k)
    for who in ("encoder", "decoder"):
        convert_vae_resnet(f"{who}.mid.block_1", f"{who}.mid_block.resnets.0")
        convert_vae_resnet(f"{who}.mid.block_2", f"{who}.mid_block.resnets.1")
        convert_vae_attn(f"{who}.mid.attn_1", f"{who}.mid_block.attentions.0")

    leftover = list(vae.keys())
    if leftover:
        logger.warning(f"{len(leftover)} unconverted vae keys, e.g. {leftover[:5]}")
    return out


def convert_ldm_clip_state_dict(sd: Dict) -> Dict:
    """``cond_stage_model.transformer.*`` (SD 1.x) or
    ``conditioner.embedders.0.transformer.*`` (SDXL's CLIP-L) -> the
    transformers `CLIPTextModel` keys, without ``position_ids``."""
    for prefix in ("cond_stage_model.transformer.", "conditioner.embedders.0.transformer."):
        sub = _shave(sd, prefix)
        if sub:
            return {k: v for k, v in sub.items() if not k.endswith("position_ids")}
    return {}


def load_single_file_checkpoint(path: Union[str, os.PathLike]) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` single file, as CPU tensors viewing a
    memory map of the file. Other formats (pickled ``.ckpt`` / ``.pt``)
    raise: unpickling runs code."""
    path = str(path)
    if path.endswith(".safetensors"):
        from ..models.modeling_utils import iter_safetensors

        return dict(iter_safetensors(path))
    raise ValueError("only .safetensors single-file checkpoints are supported (no pickle)")


def model_from_state_dict(cls, config: dict, state_dict: Dict, device: Union[str, torch.device] = "cuda",
                          dtype: Optional[torch.dtype] = None):
    """`cls.from_config(config)` built on the meta device and given `state_dict`
    (diffusers keys; numpy arrays or tensors), each tensor copied to
    `device` (floating ones cast to `dtype` when it is given) before the
    next. Strict: the keys must be the model's state dict, in both
    directions, with its shapes; a key of the class's `_derived_keys`
    (SD3's sin-cos table) is checked against the config and not kept."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{cls.__name__}: no CUDA device is visible; pass device='cpu' to load on the CPU")
    with torch.device("meta"):
        model = cls.from_config(dict(config))
    expected = model.state_dict(keep_vars=True)
    derived = set(state_dict) & set(getattr(model, "_derived_keys", ()))
    missing = sorted(expected.keys() - state_dict.keys())
    unexpected = sorted(state_dict.keys() - expected.keys() - derived)
    if missing or unexpected:
        raise ValueError(f"{cls.__name__}: the state dict does not match the model of this config: missing "
                         f"{missing[:5]} ({len(missing)}), unexpected {unexpected[:5]} ({len(unexpected)})")
    for key, value in sorted(state_dict.items(), key=lambda kv: _address(kv[1])):  # a file's tensors in file order
        tensor = value if isinstance(value, torch.Tensor) else torch.from_numpy(value)
        if key in derived:
            model.check_derived_tensor(key, tensor)
            continue
        target = expected[key]
        if tuple(tensor.shape) != tuple(target.shape):
            raise ValueError(f"{cls.__name__}: {key} has shape {tuple(tensor.shape)}, the model expects "
                             f"{tuple(target.shape)}")
        cast = dtype if dtype is not None and tensor.is_floating_point() else tensor.dtype
        module_name, _, leaf = key.rpartition(".")
        module = model.get_submodule(module_name)
        placed = tensor.to(device=device, dtype=cast, copy=True)
        if leaf in module._parameters:
            module._parameters[leaf] = torch.nn.Parameter(placed, requires_grad=target.requires_grad)
        else:
            module._buffers[leaf] = placed
    left = [n for n, t in (*model.named_parameters(), *model.named_buffers()) if t.is_meta]
    if left:
        raise ValueError(f"{cls.__name__}: {len(left)} tensors were left on the meta device, e.g. {left[:5]}")
    return model.eval()


def _address(value) -> int:
    return value.data_ptr() if isinstance(value, torch.Tensor) else value.__array_interface__["data"][0]


def _read(path_or_state_dict) -> Dict:
    if isinstance(path_or_state_dict, dict):
        return path_or_state_dict
    return load_single_file_checkpoint(path_or_state_dict)


def _num_blocks(keys, prefix: str) -> int:
    return max((int(k.split(".", 2)[1]) for k in keys if k.startswith(prefix)), default=-1) + 1


# ---------------------------------------------------------------------------
# Flux (BFL layout)
# ---------------------------------------------------------------------------


def convert_flux_transformer_state_dict(sd: Dict) -> Dict:
    """BFL Flux keys (double_blocks / single_blocks / img_in / txt_in /
    time_in / vector_in / guidance_in / final_layer) -> diffusers
    `FluxTransformer2DModel` keys (JAX `:234-315`)."""
    ckpt = {k.replace("model.diffusion_model.", ""): v for k, v in sd.items()}
    out: Dict = {}
    num_layers = _num_blocks(ckpt, "double_blocks.")
    num_single = _num_blocks(ckpt, "single_blocks.")
    inner_dim = ckpt["img_in.weight"].shape[0]

    simple = {
        "time_text_embed.timestep_embedder.linear_1": "time_in.in_layer",
        "time_text_embed.timestep_embedder.linear_2": "time_in.out_layer",
        "time_text_embed.text_embedder.linear_1": "vector_in.in_layer",
        "time_text_embed.text_embedder.linear_2": "vector_in.out_layer",
        "context_embedder": "txt_in",
        "x_embedder": "img_in",
        "proj_out": "final_layer.linear",
    }
    if any("guidance_in" in k for k in ckpt):
        simple["time_text_embed.guidance_embedder.linear_1"] = "guidance_in.in_layer"
        simple["time_text_embed.guidance_embedder.linear_2"] = "guidance_in.out_layer"
    for dst, src in simple.items():
        out[f"{dst}.weight"] = ckpt.pop(f"{src}.weight")
        out[f"{dst}.bias"] = ckpt.pop(f"{src}.bias")
    out["norm_out.linear.weight"] = _swap_scale_shift(ckpt.pop("final_layer.adaLN_modulation.1.weight"))
    out["norm_out.linear.bias"] = _swap_scale_shift(ckpt.pop("final_layer.adaLN_modulation.1.bias"))

    for i in range(num_layers):
        p, s = f"transformer_blocks.{i}.", f"double_blocks.{i}."
        out[f"{p}norm1.linear.weight"] = ckpt.pop(f"{s}img_mod.lin.weight")
        out[f"{p}norm1.linear.bias"] = ckpt.pop(f"{s}img_mod.lin.bias")
        out[f"{p}norm1_context.linear.weight"] = ckpt.pop(f"{s}txt_mod.lin.weight")
        out[f"{p}norm1_context.linear.bias"] = ckpt.pop(f"{s}txt_mod.lin.bias")
        for kind, names in (("img_attn", ("to_q", "to_k", "to_v")),
                            ("txt_attn", ("add_q_proj", "add_k_proj", "add_v_proj"))):
            qkv_w = _split(ckpt.pop(f"{s}{kind}.qkv.weight"), 3)
            qkv_b = _split(ckpt.pop(f"{s}{kind}.qkv.bias"), 3)
            for j, n in enumerate(names):
                out[f"{p}attn.{n}.weight"] = qkv_w[j]
                out[f"{p}attn.{n}.bias"] = qkv_b[j]
        out[f"{p}attn.norm_q.weight"] = ckpt.pop(f"{s}img_attn.norm.query_norm.scale")
        out[f"{p}attn.norm_k.weight"] = ckpt.pop(f"{s}img_attn.norm.key_norm.scale")
        out[f"{p}attn.norm_added_q.weight"] = ckpt.pop(f"{s}txt_attn.norm.query_norm.scale")
        out[f"{p}attn.norm_added_k.weight"] = ckpt.pop(f"{s}txt_attn.norm.key_norm.scale")
        for src, dst in (("img_mlp.0", "ff.net.0.proj"), ("img_mlp.2", "ff.net.2"),
                         ("txt_mlp.0", "ff_context.net.0.proj"), ("txt_mlp.2", "ff_context.net.2"),
                         ("img_attn.proj", "attn.to_out.0"), ("txt_attn.proj", "attn.to_add_out")):
            out[f"{p}{dst}.weight"] = ckpt.pop(f"{s}{src}.weight")
            out[f"{p}{dst}.bias"] = ckpt.pop(f"{s}{src}.bias")

    for i in range(num_single):
        p, s = f"single_transformer_blocks.{i}.", f"single_blocks.{i}."
        out[f"{p}norm.linear.weight"] = ckpt.pop(f"{s}modulation.lin.weight")
        out[f"{p}norm.linear.bias"] = ckpt.pop(f"{s}modulation.lin.bias")
        splits = [inner_dim, 2 * inner_dim, 3 * inner_dim]
        q, k, v, mlp = _split(ckpt.pop(f"{s}linear1.weight"), splits)
        qb, kb, vb, mlpb = _split(ckpt.pop(f"{s}linear1.bias"), splits)
        out[f"{p}attn.to_q.weight"], out[f"{p}attn.to_q.bias"] = q, qb
        out[f"{p}attn.to_k.weight"], out[f"{p}attn.to_k.bias"] = k, kb
        out[f"{p}attn.to_v.weight"], out[f"{p}attn.to_v.bias"] = v, vb
        out[f"{p}proj_mlp.weight"], out[f"{p}proj_mlp.bias"] = mlp, mlpb
        out[f"{p}attn.norm_q.weight"] = ckpt.pop(f"{s}norm.query_norm.scale")
        out[f"{p}attn.norm_k.weight"] = ckpt.pop(f"{s}norm.key_norm.scale")
        out[f"{p}proj_out.weight"] = ckpt.pop(f"{s}linear2.weight")
        out[f"{p}proj_out.bias"] = ckpt.pop(f"{s}linear2.bias")
    return out


def is_flux_single_file(sd: Dict) -> bool:
    return any(k.startswith(("double_blocks.", "model.diffusion_model.double_blocks.")) for k in sd)


def load_flux_transformer_single_file(path_or_state_dict, config_overrides: Optional[dict] = None,
                                      dtype: Optional[torch.dtype] = None,
                                      device: Union[str, torch.device] = "cuda"):
    """A BFL-layout Flux single file (a path or a state dict) -> a port
    `FluxTransformer2DModel` on `device`, its config (depth, widths,
    guidance) inferred from the keys as JAX's `:322-361` does."""
    from ..models.transformers.transformer_flux import FluxTransformer2DModel

    converted = convert_flux_transformer_state_dict(_read(path_or_state_dict))
    inner_dim = converted["x_embedder.weight"].shape[0]
    num_layers = _num_blocks(converted, "transformer_blocks.")
    head_dim = converted["transformer_blocks.0.attn.norm_q.weight"].shape[0] if num_layers else 128
    cfg = dict(
        patch_size=1,
        in_channels=converted["x_embedder.weight"].shape[1],
        num_layers=num_layers,
        num_single_layers=_num_blocks(converted, "single_transformer_blocks."),
        attention_head_dim=head_dim,
        num_attention_heads=inner_dim // head_dim,
        joint_attention_dim=converted["context_embedder.weight"].shape[1],
        pooled_projection_dim=converted["time_text_embed.text_embedder.linear_1.weight"].shape[1],
        guidance_embeds=any(k.startswith("time_text_embed.guidance_embedder") for k in converted),
    )
    cfg.update(config_overrides or {})
    return model_from_state_dict(FluxTransformer2DModel, cfg, converted, device, dtype)


# ---------------------------------------------------------------------------
# SD3 / SD3.5 MMDiT (SAI layout)
# ---------------------------------------------------------------------------


def is_sd3_single_file(sd: Dict) -> bool:
    return any(k.startswith(("joint_blocks.", "model.diffusion_model.joint_blocks.")) for k in sd)


def convert_sd3_transformer_state_dict(sd: Dict) -> Dict:
    """SAI MMDiT keys (``joint_blocks.N.{x_block,context_block}``) -> diffusers
    `SD3Transformer2DModel` keys: fused qkv split into to_q/k/v, the final
    AdaLN's (and the last context block's) shift and scale swapped (JAX
    `:381-462`)."""
    sd = {k.replace("model.diffusion_model.", ""): v for k, v in sd.items()}
    out: Dict = {}
    num_layers = _num_blocks(sd, "joint_blocks.")
    dual_layers = {int(k.split(".", 2)[1]) for k in sd if ".x_block.attn2.qkv.weight" in k}
    has_qk_norm = any("ln_q" in k for k in sd)

    out["pos_embed.pos_embed"] = sd["pos_embed"]
    out["pos_embed.proj.weight"] = sd["x_embedder.proj.weight"]
    out["pos_embed.proj.bias"] = sd["x_embedder.proj.bias"]
    for ours, theirs in [
        ("time_text_embed.timestep_embedder.linear_1", "t_embedder.mlp.0"),
        ("time_text_embed.timestep_embedder.linear_2", "t_embedder.mlp.2"),
        ("time_text_embed.text_embedder.linear_1", "y_embedder.mlp.0"),
        ("time_text_embed.text_embedder.linear_2", "y_embedder.mlp.2"),
        ("context_embedder", "context_embedder"),
    ]:
        out[f"{ours}.weight"] = sd[f"{theirs}.weight"]
        out[f"{ours}.bias"] = sd[f"{theirs}.bias"]

    for i in range(num_layers):
        blk, last, jb = f"transformer_blocks.{i}", i == num_layers - 1, f"joint_blocks.{i}"
        for theirs_blk, q, k, v in [
            (f"{jb}.x_block.attn", f"{blk}.attn.to_q", f"{blk}.attn.to_k", f"{blk}.attn.to_v"),
            (f"{jb}.context_block.attn", f"{blk}.attn.add_q_proj", f"{blk}.attn.add_k_proj", f"{blk}.attn.add_v_proj"),
        ]:
            for suffix in ("weight", "bias"):
                out[f"{q}.{suffix}"], out[f"{k}.{suffix}"], out[f"{v}.{suffix}"] = _split(
                    sd[f"{theirs_blk}.qkv.{suffix}"], 3)
        if has_qk_norm:
            out[f"{blk}.attn.norm_q.weight"] = sd[f"{jb}.x_block.attn.ln_q.weight"]
            out[f"{blk}.attn.norm_k.weight"] = sd[f"{jb}.x_block.attn.ln_k.weight"]
            out[f"{blk}.attn.norm_added_q.weight"] = sd[f"{jb}.context_block.attn.ln_q.weight"]
            out[f"{blk}.attn.norm_added_k.weight"] = sd[f"{jb}.context_block.attn.ln_k.weight"]
        out[f"{blk}.attn.to_out.0.weight"] = sd[f"{jb}.x_block.attn.proj.weight"]
        out[f"{blk}.attn.to_out.0.bias"] = sd[f"{jb}.x_block.attn.proj.bias"]
        if not last:
            out[f"{blk}.attn.to_add_out.weight"] = sd[f"{jb}.context_block.attn.proj.weight"]
            out[f"{blk}.attn.to_add_out.bias"] = sd[f"{jb}.context_block.attn.proj.bias"]

        if i in dual_layers:
            for suffix in ("weight", "bias"):
                out[f"{blk}.attn2.to_q.{suffix}"], out[f"{blk}.attn2.to_k.{suffix}"], \
                    out[f"{blk}.attn2.to_v.{suffix}"] = _split(sd[f"{jb}.x_block.attn2.qkv.{suffix}"], 3)
            if has_qk_norm:
                out[f"{blk}.attn2.norm_q.weight"] = sd[f"{jb}.x_block.attn2.ln_q.weight"]
                out[f"{blk}.attn2.norm_k.weight"] = sd[f"{jb}.x_block.attn2.ln_k.weight"]
            out[f"{blk}.attn2.to_out.0.weight"] = sd[f"{jb}.x_block.attn2.proj.weight"]
            out[f"{blk}.attn2.to_out.0.bias"] = sd[f"{jb}.x_block.attn2.proj.bias"]

        out[f"{blk}.norm1.linear.weight"] = sd[f"{jb}.x_block.adaLN_modulation.1.weight"]
        out[f"{blk}.norm1.linear.bias"] = sd[f"{jb}.x_block.adaLN_modulation.1.bias"]
        ctx_w = sd[f"{jb}.context_block.adaLN_modulation.1.weight"]
        ctx_b = sd[f"{jb}.context_block.adaLN_modulation.1.bias"]
        if last:
            ctx_w, ctx_b = _swap_scale_shift(ctx_w), _swap_scale_shift(ctx_b)
        out[f"{blk}.norm1_context.linear.weight"] = ctx_w
        out[f"{blk}.norm1_context.linear.bias"] = ctx_b

        for block, dst in (("x_block", "ff"), ("context_block", "ff_context")):
            if block == "context_block" and last:
                continue
            for src, name in (("mlp.fc1", "net.0.proj"), ("mlp.fc2", "net.2")):
                out[f"{blk}.{dst}.{name}.weight"] = sd[f"{jb}.{block}.{src}.weight"]
                out[f"{blk}.{dst}.{name}.bias"] = sd[f"{jb}.{block}.{src}.bias"]

    out["proj_out.weight"] = sd["final_layer.linear.weight"]
    out["proj_out.bias"] = sd["final_layer.linear.bias"]
    out["norm_out.linear.weight"] = _swap_scale_shift(sd["final_layer.adaLN_modulation.1.weight"])
    out["norm_out.linear.bias"] = _swap_scale_shift(sd["final_layer.adaLN_modulation.1.bias"])
    return out


def load_sd3_transformer_single_file(path_or_state_dict, config_overrides: Optional[dict] = None,
                                     dtype: Optional[torch.dtype] = None,
                                     device: Union[str, torch.device] = "cuda"):
    """An SAI-layout SD3 / SD3.5 single file -> a port `SD3Transformer2DModel`
    on `device`, its config inferred from the keys (depth, dual-attention
    layers, qk norm, the position grid; heads of 64 unless overridden), as
    JAX's `:465-503`. The checkpoint's sin-cos table is checked against the
    config, not kept."""
    from ..models.transformers.transformer_sd3 import SD3Transformer2DModel

    converted = convert_sd3_transformer_state_dict(_read(path_or_state_dict))
    proj = converted["pos_embed.proj.weight"]
    inner_dim = proj.shape[0]
    head_dim = 64
    cfg = dict(
        sample_size=128,
        patch_size=proj.shape[-1],
        in_channels=proj.shape[1],
        num_layers=_num_blocks(converted, "transformer_blocks."),
        attention_head_dim=head_dim,
        num_attention_heads=inner_dim // head_dim,
        joint_attention_dim=converted["context_embedder.weight"].shape[1],
        caption_projection_dim=converted["context_embedder.weight"].shape[0],
        pooled_projection_dim=converted["time_text_embed.text_embedder.linear_1.weight"].shape[1],
        out_channels=converted["proj_out.weight"].shape[0] // (proj.shape[-1] ** 2),
        pos_embed_max_size=int(round(converted["pos_embed.pos_embed"].shape[1] ** 0.5)),
        qk_norm="rms_norm" if any(".norm_q." in k for k in converted) else None,
        dual_attention_layers=tuple(sorted(int(k.split(".")[1]) for k in converted
                                           if k.endswith(".attn2.to_q.weight"))),
    )
    cfg.update(config_overrides or {})
    return model_from_state_dict(SD3Transformer2DModel, cfg, converted, device, dtype)


# ---------------------------------------------------------------------------
# Wan (original layout: base, I2V, VACE)
# ---------------------------------------------------------------------------

_WAN_RENAME = [
    ("model.diffusion_model.", ""),
    ("time_embedding.0", "condition_embedder.time_embedder.linear_1"),
    ("time_embedding.2", "condition_embedder.time_embedder.linear_2"),
    ("text_embedding.0", "condition_embedder.text_embedder.linear_1"),
    ("text_embedding.2", "condition_embedder.text_embedder.linear_2"),
    ("time_projection.1", "condition_embedder.time_proj"),
    ("cross_attn", "attn2"),
    ("self_attn", "attn1"),
    (".o.", ".to_out.0."),
    (".q.", ".to_q."),
    (".k.", ".to_k."),
    (".v.", ".to_v."),
    (".k_img.", ".add_k_proj."),
    (".v_img.", ".add_v_proj."),
    (".norm_k_img.", ".norm_added_k."),
    ("head.modulation", "scale_shift_table"),
    ("head.head", "proj_out"),
    ("modulation", "scale_shift_table"),
    ("ffn.0", "ffn.net.0.proj"),
    ("ffn.2", "ffn.net.2"),
    # norm2 <-> norm3 (the reference's "hack to swap the layer names")
    ("norm2", "norm__placeholder"),
    ("norm3", "norm2"),
    ("norm__placeholder", "norm3"),
    # I2V
    ("img_emb.proj.0", "condition_embedder.image_embedder.norm1"),
    ("img_emb.proj.1", "condition_embedder.image_embedder.ff.net.0.proj"),
    ("img_emb.proj.3", "condition_embedder.image_embedder.ff.net.2"),
    ("img_emb.proj.4", "condition_embedder.image_embedder.norm2"),
    # VACE
    ("before_proj", "proj_in"),
    ("after_proj", "proj_out"),
]


def convert_wan_transformer_state_dict(sd: Dict) -> Dict:
    """Original Wan keys -> diffusers `WanTransformer3DModel` keys (JAX
    `:548-555`: one rename table)."""
    out = {}
    for key, v in sd.items():
        new_key = key
        for old, new in _WAN_RENAME:
            new_key = new_key.replace(old, new)
        out[new_key] = v
    return out


def load_wan_transformer_single_file(path_or_state_dict, config_overrides: Optional[dict] = None,
                                     dtype: Optional[torch.dtype] = None,
                                     device: Union[str, torch.device] = "cuda"):
    """A Wan single file -> a port `WanTransformer3DModel` on `device`, its
    config inferred from the keys as JAX's `:558-595` (heads of 128 unless
    overridden: the qk norm spans all heads, so the keys do not show it)."""
    from ..models.transformers.transformer_wan import WanTransformer3DModel

    converted = convert_wan_transformer_state_dict(_read(path_or_state_dict))
    inner_dim = converted["patch_embedding.weight"].shape[0]
    head_dim = (config_overrides or {}).get("attention_head_dim", 128)
    has_image = any(k.startswith("condition_embedder.image_embedder") for k in converted)
    cfg = dict(
        in_channels=converted["patch_embedding.weight"].shape[1],
        out_channels=converted["proj_out.weight"].shape[0] // 4,  # patch 1x2x2
        num_layers=_num_blocks(converted, "blocks."),
        attention_head_dim=head_dim,
        num_attention_heads=inner_dim // head_dim,
        ffn_dim=converted["blocks.0.ffn.net.0.proj.weight"].shape[0],
        text_dim=converted["condition_embedder.text_embedder.linear_1.weight"].shape[1],
        image_dim=(converted["condition_embedder.image_embedder.ff.net.0.proj.weight"].shape[1]
                   if has_image else None),
        added_kv_proj_dim=inner_dim if any(".add_k_proj." in k for k in converted) else None,
    )
    cfg.update(config_overrides or {})
    return model_from_state_dict(WanTransformer3DModel, cfg, converted, device, dtype)


# ---------------------------------------------------------------------------
# LTX-Video
# ---------------------------------------------------------------------------

_LTX_RENAME = [
    ("model.diffusion_model.", ""),
    ("patchify_proj", "proj_in"),
    ("adaln_single", "time_embed"),
    ("q_norm", "norm_q"),
    ("k_norm", "norm_k"),
]


def convert_ltx_transformer_state_dict(sd: Dict) -> Dict:
    out = {}
    for key, v in sd.items():
        if "vae" in key:
            continue
        new_key = key
        for old, new in _LTX_RENAME:
            new_key = new_key.replace(old, new)
        out[new_key] = v
    return out


def load_ltx_transformer_single_file(path_or_state_dict, config_overrides: Optional[dict] = None,
                                     dtype: Optional[torch.dtype] = None,
                                     device: Union[str, torch.device] = "cuda"):
    """An LTX-Video single file (Lightricks' original layout, with or without
    the ``model.diffusion_model.`` prefix; VAE keys skipped) -> a port
    `LTXVideoTransformer3DModel` on `device`, its config inferred from the
    keys as JAX's `:623-655` (heads of 64 unless overridden: the qk norm
    spans all heads, so the keys do not show it)."""
    from ..models.transformers.transformer_ltx import LTXVideoTransformer3DModel

    converted = convert_ltx_transformer_state_dict(_read(path_or_state_dict))
    inner_dim, in_channels = converted["proj_in.weight"].shape
    head_dim = (config_overrides or {}).get("attention_head_dim", 64)
    cfg = dict(
        in_channels=in_channels,
        out_channels=in_channels,
        num_layers=_num_blocks(converted, "transformer_blocks."),
        attention_head_dim=head_dim,
        num_attention_heads=inner_dim // head_dim,
        cross_attention_dim=converted["transformer_blocks.0.attn2.to_k.weight"].shape[1],
        caption_channels=converted["caption_projection.linear_1.weight"].shape[1],
    )
    cfg.update(config_overrides or {})
    return model_from_state_dict(LTXVideoTransformer3DModel, cfg, converted, device, dtype)


# ---------------------------------------------------------------------------
# checkpoint-type inference (JAX `:663-719`, in its order)
# ---------------------------------------------------------------------------

def _has_any(*keys):
    return lambda sd: any(k in sd for k in keys)


_SD2_KEY = "model.diffusion_model.input_blocks.2.1.transformer_blocks.0.attn2.to_k.weight"
_IP2P_KEY = "model.diffusion_model.input_blocks.0.0.weight"

_CHECKPOINT_SNIFF_KEYS = [
    ("flux2", _has_any("model.diffusion_model.single_stream_modulation.lin.weight",
                       "single_stream_modulation.lin.weight")),
    ("flux", is_flux_single_file),
    ("sd3", is_sd3_single_file),
    ("sdxl_refiner", _has_any("conditioner.embedders.0.model.transformer.resblocks.9.mlp.c_proj.bias")),
    ("sdxl", _has_any("conditioner.embedders.1.model.transformer.resblocks.9.mlp.c_proj.bias")),
    ("sd2", lambda sd: _SD2_KEY in sd and sd[_SD2_KEY].shape[-1] == 1024),
    ("animatediff", _has_any(
        "down_blocks.0.motion_modules.0.temporal_transformer.transformer_blocks.0.attention_blocks.0.pos_encoder.pe",
        "mid_block.motion_modules.0.temporal_transformer.norm.bias")),
    ("controlnet", lambda sd: any(k.startswith("control_model.") for k in sd)),
    ("auraflow", _has_any("double_layers.0.attn.w2q.weight", "cond_seq_linear.weight")),
    ("ltx2", _has_any("model.diffusion_model.av_ca_a2v_gate_adaln_single.emb.timestep_embedder.linear_1.weight",
                      "audio_vae.per_channel_statistics.mean-of-means")),
    ("ltx_video", _has_any("model.diffusion_model.patchify_proj.weight", "patchify_proj.weight",
                           "vae.decoder.last_scale_shift_table")),
    ("hunyuan_video", _has_any("txt_in.individual_token_refiner.blocks.0.adaLN_modulation.1.bias")),
    ("mochi", _has_any("model.diffusion_model.blocks.0.attn.qkv_x.weight", "blocks.0.attn.qkv_x.weight")),
    ("lumina2", _has_any("model.diffusion_model.cap_embedder.0.weight", "cap_embedder.0.weight")),
    ("wan_vace", _has_any("vace_blocks.0.after_proj.bias")),
    ("wan_animate", _has_any("motion_encoder.dec.direction.weight")),
    ("wan", _has_any("model.diffusion_model.head.modulation", "head.modulation")),
    ("wan_vae", _has_any("decoder.middle.0.residual.0.gamma")),
    ("z_image", _has_any("model.diffusion_model.layers.0.adaLN_modulation.0.weight",
                         "layers.0.adaLN_modulation.0.weight")),
    ("hidream", _has_any("double_stream_blocks.0.block.adaLN_modulation.1.bias")),
    ("sana", _has_any("blocks.0.cross_attn.q_linear.weight", "blocks.0.cross_attn.kv_linear.weight")),
    ("cosmos", _has_any("net.x_embedder.proj.1.weight")),
    ("autoencoder_dc", _has_any("decoder.stages.1.op_list.0.main.conv.conv.bias", "encoder.project_in.conv.bias")),
    ("instruct_pix2pix", lambda sd: _IP2P_KEY in sd and sd[_IP2P_KEY].shape[1] == 8),
    ("sd1", lambda sd: any(k.startswith("model.diffusion_model.") for k in sd)),
]


def infer_single_file_checkpoint_type(sd: Dict) -> str:
    """The model family of a single-file state dict, by JAX's sniff table in
    its order (most specific first)."""
    for name, predicate in _CHECKPOINT_SNIFF_KEYS:
        try:
            if predicate(sd):
                return name
        except Exception:
            continue
    raise ValueError(f"could not infer the checkpoint type from the state dict keys; sample keys: {sorted(sd)[:5]}")

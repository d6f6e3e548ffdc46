"""LoRA: the checkpoint-format converters, fusing into `nn.Module`s, and the
pipeline's named adapters.

Port of `diffusers_tpu/loaders/lora.py`. The converters (`convert_*`, the
`_is_*` detectors and `group_lora_weights`, `:44-554`) are plain functions
on a flat ``{key: array}`` dict whose arrays may be numpy arrays or torch
tensors; they keep JAX's detection order and key maps, except where JAX's
map names a module that does not exist (each such divergence is tested
against JAX in `tests/test_torch_lora.py`):

* `_kohya_path` keeps the dots of ``ff.net`` and ``encoder.layers`` (JAX
  joins them into ``ff_net`` and ``encoder_layers``) and of ``ff.context``
  and ``norm1.context`` it joins; SGM-layout UNet keys (``input_blocks_N_M``,
  ``middle_block_N``, ``output_blocks_N_M``: kohya's SDXL LoRAs) go through
  the LDM -> diffusers UNet map of `single_file.ldm_unet_module_path`,
  where JAX makes ``unet.input.blocks...``;
* `convert_hunyuan_video_lora` runs the rename table on the token refiner's
  ``txt_in`` keys before their own renames, splits a single block's
  ``linear1`` at the hidden width its ``lora_A`` reads (JAX guesses it from
  divisibility by 13), and swaps the (shift, scale) halves of the final
  layer's ``adaLN_modulation.1`` lora_B rows into diffusers' (scale, shift).

A LoRA is fused as a weight delta into the module it names, in place:
``W' = W + scale * (alpha / r) * (B @ A)`` in float32, cast back to W's
dtype (the port's Linear is ``[out, in]``, so no transpose; a 1x1
convolution takes the delta as ``[out, in, 1, 1]``). Paths are looked up in
``named_modules()``. A path that lands on a quantized layer raises: its int8
or fp8 weight holds values in units of its scale, and a float delta added
there rounds away (JAX's `fuse_lora` adds it and casts back, ignoring the
scale); load the LoRA before quantizing.

`PipelineLoraMixin` gives every pipeline JAX's runtime surface:
`load_lora_weights`, `set_adapters`, `hotswap_lora_weights`,
`get_active_adapters`, `disable_lora` (``unfuse_lora``) and
`delete_adapters`. JAX rebuilds a params pytree from its kept base; here the
pipeline keeps a pristine copy of each weight (and bias) that a loaded
adapter touches, and only those, on the weight's own device, and rebuilds
the fused weights in place from them, so modules, shapes and dtypes never
change and `disable_lora` gives the base back bit for bit.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..utils import logging

logger = logging.get_logger(__name__)

_COMPONENT_PREFIXES = ("transformer.", "unet.", "text_encoder.", "text_encoder_2.")


def _split(value, sections, axis: int = 0):
    """np.split for numpy arrays and torch tensors: `sections` an int (equal
    parts) or a list of split points."""
    if isinstance(value, torch.Tensor):
        if isinstance(sections, int):
            return list(torch.chunk(value, sections, dim=axis))
        return list(torch.tensor_split(value, sections, dim=axis))
    return np.split(np.asarray(value), sections, axis=axis)


def _cat(values, axis: int = 0):
    if isinstance(values[0], torch.Tensor):
        return torch.cat(values, dim=axis)
    return np.concatenate(values, axis=axis)


def _strip_prefix(key: str) -> str:
    for p in _COMPONENT_PREFIXES:
        if key.startswith(p):
            return key[len(p):]
    return key


def _fold_alpha(out: dict, alphas: Dict[str, float]) -> None:
    """Fold each ``alpha`` into its (A, B) pair with the balanced power-of-two
    split of the reference (both matrices stay in a sane fp16 range)."""
    for path, alpha in alphas.items():
        a_key, b_key = path + ".lora_A.weight", path + ".lora_B.weight"
        if a_key not in out or b_key not in out:
            continue
        scale = alpha / out[a_key].shape[0]
        scale_down, scale_up = scale, 1.0
        while scale_down * 2 < scale_up:
            scale_down *= 2
            scale_up /= 2
        out[a_key] = out[a_key] * scale_down
        out[b_key] = out[b_key] * scale_up


# ------------------------------------------------------------------ kohya-ss

def convert_kohya_lora(state_dict: Dict, unet_layers_per_block: int = 2) -> Dict:
    """kohya-ss naming -> diffusers naming (UNet and text-encoder Linears):
    ``lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q.lora_down.weight``
    -> ``unet.down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.lora_A.weight``.
    SGM-layout UNet keys (``lora_unet_input_blocks_4_1_...``) are mapped with
    the UNet's `unet_layers_per_block` (2 for SDXL)."""
    out = {}
    for key, value in state_dict.items():
        if ".alpha" in key or key.endswith("alpha"):
            base = key.replace(".alpha", "")
            out[_kohya_path(base, unet_layers_per_block) + ".alpha"] = value
            continue
        if ".lora_down.weight" in key:
            base = key.replace(".lora_down.weight", "")
            out[_kohya_path(base, unet_layers_per_block) + ".lora_A.weight"] = value
        elif ".lora_up.weight" in key:
            base = key.replace(".lora_up.weight", "")
            out[_kohya_path(base, unet_layers_per_block) + ".lora_B.weight"] = value
        else:
            out[key] = value
    return out


# multi-word module names whose underscores stay (JAX's list, less "ff.net" and
# "encoder.layers", whose dots are the module path, plus "ff.context" and "norm1.context")
_KOHYA_WORDS = sorted([
    "single.transformer.blocks", "transformer.blocks", "down.blocks", "up.blocks", "mid.block",
    "attentions", "resnets", "to.add.out", "to.q", "to.k", "to.v", "to.out", "proj.in", "proj.out",
    "text.model", "self.attn", "q.proj", "k.proj", "v.proj", "out.proj",
    "conv.shortcut", "time.emb.proj", "conv.in", "conv.out", "proj.mlp", "x.embedder",
    "context.embedder", "add.q.proj", "add.k.proj", "add.v.proj", "ff.context", "norm1.context",
], key=len, reverse=True)

# SGM (LDM) UNet sub-layers of a resnet, a down- or upsampler: kohya name -> diffusers name
_SGM_SUBLAYERS = {
    "in_layers_2": "conv1", "emb_layers_1": "time_emb_proj", "out_layers_3": "conv2",
    "skip_connection": "conv_shortcut", "op": "conv", "conv": "conv",
}
_SGM_TOP_LEVEL = {
    "time_embed_0": "time_embedding.linear_1", "time_embed_2": "time_embedding.linear_2",
    "label_emb_0_0": "add_embedding.linear_1", "label_emb_0_2": "add_embedding.linear_2",
    "input_blocks_0_0": "conv_in", "out_0": "conv_norm_out", "out_2": "conv_out",
}
_SGM_BLOCK = re.compile(r"^(input_blocks|output_blocks)_(\d+)_(\d+)(?:_(.+))?$|^middle_block_(\d+)(?:_(.+))?$")


def _dotted(rest: str) -> str:
    rest = rest.replace("_", ".")
    for word in _KOHYA_WORDS:  # longest first, so nested names (single.transformer.blocks) win
        rest = rest.replace(word, word.replace(".", "_"))
    return rest


def _sgm_unet_path(rest: str, layers_per_block: int) -> Optional[str]:
    """The diffusers UNet path of an SGM-layout kohya key (after
    ``lora_unet_``), or None when `rest` is not in that layout."""
    from .single_file import ldm_unet_module_path

    if rest in _SGM_TOP_LEVEL:
        return _SGM_TOP_LEVEL[rest]
    m = _SGM_BLOCK.match(rest)
    if m is None:
        return None
    if m.group(1):
        ldm = f"{m.group(1)}.{m.group(2)}.{m.group(3)}"
        tail = m.group(4) or ""
    else:
        ldm = f"middle_block.{m.group(5)}"
        tail = m.group(6) or ""
    sublayer = _SGM_SUBLAYERS.get(tail)
    is_attention = sublayer is None
    prefix = ldm_unet_module_path(ldm, layers_per_block, is_attention=is_attention,
                                  is_sampler=tail in ("op", "conv"))
    if prefix is None or not tail:
        raise ValueError(f"kohya LoRA key lora_unet_{rest} is in the SGM (LDM) UNet layout at a place the "
                         f"LDM -> diffusers UNet map does not name (layers_per_block={layers_per_block})")
    return f"{prefix}.{sublayer}" if sublayer is not None else f"{prefix}.{_dotted(tail)}"


def _kohya_path(base: str, unet_layers_per_block: int = 2) -> str:
    if base.startswith("lora_unet_"):
        rest = base[len("lora_unet_"):]
        sgm = _sgm_unet_path(rest, unet_layers_per_block)
        if sgm is not None:
            return "unet." + sgm
        prefix = "unet."
    elif base.startswith("lora_te_"):
        prefix, rest = "text_encoder.", base[len("lora_te_"):]
    elif base.startswith("lora_te1_"):
        prefix, rest = "text_encoder.", base[len("lora_te1_"):]
    elif base.startswith("lora_te2_"):
        prefix, rest = "text_encoder_2.", base[len("lora_te2_"):]
    else:
        return base
    return prefix + _dotted(rest)


# ------------------------------------------------------------------ xlabs Flux

def convert_xlabs_flux_lora(state_dict: Dict) -> Dict:
    """xlabs Flux LoRA naming -> diffusers/peft naming (JAX `:100-157`). Fused
    qkv LoRAs are split: the shared down (A) weight is copied to q/k/v; the
    up (B) weight is row-split."""
    sd = dict(state_dict)
    out: Dict = {}

    def handle_qkv(down_key, targets):
        down = sd.pop(down_key)
        up = sd.pop(down_key.replace(".down.weight", ".up.weight"))
        dims = up.shape[0] // len(targets)
        for j, tgt in enumerate(targets):
            out[tgt + ".lora_A.weight"] = down
            out[tgt + ".lora_B.weight"] = up[j * dims:(j + 1) * dims]

    for key in list(sd.keys()):
        if key not in sd:
            continue
        k = key.removeprefix("diffusion_model.")
        m = re.search(r"double_blocks\.(\d+)", k)
        ms = re.search(r"single_blocks\.(\d+)", k)
        if m:
            blk = f"transformer.transformer_blocks.{m.group(1)}"
            if "processor.qkv_lora1" in k:
                if k.endswith(".down.weight"):
                    handle_qkv(key, [f"{blk}.attn.to_q", f"{blk}.attn.to_k", f"{blk}.attn.to_v"])
                continue
            if "processor.qkv_lora2" in k:
                if k.endswith(".down.weight"):
                    handle_qkv(key, [f"{blk}.attn.add_q_proj", f"{blk}.attn.add_k_proj", f"{blk}.attn.add_v_proj"])
                continue
            if "processor.proj_lora1" in k:
                tgt = f"{blk}.attn.to_out.0"
            elif "processor.proj_lora2" in k:
                tgt = f"{blk}.attn.to_add_out"
            else:
                out[key] = sd.pop(key)
                continue
            suffix = ".lora_A.weight" if k.endswith(".down.weight") else ".lora_B.weight"
            out[tgt + suffix] = sd.pop(key)
        elif ms:
            blk = f"transformer.single_transformer_blocks.{ms.group(1)}"
            if "qkv_lora" in k:
                if k.endswith(".down.weight"):
                    handle_qkv(key, [f"{blk}.attn.to_q", f"{blk}.attn.to_k", f"{blk}.attn.to_v"])
                continue
            if "proj_lora" in k:
                suffix = ".lora_A.weight" if k.endswith(".down.weight") else ".lora_B.weight"
                out[f"{blk}.proj_out" + suffix] = sd.pop(key)
            else:
                out[key] = sd.pop(key)
        else:
            out[key] = sd.pop(key)
    return out


# ------------------------------------------------------------------ Wan

_WAN_SUBS = sorted([
    ("self_attn.q", "attn1.to_q"), ("self_attn.k", "attn1.to_k"),
    ("self_attn.v", "attn1.to_v"), ("self_attn.o", "attn1.to_out.0"),
    ("cross_attn.k_img", "attn2.add_k_proj"), ("cross_attn.v_img", "attn2.add_v_proj"),
    ("cross_attn.q", "attn2.to_q"), ("cross_attn.k", "attn2.to_k"),
    ("cross_attn.v", "attn2.to_v"), ("cross_attn.o", "attn2.to_out.0"),
    ("ffn.0", "ffn.net.0.proj"), ("ffn.2", "ffn.net.2"),
    ("time_projection.1", "condition_embedder.time_proj"),
    ("text_embedding.0", "condition_embedder.text_embedder.linear_1"),
    ("text_embedding.2", "condition_embedder.text_embedder.linear_2"),
    ("time_embedding.0", "condition_embedder.time_embedder.linear_1"),
    ("time_embedding.2", "condition_embedder.time_embedder.linear_2"),
    ("img_emb.proj.1", "condition_embedder.image_embedder.ff.net.0.proj"),
    ("img_emb.proj.3", "condition_embedder.image_embedder.ff.net.2"),
    ("head.head", "proj_out"),
], key=lambda s: len(s[0]), reverse=True)


def convert_wan_lora(state_dict: Dict) -> Dict:
    """Wan trainer naming (``diffusion_model.blocks.N.self_attn...``) ->
    diffusers naming (JAX `:160-228`): lora_down/lora_up or lora_A/lora_B,
    ``alpha`` folded into the pair, ``diff_b`` bias deltas to ``lora_B.bias``,
    norm ``.diff`` keys dropped."""
    sd = {k[len("diffusion_model."):]: v for k, v in state_dict.items() if k.startswith("diffusion_model.")}
    down_key = "lora_A" if any(".lora_A." in k for k in sd) else "lora_down"
    up_key = "lora_B" if any(".lora_B." in k for k in sd) else "lora_up"

    def map_path(path: str) -> str:
        for theirs, ours in _WAN_SUBS:
            if f".{theirs}" in f".{path}":
                return f".{path}".replace(f".{theirs}", f".{ours}")[1:]
        return path

    out: Dict = {}
    alphas: Dict[str, float] = {}
    for key, value in sd.items():
        if key.endswith(".alpha"):
            alphas[map_path(key[: -len(".alpha")])] = float(value)
        elif key.endswith(f".{down_key}.weight"):
            out[map_path(key[: -len(f".{down_key}.weight")]) + ".lora_A.weight"] = value
        elif key.endswith(f".{up_key}.weight"):
            out[map_path(key[: -len(f".{up_key}.weight")]) + ".lora_B.weight"] = value
        elif key.endswith(".diff_b"):
            out[map_path(key[: -len(".diff_b")]) + ".lora_B.bias"] = value
        elif key.endswith(".diff"):
            logger.debug(f"dropping norm diff key {key} (zero-valued in known Wan LoRAs)")
        else:
            logger.warning(f"unhandled Wan LoRA key {key}; skipping")
    _fold_alpha(out, alphas)
    return {f"transformer.{k}": v for k, v in out.items()}


def convert_diffusion_model_prefix_lora(state_dict: Dict) -> Dict:
    """Generic ``diffusion_model.``-prefixed LoRA whose inner names already
    match diffusers module paths (LTX-Video, HiDream, ComfyUI trainers)."""
    return {"transformer." + k[len("diffusion_model."):]: v
            for k, v in state_dict.items() if k.startswith("diffusion_model.")}


# ------------------------------------------------------------------ QwenImage

_QWEN_PROTECTED = sorted([
    "add_q_proj", "add_k_proj", "add_v_proj", "to_add_out",
    "to_q", "to_k", "to_v", "to_out",
    "txt_mlp", "img_mlp", "txt_mod", "img_mod",
], key=lambda p: -p.count("_"))
_QWEN_TOP_LEVEL = {
    "img_in": "img_in",
    "txt_in": "txt_in",
    "proj_out": "proj_out",
    "norm_out_linear": "norm_out.linear",
    "time_text_embed_timestep_embedder_linear_1": "time_text_embed.timestep_embedder.linear_1",
    "time_text_embed_timestep_embedder_linear_2": "time_text_embed.timestep_embedder.linear_2",
}


def convert_qwen_lora(state_dict: Dict) -> Dict:
    """QwenImage kohya-flattened naming (``lora_unet_transformer_blocks_N_...``)
    -> diffusers naming (JAX `:258-312`): underscores unflattened except in
    protected n-grams (to_q, img_mod, ...); alpha folded into the pair."""
    sd = {k[len("lora_unet_"):]: v for k, v in state_dict.items() if k.startswith("lora_unet_")}

    def convert_base(base: str) -> str:
        for flat, dotted in _QWEN_TOP_LEVEL.items():
            if base == flat or base.startswith(flat + "."):
                return dotted + base[len(flat):]
        rest = base[len("transformer_blocks_"):]
        head, tail = (rest.split(".", 1) + [""])[:2]
        tail = ("." + tail) if tail else ""
        parts = head.split("_")
        merged, i = [], 0
        while i < len(parts):
            for prot in _QWEN_PROTECTED:
                pw = prot.split("_")
                if parts[i: i + len(pw)] == pw:
                    merged.append(prot)
                    i += len(pw)
                    break
            else:
                merged.append(parts[i])
                i += 1
        return "transformer_blocks." + ".".join(merged) + tail

    out, alphas = {}, {}
    for key, value in sd.items():
        if key.endswith(".alpha"):
            alphas["transformer." + convert_base(key[: -len(".alpha")])] = float(value)
            continue
        for suffix, ours in ((".lora_down.weight", ".lora_A.weight"), (".lora_up.weight", ".lora_B.weight")):
            if key.endswith(suffix):
                out["transformer." + convert_base(key[: -len(suffix)]) + ours] = value
                break
        else:
            logger.warning(f"unhandled Qwen LoRA key {key}; skipping")
    _fold_alpha(out, alphas)
    return out


# ------------------------------------------------------------------ HunyuanVideo

_HUNYUAN_RENAMES = [
    # (theirs, diffusers): the reference's TRANSFORMER_KEYS_RENAME_DICT restricted to
    # Linears a LoRA can target; the final layer's adaLN is renamed (and its rows swapped)
    # by `convert_hunyuan_video_lora`, and the token refiner's `self_attn_proj` and
    # `input_embedder` by this table before the `txt_in` renames
    ("time_in.mlp.0", "time_text_embed.timestep_embedder.linear_1"),
    ("time_in.mlp.2", "time_text_embed.timestep_embedder.linear_2"),
    ("guidance_in.mlp.0", "time_text_embed.guidance_embedder.linear_1"),
    ("guidance_in.mlp.2", "time_text_embed.guidance_embedder.linear_2"),
    ("vector_in.in_layer", "time_text_embed.text_embedder.linear_1"),
    ("vector_in.out_layer", "time_text_embed.text_embedder.linear_2"),
    ("img_attn_proj", "attn.to_out.0"),
    ("txt_attn_proj", "attn.to_add_out"),
    ("self_attn_proj", "attn.to_out.0"),
    ("img_mod.linear", "norm1.linear"),
    ("txt_mod.linear", "norm1_context.linear"),
    ("modulation.linear", "norm.linear"),
    ("final_layer.linear", "proj_out"),
    ("img_mlp", "ff"),
    ("txt_mlp", "ff_context"),
    ("img_in", "x_embedder"),
    ("input_embedder", "proj_in"),
    ("fc1", "net.0.proj"),
    ("fc2", "net.2"),
]
_HUNYUAN_FINAL_ADALN = "final_layer.adaLN_modulation.1"


def convert_hunyuan_video_lora(state_dict: Dict) -> Dict:
    """HunyuanVideo original-layout LoRA (``double_blocks.N.img_attn_qkv``,
    ``single_blocks.N.linear1``, ...) -> diffusers naming (JAX `:341-414`,
    the reference's `_convert_hunyuan_video_lora_to_diffusers`): fused
    ``img_attn_qkv`` / ``txt_attn_qkv`` / ``self_attn_qkv`` share lora_A
    across q/k/v and split lora_B in thirds; a single block's ``linear1``
    (qkv || mlp) shares lora_A across to_q/to_k/to_v/proj_mlp and splits
    lora_B at the hidden width its lora_A reads."""
    sd = {}
    for k, v in state_dict.items():
        for p in ("transformer.", "diffusion_model."):
            if k.startswith(p):
                k = k[len(p):]
        sd[k] = v

    def rename(key: str) -> str:
        key = key.replace("double_blocks", "transformer_blocks")
        key = key.replace("single_blocks", "single_transformer_blocks")
        key = key.replace(_HUNYUAN_FINAL_ADALN, "norm_out.linear")
        for theirs, ours in _HUNYUAN_RENAMES:
            key = key.replace(theirs, ours)
        if key.startswith("txt_in."):  # the token-refiner tree (the reference's remap_txt_in_)
            key = key.replace("individual_token_refiner.blocks", "token_refiner.refiner_blocks")
            key = key.replace("adaLN_modulation.1", "norm_out.linear")
            key = key.replace("txt_in", "context_embedder", 1)
            key = key.replace("t_embedder.mlp.0", "time_text_embed.timestep_embedder.linear_1")
            key = key.replace("t_embedder.mlp.2", "time_text_embed.timestep_embedder.linear_2")
            key = key.replace("c_embedder", "time_text_embed.text_embedder")
            key = key.replace("mlp", "ff")
            return key
        return key.replace("linear2", "proj_out")

    def lora_a_of(key: str):
        for b, a in ((".lora_B.", ".lora_A."), (".lora_up.", ".lora_down.")):
            if b in key and key.replace(b, a) in sd:
                return sd[key.replace(b, a)]
        raise ValueError(f"HunyuanVideo LoRA key {key} has no lora_A beside it: the hidden width of linear1 is "
                         "the width its lora_A reads")

    out: Dict = {}
    for key, value in sd.items():
        is_A = ".lora_A." in key or ".lora_down." in key
        source = key
        key = key.replace(".lora_down.weight", ".lora_A.weight").replace(".lora_up.weight", ".lora_B.weight")
        if "img_attn_qkv" in key or "txt_attn_qkv" in key or "self_attn_qkv" in key:
            which = "img_attn_qkv" if "img_attn_qkv" in key else (
                "txt_attn_qkv" if "txt_attn_qkv" in key else "self_attn_qkv")
            heads = (("attn.to_q", "attn.to_k", "attn.to_v") if which != "txt_attn_qkv"
                     else ("attn.add_q_proj", "attn.add_k_proj", "attn.add_v_proj"))
            if is_A or key.endswith(".alpha"):
                for h in heads:
                    out[rename(key.replace(which, h))] = value
            else:
                for h, part in zip(heads, _split(value, 3)):
                    out[rename(key.replace(which, h))] = part
        elif "single_blocks" in key and ".linear1." in key:
            targets = ("attn.to_q", "attn.to_k", "attn.to_v", "proj_mlp")
            if is_A or key.endswith(".alpha"):
                for t in targets:
                    out[rename(key.replace("linear1", t))] = value
            else:
                hidden = lora_a_of(source).shape[1]
                for t, part in zip(targets, _split(value, [hidden, 2 * hidden, 3 * hidden])):
                    out[rename(key.replace("linear1", t))] = part
        elif _HUNYUAN_FINAL_ADALN in key and key.endswith(".lora_B.weight"):
            shift, scale = _split(value, 2)  # the original (shift, scale) rows -> diffusers' (scale, shift)
            out[rename(key)] = _cat([scale, shift])
        else:
            out[rename(key)] = value
    return {f"transformer.{k}": v for k, v in out.items()}


# ------------------------------------------------------------------ musubi-tuner Wan

_MUSUBI_WAN_SUBS = [
    ("self_attn_q", "attn1.to_q"), ("self_attn_k", "attn1.to_k"),
    ("self_attn_v", "attn1.to_v"), ("self_attn_o", "attn1.to_out.0"),
    ("cross_attn_k_img", "attn2.add_k_proj"), ("cross_attn_v_img", "attn2.add_v_proj"),
    ("cross_attn_q", "attn2.to_q"), ("cross_attn_k", "attn2.to_k"),
    ("cross_attn_v", "attn2.to_v"), ("cross_attn_o", "attn2.to_out.0"),
    ("ffn_0", "ffn.net.0.proj"), ("ffn_2", "ffn.net.2"),
]


def convert_musubi_wan_lora(state_dict: Dict) -> Dict:
    """musubi-tuner Wan LoRA (``lora_unet_blocks_N_<module>``) -> diffusers
    naming, alpha folded into the pair (JAX `:429-476`)."""
    sd = {k[len("lora_unet_"):]: v for k, v in state_dict.items() if k.startswith("lora_unet_blocks_")}

    def map_base(base: str) -> Optional[str]:
        m = re.match(r"blocks_(\d+)_(.+)$", base)
        if m is None:
            return None
        for theirs, ours in _MUSUBI_WAN_SUBS:
            if m.group(2) == theirs:
                return f"blocks.{m.group(1)}.{ours}"
        return None

    out: Dict = {}
    alphas: Dict[str, float] = {}
    for key, value in sd.items():
        if key.endswith(".alpha"):
            path = map_base(key[: -len(".alpha")])
            if path is not None:
                alphas[path] = float(value)
            continue
        for suffix, ours in ((".lora_down.weight", ".lora_A.weight"), (".lora_up.weight", ".lora_B.weight")):
            if key.endswith(suffix):
                path = map_base(key[: -len(suffix)])
                if path is None:
                    logger.warning(f"unhandled musubi Wan LoRA key {key}; skipping")
                else:
                    out[path + ours] = value
                break
    _fold_alpha(out, alphas)
    return {f"transformer.{k}": v for k, v in out.items()}


# ------------------------------------------------------------------ detection and grouping

def _is_hunyuan_video_lora(state_dict) -> bool:
    return any("img_attn_qkv" in k or "txt_attn_qkv" in k or (".linear1." in k and "single_blocks" in k)
               for k in state_dict)


def _is_musubi_wan_lora(state_dict) -> bool:
    return any(k.startswith("lora_unet_blocks_") for k in state_dict)


def _is_wan_lora(state_dict) -> bool:
    return any(k.startswith("diffusion_model.") and (".self_attn." in k or ".cross_attn." in k) for k in state_dict)


def _is_qwen_kohya_lora(state_dict) -> bool:
    return any(k.startswith("lora_unet_transformer_blocks_") for k in state_dict)


def _is_xlabs_lora(state_dict) -> bool:
    return any(".processor." in k and (".down.weight" in k or ".up.weight" in k) for k in state_dict)


LoraEntry = Tuple[object, object, Optional[float], Optional[object]]


def group_lora_weights(state_dict: Dict, component: Optional[str] = None,
                       unet_layers_per_block: int = 2) -> Dict[str, LoraEntry]:
    """Group flat LoRA keys into ``{module_path: (A, B, alpha, bias)}``,
    converting a known community format first (JAX's detection order:
    xlabs, HunyuanVideo, musubi Wan, Wan, Qwen kohya, ``diffusion_model.``,
    kohya). With `component` ("unet", "transformer", ...) only its keys are
    kept, without the prefix; without it every component prefix is
    stripped. `unet_layers_per_block` maps kohya's SGM-layout UNet keys."""
    if _is_xlabs_lora(state_dict):
        state_dict = convert_xlabs_flux_lora(state_dict)
    elif _is_hunyuan_video_lora(state_dict):
        state_dict = convert_hunyuan_video_lora(state_dict)
    elif _is_musubi_wan_lora(state_dict):
        state_dict = convert_musubi_wan_lora(state_dict)
    elif _is_wan_lora(state_dict):
        state_dict = convert_wan_lora(state_dict)
    elif _is_qwen_kohya_lora(state_dict):
        state_dict = convert_qwen_lora(state_dict)
    elif any(k.startswith("diffusion_model.") for k in state_dict):
        state_dict = convert_diffusion_model_prefix_lora(state_dict)
    elif any(".lora_down." in k or ".lora_up." in k for k in state_dict):
        state_dict = convert_kohya_lora(state_dict, unet_layers_per_block)

    grouped: Dict[str, dict] = {}
    for key, value in state_dict.items():
        if key.endswith(".alpha"):
            path, leaf = key[: -len(".alpha")], "alpha"
        elif key.endswith(".lora_A.weight") or key.endswith(".lora_A.default.weight"):
            path, leaf = re.sub(r"\.lora_A(\.default)?\.weight$", "", key), "A"
        elif key.endswith(".lora_B.weight") or key.endswith(".lora_B.default.weight"):
            path, leaf = re.sub(r"\.lora_B(\.default)?\.weight$", "", key), "B"
        elif key.endswith(".lora_B.bias"):
            path, leaf = key[: -len(".lora_B.bias")], "B_bias"
        else:
            continue
        if component is not None:
            if not path.startswith(component + "."):
                continue
            path = path[len(component) + 1:]
        else:
            path = _strip_prefix(path)
        grouped.setdefault(path, {})[leaf] = value

    out = {}
    for path, parts in grouped.items():
        if "A" not in parts or "B" not in parts:
            logger.warning(f"incomplete LoRA pair at {path}; skipping")
            continue
        alpha = float(parts["alpha"]) if "alpha" in parts else None
        out[path] = (parts["A"], parts["B"], alpha, parts.get("B_bias"))
    return out


# ------------------------------------------------------------------ fusing

def _f32(value, device) -> torch.Tensor:
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.array(value, dtype=np.float32))
    return value.to(device=device, dtype=torch.float32)


def _fusible(model: nn.Module, path: str) -> Optional[nn.Module]:
    """The module a LoRA path names, if it takes a weight delta (a Linear or
    a 1x1 convolution); None when `model` has no such module. A quantized
    layer raises."""
    from ..ops.module import Int4Linear, Int8Conv2d, _QuantizedLayer

    try:
        module = model.get_submodule(path)
    except AttributeError:
        return None
    if isinstance(module, (_QuantizedLayer, Int4Linear, Int8Conv2d)):
        raise ValueError(f"LoRA path {path!r} lands on a quantized layer ({type(module).__name__}): a float delta "
                         "added to its quantized weight rounds away. Load the LoRA before quantizing the model")
    if isinstance(module, nn.Linear) or (isinstance(module, nn.Conv2d) and module.kernel_size == (1, 1)):
        return module
    return None


def _lora_delta(entry: LoraEntry, scale: float, device) -> torch.Tensor:
    """``scale * (alpha / r) * (B @ A)`` in float32, ``[out, in]``."""
    A, B, alpha = _f32(entry[0], device), _f32(entry[1], device), entry[2]
    if A.ndim == 4 and A.shape[2:] == (1, 1):  # a 1x1-conv LoRA
        A, B = A.flatten(1), B.flatten(1)
    if A.ndim != 2 or B.ndim != 2:
        raise ValueError(f"a LoRA pair of shapes {tuple(A.shape)} / {tuple(B.shape)} is not a Linear's or a 1x1 "
                         "convolution's")
    eff = scale * ((alpha / A.shape[0]) if alpha is not None else 1.0)
    return (B @ A) * eff


def _resolve(model: nn.Module, paths: Iterable[str]) -> Tuple[Dict[str, nn.Module], list]:
    found, missed = {}, []
    for path in paths:
        module = _fusible(model, path)
        if module is None:
            missed.append(path)
        else:
            found[path] = module
    if missed:
        logger.warning(f"{len(missed)} LoRA modules had no matching module path, e.g. {missed[:5]}")
    return found, missed


@torch.no_grad()
def _write_fused(module: nn.Module, base_weight: torch.Tensor, delta: Optional[torch.Tensor],
                 base_bias: Optional[torch.Tensor] = None, bias_delta: Optional[torch.Tensor] = None) -> None:
    """``module.weight = base_weight + delta`` (float32, cast back), in place."""
    weight = module.weight
    if delta is None:
        weight.copy_(base_weight)
    else:
        weight.copy_((base_weight.float() + delta.reshape(weight.shape)).to(weight.dtype))
    if base_bias is not None:
        if bias_delta is None:
            module.bias.copy_(base_bias)
        else:
            module.bias.copy_((base_bias.float() + bias_delta).to(module.bias.dtype))


def fuse_lora(model: nn.Module, lora_weights: Dict[str, LoraEntry], scale: float = 1.0) -> nn.Module:
    """Fuse grouped LoRA weights (`group_lora_weights`) into `model`'s Linears
    in place: ``W += scale * (alpha / r) * (B @ A)`` in float32, cast back to
    W's dtype; a ``lora_B.bias`` adds ``scale * bias`` to the bias. Paths
    `model` lacks are logged with their count. Returns `model`."""
    return fuse_lora_multi(model, [(lora_weights, scale)])


def fuse_lora_multi(model: nn.Module, adapters) -> nn.Module:
    """Fuse several adapters at once, in place: ``W += sum_i scale_i * delta_i``
    (float32, summed in the adapters' order, cast back once), and each
    adapter's ``lora_B.bias`` as in `fuse_lora` (JAX's `fuse_lora_multi`
    drops them). `adapters` is a list of (grouped weights, scale). Returns
    `model`."""
    weights, biases = _summed_deltas(model, adapters)
    for path, (module, delta) in weights.items():
        bias_delta = biases.get(path)
        _write_fused(module, module.weight, delta, module.bias if bias_delta is not None else None, bias_delta)
    logger.info(f"fused {len(weights)} LoRA modules")
    return model


def _summed_deltas(model: nn.Module, adapters):
    """({path: (module, summed weight delta)}, {path: summed bias delta})."""
    paths = list(dict.fromkeys(p for grouped, _ in adapters for p in grouped))
    found, _ = _resolve(model, paths)
    weights, biases = {}, {}
    for grouped, scale in adapters:
        for path, entry in grouped.items():
            if path not in found:
                continue
            module = found[path]
            delta = _lora_delta(entry, scale, module.weight.device)
            weights[path] = (module, weights[path][1] + delta if path in weights else delta)
            bias = entry[3] if len(entry) > 3 else None
            if bias is not None and module.bias is not None:
                b = scale * _f32(bias, module.bias.device)
                biases[path] = biases[path] + b if path in biases else b
    return weights, biases


def _load_state_dict(source) -> Dict:
    """A LoRA checkpoint: a safetensors path (read as CPU tensors) or a dict."""
    if isinstance(source, (str, bytes)) or hasattr(source, "__fspath__"):
        from ..models.modeling_utils import iter_safetensors

        return {k: v.clone() for k, v in iter_safetensors(source)}
    return dict(source)


def load_lora_weights(path_or_state_dict, model: nn.Module, component: Optional[str] = None,
                      scale: float = 1.0) -> nn.Module:
    """Read a LoRA (a safetensors file or a state dict) and fuse it into
    `model` in place (`fuse_lora`). Returns `model`."""
    grouped = group_lora_weights(_load_state_dict(path_or_state_dict), component=component)
    return fuse_lora(model, grouped, scale=scale)


# ------------------------------------------------------------------ the pipeline's adapters

_LORA_COMPONENT_NAMES = ("transformer", "unet", "text_encoder", "text_encoder_2")


class PipelineLoraMixin:
    """Named LoRA adapters on a pipeline: per-adapter scales, activation and
    deactivation without reloading the base weights.

    An adapter is kept as its grouped (A, B, alpha, bias) per component. The
    first adapter to touch a weight (and its bias) stores a pristine copy of
    it, on its device, in its dtype (`_lora_base`); every change of the
    active set rebuilds each touched weight in place as ``base + sum_i
    scale_i * delta_i`` in float32, cast back once. Weights no adapter
    touches are never copied or written."""

    def _lora_components(self) -> Dict[str, nn.Module]:
        return {name: getattr(self, name) for name in _LORA_COMPONENT_NAMES
                if isinstance(getattr(self, name, None), nn.Module)}

    def _group_for(self, sd: Dict, name: Optional[str]) -> Dict[str, LoraEntry]:
        unet = getattr(self, "unet", None)
        layers = getattr(getattr(unet, "config", None), "layers_per_block", 2)
        return group_lora_weights(sd, component=name, unet_layers_per_block=layers if isinstance(layers, int) else 2)

    def _grouped_by_component(self, sd: Dict) -> Dict[str, Dict[str, LoraEntry]]:
        components = self._lora_components()
        adapter = {}
        for name in components:
            grouped = self._group_for(sd, name)
            if grouped:
                adapter[name] = grouped
        if not adapter:  # prefix-less checkpoints: everything to the denoiser
            for name in ("transformer", "unet"):
                if name in components:
                    grouped = self._group_for(sd, None)
                    if grouped:
                        adapter[name] = grouped
                    break
        return adapter

    @torch.no_grad()
    def _keep_pristine(self, adapter: Dict[str, Dict[str, LoraEntry]]) -> None:
        """Resolve every path of `adapter` (a quantized layer raises before
        anything is kept) and keep a copy of each weight (and bias, where the
        adapter has a bias delta) not kept yet."""
        components = self._lora_components()
        resolved = {name: _resolve(components[name], grouped)[0] for name, grouped in adapter.items()}
        base = self.__dict__.setdefault("_lora_base", {})
        for name, found in resolved.items():
            kept = base.setdefault(name, {})
            for path, module in found.items():
                if path not in kept:
                    kept[path] = (module, module.weight.detach().clone(), None)
                has_bias = adapter[name][path][3] is not None and module.bias is not None
                if has_bias and kept[path][2] is None:
                    kept[path] = (module, kept[path][1], module.bias.detach().clone())

    @torch.no_grad()
    def _apply_adapters(self, active: Dict[str, float]) -> None:
        """Rebuild every kept weight from its pristine copy with the adapters
        of `active` at their scales."""
        adapters = self.__dict__.get("_lora_adapters", {})
        for comp_name, kept in self.__dict__.get("_lora_base", {}).items():
            selected = [(adapters[n][comp_name], w) for n, w in active.items() if comp_name in adapters[n]]
            deltas, biases = _summed_deltas(getattr(self, comp_name), selected) if selected else ({}, {})
            for path, (module, weight, bias) in kept.items():
                delta = deltas[path][1] if path in deltas else None
                _write_fused(module, weight, delta, bias, biases.get(path))
        self._active_adapters = dict(active)

    def load_lora_weights(self, source, adapter_name: str = "default", scale: float = 1.0):
        """Load a LoRA (a safetensors path or a state dict) as `adapter_name`
        and make it the active set at `scale` (JAX's and the reference's
        semantics: a newly loaded adapter becomes the active set). Keys
        prefixed ``unet.``, ``transformer.``, ``text_encoder.``,
        ``text_encoder_2.`` go to those components; a checkpoint without such
        prefixes goes to the denoiser."""
        adapter = self._grouped_by_component(_load_state_dict(source))
        if not adapter:
            raise ValueError("no LoRA weights matched any pipeline component")
        self._keep_pristine(adapter)
        self.__dict__.setdefault("_lora_adapters", {})[adapter_name] = adapter
        self.set_adapters([adapter_name], [scale])

    def hotswap_lora_weights(self, source, adapter_name: str = "default"):
        """Replace a loaded adapter's weights with a checkpoint that targets
        the same module paths, and rebuild the active set in place (modules,
        shapes and dtypes unchanged). A checkpoint that targets other paths
        raises: load it as a new adapter."""
        adapters = self.__dict__.get("_lora_adapters", {})
        if adapter_name not in adapters:
            raise ValueError(f"hotswap requires adapter '{adapter_name}' to be loaded first; loaded: {list(adapters)}")
        sd = _load_state_dict(source)
        old = adapters[adapter_name]
        adapter = {}
        for name in old:
            grouped = self._group_for(sd, name) or self._group_for(sd, None)
            if set(grouped) != set(old[name]):
                raise ValueError(f"hotswap module-path mismatch for component '{name}': the new checkpoint targets "
                                 f"{len(grouped)} modules, the loaded adapter {len(old[name])}; load it as a new "
                                 "adapter instead")
            adapter[name] = grouped
        self._keep_pristine(adapter)  # a bias delta the old weights lacked
        adapters[adapter_name] = adapter
        self._apply_adapters(self.get_active_adapters() or {adapter_name: 1.0})

    def set_adapters(self, adapter_names, adapter_weights=None):
        """Activate `adapter_names` at `adapter_weights` (one float for all, a
        list, or None for 1.0 each); the others are off."""
        if isinstance(adapter_names, str):
            adapter_names = [adapter_names]
        if adapter_weights is None:
            adapter_weights = [1.0] * len(adapter_names)
        elif not isinstance(adapter_weights, (list, tuple)):
            adapter_weights = [adapter_weights] * len(adapter_names)
        loaded = self.__dict__.get("_lora_adapters", {})
        unknown = [n for n in adapter_names if n not in loaded]
        if unknown:
            raise ValueError(f"unknown adapter(s) {unknown}; loaded: {list(loaded)}")
        self._apply_adapters(dict(zip(adapter_names, adapter_weights)))

    def get_active_adapters(self) -> Dict[str, float]:
        return dict(self.__dict__.get("_active_adapters", {}))

    def disable_lora(self):
        """Restore every touched weight from its pristine copy (bit for bit);
        the adapters stay loaded for `set_adapters`."""
        self._apply_adapters({})

    unfuse_lora = disable_lora  # the reference's name

    def delete_adapters(self, adapter_names):
        """Unload adapters; the remaining active ones are applied again (the
        base where none is), and pristine copies no loaded adapter needs are
        dropped."""
        if isinstance(adapter_names, str):
            adapter_names = [adapter_names]
        loaded = self.__dict__.get("_lora_adapters", {})
        active = self.get_active_adapters()
        for n in adapter_names:
            loaded.pop(n, None)
            active.pop(n, None)
        self._apply_adapters(active)
        for comp_name, kept in self.__dict__.get("_lora_base", {}).items():
            needed = {p for adapter in loaded.values() for p in adapter.get(comp_name, {})}
            for path in [p for p in kept if p not in needed]:
                del kept[path]

"""The port's command line (`diffusers_tpu/commands/diffusers_cli.py`).

    python -m diffusers_tpu_torch.commands.diffusers_cli <command> ...

Commands:
  env              the environment: python, torch and its CUDA, the card's name
                   and count, transformers
  convert          an LDM-layout single file (SD 1.x / SDXL) -> a diffusers
                   folder: the UNet, VAE and CLIP text encoder whose configs a
                   diffusers folder (``--config``) holds, through
                   `loaders.single_file`, with that folder's other files
  fp16_safetensors cast every float tensor of a model or pipeline folder's
                   safetensors to an fp16 or bf16 variant file beside it
  schema           a pipeline folder's model_index.json and component configs
  bench            not ported: the port's benchmark is ROADMAP A1
  custom_blocks    not ported: modular pipelines are ROADMAP A5.3
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import shutil


def env_command(args):
    import torch

    import diffusers_tpu_torch

    info = {
        "diffusers_tpu_torch": diffusers_tpu_torch.__version__,
        "python": platform.python_version(),
        "platform": platform.platform(),
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "device_count": torch.cuda.device_count() if torch.cuda.is_available() else 0,
        "devices": ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
                    if torch.cuda.is_available() else []),
    }
    try:
        import transformers

        info["transformers"] = transformers.__version__
    except Exception:
        pass
    print(json.dumps(info, indent=2))


# the components `convert` writes: (subfolder, class path)
_LDM_COMPONENTS = (
    ("unet", "diffusers_tpu_torch.models.unets.unet_2d_condition.UNet2DConditionModel"),
    ("vae", "diffusers_tpu_torch.models.autoencoders.autoencoder_kl.AutoencoderKL"),
    ("text_encoder", "diffusers_tpu_torch.models.text_encoders.clip.CLIPTextModel"),
)


def convert_command(args):
    """Write the UNet, VAE and CLIP text encoder of an LDM single file as a
    diffusers folder, each built from the config under ``--config`` and
    saved with its `save_pretrained`; the config folder's other entries
    (model_index.json, scheduler, tokenizers) are copied as they are."""
    import importlib

    from ..loaders.single_file import (
        convert_ldm_clip_state_dict,
        convert_ldm_unet_state_dict,
        convert_ldm_vae_state_dict,
        load_single_file_checkpoint,
        model_from_state_dict,
    )

    sd = load_single_file_checkpoint(args.checkpoint)
    print(f"loaded {len(sd)} tensors from {args.checkpoint}")
    os.makedirs(args.output, exist_ok=True)
    written = []
    for name, class_path in _LDM_COMPONENTS:
        config_dir = os.path.join(args.config, name)
        if not os.path.isfile(os.path.join(config_dir, "config.json")):
            continue
        module_name, _, class_name = class_path.rpartition(".")
        cls = getattr(importlib.import_module(module_name), class_name)
        config = dict(cls.load_config(config_dir))
        if name == "unet":
            converted = convert_ldm_unet_state_dict(sd, config)
        else:
            converted = (convert_ldm_vae_state_dict if name == "vae" else convert_ldm_clip_state_dict)(sd)
        if not converted:
            print(f"{name}: no keys in the single file; not written")
            continue
        model = model_from_state_dict(cls, config, converted, device="cpu")
        model.save_pretrained(os.path.join(args.output, name))
        written.append(name)
        print(f"{name}: {len(converted)} tensors written")
    for entry in sorted(os.listdir(args.config)):
        src, dst = os.path.join(args.config, entry), os.path.join(args.output, entry)
        if entry in written or os.path.exists(dst):
            continue
        (shutil.copytree if os.path.isdir(src) else shutil.copyfile)(src, dst)
    print(f"converted {written} into {args.output}")


def fp16_safetensors_command(args):
    """Re-save every `*.safetensors` under a model or pipeline folder as a
    half-precision variant beside it (`<stem>.<variant>.safetensors`),
    float32 / float64 tensors cast, others as they are (JAX's rule)."""
    import torch

    from ..models.modeling_utils import iter_safetensors, save_safetensors

    target = {"fp16": torch.float16, "bf16": torch.bfloat16}[args.variant]
    converted = 0
    for root, _, files in os.walk(args.path):
        for fname in sorted(files):
            if not fname.endswith(".safetensors") or f".{args.variant}." in fname:
                continue
            src = os.path.join(root, fname)
            tensors = {k: t.to(target) if t.dtype in (torch.float32, torch.float64) else t.clone()
                       for k, t in iter_safetensors(src)}
            stem, ext = os.path.splitext(fname)
            dst = os.path.join(root, f"{stem}.{args.variant}{ext}")
            save_safetensors(tensors, dst)
            converted += 1
            print(f"wrote {dst}")
    print(f"converted {converted} file(s) to {args.variant}")


def schema_command(args):
    """A pipeline folder's model_index.json and each component's config.json."""
    schema = {}
    index_path = os.path.join(args.path, "model_index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            schema["model_index"] = json.load(f)
    for entry in sorted(os.listdir(args.path)):
        cfg = os.path.join(args.path, entry, "config.json")
        if os.path.exists(cfg):
            with open(cfg) as f:
                schema[entry] = json.load(f)
    print(json.dumps(schema, indent=2))


def bench_command(args):
    raise NotImplementedError("bench: the port has no benchmark yet (ROADMAP A1); bench.py measures the JAX package")


def custom_blocks_command(args):
    raise NotImplementedError("custom_blocks: the port has no modular pipelines yet (ROADMAP A5.3)")


COMMANDS = {
    "env": env_command,
    "convert": convert_command,
    "fp16_safetensors": fp16_safetensors_command,
    "schema": schema_command,
    "bench": bench_command,
    "custom_blocks": custom_blocks_command,
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("diffusers-tpu-torch-cli")
    sub = parser.add_subparsers(dest="command", required=True)
    sub.add_parser("env", help="print the environment")
    p_convert = sub.add_parser("convert", help="an LDM single file -> a diffusers folder")
    p_convert.add_argument("checkpoint", help="the .safetensors single file")
    p_convert.add_argument("output", help="the diffusers folder to write")
    p_convert.add_argument("--config", required=True,
                           help="a diffusers folder whose unet/, vae/, text_encoder/ hold the configs")
    p_fp16 = sub.add_parser("fp16_safetensors", help="cast saved safetensors to a half-precision variant")
    p_fp16.add_argument("path")
    p_fp16.add_argument("--variant", choices=["fp16", "bf16"], default="fp16")
    p_schema = sub.add_parser("schema", help="dump a pipeline folder's component schema")
    p_schema.add_argument("path")
    sub.add_parser("bench", help="not ported (ROADMAP A1)")
    p_blocks = sub.add_parser("custom_blocks", help="not ported (ROADMAP A5.3)")
    p_blocks.add_argument("name")
    p_blocks.add_argument("--output", default=None)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    COMMANDS[args.command](args)


if __name__ == "__main__":
    main()

"""Text-to-image training of a `UNet2DConditionModel` with the DDPM
epsilon-prediction MSE loss, AdamW, an LR schedule, optional EMA and
safetensors checkpoints: the PyTorch counterpart of
`examples/text_to_image/train_text_to_image_tpu.py`, with the same flags.

It runs on the card by default (``--device cuda``; it raises when no card is
visible) and on the CPU with ``--device cpu``. On the card the parameters stay
f32 and the step runs under ``torch.autocast("cuda", torch.bfloat16)``: bf16
q/k/v reach the flash-attention kernels (K1 forward, K2 and K3 backward,
through `FlashAttentionFunction`), every GroupNorm runs K4, and AdamW updates
the f32 weights. On the CPU everything is f32 and the kernels' plain versions
run.

``--unet tiny`` (the default) is the JAX script's own UNet (`:57-67`);
``--unet sdxl`` is the SDXL base 1.0 UNet at its published widths
(stabilityai/stable-diffusion-xl-base-1.0 `unet/config.json`), fed synthetic
text embeds ``[B, 77, 2048]`` and SDXL's added conditions (pooled embeds
``[B, 1280]`` and the six size/crop ids). Data is synthetic, drawn from
``np.random.RandomState(seed)`` in the JAX script's order (latents, embeds,
noise, timesteps; then the pooled embeds for SDXL).

    python -m diffusers_tpu_torch.training.train_text_to_image --max_train_steps 10
    python -m diffusers_tpu_torch.training.train_text_to_image --device cpu --max_train_steps 3
    python -m diffusers_tpu_torch.training.train_text_to_image --unet sdxl --resolution 1024 \\
        --batch_size 1 --max_train_steps 5 --output_dir /path/to/out

Not ported yet: ``--tensor_parallel`` and the device mesh (they wait for the
parallelism slice, ROADMAP A12), ``--data_dir`` loading, several GPUs.
"""

from __future__ import annotations

import argparse
import os
import statistics
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..models.unets.unet_2d_condition import UNet2DConditionModel
from ..schedulers.scheduling_ddpm import DDPMScheduler
from .ema import EMAModel
from .optimization import get_scheduler, lr_lambda_scheduler
from .train_state import make_train_step

TINY_UNET = dict(
    in_channels=4, out_channels=4,
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"), up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    block_out_channels=(64, 128), layers_per_block=2, attention_head_dim=8, cross_attention_dim=64,
)
SDXL_UNET = dict(
    in_channels=4, out_channels=4,
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
    block_out_channels=(320, 640, 1280), layers_per_block=2, transformer_layers_per_block=(1, 2, 10),
    attention_head_dim=(5, 10, 20), cross_attention_dim=2048, use_linear_projection=True,
    addition_embed_type="text_time", addition_time_embed_dim=256, projection_class_embeddings_input_dim=2816,
)
UNETS = {"tiny": TINY_UNET, "sdxl": SDXL_UNET}
TEXT_SHAPES = {"tiny": (8, 64), "sdxl": (77, 2048)}  # (tokens, width) of the synthetic text embeds
SDXL_POOLED = 1280


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--max_train_steps", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--lr_scheduler", type=str, default="cosine")
    p.add_argument("--lr_warmup_steps", type=int, default=10)
    p.add_argument("--resolution", type=int, default=32)
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--output_dir", type=str, default=os.path.join(tempfile.gettempdir(), "t2i-torch"))
    p.add_argument("--checkpointing_steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--unet", choices=tuple(UNETS), default="tiny")
    return p.parse_args(argv)


def resolve_device(device: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_text_to_image: no CUDA device is visible; pass --device cpu to train on the CPU")
    return device


def build_unet(name: str, resolution: int, seed: int, device: torch.device) -> UNet2DConditionModel:
    """The UNet in f32 on `device`, random weights from `seed`."""
    torch.manual_seed(seed)
    with torch.device(device):
        return UNet2DConditionModel(sample_size=resolution // 8, **UNETS[name])


def synthetic_batch(rng: np.random.RandomState, name: str, batch_size: int, resolution: int) -> Dict[str, Any]:
    """One batch of numpy arrays, drawn in the JAX script's order."""
    tokens, width = TEXT_SHAPES[name]
    latent = (batch_size, 4, resolution // 8, resolution // 8)
    batch = {
        "latents": rng.randn(*latent).astype(np.float32),
        "embeds": rng.randn(batch_size, tokens, width).astype(np.float32),
        "noise": rng.randn(*latent).astype(np.float32),
        "timesteps": rng.randint(0, 1000, (batch_size,)).astype(np.int64),
    }
    if name == "sdxl":
        batch["text_embeds"] = rng.randn(batch_size, SDXL_POOLED).astype(np.float32)
        # original size, crop top-left, target size
        batch["time_ids"] = np.array([[resolution, resolution, 0, 0, resolution, resolution]] * batch_size, np.float32)
    return batch


def make_loss_fn(noise_scheduler: DDPMScheduler, sched_state) -> Callable:
    """DDPM epsilon-prediction MSE; the UNet runs under bf16 autocast on the
    card and in f32 on the CPU."""

    def loss_fn(unet: UNet2DConditionModel, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        latents, noise, timesteps = batch["latents"], batch["noise"], batch["timesteps"]
        noisy = noise_scheduler.add_noise(sched_state, latents, noise, timesteps)
        added = {k: batch[k] for k in ("text_embeds", "time_ids") if k in batch} or None
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=latents.is_cuda):
            pred = unet(noisy, timesteps, encoder_hidden_states=batch["embeds"], added_cond_kwargs=added).sample
        return torch.mean(torch.square(pred.float() - noise.float()))

    return loss_fn


def train(args, callback: Optional[Callable] = None) -> Dict[str, Any]:
    """Run `args.max_train_steps` steps. `callback(step, unet, loss)` runs
    after each step, with the step's grads still on the parameters. Returns
    the losses, the step times (CUDA events on the card, host clock on the
    CPU) and the peak device memory."""
    device = resolve_device(args.device)
    unet = build_unet(args.unet, args.resolution, args.seed, device)
    unet.train()
    n_params = sum(p.numel() for p in unet.parameters())
    print(f"unet {args.unet}: {n_params / 1e6:.1f} M parameters on {device}")

    noise_scheduler = DDPMScheduler()
    sched_state = noise_scheduler.set_timesteps()
    optimizer = torch.optim.AdamW(unet.parameters(), lr=args.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=1e-2)
    schedule = get_scheduler(args.lr_scheduler, args.learning_rate, args.lr_warmup_steps, args.max_train_steps)
    lr_scheduler = lr_lambda_scheduler(optimizer, schedule)
    ema = EMAModel(unet.parameters(), decay=0.9999) if args.use_ema else None
    train_step = make_train_step(make_loss_fn(noise_scheduler, sched_state), optimizer, lr_scheduler)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rng = np.random.RandomState(args.seed)
    losses, step_ms = [], []
    t0 = time.time()
    for step in range(args.max_train_steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in
                 synthetic_batch(rng, args.unet, args.batch_size, args.resolution).items()}
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            loss = train_step(unet, batch)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
        else:
            t_step = time.perf_counter()
            loss = train_step(unet, batch)
            step_ms.append((time.perf_counter() - t_step) * 1e3)
        losses.append(float(loss))
        if ema is not None:
            ema.step(unet.parameters())
        if callback is not None:
            callback(step, unet, loss)
        if step % 10 == 0:
            print(f"step {step}: loss {losses[-1]:.4f} ({(time.time() - t0) / (step + 1):.3f}s/step)")
        if (step + 1) % args.checkpointing_steps == 0:
            unet.save_pretrained(os.path.join(args.output_dir, f"checkpoint-{step + 1}"))
            print(f"saved checkpoint-{step + 1}")

    if ema is not None:
        ema.copy_to(unet.parameters())
    unet.save_pretrained(os.path.join(args.output_dir, "unet"))
    print(f"done; saved to {args.output_dir}/unet")
    peak = torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None
    return {"losses": losses, "step_ms": step_ms, "parameters": n_params, "peak_memory_gb": peak,
            "median_step_ms": statistics.median(step_ms[1:]) if len(step_ms) > 1 else None}


def main(argv=None, callback: Optional[Callable] = None):
    return train(parse_args(argv), callback=callback)


if __name__ == "__main__":
    main()

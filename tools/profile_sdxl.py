"""Where the port's main paths (SDXL, Flux.1-dev, SDXL-UNet training) spend
device time, on one CUDA card.

    python3 tools/profile_sdxl.py [--model sdxl|flux|train] [--out DIR]

Builds the full-width pipeline of `chip_smoke.py` (random weights from a
seed, made on the card: SDXL bf16; Flux.1-dev with the w8a8 transformer),
warms it up with one 1024 px request, then:

  * times one denoiser forward (the SDXL UNet at b=2, one CFG step; the Flux
    transformer at the request's shapes) with CUDA events, profiler off (mean
    of 10, or 3 for Flux);
  * traces one such forward with `torch.profiler` (CPU + CUDA activities)
    and sums device time by kernel group;
  * times one request (SDXL: 30 steps, CFG 5.0; Flux: 28 steps, guidance
    3.5) on the host clock, profiler off, then traces one.

With `--model train` it builds the SDXL UNet of `train_text_to_image` (f32
weights, AdamW, bf16 autocast), runs two warm-up steps on one synthetic
1024 px batch of 1, times the forward (loss), the backward and the optimizer
step of three steps with CUDA events, profiler off, then traces one step.

Device idle share of a forward = 1 - (union of its device intervals) / (its
unprofiled CUDA-event time): the profiler slows the host, not the kernels.
Prints one table per trace; with `--out DIR` also writes
`DIR/profile_<model>.json`. Exits non-zero when no CUDA device is visible or
when the trace holds no device activity.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (the repository root is on the path from here)

# kernel-name substrings per group, checked in order (cuDNN's implicit-GEMM
# convolutions carry "gemm" in their names, so convolutions come first)
GROUPS = (
    ("K5 w8a8_matmul", ("w8a8_gemm_kernel",)),
    ("K5 quantize_rows", ("quantize_rows_kernel",)),
    ("K1 flash_attention_fwd", ("flash_fwd_kernel",)),
    ("K2 flash_attention_bwd_dkdv", ("flash_bwd_dkdv_kernel", "flash_bwd_dkdv_reduce_kernel")),
    ("K3 flash_attention_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("optimizer (multi_tensor_apply)", ("multi_tensor_apply",)),
    ("K4 group_norm", ("group_norm_kernel",)),
    ("convolution (cuDNN)", ("cudnn", "conv", "fprop", "nchwToNhwc", "nhwcToNchw")),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "cublas", "cutlass")),
)
OTHER = "elementwise/other"


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(key in name for key in keys):
            return group
    return OTHER


def device_summary(prof, wall_ms: float) -> dict:
    """Device activity of a trace: count, summed and merged time, by group,
    and the ten costliest kernels; idle share against `wall_ms`."""
    import torch

    # device kernels and copies; user annotations mirrored on the device timeline
    # (`Optimizer.step#AdamW.step`) span other activities and are left out
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    if not events:
        raise RuntimeError("the trace holds no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, cur_start, cur_end = 0.0, *spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy_us += cur_end - cur_start
    by_group, by_name = {}, {}
    for e in events:
        us = e.time_range.end - e.time_range.start
        by_group[group_of(e.name)] = by_group.get(group_of(e.name), 0.0) + us / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3
    busy_ms = busy_us / 1e3
    return {
        "device_activities": len(events),
        "device_ms_sum": sum(by_group.values()),
        "busy_ms": busy_ms,
        "wall_ms_unprofiled": wall_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "by_group_ms": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
        "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
    }


def print_summary(title: str, s: dict) -> None:
    chip_smoke.log(f"[profile] {title}: {s['device_activities']} device activities, {s['device_ms_sum']:.2f} ms "
                   f"summed, {s['busy_ms']:.2f} ms busy (merged) of {s['wall_ms_unprofiled']:.2f} ms unprofiled: "
                   f"device idle {100 * s['idle_share']:.1f}%")
    chip_smoke.log("| group | ms | share of device time |\n|---|---|---|")
    for group, ms in s["by_group_ms"].items():
        chip_smoke.log(f"| {group} | {ms:.2f} | {100 * ms / s['device_ms_sum']:.1f}% |")
    for name, ms in s["top"]:
        chip_smoke.log(f"[profile]   {ms:9.2f} ms  {name[:110]}")


def _sdxl(torch):
    """The SDXL pipeline, its request, and one UNet forward at b=2."""
    pipe = chip_smoke._build_pipeline(chip_smoke.SDXL_UNET, chip_smoke.SDXL_VAE, chip_smoke.CLIP_L,
                                      chip_smoke.CLIP_BIGG, "cuda", torch.bfloat16)
    request = dict(prompt=chip_smoke.PROMPTS[0], height=chip_smoke.RESOLUTION, width=chip_smoke.RESOLUTION,
                   num_inference_steps=chip_smoke.STEPS, guidance_scale=chip_smoke.GUIDANCE, output_type="np")
    dev = torch.device("cuda")
    sample = torch.randn(2, 4, 128, 128, device=dev, dtype=torch.bfloat16)
    ehs = torch.randn(2, 77, 2048, device=dev, dtype=torch.bfloat16)
    cond = {"text_embeds": torch.randn(2, 1280, device=dev, dtype=torch.bfloat16),
            "time_ids": torch.tensor([[1024, 1024, 0, 0, 1024, 1024]] * 2, device=dev, dtype=torch.float32)}
    t = torch.tensor(500.0, device=dev)
    return pipe, request, lambda: pipe.unet(sample, t, ehs, added_cond_kwargs=cond), "UNet forward b=2", 10


def _flux(torch):
    """The Flux.1-dev pipeline (w8a8 transformer), its request, and one
    transformer forward with the arguments of the request's last step."""
    pipe = chip_smoke._build_flux_pipeline(chip_smoke.FLUX_DEV, chip_smoke.W8A8_MIN_WEIGHT_SIZE,
                                           chip_smoke.FLUX_VAE, chip_smoke.CLIP_L, chip_smoke.T5_XXL, "cuda",
                                           torch.bfloat16)
    request = dict(prompt=chip_smoke.FLUX_PROMPT, height=chip_smoke.RESOLUTION, width=chip_smoke.RESOLUTION,
                   num_inference_steps=chip_smoke.FLUX_STEPS, guidance_scale=chip_smoke.FLUX_GUIDANCE,
                   max_sequence_length=chip_smoke.FLUX_MAX_SEQUENCE_LENGTH, output_type="np")
    seen = {}
    hook = pipe.transformer.register_forward_pre_hook(
        lambda mod, args, kwargs: seen.update(args=args, kwargs=kwargs), with_kwargs=True)
    pipe(**dict(request, num_inference_steps=1), generator=torch.Generator(device="cuda").manual_seed(0))
    hook.remove()
    return (pipe, request, lambda: pipe.transformer(*seen["args"], **seen["kwargs"]),
            "Flux transformer forward (4096 image + 512 text tokens, w8a8)", 3)


def profile_train(torch, smi: str, out) -> int:
    """One SDXL-UNet train step at 1024 px, batch 1: phase times and a trace."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from diffusers_tpu_torch.schedulers import DDPMScheduler
    from diffusers_tpu_torch.training import train_text_to_image as t2i

    dev = torch.device("cuda")
    unet = t2i.build_unet("sdxl", chip_smoke.RESOLUTION, chip_smoke.SEED, dev)
    unet.train()
    scheduler = DDPMScheduler()
    loss_fn = t2i.make_loss_fn(scheduler, scheduler.set_timesteps())
    optimizer = torch.optim.AdamW(unet.parameters(), lr=1e-5, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             t2i.synthetic_batch(np.random.RandomState(chip_smoke.SEED), "sdxl", 1, chip_smoke.RESOLUTION).items()}

    def step(marks=None):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(unet, batch)
        if marks is not None:
            marks[1].record()
        loss.backward()
        if marks is not None:
            marks[2].record()
        optimizer.step()

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    phases = {"forward_ms": [], "backward_ms": [], "optimizer_ms": [], "step_ms": []}
    for _ in range(3):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        marks[0].record()
        step(marks)
        marks[3].record()
        torch.cuda.synchronize()
        for key, (a, b) in zip(phases, ((0, 1), (1, 2), (2, 3), (0, 3))):
            phases[key].append(marks[a].elapsed_time(marks[b]))
    means = {k: sum(v) / len(v) for k, v in phases.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    summary = device_summary(prof, means["step_ms"])
    chip_smoke.log(f"[profile] {smi}")
    chip_smoke.log(f"[profile] SDXL-UNet train step, 1024 px, batch 1 (mean of 3, CUDA events): forward + loss "
                   f"{means['forward_ms']:.1f} ms, backward {means['backward_ms']:.1f} ms, AdamW "
                   f"{means['optimizer_ms']:.1f} ms, step {means['step_ms']:.1f} ms")
    print_summary("one SDXL-UNet train step (f32 weights, bf16 autocast, AdamW)", summary)
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        (out / "profile_train.json").write_text(json.dumps(
            {"card": smi, "model": "train", "phases_ms": phases, "step": summary}, indent=2))
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", choices=("sdxl", "flux", "train"), default="sdxl")
    parser.add_argument("--out", type=Path, default=None, help="directory for profile_<model>.json")
    args = parser.parse_args()
    smi = chip_smoke.setup()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if args.model == "train":
        return profile_train(torch, smi, args.out)

    pipe, request, forward, forward_title, forward_iters = (_flux if args.model == "flux" else _sdxl)(torch)

    def run_request():
        pipe(**request, generator=torch.Generator(device="cuda").manual_seed(chip_smoke.SEED))
        torch.cuda.synchronize()

    run_request()  # warm-up: cuDNN/cuBLAS heuristics, Triton compile, kernel build

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.no_grad():
        forward_ms = chip_smoke.time_ms(forward, iters=forward_iters)
        with profile(activities=activities) as prof:
            forward()
            torch.cuda.synchronize()
    forward_summary = device_summary(prof, forward_ms)

    t0 = time.perf_counter()
    run_request()
    request_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=activities) as prof:
        run_request()
    request_summary = device_summary(prof, request_ms)

    chip_smoke.log(f"[profile] {smi}")
    print_summary(f"{forward_title}, 1024 px, bf16", forward_summary)
    print_summary(f"one request ({request['num_inference_steps']} steps, guidance {request['guidance_scale']}, "
                  f"1024 px)", request_summary)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / f"profile_{args.model}.json").write_text(json.dumps(
            {"card": smi, "model": args.model, "forward": forward_summary, "request": request_summary}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())

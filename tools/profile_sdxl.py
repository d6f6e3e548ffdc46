"""Where the port's main paths (SDXL, Flux.1-dev, SD3.5 Medium, Wan 2.1
text-to-video and image-to-video, SDXL-UNet training) spend device time, on
one CUDA card.

    python3 tools/profile_sdxl.py [--model sdxl|flux|sd3|wan|wan_i2v|train] [--out DIR]

Builds the full-width pipeline of `chip_smoke.py` (random weights from a
seed, made on the card: SDXL, SD3.5 Medium, Wan2.1-T2V-1.3B and
Wan2.1-I2V-14B-480P bf16; Flux.1-dev with the w8a8 transformer), warms it
up with one request (Wan: of 2 steps; Wan I2V: of 1), then:

  * times one denoiser forward (the SDXL UNet at b=2, one CFG step; the Flux,
    SD3 and Wan transformers at the request's shapes: Wan's is one batch-1
    call over 32,760 tokens, the 14B's with the 257 CLIP tokens too) with
    CUDA events, profiler off (mean of 10, or 3 for Flux and Wan);
  * traces one such forward with `torch.profiler` (CPU + CUDA activities)
    and sums device time by kernel group;
  * times one request (SDXL: 30 steps, CFG 5.0; Flux: 28 steps, guidance
    3.5; SD3.5 Medium: 28 steps, CFG 7.0, the server's defaults; Wan: 480 x
    832, 81 frames, 50 steps, CFG 5.0; Wan I2V: the same frames from an
    image, `chip_smoke.WAN_I2V_STEPS` steps) on the host clock, profiler off,
    then traces one; for SDXL, the same again for the
    headline request of bench.py, with the TaylorSeer cache of
    `chip_smoke.sdxl_cached_requests` (5 of 30 steps call the UNet); for
    SD3.5 Medium, the same again for a request of two prompts, the batch
    the server makes of two coalesced requests.

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


def _sd3(torch):
    """The SD3.5 Medium pipeline, its request (the server's defaults), and one
    transformer forward at b=2 with the arguments of the request's last step."""
    pipe = chip_smoke._build_sd3_pipeline(chip_smoke.SD35_MEDIUM, chip_smoke.SD3_VAE, chip_smoke.CLIP_L,
                                          chip_smoke.CLIP_BIGG, chip_smoke.T5_XXL, "cuda", torch.bfloat16)
    request = dict(prompt=chip_smoke.SD3_PROMPTS[0], height=chip_smoke.RESOLUTION, width=chip_smoke.RESOLUTION,
                   num_inference_steps=chip_smoke.SD3_STEPS, guidance_scale=chip_smoke.SD3_GUIDANCE, output_type="np")
    seen = {}
    hook = pipe.transformer.register_forward_pre_hook(
        lambda mod, args, kwargs: seen.update(args=args, kwargs=kwargs), with_kwargs=True)
    pipe(**dict(request, num_inference_steps=1), generator=torch.Generator(device="cuda").manual_seed(0))
    hook.remove()
    return (pipe, request, lambda: pipe.transformer(*seen["args"], **seen["kwargs"]),
            "SD3.5 Medium transformer forward b=2 (4096 image + 333 text tokens)", 10)


def _wan(torch):
    """The Wan2.1-T2V-1.3B pipeline, its request, and one transformer call
    (batch 1, the cond branch) with the arguments of the request's last call."""
    pipe = chip_smoke._build_wan_pipeline(chip_smoke.WAN_1_3B, chip_smoke.WAN_VAE, chip_smoke.UMT5_XXL, "cuda",
                                          torch.bfloat16)
    request = dict(prompt=chip_smoke.WAN_PROMPT, negative_prompt=chip_smoke.WAN_NEGATIVE,
                   height=chip_smoke.WAN_HEIGHT, width=chip_smoke.WAN_WIDTH, num_frames=chip_smoke.WAN_FRAMES,
                   num_inference_steps=chip_smoke.WAN_STEPS, guidance_scale=chip_smoke.WAN_GUIDANCE,
                   max_sequence_length=chip_smoke.WAN_TEXT_LEN, output_type="np")
    seen = {}
    hook = pipe.transformer.register_forward_pre_hook(
        lambda mod, args, kwargs: seen.update(args=args, kwargs=kwargs), with_kwargs=True)
    pipe(**dict(request, num_inference_steps=1), generator=torch.Generator(device="cuda").manual_seed(0))
    hook.remove()
    return (pipe, request, lambda: pipe.transformer(*seen["args"], **seen["kwargs"]),
            "Wan transformer forward b=1 (32,760 tokens, 512 text tokens)", 3)


def _wan_i2v(torch):
    """Wan2.1-I2V-14B-480P as `chip_smoke.py` phase 19 builds it (the 14B on
    the meta device, filled on the card; CLIP ViT-H/14; UMT5-XXL and the
    VAE), its request from a synthetic image, and one transformer call."""
    import numpy as np

    base = chip_smoke._build_wan_pipeline(chip_smoke.WAN_1_3B, chip_smoke.WAN_VAE, chip_smoke.UMT5_XXL, "cuda",
                                          torch.bfloat16)
    base.transformer = None
    pipe = chip_smoke._build_wan_i2v_pipeline(base, chip_smoke.WAN_I2V_14B, chip_smoke.CLIP_VIT_H)
    image = np.round(255 * chip_smoke.synthetic_video(1, chip_smoke.WAN_HEIGHT, chip_smoke.WAN_WIDTH)[0])
    request = dict(image=image.astype(np.uint8), prompt=chip_smoke.WAN_PROMPT,
                   negative_prompt=chip_smoke.WAN_NEGATIVE, height=chip_smoke.WAN_HEIGHT,
                   width=chip_smoke.WAN_WIDTH, num_frames=chip_smoke.WAN_FRAMES,
                   num_inference_steps=chip_smoke.WAN_I2V_STEPS, guidance_scale=chip_smoke.WAN_GUIDANCE,
                   max_sequence_length=chip_smoke.WAN_TEXT_LEN, output_type="np")
    seen = {}
    hook = pipe.transformer.register_forward_pre_hook(
        lambda mod, args, kwargs: seen.update(args=args, kwargs=kwargs), with_kwargs=True)
    pipe(**dict(request, num_inference_steps=1), generator=torch.Generator(device="cuda").manual_seed(0))
    hook.remove()
    return (pipe, request, lambda: pipe.transformer(*seen["args"], **seen["kwargs"]),
            "Wan2.1-I2V-14B transformer forward b=1 (32,760 tokens, 512 text + 257 CLIP tokens)", 3)


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
    parser.add_argument("--model", choices=("sdxl", "flux", "sd3", "wan", "wan_i2v", "train"), default="sdxl")
    parser.add_argument("--out", type=Path, default=None, help="directory for profile_<model>.json")
    args = parser.parse_args()
    smi = chip_smoke.setup()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if args.model == "train":
        return profile_train(torch, smi, args.out)

    build = {"sdxl": _sdxl, "flux": _flux, "sd3": _sd3, "wan": _wan, "wan_i2v": _wan_i2v}[args.model]
    pipe, request, forward, forward_title, forward_iters = build(torch)

    def run_request(**overrides):
        pipe(**dict(request, **overrides), generator=torch.Generator(device="cuda").manual_seed(chip_smoke.SEED))
        torch.cuda.synchronize()

    # warm-up: cuDNN/cuBLAS heuristics, kernel build (a Wan request of 2 steps runs every shape of one of 50;
    # `_wan_i2v` already ran one of 1)
    if args.model != "wan_i2v":
        run_request(**({"num_inference_steps": 2} if args.model == "wan" else {}))

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

    summaries = {"forward": forward_summary, "request": request_summary}
    if args.model == "sdxl":
        _, config, _ = chip_smoke.sdxl_cached_requests()[0]
        pipe.enable_cache(config)
        run_request()  # warm-up
        t0 = time.perf_counter()
        run_request()
        cached_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=activities) as prof:
            run_request()
        summaries["request_taylorseer"] = device_summary(prof, cached_ms)
    if args.model == "sd3":
        pair = dict(prompt=list(chip_smoke.SD3_PROMPTS[1:]))
        run_request(**pair)  # warm-up at batch 2
        t0 = time.perf_counter()
        run_request(**pair)
        pair_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=activities) as prof:
            run_request(**pair)
        summaries["request_pair"] = device_summary(prof, pair_ms)

    size = f"{request['height']} x {request['width']} px" + (f", {request['num_frames']} frames"
                                                            if "num_frames" in request else "")
    chip_smoke.log(f"[profile] {smi}")
    print_summary(f"{forward_title}, {size}, bf16", forward_summary)
    print_summary(f"one request ({request['num_inference_steps']} steps, guidance {request['guidance_scale']}, "
                  f"{size})", request_summary)
    if "request_taylorseer" in summaries:
        print_summary("one request with TaylorSeer (cache_interval 10, disable_cache_before_step 2, max_order 2)",
                      summaries["request_taylorseer"])
    if "request_pair" in summaries:
        print_summary("one request of two prompts (the server's coalesced batch; transformer at b=4)",
                      summaries["request_pair"])
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / f"profile_{args.model}.json").write_text(json.dumps(
            {"card": smi, "model": args.model, **summaries}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())

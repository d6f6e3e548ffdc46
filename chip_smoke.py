"""Smoke run of the PyTorch + CUDA port (`diffusers_tpu_torch`) on one NVIDIA
H100: builds the port's hand-written kernels from this checkout, holds each
against its plain PyTorch version at the shapes of the main paths, checks the
port on the card against the port on the CPU at a small size, then drives the
three main paths through their public entry points, with random weights made
from a seed on the card:

  * SDXL: one full-width 1024 px text-to-image request (30 Euler steps, CFG
    5.0, bf16) through `StableDiffusionXLPipeline.__call__` (kernels K1, K4);
  * Flux.1-dev: one full-width 1024 px request (28 flow-match steps, guidance
    3.5; the transformer w8a8, T5-XXL, CLIP-L and the VAE bf16) through
    `FluxPipeline.__call__` (kernels K5 with its row quantization, K1 at
    head_dim 128, K4);
  * training: `train_text_to_image.main` on the SDXL UNet at its published
    widths, 1024 px, batch 1, TRAIN_STEPS steps (f32 weights and AdamW, bf16
    autocast; kernels K1 forward, K2 and K3 backward, K4), then a sharded
    safetensors checkpoint,

and shows, from launch counts reset just before each path (each training
step) and read just after, that each path ran through its kernels.

    python3 chip_smoke.py [--out DIR]

Exits non-zero, printing no result, when no CUDA device is visible or when it
is not next to the `diffusers_tpu_torch` package. With `--out DIR`, detailed
results also go to `DIR/chip_smoke.json`. The last three lines of standard
output are the per-kernel JSON summary, the card's `nvidia-smi` name and
power limit, then
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Precision: the pipelines run in bf16, the training step under bf16 autocast
with f32 weights. float32 references run in full float32: this script sets
`torch.backends.cuda.matmul.allow_tf32 = False` and
`torch.backends.cudnn.allow_tf32 = False`.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
STEPS = 30
GUIDANCE = 5.0
RESOLUTION = 1024
PROMPTS = ("a photo of an astronaut riding a horse on mars", "a watercolor painting of a lighthouse at dawn")
FLUX_STEPS = 28
FLUX_GUIDANCE = 3.5
FLUX_PROMPT = "a cinematic photo of a mountain lake at dawn"

# H100 SXM dense peaks (NVIDIA data sheet) for the `bound_ms` of each kernel
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

# stabilityai/stable-diffusion-xl-base-1.0 component configs (the widths of bench.py:42-130)
SDXL_UNET = dict(
    sample_size=128, in_channels=4, out_channels=4,
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
    block_out_channels=(320, 640, 1280), layers_per_block=2, transformer_layers_per_block=(1, 2, 10),
    attention_head_dim=(5, 10, 20), cross_attention_dim=2048, use_linear_projection=True,
    addition_embed_type="text_time", addition_time_embed_dim=256, projection_class_embeddings_input_dim=2816,
)
SDXL_VAE = dict(
    in_channels=3, out_channels=3, down_block_types=("DownEncoderBlock2D",) * 4,
    up_block_types=("UpDecoderBlock2D",) * 4, block_out_channels=(128, 256, 512, 512),
    latent_channels=4, layers_per_block=2, sample_size=1024, scaling_factor=0.13025,
)
CLIP_L = dict(vocab_size=49408, hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
              num_attention_heads=12, projection_dim=768)
CLIP_BIGG = dict(vocab_size=49408, hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
                 num_attention_heads=20, projection_dim=1280, hidden_act="gelu")
EULER = dict(beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear",
             timestep_spacing="leading", steps_offset=1)

# black-forest-labs/FLUX.1-dev component configs (the widths of bench.py:175-296): the transformer
# (19 dual + 38 single blocks, 24 x 128 heads; w8a8 on every 2-D Linear of >= 2^20 elements),
# T5-XXL (bench.py:244-247), CLIP-L, the 16-channel VAE of its vae/config.json (no quant convs)
FLUX_DEV = dict(guidance_embeds=True)  # FluxTransformer2DModel's defaults are Flux.1-dev's widths
W8A8_MIN_WEIGHT_SIZE = 2**20
T5_XXL = dict(vocab_size=32128, d_model=4096, d_kv=64, d_ff=10240, num_layers=24, num_heads=64,
              feed_forward_proj="gated-gelu")
FLUX_VAE = dict(
    in_channels=3, out_channels=3, down_block_types=("DownEncoderBlock2D",) * 4,
    up_block_types=("UpDecoderBlock2D",) * 4, block_out_channels=(128, 256, 512, 512), latent_channels=16,
    layers_per_block=2, sample_size=1024, scaling_factor=0.3611, shift_factor=0.1159, use_quant_conv=False,
    use_post_quant_conv=False,
)
FLOW_MATCH = dict(use_dynamic_shifting=True, base_shift=0.5, max_shift=1.15, shift=3.0)
FLUX_MAX_SEQUENCE_LENGTH = 512

# w8a8 (M, K, N, launches per denoise step) of Flux.1-dev at 1024 px, batch 1: M = 4096 image
# tokens, 512 text tokens, 4608 joint tokens, 1 for the AdaLN / embedder linears
FLUX_W8A8_SHAPES = (
    (1, 3072, 18432, 38),    # norm1 / norm1_context linears, 19 dual blocks
    (4096, 3072, 3072, 76),  # to_q, to_k, to_v, to_out
    (512, 3072, 3072, 76),   # add_q/k/v_proj, to_add_out
    (4096, 3072, 12288, 19),  # ff.net.0
    (4096, 12288, 3072, 19),  # ff.net.2
    (512, 3072, 12288, 19),  # ff_context.net.0
    (512, 12288, 3072, 19),  # ff_context.net.2
    (1, 3072, 9216, 38),     # single-block norm linears
    (4608, 3072, 3072, 114),  # single-block to_q, to_k, to_v
    (4608, 3072, 12288, 38),  # proj_mlp
    (4608, 15360, 3072, 38),  # proj_out
    (512, 4096, 3072, 1),    # context_embedder
    (1, 3072, 3072, 3),      # timestep / guidance embedder linear_2, text embedder linear_2
    (1, 768, 3072, 1),       # text embedder linear_1
    (1, 3072, 6144, 1),      # norm_out linear
)
FLUX_W8A8_PER_STEP = 19 * 14 + 38 * 6 + 6  # = 500, as the table above sums
FLUX_ATTENTIONS_PER_STEP = 19 + 38
# (M, N) at which the card tests hold K5 to its plain version: ragged M (TMA's
# zero-filled rows), and between them every tile `pick_tile` can return
W8A8_TILE_CASES = ((1, 512), (17, 512), (77, 512), (4097, 512), (4097, 3072))

# the attention shapes of one SDXL UNet train step at 1024 px, batch 1 (label, q shape, kv length,
# options, launches per step): 10 transformer blocks at 64 x 64 latents (4096 tokens, 10 heads),
# 60 at 32 x 32 (1024 tokens, 20 heads), each with a self and a 77-token cross attention
SDXL_TRAIN_ATTENTION = (
    ("self 4096 (UNet level 2)", (1, 4096, 10, 64), 4096, {}, 10),
    ("cross 4096 x 77 (UNet level 2)", (1, 4096, 10, 64), 77, {}, 10),
    ("self 1024 (UNet level 3)", (1, 1024, 20, 64), 1024, {}, 60),
    ("cross 1024 x 77 (UNet level 3)", (1, 1024, 20, 64), 77, {}, 60),
)
SDXL_TRAIN_ATTENTIONS_PER_STEP = 140
BWD_EXTRA_CASES = (
    ("Flux joint 4608 d=128", (1, 4608, 24, 128), 4608, {"timed": True}, 0),
    ("causal 1000 (ragged)", (1, 1000, 4, 64), 1000, {"is_causal": True}, 0),
    ("additive mask 300 x 333, d=128", (2, 300, 2, 128), 333, {"mask": True}, 0),
    # a float mask of -inf or finfo.min over the first 160 keys of every other row: a whole 128-key
    # kv tile hidden, which must give finite grads
    ("mask -inf over the first 160 keys of every other row", (2, 300, 2, 64), 333, {"mask": "-inf"}, 0),
    ("mask finfo.min over the first 160 keys of every other row, d=128, fp16", (2, 300, 2, 128), 333,
     {"mask": "finfo.min", "dtype": "fp16"}, 0),
)
# (b, sq, sk, h, d, causal, mask, dtype) at which the card tests hold K2/K3 to their plain version;
# between them both K2 paths (`pick_split` > 1 and == 1) on an H100 SXM or PCIe
FLASH_BWD_CARD_CASES = (
    (1, 1024, 1024, 4, 64, False, False, "bf16"),
    (2, 512, 77, 4, 64, False, False, "bf16"),  # SDXL's ragged cross attention
    (1, 300, 300, 2, 64, True, False, "bf16"),
    (1, 130, 300, 2, 64, True, False, "bf16"),  # causal, Sq < Sk: top-left aligned
    (2, 300, 130, 2, 128, True, True, "bf16"),  # causal + mask, Sq > Sk
    (1, 200, 333, 2, 128, False, True, "bf16"),
    (1, 500, 700, 3, 128, False, False, "fp16"),
    (3, 1, 5, 1, 64, False, False, "fp16"),
    (1, 4096, 77, 10, 64, False, False, "bf16"),  # the train step's cross attentions (split)
    (1, 1024, 77, 20, 64, False, False, "bf16"),
    (1, 1024, 1024, 20, 64, False, False, "bf16"),  # the train step's level-3 self attention (not split)
    (2, 300, 333, 2, 64, False, "-inf", "bf16"),  # a hidden first kv tile
    (2, 300, 333, 2, 128, False, "finfo.min", "fp16"),
)
TRAIN_STEPS = 5

# small SDXL-shaped pipeline for the card-vs-CPU check: head_dim 64 so the
# UNet and the VAE mid-block attention both take the flash kernel on the card
SMALL_UNET = dict(
    sample_size=16, in_channels=4, out_channels=4,
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"), up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
    block_out_channels=(64, 128), layers_per_block=1, attention_head_dim=(1, 2), transformer_layers_per_block=(1, 2),
    use_linear_projection=True, cross_attention_dim=64, addition_embed_type="text_time", addition_time_embed_dim=8,
    projection_class_embeddings_input_dim=32 + 6 * 8,
)
SMALL_VAE = dict(block_out_channels=(32, 64), down_block_types=("DownEncoderBlock2D",) * 2,
                 up_block_types=("UpDecoderBlock2D",) * 2, latent_channels=4, layers_per_block=1, sample_size=32)
SMALL_CLIP = dict(vocab_size=49408, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                  num_attention_heads=2, projection_dim=32)
# small Flux-shaped pipeline for the card-vs-CPU check: head_dim 128 (K1), every transformer
# Linear of >= 2^15 elements w8a8 (all 128-aligned: K5), GroupNorms in the VAE (K4)
SMALL_FLUX = dict(in_channels=64, num_layers=1, num_single_layers=2, attention_head_dim=128, num_attention_heads=2,
                  joint_attention_dim=256, pooled_projection_dim=128, guidance_embeds=True)
SMALL_FLUX_MIN_WEIGHT_SIZE = 2**15
SMALL_FLUX_CLIP = dict(vocab_size=49408, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                       num_attention_heads=2, projection_dim=128)
SMALL_T5 = dict(vocab_size=32128, d_model=256, d_kv=64, d_ff=512, num_layers=2, num_heads=4,
                feed_forward_proj="gated-gelu")
SMALL_FLUX_VAE = dict(block_out_channels=(32, 64), down_block_types=("DownEncoderBlock2D",) * 2,
                      up_block_types=("UpDecoderBlock2D",) * 2, latent_channels=16, layers_per_block=1,
                      sample_size=64, scaling_factor=0.3611, shift_factor=0.1159, use_quant_conv=False,
                      use_post_quant_conv=False)

RESULTS = {}


def log(msg: str) -> None:
    print(msg, flush=True)


class StandInTokenizer:
    """Deterministic stand-in for the CLIP and T5 tokenizers (no vocabulary
    files in the repository): optional BOS, 16 ids from a CRC of the prompt,
    EOS, padding with 0."""

    model_max_length = 77

    def __init__(self, vocab_size: int = 49408, bos: int = 49406, eos: int = 49407):
        self.vocab_size, self.bos, self.eos = vocab_size, bos, eos

    def __call__(self, prompts, padding=None, max_length=77, truncation=True, return_tensors="np"):
        import numpy as np

        class Out:
            pass

        ids = []
        for p in prompts:
            h = zlib.crc32(p.encode("utf-8"))
            body = [(h + i * 7919) % (self.vocab_size - 500) + 2 for i in range(16)]
            row = ([self.bos] if self.bos is not None else []) + body + [self.eos]
            ids.append(row + [0] * (max_length - len(row)))
        out = Out()
        out.input_ids = np.array(ids, dtype=np.int64)
        return out


T5_TOKENIZER = dict(vocab_size=32128, bos=None, eos=1)


def bf16_tol(ref) -> float:
    """One bf16 ulp at the reference's largest magnitude (2^-7 * max|ref|):
    kernel and plain version each round an f32 result to bf16 once and their
    f32 sums differ only in order."""
    return 2.0**-7 * max(1.0, float(ref.abs().max()))


def bf16_ulp(ref):
    """One bf16 ulp of each element of `ref`: 2^(floor(log2|ref|) - 7)."""
    import torch

    _, exponent = torch.frexp(ref.float().abs())
    return torch.ldexp(torch.ones_like(ref, dtype=torch.float32), exponent - 8)


def attention_bounds(q, k, v, attn_mask=None, is_causal=False):
    """Per-element limits for the flash kernel's output, from the data.

    The kernel rounds each probability p to the input dtype before P.v (unit
    roundoff u: 2^-8 for bf16, 2^-11 for fp16; below fp16's normal range the
    rounding error is at most 2^-25) while its row sum stays f32, and rounds
    the output once. So, element by element,
    |out - ref32| <= u (|ref32| + sum_k p|v|) [+ 2^-25 sum_k |v| for fp16],
    where ref32 is the plain version in f32; the plain version in the input
    dtype rounds ref32 once more (another u |ref32|). 2^-14 (|ref32| +
    sum_k p|v|) covers f32 sums in another order and the approximate exp2.

    Returns (ref32, bound vs ref32, bound vs the plain version in the input dtype)."""
    import torch

    from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention_plain

    u = 2.0**-8 if q.dtype == torch.bfloat16 else 2.0**-11
    ref = flash_attention_plain(q.float(), k.float(), v.float(), attn_mask=attn_mask, is_causal=is_causal)
    pv = flash_attention_plain(q.float(), k.float(), v.float().abs(), attn_mask=attn_mask, is_causal=is_causal)
    bound = (u + 2.0**-14) * (ref.abs() + pv)
    if q.dtype == torch.float16:
        bound = bound + 2.0**-25 * v.float().abs().sum(dim=1, keepdim=True)
    return ref, bound, bound + u * ref.abs()


def attention_bwd_bounds(q, k, v, out, lse, grad_out, attn_mask=None, is_causal=False):
    """Per-element limits for the backward kernels' (dq, dk, dv), from the data.

    On the same inputs (q, k, v, out, lse, dO) the kernels differ from the
    plain version in f32 in three ways: they round P to the input dtype before
    P^T dO and dS to it before dS^T q and dS k (unit roundoff u: 2^-8 for
    bf16, 2^-11 for fp16); they sum in another order and take `__expf`, which
    moves p and dP = dO v^T by at most 2^-14 of p and of sum_d |dO||v|; and
    they round each output once (u |ref32|). So, element by element,

      |dv - ref| <= (u + 2^-14) (p^T |dO|) + u |ref|
      |dk - ref| <= (u + 2^-14) (|dS|^T |q|) + 2^-14 scale ((p * (|dO| |v|^T))^T |q|) + u |ref|
      |dq - ref| <= (u + 2^-14) (|dS| |k|) + 2^-14 scale ((p * (|dO| |v|^T)) |k|) + u |ref|

    [for fp16, whose subnormal rounding is absolute: + 2^-25 times the sum
    of |dO|, |q| or |k| for P and dS, and + 2^-25 for each output's own
    rounding]. The plain version in the input dtype rounds ref32 once more
    (another u |ref32| [+ 2^-25]).

    Returns (refs32, bounds vs ref32, bounds vs the plain version in the input
    dtype), each a (dq, dk, dv) tuple."""
    import torch

    from diffusers_tpu_torch.ops.cuda.flash_attention import _logits, flash_attention_bwd_plain

    u = 2.0**-8 if q.dtype == torch.bfloat16 else 2.0**-11
    eps = 2.0**-14
    scale = 1.0 / q.shape[-1] ** 0.5
    qf, kf, vf, dof = (t.float() for t in (q, k, v, grad_out))
    refs = flash_attention_bwd_plain(qf, kf, vf, attn_mask, out.float(), lse, dof, scale, is_causal)
    p = torch.exp(_logits(qf, kf, attn_mask, scale, is_causal) - lse[..., None])
    delta = (dof * out.float()).sum(-1).transpose(1, 2)
    ds_abs = (p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta[..., None]) * scale).abs()
    dp_err = p * torch.einsum("bqhd,bkhd->bhqk", dof.abs(), vf.abs()) * scale
    bound_dv = (u + eps) * torch.einsum("bhqk,bqhd->bkhd", p, dof.abs())
    del p
    bound_dk = ((u + eps) * torch.einsum("bhqk,bqhd->bkhd", ds_abs, qf.abs())
                + eps * torch.einsum("bhqk,bqhd->bkhd", dp_err, qf.abs()))
    bound_dq = ((u + eps) * torch.einsum("bhqk,bkhd->bqhd", ds_abs, kf.abs())
                + eps * torch.einsum("bhqk,bkhd->bqhd", dp_err, kf.abs()))
    del ds_abs, dp_err
    if q.dtype == torch.float16:
        bound_dq = bound_dq + 2.0**-25 * kf.abs().sum(dim=1, keepdim=True)
        bound_dk = bound_dk + 2.0**-25 * qf.abs().sum(dim=1, keepdim=True)
        bound_dv = bound_dv + 2.0**-25 * dof.abs().sum(dim=1, keepdim=True)
    out_ulp = 2.0**-25 if q.dtype == torch.float16 else 0.0  # an output's subnormal rounding
    bounds = tuple(b + u * r.abs() + out_ulp for b, r in zip((bound_dq, bound_dk, bound_dv), refs))
    return refs, bounds, tuple(b + u * r.abs() + out_ulp for b, r in zip(bounds, refs))


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of one call: `iters` calls captured in a CUDA graph and
    replayed once on CUDA events, so no host time enters (for a small kernel,
    `time_ms` measures the host's launch rate instead)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 100) -> float:
    """Host time of one call (microseconds): the enqueue alone, the device's
    work left to finish after the clock stops. For a kernel wrapper it holds
    the checks, the tensor-map encoding and the launch."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / iters * 1e6


def time_pair(kernel_fn, plain_fn, iters: int, plain_iters: int = None):
    """Times in turns (plain, kernel, kernel, plain); returns (kernel_ms, plain_ms) means."""
    plain_iters = plain_iters or iters
    p1 = time_ms(plain_fn, plain_iters)
    k1 = time_ms(kernel_fn, iters)
    k2 = time_ms(kernel_fn, iters)
    p2 = time_ms(plain_fn, plain_iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def launch_counters():
    """Every kernel wrapper's launch counter, by kernel name."""
    from diffusers_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_bwd_dkdv,
        flash_attention_bwd_dq,
        flash_attention_full,
    )
    from diffusers_tpu_torch.ops.cuda.w8a8_matmul import quantize_rows, w8a8_matmul_2d
    from diffusers_tpu_torch.ops.triton.group_norm import group_norm

    return {"flash_attention_fwd": flash_attention_full, "flash_attention_bwd_dkdv": flash_attention_bwd_dkdv,
            "flash_attention_bwd_dq": flash_attention_bwd_dq, "group_norm": group_norm,
            "w8a8_matmul": w8a8_matmul_2d, "w8a8_quantize_rows": quantize_rows}


def reset_launches() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in launch_counters().items()}


# ------------------------------------------------------------------ phases


def setup():
    """Phase 1: the card. Fails without CUDA or without the package beside this script."""
    if not (ROOT / "diffusers_tpu_torch" / "__init__.py").is_file():
        raise SystemExit(f"chip_smoke: no diffusers_tpu_torch package beside {Path(__file__).name}")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    RESULTS["device"] = {
        "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(), "nvidia_smi": smi,
        "torch": torch.__version__, "cuda": torch.version.cuda,
    }
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


def ptxas_summary(log: str):
    """Per kernel function of an nvcc `-Xptxas -v` log: (name, registers,
    spill stores, spill loads), names demangled where `c++filt` exists."""
    import re
    import shutil

    rows, name = [], None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name = m.group(1)
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            spills = (int(m.group(1)), int(m.group(2)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            rows.append([name, int(m.group(1)), *spills])
            name = None
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows), capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        for r, n in zip(rows, names):
            r[0] = n.replace("(anonymous namespace)::", "").split("(")[0]
    return [tuple(r) for r in rows]


def build_kernels():
    """Phase 2: build the CUDA C++ kernels with nvcc (sm_90a), one nvcc per
    source, all at once; each kernel's registers and spills (ptxas) and the
    dynamic shared memory of K1's, K2's, K3's and K5's launches."""
    from diffusers_tpu_torch.ops.cuda import _build, flash_attention, w8a8_matmul

    sources = (flash_attention.SOURCE, flash_attention.BWD_SOURCE, w8a8_matmul.SOURCE)
    t0 = time.perf_counter()
    _build.build_all(sources)
    for load in (flash_attention.load_library, flash_attention.load_bwd_library, w8a8_matmul.load_library):
        load()
    seconds = time.perf_counter() - t0
    RESULTS["build"] = {"seconds": seconds}
    log(f"[build] {', '.join(src.name for src in sources)} -> sm_90a in {seconds:.1f} s (in parallel)")
    for src in sources:
        rows = ptxas_summary(_build.build_log(src))
        RESULTS["build"][src.name] = [{"function": n, "registers": r, "spill_stores": ss, "spill_loads": sl}
                                      for n, r, ss, sl in rows]
        for n, r, ss, sl in rows:
            log(f"[build]   {src.name}: {n}: {r} registers, spill stores {ss} B, spill loads {sl} B")
    smem = {f"flash_attention_fwd d={d}": flash_attention.load_library().flash_attention_fwd_smem_bytes(d)
            for d in flash_attention.HEAD_DIMS}
    smem.update({f"flash_attention_bwd {name} d={d}": flash_attention.load_bwd_library().flash_attention_bwd_smem_bytes(
        d, kernel) for d in flash_attention.HEAD_DIMS for name, kernel in (("dkdv", 0), ("dq", 1))})
    smem.update({f"w8a8_matmul tile {bm}x{bn}": w8a8_matmul.load_library().w8a8_matmul_smem_bytes(bn)
                 for bm, bn in w8a8_matmul.TILES})
    RESULTS["build"]["dynamic_smem_bytes"] = smem
    log(f"[build]   dynamic shared memory per block (bytes): {smem}")


def check_kernels():
    """Phase 3: K1 and K4 against their plain versions at the main paths'
    shapes, bf16; K1 as the forward-only flash attention (K6's counterpart)."""
    import torch
    import torch.nn.functional as F

    from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention, flash_attention_full, flash_attention_plain
    from diffusers_tpu_torch.ops.triton.group_norm import group_norm, group_norm_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = []

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale).to(dtype)

    # --- K1: flash attention forward
    attn_cases = [
        # (label, q shape, kv length, options, timed)
        ("Flux joint 4608 d=128", (1, 4608, 24, 128), 4608, {}, True),
        ("self 4096 (UNet level 2)", (2, 4096, 10, 64), 4096, {}, True),
        ("self 1024 (UNet level 3)", (2, 1024, 20, 64), 1024, {}, True),
        ("cross 4096 x 77 (UNet level 2)", (2, 4096, 10, 64), 77, {}, True),
        ("cross 1024 x 77 (UNet level 3)", (2, 1024, 20, 64), 77, {}, True),
        ("causal 300 (ragged)", (1, 300, 2, 64), 300, {"is_causal": True}, False),
        ("additive mask 200 x 333, d=128", (1, 200, 2, 128), 333, {"mask": True}, False),
        ("fp16 d=128 500 x 700", (1, 500, 3, 128), 700, {"dtype": torch.float16}, False),
        ("mask -inf over the first 160 keys of every other row, d=128", (2, 300, 2, 128), 333, {"mask": "hide"},
         False),
    ]
    k1_errs, k1_times = [], {}
    for label, qshape, sk, opt, timed in attn_cases:
        dtype = opt.get("dtype", torch.bfloat16)
        b, sq, h, d = qshape
        q = randn(b, sq, h, d, dtype=dtype, scale=2.0)
        k = randn(b, sk, h, d, dtype=dtype)
        v = randn(b, sk, h, d, dtype=dtype)
        mask = None
        if opt.get("mask") == "hide":  # more than one 128-key kv tile hidden: no inf - inf in the kernel
            mask = torch.zeros((b, 1, sq, sk), device=dev)
            mask[:, :, ::2, :160] = float("-inf")
        elif opt.get("mask"):
            mask = torch.where(torch.rand((b, 1, sq, sk), generator=gen, device=dev) < 0.3, -1e4, 0.0)
        causal = opt.get("is_causal", False)
        out = flash_attention_full(q, k, v, attn_mask=mask, is_causal=causal)
        torch.cuda.synchronize()
        ref32, bound32, bound16 = attention_bounds(q, k, v, attn_mask=mask, is_causal=causal)
        ref16 = flash_attention_plain(q, k, v, attn_mask=mask, is_causal=causal)
        diff32 = (out.float() - ref32).abs()
        err32 = float(diff32.max())
        err16 = float((out.float() - ref16.float()).abs().max())
        used32 = float((diff32 / bound32).max())
        used16 = float(((out.float() - ref16.float()).abs() / bound16).max())
        row = {"kernel": "flash_attention_fwd", "case": label, "q": list(qshape), "sk": sk, "dtype": str(dtype),
               "max_abs_err_vs_f32": err32, "max_abs_err_vs_plain_same_dtype": err16,
               "max_share_of_bound_vs_f32": used32, "max_share_of_bound_vs_plain_same_dtype": used16,
               "max_bound_vs_f32": float(bound32.max())}
        if timed:
            ms, plain_ms = time_pair(lambda: flash_attention_full(q, k, v),
                                     lambda: flash_attention_plain(q, k, v), iters=20, plain_iters=5)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=20)
            flops = 4.0 * b * h * sq * sk * d
            bms, by = bound_ms(2 * (q.numel() + k.numel() + v.numel() + q.numel()), flops, PEAK_BF16_FLOPS)
            row.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms, bound_by=by,
                       tflops=flops / ms / 1e9, share_of_time_bound=bms / ms,
                       device_ms=graph_ms(lambda: flash_attention_full(q, k, v)),
                       library_device_ms=graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
                       host_us_per_call=host_us(lambda: flash_attention_full(q, k, v)))
            k1_times[label] = row
        log(f"[K1] {label}: err vs f32 {err32:.3e}, vs plain {err16:.3e}; share of the per-element bound "
            f"{used32:.3f} / {used16:.3f}"
            + (f", kernel {row['ms']:.4f} ms ({row['tflops']:.1f} TFLOP/s, {100 * row['share_of_time_bound']:.1f}% "
               f"of its bound), plain {row['plain_ms']:.3f} ms, SDPA {row['library_ms']:.4f} ms, bound "
               f"{row['bound_ms']:.4f} ms; device time (CUDA graph) {row['device_ms']:.4f} ms, SDPA "
               f"{row['library_device_ms']:.4f} ms; host {row['host_us_per_call']:.1f} us a call" if timed else ""))
        if not (used32 <= 1.0 and used16 <= 1.0 and torch.isfinite(out).all()):
            raise AssertionError(f"flash_attention_fwd disagrees with its plain version on {label}")
        if timed:
            # controls: outputs of a partly wrong kernel must break the bound
            t0 = (sk // 2) // 64 * 64  # 64 keys from the middle
            keep = torch.cat([torch.arange(t0, device=dev), torch.arange(min(t0 + 64, sk), sk, device=dev)])
            dropped = flash_attention_full(q, k[:, keep], v[:, keep])
            misscaled = out.clone()
            misscaled[:, ::64] *= 1 + 2.0**-5  # every 64th query row 3% off
            controls = {"kv_tile_dropped": float(((dropped.float() - ref32).abs() / bound32).max()),
                        "rows_misscaled": float(((misscaled.float() - ref32).abs() / bound32).max())}
            last = (sk - 1) // 128 * 128  # the kernel's last 128-key kv tile starts here
            if last > 0:
                no_last = flash_attention_full(q, k[:, :last], v[:, :last])
                controls["last_kv_tile_dropped"] = float(((no_last.float() - ref32).abs() / bound32).max())
            row["controls_share_of_bound"] = controls
            log(f"[K1]   controls, share of the bound (must exceed 1): {controls}")
            if min(controls.values()) <= 1.0:
                raise AssertionError(f"the flash_attention_fwd bound does not reject a broken output on {label}")
        cases.append(row)
        k1_errs.append(err32)

    # LSE against torch.logsumexp of the f32 logits
    q, k, v = randn(1, 256, 2, 64, scale=2.0), randn(1, 256, 2, 64), randn(1, 256, 2, 64)
    _, lse = flash_attention_full(q, k, v, return_lse=True)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / 8.0
    lse_err = float((lse - torch.logsumexp(logits, dim=-1)).abs().max())
    lse_tol = 1e-3  # f32 online softmax with an approximate exp2 against exact f32 logsumexp
    cases.append({"kernel": "flash_attention_fwd", "case": "lse 256", "max_abs_err_vs_f32": lse_err, "tol": lse_tol})
    log(f"[K1] lse 256: err vs torch.logsumexp {lse_err:.3e} (tol {lse_tol:.0e})")
    if not lse_err <= lse_tol:
        raise AssertionError("flash_attention_fwd LSE disagrees with torch.logsumexp")

    # K6's counterpart: forward-only flash_attention (causal, custom scale) is K1's kernel
    q, k, v = randn(2, 1024, 4, 128, scale=2.0), randn(2, 1024, 4, 128), randn(2, 1024, 4, 128)
    before = flash_attention_full.launches
    out = flash_attention(q, k, v, scale=0.1, is_causal=True)
    torch.cuda.synchronize()
    ref32 = flash_attention_plain(q.float(), k.float(), v.float(), scale=0.1, is_causal=True)
    pv = flash_attention_plain(q.float(), k.float(), v.float().abs(), scale=0.1, is_causal=True)
    k6_share = float(((out.float() - ref32).abs() / ((2.0**-8 + 2.0**-14) * (ref32.abs() + pv))).max())
    cases.append({"kernel": "flash_attention (K6, served by K1)", "case": "causal 1024, d=128, scale 0.1",
                  "max_abs_err_vs_f32": float((out.float() - ref32).abs().max()), "max_share_of_bound": k6_share})
    log(f"[K6] flash_attention causal 1024 d=128 scale 0.1 through K1: share of the per-element bound {k6_share:.3f}")
    if not (k6_share <= 1.0 and flash_attention_full.launches == before + 1):
        raise AssertionError("flash_attention (K6 through K1) disagrees with its plain version")

    # --- K4: GroupNorm (+SiLU)
    gn_shapes = [
        ("UNet 320 @ 128x128", (2, 320, 128, 128)),
        ("UNet 640 @ 64x64", (2, 640, 64, 64)),
        ("UNet 1280 @ 32x32", (2, 1280, 32, 32)),
        ("VAE 128 @ 1024x1024", (1, 128, 1024, 1024)),
    ]
    k4_errs, k4_times = [], {}
    t0 = time.perf_counter()
    for label, shape in gn_shapes:
        c = shape[1]
        x = randn(*shape, scale=1.5) + 0.5
        w = (1 + 0.1 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        bias = (0.1 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        for silu in (False, True):
            out = group_norm(x, w, bias, 32, 1e-6, apply_silu=silu)
            torch.cuda.synchronize()
            if "first_launch_seconds" not in RESULTS.setdefault("triton", {}):
                RESULTS["triton"]["first_launch_seconds"] = time.perf_counter() - t0
            ref32 = group_norm_plain(x.float(), w.float(), bias.float(), 32, 1e-6, apply_silu=silu)
            ref16 = group_norm_plain(x, w, bias, 32, 1e-6, apply_silu=silu)
            err32 = float((out.float() - ref32).abs().max())
            err16 = float((out.float() - ref16.float()).abs().max())
            tol = bf16_tol(ref32)
            ms, plain_ms = time_pair(lambda: group_norm(x, w, bias, 32, 1e-6, apply_silu=silu),
                                     lambda: group_norm_plain(x, w, bias, 32, 1e-6, apply_silu=silu), iters=10)
            if silu:
                library_ms = time_ms(lambda: F.silu(F.group_norm(x, 32, w, bias, 1e-6)), iters=10)
            else:
                library_ms = time_ms(lambda: F.group_norm(x, 32, w, bias, 1e-6), iters=10)
            bms, by = bound_ms(2 * x.numel() * x.element_size(), 0, PEAK_BF16_FLOPS)
            gbps = 3 * x.numel() * x.element_size() / ms / 1e6
            name = f"{label}{' +SiLU' if silu else ''}"
            row = {"kernel": "group_norm", "case": name, "shape": list(shape), "max_abs_err_vs_f32": err32,
                   "max_abs_err_vs_plain_same_dtype": err16, "tol": tol, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound_ms": bms, "bound_by": by, "gbps_3x_bytes": gbps}
            cases.append(row)
            k4_errs.append(err32)
            k4_times[name] = row
            log(f"[K4] {name}: err vs f32 {err32:.3e}, vs plain {err16:.3e} (tol {tol:.3e}), "
                f"kernel {ms:.3f} ms ({gbps:.0f} GB/s at 3 passes), plain {plain_ms:.3f} ms, "
                f"F.group_norm{'+F.silu' if silu else ''} {library_ms:.3f} ms, bound {bms:.3f} ms")
            if not (err32 <= tol and err16 <= tol and torch.isfinite(out).all()):
                raise AssertionError(f"group_norm disagrees with its plain version on {name}")
    log(f"[K4] triton first launch (compile) {RESULTS['triton']['first_launch_seconds']:.1f} s")
    RESULTS["kernel_cases"] = cases
    return {
        "flash_attention_fwd": (max(k1_errs + [lse_err]), k1_times["Flux joint 4608 d=128"]),
        "group_norm": (max(k4_errs), k4_times["UNet 320 @ 128x128 +SiLU"]),
    }


def check_w8a8():
    """Phase 4: K5 and its row quantization against their plain versions at
    every Flux.1-dev w8a8 shape, bf16, with a skipped-K-tile control; times of
    kernel, plain version and the nearest library calls, summed over one
    denoise step's launches."""
    import torch

    from diffusers_tpu_torch.ops.cuda._build import sm_count
    from diffusers_tpu_torch.ops.cuda.w8a8_matmul import (
        pick_tile,
        quantize_rows,
        quantize_rows_plain,
        w8a8_matmul_2d,
        w8a8_matmul_2d_plain,
    )
    from diffusers_tpu_torch.quantizers import quantize_kernel_int8

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    cases = []
    step = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "bf16_matmul_ms", "bound_ms",
                             "q_ms", "q_plain_ms", "q_bound_ms", "device_ms", "library_device_ms")}
    max_err = 0.0
    for m, k, n, per_step in FLUX_W8A8_SHAPES:
        x = (torch.randn(m, k, generator=gen, device=dev) * 2).to(torch.bfloat16)
        w = torch.randn(n, k, generator=gen, device=dev) / k**0.5
        qw, ws = quantize_kernel_int8(w)
        bias = (0.1 * torch.randn(n, generator=gen, device=dev)).to(torch.bfloat16)

        # the row quantization: bit for bit
        qx, xs = quantize_rows(x)
        qx_p, xs_p = quantize_rows_plain(x)
        torch.cuda.synchronize()
        q_equal = bool(torch.equal(qx, qx_p)) and bool(torch.equal(xs, xs_p))

        # the matmul: within one bf16 ulp of the plain version per element (the int32 sums are exact)
        y = w8a8_matmul_2d(qx, qw, xs, ws, torch.bfloat16, bias)
        torch.cuda.synchronize()
        ref = w8a8_matmul_2d_plain(qx, qw, xs, ws, torch.bfloat16, bias)
        diff = (y.float() - ref.float()).abs()
        ulp = bf16_ulp(ref)
        used = float((diff / ulp).max())
        err = float(diff.max())
        # control: the kernel without one 64-wide K slice must break the limit
        skipped = w8a8_matmul_2d(qx, qw, xs, ws, torch.bfloat16, bias, _skip_k_tile=(k // 64) // 2)
        control = float(((skipped.float() - ref.float()).abs() / ulp).max())

        ms, plain_ms = time_pair(lambda: w8a8_matmul_2d(qx, qw, xs, ws, torch.bfloat16, bias),
                                 lambda: w8a8_matmul_2d_plain(qx, qw, xs, ws, torch.bfloat16, bias),
                                 iters=20, plain_iters=2)
        call_us = host_us(lambda: w8a8_matmul_2d(qx, qw, xs, ws, torch.bfloat16, bias))
        device_ms = graph_ms(lambda: w8a8_matmul_2d(qx, qw, xs, ws, torch.bfloat16, bias))
        q_ms, q_plain_ms = time_pair(lambda: quantize_rows(x), lambda: quantize_rows_plain(x), iters=20)
        # nearest library calls: cuBLAS int8 (`torch._int_mm`, which takes M > 16: M padded to 32)
        # with the same epilogue, and a bf16 matmul of the dequantized weight
        mp = max(m, 32)
        qx_pad = torch.zeros(mp, k, dtype=torch.int8, device=dev)
        qx_pad[:m] = qx
        xs_pad = torch.ones(mp, 1, device=dev)
        xs_pad[:m] = xs
        int_mm = lambda: (torch._int_mm(qx_pad, qw.t()).float() * xs_pad * ws).to(torch.bfloat16) + bias  # noqa: E731
        library_ms, library_device_ms = time_ms(int_mm, iters=20), graph_ms(int_mm)
        w_bf16 = (qw.float() * ws[:, None]).to(torch.bfloat16)
        bf16_ms = time_ms(lambda: torch.nn.functional.linear(x, w_bf16, bias), iters=20)
        bms, by = bound_ms(m * k + n * k + 4 * (m + n) + 2 * n + 2 * m * n, 2.0 * m * n * k, PEAK_INT8_OPS)
        q_bms, _ = bound_ms(2 * m * k + m * k + 4 * m, 0, PEAK_INT8_OPS)

        row = {"kernel": "w8a8_matmul", "m": m, "k": k, "n": n, "launches_per_step": per_step,
               "quantize_rows_bit_equal": q_equal, "max_abs_err_vs_plain": err, "max_ulps_vs_plain": used,
               "control_skipped_k_tile_max_ulps": control, "ms": ms, "plain_ms": plain_ms,
               "int_mm_epilogue_ms": library_ms, "bf16_matmul_ms": bf16_ms, "bound_ms": bms, "bound_by": by,
               "tops": 2.0 * m * n * k / ms / 1e9, "share_of_time_bound": bms / ms,
               "tile": pick_tile(m, n, sm_count(dev.index or 0)), "host_us_per_call": call_us, "device_ms": device_ms,
               "int_mm_epilogue_device_ms": library_device_ms, "quantize_ms": q_ms,
               "quantize_plain_ms": q_plain_ms, "quantize_bound_ms": q_bms}
        cases.append(row)
        log(f"[K5] M {m} K {k} N {n} (x{per_step}/step): qx bit-equal {q_equal}; err {err:.3e} ({used:.2f} ulp, "
            f"control {control:.1f} ulp); kernel {ms:.4f} ms ({row['tops']:.0f} TOPS, "
            f"{100 * row['share_of_time_bound']:.1f}% of its bound; tile {row['tile']}; host "
            f"{call_us:.1f} us a call; device time (CUDA graph) {device_ms:.4f}, _int_mm+epilogue {library_device_ms:.4f}), "
            f"plain {plain_ms:.3f}, "
            f"_int_mm+epilogue {library_ms:.4f}, bf16 matmul {bf16_ms:.4f}, bound {bms:.4f} ({by}); "
            f"quantize {q_ms:.4f} ms (plain {q_plain_ms:.4f}, bound {q_bms:.4f})")
        if not (q_equal and used <= 1.0 and torch.isfinite(y).all()):
            raise AssertionError(f"w8a8 kernels disagree with their plain versions at M {m} K {k} N {n}")
        if control <= 1.0:
            raise AssertionError(f"the w8a8 limit does not reject a skipped K tile at M {m} K {k} N {n}")
        max_err = max(max_err, err)
        for key, value in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                           ("bf16_matmul_ms", bf16_ms), ("bound_ms", bms), ("q_ms", q_ms),
                           ("q_plain_ms", q_plain_ms), ("q_bound_ms", q_bms), ("device_ms", device_ms),
                           ("library_device_ms", library_device_ms)):
            step[key] += per_step * value
    assert sum(s[3] for s in FLUX_W8A8_SHAPES) == FLUX_W8A8_PER_STEP
    RESULTS["w8a8_cases"] = cases
    RESULTS["w8a8_per_denoise_step"] = step
    log(f"[K5] one Flux.1-dev denoise step ({FLUX_W8A8_PER_STEP} launches): kernel {step['ms']:.2f} ms, plain "
        f"{step['plain_ms']:.1f} ms, _int_mm+epilogue {step['library_ms']:.2f} ms, bf16 matmul "
        f"{step['bf16_matmul_ms']:.2f} ms, bound {step['bound_ms']:.2f} ms; device time (CUDA graphs) kernel "
        f"{step['device_ms']:.2f} ms, _int_mm+epilogue {step['library_device_ms']:.2f} ms; quantize_rows {step['q_ms']:.2f} ms "
        f"(bound {step['q_bound_ms']:.2f} ms)")
    return {
        "w8a8_matmul": (max_err, {"ms": step["ms"], "plain_ms": step["plain_ms"], "library_ms": step["library_ms"],
                                  "bound_ms": step["bound_ms"], "bound_by": "operations"}),
        "w8a8_quantize_rows": (0.0, {"ms": step["q_ms"], "plain_ms": step["q_plain_ms"], "library_ms": None,
                                     "bound_ms": step["q_bound_ms"], "bound_by": "bytes"}),
    }


def _bwd_instance(dtype, d, masked, causal):
    """K2's and K3's ptxas rows (registers, spills) and dynamic shared memory
    for the kernel instances that a case launches."""
    import torch

    from diffusers_tpu_torch.ops.cuda.flash_attention import load_bwd_library

    ty = "__nv_bfloat16" if dtype == torch.bfloat16 else "__half"
    flags = f"{str(bool(masked)).lower()}, {str(bool(causal)).lower()}"
    rows = {r["function"]: r for r in RESULTS.get("build", {}).get("flash_attention_bwd.cu", [])}
    lib = load_bwd_library()
    return {name: dict(rows.get(f"void flash_bwd_{name}_kernel<{ty}, {d}, {flags}>", {}),
                       dynamic_smem_bytes=lib.flash_attention_bwd_smem_bytes(d, kernel))
            for name, kernel in (("dkdv", 0), ("dq", 1))}


def check_flash_bwd():
    """Phase 5: K2 (dK/dV) and K3 (dQ) against their plain version,
    `flash_attention_bwd_plain`, at the SDXL training shapes (1024 px, batch
    1: self attention over 4096 and 1024 tokens, cross attention over 77,
    where K2 splits its query sweep), at Flux's (1, 4608, 24, 128) for
    head_dim 128, on a causal and a masked case, and with a mask of -inf or
    finfo.min over a row's first kv tile; each element within
    `attention_bwd_bounds`, and two launches bit-identical. Controls: grads of
    inputs with one 64-key tile of k/v zeroed must break the bound. For each
    case: the split `pick_split` chose and the instances' ptxas registers,
    spills and shared memory; for the timed ones each kernel's time on
    events and in device time (a CUDA graph), TFLOP/s and share of its
    bound, host time a call, and the times of the plain version, of the bound
    and of the library call (the backward of `F.scaled_dot_product_attention`:
    its forward and backward, minus its forward), summed over one SDXL train
    step's launches."""
    import torch
    import torch.nn.functional as F

    from diffusers_tpu_torch.ops.cuda._build import sm_count
    from diffusers_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_dkdv,
        flash_attention_bwd_dq,
        flash_attention_bwd_plain,
        flash_attention_full,
        pick_split,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    sms = sm_count(dev.index or 0)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale).to(dtype)

    cases, step = [], {k: 0.0 for k in ("dkdv_ms", "dq_ms", "plain_ms", "library_ms", "dkdv_bound_ms",
                                         "dq_bound_ms", "dkdv_device_ms", "dq_device_ms", "library_device_ms")}
    max_err = {"flash_attention_bwd_dkdv": 0.0, "flash_attention_bwd_dq": 0.0}
    for label, qshape, sk, opt, per_step in SDXL_TRAIN_ATTENTION + BWD_EXTRA_CASES:
        b, sq, h, d = qshape
        dtype = torch.float16 if opt.get("dtype") == "fp16" else torch.bfloat16
        q, k, v = randn(b, sq, h, d, dtype=dtype, scale=2.0), randn(b, sk, h, d, dtype=dtype), randn(b, sk, h, d,
                                                                                                     dtype=dtype)
        mask = None
        if opt.get("mask") in ("-inf", "finfo.min"):  # a whole first 128-key kv tile hidden in every other row
            mask = torch.zeros((b, 1, sq, sk), device=dev)
            mask[:, :, ::2, :160] = float("-inf") if opt["mask"] == "-inf" else torch.finfo(torch.float32).min
        elif opt.get("mask"):
            mask = torch.where(torch.rand((b, 1, sq, sk), generator=gen, device=dev) < 0.3, -1e4, 0.0)
        causal = opt.get("is_causal", False)
        out, lse = flash_attention_full(q, k, v, attn_mask=mask, is_causal=causal, return_lse=True)
        grad_out = randn(b, sq, h, d, dtype=dtype)
        grads = flash_attention_bwd(q, k, v, mask, out, lse, grad_out, is_causal=causal)
        again = flash_attention_bwd(q, k, v, mask, out, lse, grad_out, is_causal=causal)
        torch.cuda.synchronize()
        identical = all(torch.equal(a, g) for a, g in zip(again, grads))
        del again
        refs, bounds32, bounds16 = attention_bwd_bounds(q, k, v, out, lse, grad_out, attn_mask=mask,
                                                        is_causal=causal)
        plain = flash_attention_bwd_plain(q, k, v, mask, out, lse, grad_out, 1.0 / d**0.5, causal)
        split = pick_split(b, h, sq, sk, sms)
        instance = _bwd_instance(dtype, d, mask is not None, causal)
        row = {"kernel": "flash_attention_bwd", "case": label, "q": list(qshape), "sk": sk, "dtype": str(dtype),
               "split": split, "bit_identical_across_launches": identical, "instances": instance}
        ok = identical
        for name, g, ref, p16, b32, b16 in zip(("dq", "dk", "dv"), grads, refs, plain, bounds32, bounds16):
            diff32, diff16 = (g.float() - ref).abs(), (g.float() - p16.float()).abs()
            share32 = float(torch.where(diff32 == 0, 0.0, diff32 / b32).max())
            share16 = float(torch.where(diff16 == 0, 0.0, diff16 / b16).max())
            row[name] = {"max_abs_err_vs_f32": float(diff32.max()), "max_abs_err_vs_plain_same_dtype":
                         float(diff16.max()), "max_share_of_bound_vs_f32": share32,
                         "max_share_of_bound_vs_plain_same_dtype": share16}
            ok = ok and share32 <= 1.0 and share16 <= 1.0 and bool(torch.isfinite(g).all())
            kernel = "flash_attention_bwd_dq" if name == "dq" else "flash_attention_bwd_dkdv"
            max_err[kernel] = max(max_err[kernel], float(diff32.max()))
        shares = {n: round(row[n]["max_share_of_bound_vs_f32"], 3) for n in ("dq", "dk", "dv")}
        ptxas = {n: (f"{r.get('registers')} registers, spills {r.get('spill_stores')}/{r.get('spill_loads')} B, "
                     f"smem {r['dynamic_smem_bytes']} B") for n, r in instance.items()}
        log(f"[K2/K3] {label}: share of the per-element bound vs f32 {shares}; K2 split {split}; bit-identical "
            f"across two launches {identical}; instances {ptxas}")
        if not ok:
            raise AssertionError(f"flash_attention_bwd disagrees with its plain version on {label}: {row}")
        if per_step or opt.get("timed"):
            # controls: grads of inputs with one 64-key kv tile zeroed must break the bound
            t0 = (sk // 2) // 64 * 64
            k0, v0 = k.clone(), v.clone()
            k0[:, t0:t0 + 64] = 0
            v0[:, t0:t0 + 64] = 0
            broken = flash_attention_bwd(q, k0, v0, mask, out, lse, grad_out, is_causal=causal)
            controls = {n: float(((g.float() - ref).abs() / b32).max())
                        for n, g, ref, b32 in zip(("dq", "dk", "dv"), broken, refs, bounds32)}
            row["controls_share_of_bound"] = controls
            log(f"[K2/K3]   control (kv tile zeroed), share of the bound (must exceed 1): {controls}")
            if min(controls.values()) <= 1.0:
                raise AssertionError(f"the flash_attention_bwd bound does not reject a zeroed kv tile on {label}")
            delta = (grad_out.float() * out).sum(-1).transpose(1, 2)  # as flash_attention_bwd computes it
            args = (q, k, v, mask, lse, delta, grad_out, 1 / d**0.5, causal)
            dkdv_ms, dq_ms = time_pair(lambda: flash_attention_bwd_dkdv(*args), lambda: flash_attention_bwd_dq(*args),
                                       iters=20)
            plain_ms = time_ms(lambda: flash_attention_bwd_plain(q, k, v, mask, out, lse, grad_out, 1 / d**0.5,
                                                                 causal), iters=3)
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
            go = grad_out.transpose(1, 2)

            def sdpa_fwd_bwd():
                o = F.scaled_dot_product_attention(qt, kt, vt)
                torch.autograd.grad(o, (qt, kt, vt), go)

            with torch.no_grad():
                sdpa_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=20)
                sdpa_fwd_device_ms = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
            library_ms = time_ms(sdpa_fwd_bwd, iters=20) - sdpa_fwd_ms
            # the same comparison in device time (CUDA graphs: no host or autograd dispatch)
            library_device_ms = graph_ms(sdpa_fwd_bwd) - sdpa_fwd_device_ms
            dkdv_device_ms = graph_ms(lambda: flash_attention_bwd_dkdv(*args))
            dq_device_ms = graph_ms(lambda: flash_attention_bwd_dq(*args))
            host = {"dkdv_host_us": host_us(lambda: flash_attention_bwd_dkdv(*args)),
                    "dq_host_us": host_us(lambda: flash_attention_bwd_dq(*args)),
                    "bwd_host_us": host_us(lambda: flash_attention_bwd(q, k, v, mask, out, lse, grad_out,
                                                                       is_causal=causal)),
                    "delta_host_us": host_us(lambda: (grad_out.float() * out).sum(-1).transpose(1, 2))}
            io = 2 * (q.numel() + k.numel() + v.numel() + grad_out.numel()) + 2 * 4 * b * h * sq
            flops = 2.0 * b * h * sq * sk * d
            dkdv_bound, dkdv_by = bound_ms(io + 2 * (k.numel() + v.numel()), 4 * flops, PEAK_BF16_FLOPS)
            dq_bound, dq_by = bound_ms(io + 2 * q.numel(), 3 * flops, PEAK_BF16_FLOPS)
            row.update(dkdv_ms=dkdv_ms, dq_ms=dq_ms, plain_ms=plain_ms, library_ms=library_ms,
                       dkdv_bound_ms=dkdv_bound, dkdv_bound_by=dkdv_by, dq_bound_ms=dq_bound, dq_bound_by=dq_by,
                       launches_per_train_step=per_step, dkdv_tflops=4 * flops / dkdv_ms / 1e9,
                       dq_tflops=3 * flops / dq_ms / 1e9, dkdv_device_ms=dkdv_device_ms,
                       dq_device_ms=dq_device_ms, library_device_ms=library_device_ms,
                       dkdv_device_tflops=4 * flops / dkdv_device_ms / 1e9,
                       dq_device_tflops=3 * flops / dq_device_ms / 1e9,
                       dkdv_device_share_of_bound=dkdv_bound / dkdv_device_ms,
                       dq_device_share_of_bound=dq_bound / dq_device_ms, **host)
            log(f"[K2/K3]   K2 {dkdv_ms:.3f} ms ({row['dkdv_tflops']:.1f} TFLOP/s, bound {dkdv_bound:.3f} "
                f"{dkdv_by}), K3 {dq_ms:.3f} ms ({row['dq_tflops']:.1f} TFLOP/s, bound {dq_bound:.3f} {dq_by}), "
                f"plain {plain_ms:.3f} ms, SDPA backward {library_ms:.3f} ms (x{per_step} per train step); device "
                f"time (CUDA graphs) K2 {dkdv_device_ms:.4f} ms ({row['dkdv_device_tflops']:.1f} TFLOP/s, "
                f"{100 * row['dkdv_device_share_of_bound']:.1f}% of its bound) + K3 {dq_device_ms:.4f} ms "
                f"({row['dq_device_tflops']:.1f} TFLOP/s, {100 * row['dq_device_share_of_bound']:.1f}%), SDPA "
                f"backward {library_device_ms:.4f} ms; host a call: K2 {host['dkdv_host_us']:.1f} us, K3 "
                f"{host['dq_host_us']:.1f} us, both (flash_attention_bwd, with delta) {host['bwd_host_us']:.1f} us, "
                f"delta alone {host['delta_host_us']:.1f} us")
            for key in step:
                step[key] += per_step * row[key]
        cases.append(row)
        del refs, bounds32, bounds16, plain
        torch.cuda.empty_cache()
    RESULTS["flash_bwd_cases"] = cases
    RESULTS["flash_bwd_per_train_step"] = step
    log(f"[K2/K3] one SDXL train step (140 launches each): K2 {step['dkdv_ms']:.2f} ms (bound "
        f"{step['dkdv_bound_ms']:.2f}), K3 {step['dq_ms']:.2f} ms (bound {step['dq_bound_ms']:.2f}), plain "
        f"{step['plain_ms']:.1f} ms, SDPA backward {step['library_ms']:.2f} ms; device time (CUDA graphs) K2 "
        f"{step['dkdv_device_ms']:.2f} + K3 {step['dq_device_ms']:.2f} ms, SDPA backward "
        f"{step['library_device_ms']:.2f} ms")
    return {
        "flash_attention_bwd_dkdv": (max_err["flash_attention_bwd_dkdv"], {
            "ms": step["dkdv_ms"], "plain_ms": step["plain_ms"], "library_ms": step["library_ms"],
            "bound_ms": step["dkdv_bound_ms"], "bound_by": "operations"}),
        "flash_attention_bwd_dq": (max_err["flash_attention_bwd_dq"], {
            "ms": step["dq_ms"], "plain_ms": step["plain_ms"], "library_ms": step["library_ms"],
            "bound_ms": step["dq_bound_ms"], "bound_by": "operations"}),
    }


def _build_pipeline(unet_cfg, vae_cfg, clip1_cfg, clip2_cfg, device, dtype):
    import torch

    from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
    from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel, CLIPTextModelWithProjection
    from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
    from diffusers_tpu_torch.pipelines.stable_diffusion_xl.pipeline_stable_diffusion_xl import (
        StableDiffusionXLPipeline,
    )
    from diffusers_tpu_torch.schedulers import EulerDiscreteScheduler

    torch.manual_seed(SEED)
    with torch.device(device):  # parameters are created (and randomly initialized) on `device`
        unet = UNet2DConditionModel(**unet_cfg)
        vae = AutoencoderKL(**vae_cfg)
        te1 = CLIPTextModel(**clip1_cfg)
        te2 = CLIPTextModelWithProjection(**clip2_cfg)
    kwargs = {} if device == "cuda" else {"device": device}  # the pipeline's default device is the card
    pipe = StableDiffusionXLPipeline(
        vae=vae, text_encoder=te1, text_encoder_2=te2, tokenizer=StandInTokenizer(),
        tokenizer_2=StandInTokenizer(), unet=unet, scheduler=EulerDiscreteScheduler(**EULER), **kwargs,
    )
    return pipe.to(dtype=dtype)


def _build_flux_pipeline(transformer_cfg, min_weight_size, vae_cfg, clip_cfg, t5_cfg, device, dtype):
    """A FluxPipeline with random weights from SEED. The transformer and T5
    are built on the meta device and allocated one block at a time on
    `device` (random init in float32, cast to `dtype`, transformer Linears of
    >= `min_weight_size` elements quantized to w8a8), so no full float copy
    of either exists."""
    import torch

    from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
    from diffusers_tpu_torch.models.modeling_utils import materialize_
    from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel
    from diffusers_tpu_torch.models.text_encoders.t5 import T5EncoderModel
    from diffusers_tpu_torch.models.transformers.transformer_flux import FluxTransformer2DModel
    from diffusers_tpu_torch.pipelines.flux.pipeline_flux import FluxPipeline
    from diffusers_tpu_torch.quantizers import quantize_w8a8
    from diffusers_tpu_torch.schedulers import FlowMatchEulerDiscreteScheduler

    torch.manual_seed(SEED)
    with torch.device("meta"):
        transformer = FluxTransformer2DModel(**transformer_cfg)
        t5 = T5EncoderModel(**t5_cfg)
    materialize_(transformer, device, dtype, lambda unit: quantize_w8a8(unit, min_weight_size))
    materialize_(t5, device, dtype)
    with torch.device(device):
        vae = AutoencoderKL(**vae_cfg).to(dtype)
        clip = CLIPTextModel(**clip_cfg).to(dtype)
    kwargs = {} if device == "cuda" else {"device": device}  # the pipeline's default device is the card
    return FluxPipeline(
        scheduler=FlowMatchEulerDiscreteScheduler(**FLOW_MATCH), vae=vae, text_encoder=clip,
        tokenizer=StandInTokenizer(), text_encoder_2=t5, tokenizer_2=StandInTokenizer(**T5_TOKENIZER),
        transformer=transformer, **kwargs,
    )


def check_small_reference(device: str = "cuda"):
    """Phase 6: the port on the card (bf16, kernels) against the port on the
    CPU (f32, plain versions; held to JAX by the CPU tests) on one small
    SDXL-shaped pipeline with the same weights and latents."""
    import numpy as np
    import torch

    # built twice from the same seed on the CPU: identical weights
    cpu = _build_pipeline(SMALL_UNET, SMALL_VAE, SMALL_CLIP, SMALL_CLIP, "cpu", torch.float32)
    gpu = _build_pipeline(SMALL_UNET, SMALL_VAE, SMALL_CLIP, SMALL_CLIP, "cpu", torch.float32)
    gpu.to(device=torch.device(device), dtype=torch.bfloat16)
    latents = torch.from_numpy(np.random.RandomState(SEED).randn(1, 4, 16, 16).astype(np.float32))
    kwargs = dict(num_inference_steps=4, guidance_scale=GUIDANCE, output_type="np")
    ref = cpu(PROMPTS[0], latents=latents, **kwargs).images
    out = gpu(PROMPTS[0], latents=latents, **kwargs).images
    err = float(np.abs(out - ref).max())
    # bf16 weights and activations (8 significant bits) through a 4-step
    # denoise and the VAE, against f32 on the CPU: 5% of the [0, 1] range
    tol = 0.05
    RESULTS["small_reference"] = {"max_abs_err": err, "mean_abs_err": float(np.abs(out - ref).mean()), "tol": tol,
                                  "shape": list(out.shape)}
    log(f"[ref] small SDXL pipeline, card bf16 vs CPU f32: max |diff| {err:.3e}, "
        f"mean {RESULTS['small_reference']['mean_abs_err']:.3e} (tol {tol})")
    if not (out.shape == ref.shape and np.isfinite(out).all() and err <= tol):
        raise AssertionError("the port on the card disagrees with the port on the CPU")


def check_small_flux_reference(device: str = "cuda"):
    """Phase 7: the same for a small Flux-shaped pipeline: w8a8 transformer
    (K5), head_dim 128 (K1), VAE GroupNorms (K4) on the card in bf16, against
    the plain versions on the CPU in f32, with the same weights (the same int8
    transformer weights) and latents."""
    import numpy as np
    import torch

    build = lambda: _build_flux_pipeline(SMALL_FLUX, SMALL_FLUX_MIN_WEIGHT_SIZE, SMALL_FLUX_VAE,  # noqa: E731
                                         SMALL_FLUX_CLIP, SMALL_T5, "cpu", torch.float32)
    cpu, gpu = build(), build()
    gpu.to(device=torch.device(device), dtype=torch.bfloat16)
    latents = torch.from_numpy(np.random.RandomState(SEED).randn(1, 256, 64).astype(np.float32))
    kwargs = dict(height=64, width=64, num_inference_steps=4, guidance_scale=FLUX_GUIDANCE, max_sequence_length=64,
                  output_type="np")
    ref = cpu(FLUX_PROMPT, latents=latents, **kwargs).images
    reset_launches()
    out = gpu(FLUX_PROMPT, latents=latents, **kwargs).images
    launches = read_launches()
    err = float(np.abs(out - ref).max())
    # bf16 activations (8 significant bits) quantized per row to int8 on the
    # card against f32 ones on the CPU (qx flips by one wherever the two round
    # differently), through a 4-step denoise and the VAE: 5% of the [0, 1]
    # range, the SDXL check's limit
    tol = 0.05
    RESULTS["small_flux_reference"] = {"max_abs_err": err, "mean_abs_err": float(np.abs(out - ref).mean()),
                                       "tol": tol, "shape": list(out.shape), "launches": launches}
    log(f"[ref] small Flux pipeline (w8a8), card bf16 vs CPU f32: max |diff| {err:.3e}, "
        f"mean {RESULTS['small_flux_reference']['mean_abs_err']:.3e} (tol {tol}); launches {launches}")
    if not (out.shape == ref.shape and np.isfinite(out).all() and err <= tol):
        raise AssertionError("the Flux port on the card disagrees with the port on the CPU")
    forward_kernels = ("flash_attention_fwd", "group_norm", "w8a8_matmul", "w8a8_quantize_rows")
    if min(launches[name] for name in forward_kernels) <= 0:
        raise AssertionError(f"the small Flux pipeline on the card missed a kernel: {launches}")


def _small_train_unet(device):
    """SMALL_UNET in f32 from SEED, and one batch for it (text embeds [2, 77,
    64], SDXL's added conditions)."""
    import numpy as np
    import torch

    from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel

    torch.manual_seed(SEED)
    unet = UNet2DConditionModel(**SMALL_UNET).to(device)
    rng = np.random.RandomState(SEED)
    batch = {"latents": rng.randn(2, 4, 16, 16), "embeds": rng.randn(2, 77, 64), "noise": rng.randn(2, 4, 16, 16),
             "timesteps": rng.randint(0, 1000, (2,)), "text_embeds": rng.randn(2, 32),
             "time_ids": np.array([[128, 128, 0, 0, 128, 128]] * 2)}
    batch = {k: torch.from_numpy(v.astype(np.int64 if k == "timesteps" else np.float32)).to(device)
             for k, v in batch.items()}
    return unet, batch


def check_small_training(device: str = "cuda"):
    """Phase 8: one train step's loss and gradients on the card (bf16
    autocast: K1, K2, K3 at head_dim 64, K4) against the CPU (f32, the plain
    versions) from the same weights and batch, through the trainer's loss
    (`train_text_to_image.make_loss_fn`)."""
    import torch

    from diffusers_tpu_torch.schedulers import DDPMScheduler
    from diffusers_tpu_torch.training.train_text_to_image import make_loss_fn

    scheduler = DDPMScheduler()
    loss_fn = make_loss_fn(scheduler, scheduler.set_timesteps())
    grads = {}
    for dev in ("cpu", device):
        unet, batch = _small_train_unet(dev)
        reset_launches()
        loss = loss_fn(unet, batch)
        loss.backward()
        if dev != "cpu":
            torch.cuda.synchronize()
        launches = read_launches()
        missing = [n for n, p in unet.named_parameters() if p.grad is None or not bool(torch.isfinite(p.grad).all())]
        if missing:
            raise AssertionError(f"{len(missing)} parameters without a finite gradient on {dev}, e.g. {missing[:5]}")
        grads[dev] = (float(loss.detach()), torch.cat([p.grad.float().flatten().cpu() for p in unet.parameters()]), launches)
    (loss_cpu, g_cpu, _), (loss_gpu, g_gpu, launches) = grads["cpu"], grads[device]
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    cosine = float(torch.nn.functional.cosine_similarity(g_gpu.double(), g_cpu.double(), dim=0))
    # bf16 autocast (8 significant bits) through the UNet's forward and backward
    # against f32: 2% on the loss and a gradient cosine of at least 0.995
    loss_tol, cos_tol = 0.02, 0.995
    RESULTS["small_training"] = {"loss_cpu": loss_cpu, "loss_card": loss_gpu, "loss_rel_diff": rel,
                                 "grad_cosine": cosine, "loss_tol": loss_tol, "cosine_tol": cos_tol,
                                 "launches": launches}
    log(f"[train-ref] small UNet train step, card bf16 autocast vs CPU f32: loss {loss_gpu:.5f} vs {loss_cpu:.5f} "
        f"(rel {rel:.2e}, tol {loss_tol}), grad cosine {cosine:.6f} (tol {cos_tol}); launches {launches}")
    if not (rel <= loss_tol and cosine >= cos_tol):
        raise AssertionError("the training step on the card disagrees with the CPU")
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq", "group_norm"):
        if launches[name] <= 0:
            raise AssertionError(f"the small training step on the card did not launch {name}: {launches}")


def run_training(smi: str):
    """Phase 11: the full-width training path: `train_text_to_image.main`
    with the SDXL UNet at its published widths, 1024 px, batch 1, EMA off,
    for TRAIN_STEPS steps (f32 weights and AdamW, bf16 autocast), then its
    checkpoint. Launch counts are read after each step; every trainable
    parameter must have a finite gradient after the first backward."""
    import os
    import tempfile

    import torch

    from diffusers_tpu_torch.ops.module import GroupNorm
    from diffusers_tpu_torch.training import train_text_to_image

    per_step, seen = [], {}

    def callback(step, unet, loss):
        per_step.append(read_launches())
        reset_launches()
        if step == 0:
            params = [(n, p) for n, p in unet.named_parameters() if p.requires_grad]
            finite = torch.stack([torch.isfinite(p.grad).all() if p.grad is not None
                                  else torch.tensor(False, device=p.device) for _, p in params])
            bad = [n for (n, _), ok in zip(params, finite.tolist()) if not ok]
            seen.update(trainable=len(params), without_finite_grad=bad,
                        group_norms=sum(isinstance(m, GroupNorm) for m in unet.modules()))

    with tempfile.TemporaryDirectory() as out_dir:
        reset_launches()
        t0 = time.perf_counter()
        result = train_text_to_image.main(
            ["--unet", "sdxl", "--resolution", str(RESOLUTION), "--batch_size", "1", "--max_train_steps",
             str(TRAIN_STEPS), "--lr_warmup_steps", "1", "--seed", str(SEED), "--output_dir", out_dir,
             "--checkpointing_steps", str(10 * TRAIN_STEPS)], callback=callback)
        seconds = time.perf_counter() - t0
        saved = sorted(os.listdir(os.path.join(out_dir, "unet")))
        saved_gb = sum(os.path.getsize(os.path.join(out_dir, "unet", f)) for f in saved) / 1e9

    expected = {"flash_attention_fwd": SDXL_TRAIN_ATTENTIONS_PER_STEP,
                "flash_attention_bwd_dkdv": SDXL_TRAIN_ATTENTIONS_PER_STEP,
                "flash_attention_bwd_dq": SDXL_TRAIN_ATTENTIONS_PER_STEP,
                "group_norm": seen["group_norms"], "w8a8_matmul": 0, "w8a8_quantize_rows": 0}
    step_ms = result["step_ms"]
    log(f"[train] SDXL UNet ({result['parameters'] / 1e9:.3f} B parameters, f32 + AdamW, bf16 autocast), 1024 px, "
        f"batch 1: {TRAIN_STEPS} steps in {seconds:.1f} s with the build and the checkpoint")
    for i, (ms, counts, loss) in enumerate(zip(step_ms, per_step, result["losses"])):
        log(f"[train] step {i}: {ms:.1f} ms (CUDA events), loss {loss:.5f}, launches {counts}")
    log(f"[train] {smi}: median {result['median_step_ms']:.1f} ms per step (steps 1-{TRAIN_STEPS - 1}), peak memory "
        f"{result['peak_memory_gb']:.1f} GB; {seen['trainable']} trainable parameters, "
        f"{len(seen['without_finite_grad'])} without a finite gradient after the first backward; "
        f"checkpoint {saved} ({saved_gb:.2f} GB)")
    RESULTS["training"] = {
        "card": smi, "unet": "sdxl", "resolution": RESOLUTION, "batch_size": 1, "steps": TRAIN_STEPS,
        "step_ms": step_ms, "median_step_ms": result["median_step_ms"], "peak_memory_gb": result["peak_memory_gb"],
        "losses": result["losses"], "parameters": result["parameters"], "launches_per_step": per_step,
        "expected_launches_per_step": expected, "trainable_parameters": seen["trainable"],
        "without_finite_grad": seen["without_finite_grad"], "checkpoint_files": saved,
        "checkpoint_gb": saved_gb, "seconds": seconds,
    }
    if seen["without_finite_grad"]:
        raise AssertionError(f"{len(seen['without_finite_grad'])} trainable parameters have no finite gradient "
                             f"after the first backward, e.g. {seen['without_finite_grad'][:5]}")
    if not all(map(math.isfinite, result["losses"])):
        raise AssertionError(f"non-finite training loss: {result['losses']}")
    for i, counts in enumerate(per_step):
        if counts != expected:
            raise AssertionError(f"step {i} launched {counts}, expected {expected}")
    if "diffusion_pytorch_model.safetensors.index.json" not in saved or len(saved) < 3:
        raise AssertionError(f"the checkpoint was not written as sharded safetensors: {saved}")
    return {name: sum(c[name] for c in per_step) for name in expected}


def run_pipeline(smi: str):
    """Phase 9: one full-width SDXL 1024 px request through the kernels."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    pipe = _build_pipeline(SDXL_UNET, SDXL_VAE, CLIP_L, CLIP_BIGG, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for m in (pipe.unet, pipe.vae, pipe.text_encoder, pipe.text_encoder_2)
                   for p in m.parameters())
    log(f"[sdxl] built SDXL at full width on the card: {n_params / 1e9:.3f} B parameters, bf16, {build_s:.1f} s")

    latents_seen = []
    hook = pipe.vae.post_quant_conv.register_forward_pre_hook(lambda mod, args: latents_seen.append(args[0]))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    images = pipe(PROMPTS[0], height=RESOLUTION, width=RESOLUTION, num_inference_steps=STEPS,
                  guidance_scale=GUIDANCE, generator=torch.Generator(device="cuda").manual_seed(SEED),
                  output_type="pil").images
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    hook.remove()
    image = np.asarray(images[0])
    if len(images) != 1 or image.shape != (RESOLUTION, RESOLUTION, 3) or image.dtype != np.uint8:
        raise AssertionError(f"bad uint8 image {image.shape} {image.dtype}")
    if not bool(torch.isfinite(latents_seen[-1]).all()):
        raise AssertionError("non-finite latents")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    expected_k1 = 140 * STEPS  # 70 BasicTransformerBlocks x 2 attentions per UNet call
    log(f"[sdxl] launches: {launches} (flash_attention_fwd expected {expected_k1})")
    if launches["flash_attention_fwd"] != expected_k1:
        raise AssertionError(f"flash_attention_fwd launched {launches['flash_attention_fwd']} times, "
                             f"expected {expected_k1}")
    if launches["group_norm"] <= 0:
        raise AssertionError("group_norm was not launched on the SDXL path")

    # UNet forward at b=2 (one CFG step), bf16, 1024 px
    dev = torch.device("cuda")
    sample = torch.randn(2, 4, 128, 128, device=dev, dtype=torch.bfloat16)
    ehs = torch.randn(2, 77, 2048, device=dev, dtype=torch.bfloat16)
    cond = {"text_embeds": torch.randn(2, 1280, device=dev, dtype=torch.bfloat16),
            "time_ids": torch.tensor([[1024, 1024, 0, 0, 1024, 1024]] * 2, device=dev, dtype=torch.float32)}
    t = torch.tensor(500.0, device=dev)
    with torch.no_grad():
        unet_ms = time_ms(lambda: pipe.unet(sample, t, ehs, added_cond_kwargs=cond), iters=10)
    log(f"[sdxl] {smi}: {seconds:.3f} s/image, image mean {image.mean():.1f}, UNet forward b=2 {unet_ms:.2f} ms, "
        f"peak memory {peak_gb:.1f} GB")
    RESULTS["pipeline"] = {
        "card": smi, "steps": STEPS, "resolution": RESOLUTION, "guidance_scale": GUIDANCE,
        "seconds_per_request": [seconds], "unet_forward_b2_ms": unet_ms, "peak_memory_gb": peak_gb,
        "build_seconds": build_s, "parameters": n_params, "launches": launches,
    }
    return launches


def run_flux_pipeline(smi: str):
    """Phase 10: one full-width Flux.1-dev 1024 px request (28 steps, guidance
    3.5) through `FluxPipeline.__call__`: the w8a8 transformer on K5, its
    attention on K1 at head_dim 128, the VAE's GroupNorms on K4."""
    import numpy as np
    import torch

    from diffusers_tpu_torch.ops.module import W8A8Linear

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = _build_flux_pipeline(FLUX_DEV, W8A8_MIN_WEIGHT_SIZE, FLUX_VAE, CLIP_L, T5_XXL, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tr = pipe.transformer
    n_w8a8 = sum(isinstance(m, W8A8Linear) for m in tr.modules())
    n_params = {name: sum(p.numel() for p in getattr(pipe, name).parameters())
                for name in ("transformer", "text_encoder_2", "text_encoder", "vae")}
    int8_gb = sum(m.weight.numel() for m in tr.modules() if isinstance(m, W8A8Linear)) / 1e9
    resident_gb = torch.cuda.memory_allocated() / 1e9
    log(f"[flux] built Flux.1-dev at full width on the card in {build_s:.1f} s: parameters "
        f"{ {k: f'{v / 1e9:.3f} B' for k, v in n_params.items()} }; {n_w8a8} w8a8 Linears ({int8_gb:.2f} GB int8); "
        f"{resident_gb:.1f} GB resident, build peak {build_peak_gb:.1f} GB")
    if n_w8a8 != FLUX_W8A8_PER_STEP:
        raise AssertionError(f"{n_w8a8} w8a8 Linears in the transformer, expected {FLUX_W8A8_PER_STEP}")

    # per-step transformer time on CUDA events, the latents going into the VAE, and its output
    spans, seen = [], {}

    def record(event_list):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        event_list.append(event)

    def on_start(mod, args):
        spans.append([])
        record(spans[-1])

    pre = tr.register_forward_pre_hook(on_start)
    post = tr.register_forward_hook(lambda mod, args, out: record(spans[-1]))
    vae_in = pipe.vae.decoder.register_forward_pre_hook(lambda mod, args: seen.__setitem__("latents", args[0]))
    vae_out = pipe.vae.decoder.register_forward_hook(lambda mod, args, out: seen.__setitem__("decoded", out))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    images = pipe(FLUX_PROMPT, height=RESOLUTION, width=RESOLUTION, num_inference_steps=FLUX_STEPS,
                  guidance_scale=FLUX_GUIDANCE, generator=torch.Generator(device="cuda").manual_seed(SEED),
                  max_sequence_length=FLUX_MAX_SEQUENCE_LENGTH, output_type="pil").images
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    for h in (pre, post, vae_in, vae_out):
        h.remove()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [start.elapsed_time(end) for start, end in spans]

    image = np.asarray(images[0])
    if len(images) != 1 or image.shape != (RESOLUTION, RESOLUTION, 3) or image.dtype != np.uint8:
        raise AssertionError(f"bad uint8 image {image.shape} {image.dtype}")
    finite = {k: bool(torch.isfinite(v).all()) for k, v in seen.items()}
    if set(finite) != {"latents", "decoded"} or not all(finite.values()):
        raise AssertionError(f"non-finite latents or image: {finite}")
    expected = {"w8a8_matmul": n_w8a8 * FLUX_STEPS, "w8a8_quantize_rows": n_w8a8 * FLUX_STEPS,
                "flash_attention_fwd": FLUX_ATTENTIONS_PER_STEP * FLUX_STEPS}
    log(f"[flux] launches: {launches} (expected {expected}, group_norm > 0)")
    for name, count in expected.items():
        if launches[name] != count:
            raise AssertionError(f"{name} launched {launches[name]} times on the Flux path, expected {count}")
    if launches["group_norm"] <= 0:
        raise AssertionError("group_norm was not launched on the Flux path")
    if len(step_ms) != FLUX_STEPS:
        raise AssertionError(f"{len(step_ms)} transformer calls, expected {FLUX_STEPS}")
    mean_step = sum(step_ms) / len(step_ms)
    log(f"[flux] {smi}: {seconds:.3f} s/image (1024 px, {FLUX_STEPS} steps), transformer {mean_step:.1f} ms/step "
        f"(CUDA events; min {min(step_ms):.1f}, max {max(step_ms):.1f}), peak memory {peak_gb:.1f} GB, "
        f"latents and image finite, image mean {image.mean():.1f}")
    RESULTS["flux_pipeline"] = {
        "card": smi, "steps": FLUX_STEPS, "resolution": RESOLUTION, "guidance_scale": FLUX_GUIDANCE,
        "seconds_per_request": seconds, "transformer_ms_per_step": step_ms, "transformer_ms_per_step_mean": mean_step,
        "peak_memory_gb": peak_gb, "build_peak_memory_gb": build_peak_gb, "resident_gb": resident_gb,
        "int8_weight_gb": int8_gb, "build_seconds": build_s, "parameters": n_params, "w8a8_linears": n_w8a8,
        "launches": launches, "expected_launches": expected, "image_mean": float(image.mean()),
    }
    return launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=None, help="directory for chip_smoke.json")
    args = parser.parse_args()
    t_start = time.perf_counter()
    smi = setup()
    import gc

    import torch

    build_kernels()
    summary = check_kernels()
    summary.update(check_w8a8())
    summary.update(check_flash_bwd())
    check_small_reference()
    check_small_flux_reference()
    check_small_training()
    sdxl = run_pipeline(smi)
    torch.cuda.empty_cache()
    flux = run_flux_pipeline(smi)
    gc.collect()
    torch.cuda.empty_cache()
    training = run_training(smi)
    paths = {"sdxl": sdxl, "flux": flux, "training": training}
    RESULTS["launches_by_path"] = paths

    meta = {
        "flash_attention_fwd": ("cuda", "diffusers_tpu_torch/csrc/flash_attention_fwd.cu",
                                "diffusers_tpu/ops/pallas/flash_attention_bwd.py:141",
                                "q/k/v (1, 4608, 24, 128) bf16: Flux joint attention"),
        "flash_attention_bwd_dkdv": ("cuda", "diffusers_tpu_torch/csrc/flash_attention_bwd.cu",
                                     "diffusers_tpu/ops/pallas/flash_attention_bwd.py:257",
                                     "one SDXL train step (1024 px, b=1): the sum over its 140 launches at their "
                                     "4 shapes; library: the SDPA backward (dq, dk, dv together)"),
        "flash_attention_bwd_dq": ("cuda", "diffusers_tpu_torch/csrc/flash_attention_bwd.cu",
                                   "diffusers_tpu/ops/pallas/flash_attention_bwd.py:285",
                                   "one SDXL train step (1024 px, b=1): the sum over its 140 launches at their "
                                   "4 shapes; library: the SDPA backward (dq, dk, dv together)"),
        "group_norm": ("triton", "diffusers_tpu_torch/ops/triton/group_norm.py",
                       "diffusers_tpu/ops/pallas/group_norm.py:150", "(2, 320, 128, 128) bf16 + SiLU"),
        "w8a8_matmul": ("cuda", "diffusers_tpu_torch/csrc/w8a8_matmul.cu",
                        "diffusers_tpu/ops/pallas/quantized_matmul.py:85",
                        "one Flux.1-dev denoise step: the sum over its 500 launches at their shapes"),
        "w8a8_quantize_rows": ("cuda", "diffusers_tpu_torch/csrc/w8a8_matmul.cu",
                               "diffusers_tpu/ops/pallas/quantized_matmul.py:31",
                               "one Flux.1-dev denoise step: the sum over its 500 launches at their shapes"),
    }
    kernels = []
    for name, (route, source, replaces, shape) in meta.items():
        err, t = summary[name]
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": sum(path[name] for path in paths.values()), "max_abs_err": err, "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"], "shape": shape})
    RESULTS["kernels"] = kernels
    RESULTS["seconds"] = time.perf_counter() - t_start
    log(f"[done] {RESULTS['seconds']:.1f} s")
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke.json").write_text(json.dumps(RESULTS, indent=2))

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

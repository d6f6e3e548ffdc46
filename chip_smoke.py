"""Smoke run of the PyTorch + CUDA port (`diffusers_tpu_torch`) on one NVIDIA
H100: builds the port's hand-written kernels from this checkout, holds each
against its plain PyTorch version at the shapes of the main paths, checks the
port on the card against the port on the CPU at a small size, then drives the
two main paths through the public pipelines, with random weights made from a
seed on the card:

  * SDXL: one full-width 1024 px text-to-image request (30 Euler steps, CFG
    5.0, bf16) through `StableDiffusionXLPipeline.__call__` (kernels K1, K4);
  * Flux.1-dev: one full-width 1024 px request (28 flow-match steps, guidance
    3.5; the transformer w8a8, T5-XXL, CLIP-L and the VAE bf16) through
    `FluxPipeline.__call__` (kernels K5 with its row quantization, K1 at
    head_dim 128, K4),

and shows, from launch counts reset just before each path and read just
after, that each path ran through its kernels.

    python3 chip_smoke.py [--out DIR]

Exits non-zero, printing no result, when no CUDA device is visible or when it
is not next to the `diffusers_tpu_torch` package. With `--out DIR`, detailed
results also go to `DIR/chip_smoke.json`. The last three lines of standard
output are the per-kernel JSON summary, the card's `nvidia-smi` name and
power limit, then
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Precision: the pipelines run in bf16. float32 references run in full float32:
this script sets `torch.backends.cuda.matmul.allow_tf32 = False` and
`torch.backends.cudnn.allow_tf32 = False`.
"""

from __future__ import annotations

import argparse
import json
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
    sum_k p|v|) covers f32 sums in another order and `__expf`.

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
    from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention_full
    from diffusers_tpu_torch.ops.cuda.w8a8_matmul import quantize_rows, w8a8_matmul_2d
    from diffusers_tpu_torch.ops.triton.group_norm import group_norm

    return {"flash_attention_fwd": flash_attention_full, "group_norm": group_norm,
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


def build_kernels():
    """Phase 2: build the CUDA C++ kernels with nvcc (sm_90a), one nvcc per
    source, all at once."""
    from diffusers_tpu_torch.ops.cuda import _build, flash_attention, w8a8_matmul

    modules = (flash_attention, w8a8_matmul)
    t0 = time.perf_counter()
    _build.build_all([m.SOURCE for m in modules])
    for m in modules:
        m.load_library()
    seconds = time.perf_counter() - t0
    RESULTS["build"] = {"seconds": seconds}
    log(f"[build] {', '.join(m.SOURCE.name for m in modules)} -> sm_90a in {seconds:.1f} s (in parallel)")
    for m in modules:
        ptxas = [line.strip() for line in _build.build_log(m.SOURCE).splitlines() if "registers" in line or "spill" in line]
        RESULTS["build"][m.SOURCE.name] = ptxas
        for line in ptxas:
            log(f"[build]   {m.SOURCE.name}: {line}")


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
    ]
    k1_errs, k1_times = [], {}
    for label, qshape, sk, opt, timed in attn_cases:
        dtype = opt.get("dtype", torch.bfloat16)
        b, sq, h, d = qshape
        q = randn(b, sq, h, d, dtype=dtype, scale=2.0)
        k = randn(b, sk, h, d, dtype=dtype)
        v = randn(b, sk, h, d, dtype=dtype)
        mask = None
        if opt.get("mask"):
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
                       tflops=flops / ms / 1e9)
            k1_times[label] = row
        log(f"[K1] {label}: err vs f32 {err32:.3e}, vs plain {err16:.3e}; share of the per-element bound "
            f"{used32:.3f} / {used16:.3f}"
            + (f", kernel {row['ms']:.3f} ms ({row['tflops']:.1f} TFLOP/s), plain {row['plain_ms']:.3f} ms, "
               f"SDPA {row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms" if timed else ""))
        if not (used32 <= 1.0 and used16 <= 1.0 and torch.isfinite(out).all()):
            raise AssertionError(f"flash_attention_fwd disagrees with its plain version on {label}")
        if timed:
            # controls: outputs of a partly wrong kernel must break the bound
            t0 = (sk // 2) // 64 * 64  # one 64-key kv tile of the kernel
            keep = torch.cat([torch.arange(t0, device=dev), torch.arange(min(t0 + 64, sk), sk, device=dev)])
            dropped = flash_attention_full(q, k[:, keep], v[:, keep])
            misscaled = out.clone()
            misscaled[:, ::64] *= 1 + 2.0**-5  # every 64th query row 3% off
            controls = {"kv_tile_dropped": float(((dropped.float() - ref32).abs() / bound32).max()),
                        "rows_misscaled": float(((misscaled.float() - ref32).abs() / bound32).max())}
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
    lse_tol = 1e-3  # f32 online softmax with __expf against exact f32 logsumexp
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

    from diffusers_tpu_torch.ops.cuda.w8a8_matmul import (
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
                             "q_ms", "q_plain_ms", "q_bound_ms")}
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
        # control: the kernel without one 64-wide K tile must break the limit
        skipped = w8a8_matmul_2d(qx, qw, xs, ws, torch.bfloat16, bias, _skip_k_tile=(k // 64) // 2)
        control = float(((skipped.float() - ref.float()).abs() / ulp).max())

        ms, plain_ms = time_pair(lambda: w8a8_matmul_2d(qx, qw, xs, ws, torch.bfloat16, bias),
                                 lambda: w8a8_matmul_2d_plain(qx, qw, xs, ws, torch.bfloat16, bias),
                                 iters=20, plain_iters=2)
        q_ms, q_plain_ms = time_pair(lambda: quantize_rows(x), lambda: quantize_rows_plain(x), iters=20)
        # nearest library calls: cuBLAS int8 (`torch._int_mm`, which takes M > 16: M padded to 32)
        # with the same epilogue, and a bf16 matmul of the dequantized weight
        mp = max(m, 32)
        qx_pad = torch.zeros(mp, k, dtype=torch.int8, device=dev)
        qx_pad[:m] = qx
        xs_pad = torch.ones(mp, 1, device=dev)
        xs_pad[:m] = xs
        library_ms = time_ms(
            lambda: (torch._int_mm(qx_pad, qw.t()).float() * xs_pad * ws).to(torch.bfloat16) + bias, iters=20)
        w_bf16 = (qw.float() * ws[:, None]).to(torch.bfloat16)
        bf16_ms = time_ms(lambda: torch.nn.functional.linear(x, w_bf16, bias), iters=20)
        bms, by = bound_ms(m * k + n * k + 4 * (m + n) + 2 * n + 2 * m * n, 2.0 * m * n * k, PEAK_INT8_OPS)
        q_bms, _ = bound_ms(2 * m * k + m * k + 4 * m, 0, PEAK_INT8_OPS)

        row = {"kernel": "w8a8_matmul", "m": m, "k": k, "n": n, "launches_per_step": per_step,
               "quantize_rows_bit_equal": q_equal, "max_abs_err_vs_plain": err, "max_ulps_vs_plain": used,
               "control_skipped_k_tile_max_ulps": control, "ms": ms, "plain_ms": plain_ms,
               "int_mm_epilogue_ms": library_ms, "bf16_matmul_ms": bf16_ms, "bound_ms": bms, "bound_by": by,
               "tops": 2.0 * m * n * k / ms / 1e9, "quantize_ms": q_ms, "quantize_plain_ms": q_plain_ms,
               "quantize_bound_ms": q_bms}
        cases.append(row)
        log(f"[K5] M {m} K {k} N {n} (x{per_step}/step): qx bit-equal {q_equal}; err {err:.3e} ({used:.2f} ulp, "
            f"control {control:.1f} ulp); kernel {ms:.4f} ms ({row['tops']:.0f} TOPS), plain {plain_ms:.3f}, "
            f"_int_mm+epilogue {library_ms:.4f}, bf16 matmul {bf16_ms:.4f}, bound {bms:.4f} ({by}); "
            f"quantize {q_ms:.4f} ms (plain {q_plain_ms:.4f}, bound {q_bms:.4f})")
        if not (q_equal and used <= 1.0 and torch.isfinite(y).all()):
            raise AssertionError(f"w8a8 kernels disagree with their plain versions at M {m} K {k} N {n}")
        if control <= 1.0:
            raise AssertionError(f"the w8a8 limit does not reject a skipped K tile at M {m} K {k} N {n}")
        max_err = max(max_err, err)
        for key, value in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                           ("bf16_matmul_ms", bf16_ms), ("bound_ms", bms), ("q_ms", q_ms),
                           ("q_plain_ms", q_plain_ms), ("q_bound_ms", q_bms)):
            step[key] += per_step * value
    assert sum(s[3] for s in FLUX_W8A8_SHAPES) == FLUX_W8A8_PER_STEP
    RESULTS["w8a8_cases"] = cases
    RESULTS["w8a8_per_denoise_step"] = step
    log(f"[K5] one Flux.1-dev denoise step ({FLUX_W8A8_PER_STEP} launches): kernel {step['ms']:.2f} ms, plain "
        f"{step['plain_ms']:.1f} ms, _int_mm+epilogue {step['library_ms']:.2f} ms, bf16 matmul "
        f"{step['bf16_matmul_ms']:.2f} ms, bound {step['bound_ms']:.2f} ms; quantize_rows {step['q_ms']:.2f} ms "
        f"(bound {step['q_bound_ms']:.2f} ms)")
    return {
        "w8a8_matmul": (max_err, {"ms": step["ms"], "plain_ms": step["plain_ms"], "library_ms": step["library_ms"],
                                  "bound_ms": step["bound_ms"], "bound_by": "operations"}),
        "w8a8_quantize_rows": (0.0, {"ms": step["q_ms"], "plain_ms": step["q_plain_ms"], "library_ms": None,
                                     "bound_ms": step["q_bound_ms"], "bound_by": "bytes"}),
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
    """Phase 5: the port on the card (bf16, kernels) against the port on the
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
    """Phase 6: the same for a small Flux-shaped pipeline: w8a8 transformer
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
    if min(launches.values()) <= 0:
        raise AssertionError(f"the small Flux pipeline on the card missed a kernel: {launches}")


def run_pipeline(smi: str):
    """Phase 7: one full-width SDXL 1024 px request through the kernels."""
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
    """Phase 8: one full-width Flux.1-dev 1024 px request (28 steps, guidance
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
    import torch

    build_kernels()
    summary = check_kernels()
    summary.update(check_w8a8())
    check_small_reference()
    check_small_flux_reference()
    sdxl = run_pipeline(smi)
    torch.cuda.empty_cache()
    flux = run_flux_pipeline(smi)
    RESULTS["launches_by_path"] = {"sdxl": sdxl, "flux": flux}

    meta = {
        "flash_attention_fwd": ("cuda", "diffusers_tpu_torch/csrc/flash_attention_fwd.cu",
                                "diffusers_tpu/ops/pallas/flash_attention_bwd.py:141",
                                "q/k/v (1, 4608, 24, 128) bf16: Flux joint attention"),
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
                        "launches": sdxl[name] + flux[name], "max_abs_err": err, "ms": t["ms"],
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

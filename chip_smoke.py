"""Smoke run of the PyTorch + CUDA port (`diffusers_tpu_torch`) on one NVIDIA
H100: builds the port's hand-written kernels from this checkout, holds each
against its plain PyTorch version at the shapes of the main paths, checks the
port on the card against the port on the CPU at a small size (every cache
config and callback, the image-conditioned pipelines, the SD3 pipelines and
the Wan pipelines, VACE, Animate and SkyReels-V2, the SD 1.x pipelines, the
T2I-Adapter, each IP-Adapter head, the Flux family with the int4 Linear
included, and the SD, SDXL, Union and SD3 ControlNet pipelines), then
drives the main paths through their public entry points, with random weights
made from a seed on the card:

  * SDXL: one full-width 1024 px text-to-image request (30 Euler steps, CFG
    5.0, bf16) through `StableDiffusionXLPipeline.__call__` (kernels K1, K4);
    then, on the same pipeline, the headline request of bench.py with
    `TaylorSeerCacheConfig(cache_interval=10, disable_cache_before_step=2,
    max_order=2)` (5 of 30 steps call the UNet), one with FasterCache, one
    with MagCache (flat ratios) and one with `SDXLCFGCutoffCallback`; then,
    on its components, one img2img request (strength 0.3), one inpaint
    request with a full-width 9-channel inpainting UNet (strength 0.99) and
    one ControlNet request with the full-width SDXL ControlNet
    (diffusers/controlnet-canny-sdxl-1.0's widths), which is first written
    with `save_pretrained` and read back onto the card by `from_pretrained`
    (bit-equal), on synthetic numpy inputs (an image, a mask, an edge map);
  * Flux.1-dev: one full-width 1024 px request (28 flow-match steps, guidance
    3.5; the transformer w8a8, T5-XXL, CLIP-L and the VAE bf16) through
    `FluxPipeline.__call__` (kernels K5 with its row quantization, K1 at
    head_dim 128, K4); then one request each with TaylorSeer,
    FirstBlockCache, Pyramid Attention Broadcast and MagCache;
  * the rest of the Flux family at FLUX.1-dev's full width (phase 13c), on
    the same pipeline at 1024 px: img2img, inpaint, Kontext with a 1024 px
    reference (KONTEXT_STEPS; K1 at 8,704 tokens), Kontext inpaint, ControlNet at
    InstantX/FLUX.1-dev-Controlnet-Canny's widths (plain, img2img, inpaint)
    and its Union form, Redux (SigLIP so400m and the Redux encoder feeding a
    request), bench.py's int4 T5-XXL (quantized in place on the card; its
    bytes, encode time and embeds beside the bf16 tower's, one request),
    then FLUX.1-Fill-dev (FILL_STEPS) and FLUX.1-Canny-dev (Control, its
    img2img and inpaint) at full depth;
  * SD3.5 Medium: its published widths (24 layers, 13 dual-attention, 24 x
    64 heads; CLIP-L, bigG, T5-XXL; the 16-channel VAE) served by the
    port's HTTP server (`diffusers_tpu_torch.serving.server`, seed 0) at its
    defaults (1024 px, 28 flow-match steps, CFG 7.0): one request, then two
    that coalesce into one batch of 2 (kernels K1 at head_dim 64 over the
    ragged 4429-token joint stream and the 4096-token attn2, K4); the PNGs
    read back with the port's decoder, the first equal to a direct pipeline
    call from the same seed; then one TaylorSeer and one FirstBlockCache
    request on the pipeline;
  * Wan 2.1 text-to-video: Wan2.1-T2V-1.3B at its published widths (30
    layers, 12 x 128 heads; UMT5-XXL; the 3-D causal VAE, decoded in
    temporal chunks) through `WanPipeline.__call__`: one 480 x 832, 81-frame
    request (32,760 tokens; WAN_STEPS UniPC steps, cut from upstream's 50,
    CFG 5.0 as two batch-1 calls a step, 512 text tokens; kernel K1 at
    head_dim 128, 60 a call), then one
    TaylorSeer(10, 2, 2) request, then video-to-video on the same pipeline
    (`WanVideoToVideoPipeline`, a synthetic 81-frame video, strength 0.8);
  * Wan image-to-video: Wan2.1-I2V-14B-480P at its published widths and
    depth (40 layers, 40 x 128 heads, 36 input channels, the CLIP image
    branch; a CLIP ViT-H/14; phase 17's UMT5-XXL and VAE, whose chunked
    encode takes the 81-frame clip) through
    `WanImageToVideoPipeline.__call__`: one 480 x 832, 81-frame request of
    WAN_I2V_STEPS step from a synthetic image (K1 120 a call: self, text and image
    cross attention in each block); then first-last-frame (Wan2.1-FLF2V's
    514-token image table) and Wan 2.2's two experts (boundary 0.9) at
    full width with the depth cut to 2 blocks;
  * the rest of the Wan family on phase 17's UMT5-XXL and VAE: Wan-VACE at
    Wan2.1-VACE-1.3B's widths and depth (30 blocks and 15 VACE blocks) through
    `WanVACEPipeline.__call__`, one 480 x 832 x 81 request with a synthetic
    control video and mask (CFG as one batch-2 call a step, K1 90 a call);
    Wan2.2-Animate-14B at full width cut to 5 blocks (the motion encoder at
    512 px, the face encoder, one face adapter; a CLIP ViT-H/14) through
    `WanAnimatePipeline.__call__` at 720 x 1280: one 77-frame segment in
    animate mode, then one replace segment; SkyReels-V2-T2V-14B-540P at full
    width cut to 2 blocks through `SkyReelsV2Pipeline.__call__`, one 544 x
    960 x 97 request (51,000 tokens);
  * the rest of the SD slice: Stable Diffusion 1.5 at its published widths
    (phase 23) through `StableDiffusionPipeline.__call__`, 512 px, CFG 7.5:
    one PNDM request (50 steps), one DDIM request, img2img, a 9-channel
    inpaint and one T2I-Adapter request (TencentARC/t2iadapter_canny_sd15v2's
    widths) from a synthetic edge map (kernel K4; its heads of 40, 80 and
    160 run `native`); IP-Adapter Plus and base on phase 11's SDXL (phase
    12c; h94/IP-Adapter's SDXL widths, a CLIP ViT-H/14), one 1024 px request
    each (K1 also in the 70 image cross attentions and the resampler), then
    the adapter unloaded and phase 11's image again, bit-equal; whole and
    tiled decodes of 1024 and 2048 px latents on Flux's VAE and one Flux
    request with tiling on (phase 13b);
  * the ControlNet family (phase 24; each request warmed up once, then
    timed on CUDA events, a denoiser and a ControlNet call timed apart): on
    phase 11's SDXL at SDXL_CONTROLNET_FAMILY_STEPS (10; cut from 30),
    ControlNet img2img (0.3) and inpaint (0.99), then
    ControlNet-Union (xinsir/controlnet-union-sdxl-1.0's layout) text-to-
    image, img2img and inpaint and two Union nets as a
    MultiControlNetUnionModel; on phase 23's SD 1.5, a ControlNet at
    lllyasviel/control_v11p_sd15_canny's widths, text-to-image, img2img,
    inpaint and two nets as a Multi-ControlNet; on phase 16's SD3.5 Medium,
    the SD3 ControlNet built by `SD3ControlNetModel.from_transformer` (12
    joint blocks with the base's dual attention), 28 steps (kernels K1, K4;
    SD 1.5's heads run `native`); one request of each family first runs 4
    steps on the kernels and on the plain routes on the card, the two images
    within 0.05;
  * the other quantized layers and the rest of the SD family: phase 5b
    holds the per-tensor int8 routes (the Linear and the im2col conv on
    K5's GEMM, K and N padded) to their plain versions bit for bit at
    SDXL's shapes; phase 12d quantizes a copy of phase 11's UNet with
    `Int8DynamicActConfig()` (131 per-row Linears and 40 int8 convs: K5
    171 a UNet call) and answers phase 11's request with it, then runs one
    UNet call each under `impl="xla"`, `Int8WeightOnlyConfig` and
    `Fp8WeightOnlyConfig`; phase 12e runs SDXL InstructPix2Pix at 768 px
    with an 8-channel SDXL UNet (triple CFG); phase 23b runs, on phase 23's
    SD 1.5 components, InstructPix2Pix at 512 px, LCM at 768 px (4 steps),
    TCD (4 steps, eta 0.3) and the x4 upscaler at its published widths from
    128 to 512 px (its UNet's noise-level class embeddings; K1 at its heads
    of 64 and 128); step counts cut where marked (`IP2P_STEPS`,
    `UPSCALE_STEPS`); phase 10i runs all of them small, card against CPU;
  * pipelines from disk (phase 18): SDXL written with `save_pretrained` and
    read back with `StableDiffusionXLPipeline.from_pretrained(dir,
    dtype=torch.bfloat16)`, one request; SD3.5 Medium given real tokenizers
    (a CLIP vocabulary and a T5 Unigram model written on the spot), saved
    (T5-XXL in transformers shards) and served by `serve()` from
    `MODEL_PATH`, one request; Flux.1-dev at full width cut to 2 dual and 4
    single blocks, saved in bf16 and loaded with
    `PipelineQuantizationConfig(quant_mapping={"transformer":
    Int8DynamicActConfig()})` (w8a8 on load, kernel K5), one request; the
    four small pipelines round-tripped on the card; weights bit-equal and
    images within 2 uint8 levels of the in-memory pipelines';
  * guidance (phase 25, and 10j small, card against CPU): on phase 11's
    SDXL, `StableDiffusionXLPAGPipeline.from_pipe` at 1024 px, 30 steps,
    CFG 5.0, pag_scale 3.0 on the "mid" layers (two UNet calls a step: the
    CFG pair at b=2, the perturbed conditional at b=1; K1 270 and K4 92 a
    step) beside the dense request, PAG img2img and PAG ControlNet (phase
    12b's net) at cut steps, one FreeU request and one UNet call under SEG;
    on phase 23's SD 1.5, the PAG pipeline (PNDM, 50 steps); on phase 16's
    SD3.5 Medium, the PAG pipeline on block 13 (28 steps, CFG 7.0; K1 74 a
    step, the perturbed joint attention through K1 under the identity mask,
    which phase 3 holds to its plain version and times against the open
    call) and one transformer call with blocks 7-9 skipped (SLG);
  * the loaders (phase 26): on phase 11's SDXL, two seeded rank-16 PEFT
    LoRAs on the UNet's attention and feed-forward Linears and both text
    encoders through `load_lora_weights`, a request with one, one with
    `set_adapters` of both at (0.3, 0.7), a kohya SGM-layout twin fused
    bit-equal, and after `disable_lora` a request bit-equal to the dense
    one (K1 140, K4 46 a step each); the UNet, VAE and CLIP-L written as one
    LDM-layout single file and read back through `loaders.single_file`,
    bit-equal in state and in a request; a 2-vector textual inversion in
    CLIP-L and a request that uses it; on phase 13's Flux.1-dev, an XLabs
    LoRA refused by the w8a8 transformer, then fused into a bf16 FLUX.1-dev
    transformer before `quantize_w8a8(model, 2**20)`, one call held to its
    plain routes (K1 57, K5 500); the Flux, SD3.5 Medium and Wan I2V-14B
    transformers at full width and 2 blocks written in their original
    layouts and read back, bit-equal in state and in a forward;
  * Qwen-Image (phase 27): its published widths (the 20.4 B double-stream
    transformer, the 7.07 B Qwen2.5-VL text tower, the Wan-family VAE) with
    a Qwen2 BPE tokenizer written on the spot, through
    `QwenImagePipeline.__call__`: one 1024 px request of QWEN_STEPS steps
    (true CFG 4.0 as one batch-2 call a step over 1,024 padded text + 4,096
    image tokens; K1 60 a call under the key-padding bias), then img2img
    and inpaint (3 and 2 calls);
  * LTX-Video (phase 28): the 2 B DiT at LTX-Video 0.9.x's widths with
    T5-XXL and a 0.9.1-style timestep-conditioned VAE, through
    `LTXPipeline.__call__`: one 512 x 704 x 161 request of LTX_STEPS steps
    (CFG 3.0 as one batch-2 call a step over 7,392 tokens; K1 56 a call)
    with the whole-video decode, image-to-video and a condition request
    (an image at frame 0, a 17-frame video at frame 80), and the 0.9.7
    spatial latent upsampler on the request's latents (K4 17 a call);
    phases 10k and 10l run both families small, card against CPU, with
    every LTX cache; phase 27 also runs the Qwen-Image ControlNet (5 blocks
    by `from_transformer`, residual paths random) into one transformer call
    at b=2 (K1 65);
  * HunyuanVideo (phase 29): the 13 B transformer, llava-llama-3-8b's text
    tower and CLIP-L, the causal 3-D VAE, through
    `HunyuanVideoPipeline.__call__`: one 320 x 512 x 61 request of
    HUNYUAN_STEPS steps (guidance 6.0 distilled: one batch-1 call a step
    over 10,240 image + 256 text tokens; K1 62 a call: 60 joint attentions
    under the key-padding bias and the token refiner's 2) with the decode
    (K4 at every GroupNorm of the decoder; the mid block's frame-causal
    attention at d = 512 runs `native`), and a TaylorSeer request; FramePack
    (phase 30): its transformer in place of HunyuanVideo's, SigLIP so400m,
    phase 29's tower, CLIP-L and VAE, one 832 x 480 image-to-video request
    of 2 sections in each sampling order, at the joint attention length and
    VAE spans that phases 3 and 4 check K1 and K4 at; phases 10m and 10n run both small,
    card against CPU, with every HunyuanVideo cache and true CFG;
  * training: `train_text_to_image.main` on the SDXL UNet at its published
    widths, 1024 px, batch 1, TRAIN_STEPS steps (f32 weights and AdamW, bf16
    autocast; kernels K1 forward, K2 and K3 backward, K4), then a sharded
    safetensors checkpoint,

and shows, from launch counts reset just before each path (each training
step) and read just after, that each path ran through its kernels; a cached
request's counts are read after every denoise step and held to its cache's
schedule, so a step that the cache skips is seen to launch nothing of what
it skips.

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
import atexit
import contextlib
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
    # finfo.min over every key of one query row: the forward's NaN row and -inf LSE give NaN dq on that
    # row, NaN dk and +-inf dv, in the plain version as in JAX's kernels; the kernels must match the pattern
    ("mask finfo.min over every key of one query row", (1, 128, 1, 64), 128, {"mask": "row"}, 0),
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
    (1, 128, 128, 1, 64, False, "row", "bf16"),  # every key of one query row hidden: NaN and inf grads
)
# K4's GroupNorm calls (shape, SiLU, launches) in one SDXL UNet call at 1024 px and b=2 (46) and in one
# VAE decode to 1024 px (30, SDXL's and Flux's decoders alike); tests/test_torch_group_norm.py checks
# them against the models
GN_UNET_CALL = (
    ((2, 320, 128, 128), True, 8), ((2, 320, 64, 64), True, 1), ((2, 640, 64, 64), True, 6),
    ((2, 640, 64, 64), False, 5), ((2, 640, 32, 32), True, 1), ((2, 1280, 32, 32), True, 10),
    ((2, 1280, 32, 32), False, 6), ((2, 2560, 32, 32), True, 2), ((2, 1920, 32, 32), True, 1),
    ((2, 1920, 64, 64), True, 1), ((2, 1280, 64, 64), True, 1), ((2, 960, 64, 64), True, 1),
    ((2, 960, 128, 128), True, 1), ((2, 640, 128, 128), True, 2),
)
GN_VAE_DECODE = (
    ((1, 512, 128, 128), True, 10), ((1, 512, 16384), False, 1), ((1, 512, 256, 256), True, 6),
    ((1, 512, 512, 512), True, 1), ((1, 256, 512, 512), True, 5), ((1, 256, 1024, 1024), True, 1),
    ((1, 128, 1024, 1024), True, 6),
)
# ... and in one VAE encode of a 1024 px image (22 launches; img2img runs one, inpaint with the 9-channel
# UNet two); two of its shapes, (1,128,512,512) and (1,256,256,256), are not in the decoder's table
GN_VAE_ENCODE = (
    ((1, 128, 1024, 1024), True, 4), ((1, 128, 512, 512), True, 1), ((1, 256, 512, 512), True, 3),
    ((1, 256, 256, 256), True, 1), ((1, 512, 256, 256), True, 3), ((1, 512, 128, 128), True, 9),
    ((1, 512, 16384), False, 1),
)
# K4's GroupNorm calls in one SD 1.5 UNet call at 512 px and b=2 (61) and in one VAE decode to 512 px (30: SD 1.5's
# decoder, and each 512 px tile of a tiled Flux decode, whose decoder has the same widths); phase 23 holds the
# UNet's table to the calls a UNet call makes
GN_SD15_UNET_CALL = (
    ((2, 320, 64, 64), True, 8), ((2, 320, 64, 64), False, 5), ((2, 640, 64, 64), True, 2),
    ((2, 960, 64, 64), True, 1), ((2, 320, 32, 32), True, 1), ((2, 640, 32, 32), True, 6),
    ((2, 640, 32, 32), False, 5), ((2, 960, 32, 32), True, 1), ((2, 1280, 32, 32), True, 1),
    ((2, 1920, 32, 32), True, 1), ((2, 640, 16, 16), True, 1), ((2, 1280, 16, 16), True, 6),
    ((2, 1280, 16, 16), False, 5), ((2, 1920, 16, 16), True, 1), ((2, 2560, 16, 16), True, 2),
    ((2, 1280, 8, 8), True, 11), ((2, 1280, 8, 8), False, 1), ((2, 2560, 8, 8), True, 3),
)
GN_VAE_DECODE_512 = (
    ((1, 512, 64, 64), True, 10), ((1, 512, 4096), False, 1), ((1, 512, 128, 128), True, 6),
    ((1, 512, 256, 256), True, 1), ((1, 256, 256, 256), True, 5), ((1, 256, 512, 512), True, 1),
    ((1, 128, 512, 512), True, 6),
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

# phase 10b: the image-conditioned pipelines on phase 7's small components, with SMALL_UNET at 9 input
# channels and a small SDXL ControlNet (SMALL_UNET's down half; its conditioning embedding halves the
# image, as SMALL_VAE does)
SMALL_CONTROLNET = dict(
    in_channels=4, down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"), block_out_channels=(64, 128),
    layers_per_block=1, attention_head_dim=(1, 2), transformer_layers_per_block=(1, 2), use_linear_projection=True,
    cross_attention_dim=64, addition_embed_type="text_time", addition_time_embed_dim=8,
    projection_class_embeddings_input_dim=32 + 6 * 8, conditioning_embedding_out_channels=(16, 32),
)
# diffusers/controlnet-canny-sdxl-1.0 config.json (SDXL base's widths down to the mid block)
SDXL_CONTROLNET = dict(
    in_channels=4, down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
    block_out_channels=(320, 640, 1280), layers_per_block=2, transformer_layers_per_block=(1, 2, 10),
    attention_head_dim=(5, 10, 20), cross_attention_dim=2048, use_linear_projection=True,
    addition_embed_type="text_time", addition_time_embed_dim=256, projection_class_embeddings_input_dim=2816,
    conditioning_embedding_out_channels=(16, 32, 96, 256),
)
# phase 12b's full-width requests: img2img at strength 0.3 (9 of 30 steps), the 9-channel inpainting UNet
# of diffusers/stable-diffusion-xl-1.0-inpainting-0.1 (SDXL base's widths, in_channels=9) at 0.99 (29 of
# 30), ControlNet at conditioning scale 0.5 (30 steps); CFG 5.0 for all
IMG2IMG_STRENGTH = 0.3
INPAINT_STRENGTH = 0.99
CONTROLNET_SCALE = 0.5

# phase 10: the caches and callbacks on the small pipelines, at a step count where every schedule skips
SMALL_CACHE_STEPS = 8
SMALL_FBC_THRESHOLD = 0.5
# the headline TaylorSeer request (bench.py:162): 5 of 30 steps call the UNet (140 K1 and 46 K4 launches
# each), then one VAE decode (30 K4)
SDXL_HEADLINE_LAUNCHES = dict(flash_attention_fwd=140 * 5, flash_attention_bwd_dkdv=0, flash_attention_bwd_dq=0,
                              group_norm=46 * 5 + 30, w8a8_matmul=0, w8a8_quantize_rows=0)

# stabilityai/stable-diffusion-3.5-medium: transformer/config.json (24 layers, the first 13 dual-attention,
# 24 x 64 heads, qk RMSNorm, pos_embed_max_size 384), the text encoders chip_smoke builds for SDXL and Flux
# (CLIP-L and OpenCLIP-bigG with their projections, T5-XXL at 256 tokens), the 16-channel VAE of its
# vae/config.json (no quant convs), flow-match Euler with shift 3.0; 1024 px, 28 steps, CFG 7.0 (the
# server's defaults, examples/server/server.py:165-166)
SD35_MEDIUM = dict(sample_size=128, patch_size=2, in_channels=16, num_layers=24, attention_head_dim=64,
                   num_attention_heads=24, joint_attention_dim=4096, caption_projection_dim=1536,
                   pooled_projection_dim=2048, out_channels=16, pos_embed_max_size=384,
                   dual_attention_layers=tuple(range(13)), qk_norm="rms_norm")
SD3_VAE = dict(FLUX_VAE, scaling_factor=1.5305, shift_factor=0.0609)
SD3_STEPS = 28
SD3_GUIDANCE = 7.0
SD3_PROMPTS = ("a photo of a red fox in fresh snow", "a blue kite over the sea", "a green kite over a field")
# phase 10c: small SD3.0- and SD3.5-style pipelines (head_dim 64: K1 in the transformer and the VAE mid-block)
SMALL_SD3 = dict(sample_size=16, patch_size=2, in_channels=16, num_layers=3, attention_head_dim=64,
                 num_attention_heads=2, joint_attention_dim=256, caption_projection_dim=128,
                 pooled_projection_dim=128, out_channels=16, pos_embed_max_size=96)
SMALL_SD35 = dict(SMALL_SD3, dual_attention_layers=(0, 1), qk_norm="rms_norm")
SMALL_SD3_CLIP = dict(SMALL_FLUX_CLIP, projection_dim=64)
SMALL_SD3_VAE = dict(SMALL_FLUX_VAE, scaling_factor=1.5305, shift_factor=0.0609, sample_size=32)
# Wan 2.1 text-to-video, Wan-AI/Wan2.1-T2V-1.3B-Diffusers: transformer/config.json (1.3B: 30 layers, 12 x 128
# heads, ffn 8960), the VAE at the JAX package's defaults with upstream's 16-channel latent statistics, UMT5-XXL,
# UniPC with flow prediction and flow shift 3.0; 480 x 832, 81 frames, WAN_STEPS steps, CFG 5.0, 512 text tokens
WAN_1_3B = dict(patch_size=(1, 2, 2), num_attention_heads=12, attention_head_dim=128, in_channels=16, out_channels=16,
                text_dim=4096, freq_dim=256, ffn_dim=8960, num_layers=30, cross_attn_norm=True,
                qk_norm="rms_norm_across_heads", eps=1e-6, rope_max_seq_len=1024)
WAN_VAE = dict(base_dim=96, z_dim=16, dim_mult=(1, 2, 4, 4), num_res_blocks=2, temperal_downsample=(False, True, True),
               latents_mean=[-0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508, 0.4134, -0.0715,
                             0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921],
               latents_std=[2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743, 3.2687, 2.1526, 2.8652,
                            1.5579, 1.6382, 1.1253, 2.8251, 1.9160])
UMT5_XXL = dict(vocab_size=256384, d_model=4096, d_kv=64, d_ff=10240, num_layers=24, num_heads=64,
                feed_forward_proj="gated-gelu")
WAN_UNIPC = dict(prediction_type="flow_prediction", use_flow_sigmas=True, flow_shift=3.0)
WAN_HEIGHT, WAN_WIDTH, WAN_FRAMES = 480, 832, 81
WAN_STEPS = 5  # upstream's default is 50; cut to hold the run's time as the guidance and loader phases join it
WAN_GUIDANCE = 5.0
WAN_TEXT_LEN = 512
WAN_PROMPT = "a red panda eating bamboo in a misty forest, cinematic"
WAN_NEGATIVE = "blurry, low quality, static"
WAN_TOKENS = 21 * 30 * 52  # (81 - 1) / 4 + 1 latent frames of 60 x 104, patches of 1 x 2 x 2
WAN_SELF_ATTENTION = (1, WAN_TOKENS, 12, 128)
WAN_Q_CHUNK = 2048  # query rows a check of the self attention against its plain version takes at a time
# Wan image-to-video (phase 19), Wan-AI/Wan2.1-I2V-14B-480P-Diffusers: transformer/config.json (40 layers, 40 x 128
# heads, ffn 13824, 36 input channels: 16 latent + 4 mask + 16 condition; the image branch: image_dim 1280,
# added_kv_proj_dim 5120); image_encoder/config.json, CLIP ViT-H/14 (32 layers, width 1280, 16 x 80 heads, ffn
# 5120, gelu, 224 px: 257 tokens); UMT5-XXL, the VAE and UniPC as phase 17's; 480 x 832, 81 frames, CFG 5.0,
# 512 text tokens, WAN_I2V_STEPS steps (the depth is whole; the step count is the cut)
WAN_I2V_14B = dict(WAN_1_3B, num_attention_heads=40, ffn_dim=13824, num_layers=40, in_channels=36, image_dim=1280,
                   added_kv_proj_dim=5120)
CLIP_VIT_H = dict(hidden_size=1280, intermediate_size=5120, num_hidden_layers=32, num_attention_heads=16,
                  image_size=224, patch_size=14, hidden_act="gelu", layer_norm_eps=1e-5)
WAN_I2V_STEPS = 1  # upstream's 50; one step runs every part of the path (CLIP, the encode, two calls)
WAN_14B_SELF_ATTENTION = (1, WAN_TOKENS, 40, 128)
WAN_14B_Q_CHUNK = 512  # at 40 heads a 2,048-row chunk of f32 logits would be 10.7 GB
# phase 19's cut requests at full width, WAN_CUT_LAYERS blocks a transformer, WAN_CUT_STEPS steps: first-last-frame
# at Wan-AI/Wan2.1-FLF2V-14B-720P-Diffusers' widths (I2V-14B's and a 2 x 257-token image table, pos_embed_seq_len
# 514) at 480 x 832; Wan 2.2's two experts at Wan-AI/Wan2.2-I2V-A14B-Diffusers' widths (I2V-14B's with no image
# branch, boundary_ratio 0.9), guidance 4.0 then 3.0
WAN_CUT_LAYERS = 2
WAN_CUT_STEPS = 2
WAN_FLF_CUT = dict(WAN_I2V_14B, pos_embed_seq_len=514, num_layers=WAN_CUT_LAYERS)
WAN_A14B_CUT = dict(WAN_I2V_14B, image_dim=None, added_kv_proj_dim=None, num_layers=WAN_CUT_LAYERS)
WAN_A14B_BOUNDARY = 0.9
WAN_A14B_GUIDANCE = (4.0, 3.0)
# phase 17b: video-to-video on phase 17's Wan2.1-T2V-1.3B pipeline, a synthetic 81-frame 480 x 832 video
WAN_V2V_STEPS, WAN_V2V_STRENGTH = 2, 0.8
# phase 10d: a small Wan pipeline (head_dim 64: K1 in both attentions of a block), 9 frames of 64 x 64
SMALL_WAN = dict(patch_size=(1, 2, 2), num_attention_heads=2, attention_head_dim=64, in_channels=16, out_channels=16,
                 text_dim=64, freq_dim=64, ffn_dim=256, num_layers=2, cross_attn_norm=True, rope_max_seq_len=1024)
SMALL_WAN_VAE = dict(base_dim=16, z_dim=16, dim_mult=(1, 2, 2, 2), num_res_blocks=1,
                     temperal_downsample=(False, True, True), latents_mean=WAN_VAE["latents_mean"],
                     latents_std=WAN_VAE["latents_std"])
SMALL_UMT5 = dict(vocab_size=32128, d_model=64, d_kv=32, d_ff=128, num_layers=2, num_heads=2,
                  feed_forward_proj="gated-gelu")
# phase 10e: small image-to-video, first-last-frame, two-expert and video-to-video pipelines on phase 10d's
# components: SMALL_WAN at 36 input channels, a small CLIP vision tower at 224 px (257 tokens), 512 text tokens
SMALL_CLIP_VISION = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=2,
                         image_size=224, patch_size=14, hidden_act="gelu")
SMALL_WAN_I2V = dict(SMALL_WAN, in_channels=36, image_dim=64, added_kv_proj_dim=128)
SMALL_WAN_FLF = dict(SMALL_WAN_I2V, pos_embed_seq_len=514)
SMALL_WAN_EXPERT = dict(SMALL_WAN, in_channels=36)

# phase 20: Wan-VACE, Wan-AI/Wan2.1-VACE-1.3B-diffusers: the 1.3B's widths and depth (30 blocks) with 15 VACE
# blocks at layers 0, 2, ..., 28 and 96 control channels (2 x 16 latent + 8 x 8 mask); phase 17's UMT5-XXL and
# VAE; 480 x 832 x 81 with a synthetic control video and mask, CFG 5.0 as one batch-2 call a step, WAN_VACE_STEPS
# steps (the cut)
WAN_VACE_1_3B = dict(WAN_1_3B, vace_layers=list(range(0, 30, 2)), vace_in_channels=96)
WAN_VACE_STEPS = 1
WAN_VACE_K1_PER_CALL = (30 + 15) * 2
WAN_VACE_BATCH2_SELF_ATTENTION = (2, WAN_TOKENS, 12, 128)
WAN_VACE_Q_CHUNK = 1024
# phase 21: Wan2.2-Animate-14B (Wan-AI/Wan2.2-Animate-14B-Diffusers): I2V-14B's widths (40 x 128 heads, ffn 13824,
# 36 input channels, the CLIP image branch) with the motion encoder at 512 px, the face encoder (4 heads of 1024)
# and a face adapter every 5 blocks; cut to WAN_ANIMATE_LAYERS blocks (one adapter); phase 17's UMT5-XXL and VAE,
# a CLIP ViT-H/14; 720 x 1280, 77-frame segments: WAN_ANIMATE_SEGMENTS over a pose and face video in animate mode,
# then one in replace mode, WAN_ANIMATE_STEPS steps each (75,600 tokens: 21 latent frames of 45 x 80 patches)
WAN_ANIMATE_LAYERS = 5  # 10 before the loader phases joined the run
WAN_ANIMATE_SEGMENTS = 1  # 2 before the loader phases joined the run
WAN_ANIMATE_14B = dict(WAN_I2V_14B, latent_channels=16, num_layers=WAN_ANIMATE_LAYERS, inject_face_latents_blocks=5)
WAN_ANIMATE_HEIGHT, WAN_ANIMATE_WIDTH, WAN_ANIMATE_SEGMENT = 720, 1280, 77
WAN_ANIMATE_STEPS = 1
WAN_ANIMATE_TOKENS = 21 * 45 * 80
WAN_ANIMATE_K1_PER_CALL = WAN_ANIMATE_LAYERS * 3 + WAN_ANIMATE_LAYERS // 5
WAN_ANIMATE_SELF_ATTENTION = (1, WAN_ANIMATE_TOKENS, 40, 128)
# phase 22: SkyReels-V2-T2V-14B-540P (Skywork/SkyReels-V2-T2V-14B-540P-Diffusers): the Wan 14B widths (40 x 128
# heads, ffn 13824), one frame a block, no fps injection (the class defaults), cut to WAN_CUT_LAYERS blocks; phase
# 17's UMT5-XXL and VAE; UniPC with flow shift 8.0; 544 x 960 x 97 (51,000 tokens), CFG 6.0, SKYREELS_STEPS steps
SKYREELS_14B = dict(WAN_1_3B, num_attention_heads=40, ffn_dim=13824, num_layers=WAN_CUT_LAYERS)
SKYREELS_UNIPC = dict(WAN_UNIPC, flow_shift=8.0)
SKYREELS_HEIGHT, SKYREELS_WIDTH, SKYREELS_FRAMES = 544, 960, 97
SKYREELS_STEPS, SKYREELS_GUIDANCE = 1, 6.0
SKYREELS_TOKENS = 25 * 34 * 60
SKYREELS_SELF_ATTENTION = (1, SKYREELS_TOKENS, 40, 128)
# phase 10f: small VACE, Animate and SkyReels-V2 on phase 10d's widths
SMALL_WAN_VACE = dict(SMALL_WAN, vace_layers=[0, 1], vace_in_channels=2 * 16 + 8 * 8)
SMALL_ANIMATE = dict(SMALL_WAN_I2V, latent_channels=16, motion_encoder_size=32, motion_style_dim=64, motion_dim=8,
                     motion_encoder_dim=64, face_encoder_hidden_dim=32, face_encoder_num_heads=2,
                     inject_face_latents_blocks=1, motion_encoder_channel_sizes={"4": 64, "8": 64, "16": 64, "32": 32})
SMALL_SKYREELS_CAUSAL = dict(SMALL_WAN, num_frame_per_block=2, inject_sample_info=True)

# phase 18c: Flux.1-dev at full width, depth cut to 2 dual and 4 single blocks (every distinct Linear shape of
# the 500), T5-XXL at full width with 2 layers; CLIP-L and the VAE whole. Its transformer is saved in bf16 and
# quantized on load by JAX's w8a8 rule for Int8DynamicActConfig(): 2 x 14 + 4 x 6 block Linears, and of the
# rest the context embedder, the timestep / guidance / text embedders' linear_2, norm_out and proj_out
FLUX_CUT = dict(FLUX_DEV, num_layers=2, num_single_layers=4)
T5_CUT = dict(T5_XXL, num_layers=2)
FLUX_CUT_W8A8 = 2 * 14 + 4 * 6 + 6
SAMPLE_ROUND_TRIP_STEPS = 4  # phase 18d: the small pipelines' requests
DISK_MARGIN = 2e9  # bytes kept free beyond what a phase-18 directory takes

# phase 23: Stable Diffusion 1.5 at stable-diffusion-v1-5/stable-diffusion-v1-5's published widths: unet/config.json
# (block_out_channels (320, 640, 1280, 1280), 2 layers a block, attention_head_dim 8: 8 heads of d = 40, 80, 160,
# 1x1-conv proj_in / proj_out, cross_attention_dim 768; 859.5 M parameters), text_encoder/config.json (CLIP-L:
# 12 layers, 768 wide, quick_gelu; 123 M), vae/config.json (SDXL's VAE widths, scaling_factor 0.18215) and
# scheduler/scheduler_config.json (PNDM, skip_prk_steps); 512 px, 50 steps, CFG 7.5. DDIM is the usual swap (the
# PNDM config's numbers, clip_sample off). The inpainting UNet is stable-diffusion-v1-5/stable-diffusion-inpainting's
# (the same widths, 9 input channels); the T2I-Adapter TencentARC/t2iadapter_canny_sd15v2's config.json
SD15_UNET = dict(
    sample_size=64, in_channels=4, out_channels=4,
    down_block_types=("CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",),
    up_block_types=("UpBlock2D",) + ("CrossAttnUpBlock2D",) * 3, block_out_channels=(320, 640, 1280, 1280),
    layers_per_block=2, attention_head_dim=8, cross_attention_dim=768, use_linear_projection=False,
)
SD15_UNET_PARAMETERS = 859_520_964
SD15_VAE = dict(SDXL_VAE, sample_size=512, scaling_factor=0.18215)
SD15_PNDM = dict(beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear", skip_prk_steps=True,
                 set_alpha_to_one=False, steps_offset=1)
SD15_DDIM = dict(beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear", clip_sample=False,
                 set_alpha_to_one=False, steps_offset=1)
SD15_STEPS = 50
SD15_DDIM_STEPS = 10  # the cut: the DDIM request tests the scheduler swap, not the step count
SD15_GUIDANCE = 7.5
SD15_RESOLUTION = 512
SD15_PROMPT = "a photograph of an astronaut riding a horse"
SD15_IMG2IMG_STRENGTH = 0.75
SD15_INPAINT_STRENGTH = 1.0
T2I_CANNY_SD15 = dict(in_channels=1, channels=(320, 640, 1280, 1280), num_res_blocks=2, downscale_factor=8,
                      adapter_type="full_adapter")
# SD 1.5's attentions at 512 px under CFG (b=2): (label, q shape, kv length, launches a UNet call). Its heads of
# 40, 80 and 160 are not K1's (HEAD_DIMS), so they run `native` (JAX's rule: d % 64 == 0); phase 23 times each
# against SDPA for ROADMAP B1.1
SD15_ATTENTION = (
    ("self 4096 d=40", (2, 4096, 8, 40), 4096, 5), ("cross 4096 x 77 d=40", (2, 4096, 8, 40), 77, 5),
    ("self 1024 d=80", (2, 1024, 8, 80), 1024, 5), ("cross 1024 x 77 d=80", (2, 1024, 8, 80), 77, 5),
    ("self 256 d=160", (2, 256, 8, 160), 256, 5), ("cross 256 x 77 d=160", (2, 256, 8, 160), 77, 5),
    ("mid self 64 d=160", (2, 64, 8, 160), 64, 1), ("mid cross 64 x 77 d=160", (2, 64, 8, 160), 77, 1),
)
# phase 5b: the per-tensor int8 routes (`ops/int8.py`) on K5's GEMM at SDXL's shapes, 1024 px, CFG (b=2): the
# per-tensor Linear at the level-3 feed-forward's (8,192 rows = 2 x 64 x 64 tokens, 1,280 -> 10,240), the int8 conv at
# the level-1 3x3 (2, 320, 128, 128) -> 320 (K = 2,880 and N = 320 both padded to 128) and the level-3 3x3
# (2, 1280, 32, 32) -> 1,280. (label, kind, input shape, N, kernel size)
INT8_ROUTE_CASES = (
    ("per-tensor Linear (8192, 1280 -> 10240)", "linear", (8192, 1280), 10240, None),
    ("conv (2, 320, 128, 128) 3x3 -> 320", "conv", (2, 320, 128, 128), 320, 3),
    ("conv (2, 1280, 32, 32) 3x3 -> 1280", "conv", (2, 1280, 32, 32), 1280, 3),
)
# phase 12d: SDXL under `Int8DynamicActConfig()` (JAX's rule at its default min_weight_size 4096): 131 Linears per
# row (60 x (1280 -> 10240), 60 x (5120 -> 1280), 10 x (2560 -> 640), 1 x (2816 -> 1280)) and 40 int8 convs, so K5
# runs 171 times a UNet call (131 of them after a row quantization); the other three configs run one UNet call each
SDXL_W8A8_LINEARS, SDXL_INT8_CONVS = 131, 40
# phase 12e: SDXL InstructPix2Pix (diffusers/sdxl-instructpix2pix-768's layout: SDXL's UNet with 8 input channels, its
# Euler scheduler) at 768 px on phase 11's VAE and text towers, guidance 3.0 and image guidance 1.5 (triple CFG: one
# batch-3 UNet call a step), IP2P_STEPS of the published default 100 (the cut)
IP2P_STEPS = 10
IP2P_RESOLUTION_XL = 768
IP2P_GUIDANCE, IP2P_IMAGE_GUIDANCE = 3.0, 1.5
# phase 23b, on phase 23's SD 1.5 components: InstructPix2Pix at timbrooks/instruct-pix2pix's widths (SD 1.5's UNet
# with 8 input channels; the Euler scheduler at SD 1.5's betas for its Euler ancestral one, which the port lacks) at
# 512 px, guidance 7.5, image guidance 1.5, IP2P_STEPS of 100; LCM at SimianLuo/LCM_Dreamshaper_v7's widths (SD 1.5's
# UNet with time_cond_proj_dim 256; LCMScheduler, 50 original steps) at 768 px, 4 steps (the published default),
# guidance 8.5; TCD on SD 1.5's UNet (TCD ships as a LoRA on it) at 512 px, 4 steps, eta 0.3; the x4 upscaler at
# stabilityai/stable-diffusion-x4-upscaler's widths (its UNet: block_out_channels (256, 512, 512, 1024), 8 heads,
# cross attention 1024, 1,000 noise-level classes, only_cross_attention (True, True, True, False) by block (the
# first block has no attention), 7 input channels; its OpenCLIP-H text tower, 23 layers of 1,024; its 3-block VAE,
# scaling 0.08333; a DDPM low_res_scheduler and a v-prediction DDIM), 128 px -> 512 px, noise level 20, guidance
# 9.0, UPSCALE_STEPS of 75
LCM_UNET = dict(SD15_UNET, time_cond_proj_dim=256)
LCM_SCHEDULER = dict(beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear", original_inference_steps=50)
LCM_STEPS, LCM_RESOLUTION, LCM_GUIDANCE = 4, 768, 8.5
TCD_STEPS, TCD_ETA = 4, 0.3
UPSCALE_UNET = dict(
    sample_size=128, in_channels=7, out_channels=4,
    down_block_types=("DownBlock2D",) + ("CrossAttnDownBlock2D",) * 3,
    up_block_types=("CrossAttnUpBlock2D",) * 3 + ("UpBlock2D",), block_out_channels=(256, 512, 512, 1024),
    layers_per_block=2, attention_head_dim=8, cross_attention_dim=1024, use_linear_projection=True,
    num_class_embeds=1000, only_cross_attention=(True, True, True, False),
)
UPSCALE_VAE = dict(in_channels=3, out_channels=3, down_block_types=("DownEncoderBlock2D",) * 3,
                   up_block_types=("UpDecoderBlock2D",) * 3, block_out_channels=(128, 256, 512), latent_channels=4,
                   layers_per_block=2, sample_size=256, scaling_factor=0.08333)
CLIP_H_TEXT = dict(vocab_size=49408, hidden_size=1024, intermediate_size=4096, num_hidden_layers=23,
                   num_attention_heads=16, projection_dim=512, hidden_act="gelu")
UPSCALE_DDIM = dict(beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear", clip_sample=False,
                    set_alpha_to_one=False, steps_offset=1, prediction_type="v_prediction")
UPSCALE_DDPM = dict(beta_start=0.0001, beta_end=0.02, beta_schedule="scaled_linear")
UPSCALE_STEPS, UPSCALE_LOW_RES, UPSCALE_GUIDANCE, UPSCALE_NOISE_LEVEL = 10, 128, 9.0, 20
# phase 10i: the new modules on small components, card bf16 against CPU f32: an SDXL-shaped UNet that JAX's gates
# quantize (a 2,560-wide time embedding: its linear_2 and every time_emb_proj have K = 2,560; 320-channel 3x3 convs of
# fan-in 2,880; heads of 64) under each config, and the InstructPix2Pix, upscaler, LCM and TCD pipelines
SMALL_Q_UNET = dict(SMALL_UNET, block_out_channels=(64, 320), attention_head_dim=(1, 5), time_embedding_dim=2560)
# bf16 on the card against bf16 on the CPU, as a share of the output's largest magnitude: the kernels' bf16 rounding
# moves some activations across a per-tensor quantization step, each flip worth a step times a weight (measured on an
# NVIDIA H100 80GB HBM3 at 700 W: 0.048 w8a8, 0.040 per tensor, 0.018 int8 and fp8 weight-only)
SMALL_Q_TOL = 0.1

# CLIP ViT-H/14's attention (16 heads of 80 over 257 tokens, 32 layers): `native`, once an image encode
VIT_H_ATTENTION = ("ViT-H self 257 d=80", (1, 257, 16, 80), 257, 32)

# phase 12c: IP-Adapter on phase 11's SDXL, h94/IP-Adapter's sdxl_models: ip-adapter-plus_sdxl_vit-h (the resampler
# over ViT-H's penultimate states: 1280 wide, depth 4, 20 heads of 64, 16 queries, output 2048) and
# ip-adapter_sdxl_vit-h (ImageProjection 1024 -> 4 x 2048); to_k_ip / to_v_ip [inner, 2048] for all 70 attn2 layers;
# the CLIP ViT-H/14 tower with its 1024-wide projection; 1024 px, 30 Euler steps, CFG 5.0
CLIP_VIT_H_PROJ = dict(CLIP_VIT_H, projection_dim=1024)
IP_PLUS_SDXL = dict(hidden_dims=1280, depth=4, heads=20, num_queries=16)
IP_SDXL_CROSS_ATTENTIONS = 70
IP_PLUS_RESAMPLER_ATTENTIONS = 4
# the K1 shapes it adds (phase 3): the IP cross attention at both attn2 levels over 4 (base) and 16 (Plus) image
# tokens, and the resampler's attention (the latents over [257 ViT-H tokens ; 16 latents]) at the CFG batch
IP_K1_CASES = (
    ("IP-Adapter cross 4096 x 4 d=64 (base)", (2, 4096, 10, 64), 4, {}, True),
    ("IP-Adapter cross 1024 x 4 d=64 (base)", (2, 1024, 20, 64), 4, {}, True),
    ("IP-Adapter cross 4096 x 16 d=64 (Plus)", (2, 4096, 10, 64), 16, {}, True),
    ("IP-Adapter cross 1024 x 16 d=64 (Plus)", (2, 1024, 20, 64), 16, {}, True),
    ("IP-Adapter Plus resampler 16 x 273 d=64", (2, 16, 20, 64), 273, {}, True),
)

# phase 13b: VAE tiling on phase 13's Flux VAE: whole and tiled decodes of a 1024 px and a 2048 px latent (512 px
# tiles), then one Flux request with tiling on, its steps cut to FLUX_TILED_STEPS (the decode is what it tests)
VAE_TILE = 512
FLUX_TILED_STEPS = 4

# phase 8b: the Flux family on small components, card bf16 against CPU f32: phase 8's SMALL_FLUX pipeline (its VAE has
# vae_scale_factor 2), a Fill transformer (64 + 64 + 4 x 2^2 = 144 input channels) and a Control one (128), a ControlNet
# of 1 dual and 1 single block, plain and Union (its residual projections made random so the residuals act), all w8a8
# by SMALL_FLUX_MIN_WEIGHT_SIZE; a small SigLIP (2 heads of 64, so K1 runs on the card) with a Redux encoder into T5's
# 256; an int4 Linear and SMALL_T5 quantized by bench.py's int4 rule at 2^15 elements
SMALL_FLUX_FILL = dict(SMALL_FLUX, in_channels=144, out_channels=64)
SMALL_FLUX_CONTROL = dict(SMALL_FLUX, in_channels=128, out_channels=64)
SMALL_FLUX_CONTROLNET = dict(SMALL_FLUX, num_layers=1, num_single_layers=1)
SMALL_SIGLIP = dict(hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=2, image_size=56,
                    patch_size=14)
SMALL_REDUX = dict(redux_dim=128, txt_in_features=256)
SMALL_FAMILY_STEPS = 4

# phase 13c: the rest of the Flux family at full width on phase 13's FLUX.1-dev pipeline (the w8a8 transformer, CLIP-L,
# T5-XXL, the VAE). Published configs: black-forest-labs/FLUX.1-Fill-dev's transformer (FLUX.1-dev's widths,
# in_channels 384, out_channels 64), FLUX.1-Canny-dev's (in_channels 128, out_channels 64), FLUX.1-Kontext-dev's
# (FLUX.1-dev's config: the dev transformer serves), InstantX/FLUX.1-dev-Controlnet-Canny's ControlNet (5 dual and 10
# single blocks at 24 x 128, guidance embeds) and InstantX/FLUX.1-dev-Controlnet-Union's (the same, num_mode 10), each
# w8a8 by bench.py's rule; Redux: google/siglip-so400m-patch14-384's vision tower (1152 wide, 27 layers, 16 heads of 72,
# MLP 4304, 384 px in patches of 14: 729 tokens) and black-forest-labs/FLUX.1-Redux-dev's ReduxImageEncoder(1152, 4096).
# Kontext (1024 px with a 1024 px reference: 512 + 4096 + 4096 = 8,704 tokens) and Fill are cut from their published
# 28 steps to 4, as the other requests are cut to 4 transformer calls (img2img and inpaint at strength 0.6 of 7 steps)
FLUX_FILL_DEV = dict(FLUX_DEV, in_channels=384, out_channels=64)
FLUX_CANNY_DEV = dict(FLUX_DEV, in_channels=128, out_channels=64)
FLUX_CONTROLNET_CANNY = dict(guidance_embeds=True, num_layers=5, num_single_layers=10)
FLUX_CONTROLNET_UNION = dict(FLUX_CONTROLNET_CANNY, num_mode=10)
SIGLIP_SO400M = dict(hidden_size=1152, intermediate_size=4304, num_hidden_layers=27, num_attention_heads=16,
                     image_size=384, patch_size=14)
REDUX_DEV = dict(redux_dim=1152, txt_in_features=4096)
KONTEXT_STEPS = 4  # cut from the published 28 to hold the run's time as phases 27-28 join it
KONTEXT_GUIDANCE = 2.5
FILL_STEPS = 4  # cut from 28, as KONTEXT_STEPS
FILL_GUIDANCE = 30.0
FAMILY_CUT_STEPS = 4
FAMILY_STRENGTH = 0.6
FAMILY_STRENGTH_STEPS = 7  # int(7 x 0.6) = 4 transformer calls
UNION_MODE = 0  # the Union ControlNet's canny mode
KONTEXT_JOINT_ATTENTION = (1, 512 + 4096 + 4096, 24, 128)
SIGLIP_ATTENTION = ("SigLIP so400m self 729 d=72", (1, 729, 16, 72), 729, 27)
# w8a8 (M, K, N, launches a step) of one Kontext step at 1024 px with a 1024 px reference: FLUX_W8A8_SHAPES with the
# 8,192 image tokens in the dual blocks and the 8,704 joint tokens in the single blocks
KONTEXT_W8A8_SHAPES = tuple(((2 * m if m == 4096 else m + 4096 if m == 4608 else m), k, n, c)
                            for m, k, n, c in FLUX_W8A8_SHAPES)

# phase 10g: the SD slice on small components, card bf16 against CPU f32: an SD-shaped UNet (1x1-conv projections, no
# added embedding; heads of 64 and 128, so K1 runs on the card), phase 7's VAE and CLIP, a small T2I-Adapter and a
# small CLIP vision tower with its projection (224 px, 257 tokens)
SMALL_SD_UNET = dict(
    sample_size=16, in_channels=4, out_channels=4, down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), block_out_channels=(64, 128), layers_per_block=1,
    attention_head_dim=1, cross_attention_dim=32, use_linear_projection=False,
)
SMALL_T2I_ADAPTER = dict(in_channels=1, channels=(64, 128), num_res_blocks=1, downscale_factor=2)
SMALL_VISION_PROJ = dict(SMALL_CLIP_VISION, projection_dim=48)

# phase 10h: the ControlNet family on small components, card bf16 against CPU f32: phase 10g's SD pipeline with an
# SD-shaped ControlNet (SMALL_SD_UNET's down half: heads of 64 and 128, so K1 runs; its conditioning embedding halves
# the image, as SMALL_VAE does), phase 10b's SDXL pipeline with SMALL_CONTROLNET and a Union net of its widths (the
# union transformer 64 wide, 8 heads; its zero-initialised spatial_ch_projs made random so the fusion acts), and phase
# 10c's SD3.5-style pipeline with a ControlNet by the from_transformer rule (2 blocks, residual projections and
# pos_embed_input made random so the residuals act)
SMALL_SD_CONTROLNET = dict(
    in_channels=4, down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"), block_out_channels=(64, 128),
    layers_per_block=1, attention_head_dim=1, cross_attention_dim=32, use_linear_projection=False,
    conditioning_embedding_out_channels=(16, 32),
)
SMALL_UNION = dict(SMALL_CONTROLNET, num_control_type=6, num_trans_channel=64, num_trans_head=8, num_proj_channel=64)
SMALL_SD3_CONTROLNET_LAYERS = 2
SMALL_CONTROLNET_STEPS = 4
# phase 24: the ControlNet family at full width. SD 1.5: lllyasviel/control_v11p_sd15_canny's config.json (the SD 1.5
# UNet's down half: (320, 640, 1280, 1280), 8 heads of 40/80/160, cross_attention_dim 768, conditioning channels
# (16, 32, 96, 256); 361 M parameters) on phase 23's pipeline, 512 px, PNDM 50 steps, CFG 7.5; img2img and inpaint at
# phase 23's strengths; one Multi-ControlNet request with two such nets. SDXL: phase 12b's SDXL_CONTROLNET on phase 11's
# pipeline, img2img at 0.3 and inpaint at 0.99, 1024 px, 30 steps, CFG 5.0. ControlNet-Union:
# xinsir/controlnet-union-sdxl-1.0's layout, SDXL_CONTROLNET's widths with the union fields at their defaults
# (6 control types, a 320-wide transformer of 1 layer with 8 heads, projection 320), text-to-image, img2img (0.3) and
# inpaint (0.99), and one MultiControlNetUnion request with two nets (canny on the edge map, depth on the image). SD3:
# the joint-block kind (InstantX's layout) built from phase 16's SD3.5 Medium transformer by the from_transformer rule
# (JAX's default of 12 blocks, no extra conditioning channel; upstream's rule, so the blocks keep the base's dual
# attention and qk RMSNorm), its residual projections and pos_embed_input random from SEED; 1024 px, 28 steps,
# CFG 7.0. Every request runs once at CONTROLNET_WARMUP_STEPS as a warm-up, then is timed on CUDA events; one request
# of each family (SD 1.5 text-to-image, SDXL inpaint, Union text-to-image, SD3) runs its warm-up twice, on the kernels
# and on the plain routes on the card, and holds the two images together
SD15_CONTROLNET = dict(
    in_channels=4, down_block_types=("CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",),
    block_out_channels=(320, 640, 1280, 1280), layers_per_block=2, attention_head_dim=8, cross_attention_dim=768,
    use_linear_projection=False, conditioning_embedding_out_channels=(16, 32, 96, 256),
)
SDXL_UNION = dict(SDXL_CONTROLNET, num_control_type=6, num_trans_channel=320, num_trans_head=8, num_trans_layer=1,
                  num_proj_channel=320)
UNION_CANNY, UNION_DEPTH = 3, 1  # xinsir's task indices
SD3_CONTROLNET_LAYERS = 12
SD15_CONTROLNET_SCALE = 1.0
CONTROLNET_WARMUP_STEPS = 4
SDXL_CONTROLNET_FAMILY_STEPS = 10  # phase 24b's schedule, cut from 30 to hold the run's time

# guidance (phases 3, 10j, 25): Perturbed-Attention Guidance at pag_scale 3.0 on SDXL and SD 1.5 with the pipelines'
# default "mid" (SDXL's 10 mid-block attn1 turned to identities: a perturbed UNet call launches K1 130 and K4 46, so a
# PAG step at b=2 + b=1 launches K1 270 and K4 92; SD 1.5's heads run `native`, K4 61 + 61) and on SD3.5 Medium with
# upstream's default block 13 (its joint attention under the identity mask: K1 37 + 37 a step); Skip Layer Guidance
# over SD3.5 Medium's blocks 7-9 (the SD3.5 recipe's default, upstream's `skip_guidance_layers`); SEG on SDXL's mid
# block at sigma 3 (kernel 19 over the 32 x 32 grid); FreeU at SDXL's suggested factors. The img2img PAG request
# takes phase 12b's strength (9 of 30 steps), the ControlNet PAG request PAG_CONTROLNET_STEPS steps (the cut)
PAG_SCALE = 3.0
SD3_PAG_LAYERS = r"transformer_blocks\.13"
SDXL_PAG_STEP = dict(flash_attention_fwd=270, group_norm=92)
SD3_PAG_STEP_K1 = 74
SLG_BLOCKS = (7, 8, 9)
SEG_SIGMA = 3.0
SDXL_FREEU = dict(s1=0.6, s2=0.4, b1=1.1, b2=1.2)
PAG_CONTROLNET_STEPS = 8
PAG_WARMUP_STEPS = 4
SD3_IMAGE_TOKENS = 4096  # 1024 px: 64 x 64 patches before SD3's 333 text tokens
SD3_PAG_ATTENTION = (1, 4096 + 333, 24, 64)  # the perturbed joint attention at b=1
GUIDANCE_MODEL_TOL = 0.05  # a small model's bf16 output on the card against f32 on the CPU, of its largest value

# Qwen-Image (phases 3, 10k, 27): Qwen/Qwen-Image's published widths, the JAX package's defaults (recalled: no
# config.json in the repository): the transformer (60 blocks, 24 x 128 heads, joint dim 3584, in 64, out 16; 20.4 B),
# the Qwen2.5-VL-7B text tower without its vision tower and LM head (28 layers, 3584 / 18944, 28 / 4 heads, vocab
# 152064; 7.07 B), the VAE (base 96, z 16), its flow-match scheduler config; 1024 px, true CFG 4.0 as one batch-2
# call a step, 1,024 text tokens (+ the 34 of the template's prefix). Cut to QWEN_STEPS of 50 steps; img2img
# (strength 0.6 of QWEN_EDIT_STEPS) and inpaint run 3 and 2 transformer calls
QWEN_IMAGE = dict()
QWEN_TEXT = dict()
QWEN_VAE = dict()
QWEN_SCHEDULER = dict(use_dynamic_shifting=True, base_shift=0.5, max_shift=0.9, base_image_seq_len=256,
                      max_image_seq_len=8192, shift_terminal=0.02)
QWEN_STEPS = 4
QWEN_EDIT_STEPS = (5, 4)  # img2img, inpaint: strength 0.6 keeps 3 and 2 steps
QWEN_STRENGTH = 0.6
QWEN_TRUE_CFG = 4.0
QWEN_TEXT_LEN = 1024
QWEN_PROMPT = "a jade rabbit sitting on a red paper lantern, ink painting"
QWEN_JOINT_ATTENTION = (2, 1024 + 4096, 24, 128)  # 1,024 padded text + 64 x 64 image tokens at b=2
QWEN_KEPT_TEXT = (12, 40)  # text keys a short negative and positive prompt keep of the 1,024: the key-padding bias
# phase 10k: small Qwen-Image pipelines (head_dim 128: K1), card bf16 against CPU f32
SMALL_QWEN = dict(patch_size=2, in_channels=16, out_channels=4, num_layers=2, attention_head_dim=128,
                  num_attention_heads=2, joint_attention_dim=64, axes_dims_rope=(16, 56, 56))
SMALL_QWEN_TEXT = dict(vocab_size=1024, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                       num_attention_heads=4, num_key_value_heads=2)
SMALL_QWEN_VAE = dict(base_dim=16, z_dim=4, dim_mult=(1, 2, 2, 2), num_res_blocks=1,
                      latents_mean=[0.1, -0.2, 0.0, 0.3], latents_std=[1.0, 0.5, 2.0, 1.5])

# LTX-Video (phases 3, 4, 10l, 28): LTX-Video 0.9.x's transformer at its published widths, the JAX defaults (28
# blocks, 32 x 64 heads, caption 4096; 1.92 B) with T5-XXL at 128 tokens; the VAE with LTX-Video 0.9.1's
# timestep-conditioned decoder (recalled: decoder widths 256 / 512 / 1024 with 5 / 6 / 7 / 8 resnets, noise in the
# up blocks, residual upsamplers of factor 2) and its scheduler config (recalled); 512 x 704 x 161 frames (21 x 16 x 22
# latent tokens: 7,392), CFG 3.0 as one batch-2 call a step, cut to LTX_STEPS of 50; image-to-video and a condition
# request (an image at frame 0, a 17-frame video at frame 80) cut to LTX_EDIT_STEPS with no decode; the latent
# upsampler at LTX-Video 0.9.7's spatial widths (128 -> 512, 4 blocks a stage, dims 3) on the request's latents (its
# output not decoded: 161 x 1024 x 1408 frames)
LTX_VIDEO = dict()
LTX_VAE = dict(decoder_block_out_channels=(256, 512, 1024), decoder_layers_per_block=(5, 6, 7, 8),
               decoder_spatio_temporal_scaling=(True, True, True), decoder_inject_noise=(True, True, True, False),
               upsample_residual=(True, True, True), upsample_factor=(2, 2, 2), timestep_conditioning=True)
LTX_SCHEDULER = dict(use_dynamic_shifting=True, base_shift=0.95, max_shift=2.05, base_image_seq_len=1024,
                     max_image_seq_len=4096, shift_terminal=0.1)
LTX_UPSAMPLER = dict(in_channels=128, mid_channels=512, num_blocks_per_stage=4, dims=3, spatial_upsample=True)
LTX_HEIGHT, LTX_WIDTH, LTX_FRAMES, LTX_FRAME_RATE = 512, 704, 161, 25
LTX_STEPS = 3
LTX_EDIT_STEPS = 2
LTX_GUIDANCE = 3.0
LTX_TEXT_LEN = 128
LTX_DECODE_TIMESTEP, LTX_DECODE_NOISE_SCALE = 0.05, 0.025
LTX_PROMPT = "a paper boat drifting down a rain-soaked street at dusk"
LTX_NEGATIVE = "worst quality, blurry, jittery"
LTX_TOKENS = 21 * 16 * 22
LTX_SELF_ATTENTION = (2, LTX_TOKENS, 32, 64)  # 7,392 = 57 x 128 + 96: a ragged last q tile
LTX_KEPT_TEXT = (6, 18)  # T5 tokens a negative and positive prompt keep of the 128: the cross attention's -10000 bias
# K4 in one LTX latent-upsampler call (17 launches): the initial norm and 4 blocks before the 2x spatial upsample, 4
# after; a group spans 16 channels of 21 x 16 x 22 (231 KB in bf16: the cluster regime), then of 21 x 32 x 44
GN_LTX_UPSAMPLER = (
    ((1, 512, 21, 16, 22), True, 5), ((1, 512, 21, 16, 22), False, 4),
    ((1, 512, 21, 32, 44), True, 4), ((1, 512, 21, 32, 44), False, 4),
)
# phase 10l: small LTX pipelines (head_dim 64: K1; the upsampler's GroupNorms: K4), card bf16 against CPU f32
SMALL_LTX = dict(in_channels=16, out_channels=16, num_attention_heads=2, attention_head_dim=64,
                 cross_attention_dim=128, num_layers=2, caption_channels=64)
SMALL_LTX_VAE = dict(latent_channels=16, block_out_channels=(16, 32, 32, 32), decoder_block_out_channels=(32,) * 4,
                     layers_per_block=(1, 1, 1, 1, 1), decoder_layers_per_block=(1, 1, 1, 1, 1),
                     spatio_temporal_scaling=(True, True, False, False),
                     decoder_spatio_temporal_scaling=(True, True, False, False), timestep_conditioning=True,
                     patch_size=2)
SMALL_LTX_T5 = dict(vocab_size=32128, d_model=64, d_kv=32, d_ff=128, num_layers=2, num_heads=2,
                    feed_forward_proj="gated-gelu")
SMALL_LTX_UPSAMPLER = dict(in_channels=16, mid_channels=64, num_blocks_per_stage=1, dims=3)

# HunyuanVideo (phases 3, 4, 10m, 29): hunyuanvideo-community/HunyuanVideo's published widths, the port's defaults
# (the JAX package's): the 13 B transformer (20 dual + 40 single blocks of 24 x 128 heads, 2 refiner layers, text
# 4096, pooled 768, RoPE (16, 56, 56) at theta 256, distilled guidance), llava-llama-3-8b's text tower (32 layers,
# 4096 / 14336, 32 / 8 heads, vocab 128320) read at hidden_states[-3], CLIP-L's pooled output, the causal 3-D VAE
# (128, 256, 512, 512), flow-match shift 7.0; 320 x 512 x 61 frames (diffusers' HunyuanVideo docs): 16 x 20 x 32 =
# 10,240 image tokens + 256 text tokens, guidance 6.0 distilled (one batch-1 call a step); HUNYUAN_STEPS of 30 with
# the decode. The template's crop is the stand-in tokenizer's count of the template before the prompt
HUNYUAN_VIDEO = dict()
HUNYUAN_LLAMA = dict()
HUNYUAN_VAE = dict()
HUNYUAN_SHIFT = 7.0
HUNYUAN_HEIGHT, HUNYUAN_WIDTH, HUNYUAN_FRAMES = 320, 512, 61
HUNYUAN_STEPS = 4
HUNYUAN_GUIDANCE = 6.0
HUNYUAN_TEXT_LEN = 256
HUNYUAN_PROMPT = "a cat walks on the grass, realistic style, soft morning light"
HUNYUAN_TOKENS = 16 * 20 * 32
HUNYUAN_JOINT_ATTENTION = (1, HUNYUAN_TOKENS + HUNYUAN_TEXT_LEN, 24, 128)  # image tokens first, then the text
HUNYUAN_KEPT_TEXT = (12,)  # text tokens the prompt keeps of the 256 after the crop: the key-padding bias
HUNYUAN_REFINER_ATTENTION = (1, HUNYUAN_TEXT_LEN, 24, 128)  # the token refiner under its 2-D mask
HUNYUAN_LLAMA_VOCAB = 128320
# K4 at the decode's largest spans (320 x 512 x 61, the split regime): the last up block's first norm over 256
# channels (160 MB a group), its other five and `conv_norm_out` over 128 (80 MB a group)
GN_HUNYUAN_VAE = (((1, 256, 61, 320, 512), True, 1), ((1, 128, 61, 320, 512), True, 6))
HUNYUAN_TAYLORSEER = dict(cache_interval=2, disable_cache_before_step=1, max_order=1)
# FramePack (phases 10n, 30): lllyasviel/FramePackI2V_HY's transformer (HunyuanVideo's widths, the 1,152-wide SigLIP
# projection, the 1x / 2x / 4x history embedders) with google/siglip-so400m-patch14-384 as the image encoder at 384
# px; 832 x 480 (104 x 60 latents: 1,560 tokens a latent frame), sections of FRAMEPACK_WINDOW latent frames (9
# published: the second section's decode of 19 latent frames, 73 x 480 x 832, does not fit beside the 42 GB of
# weights without tiling, which JAX does not do), 2 sections (num_frames 34) of FRAMEPACK_STEPS steps (25 published),
# in both sampling orders
FRAMEPACK = dict(has_image_proj=True, has_clean_x_embedder=True)
FRAMEPACK_HEIGHT, FRAMEPACK_WIDTH = 480, 832
FRAMEPACK_WINDOW = 5
FRAMEPACK_FRAMES = 34
FRAMEPACK_STEPS = 2
FRAMEPACK_GUIDANCE = 10.0
# K1 at FramePack's joint attention (phase 3; phase 30 holds its main path to this length): 30 x 52 tokens a latent
# frame after the 2 x 2 patch, for the section's FRAMEPACK_WINDOW frames and the 2 clean frames, then the 2x
# history's 1 frame at 15 x 26 and the 4x history's 4 frames at 8 x 13 (replicate-padded): 11,726 image tokens;
# then 729 SigLIP tokens and the 256 text tokens: 12,711 = 99 x 128 + 39, a ragged last query tile, and the
# key-padding bias hides the last 244 keys, the whole last key tile among them
FRAMEPACK_TOKENS = (FRAMEPACK_WINDOW + 2) * 30 * 52 + 15 * 26 + 4 * 8 * 13
FRAMEPACK_IMAGE_TOKENS = 729
FRAMEPACK_JOINT_ATTENTION = (1, FRAMEPACK_TOKENS + FRAMEPACK_IMAGE_TOKENS + HUNYUAN_TEXT_LEN, 24, 128)
# K4 at FramePack's largest spans (the split regime; phase 30 holds its decodes to them): the decode of the last
# section's 11 latent frames in the inverted order (41 x 480 x 832: the last up block's first norm over 256
# channels, 4.2 G elements, its other five and `conv_norm_out` over 128), and the image encode's first down block
# (1 x 480 x 832, four norms)
GN_FRAMEPACK_VAE = (((1, 256, 41, 480, 832), True, 1), ((1, 128, 41, 480, 832), True, 6),
                    ((1, 128, 1, 480, 832), True, 4))
# phases 10m, 10n: small HunyuanVideo and FramePack pipelines (head_dim 128: K1), card bf16 against CPU f32
SMALL_HUNYUAN = dict(in_channels=16, out_channels=16, num_attention_heads=2, attention_head_dim=128, num_layers=1,
                     num_single_layers=1, num_refiner_layers=1, text_embed_dim=64, pooled_projection_dim=32,
                     rope_axes_dim=(16, 56, 56))
SMALL_HUNYUAN_LLAMA = dict(vocab_size=HUNYUAN_LLAMA_VOCAB, hidden_size=64, intermediate_size=128,
                           num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2)
SMALL_HUNYUAN_CLIP = dict(vocab_size=49408, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                          num_attention_heads=2, projection_dim=32)
SMALL_HUNYUAN_VAE = dict(latent_channels=16, block_out_channels=(32, 32, 32, 32), layers_per_block=1,
                         norm_num_groups=32)
SMALL_FRAMEPACK_SIGLIP = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=1, num_attention_heads=2,
                              image_size=64, patch_size=16)
# the Qwen-Image ControlNet (phase 27): InstantX/Qwen-Image-ControlNet-Union's depth (5 blocks) from the
# transformer by `from_transformer`; its residuals enter one transformer call at b=2
QWEN_CONTROLNET_LAYERS = 5

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


def clip_tokenizer(directory, vocab_size=None):
    """A real `transformers.CLIPTokenizer` with a vocabulary written on the
    spot into `directory` (no download): CLIP's byte-level alphabet, each
    symbol also as a word end (``</w>``), a few merges, then BOS and EOS,
    the highest ids (CLIP pools at the highest). With `vocab_size` (CLIP's
    49408), filler words no prompt meets pad the vocabulary so that BOS and
    EOS are CLIP's 49406 and 49407 and a textual-inversion token gets the
    row the text encoder's table appends. Loaded with `from_pretrained`, as
    a published pipeline's `tokenizer/` folder is."""
    import transformers

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    alphabet = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + \
        list(range(ord("®"), ord("ÿ") + 1))
    extra = [b for b in range(256) if b not in alphabet]
    symbols = [chr(b) for b in alphabet] + [chr(256 + i) for i in range(len(extra))]  # bytes_to_unicode's order
    merges = ["t h", "th e</w>", "a n", "an d</w>", "o n</w>", "i n"]
    vocab = {sym: i for i, sym in enumerate(symbols)}
    vocab.update({sym + "</w>": 256 + i for i, sym in enumerate(symbols)})
    for m in merges:
        vocab["".join(m.split())] = len(vocab)
    while vocab_size is not None and len(vocab) < vocab_size - 2:
        vocab[f"filler{len(vocab)}\u0100</w>"] = len(vocab)
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = len(vocab), len(vocab) + 1
    (directory / "vocab.json").write_text(json.dumps(vocab))
    (directory / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n")
    (directory / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "CLIPTokenizer", "model_max_length": 77, "bos_token": "<|startoftext|>",
         "eos_token": "<|endoftext|>", "unk_token": "<|endoftext|>", "pad_token": "<|endoftext|>"}))
    return transformers.CLIPTokenizer.from_pretrained(str(directory))


def t5_tokenizer(directory):
    """A real T5 tokenizer (`T5TokenizerFast`, or `T5Tokenizer` where
    transformers has no separate fast class) over a `tokenizers` Unigram
    model written on the spot into `directory` (no download): pad 0, EOS 1,
    unk 2, the lower-case letters and digits with and without a word-start
    marker; EOS appended. Loaded with `from_pretrained`."""
    import transformers
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, processors

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    letters = [chr(c) for c in range(ord("a"), ord("z") + 1)] + [str(d) for d in range(10)]
    pieces = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0), ("\u2581", -2.0)]
    pieces += [("\u2581" + c, -3.0 - i / 100) for i, c in enumerate(letters)]
    pieces += [(c, -4.0 - i / 100) for i, c in enumerate(letters)]
    tok = Tokenizer(models.Unigram(pieces, unk_id=2, byte_fallback=False))
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="\u2581", prepend_scheme="always")
    tok.decoder = decoders.Metaspace(replacement="\u2581", prepend_scheme="always")
    tok.post_processor = processors.TemplateProcessing(single="$A </s>", pair="$A </s> $B </s>",
                                                       special_tokens=[("</s>", 1)])
    tok.save(str(directory / "tokenizer.json"))
    cls = getattr(transformers, "T5TokenizerFast", None) or transformers.T5Tokenizer
    (directory / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": cls.__name__, "model_max_length": 512, "eos_token": "</s>", "unk_token": "<unk>",
         "pad_token": "<pad>", "extra_ids": 0}))
    return cls.from_pretrained(str(directory))


def clip_image_processor():
    """transformers' `CLIPImageProcessor` with Wan2.1-I2V-14B-480P's numbers
    (224 px, bicubic, centre crop, OpenAI CLIP's mean and std); on the card's
    transformers 5.5 without torchvision it is the PIL backend's class."""
    import transformers

    from diffusers_tpu_torch.models.text_encoders.clip import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD

    return transformers.CLIPImageProcessor(size={"shortest_edge": 224}, crop_size={"height": 224, "width": 224},
                                           image_mean=list(OPENAI_CLIP_MEAN), image_std=list(OPENAI_CLIP_STD))


def group_slices(x, groups: int, limit: int = 2**28):
    """(channel slice, its group count) pairs that cover x's channels in
    whole groups, each of at most `limit` elements where a group allows it
    (one slice for x up to `limit`): GroupNorm's plain version runs on them
    one at a time, so that the f32 reference of a multi-GB span (FramePack's
    decode) fits on the card beside the span."""
    per = max(1, min(groups, groups * limit // x.numel()))
    while groups % per:
        per -= 1
    width = x.shape[1] // groups * per
    return [(slice(c, c + width), per) for c in range(0, x.shape[1], width)]


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
    from diffusers_tpu_torch.ops.cuda.group_norm import group_norm

    return {"flash_attention_fwd": flash_attention_full, "flash_attention_bwd_dkdv": flash_attention_bwd_dkdv,
            "flash_attention_bwd_dq": flash_attention_bwd_dq, "group_norm": group_norm,
            "w8a8_matmul": w8a8_matmul_2d, "w8a8_quantize_rows": quantize_rows}


def reset_launches() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in launch_counters().items()}


# ------------------------------------------------------------------ single-file layouts (phase 26 and the CPU tests)
# Each function writes a port model's state dict (diffusers keys) in a community single-file layout: the inverse of
# the converters of `diffusers_tpu_torch.loaders.single_file`. tests/test_torch_single_file.py checks each by a round
# trip through the JAX package's converter.

_LDM_RESNET_INVERSE = {"norm1": "in_layers.0", "conv1": "in_layers.2", "time_emb_proj": "emb_layers.1",
                       "norm2": "out_layers.0", "conv2": "out_layers.3", "conv_shortcut": "skip_connection"}
_LDM_UNET_STATIC_INVERSE = {"time_embedding.linear_1": "time_embed.0", "time_embedding.linear_2": "time_embed.2",
                            "conv_in": "input_blocks.0.0", "conv_norm_out": "out.0", "conv_out": "out.2",
                            "add_embedding.linear_1": "label_emb.0.0", "add_embedding.linear_2": "label_emb.0.2"}


def ldm_unet_keys(state, layers_per_block: int, prefix: str = "model.diffusion_model.") -> dict:
    """A diffusers UNet state dict in the LDM (SGM) layout."""
    per = layers_per_block + 1
    has_attention = {key.split(".")[1] for key in state if key.startswith("up_blocks.") and ".attentions." in key}
    out = {}
    for key, value in state.items():
        parts = key.split(".")
        module, leaf = ".".join(parts[:-1]), parts[-1]
        if module in _LDM_UNET_STATIC_INVERSE:
            new = f"{_LDM_UNET_STATIC_INVERSE[module]}.{leaf}"
        elif parts[0] in ("down_blocks", "up_blocks"):
            b, kind = int(parts[1]), parts[2]
            if kind == "downsamplers":
                new = f"input_blocks.{1 + b * per + layers_per_block}.0.op.{leaf}"
            elif kind == "upsamplers":
                new = f"output_blocks.{b * per + layers_per_block}.{2 if parts[1] in has_attention else 1}.conv.{leaf}"
            else:
                layer = int(parts[3])
                i = 1 + b * per + layer if parts[0] == "down_blocks" else b * per + layer
                name = "input_blocks" if parts[0] == "down_blocks" else "output_blocks"
                rest = parts[4:]
                if kind == "resnets":
                    new = f"{name}.{i}.0.{_LDM_RESNET_INVERSE[rest[0]]}.{'.'.join(rest[1:])}"
                else:
                    new = f"{name}.{i}.1.{'.'.join(rest)}"
        elif parts[0] == "mid_block":
            j = {("resnets", "0"): 0, ("attentions", "0"): 1, ("resnets", "1"): 2}[(parts[1], parts[2])]
            rest = parts[3:]
            if parts[1] == "resnets":
                new = f"middle_block.{j}.{_LDM_RESNET_INVERSE[rest[0]]}.{'.'.join(rest[1:])}"
            else:
                new = f"middle_block.{j}.{'.'.join(rest)}"
        else:
            raise KeyError(f"no LDM name for UNet key {key}")
        out[prefix + new] = value
    return out


_LDM_VAE_STATIC_INVERSE = {"encoder.conv_norm_out": "encoder.norm_out", "decoder.conv_norm_out": "decoder.norm_out"}
_LDM_VAE_ATTENTION_INVERSE = {"group_norm": "norm", "to_q": "q", "to_k": "k", "to_v": "v", "to_out.0": "proj_out"}


def ldm_vae_keys(state, prefix: str = "first_stage_model.") -> dict:
    """A diffusers AutoencoderKL state dict in the LDM layout: the decoder's up
    blocks reversed, the mid block's attention projections as 1x1 convolutions."""
    n_up = len({key.split(".")[2] for key in state if key.startswith("decoder.up_blocks.")})
    out = {}
    for key, value in state.items():
        parts = key.split(".")
        module, leaf = ".".join(parts[:-1]), parts[-1]
        who = parts[0]
        if module in _LDM_VAE_STATIC_INVERSE:
            new = f"{_LDM_VAE_STATIC_INVERSE[module]}.{leaf}"
        elif len(parts) > 2 and parts[1] in ("down_blocks", "up_blocks"):
            i = int(parts[2]) if parts[1] == "down_blocks" else n_up - 1 - int(parts[2])
            stage = "down" if parts[1] == "down_blocks" else "up"
            if parts[3] == "resnets":
                name = "nin_shortcut" if parts[5] == "conv_shortcut" else parts[5]
                new = f"{who}.{stage}.{i}.block.{parts[4]}.{name}.{leaf}"
            else:
                new = f"{who}.{stage}.{i}.{'downsample' if stage == 'down' else 'upsample'}.conv.{leaf}"
        elif len(parts) > 2 and parts[1] == "mid_block":
            if parts[2] == "resnets":
                new = f"{who}.mid.block_{int(parts[3]) + 1}.{'.'.join(parts[4:])}"
            else:
                name = ".".join(parts[4:-1])
                new = f"{who}.mid.attn_1.{_LDM_VAE_ATTENTION_INVERSE[name]}.{leaf}"
                if name != "group_norm" and leaf == "weight":
                    value = value[:, :, None, None]
        else:
            new = key
        out[prefix + new] = value
    return out


def ldm_clip_keys(state, prefix: str = "conditioner.embedders.0.transformer.") -> dict:
    """A CLIP text encoder's state dict under an LDM prefix (SDXL's CLIP-L by
    default; SD 1.x's is ``cond_stage_model.transformer.``), with the
    ``position_ids`` buffer such files carry."""
    import torch

    out = {prefix + key: value for key, value in state.items()}
    n = state["text_model.embeddings.position_embedding.weight"].shape[0]
    out[prefix + "text_model.embeddings.position_ids"] = torch.arange(n)[None]
    return out


def _cat0(*tensors):
    import torch

    return torch.cat(tensors, dim=0)


def _swap_halves(w):
    first, second = w.chunk(2, dim=0)
    return _cat0(second, first)


def bfl_flux_keys(state) -> dict:
    """A diffusers Flux transformer state dict in BFL's original layout."""
    out = {}
    simple = {"time_in.in_layer": "time_text_embed.timestep_embedder.linear_1",
              "time_in.out_layer": "time_text_embed.timestep_embedder.linear_2",
              "vector_in.in_layer": "time_text_embed.text_embedder.linear_1",
              "vector_in.out_layer": "time_text_embed.text_embedder.linear_2",
              "guidance_in.in_layer": "time_text_embed.guidance_embedder.linear_1",
              "guidance_in.out_layer": "time_text_embed.guidance_embedder.linear_2",
              "txt_in": "context_embedder", "img_in": "x_embedder", "final_layer.linear": "proj_out"}
    for dst, src in simple.items():
        if f"{src}.weight" in state:
            out[f"{dst}.weight"], out[f"{dst}.bias"] = state[f"{src}.weight"], state[f"{src}.bias"]
    out["final_layer.adaLN_modulation.1.weight"] = _swap_halves(state["norm_out.linear.weight"])
    out["final_layer.adaLN_modulation.1.bias"] = _swap_halves(state["norm_out.linear.bias"])
    i = 0
    while f"transformer_blocks.{i}.norm1.linear.weight" in state:
        p, s = f"transformer_blocks.{i}.", f"double_blocks.{i}."
        for leaf in ("weight", "bias"):
            out[f"{s}img_mod.lin.{leaf}"] = state[f"{p}norm1.linear.{leaf}"]
            out[f"{s}txt_mod.lin.{leaf}"] = state[f"{p}norm1_context.linear.{leaf}"]
            out[f"{s}img_attn.qkv.{leaf}"] = _cat0(*(state[f"{p}attn.{n}.{leaf}"] for n in ("to_q", "to_k", "to_v")))
            out[f"{s}txt_attn.qkv.{leaf}"] = _cat0(*(state[f"{p}attn.{n}.{leaf}"]
                                                   for n in ("add_q_proj", "add_k_proj", "add_v_proj")))
            for a, b in (("img_mlp.0", "ff.net.0.proj"), ("img_mlp.2", "ff.net.2"),
                         ("txt_mlp.0", "ff_context.net.0.proj"), ("txt_mlp.2", "ff_context.net.2"),
                         ("img_attn.proj", "attn.to_out.0"), ("txt_attn.proj", "attn.to_add_out")):
                out[f"{s}{a}.{leaf}"] = state[f"{p}{b}.{leaf}"]
        out[f"{s}img_attn.norm.query_norm.scale"] = state[f"{p}attn.norm_q.weight"]
        out[f"{s}img_attn.norm.key_norm.scale"] = state[f"{p}attn.norm_k.weight"]
        out[f"{s}txt_attn.norm.query_norm.scale"] = state[f"{p}attn.norm_added_q.weight"]
        out[f"{s}txt_attn.norm.key_norm.scale"] = state[f"{p}attn.norm_added_k.weight"]
        i += 1
    i = 0
    while f"single_transformer_blocks.{i}.norm.linear.weight" in state:
        p, s = f"single_transformer_blocks.{i}.", f"single_blocks.{i}."
        for leaf in ("weight", "bias"):
            out[f"{s}modulation.lin.{leaf}"] = state[f"{p}norm.linear.{leaf}"]
            out[f"{s}linear1.{leaf}"] = _cat0(*(state[f"{p}{n}.{leaf}"]
                                                for n in ("attn.to_q", "attn.to_k", "attn.to_v", "proj_mlp")))
            out[f"{s}linear2.{leaf}"] = state[f"{p}proj_out.{leaf}"]
        out[f"{s}norm.query_norm.scale"] = state[f"{p}attn.norm_q.weight"]
        out[f"{s}norm.key_norm.scale"] = state[f"{p}attn.norm_k.weight"]
        i += 1
    return out


def sai_sd3_keys(state, pos_embed) -> dict:
    """A diffusers SD3 transformer state dict in SAI's MMDiT layout, with its
    sin-cos table `pos_embed` ([1, m², D]) as SAI files carry it."""
    out = {"pos_embed": pos_embed, "x_embedder.proj.weight": state["pos_embed.proj.weight"],
           "x_embedder.proj.bias": state["pos_embed.proj.bias"]}
    for ours, theirs in (("time_text_embed.timestep_embedder.linear_1", "t_embedder.mlp.0"),
                         ("time_text_embed.timestep_embedder.linear_2", "t_embedder.mlp.2"),
                         ("time_text_embed.text_embedder.linear_1", "y_embedder.mlp.0"),
                         ("time_text_embed.text_embedder.linear_2", "y_embedder.mlp.2"),
                         ("context_embedder", "context_embedder"), ("proj_out", "final_layer.linear")):
        for leaf in ("weight", "bias"):
            out[f"{theirs}.{leaf}"] = state[f"{ours}.{leaf}"]
    for leaf in ("weight", "bias"):
        out[f"final_layer.adaLN_modulation.1.{leaf}"] = _swap_halves(state[f"norm_out.linear.{leaf}"])
    n = 1 + max(int(k.split(".")[1]) for k in state if k.startswith("transformer_blocks."))
    for i in range(n):
        p, s, last = f"transformer_blocks.{i}.", f"joint_blocks.{i}.", i == n - 1
        for leaf in ("weight", "bias"):
            out[f"{s}x_block.attn.qkv.{leaf}"] = _cat0(*(state[f"{p}attn.{x}.{leaf}"]
                                                       for x in ("to_q", "to_k", "to_v")))
            out[f"{s}context_block.attn.qkv.{leaf}"] = _cat0(*(state[f"{p}attn.{x}.{leaf}"]
                                                             for x in ("add_q_proj", "add_k_proj", "add_v_proj")))
            out[f"{s}x_block.attn.proj.{leaf}"] = state[f"{p}attn.to_out.0.{leaf}"]
            out[f"{s}x_block.adaLN_modulation.1.{leaf}"] = state[f"{p}norm1.linear.{leaf}"]
            ctx = state[f"{p}norm1_context.linear.{leaf}"]
            out[f"{s}context_block.adaLN_modulation.1.{leaf}"] = _swap_halves(ctx) if last else ctx
            blocks = (("x_block", "ff"),) if last else (("x_block", "ff"), ("context_block", "ff_context"))
            for block, ff in blocks:
                out[f"{s}{block}.mlp.fc1.{leaf}"] = state[f"{p}{ff}.net.0.proj.{leaf}"]
                out[f"{s}{block}.mlp.fc2.{leaf}"] = state[f"{p}{ff}.net.2.{leaf}"]
            if not last:
                out[f"{s}context_block.attn.proj.{leaf}"] = state[f"{p}attn.to_add_out.{leaf}"]
            if f"{p}attn2.to_q.weight" in state:
                out[f"{s}x_block.attn2.qkv.{leaf}"] = _cat0(*(state[f"{p}attn2.{x}.{leaf}"]
                                                            for x in ("to_q", "to_k", "to_v")))
                out[f"{s}x_block.attn2.proj.{leaf}"] = state[f"{p}attn2.to_out.0.{leaf}"]
        for ours, theirs in (("attn.norm_q", "x_block.attn.ln_q"), ("attn.norm_k", "x_block.attn.ln_k"),
                             ("attn.norm_added_q", "context_block.attn.ln_q"),
                             ("attn.norm_added_k", "context_block.attn.ln_k"),
                             ("attn2.norm_q", "x_block.attn2.ln_q"), ("attn2.norm_k", "x_block.attn2.ln_k")):
            if f"{p}{ours}.weight" in state:
                out[f"{s}{theirs}.weight"] = state[f"{p}{ours}.weight"]
    return out


_WAN_INVERSE = [  # diffusers -> original, applied in order (the converter's table backwards)
    ("condition_embedder.image_embedder.norm1", "img_emb.proj.0"),
    ("condition_embedder.image_embedder.ff.net.0.proj", "img_emb.proj.1"),
    ("condition_embedder.image_embedder.ff.net.2", "img_emb.proj.3"),
    ("condition_embedder.image_embedder.norm2", "img_emb.proj.4"),
    ("condition_embedder.time_embedder.linear_1", "time_embedding.0"),
    ("condition_embedder.time_embedder.linear_2", "time_embedding.2"),
    ("condition_embedder.text_embedder.linear_1", "text_embedding.0"),
    ("condition_embedder.text_embedder.linear_2", "text_embedding.2"),
    ("condition_embedder.time_proj", "time_projection.1"),
    ("attn2", "cross_attn"), ("attn1", "self_attn"),
    (".to_out.0.", ".o."), (".to_q.", ".q."), (".to_k.", ".k."), (".to_v.", ".v."),
    (".add_k_proj.", ".k_img."), (".add_v_proj.", ".v_img."), (".norm_added_k.", ".norm_k_img."),
    ("ffn.net.0.proj", "ffn.0"), ("ffn.net.2", "ffn.2"),
    ("norm2", "norm__placeholder"), ("norm3", "norm2"), ("norm__placeholder", "norm3"),
]


def wan_original_keys(state) -> dict:
    """A diffusers Wan transformer state dict in Wan's original layout."""
    out = {}
    for key, value in state.items():
        if key == "scale_shift_table":
            new = "head.modulation"
        elif key.startswith("proj_out."):
            new = "head.head." + key[len("proj_out."):]
        else:
            new = key.replace("scale_shift_table", "modulation")
            for ours, theirs in _WAN_INVERSE:
                new = new.replace(ours, theirs)
        out[new] = value
    return out


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
    dynamic shared memory of K1's, K2's, K3's and K5's launches (K4's is per
    shape, in phase 4)."""
    from diffusers_tpu_torch.ops.cuda import _build, flash_attention, group_norm, w8a8_matmul

    sources = (flash_attention.SOURCE, flash_attention.BWD_SOURCE, w8a8_matmul.SOURCE, group_norm.SOURCE)
    t0 = time.perf_counter()
    _build.build_all(sources)
    for load in (flash_attention.load_library, flash_attention.load_bwd_library, w8a8_matmul.load_library,
                 group_norm.load_library):
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
    """Phase 3: K1 against its plain version at the main paths' shapes, bf16,
    and on a row that an additive finfo.min hides entirely (NaN out and -inf
    LSE on both sides, the other rows within the bound); K1 as the
    forward-only flash attention (K6's counterpart), whose causal calls at
    lengths that are not multiples of 128 go to `native` as JAX's do."""
    import torch
    import torch.nn.functional as F

    from diffusers_tpu_torch.ops.attention import _native_attention
    from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention, flash_attention_full, flash_attention_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = []

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale).to(dtype)

    # --- K1: flash attention forward
    attn_cases = [
        # (label, q shape, kv length, options, timed)
        ("Flux joint 4608 d=128", (1, 4608, 24, 128), 4608, {}, True),
        # FLUX.1-Kontext-dev at 1024 px with a 1024 px reference: 512 text + 4096 target + 4096 reference tokens
        ("Flux Kontext joint 8704 d=128", KONTEXT_JOINT_ATTENTION, KONTEXT_JOINT_ATTENTION[1], {}, True),
        ("self 4096 (UNet level 2)", (2, 4096, 10, 64), 4096, {}, True),
        ("self 1024 (UNet level 3)", (2, 1024, 20, 64), 1024, {}, True),
        ("cross 4096 x 77 (UNet level 2)", (2, 4096, 10, 64), 77, {}, True),
        ("cross 1024 x 77 (UNet level 3)", (2, 1024, 20, 64), 77, {}, True),
        # SD3.5 Medium at 1024 px under CFG: the joint attention over 4096 image + 333 text tokens (a ragged
        # last q tile: 4429 = 34 x 128 + 77), the dual blocks' attn2 over the image tokens, and the joint
        # attention of a coalesced pair of requests
        ("SD3 joint 4429 d=64", (2, 4429, 24, 64), 4429, {}, True),
        ("SD3.5 attn2 4096 d=64", (2, 4096, 24, 64), 4096, {}, True),
        ("SD3 joint 4429 d=64, coalesced pair", (4, 4429, 24, 64), 4429, {}, False),
        # Wan2.1-T2V-1.3B at 480 x 832 x 81: the cross attention over 512 text tokens (a ragged last q tile: 32760
        # = 255 x 128 + 120); the self attention is checked apart (check_k1_wan_self)
        ("Wan cross 32760 x 512 d=128", (1, WAN_TOKENS, 12, 128), 512, {}, True),
        # Wan2.1-I2V-14B-480P's 40 heads: the text cross attention over 512 tokens, the image cross attention over
        # 257 CLIP tokens (2 x 128 + 1 keys), and Wan2.1-FLF2V's over 514 (4 x 128 + 2)
        ("Wan 14B cross 32760 x 512 d=128", (1, WAN_TOKENS, 40, 128), 512, {}, True),
        ("Wan 14B image cross 32760 x 257 d=128", (1, WAN_TOKENS, 40, 128), 257, {}, True),
        ("Wan FLF image cross 32760 x 514 d=128", (1, WAN_TOKENS, 40, 128), 514, {}, True),
        # Wan2.2-Animate-14B at 720 x 1280: the face adapter, each of 21 latent frames' 3,600 tokens over that
        # frame's 5 motion tokens (one ragged kv tile)
        ("Animate face cross (21, 3600) x 5 d=128", (21, 3600, 40, 128), 5, {}, True),
        # SkyReels-V2 with 2 frames a block: the bool block-causal keep-mask (4 frames of 96 tokens)
        ("SkyReels block-causal bool mask 384, d=128", (1, 384, 2, 128), 384, {"mask": "block_causal"}, False),
        ("causal 300 (ragged)", (1, 300, 2, 64), 300, {"is_causal": True}, False),
        ("additive mask 200 x 333, d=128", (1, 200, 2, 128), 333, {"mask": True}, False),
        ("fp16 d=128 500 x 700", (1, 500, 3, 128), 700, {"dtype": torch.float16}, False),
        ("mask -inf over the first 160 keys of every other row, d=128", (2, 300, 2, 128), 333, {"mask": "hide"},
         False),
        ("mask finfo.min over every key of one query row", (1, 128, 1, 64), 128, {"mask": "row"}, False),
        # SD3.5 PAG's perturbed call at 1024 px: the joint attention under the identity mask (the image block
        # the identity, the 333 text keys open: `pag_identity_mask`), a dense float32 [1, 1, 4429, 4429] mask
        ("SD3 PAG identity mask 4429 d=64", SD3_PAG_ATTENTION, SD3_PAG_ATTENTION[1], {"mask": "pag"}, False),
        *IP_K1_CASES,
        # Qwen-Image at 1024 px under true CFG: the joint attention over 1,024 padded text + 4,096 image tokens,
        # open and under the key-padding bias (-inf on the padded text keys: whole 128-key tiles in the middle of
        # every row hidden, the first only in part); LTX-Video at 512 x 704 x 161: the cross attention over 128 T5
        # tokens under its -10000 bias and open (the self attention is checked apart, check_k1_wan_self)
        ("Qwen joint 5120 d=128", QWEN_JOINT_ATTENTION, QWEN_JOINT_ATTENTION[1], {}, True),
        ("Qwen joint 5120 d=128, key-padding bias", QWEN_JOINT_ATTENTION, QWEN_JOINT_ATTENTION[1], {"mask": "qwen"},
         True),
        ("LTX cross 7392 x 128 d=64", LTX_SELF_ATTENTION, LTX_TEXT_LEN, {}, True),
        ("LTX cross 7392 x 128 d=64, -10000 bias", LTX_SELF_ATTENTION, LTX_TEXT_LEN, {"mask": "ltx"}, True),
        # HunyuanVideo's token refiner over 256 text tokens under its 2-D keep-mask (a prompt of 12 kept tokens:
        # the padded query rows keep key 0 alone); its joint attention is checked apart (check_k1_wan_self)
        ("HunyuanVideo refiner 256 d=128, 2-D mask", HUNYUAN_REFINER_ATTENTION, HUNYUAN_TEXT_LEN,
         {"mask": "hunyuan_refiner"}, True),
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
        elif opt.get("mask") == "row":  # every logit of row 5 below NEG_INF: NaN out, -inf LSE (JAX's rule)
            mask = torch.zeros((b, 1, sq, sk), device=dev)
            mask[:, :, 5, :] = torch.finfo(torch.float32).min
        elif opt.get("mask") == "pag":
            from diffusers_tpu_torch.models.transformers.transformer_sd3 import pag_identity_mask

            mask = pag_identity_mask(sq, SD3_IMAGE_TOKENS, dev)
        elif opt.get("mask") == "block_causal":  # SkyReelsV2Transformer3DModel.causal_mask of a (4, 8, 12) grid
            from diffusers_tpu_torch.models.transformers.transformer_skyreels_v2 import SkyReelsV2Transformer3DModel

            with torch.device("meta"):
                sky = SkyReelsV2Transformer3DModel(num_attention_heads=2, num_layers=0, num_frame_per_block=2)
            mask = torch.from_numpy(sky.causal_mask(4, 8, 12).copy()).to(dev)
        elif opt.get("mask") in ("qwen", "ltx", "hunyuan_refiner"):
            mask = key_padding_bias(opt["mask"], b, dev)
        elif opt.get("mask"):
            mask = torch.where(torch.rand((b, 1, sq, sk), generator=gen, device=dev) < 0.3, -1e4, 0.0)
        causal = opt.get("is_causal", False)
        out, lse = flash_attention_full(q, k, v, attn_mask=mask, is_causal=causal, return_lse=True)
        torch.cuda.synchronize()
        ref32, bound32, bound16 = attention_bounds(q, k, v, attn_mask=mask, is_causal=causal)
        ref16, ref_lse = flash_attention_plain(q, k, v, attn_mask=mask, is_causal=causal, return_lse=True)
        # the plain version's NaN rows (a row with every logit hidden) must be the kernel's; the rest
        # is held to the bound
        fin = torch.isfinite(ref32)
        same_pattern = torch.equal(torch.isnan(out), torch.isnan(ref32)) and torch.equal(
            torch.isinf(lse), torch.isinf(ref_lse))
        diff32 = torch.where(fin, out.float() - ref32, 0.0).abs()
        diff16 = torch.where(fin, out.float() - ref16.float(), 0.0).abs()
        err32 = float(diff32.max())
        err16 = float(diff16.max())
        used32 = float(torch.where(fin, diff32 / bound32, 0.0).max())
        used16 = float(torch.where(fin, diff16 / bound16, 0.0).max())
        row = {"kernel": "flash_attention_fwd", "case": label, "q": list(qshape), "sk": sk, "dtype": str(dtype),
               "max_abs_err_vs_f32": err32, "max_abs_err_vs_plain_same_dtype": err16,
               "max_share_of_bound_vs_f32": used32, "max_share_of_bound_vs_plain_same_dtype": used16,
               "max_bound_vs_f32": float(torch.where(fin, bound32, 0.0).max()),
               "non_finite_rows_as_plain": same_pattern, "nan_outputs": int(torch.isnan(out).sum())}
        if timed:
            # under a mask: SDPA with the same keys as a bool keep-mask; the bound reads the mask once and counts
            # only the kept (query, key) pairs, since a hidden key's products add exactly 0
            keep = None if mask is None else mask if mask.dtype == torch.bool else mask == 0
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def kernel():
                return flash_attention_full(q, k, v, attn_mask=mask)

            def library():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep)

            ms, plain_ms = time_pair(kernel, lambda: flash_attention_plain(q, k, v, attn_mask=mask), iters=20,
                                     plain_iters=5)
            library_ms = time_ms(library, iters=20)
            kept_share = 1.0 if mask is None else float(keep.float().mean())
            flops = 4.0 * b * h * sq * sk * d * kept_share
            nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
            if mask is not None:
                nbytes += mask.numel() * mask.element_size()
            bms, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
            row.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms, bound_by=by,
                       kept_pair_share=kept_share, tflops=flops / ms / 1e9, share_of_time_bound=bms / ms,
                       device_ms=graph_ms(kernel), library_device_ms=graph_ms(library),
                       host_us_per_call=host_us(kernel))
            k1_times[label] = row
        log(f"[K1] {label}: err vs f32 {err32:.3e}, vs plain {err16:.3e}; share of the per-element bound "
            f"{used32:.3f} / {used16:.3f}"
            + (f", kernel {row['ms']:.4f} ms ({row['tflops']:.1f} TFLOP/s, {100 * row['share_of_time_bound']:.1f}% "
               f"of its bound), plain {row['plain_ms']:.3f} ms, SDPA {row['library_ms']:.4f} ms, bound "
               f"{row['bound_ms']:.4f} ms; device time (CUDA graph) {row['device_ms']:.4f} ms, SDPA "
               f"{row['library_device_ms']:.4f} ms; host {row['host_us_per_call']:.1f} us a call" if timed else ""))
        if not (used32 <= 1.0 and used16 <= 1.0 and same_pattern and torch.isfinite(out[fin]).all()):
            raise AssertionError(f"flash_attention_fwd disagrees with its plain version on {label}")
        if sq % 128 and mask is None and not causal:
            # the ragged last q tile: its rows past seq_q are neither stored nor let into the LSE
            tail = sq // 128 * 128
            logits = torch.einsum("bqhd,bkhd->bhqk", q[:, tail:].float(), k.float()) / math.sqrt(d)
            tail_err = float((lse[:, :, tail:] - torch.logsumexp(logits, dim=-1)).abs().max())
            row["ragged_tail_rows"], row["ragged_tail_lse_err"] = sq - tail, tail_err
            log(f"[K1]   ragged last q tile ({sq - tail} of 128 rows): LSE err vs torch.logsumexp {tail_err:.3e} "
                "(tol 1e-3)")
            if not tail_err <= 1e-3:
                raise AssertionError(f"flash_attention_fwd's LSE of the ragged last q tile is wrong on {label}")
        if timed and mask is None:
            # controls: outputs of a partly wrong kernel must break the bound
            t0 = (sk // 2) // 64 * 64  # 64 keys from the middle (one key of a single short kv tile)
            drop = 64 if sk > 64 else 1
            t0 = t0 if sk > 64 else sk // 2
            keep = torch.cat([torch.arange(t0, device=dev), torch.arange(min(t0 + drop, sk), sk, device=dev)])
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

    RESULTS["k1_pag_mask"] = check_k1_pag_mask(randn)
    # the key-padding biases against the open calls at the same shapes, each with its own bound
    RESULTS["k1_key_padding"] = {}
    for name, label, bias in (("qwen_joint", "Qwen joint 5120 d=128", "key-padding bias"),
                              ("ltx_cross", "LTX cross 7392 x 128 d=64", "-10000 bias")):
        masked, open_ = k1_times[f"{label}, {bias}"], k1_times[label]
        RESULTS["k1_key_padding"][name] = record = {
            "masked_ms": masked["ms"], "open_ms": open_["ms"], "gap_ms": masked["ms"] - open_["ms"],
            "masked_device_ms": masked["device_ms"], "open_device_ms": open_["device_ms"],
            "masked_bound_ms": masked["bound_ms"], "masked_bound_by": masked["bound_by"],
            "open_bound_ms": open_["bound_ms"], "open_bound_by": open_["bound_by"],
            "kept_pair_share": masked["kept_pair_share"], "plain_masked_ms": masked["plain_ms"],
            "library_masked_ms": masked["library_ms"], "library_open_ms": open_["library_ms"]}
        log(f"[K1] {label} under its {bias} (pairs kept {100 * record['kept_pair_share']:.1f}%): masked "
            f"{record['masked_ms']:.4f} ms (bound {record['masked_bound_ms']:.4f}, {record['masked_bound_by']}) "
            f"against {record['open_ms']:.4f} open (bound {record['open_bound_ms']:.4f}), gap "
            f"{record['gap_ms']:.4f} ms; SDPA {record['library_masked_ms']:.4f} with the bool keep-mask, "
            f"{record['library_open_ms']:.4f} open")

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
    # causal at lengths JAX's `_flash_kernel` does not tile goes to `native` (bottom-right aligned), as in JAX
    q, k, v = randn(1, 200, 2, 128, scale=2.0), randn(1, 300, 2, 128), randn(1, 300, 2, 128)
    before = flash_attention_full.launches
    out = flash_attention(q, k, v, is_causal=True)
    routed = flash_attention_full.launches == before and torch.equal(out, _native_attention(q, k, v, is_causal=True))
    cases.append({"kernel": "flash_attention (K6)", "case": "causal 200 x 300 routed to native", "ok": routed})
    log(f"[K6] flash_attention causal 200 x 300: routed to native (no K1 launch, native's output) {routed}")
    if not routed:
        raise AssertionError("flash_attention does not route a causal call at untiled lengths to native")

    for shape, chunk, iters in ((WAN_SELF_ATTENTION, WAN_Q_CHUNK, 10), (WAN_14B_SELF_ATTENTION, WAN_14B_Q_CHUNK, 10),
                                (WAN_VACE_BATCH2_SELF_ATTENTION, WAN_VACE_Q_CHUNK, 5),
                                (SKYREELS_SELF_ATTENTION, WAN_14B_Q_CHUNK, 3),
                                (WAN_ANIMATE_SELF_ATTENTION, WAN_14B_Q_CHUNK, 3),
                                (LTX_SELF_ATTENTION, WAN_Q_CHUNK, 10)):
        wan_self = check_k1_wan_self(randn, shape, chunk, iters, name="LTX self" if shape == LTX_SELF_ATTENTION
                                     else "Wan self")
        cases.append(wan_self)
        k1_errs.append(wan_self["max_abs_err_vs_f32"])
    # HunyuanVideo at 320 x 512 x 61: the joint attention over 10,240 image + 256 text tokens under the
    # key-padding bias (the text keys past the prompt's 12 hidden: two 128-key tiles, the first in part)
    hunyuan = check_k1_wan_self(randn, HUNYUAN_JOINT_ATTENTION, WAN_Q_CHUNK, 10, name="HunyuanVideo joint",
                                mask=key_padding_bias("hunyuan", HUNYUAN_JOINT_ATTENTION[0], dev))
    cases.append(hunyuan)
    k1_errs.append(hunyuan["max_abs_err_vs_f32"])
    RESULTS["k1_hunyuan_joint"] = hunyuan
    # FramePack at 832 x 480: 11,726 image + 729 SigLIP + 256 text tokens under the key-padding bias, a ragged last
    # query tile (39 rows, their LSE checked) and a last key tile the bias hides whole
    framepack = check_k1_wan_self(randn, FRAMEPACK_JOINT_ATTENTION, WAN_Q_CHUNK, 10, name="FramePack joint",
                                  mask=key_padding_bias("framepack", FRAMEPACK_JOINT_ATTENTION[0], dev))
    cases.append(framepack)
    k1_errs.append(framepack["max_abs_err_vs_f32"])
    RESULTS["k1_framepack_joint"] = framepack
    RESULTS["kernel_cases"] = cases
    return {"flash_attention_fwd": (max(k1_errs + [lse_err]), k1_times["Flux joint 4608 d=128"])}


def check_k1_pag_mask(randn):
    """Phase 3, PAG's mask: K1 on SD3_PAG_ATTENTION under `pag_identity_mask`
    (read per element through its broadcast strides, no copy) against the
    unmasked call at the same shape, in turns (open, masked, masked, open)
    on CUDA events and as device time (CUDA graphs), with the plain version
    and SDPA under the same mask (SDPA's as a bool keep-mask) beside them.
    The bound adds the mask's bytes, read once, to the call's. Returns the
    record."""
    import torch
    import torch.nn.functional as F

    from diffusers_tpu_torch.models.transformers.transformer_sd3 import pag_identity_mask
    from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention_full, flash_attention_plain

    b, sq, h, d = SD3_PAG_ATTENTION
    q, k, v = randn(b, sq, h, d, scale=2.0), randn(b, sq, h, d), randn(b, sq, h, d)
    mask = pag_identity_mask(sq, SD3_IMAGE_TOKENS, q.device)
    keep = mask == 0

    def masked():
        return flash_attention_full(q, k, v, attn_mask=mask)

    def open_():
        return flash_attention_full(q, k, v)

    masked_ms, open_ms = time_pair(masked, open_, iters=20)
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, attn_mask=mask), iters=3)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep), iters=10)
    flops = 4.0 * b * h * sq * sq * d
    bms, by = bound_ms(2 * 4 * q.numel() + 4 * mask.numel(), flops, PEAK_BF16_FLOPS)
    record = {"q": list(SD3_PAG_ATTENTION), "mask_bytes": 4 * mask.numel(), "masked_ms": masked_ms,
              "open_ms": open_ms, "gap_ms": masked_ms - open_ms, "masked_device_ms": graph_ms(masked),
              "open_device_ms": graph_ms(open_), "plain_masked_ms": plain_ms, "library_masked_ms": library_ms,
              "bound_ms": bms, "bound_by": by}
    log(f"[K1] SD3 PAG identity mask {SD3_PAG_ATTENTION}: masked {masked_ms:.4f} ms against {open_ms:.4f} ms "
        f"unmasked (CUDA events, in turns; device {record['masked_device_ms']:.4f} / {record['open_device_ms']:.4f} "
        f"ms), gap {record['gap_ms']:.4f} ms; the plain version {plain_ms:.3f} ms, SDPA with the bool mask "
        f"{library_ms:.4f} ms; bound {bms:.4f} ms ({by}, the mask's {record['mask_bytes'] / 1e6:.1f} MB included)")
    return record


def key_padding_bias(kind, batch, device):
    """The mask the model hands K1, built by the model's own code from a text
    keep-mask whose row i keeps its first `kept[i]` tokens: an f32 [batch,
    1, 1, S] bias for Qwen-Image's joint attention ("qwen": `-inf` on the
    padded text keys of 1,024, then 4,096 open image keys), LTX's cross
    attention ("ltx": `-10000` on the padded keys of 128 T5 tokens),
    HunyuanVideo's joint attention ("hunyuan": 10,240 open image keys, then
    `-inf` on the padded text keys of 256) and FramePack's ("framepack":
    11,726 open image keys and 729 open SigLIP keys, then the text keys as
    HunyuanVideo's); the bool [batch, 1, 256, 256] keep-mask of
    HunyuanVideo's token refiner ("hunyuan_refiner": kept query and key, or
    key 0)."""
    import torch

    from diffusers_tpu_torch.models.transformers.transformer_hunyuan_video import refiner_mask, validity_bias
    from diffusers_tpu_torch.models.transformers.transformer_ltx import cross_attention_bias
    from diffusers_tpu_torch.models.transformers.transformer_qwenimage import key_padding_bias as qwen_bias

    kept, text = {"qwen": (QWEN_KEPT_TEXT, QWEN_TEXT_LEN), "ltx": (LTX_KEPT_TEXT, LTX_TEXT_LEN)}.get(
        kind, (HUNYUAN_KEPT_TEXT, HUNYUAN_TEXT_LEN))
    lengths = torch.tensor([kept[i % len(kept)] for i in range(batch)], device=device)
    keep = (torch.arange(text, device=device)[None] < lengths[:, None]).long()
    if kind == "qwen":
        return qwen_bias(keep, QWEN_JOINT_ATTENTION[1] - QWEN_TEXT_LEN)
    if kind == "hunyuan":
        return validity_bias(keep, HUNYUAN_TOKENS)
    if kind == "framepack":
        siglip = torch.ones((batch, FRAMEPACK_IMAGE_TOKENS), dtype=keep.dtype, device=device)
        return validity_bias(torch.cat([siglip, keep], dim=1), FRAMEPACK_TOKENS)
    if kind == "hunyuan_refiner":
        return refiner_mask(keep)
    return cross_attention_bias(keep)


def check_k1_wan_self(randn, shape, chunk, iters=10, name="Wan self", mask=None):
    """Phase 3, long self attentions: K1 at `shape` ((1, 32760, 12, 128) for
    Wan's 1.3B model, (1, 32760, 40, 128) for the 14B, (2, 32760, 12, 128) for
    VACE's CFG batch, (1, 51000, 40, 128) for SkyReels-V2 at 544 x 960 x 97,
    (1, 75600, 40, 128) for Animate at 720 x 1280; LTX-Video's (2, 7392, 32,
    64) at 512 x 704 x 161 under `name` "LTX self"; HunyuanVideo's joint
    attention (1, 10496, 24, 128) and FramePack's (1, 12711, 24, 128) under
    their key-padding bias `mask`, an f32 [B, 1, 1, S] broadcast over the
    queries), bf16, held to
    `attention_bounds` over every query row and every head, `chunk` query
    rows at a time (the plain version of the whole would hold an h x 32760²
    f32 logit matrix, 51.5 GB at 12 heads); a ragged last q tile's rows and
    their LSE; controls that must break the bound (on the first chunk: a
    64-key span of kept keys dropped, the last kv tile that holds a kept key
    dropped, rows misscaled); the kernel's time on events, its device time
    (CUDA graph), its bound (over the kept pairs), SDPA's time (a bool
    keep-mask under a bias), and the plain version's time computing the
    whole output chunk by chunk."""
    import torch
    import torch.nn.functional as F

    from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention_full, flash_attention_plain

    b, sq, h, d = shape
    label = f"{name} {sq} x {h} heads d={d}" + (f", batch {b}" if b > 1 else "")
    q, k, v = randn(b, sq, h, d, scale=2.0), randn(b, sq, h, d), randn(b, sq, h, d)
    out, lse = flash_attention_full(q, k, v, attn_mask=mask, return_lse=True)
    torch.cuda.synchronize()

    def cols(idx):  # the mask's columns of the kept keys `idx`
        return None if mask is None else mask[..., idx]

    err32 = err16 = used32 = used16 = 0.0
    for start in range(0, sq, chunk):
        qs, o = q[:, start:start + chunk], out[:, start:start + chunk].float()
        ref32, bound32, bound16 = attention_bounds(qs, k, v, attn_mask=mask)
        ref16 = flash_attention_plain(qs, k, v, attn_mask=mask).float()
        err32, err16 = max(err32, float((o - ref32).abs().max())), max(err16, float((o - ref16).abs().max()))
        used32 = max(used32, float(((o - ref32).abs() / bound32).max()))
        used16 = max(used16, float(((o - ref16).abs() / bound16).max()))
        if start == 0:  # controls: outputs of a partly wrong kernel must break the bound
            drop = 16384 if sq > 16448 else sq // 2 // 64 * 64  # 64 keys from the middle
            keep = torch.cat([torch.arange(drop, device=q.device), torch.arange(drop + 64, sq, device=q.device)])
            kept = torch.arange(sq, device=q.device) if mask is None else (mask[0, 0, 0] == 0).nonzero()[:, 0]
            last = int(kept[-1]) // 128 * 128  # the last kv tile that holds a kept key
            no_last = torch.cat([torch.arange(last, device=q.device),
                                 torch.arange(min(last + 128, sq), sq, device=q.device)])
            controls = {
                "kv_tile_dropped": float(((flash_attention_full(qs, k[:, keep], v[:, keep], attn_mask=cols(keep))
                                           .float() - ref32).abs() / bound32).max()),
                "last_kv_tile_dropped": float(((flash_attention_full(qs, k[:, no_last], v[:, no_last],
                                                                     attn_mask=cols(no_last)).float() - ref32)
                                               .abs() / bound32).max()),
                "rows_misscaled": float(((o[:, ::64] * (1 + 2.0**-5) - ref32[:, ::64]).abs() / bound32[:, ::64]).max()),
            }
        del ref32, bound32, bound16, ref16
    tail = sq // 128 * 128
    tail_err = 0.0
    if tail < sq:
        logits = torch.einsum("bqhd,bkhd->bhqk", q[:, tail:].float(), k.float()) / math.sqrt(d)
        if mask is not None:
            logits = logits + mask.float()
        tail_err = float((lse[:, :, tail:] - torch.logsumexp(logits, dim=-1)).abs().max())
    keep_mask = None if mask is None else mask == 0
    kept_share = 1.0 if mask is None else float(keep_mask.float().mean())
    flops = 4.0 * b * h * sq * sq * d * kept_share
    nbytes = 2 * 4 * q.numel() + (0 if mask is None else mask.numel() * mask.element_size())
    bms, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
    ms = (time_ms(lambda: flash_attention_full(q, k, v, attn_mask=mask), iters=iters)
          + time_ms(lambda: flash_attention_full(q, k, v, attn_mask=mask), iters=iters)) / 2
    plain_ms = time_ms(lambda: [flash_attention_plain(q[:, i:i + chunk], k, v, attn_mask=mask)
                                for i in range(0, sq, chunk)], iters=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    row = {"kernel": "flash_attention_fwd", "case": label, "q": list(shape), "sk": sq,
           "dtype": "torch.bfloat16", "checked": f"every query row and head, {chunk} rows at a time",
           "key_padding_bias": mask is not None, "kept_pair_share": kept_share,
           "max_abs_err_vs_f32": err32, "max_abs_err_vs_plain_same_dtype": err16,
           "max_share_of_bound_vs_f32": used32, "max_share_of_bound_vs_plain_same_dtype": used16,
           "ragged_tail_rows": sq - tail, "ragged_tail_lse_err": tail_err, "controls_share_of_bound": controls,
           "ms": ms, "plain_ms": plain_ms, "plain": f"chunked, {chunk} query rows a call",
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep_mask), iters=iters),
           "bound_ms": bms, "bound_by": by, "tflops": flops / ms / 1e9, "share_of_time_bound": bms / ms,
           "device_ms": graph_ms(lambda: flash_attention_full(q, k, v, attn_mask=mask), iters=min(iters, 5)),
           "library_device_ms": graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep_mask),
                                         iters=min(iters, 5)),
           "host_us_per_call": host_us(lambda: flash_attention_full(q, k, v, attn_mask=mask), iters=min(iters, 5))}
    log(f"[K1] {label}{' under its key-padding bias' if mask is not None else ''} (every query row of every head, "
        f"{chunk} rows at a time): err vs f32 {err32:.3e}, vs plain {err16:.3e}; share of the per-element bound "
        f"{used32:.3f} / {used16:.3f}; ragged last q tile ({sq - tail} rows): LSE err {tail_err:.3e} (tol 1e-3); "
        f"controls {controls}; kernel {ms:.3f} ms ({row['tflops']:.1f} TFLOP/s, {100 * bms / ms:.1f}% of its bound), "
        f"device {row['device_ms']:.3f} ms, SDPA {row['library_ms']:.3f} ms (device {row['library_device_ms']:.3f}), "
        f"bound {bms:.3f} ms, plain (chunked) {plain_ms:.1f} ms")
    if not (used32 <= 1.0 and used16 <= 1.0 and tail_err <= 1e-3 and torch.isfinite(out).all()):
        raise AssertionError(f"flash_attention_fwd disagrees with its plain version at {label}")
    if min(controls.values()) <= 1.0:
        raise AssertionError(f"the flash_attention_fwd bound does not reject a broken output at {label}")
    return row


def check_group_norm():
    """Phase 4: K4 against its plain version at every GroupNorm of an SDXL
    UNet call and a VAE decode (`GN_UNET_CALL`, `GN_VAE_DECODE`), at the
    VAE encoder's two shapes that the decoder lacks (`GN_VAE_ENCODE`), and at
    every GroupNorm of an SD 1.5 UNet call at 512 px and of a 512 px decode
    (`GN_SD15_UNET_CALL`, `GN_VAE_DECODE_512`: SD 1.5's, and each tile of a
    tiled decode), and at the largest spans of the LTX upsampler and of
    HunyuanVideo's and FramePack's VAEs (`GN_LTX_UPSAMPLER`, `GN_HUNYUAN_VAE`,
    `GN_FRAMEPACK_VAE`), bf16: one bf16 ulp at the reference's largest
    magnitude against the f32 plain version and the bf16 one (on a span over
    2^28 elements, a few groups at a time: `group_slices`), two launches
    bit-identical, one launch a call.
    Controls (one case of each regime): a launch that leaves one partial out
    of the statistics, on inputs whose chunk of that partial is shifted by
    20, must break the limit. For each case: the plan, its shared memory,
    device time (CUDA graph), events time against the plain version, host
    time a call, GB/s and share of the 2 x bytes bound, and `F.group_norm`
    (+ `F.silu`) on events and in device time; then the sums over one UNet
    call's 46 launches and one VAE decode's 30."""
    import torch
    import torch.nn.functional as F

    from diffusers_tpu_torch.ops.cuda._build import sm_count
    from diffusers_tpu_torch.ops.cuda.group_norm import (
        _group_norm_cuda,
        chunk_bounds,
        group_norm,
        group_norm_plain,
        plan_group_norm,
    )

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    sms = sm_count(0)
    cases, max_err, controlled = [], 0.0, set()
    sums = {where: {k: 0.0 for k in ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms")}
            for where in ("UNet", "VAE", "SD UNet", "VAE 512", "LTX upsampler")}
    decoder_shapes = {(shape, silu) for shape, silu, _ in GN_VAE_DECODE}
    encode_only = tuple(row for row in GN_VAE_ENCODE if row[:2] not in decoder_shapes)
    for where, table in (("UNet", GN_UNET_CALL), ("VAE", GN_VAE_DECODE), ("VAE encode", encode_only),
                         ("SD UNet", GN_SD15_UNET_CALL), ("VAE 512", GN_VAE_DECODE_512),
                         ("LTX upsampler", GN_LTX_UPSAMPLER), ("HunyuanVideo VAE", GN_HUNYUAN_VAE),
                         ("FramePack VAE", GN_FRAMEPACK_VAE)):
        for shape, silu, launches in table:
            c = shape[1]
            x = (torch.randn(shape, generator=gen, device=dev) * 1.5 + 0.5).to(torch.bfloat16)
            w = (1 + 0.1 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
            bias = (0.1 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
            before = group_norm.launches
            out = group_norm(x, w, bias, 32, 1e-6, apply_silu=silu)
            again = group_norm(x, w, bias, 32, 1e-6, apply_silu=silu)
            torch.cuda.synchronize()
            one_launch = group_norm.launches == before + 2
            identical = torch.equal(out, again)
            del again
            slices = group_slices(x, 32)
            err32 = err16 = tol = 0.0
            for part, groups in slices:
                ref32 = group_norm_plain(x[:, part].float(), w[part].float(), bias[part].float(), groups, 1e-6,
                                         apply_silu=silu)
                ref16 = group_norm_plain(x[:, part], w[part], bias[part], groups, 1e-6, apply_silu=silu)
                o = out[:, part].float()
                tol = max(tol, bf16_tol(ref32))
                err32 = max(err32, float((o - ref32).abs().max()))
                err16 = max(err16, float((o - ref16.float()).abs().max()))
                del ref32, ref16, o
            plan = plan_group_norm(tuple(shape), torch.bfloat16, sms)
            name = f"{where} {tuple(shape)}{' +SiLU' if silu else ''}"
            ok = err32 <= tol and err16 <= tol and identical and one_launch and bool(torch.isfinite(out).all())
            row = {"kernel": "group_norm", "case": name, "shape": list(shape), "silu": silu,
                   "launches_per_call": launches, "plan": plan._asdict(), "max_abs_err_vs_f32": err32,
                   "max_abs_err_vs_plain_same_dtype": err16, "tol": tol, "bit_identical_across_launches": identical}
            if plan.split not in controlled:
                # control: one partial left out, on inputs whose chunk of that partial is shifted by 20
                controlled.add(plan.split)
                drop = plan.parts // 2
                lo, hi = chunk_bounds(plan, x[0].numel() // 32)[drop]
                shifted = x.clone()
                shifted.view(-1, x[0].numel() // 32)[:, lo:hi] += 20.0
                broken = _group_norm_cuda(shifted, w, bias, 32, 1e-6, silu, _drop_partial=drop)
                ref_shifted = group_norm_plain(shifted.float(), w.float(), bias.float(), 32, 1e-6, apply_silu=silu)
                row["control_dropped_partial_share_of_tol"] = float((broken.float() - ref_shifted).abs().max()) / \
                    bf16_tol(ref_shifted)
                del shifted, broken, ref_shifted
                ok = ok and row["control_dropped_partial_share_of_tol"] > 1.0
            call = lambda: group_norm(x, w, bias, 32, 1e-6, apply_silu=silu)  # noqa: E731

            def plain():
                if len(slices) == 1:
                    return group_norm_plain(x, w, bias, 32, 1e-6, apply_silu=silu)
                buf = torch.empty_like(x)
                for part, groups in slices:
                    buf[:, part] = group_norm_plain(x[:, part], w[part], bias[part], groups, 1e-6, apply_silu=silu)
                return buf

            library = ((lambda: F.silu(F.group_norm(x, 32, w, bias, 1e-6))) if silu
                       else (lambda: F.group_norm(x, 32, w, bias, 1e-6)))
            ms, plain_ms = time_pair(call, plain, iters=10)
            nbytes = 2 * x.numel() * x.element_size()
            bms, by = bound_ms(nbytes, 0, PEAK_BF16_FLOPS)
            device_ms = graph_ms(call)
            row.update(ms=ms, plain_ms=plain_ms, device_ms=device_ms, host_us_per_call=host_us(call),
                       library_ms=time_ms(library, iters=10), library_device_ms=graph_ms(library), bound_ms=bms,
                       bound_by=by, device_gbps_2x_bytes=nbytes / device_ms / 1e6,
                       device_share_of_bound=bms / device_ms, plain=f"{len(slices)} channel slice(s) a call")
            cases.append(row)
            max_err = max(max_err, err32)
            log(f"[K4] {name}: {'split' if plan.split else 'cluster'} x{plan.parts}, chunk "
                f"{plan.chunk * 2 / 1024:.0f} KB, smem {plan.smem_bytes} B; err vs f32 {err32:.3e}, vs plain "
                f"{err16:.3e} (tol {tol:.3e}); bit-identical {identical}"
                + (f"; control (a partial dropped) {row['control_dropped_partial_share_of_tol']:.1f} x tol"
                   if "control_dropped_partial_share_of_tol" in row else "")
                + f"; device {device_ms:.4f} ms ({row['device_gbps_2x_bytes']:.0f} GB/s at 2 x bytes, "
                f"{100 * row['device_share_of_bound']:.1f}% of the {bms:.4f} ms bound), F.group_norm"
                f"{'+F.silu' if silu else ''} device {row['library_device_ms']:.4f} ms; events {ms:.4f} ms, plain "
                f"{plain_ms:.3f}, library {row['library_ms']:.4f}; host {row['host_us_per_call']:.1f} us a call")
            if not ok:
                raise AssertionError(f"group_norm disagrees with its plain version (or a control passed) on {name}: "
                                     f"{row}")
            for key in sums.get(where, ()):
                sums[where][key] += launches * row[key]
            del x, out
            torch.cuda.empty_cache()
    assert sum(n for _, _, n in GN_UNET_CALL) == 46 and controlled == {False, True} and len(encode_only) == 2
    assert sum(n for _, _, n in GN_SD15_UNET_CALL) == 61 and sum(n for _, _, n in GN_VAE_DECODE_512) == 30
    assert sum(n for _, _, n in GN_LTX_UPSAMPLER) == 17
    RESULTS["group_norm_cases"] = cases
    RESULTS["group_norm_per_unet_call"], RESULTS["group_norm_per_vae_decode"] = sums["UNet"], sums["VAE"]
    RESULTS["group_norm_per_sd15_unet_call"], RESULTS["group_norm_per_vae_decode_512"] = sums["SD UNet"], sums["VAE 512"]
    RESULTS["group_norm_per_ltx_upsampler_call"] = sums["LTX upsampler"]
    for where, what in (("UNet", "one SDXL UNet call at b=2 (46 launches)"), ("VAE", "one VAE decode (30 launches)"),
                        ("SD UNet", "one SD 1.5 UNet call at b=2, 512 px (61 launches)"),
                        ("VAE 512", "one VAE decode to 512 px, or one 512 px tile (30 launches)"),
                        ("LTX upsampler", "one LTX latent-upsampler call at 512 x 704 x 161 (17 launches)")):
        t = sums[where]
        log(f"[K4] {what}: device {t['device_ms']:.3f} ms (bound {t['bound_ms']:.3f} ms), F.group_norm(+F.silu) "
            f"device {t['library_device_ms']:.3f} ms; events {t['ms']:.3f} ms, plain {t['plain_ms']:.2f} ms, library "
            f"{t['library_ms']:.3f} ms")
    unet = sums["UNet"]
    return {"group_norm": (max_err, {"ms": unet["ms"], "plain_ms": unet["plain_ms"], "library_ms": unet["library_ms"],
                                     "bound_ms": unet["bound_ms"], "bound_by": "bytes"})}


def check_w8a8():
    """Phase 5: K5 and its row quantization against their plain versions at
    every Flux.1-dev w8a8 shape and every Kontext one (M up to 8,704), bf16,
    with a skipped-K-tile control; times of kernel, plain version and the
    nearest library calls, summed over one denoise step's launches of each."""
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
    shapes = list(dict.fromkeys((m, k, n) for m, k, n, _ in FLUX_W8A8_SHAPES + KONTEXT_W8A8_SHAPES))
    flux_per_step = {(m, k, n): c for m, k, n, c in FLUX_W8A8_SHAPES}
    for m, k, n in shapes:
        per_step = flux_per_step.get((m, k, n), 0)
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
    assert sum(s[3] for s in FLUX_W8A8_SHAPES) == sum(s[3] for s in KONTEXT_W8A8_SHAPES) == FLUX_W8A8_PER_STEP
    RESULTS["w8a8_cases"] = cases
    RESULTS["w8a8_per_denoise_step"] = step
    # one Kontext step (phase 13c): the same 500 launches at 8,192 image and 8,704 joint tokens
    by_shape = {(row["m"], row["k"], row["n"]): row for row in cases}
    kontext = {key: sum(c * by_shape[(m, k, n)][key] for m, k, n, c in KONTEXT_W8A8_SHAPES)
               for key in ("ms", "plain_ms", "int_mm_epilogue_ms", "bound_ms", "device_ms", "quantize_ms",
                           "quantize_bound_ms")}
    RESULTS["w8a8_per_kontext_step"] = kontext
    log(f"[K5] one Kontext denoise step ({FLUX_W8A8_PER_STEP} launches, M up to 8,704): kernel {kontext['ms']:.2f} ms "
        f"(device {kontext['device_ms']:.2f} ms), plain {kontext['plain_ms']:.1f} ms, _int_mm+epilogue "
        f"{kontext['int_mm_epilogue_ms']:.2f} ms, bound {kontext['bound_ms']:.2f} ms; quantize_rows "
        f"{kontext['quantize_ms']:.2f} ms (bound {kontext['quantize_bound_ms']:.2f} ms)")
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
    """Phase 6: K2 (dK/dV) and K3 (dQ) against their plain version,
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
        elif opt.get("mask") == "row":
            mask = torch.zeros((b, 1, sq, sk), device=dev)
            mask[:, :, 5, :] = torch.finfo(torch.float32).min
        elif opt.get("mask") == "pag":
            from diffusers_tpu_torch.models.transformers.transformer_sd3 import pag_identity_mask

            mask = pag_identity_mask(sq, SD3_IMAGE_TOKENS, dev)
        elif opt.get("mask") == "block_causal":  # SkyReelsV2Transformer3DModel.causal_mask of a (4, 8, 12) grid
            from diffusers_tpu_torch.models.transformers.transformer_skyreels_v2 import SkyReelsV2Transformer3DModel

            with torch.device("meta"):
                sky = SkyReelsV2Transformer3DModel(num_attention_heads=2, num_layers=0, num_frame_per_block=2)
            mask = torch.from_numpy(sky.causal_mask(4, 8, 12).copy()).to(dev)
        elif opt.get("mask"):
            mask = torch.where(torch.rand((b, 1, sq, sk), generator=gen, device=dev) < 0.3, -1e4, 0.0)
        causal = opt.get("is_causal", False)
        out, lse = flash_attention_full(q, k, v, attn_mask=mask, is_causal=causal, return_lse=True)
        grad_out = randn(b, sq, h, d, dtype=dtype)
        grads = flash_attention_bwd(q, k, v, mask, out, lse, grad_out, is_causal=causal)
        again = flash_attention_bwd(q, k, v, mask, out, lse, grad_out, is_causal=causal)
        torch.cuda.synchronize()
        identical = all(torch.equal(a.view(torch.int16), g.view(torch.int16)) for a, g in zip(again, grads))
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
            # where the plain version is not finite (a row with every logit hidden) the kernel must give
            # the same NaN / +inf / -inf; everywhere else it is held to the bound
            fin = torch.isfinite(ref)
            pattern = all(torch.equal(f(g), f(ref)) for f in (torch.isnan, torch.isposinf, torch.isneginf))
            diff32 = torch.where(fin, g.float() - ref, 0.0).abs()
            diff16 = torch.where(fin, g.float() - p16.float(), 0.0).abs()
            share32 = float(torch.where(diff32 == 0, 0.0, diff32 / b32).max())
            share16 = float(torch.where(diff16 == 0, 0.0, diff16 / b16).max())
            row[name] = {"max_abs_err_vs_f32": float(diff32.max()), "max_abs_err_vs_plain_same_dtype":
                         float(diff16.max()), "max_share_of_bound_vs_f32": share32,
                         "max_share_of_bound_vs_plain_same_dtype": share16, "non_finite_as_plain": pattern,
                         "non_finite": int((~fin).sum())}
            ok = ok and share32 <= 1.0 and share16 <= 1.0 and pattern
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
    >= `min_weight_size` elements quantized to w8a8; none when it is None),
    so no full float copy of either exists."""
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
    materialize_(transformer, device, dtype,
                 None if min_weight_size is None else lambda unit: quantize_w8a8(unit, min_weight_size))
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
    """Phase 7: the port on the card (bf16, kernels) against the port on the
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
    """Phase 8: the same for a small Flux-shaped pipeline: w8a8 transformer
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
    """Phase 9: one train step's loss and gradients on the card (bf16
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


def small_cache_cases():
    """Phase 10's cases: (pipeline, label, cache config or None, callback
    factory or None), every config each pipeline honours and the callbacks,
    at SMALL_CACHE_STEPS steps (schedules with skips at that count)."""
    from diffusers_tpu_torch.callbacks import MultiPipelineCallbacks, SDXLCFGCutoffCallback
    from diffusers_tpu_torch.hooks import (
        FLUX_MAG_RATIOS,
        FasterCacheConfig,
        FirstBlockCacheConfig,
        MagCacheConfig,
        PyramidAttentionBroadcastConfig,
        TaylorSeerCacheConfig,
        TextKVCacheConfig,
    )

    n = SMALL_CACHE_STEPS
    taylorseer = TaylorSeerCacheConfig(cache_interval=3, disable_cache_before_step=2, max_order=2)
    noop = lambda: lambda p, i, t, kw: {}  # noqa: E731
    halve_latents = lambda: lambda p, i, t, kw: {"latents": kw["latents"] * 0.5} if i == 3 else {}  # noqa: E731
    return (
        ("sdxl", "taylorseer", taylorseer, None),
        ("sdxl", "faster_cache", FasterCacheConfig(unconditional_batch_skip_range=3,
                                                   unconditional_batch_timestep_skip_range=(-1, 1000)), None),
        ("sdxl", "mag_cache", MagCacheConfig(threshold=0.5, max_skip_steps=1, retention_ratio=0.25,
                                             num_inference_steps=n, mag_ratios=(1.0,) * n), None),
        ("sdxl", "text_kv", TextKVCacheConfig(), None),
        ("sdxl", "callback_noop", None, noop),
        ("sdxl", "callback_latents", None, halve_latents),
        ("sdxl", "callback_cfg_cutoff", None, lambda: SDXLCFGCutoffCallback(cutoff_step_ratio=0.4)),
        ("sdxl", "callback_multi", None,
         lambda: MultiPipelineCallbacks([SDXLCFGCutoffCallback(cutoff_step_index=2), halve_latents()])),
        ("flux", "taylorseer", taylorseer, None),
        ("flux", "first_block_cache", FirstBlockCacheConfig(threshold=SMALL_FBC_THRESHOLD), None),
        ("flux", "pab", PyramidAttentionBroadcastConfig(spatial_attention_timestep_skip_range=(100, 950)), None),
        ("flux", "mag_cache", MagCacheConfig(threshold=0.5, max_skip_steps=1, retention_ratio=0.25,
                                             mag_ratios=tuple(FLUX_MAG_RATIOS)), None),
        ("flux", "text_kv", TextKVCacheConfig(), None),
        ("flux", "callback_noop", None, noop),
    )


def check_small_caches(device: str = "cuda"):
    """Phase 10: every cache config on each pipeline that honours it, and the
    callbacks, on the small pipelines of phases 7 and 8 at SMALL_CACHE_STEPS
    steps: the card (bf16, kernels) against the CPU (f32, plain versions;
    held to JAX by tests/test_torch_pipeline_cache.py and
    tests/test_torch_callbacks.py), with those phases' tolerance. For
    FirstBlockCache, a decision is a ratio against a threshold, which bf16
    on the card may put on the other side than f32 on the CPU: the two
    decision sequences and each step's relative change are reported beside
    the threshold, the steps where they differ recorded, and the image held
    to the same tolerance."""
    import numpy as np
    import torch

    sdxl = [_build_pipeline(SMALL_UNET, SMALL_VAE, SMALL_CLIP, SMALL_CLIP, "cpu", torch.float32) for _ in range(2)]
    flux = [_build_flux_pipeline(SMALL_FLUX, SMALL_FLUX_MIN_WEIGHT_SIZE, SMALL_FLUX_VAE, SMALL_FLUX_CLIP, SMALL_T5,
                                 "cpu", torch.float32) for _ in range(2)]
    for pipe in (sdxl[1], flux[1]):
        pipe.to(device=torch.device(device), dtype=torch.bfloat16)
    rng = np.random.RandomState(SEED)
    inputs = {
        "sdxl": (sdxl, PROMPTS[0], dict(latents=torch.from_numpy(rng.randn(1, 4, 16, 16).astype(np.float32)),
                                        guidance_scale=GUIDANCE)),
        "flux": (flux, FLUX_PROMPT, dict(latents=torch.from_numpy(rng.randn(1, 256, 64).astype(np.float32)),
                                         height=64, width=64, guidance_scale=FLUX_GUIDANCE, max_sequence_length=64)),
    }
    tol = 0.05  # phases 7 and 8: bf16 on the card against f32 on the CPU, on the [0, 1] image
    results = {}
    for name, label, config, callback in small_cache_cases():
        (cpu, card), prompt, kwargs = inputs[name]
        images, records = [], []
        for pipe in (cpu, card):
            if config is not None:
                pipe.enable_cache(config)
            reset_launches()
            try:
                images.append(pipe(prompt, num_inference_steps=SMALL_CACHE_STEPS, output_type="np",
                                   callback_on_step_end=callback() if callback else None, **kwargs).images)
            finally:
                pipe.disable_cache()
            records.append(pipe.fbc_record if label == "first_block_cache" else None)
        launches = read_launches()
        ref, out = images
        err = float(np.abs(out - ref).max())
        row = {"max_abs_err": err, "tol": tol, "launches": launches}
        if records[0] is not None:
            row["decisions"] = {"cpu": records[0]["decisions"], "card": records[1]["decisions"]}
            row["ratios"] = {side: [None if r is None else float(r) for r in rec["ratios"]]
                             for side, rec in zip(("cpu", "card"), records)}
            row["flipped_steps"] = [i for i, (a, b) in enumerate(zip(*row["decisions"].values())) if a != b]
            log(f"[ref-cache]   first-block relative change per step (threshold {config.threshold}): CPU "
                f"{row['ratios']['cpu']}, card {row['ratios']['card']}; decisions CPU {row['decisions']['cpu']}, "
                f"card {row['decisions']['card']}, differing at steps {row['flipped_steps']}")
        results[f"{name} {label}"] = row
        log(f"[ref-cache] small {name} {label}, card bf16 vs CPU f32: max |diff| {err:.3e} (tol {tol}); "
            f"launches {launches}")
        if not (out.shape == ref.shape and np.isfinite(out).all() and err <= tol):
            raise AssertionError(f"small {name} {label}: the card disagrees with the CPU")
        kernels = ("flash_attention_fwd", "group_norm") + (("w8a8_matmul",) if name == "flux" else ())
        if min(launches[k] for k in kernels) <= 0:
            raise AssertionError(f"small {name} {label} on the card missed a kernel: {launches}")
    RESULTS["small_caches"] = results


def synthetic_inputs(size: int):
    """(image, mask, edge map) at size x size as float32 numpy in [0, 1], for
    want of PIL and OpenCV on the card's machine: an HWC image (a seeded
    gradient plus noise), an HW mask (a centred square covering 25%) and an
    HWC binary edge map (a few lines)."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1)
    image = 0.8 * np.stack([x, y, (x + y) / 2], axis=-1) + 0.2 * rng.rand(size, size, 3).astype(np.float32)
    mask = np.zeros((size, size), np.float32)
    mask[size // 4:size - size // 4, size // 4:size - size // 4] = 1.0
    edges = np.zeros((size, size, 3), np.float32)
    for k in range(1, 6):
        edges[k * size // 6, :] = edges[:, k * size // 6] = 1.0
    edges[np.arange(size), np.arange(size)] = 1.0
    return image, mask, edges


def _image_pipelines(base, unet9, controlnet, device):
    """The img2img, inpaint (9- and 4-channel) and ControlNet pipelines on the
    components of `base`, by label."""
    from diffusers_tpu_torch.pipelines.controlnet import StableDiffusionXLControlNetPipeline
    from diffusers_tpu_torch.pipelines.stable_diffusion_xl import (
        StableDiffusionXLImg2ImgPipeline,
        StableDiffusionXLInpaintPipeline,
    )

    parts = dict(base.components, device=device)
    return {"img2img": StableDiffusionXLImg2ImgPipeline(**parts),
            "inpaint_9ch": StableDiffusionXLInpaintPipeline(**dict(parts, unet=unet9)),
            "inpaint_4ch": StableDiffusionXLInpaintPipeline(**parts),
            "controlnet": StableDiffusionXLControlNetPipeline(**parts, controlnet=controlnet)}


def check_small_image_pipelines(device: str = "cuda"):
    """Phase 10b: the image-conditioned pipelines on the card (bf16, kernels)
    against the CPU (f32, plain versions; held to JAX by
    tests/test_torch_pipeline_img2img.py and tests/test_torch_controlnet.py)
    on phase 7's small components, with SMALL_UNET at 9 input channels and
    SMALL_CONTROLNET: img2img, inpaint with each UNet, ControlNet plain and
    in guess mode, and text-to-image on the Karras ladder, each 4 steps,
    with phase 7's tolerance. Both sides draw from one CPU generator seeded
    alike, so they get the same noise and the same encoder samples."""
    import numpy as np
    import torch

    from diffusers_tpu_torch.models.controlnets import ControlNetModel
    from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
    from diffusers_tpu_torch.schedulers import EulerDiscreteScheduler

    sides = []
    for dev in ("cpu", device):
        base = _build_pipeline(SMALL_UNET, SMALL_VAE, SMALL_CLIP, SMALL_CLIP, "cpu", torch.float32)
        torch.manual_seed(SEED + 1)
        unet9 = UNet2DConditionModel(**dict(SMALL_UNET, in_channels=9))
        controlnet = ControlNetModel(**SMALL_CONTROLNET)
        pipes = _image_pipelines(base, unet9, controlnet, "cpu")
        pipes["karras"] = type(base)(**dict(base.components, device="cpu",
                                            scheduler=EulerDiscreteScheduler(**EULER, use_karras_sigmas=True)))
        for pipe in pipes.values():
            pipe.to(device=torch.device(dev), dtype=torch.float32 if not sides else torch.bfloat16)
        sides.append(pipes)
    image, mask, edges = synthetic_inputs(32)
    latents = torch.from_numpy(np.random.RandomState(SEED).randn(1, 4, 16, 16).astype(np.float32))
    cases = (
        ("img2img", "img2img", dict(image=image, strength=0.6)),
        ("inpaint_9ch", "inpaint_9ch", dict(image=image, mask_image=mask)),
        ("inpaint_4ch", "inpaint_4ch", dict(image=image, mask_image=mask, strength=0.8)),
        ("controlnet", "controlnet", dict(image=edges, latents=latents, controlnet_conditioning_scale=0.5)),
        ("controlnet_guess_mode", "controlnet", dict(image=edges, latents=latents, controlnet_conditioning_scale=0.5,
                                                     guess_mode=True)),
        ("karras_text_to_image", "karras", dict(latents=latents)),
    )
    tol = 0.05  # phase 7: bf16 on the card against f32 on the CPU, on the [0, 1] image
    results = {}
    for label, pipe_name, kwargs in cases:
        images = []
        for pipes in sides:  # the CPU, then the card
            reset_launches()
            images.append(pipes[pipe_name](PROMPTS[0], num_inference_steps=4, guidance_scale=GUIDANCE,
                                                generator=torch.Generator().manual_seed(SEED), output_type="np",
                                                **kwargs).images)
            launches = read_launches()
        ref, out = images
        err = float(np.abs(out - ref).max())
        results[label] = {"max_abs_err": err, "mean_abs_err": float(np.abs(out - ref).mean()), "tol": tol,
                          "launches": launches}
        log(f"[ref-image] small {label}, card bf16 vs CPU f32: max |diff| {err:.3e} (tol {tol}); launches {launches}")
        if not (out.shape == ref.shape == (1, 32, 32, 3) and np.isfinite(out).all() and err <= tol):
            raise AssertionError(f"small {label}: the card disagrees with the CPU")
        if min(launches["flash_attention_fwd"], launches["group_norm"]) <= 0:
            raise AssertionError(f"small {label} on the card missed a kernel: {launches}")
    RESULTS["small_image_pipelines"] = results


def run_training(smi: str):
    """Phase 15: the full-width training path: `train_text_to_image.main`
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
    """Phase 11: one full-width SDXL 1024 px request through the kernels.
    Returns (launches, the pipeline, the uint8 image)."""
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
    expected_k4 = sum(n for _, _, n in GN_UNET_CALL) * STEPS + sum(n for _, _, n in GN_VAE_DECODE)
    if launches["group_norm"] != expected_k4:
        raise AssertionError(f"group_norm launched {launches['group_norm']} times on the SDXL path, expected "
                             f"{expected_k4}")

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
    return launches, pipe, image


def run_flux_pipeline(smi: str):
    """Phase 13: one full-width Flux.1-dev 1024 px request (28 steps, guidance
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
                "flash_attention_fwd": FLUX_ATTENTIONS_PER_STEP * FLUX_STEPS,
                "group_norm": sum(n for _, _, n in GN_VAE_DECODE)}  # one VAE decode
    log(f"[flux] launches: {launches} (expected {expected})")
    for name, count in expected.items():
        if launches[name] != count:
            raise AssertionError(f"{name} launched {launches[name]} times on the Flux path, expected {count}")
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
    return launches, pipe, image


class StepLaunches:
    """Launch counts of each denoise step of one request: within the block,
    the pipeline's `scheduler.step` reads the counters after every step, and
    a step's counts are the difference to the previous read (the first
    step's, to the counts at entry). A step that a cache skips shows zeros
    for what it skipped. `after` holds what came after the last step (the VAE
    decode); `batches`, the denoiser's batch size at each of its calls;
    `timesteps`, the schedule's timestep at each step."""

    def __init__(self, pipe, denoiser):
        self.pipe, self.denoiser = pipe, denoiser

    def __enter__(self):
        scheduler, step = self.pipe.scheduler, self.pipe.scheduler.step
        self.per_step, self.batches, self.timesteps, self._last = [], [], [], read_launches()

        def counted_step(state, model_output, timestep, sample, **kwargs):
            out = step(state, model_output, timestep, sample, **kwargs)
            self.timesteps.append(float(timestep))
            now = read_launches()
            self.per_step.append({k: now[k] - self._last[k] for k in now})
            self._last = now
            return out

        scheduler.step = counted_step
        self._hook = self.denoiser.register_forward_pre_hook(lambda mod, args: self.batches.append(args[0].shape[0]))
        return self

    def __exit__(self, *exc):
        del self.pipe.scheduler.step
        self._hook.remove()
        now = read_launches()
        self.after = {k: now[k] - self._last[k] for k in now}
        return False


def _launches(**counts):
    """A launch-count dict over every kernel, zero where not given."""
    return {name: counts.get(name, 0) for name in launch_counters()}


def _module_launches(module):
    """The forward launches of one call of `module` that calls each of its
    GroupNorms and attentions once: K4 per GroupNorm, K1 per attention at a
    head dim the kernel takes (the others run `native`; a Wan cross
    attention with an image branch launches twice: the text, then the image
    tokens; a UNet cross attention with IP-Adapters once more for each
    adapter whose scale is not 0), and K5 with its row quantization per w8a8 Linear whose K and N
    are multiples of 128 (the others take the dequantized matmul, as in
    JAX), and K5 alone per per-tensor int8 Linear and per group of an int8
    conv (any shape: their operands are padded)."""
    from diffusers_tpu_torch.models.attention import Attention
    from diffusers_tpu_torch.models.transformers.transformer_flux import FluxAttention
    from diffusers_tpu_torch.models.transformers.transformer_hunyuan_video import HunyuanVideoAttention
    from diffusers_tpu_torch.models.transformers.transformer_ltx import LTXAttention
    from diffusers_tpu_torch.models.transformers.transformer_qwenimage import QwenDoubleStreamAttention
    from diffusers_tpu_torch.models.transformers.transformer_sd3 import JointAttention
    from diffusers_tpu_torch.models.transformers.transformer_wan import WanAttention
    from diffusers_tpu_torch.models.transformers.transformer_wan_animate import WanAnimateFaceBlockCrossAttention
    from diffusers_tpu_torch.ops.cuda.flash_attention import HEAD_DIMS
    from diffusers_tpu_torch.ops.module import GroupNorm, Int8Conv2d, Int8PerTensorLinear, W8A8Linear

    mods = list(module.modules())
    w8a8 = sum(type(m) is W8A8Linear and m.in_features % 128 == 0 and m.out_features % 128 == 0 for m in mods)
    per_tensor = sum(isinstance(m, Int8PerTensorLinear) for m in mods) + sum(
        m.groups for m in mods if isinstance(m, Int8Conv2d))
    attentions = (Attention, FluxAttention, JointAttention, WanAttention, WanAnimateFaceBlockCrossAttention,
                  QwenDoubleStreamAttention, LTXAttention, HunyuanVideoAttention)

    def calls(m):  # a Wan image branch or a loaded IP-Adapter (one a nonzero scale) adds calls
        if isinstance(m, WanAttention):
            return 1 + (m.added_kv_proj_dim is not None)
        if isinstance(m, Attention) and m.to_k_ip is not None:
            return 1 + sum(scale != 0 for scale in m.ip_adapter_scale)
        return 1

    return _launches(group_norm=sum(isinstance(m, GroupNorm) for m in mods), w8a8_matmul=w8a8 + per_tensor,
                     w8a8_quantize_rows=w8a8,
                     flash_attention_fwd=sum(calls(m) * (isinstance(m, attentions) and m.dim_head in HEAD_DIMS)
                                             for m in mods))


def _request_seconds(call):
    """(result, seconds, peak GB) of one call (a request, a save, a load), on
    the host clock ending in a synchronise."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9


def _image_cosine(a, b) -> float:
    """Cosine of two uint8 images as float64 vectors (bench.py's cached-vs-dense metric)."""
    import numpy as np

    a, b = np.asarray(a).astype(np.float64).ravel(), np.asarray(b).astype(np.float64).ravel()
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def _check_steps(label, per_step, expected_steps, after, expected_after):
    for i, (got, want) in enumerate(zip(per_step, expected_steps)):
        if got != want:
            raise AssertionError(f"{label}: step {i} launched {got}, expected {want}")
    if len(per_step) != len(expected_steps):
        raise AssertionError(f"{label}: {len(per_step)} steps, expected {len(expected_steps)}")
    if after != expected_after:
        raise AssertionError(f"{label}: the decode launched {after}, expected {expected_after}")


def sdxl_cached_requests():
    """The SDXL cached requests at full width: (label, cache config or None,
    callback factory or None). The headline first (bench.py:162)."""
    from diffusers_tpu_torch.callbacks import SDXLCFGCutoffCallback
    from diffusers_tpu_torch.hooks import FasterCacheConfig, MagCacheConfig, TaylorSeerCacheConfig

    return (
        ("taylorseer", TaylorSeerCacheConfig(cache_interval=10, disable_cache_before_step=2, max_order=2), None),
        ("faster_cache", FasterCacheConfig(), None),
        # SDXL has no published ratio table: flat ratios (tests/test_cache_hooks.py does the same)
        ("mag_cache", MagCacheConfig(num_inference_steps=STEPS, mag_ratios=(1.0,) * STEPS), None),
        ("cfg_cutoff_callback", None, lambda: SDXLCFGCutoffCallback(cutoff_step_ratio=0.4)),
    )


def sdxl_unet_calls(label, config, pipe):
    """The UNet's batch at each step of an SDXL request (0 where the step
    makes no UNet call), from the cache's host-made schedule."""
    from diffusers_tpu_torch.hooks import faster_cache_schedules, mag_cache_compute_mask, taylorseer_compute_mask

    if label == "taylorseer":
        return [2 * int(c) for c in taylorseer_compute_mask(STEPS, config)]
    if label == "faster_cache":
        skip, _, _ = faster_cache_schedules(pipe.scheduler.set_timesteps(STEPS).timesteps.numpy(), config)
        return [1 if s else 2 for s in skip]
    if label == "mag_cache":
        return [2 * int(c) for c in mag_cache_compute_mask(config)]
    cutoff = int(STEPS * 0.4)  # the callback halves the batch after step `cutoff`
    return [2 if i <= cutoff else 1 for i in range(STEPS)]


def run_sdxl_cached(smi: str, pipe, dense_image):
    """Phase 12: the full-width SDXL requests through the caches and a
    callback, on phase 11's pipeline, with its seed and prompt: first the
    headline TaylorSeer request (bench.py:162; 5 of 30 steps computed:
    SDXL_HEADLINE_LAUNCHES), then FasterCache, MagCache (flat
    ratios) and `SDXLCFGCutoffCallback(cutoff_step_ratio=0.4)`. Each step's
    launches are held to the schedule: a step that calls the UNet (at batch
    1 or 2) 140 K1 and 46 K4 launches, a skipped one none."""
    import numpy as np
    import torch

    per_call, decode = _module_launches(pipe.unet), _module_launches(pipe.vae.decoder)
    out, paths = {}, {}
    for label, config, callback in sdxl_cached_requests():
        calls = sdxl_unet_calls(label, config, pipe)
        expected = [per_call if b else _launches() for b in calls]
        if config is not None:
            pipe.enable_cache(config)
        reset_launches()
        try:
            with StepLaunches(pipe, pipe.unet) as steps:
                images, seconds, peak_gb = _request_seconds(lambda: pipe(
                    PROMPTS[0], height=RESOLUTION, width=RESOLUTION, num_inference_steps=STEPS,
                    guidance_scale=GUIDANCE, generator=torch.Generator(device="cuda").manual_seed(SEED),
                    output_type="pil", callback_on_step_end=callback() if callback else None).images)
        finally:
            pipe.disable_cache()
        launches = read_launches()
        image = np.asarray(images[0])
        if image.shape != (RESOLUTION, RESOLUTION, 3) or image.dtype != np.uint8:
            raise AssertionError(f"sdxl {label}: bad uint8 image {image.shape} {image.dtype}")
        _check_steps(f"sdxl {label}", steps.per_step, expected, steps.after, decode)
        if steps.batches != [b for b in calls if b]:
            raise AssertionError(f"sdxl {label}: UNet batches {steps.batches}, expected {[b for b in calls if b]}")
        cosine = _image_cosine(image, dense_image)
        computed = sum(b == 2 for b in calls)
        log(f"[sdxl-cache] {smi}: {label}: {seconds:.3f} s/image, peak memory {peak_gb:.1f} GB, UNet calls "
            f"{sum(b > 0 for b in calls)} of {STEPS} steps ({computed} at batch 2, {sum(b == 1 for b in calls)} at "
            f"batch 1), launches {launches}, cosine to the dense image {cosine:.4f} (random weights)")
        out[label] = {"card": smi, "seconds_per_request": seconds, "peak_memory_gb": peak_gb,
                      "unet_batch_per_step": calls, "launches": launches, "launches_per_step": steps.per_step,
                      "cosine_to_dense": cosine}
        paths[f"sdxl_{label}"] = launches
    headline = out["taylorseer"]["launches"]
    if headline != SDXL_HEADLINE_LAUNCHES:
        raise AssertionError(f"the headline TaylorSeer request launched {headline}, expected {SDXL_HEADLINE_LAUNCHES}")
    RESULTS["sdxl_cached"] = out
    return paths


def _load_controlnet_from_pretrained(smi: str):
    """The full-width ControlNet (SDXL_CONTROLNET, random weights from SEED,
    bf16) written with the port's `save_pretrained` in 1 GB shards to a
    temporary directory, loaded back onto the card with `from_pretrained`,
    held bit-equal to what was saved; the directory is deleted. Returns the
    loaded model."""
    import shutil
    import tempfile

    import torch

    from diffusers_tpu_torch.models.controlnets import ControlNetModel

    torch.manual_seed(SEED + 2)
    with torch.device("cuda"):
        saved = ControlNetModel(**SDXL_CONTROLNET).to(torch.bfloat16)
    n_params = sum(p.numel() for p in saved.parameters())
    nbytes = sum(t.numel() * t.element_size() for t in saved.state_dict().values())
    directory = tempfile.mkdtemp(prefix="chip_smoke_controlnet_")
    try:
        t0 = time.perf_counter()
        saved.save_pretrained(directory, max_shard_size="1GB")
        save_s = time.perf_counter() - t0
        shards = sorted(f for f in Path(directory).iterdir() if f.suffix == ".safetensors")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = ControlNetModel.from_pretrained(directory, device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(directory)
    expected, got = saved.state_dict(), loaded.state_dict()
    equal = list(expected) == list(got) and all(
        got[k].dtype == v.dtype and got[k].device.type == "cuda" and torch.equal(got[k], v) for k, v in expected.items())
    del saved, expected
    torch.cuda.empty_cache()
    RESULTS["controlnet_from_pretrained"] = {
        "card": smi, "parameters": n_params, "bytes": nbytes, "shards": len(shards), "save_seconds": save_s,
        "load_seconds": load_s, "load_gb_per_s": nbytes / load_s / 1e9, "bit_equal": equal}
    log(f"[controlnet] {smi}: ControlNet at full width, {n_params / 1e9:.3f} B parameters, {nbytes / 1e9:.2f} GB "
        f"bf16 in {len(shards)} shards: save {save_s:.1f} s, from_pretrained onto the card {load_s:.2f} s "
        f"({nbytes / load_s / 1e9:.2f} GB/s), bit-equal {equal}")
    if not equal:
        raise AssertionError("from_pretrained did not give back the saved ControlNet bit for bit")
    return loaded


def run_image_pipelines(smi: str, pipe):
    """Phase 12b: the full-width image-conditioned requests on phase 11's
    pipeline (its CLIP towers, VAE and UNet, seed and prompt), 1024 px, 30
    steps, CFG 5.0, inputs from `synthetic_inputs`: img2img at strength 0.3
    (9 UNet calls), inpaint with a full-width 9-channel inpainting UNet at
    0.99 (29 calls; the UNet is built, used and freed here), and ControlNet
    at scale 0.5 with the full-width ControlNet loaded by `from_pretrained`
    (30 ControlNet + UNet calls). Each step's launches are held to the
    counts of the models' modules (`StepLaunches`): a UNet call, plus the
    ControlNet's, plus at the first step each VAE encode the request makes;
    the decode after the last step. Returns the launches by path and the
    ControlNet (phase 25a takes it on)."""
    import gc

    import numpy as np
    import torch

    from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
    from diffusers_tpu_torch.schedulers import EulerDiscreteScheduler

    image, mask, edges = synthetic_inputs(RESOLUTION)
    unet_call, encode, decode = (_module_launches(m) for m in (pipe.unet, pipe.vae.encoder, pipe.vae.decoder))
    base = dict(pipe.components, scheduler=EulerDiscreteScheduler(**EULER))
    out, paths = {}, {}

    def request(label, pipeline, steps, per_step, first_extra, n_params, **kwargs):
        latents_seen = []
        hook = pipeline.vae.post_quant_conv.register_forward_pre_hook(lambda m, a: latents_seen.append(a[0]))
        reset_launches()
        try:
            with StepLaunches(pipeline, pipeline.unet) as counted:
                images, seconds, peak_gb = _request_seconds(lambda: pipeline(
                    PROMPTS[0], num_inference_steps=STEPS, guidance_scale=GUIDANCE,
                    generator=torch.Generator(device="cuda").manual_seed(SEED), output_type="pil", **kwargs).images)
        finally:
            hook.remove()
        launches = read_launches()
        result = np.asarray(images[0])
        if result.shape != (RESOLUTION, RESOLUTION, 3) or result.dtype != np.uint8:
            raise AssertionError(f"{label}: bad uint8 image {result.shape} {result.dtype}")
        if not bool(torch.isfinite(latents_seen[-1]).all()):
            raise AssertionError(f"{label}: non-finite latents")
        expected = [dict(per_step) for _ in range(steps)]
        for k, v in first_extra.items():
            expected[0][k] += v
        _check_steps(label, counted.per_step, expected, counted.after, decode)
        log(f"[image] {smi}: {label}: {seconds:.3f} s/image, peak memory {peak_gb:.1f} GB, {steps} steps, "
            f"{n_params / 1e9:.3f} B parameters; launches {launches} (K1 {per_step['flash_attention_fwd']} and "
            f"K4 {per_step['group_norm']} a step, as the modules count)")
        out[label] = {"card": smi, "seconds_per_request": seconds, "peak_memory_gb": peak_gb, "steps": steps,
                      "parameters": n_params, "launches": launches, "launches_per_step": counted.per_step}
        paths[label] = launches

    def n_params(*models):
        return sum(p.numel() for m in models for p in m.parameters())

    sdxl_params = n_params(pipe.unet, pipe.vae, pipe.text_encoder, pipe.text_encoder_2)
    from diffusers_tpu_torch.pipelines.controlnet import StableDiffusionXLControlNetPipeline
    from diffusers_tpu_torch.pipelines.stable_diffusion_xl import (
        StableDiffusionXLImg2ImgPipeline,
        StableDiffusionXLInpaintPipeline,
    )

    steps = int(STEPS * IMG2IMG_STRENGTH)
    request("sdxl_img2img", StableDiffusionXLImg2ImgPipeline(**base), steps, unet_call, encode, sdxl_params,
            image=image, strength=IMG2IMG_STRENGTH)

    torch.manual_seed(SEED + 1)
    with torch.device("cuda"):
        unet9 = UNet2DConditionModel(**dict(SDXL_UNET, in_channels=9)).to(torch.bfloat16)
    inpaint = StableDiffusionXLInpaintPipeline(**dict(base, unet=unet9))
    two_encodes = {k: 2 * v for k, v in encode.items()}
    request("sdxl_inpaint_9ch", inpaint, int(STEPS * INPAINT_STRENGTH), _module_launches(unet9), two_encodes,
            n_params(unet9, pipe.vae, pipe.text_encoder, pipe.text_encoder_2), image=image, mask_image=mask,
            strength=INPAINT_STRENGTH)
    del inpaint, unet9
    gc.collect()
    torch.cuda.empty_cache()

    controlnet = _load_controlnet_from_pretrained(smi)
    cn_call = _module_launches(controlnet)
    if (cn_call["flash_attention_fwd"], cn_call["group_norm"]) != (68, 21):
        raise AssertionError(f"the full-width ControlNet's modules count {cn_call}, expected K1 68 and K4 21")
    per_step = {k: unet_call[k] + cn_call[k] for k in unet_call}
    request("sdxl_controlnet", StableDiffusionXLControlNetPipeline(**base, controlnet=controlnet), STEPS, per_step,
            {}, sdxl_params + n_params(controlnet), image=edges, controlnet_conditioning_scale=CONTROLNET_SCALE)
    # the ControlNet's forward at b=2 (one CFG step) beside the UNet's, as phase 11 times the UNet's
    dev = torch.device("cuda")
    sample = torch.randn(2, 4, 128, 128, device=dev, dtype=torch.bfloat16)
    ehs = torch.randn(2, 77, 2048, device=dev, dtype=torch.bfloat16)
    cond = {"text_embeds": torch.randn(2, 1280, device=dev, dtype=torch.bfloat16),
            "time_ids": torch.tensor([[1024, 1024, 0, 0, 1024, 1024]] * 2, device=dev, dtype=torch.float32)}
    edge_batch = torch.rand(2, 3, RESOLUTION, RESOLUTION, device=dev, dtype=torch.bfloat16)
    t = torch.tensor(500.0, device=dev)
    with torch.no_grad():
        cn_ms = time_ms(lambda: controlnet(sample, t, ehs, edge_batch, added_cond_kwargs=cond), iters=10)
        unet_ms = time_ms(lambda: pipe.unet(sample, t, ehs, added_cond_kwargs=cond), iters=10)
    out["sdxl_controlnet"].update(controlnet_forward_b2_ms=cn_ms, unet_forward_b2_ms=unet_ms)
    log(f"[image] {smi}: ControlNet forward b=2 {cn_ms:.2f} ms, UNet forward b=2 {unet_ms:.2f} ms (CUDA events, "
        f"10 calls each): {cn_ms / unet_ms:.2f} of a UNet call")
    RESULTS["image_pipelines"] = out
    return paths, controlnet


def run_flux_cached(smi: str, pipe, dense_image):
    """Phase 14: the full-width Flux.1-dev requests through each cache, on
    phase 13's pipeline: TaylorSeer (the headline's schedule), FirstBlockCache
    (threshold 0.05), PAB (default ranges) and MagCache (FLUX_MAG_RATIOS).
    Each step's launches are held to the schedule or, for FirstBlockCache, to
    the decision the run recorded: a computed step 500 w8a8 launches (each
    with its row quantization) and 57 K1; a TaylorSeer step predicted, none;
    a MagCache step skipped, the Linears outside the blocks; a FirstBlockCache
    step skipped, those and the first block's (K1 once); a PAB broadcast step,
    every Linear but the attentions' and no K1."""
    import dataclasses

    import numpy as np
    import torch

    from diffusers_tpu_torch.hooks import (
        FLUX_MAG_RATIOS,
        FirstBlockCacheConfig,
        MagCacheConfig,
        PyramidAttentionBroadcastConfig,
        TaylorSeerCacheConfig,
        mag_cache_compute_mask,
        pab_compute_mask,
        taylorseer_compute_mask,
    )
    from diffusers_tpu_torch.ops.module import W8A8Linear

    tr = pipe.transformer

    def n_w8a8(*modules):
        return sum(isinstance(m, W8A8Linear) for mod in modules for m in mod.modules())

    total = n_w8a8(tr)
    in_blocks = n_w8a8(*tr.transformer_blocks, *tr.single_transformer_blocks)
    in_attention = n_w8a8(*(b.attn for b in (*tr.transformer_blocks, *tr.single_transformer_blocks)))

    def step(w8a8, attention):
        return _launches(w8a8_matmul=w8a8, w8a8_quantize_rows=w8a8, flash_attention_fwd=attention)

    full = _module_launches(tr)
    skipped = {
        "taylorseer": step(0, 0),
        "first_block_cache": step(total - in_blocks + n_w8a8(tr.transformer_blocks[0]), 1),
        "pab": step(total - in_attention, 0),
        "mag_cache": step(total - in_blocks, 0),
    }
    mag = MagCacheConfig(mag_ratios=tuple(FLUX_MAG_RATIOS))
    requests = (
        ("taylorseer", TaylorSeerCacheConfig(cache_interval=10, disable_cache_before_step=2, max_order=2),
         lambda cfg, ts: taylorseer_compute_mask(FLUX_STEPS, cfg)),
        ("first_block_cache", FirstBlockCacheConfig(), None),
        ("pab", PyramidAttentionBroadcastConfig(),
         lambda cfg, ts: pab_compute_mask(np.asarray(ts), cfg.spatial_attention_block_skip_range,
                                          cfg.spatial_attention_timestep_skip_range)),
        ("mag_cache", MagCacheConfig(mag_ratios=tuple(FLUX_MAG_RATIOS)),
         lambda cfg, ts: mag_cache_compute_mask(dataclasses.replace(cfg, num_inference_steps=FLUX_STEPS))),
    )
    decode = _module_launches(pipe.vae.decoder)
    out, paths = {}, {}
    for label, config, schedule in requests:
        pipe.enable_cache(config)
        reset_launches()
        try:
            with StepLaunches(pipe, tr) as steps:
                images, seconds, peak_gb = _request_seconds(lambda: pipe(
                    FLUX_PROMPT, height=RESOLUTION, width=RESOLUTION, num_inference_steps=FLUX_STEPS,
                    guidance_scale=FLUX_GUIDANCE, generator=torch.Generator(device="cuda").manual_seed(SEED),
                    max_sequence_length=FLUX_MAX_SEQUENCE_LENGTH, output_type="pil").images)
        finally:
            pipe.disable_cache()
        launches = read_launches()
        ratios = None
        if schedule is None:  # FirstBlockCache: the decisions the run recorded
            computed = list(pipe.fbc_record["decisions"])
            ratios = [None if r is None else float(r) for r in pipe.fbc_record["ratios"]]
        else:
            computed = [bool(c) for c in schedule(config, steps.timesteps)]
        image = np.asarray(images[0])
        if image.shape != (RESOLUTION, RESOLUTION, 3) or image.dtype != np.uint8:
            raise AssertionError(f"flux {label}: bad uint8 image {image.shape} {image.dtype}")
        _check_steps(f"flux {label}", steps.per_step, [full if c else skipped[label] for c in computed],
                     steps.after, decode)
        cosine = _image_cosine(image, dense_image)
        log(f"[flux-cache] {smi}: {label}: {seconds:.3f} s/image, peak memory {peak_gb:.1f} GB, "
            f"{sum(computed)} of {FLUX_STEPS} steps computed, launches {launches}, cosine to the dense image "
            f"{cosine:.4f} (random weights)")
        if ratios is not None:
            log(f"[flux-cache]   first-block relative change per step (threshold {config.threshold}): "
                f"{['-' if r is None else f'{r:.4f}' for r in ratios]}")
        out[label] = {"card": smi, "seconds_per_request": seconds, "peak_memory_gb": peak_gb,
                      "computed_per_step": computed, "launches": launches, "launches_per_step": steps.per_step,
                      "cosine_to_dense": cosine, "fbc_ratios": ratios}
        paths[f"flux_{label}"] = launches
        torch.cuda.empty_cache()  # PAB's stacked cache (~1.6 GB) goes with its request
    RESULTS["flux_cached"] = out
    return paths


def _build_sd3_pipeline(transformer_cfg, vae_cfg, clip1_cfg, clip2_cfg, t5_cfg, device, dtype):
    """A StableDiffusion3Pipeline with random weights from SEED. The
    transformer and T5 are built on the meta device and allocated one block at
    a time on `device` (random init in float32, cast to `dtype`), so no full
    float copy of either exists."""
    import torch

    from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
    from diffusers_tpu_torch.models.modeling_utils import materialize_
    from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModelWithProjection
    from diffusers_tpu_torch.models.text_encoders.t5 import T5EncoderModel
    from diffusers_tpu_torch.models.transformers.transformer_sd3 import SD3Transformer2DModel
    from diffusers_tpu_torch.pipelines.stable_diffusion_3 import StableDiffusion3Pipeline
    from diffusers_tpu_torch.schedulers import FlowMatchEulerDiscreteScheduler

    torch.manual_seed(SEED)
    with torch.device("meta"):
        transformer = SD3Transformer2DModel(**transformer_cfg)
        t5 = T5EncoderModel(**t5_cfg)
    materialize_(transformer, device, dtype)
    materialize_(t5, device, dtype)
    with torch.device(device):
        vae = AutoencoderKL(**vae_cfg).to(dtype)
        clip1 = CLIPTextModelWithProjection(**clip1_cfg).to(dtype)
        clip2 = CLIPTextModelWithProjection(**clip2_cfg).to(dtype)
    kwargs = {} if device == "cuda" else {"device": device}  # the pipeline's default device is the card
    return StableDiffusion3Pipeline(
        transformer=transformer, scheduler=FlowMatchEulerDiscreteScheduler(shift=3.0), vae=vae,
        text_encoder=clip1, tokenizer=StandInTokenizer(), text_encoder_2=clip2, tokenizer_2=StandInTokenizer(),
        text_encoder_3=t5, tokenizer_3=StandInTokenizer(**T5_TOKENIZER), **kwargs,
    )


def sd3_step_launches(config, pipe, timesteps, fbc_decisions=None):
    """The launches expected at each denoise step of an SD3 request under
    `config`, from the module counts and the cache's host-made schedule (for
    FirstBlockCache, from the decisions the run recorded): a step that calls
    the transformer whole launches its module count; a TaylorSeer or MagCache
    step that predicts, nothing; a PAB broadcast step, no K1; a
    FirstBlockCache step that skips, the first block's K1."""
    import numpy as np

    from diffusers_tpu_torch.hooks import (
        FirstBlockCacheConfig,
        MagCacheConfig,
        PyramidAttentionBroadcastConfig,
        TaylorSeerCacheConfig,
        mag_cache_compute_mask,
        pab_compute_mask,
        taylorseer_compute_mask,
    )

    tr, n = pipe.transformer, len(timesteps)
    full, none = _module_launches(tr), _launches()
    if isinstance(config, TaylorSeerCacheConfig):
        return [full if c else none for c in taylorseer_compute_mask(n, config)]
    if isinstance(config, MagCacheConfig):
        return [full if c else none for c in mag_cache_compute_mask(config)]
    if isinstance(config, PyramidAttentionBroadcastConfig):
        mask = pab_compute_mask(np.asarray(timesteps), config.spatial_attention_block_skip_range,
                                config.spatial_attention_timestep_skip_range)
        return [full if c else _launches() for c in mask]
    if isinstance(config, FirstBlockCacheConfig):
        return [full if c else _module_launches(tr.transformer_blocks[0]) for c in fbc_decisions]
    return [full] * n  # dense, TextKV, FasterCache (one call a step at batch 2 or 1), a callback


def small_sd3_cases():
    """Phase 10c's cases: (pipeline, label, cache config or None, callback or
    None, extra call arguments); the image-conditioned ones on the SD3.5-style
    components."""
    from diffusers_tpu_torch.hooks import (
        FasterCacheConfig,
        FirstBlockCacheConfig,
        MagCacheConfig,
        PyramidAttentionBroadcastConfig,
        TaylorSeerCacheConfig,
        TextKVCacheConfig,
    )

    n = SMALL_CACHE_STEPS
    image, mask, _ = synthetic_inputs(32)
    halve_latents = lambda p, i, t, kw: {"latents": kw["latents"] * 0.5} if i == 3 else {}  # noqa: E731
    return (
        ("sd3.0", "sd3.0 dense", None, None, {}),
        ("sd3.5", "sd3.5 dense", None, None, {}),
        ("sd3.5", "sd3.5 taylorseer", TaylorSeerCacheConfig(cache_interval=3, disable_cache_before_step=2, max_order=2),
         None, {}),
        ("sd3.5", "sd3.5 mag_cache", MagCacheConfig(threshold=0.5, max_skip_steps=1, retention_ratio=0.25,
                                              num_inference_steps=n, mag_ratios=(1.0,) * n), None, {}),
        ("sd3.5", "sd3.5 text_kv", TextKVCacheConfig(), None, {}),
        ("sd3.5", "sd3.5 faster_cache", FasterCacheConfig(unconditional_batch_skip_range=3,
                                                    unconditional_batch_timestep_skip_range=(-1, 1000)), None, {}),
        ("sd3.5", "sd3.5 pab", PyramidAttentionBroadcastConfig(spatial_attention_timestep_skip_range=(100, 950)), None, {}),
        ("sd3.5", "sd3.5 first_block_cache", FirstBlockCacheConfig(threshold=SMALL_FBC_THRESHOLD), None, {}),
        ("sd3.5", "sd3.5 callback_latents", None, halve_latents, {}),
        ("img2img", "sd3.5 img2img", None, None, dict(image=image, strength=0.6)),
        ("inpaint", "sd3.5 inpaint", None, None, dict(image=image, mask_image=mask, strength=0.8)),
    )


def check_small_sd3(device: str = "cuda"):
    """Phase 10c: small SD3.0- and SD3.5-style pipelines (SMALL_SD3,
    SMALL_SD35) on the card (bf16, kernels) against the CPU (f32, plain
    versions; held to JAX by tests/test_torch_pipeline_sd3.py), with phase
    7's tolerance: text-to-image, every SD3 cache config and a step callback
    at SMALL_CACHE_STEPS steps, img2img and inpaint. Both sides take the same
    latents, or draw from one CPU generator seeded alike. On the card each
    step's launches are held to the module counts under the cache's schedule
    (`StepLaunches`; the VAE encode of img2img and inpaint booked to the first
    step, the decode after the last)."""
    import numpy as np
    import torch

    from diffusers_tpu_torch.pipelines.stable_diffusion_3 import (
        StableDiffusion3Img2ImgPipeline,
        StableDiffusion3InpaintPipeline,
    )

    sides = []
    for dev in ("cpu", device):
        pipes = {}
        for name, cfg in (("sd3.0", SMALL_SD3), ("sd3.5", SMALL_SD35)):
            pipes[name] = _build_sd3_pipeline(cfg, SMALL_SD3_VAE, SMALL_SD3_CLIP, SMALL_SD3_CLIP, SMALL_T5, "cpu",
                                              torch.float32)
        parts = dict(pipes["sd3.5"].components, device="cpu")
        pipes["img2img"] = StableDiffusion3Img2ImgPipeline(**parts)
        pipes["inpaint"] = StableDiffusion3InpaintPipeline(**parts)
        for pipe in pipes.values():
            pipe.to(device=torch.device(dev), dtype=torch.float32 if dev == "cpu" else torch.bfloat16)
        sides.append(pipes)
    latents = torch.from_numpy(np.random.RandomState(SEED).randn(1, 16, 16, 16).astype(np.float32))
    tol = 0.05  # phase 7: bf16 on the card against f32 on the CPU, on the [0, 1] image
    results = {}
    for name, label, config, callback, extra in small_sd3_cases():
        images, records = [], []
        for pipes in sides:  # the CPU, then the card
            pipe = pipes[name]
            kwargs = dict(num_inference_steps=SMALL_CACHE_STEPS, guidance_scale=SD3_GUIDANCE, max_sequence_length=64,
                          output_type="np", **extra)
            if "image" in extra:
                kwargs["generator"] = torch.Generator().manual_seed(SEED)
            else:
                kwargs.update(latents=latents, callback_on_step_end=callback)
            if config is not None:
                pipe.enable_cache(config)
            reset_launches()
            try:
                with StepLaunches(pipe, pipe.transformer) as steps:
                    images.append(pipe(PROMPTS[0], **kwargs).images)
            finally:
                pipe.disable_cache()
            records.append(list(pipe.fbc_record["decisions"]) if "first_block" in label else None)
        ref, out = images
        err = float(np.abs(out - ref).max())
        timesteps = steps.timesteps
        expected = sd3_step_launches(config, pipe, timesteps, records[1])
        if "image" in extra:  # the VAE encode runs before the first step
            expected[0] = {k: v + _module_launches(pipe.vae.encoder)[k] for k, v in expected[0].items()}
        row = {"max_abs_err": err, "tol": tol, "launches": read_launches(), "steps": len(timesteps),
               "transformer_batches": steps.batches}
        if records[0] is not None:
            row["decisions"] = {"cpu": records[0], "card": records[1]}
        results[label] = row
        log(f"[ref-sd3] small {label}, card bf16 vs CPU f32: max |diff| {err:.3e} (tol {tol}); launches "
            f"{row['launches']}; transformer batches {steps.batches}"
            + (f"; decisions CPU {records[0]}, card {records[1]}" if records[0] is not None else ""))
        if not (out.shape == ref.shape == (1, 32, 32, 3) and np.isfinite(out).all() and err <= tol):
            raise AssertionError(f"small {label}: the card disagrees with the CPU")
        _check_steps(f"small {label}", steps.per_step, expected, steps.after,
                     _module_launches(pipe.vae.decoder))
    RESULTS["small_sd3"] = results


def _post(port: int, payload: dict, timeout: float = 600):
    """(status, JSON) of a POST to the server's generation route."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/images/generations", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _fetch_png(port: int, url: str):
    import urllib.request

    from diffusers_tpu_torch.utils.png import decode_png

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/images/{url.rsplit('/', 1)[-1]}", timeout=60) as r:
        return decode_png(r.read())


def run_sd3_served(smi: str):
    """Phase 16: SD3.5 Medium at its published widths (SD35_MEDIUM, SD3_VAE,
    CLIP-L, bigG, T5-XXL; random bf16 weights from SEED made on the card),
    served by the port's HTTP server (`serving.server.serve`, seed 0) on
    127.0.0.1 at its defaults (1024 px, 28 steps, CFG 7.0): one request,
    held at its first transformer call until two more same-shape requests
    are queued, which then coalesce into one batch of 2. Each PNG is fetched
    and decoded with the port's reader; the first must equal a direct
    pipeline call from the same seed. Then, directly on the pipeline, one
    TaylorSeer(10, 2, 2) and one FirstBlockCache request. Every step's
    launches are held to the module counts (`StepLaunches`)."""
    import logging
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from diffusers_tpu_torch.hooks import FirstBlockCacheConfig, TaylorSeerCacheConfig
    from diffusers_tpu_torch.serving import server

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = _build_sd3_pipeline(SD35_MEDIUM, SD3_VAE, CLIP_L, CLIP_BIGG, T5_XXL, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tr = pipe.transformer
    n_params = {name: sum(p.numel() for p in getattr(pipe, name).parameters())
                for name in ("transformer", "text_encoder_3", "text_encoder", "text_encoder_2", "vae")}
    log(f"[sd3] built SD3.5 Medium at full width on the card in {build_s:.1f} s: parameters "
        f"{ {k: f'{v / 1e9:.3f} B' for k, v in n_params.items()} }, bf16, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB resident")
    per_call, decode = _module_launches(tr), _module_launches(pipe.vae.decoder)
    k1_call = per_call["flash_attention_fwd"]  # 24 joint attentions + 13 attn2

    # --- served: one request, then two coalesced
    records, image_dir = [], tempfile.mkdtemp(prefix="sd3_images_")
    capture = logging.Handler()
    capture.emit = lambda record: records.append(record.getMessage())
    server.logger.addHandler(capture)
    server.logger.setLevel(logging.INFO)
    server.IMAGE_DIR = image_dir
    httpd = server.serve(pipeline=pipe, host="127.0.0.1", port=0, seed=SEED)
    worker, port = httpd.worker, httpd.server_address[1]
    held = threading.Event()

    def hold_first(mod, args):  # the first batch waits for the next two jobs, so they coalesce
        hold.remove()
        held.set()
        deadline = time.monotonic() + 120
        while worker.jobs.qsize() < 2:
            if time.monotonic() > deadline:
                raise RuntimeError("the second and third requests never reached the queue")
            time.sleep(0.005)

    hold = tr.register_forward_pre_hook(hold_first)
    serving = threading.Thread(target=httpd.serve_forever, daemon=True)
    serving.start()
    answers = {}

    def post(i):  # the server's defaults, stated
        answers[i] = _post(port, {"prompt": SD3_PROMPTS[i], "size": f"{RESOLUTION}x{RESOLUTION}", "steps": SD3_STEPS,
                                  "guidance_scale": SD3_GUIDANCE})

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:
        clients = [threading.Thread(target=post, args=(0,))]
        clients[0].start()
        if not held.wait(timeout=600):
            raise AssertionError("the server never started the first request")
        clients += [threading.Thread(target=post, args=(i,)) for i in (1, 2)]
        for c in clients[1:]:
            c.start()
        for c in clients:
            c.join(timeout=900)
        torch.cuda.synchronize()
        served_launches = read_launches()
        served_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if sorted(answers) != [0, 1, 2] or any(answers[i][0] != 200 for i in range(3)):
            raise AssertionError(f"the served requests failed: {answers}")
        pngs = [_fetch_png(port, answers[i][1]["data"][0]["url"]) for i in range(3)]
    finally:
        hold.remove()
        server.logger.removeHandler(capture)
        httpd.shutdown()
        worker.stop()
        httpd.server_close()
        shutil.rmtree(image_dir, ignore_errors=True)
    batches = [(int(m.split()[0].split("=")[1]), float(m.rsplit(" in ", 1)[1].rstrip("s")))
               for m in records if m.startswith("batch=")]
    if [b for b, _ in batches] != [1, 2]:
        raise AssertionError(f"the server ran batches {batches}, expected [1, 2]")
    if any(im.shape != (RESOLUTION, RESOLUTION, 3) or im.dtype != np.uint8 for im in pngs):
        raise AssertionError(f"bad served images {[(im.shape, im.dtype) for im in pngs]}")
    expected = {k: 2 * (SD3_STEPS * per_call[k] + decode[k]) for k in per_call}  # two pipeline calls
    log(f"[sd3] {smi}: served 3 requests as batches {[b for b, _ in batches]} in {[s for _, s in batches]} s "
        f"(s/image {batches[0][1]:.3f} alone, {batches[1][1] / 2:.3f} coalesced); peak memory {served_peak_gb:.1f} "
        f"GB; launches {served_launches} (expected {expected})")
    if served_launches != expected:
        raise AssertionError(f"the served requests launched {served_launches}, expected {expected}")

    # --- the first request again, directly, from the same seed; transformer time on CUDA events
    spans = []

    def on_start(mod, args):
        spans.append([torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)])
        spans[-1][0].record()

    pre = tr.register_forward_pre_hook(on_start)
    post_hook = tr.register_forward_hook(lambda mod, args, out: spans[-1][1].record())
    seen = {}
    vae_in = pipe.vae.decoder.register_forward_pre_hook(lambda mod, args: seen.__setitem__("latents", args[0]))
    reset_launches()
    try:
        with StepLaunches(pipe, tr) as steps:
            direct, direct_s, direct_peak = _request_seconds(lambda: pipe(
                SD3_PROMPTS[0], height=RESOLUTION, width=RESOLUTION, num_inference_steps=SD3_STEPS,
                guidance_scale=SD3_GUIDANCE, generator=torch.Generator(device="cuda").manual_seed(SEED),
                output_type="np").images)
    finally:
        for h in (pre, post_hook, vae_in):
            h.remove()
    direct_launches = read_launches()
    step_ms = [a.elapsed_time(b) for a, b in spans]
    direct_image = server.to_uint8(direct[0])
    diff = int(np.abs(direct_image.astype(np.int16) - pngs[0].astype(np.int16)).max())
    if not bool(torch.isfinite(seen["latents"]).all()):
        raise AssertionError("non-finite SD3 latents")
    _check_steps("sd3 direct", steps.per_step, [per_call] * SD3_STEPS, steps.after, decode)
    mean_ms = sum(step_ms) / len(step_ms)
    log(f"[sd3] {smi}: direct request {direct_s:.3f} s/image, transformer {mean_ms:.2f} ms a call at b=2 (CUDA "
        f"events; min {min(step_ms):.2f}, max {max(step_ms):.2f}), peak memory {direct_peak:.1f} GB; served image "
        f"vs direct call from seed {SEED}: max |diff| {diff} (uint8 levels; limit 2); launches a request "
        f"K1 {SD3_STEPS * k1_call} ({k1_call} a call), K4 {decode['group_norm']} (the decode)")
    if diff > 2:  # the same latents through the same kernels: equal but for a rounding flip
        raise AssertionError(f"the served image differs from a direct call from the same seed by {diff}")

    # --- the cached requests, directly on the pipeline
    cached = {}
    for label, config in (("taylorseer", TaylorSeerCacheConfig(cache_interval=10, disable_cache_before_step=2,
                                                               max_order=2)),
                          ("first_block_cache", FirstBlockCacheConfig())):
        pipe.enable_cache(config)
        reset_launches()
        try:
            with StepLaunches(pipe, tr) as steps:
                images, seconds, peak_gb = _request_seconds(lambda: pipe(
                    SD3_PROMPTS[0], height=RESOLUTION, width=RESOLUTION, num_inference_steps=SD3_STEPS,
                    guidance_scale=SD3_GUIDANCE, generator=torch.Generator(device="cuda").manual_seed(SEED),
                    output_type="np").images)
        finally:
            pipe.disable_cache()
        decisions = list(pipe.fbc_record["decisions"]) if label == "first_block_cache" else None
        expected_steps = sd3_step_launches(config, pipe, steps.timesteps, decisions)
        _check_steps(f"sd3 {label}", steps.per_step, expected_steps, steps.after, decode)
        calls = sum(decisions) if decisions is not None else len(steps.batches)  # whole-transformer calls
        image = server.to_uint8(images[0])
        cached[label] = {"seconds_per_request": seconds, "peak_memory_gb": peak_gb, "full_transformer_calls": calls,
                         "transformer_calls": len(steps.batches), "launches": read_launches(),
                         "cosine_to_dense": _image_cosine(image, direct_image), "fbc_decisions": decisions}
        log(f"[sd3-cache] {smi}: {label}: {seconds:.3f} s/image, {calls} of {SD3_STEPS} steps ran the whole "
            f"transformer ({len(steps.batches)} transformer calls), launches {cached[label]['launches']}, cosine to "
            f"the dense image {cached[label]['cosine_to_dense']:.4f} (random weights)")
    RESULTS["sd3"] = {
        "card": smi, "steps": SD3_STEPS, "resolution": RESOLUTION, "guidance_scale": SD3_GUIDANCE,
        "build_seconds": build_s, "parameters": n_params, "served_batches": batches,
        "served_seconds_per_image": [batches[0][1], batches[1][1] / 2], "served_peak_memory_gb": served_peak_gb,
        "served_launches": served_launches, "direct_seconds": direct_s, "direct_peak_memory_gb": direct_peak,
        "direct_launches": direct_launches, "transformer_ms_per_call": step_ms, "transformer_ms_mean": mean_ms,
        "served_vs_direct_max_diff": diff, "k1_per_call": k1_call, "cached": cached,
    }
    return {"sd3_served": served_launches, "sd3_direct": direct_launches,
            **{f"sd3_{label}": row["launches"] for label, row in cached.items()}}, pipe


def _build_wan_pipeline(transformer_cfg, vae_cfg, umt5_cfg, device, dtype):
    """A WanPipeline with random weights from SEED. UMT5 is built on the meta
    device and allocated one block at a time on `device` (random init in
    float32, cast to `dtype`); the transformer (whose `scale_shift_table` sits
    on the model itself) and the VAE are made in float32 on `device`, then
    cast."""
    import torch

    from diffusers_tpu_torch import AutoencoderKLWan, UMT5EncoderModel, UniPCMultistepScheduler, WanPipeline, \
        WanTransformer3DModel
    from diffusers_tpu_torch.models.modeling_utils import materialize_

    torch.manual_seed(SEED)
    with torch.device("meta"):
        umt5 = UMT5EncoderModel(**umt5_cfg)
    materialize_(umt5, device, dtype)
    with torch.device(device):
        transformer = WanTransformer3DModel(**transformer_cfg).to(dtype)
        vae = AutoencoderKLWan(**vae_cfg).to(dtype)
    kwargs = {} if device == "cuda" else {"device": device}  # the pipeline's default device is the card
    tokenizer = StandInTokenizer(vocab_size=umt5_cfg["vocab_size"], bos=None, eos=1)  # no mask: ids != 0 count
    return WanPipeline(tokenizer=tokenizer, text_encoder=umt5.eval(),
                       transformer=transformer.eval(), vae=vae.eval(), scheduler=UniPCMultistepScheduler(**WAN_UNIPC),
                       **kwargs)


def wan_step_launches(config, pipe, timesteps, fbc_record=None):
    """The launches expected at each denoise step of a Wan request under
    `config` (CFG: a cond and an uncond call a step), from the module counts
    and the cache's host-made schedule (for FirstBlockCache, from the
    decisions the run recorded for each stream): a step's calls launch their
    module counts; a TaylorSeer or MagCache step that predicts, nothing; a
    PAB broadcast step, the cross attentions alone; a FirstBlockCache call
    that skips, the first block's; a FasterCache step that skips, one call."""
    import numpy as np

    from diffusers_tpu_torch.hooks import (
        FasterCacheConfig,
        FirstBlockCacheConfig,
        MagCacheConfig,
        PyramidAttentionBroadcastConfig,
        TaylorSeerCacheConfig,
        faster_cache_schedules,
        mag_cache_compute_mask,
        pab_compute_mask,
        taylorseer_compute_mask,
    )

    tr, n = pipe.transformer, len(timesteps)
    full, none = _module_launches(tr), _launches()

    def times(counts, calls):
        return {k: calls * v for k, v in counts.items()}

    if isinstance(config, TaylorSeerCacheConfig):
        return [times(full, 2) if c else none for c in taylorseer_compute_mask(n, config)]
    if isinstance(config, MagCacheConfig):
        return [times(full, 2) if c else none for c in mag_cache_compute_mask(config)]
    if isinstance(config, FasterCacheConfig):
        skip = faster_cache_schedules(np.asarray(timesteps), config)[0]
        return [times(full, 1 if s else 2) for s in skip]
    if isinstance(config, PyramidAttentionBroadcastConfig):
        mask = pab_compute_mask(np.asarray(timesteps), config.spatial_attention_block_skip_range,
                                config.spatial_attention_timestep_skip_range)
        cross = _launches(flash_attention_fwd=len(tr.blocks))
        return [times(full if c else cross, 2) for c in mask]
    if isinstance(config, FirstBlockCacheConfig):
        first = _module_launches(tr.blocks[0])
        return [{k: (full if c else first)[k] + (full if u else first)[k] for k in full}
                for c, u in zip(fbc_record["cond"]["decisions"], fbc_record["uncond"]["decisions"])]
    return [times(full, 2)] * n  # dense, TextKV, a callback


def small_wan_cases():
    """Phase 10d's cases: (label, cache config or None, callback or None, FreeInit or None)."""
    from diffusers_tpu_torch.hooks import (
        FasterCacheConfig,
        FirstBlockCacheConfig,
        MagCacheConfig,
        PyramidAttentionBroadcastConfig,
        TaylorSeerCacheConfig,
        TextKVCacheConfig,
    )

    n = SMALL_CACHE_STEPS
    halve_latents = lambda p, i, t, kw: {"latents": kw["latents"] * 0.5} if i == 3 else {}  # noqa: E731
    return (
        ("dense", None, None, None),
        ("taylorseer", TaylorSeerCacheConfig(cache_interval=3, disable_cache_before_step=2, max_order=2), None, None),
        ("mag_cache", MagCacheConfig(threshold=0.5, max_skip_steps=1, retention_ratio=0.25, num_inference_steps=n,
                                     mag_ratios=(1.0,) * n), None, None),
        ("text_kv", TextKVCacheConfig(), None, None),
        ("faster_cache", FasterCacheConfig(unconditional_batch_skip_range=3,
                                           unconditional_batch_timestep_skip_range=(-1, 1000)), None, None),
        ("pab", PyramidAttentionBroadcastConfig(spatial_attention_timestep_skip_range=(100, 950)), None, None),
        ("first_block_cache", FirstBlockCacheConfig(threshold=SMALL_FBC_THRESHOLD), None, None),
        ("callback_latents", None, halve_latents, None),
        ("free_init", None, None, dict(num_iters=2, use_fast_sampling=True)),
    )


def check_small_wan(device: str = "cuda"):
    """Phase 10d: a small Wan pipeline (SMALL_WAN, SMALL_WAN_VAE, SMALL_UMT5;
    9 frames of 64 x 64) on the card (bf16, kernels) against the CPU (f32,
    plain versions; held to JAX by tests/test_torch_pipeline_wan.py), with
    phase 7's tolerance on the [0, 1] video: the dense request, each of the six
    caches, a step callback and FreeInit (two passes, fast sampling) at
    SMALL_CACHE_STEPS steps. Both sides take the same latents and draw
    FreeInit's fresh noise from one CPU generator seeded alike. On the card
    each step's launches are held to the module counts under the cache's
    schedule (`StepLaunches`; the UMT5 encode and the VAE decode launch no
    kernel: their attention is `native`)."""
    import numpy as np
    import torch

    sides = [_build_wan_pipeline(SMALL_WAN, SMALL_WAN_VAE, SMALL_UMT5, "cpu", torch.float32) for _ in range(2)]
    sides[1].to(device=torch.device(device), dtype=torch.bfloat16)
    latents = torch.from_numpy(np.random.RandomState(SEED).randn(1, 16, 3, 8, 8).astype(np.float32))
    tol = 0.05  # phase 7: bf16 on the card against f32 on the CPU, on the [0, 1] video
    results = {}
    for label, config, callback, free_init in small_wan_cases():
        videos, records = [], []
        for pipe in sides:  # the CPU, then the card
            if config is not None:
                pipe.enable_cache(config)
            if free_init is not None:
                pipe.enable_free_init(**free_init)
            reset_launches()
            try:
                with StepLaunches(pipe, pipe.transformer) as steps:
                    videos.append(pipe(WAN_PROMPT, WAN_NEGATIVE, height=64, width=64, num_frames=9,
                                       num_inference_steps=SMALL_CACHE_STEPS, guidance_scale=WAN_GUIDANCE,
                                       max_sequence_length=64, latents=latents, callback_on_step_end=callback,
                                       generator=torch.Generator().manual_seed(SEED), output_type="np").frames)
            finally:
                pipe.disable_cache()
                pipe.disable_free_init()
            records.append(pipe.fbc_record if label == "first_block_cache" else None)
        ref, out = videos
        err = float(np.abs(out - ref).max())
        expected = wan_step_launches(config, pipe, steps.timesteps, records[1])
        row = {"max_abs_err": err, "tol": tol, "launches": read_launches(), "steps": len(steps.timesteps),
               "transformer_calls": len(steps.batches)}
        if records[0] is not None:
            row["decisions"] = {side: {stream: rec[stream]["decisions"] for stream in rec}
                                for side, rec in zip(("cpu", "card"), records)}
        results[label] = row
        log(f"[ref-wan] small Wan {label}, card bf16 vs CPU f32: max |diff| {err:.3e} (tol {tol}); launches "
            f"{row['launches']}; {row['transformer_calls']} transformer calls over {row['steps']} steps"
            + (f"; decisions {row['decisions']}" if records[0] is not None else ""))
        if not (out.shape == ref.shape == (1, 9, 64, 64, 3) and np.isfinite(out).all() and err <= tol):
            raise AssertionError(f"small Wan {label}: the card disagrees with the CPU")
        _check_steps(f"small Wan {label}", steps.per_step, expected, steps.after, _launches())
        if read_launches()["flash_attention_fwd"] <= 0:
            raise AssertionError(f"small Wan {label} on the card launched no K1")
    RESULTS["small_wan"] = results


def run_wan(smi: str):
    """Phase 17: Wan2.1-T2V-1.3B at its published widths (WAN_1_3B, WAN_VAE,
    UMT5-XXL; random bf16 weights from SEED made on the card): one 480 x 832,
    81-frame request of WAN_STEPS UniPC steps with CFG 5.0 (two batch-1
    transformer calls a step) and 512 text tokens, through
    `WanPipeline.__call__`; then one TaylorSeer(10, 2, 2) request. Recorded:
    seconds a video (host clock ending in a synchronise), each transformer
    call on CUDA events, the UMT5 encodes and the VAE decode apart (CUDA
    events), peak memory; every step's launches held to the module counts
    (K1 60 a call, 120 a step). Returns the paths' launches and
    the pipeline (phases 17b and 19 go on with its components)."""
    import numpy as np
    import torch

    from diffusers_tpu_torch.hooks import TaylorSeerCacheConfig

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = _build_wan_pipeline(WAN_1_3B, WAN_VAE, UMT5_XXL, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tr = pipe.transformer
    n_params = {name: sum(p.numel() for p in getattr(pipe, name).parameters())
                for name in ("transformer", "text_encoder", "vae")}
    resident_gb = torch.cuda.memory_allocated() / 1e9
    log(f"[wan] built Wan2.1-T2V-1.3B at full width on the card in {build_s:.1f} s: parameters "
        f"{ {k: f'{v / 1e9:.3f} B' for k, v in n_params.items()} }, bf16, {resident_gb:.1f} GB resident")
    per_call = _module_launches(tr)
    if per_call["flash_attention_fwd"] != 60:
        raise AssertionError(f"the Wan transformer counts {per_call} launches a call, expected K1 60")

    request = dict(prompt=WAN_PROMPT, negative_prompt=WAN_NEGATIVE, height=WAN_HEIGHT, width=WAN_WIDTH,
                   num_frames=WAN_FRAMES, num_inference_steps=WAN_STEPS, guidance_scale=WAN_GUIDANCE,
                   max_sequence_length=WAN_TEXT_LEN, output_type="np")
    results = {}
    for label, config in (("dense", None), ("taylorseer", TaylorSeerCacheConfig(
            cache_interval=10, disable_cache_before_step=2, max_order=2))):
        if config is not None:
            pipe.enable_cache(config)
        reset_launches()
        spans = CudaSpans({"transformer": tr, "text_encoder": pipe.text_encoder}, {"vae_decode": (pipe.vae, "decode")})
        try:
            with StepLaunches(pipe, tr) as steps, spans:
                frames, seconds, peak_gb = _request_seconds(lambda: pipe(
                    generator=torch.Generator(device="cuda").manual_seed(SEED), **request).frames)
        finally:
            pipe.disable_cache()
        ms = spans.ms()
        launches = read_launches()
        expected = wan_step_launches(config, pipe, steps.timesteps)
        _check_steps(f"wan {label}", steps.per_step, expected, steps.after, _launches())
        if not (frames.shape == (1, WAN_FRAMES, WAN_HEIGHT, WAN_WIDTH, 3) and np.isfinite(frames).all()):
            raise AssertionError(f"wan {label}: bad frames {frames.shape}")
        row = {"seconds_per_video": seconds, "peak_memory_gb": peak_gb, "launches": launches,
               "transformer_calls": len(ms["transformer"]), "transformer_ms_per_call": ms["transformer"],
               "transformer_ms_mean": float(np.mean(ms["transformer"])),
               "umt5_encode_seconds": sum(ms["text_encoder"]) / 1e3, "umt5_calls": len(ms["text_encoder"]),
               "vae_decode_seconds": sum(ms["vae_decode"]) / 1e3, "frames_mean": float(frames.mean()),
               "frames_std": float(frames.std())}
        if label == "dense":
            dense_frames = frames
            if launches["flash_attention_fwd"] != 2 * WAN_STEPS * 60:
                raise AssertionError(f"the dense Wan request launched {launches}, expected K1 {2 * WAN_STEPS * 60}")
        else:
            a, b = dense_frames.astype(np.float64).ravel(), frames.astype(np.float64).ravel()
            row["cosine_to_dense"] = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
        results[label] = row
        log(f"[wan] {smi}: {label}: {seconds:.2f} s a video ({WAN_FRAMES} x {WAN_HEIGHT} x {WAN_WIDTH}, "
            f"{WAN_STEPS} steps), {row['transformer_calls']} transformer calls of {row['transformer_ms_mean']:.1f} "
            f"ms (CUDA events; min {min(ms['transformer']):.1f}, max {max(ms['transformer']):.1f}), UMT5 encode "
            f"{row['umt5_encode_seconds']:.3f} s ({row['umt5_calls']} calls), VAE decode "
            f"{row['vae_decode_seconds']:.2f} s, peak memory {peak_gb:.1f} GB; launches {launches}"
            + (f"; cosine to the dense video {row['cosine_to_dense']:.4f} (random weights)"
               if "cosine_to_dense" in row else ""))
    RESULTS["wan"] = {"card": smi, "steps": WAN_STEPS, "frames": WAN_FRAMES, "height": WAN_HEIGHT,
                      "width": WAN_WIDTH, "guidance_scale": WAN_GUIDANCE, "text_tokens": WAN_TEXT_LEN,
                      "build_seconds": build_s, "parameters": n_params, "resident_gb": resident_gb,
                      "k1_per_call": per_call["flash_attention_fwd"], **results}
    return {"wan": results["dense"]["launches"], "wan_taylorseer": results["taylorseer"]["launches"]}, pipe


def synthetic_video(frames: int, height: int, width: int):
    """float32 [frames, H, W, 3] in [0, 1]: seeded colour gradients that drift
    frame by frame, plus noise (the first frame, as uint8, is the image of
    the image-to-video requests)."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    y, x = y / (height - 1), x / (width - 1)
    t = np.arange(frames, dtype=np.float32)[:, None, None] / max(frames - 1, 1)
    video = np.stack([0.5 + 0.4 * np.sin(6.0 * (x + t)), 0.5 + 0.4 * np.cos(5.0 * (y - t)),
                      0.5 + 0.4 * np.sin(4.0 * (x + y + 2 * t))], axis=-1)
    return np.clip(0.85 * video + 0.15 * rng.rand(frames, height, width, 3), 0, 1).astype(np.float32)


def _wan_random_model(cls, cfg, device, dtype, seed):
    """A model of `cls` with random weights from `seed`: on the CPU built
    directly (float32 init), on the card built on the meta device and
    allocated unit by unit (`materialize_`), so that no float32 copy of a
    14B transformer exists; a parameter of the model itself (the Wan
    transformer's `scale_shift_table`) is drawn as its module draws it,
    randn / sqrt(dim), and one of a module that `materialize_` splits into
    its children by that module's `reset_parameters`."""
    import torch
    from torch import nn

    from diffusers_tpu_torch.models.modeling_utils import materialize_

    torch.manual_seed(seed)
    if torch.device(device).type == "cpu":
        return cls(**cfg).to(dtype).eval()
    with torch.device("meta"):
        model = cls(**cfg)
    materialize_(model, device, dtype)
    for name, p in list(model.named_parameters(recurse=False)):
        if p.is_meta:
            setattr(model, name, nn.Parameter((torch.randn(p.shape, device=device) / p.shape[-1] ** 0.5).to(dtype)))
    for module in model.modules():  # a module that holds a list keeps its own parameters (Animate's motion basis)
        left = [(n, p) for n, p in module.named_parameters(recurse=False) if p.is_meta]
        for name, p in left:
            setattr(module, name, nn.Parameter(torch.empty(p.shape, device=device)))
        if left:
            module.reset_parameters()
            module.to(dtype)
    return model.eval()


def _build_wan_i2v_pipeline(base, transformer_cfg, clip_cfg=None, transformer_2_cfg=None, boundary_ratio=None,
                            image_processor=None):
    """A WanImageToVideoPipeline on `base`'s (a WanPipeline's) tokenizer, UMT5
    and VAE, on its device and in its dtype, with random transformer(s) and
    CLIP vision tower (`clip_cfg` None: no image encoder) from SEED."""
    from diffusers_tpu_torch import CLIPVisionModel, UniPCMultistepScheduler, WanImageToVideoPipeline, \
        WanTransformer3DModel

    device, dtype = base.device, base.vae.dtype
    make = lambda cls, cfg, seed: None if cfg is None else _wan_random_model(cls, cfg, device, dtype, seed)  # noqa
    return WanImageToVideoPipeline(
        tokenizer=base.tokenizer, text_encoder=base.text_encoder, vae=base.vae,
        scheduler=UniPCMultistepScheduler(**WAN_UNIPC), transformer=make(WanTransformer3DModel, transformer_cfg, SEED + 1),
        transformer_2=make(WanTransformer3DModel, transformer_2_cfg, SEED + 2),
        image_encoder=make(CLIPVisionModel, clip_cfg, SEED + 3), image_processor=image_processor,
        boundary_ratio=boundary_ratio, device=device)


def wan_i2v_step_launches(pipe, timesteps):
    """The launches expected at each step of an image-to-video request: two
    calls (cond, uncond) of the step's expert, `transformer` while t >=
    boundary_ratio x 1000 (every step without a boundary), then
    `transformer_2`."""
    ratio = pipe.config.get("boundary_ratio")
    k = len(timesteps) if ratio is None else sum(t >= ratio * 1000 for t in timesteps)
    first, second = (_module_launches(m) if m is not None else None for m in (pipe.transformer, pipe.transformer_2))
    return [{n: 2 * (first if i < k else second)[n] for n in first} for i in range(len(timesteps))]


class CudaSpans:
    """CUDA-event spans, by label, of module forwards (`modules`: label ->
    module) and method calls (`methods`: label -> (object, method name))
    within the block; `ms()` gives each label's spans in ms, in call order."""

    def __init__(self, modules=None, methods=None):
        self.modules, self.methods = modules or {}, methods or {}

    def _start(self, label):
        import torch

        self.spans[label].append([torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)])
        self.spans[label][-1][0].record()

    def __enter__(self):
        self.spans = {label: [] for label in (*self.modules, *self.methods)}
        self._hooks = []
        for label, module in self.modules.items():
            self._hooks.append(module.register_forward_pre_hook(lambda mod, args, label=label: self._start(label)))
            self._hooks.append(module.register_forward_hook(
                lambda mod, args, out, label=label: self.spans[label][-1][1].record()))
        self._saved = {label: owner.__dict__.get(name) for label, (owner, name) in self.methods.items()}
        for label, (owner, name) in self.methods.items():
            def timed(*args, _fn=getattr(owner, name), _label=label, **kwargs):
                self._start(_label)
                out = _fn(*args, **kwargs)
                self.spans[_label][-1][1].record()
                return out

            setattr(owner, name, timed)
        return self

    def __exit__(self, *exc):
        for h in self._hooks:
            h.remove()
        for label, (owner, name) in self.methods.items():  # what was there before: another wrapper, or nothing
            if self._saved[label] is None:
                delattr(owner, name)
            else:
                setattr(owner, name, self._saved[label])
        return False

    def ms(self):
        import torch

        torch.cuda.synchronize()
        return {label: [a.elapsed_time(b) for a, b in spans] for label, spans in self.spans.items()}


def small_wan_i2v_cases():
    """Phase 10e's requests: (label, a function that builds the pipeline on
    the CPU in float32, call keyword arguments). Each call of it draws the
    same weights from SEED."""
    import numpy as np
    import torch

    from diffusers_tpu_torch import WanVideoToVideoPipeline

    def base():
        return _build_wan_pipeline(SMALL_WAN, SMALL_WAN_VAE, SMALL_UMT5, "cpu", torch.float32)

    video = synthetic_video(9, 64, 64)
    image, last = (np.round(255 * video[i]).astype(np.uint8) for i in (0, -1))
    latents = torch.from_numpy(np.random.RandomState(SEED).randn(1, 16, 3, 8, 8).astype(np.float32))
    i2v = dict(image=image, prompt=WAN_PROMPT, negative_prompt=WAN_NEGATIVE, height=64, width=64, num_frames=9,
               num_inference_steps=SAMPLE_ROUND_TRIP_STEPS, guidance_scale=WAN_GUIDANCE,
               max_sequence_length=WAN_TEXT_LEN, latents=latents, output_type="np")
    return (
        ("i2v", lambda: _build_wan_i2v_pipeline(base(), SMALL_WAN_I2V, SMALL_CLIP_VISION), i2v),
        ("flf", lambda: _build_wan_i2v_pipeline(base(), SMALL_WAN_FLF, SMALL_CLIP_VISION), dict(i2v, last_image=last)),
        ("two_experts", lambda: _build_wan_i2v_pipeline(base(), SMALL_WAN_EXPERT, transformer_2_cfg=SMALL_WAN_EXPERT,
                                                        boundary_ratio=0.5),
         dict(i2v, guidance_scale=WAN_A14B_GUIDANCE[0], guidance_scale_2=WAN_A14B_GUIDANCE[1])),
        ("v2v", lambda: WanVideoToVideoPipeline.from_pipe(base()),
         dict(prompt=WAN_PROMPT, negative_prompt=WAN_NEGATIVE, video=video, strength=WAN_V2V_STRENGTH, height=64,
              width=64, num_inference_steps=5, guidance_scale=WAN_GUIDANCE, output_type="np")),
    )


def check_small_wan_i2v(device: str = "cuda"):
    """Phase 10e: small Wan image-to-video (a CLIP vision tower, 512 text
    tokens), first-last-frame (a 2 x 257-token image table), the two-expert
    loop (boundary 0.5, guidance 4.0 then 3.0) and video-to-video (strength
    0.8) pipelines on phase 10d's components, on the card (bf16, kernels)
    against the CPU (f32, plain versions; held to JAX by
    tests/test_torch_pipeline_wan_i2v.py), with phase 7's tolerance on the
    [0, 1] video. Both sides take the same latents, and V2V's noise comes
    from one CPU generator seeded alike. On the card each step's launches
    are held to the step's expert's module counts (K1 3 a block with the
    image branch; the CLIP tower, UMT5 and the VAE launch none: `native`)."""
    import numpy as np
    import torch

    tol = 0.05  # phase 7: bf16 on the card against f32 on the CPU, on the [0, 1] video
    results = {}
    for label, build, call in small_wan_i2v_cases():
        sides = [build(), build().to(device=torch.device(device), dtype=torch.bfloat16)]
        videos = []
        for pipe in sides:  # the CPU, then the card
            reset_launches()
            with StepLaunches(pipe, pipe.transformer) as steps:
                videos.append(pipe(generator=torch.Generator().manual_seed(SEED), **call).frames)
        ref, out = videos
        err = float(np.abs(out - ref).max())
        expected = (wan_i2v_step_launches(pipe, steps.timesteps) if label != "v2v"
                    else wan_step_launches(None, pipe, steps.timesteps))
        results[label] = row = {"max_abs_err": err, "tol": tol, "launches": read_launches(),
                                "steps": len(steps.timesteps), "transformer_calls": len(steps.batches)}
        log(f"[ref-wan-i2v] small Wan {label}, card bf16 vs CPU f32: max |diff| {err:.3e} (tol {tol}); launches "
            f"{row['launches']}; {row['transformer_calls']} calls of `transformer` over {row['steps']} steps")
        if not (out.shape == ref.shape == (1, 9, 64, 64, 3) and np.isfinite(out).all() and err <= tol):
            raise AssertionError(f"small Wan {label}: the card disagrees with the CPU")
        _check_steps(f"small Wan {label}", steps.per_step, expected, steps.after, _launches())
        if read_launches()["flash_attention_fwd"] <= 0:
            raise AssertionError(f"small Wan {label} on the card launched no K1")
    RESULTS["small_wan_i2v"] = results


def run_wan_v2v(smi: str, base):
    """Phase 17b: video-to-video on phase 17's Wan2.1-T2V-1.3B pipeline
    (`WanVideoToVideoPipeline.from_pipe`): a synthetic 81-frame 480 x 832
    video at strength WAN_V2V_STRENGTH, WAN_V2V_STEPS steps (the last
    int(steps x strength) run), CFG 5.0, 512 text tokens. Recorded: seconds a video, the chunked
    81-frame VAE encode and the decode (CUDA events), each transformer call,
    peak memory; every step's launches (K1 60 a call)."""
    import numpy as np
    import torch

    from diffusers_tpu_torch import WanVideoToVideoPipeline

    pipe = WanVideoToVideoPipeline.from_pipe(base)
    video = synthetic_video(WAN_FRAMES, WAN_HEIGHT, WAN_WIDTH)
    reset_launches()
    spans = CudaSpans({"transformer": pipe.transformer},
                      {"vae_encode": (pipe.vae, "encode"), "vae_decode": (pipe.vae, "decode")})
    with spans, StepLaunches(pipe, pipe.transformer) as steps:
        frames, seconds, peak_gb = _request_seconds(lambda: pipe(
            WAN_PROMPT, WAN_NEGATIVE, video=video, strength=WAN_V2V_STRENGTH, height=WAN_HEIGHT, width=WAN_WIDTH,
            num_inference_steps=WAN_V2V_STEPS, guidance_scale=WAN_GUIDANCE, max_sequence_length=WAN_TEXT_LEN,
            generator=torch.Generator(device="cuda").manual_seed(SEED)).frames)
    ms = spans.ms()
    launches = read_launches()
    _check_steps("wan v2v", steps.per_step, wan_step_launches(None, pipe, steps.timesteps), steps.after, _launches())
    kept = WAN_V2V_STEPS - (WAN_V2V_STEPS - int(WAN_V2V_STEPS * WAN_V2V_STRENGTH))
    if not (frames.shape == (1, WAN_FRAMES, WAN_HEIGHT, WAN_WIDTH, 3) and np.isfinite(frames).all()
            and len(steps.timesteps) == kept and launches["flash_attention_fwd"] == 2 * kept * 60):
        raise AssertionError(f"wan v2v: frames {frames.shape}, {len(steps.timesteps)} steps, launches {launches}")
    row = {"seconds_per_video": seconds, "peak_memory_gb": peak_gb, "launches": launches, "steps": kept,
           "strength": WAN_V2V_STRENGTH, "transformer_ms_per_call": ms["transformer"],
           "transformer_ms_mean": float(np.mean(ms["transformer"])), "vae_encode_seconds": sum(ms["vae_encode"]) / 1e3,
           "vae_decode_seconds": sum(ms["vae_decode"]) / 1e3,
           "abs_diff_to_input_mean": float(np.abs(frames[0] - video).mean())}
    log(f"[wan-v2v] {smi}: {seconds:.2f} s a video ({WAN_FRAMES} x {WAN_HEIGHT} x {WAN_WIDTH}, strength "
        f"{WAN_V2V_STRENGTH}: {kept} of {WAN_V2V_STEPS} steps), {len(ms['transformer'])} transformer calls of "
        f"{row['transformer_ms_mean']:.1f} ms (CUDA events), VAE encode {row['vae_encode_seconds']:.2f} s (81 frames, "
        f"chunked), decode {row['vae_decode_seconds']:.2f} s, peak memory {peak_gb:.1f} GB; launches {launches}; mean "
        f"|output - input| {row['abs_diff_to_input_mean']:.3f} (random weights)")
    RESULTS["wan_v2v"] = row
    return {"wan_v2v": launches}


def run_wan_i2v(smi: str, base):
    """Phase 19: Wan2.1-I2V-14B-480P at its published widths and full depth
    (WAN_I2V_14B, built on the meta device and filled tensor by tensor on the
    card, bf16; a CLIP ViT-H/14; phase 17's UMT5-XXL and VAE): one 480 x 832,
    81-frame request from a synthetic image, CFG 5.0, 512 text tokens,
    WAN_I2V_STEPS steps, through `WanImageToVideoPipeline.__call__`. Recorded:
    each step's and each transformer call's ms (CUDA events), the CLIP
    encode, the chunked 81-frame VAE encode (and its own peak memory,
    measured apart) and the decode, the request's peak memory; K1 held to
    120 a transformer call. Then, at full width with the depth cut to
    WAN_CUT_LAYERS blocks, WAN_CUT_STEPS steps: first-last-frame with
    Wan2.1-FLF2V's 514-token image table, and Wan 2.2's two experts
    (boundary 0.9, guidance 4.0 then 3.0, no CLIP context); each step's
    launches held to its expert's module counts."""
    import gc

    import numpy as np
    import torch

    video = synthetic_video(WAN_FRAMES, WAN_HEIGHT, WAN_WIDTH)
    image, last = (np.round(255 * video[i]).astype(np.uint8) for i in (0, -1))
    request = dict(image=image, prompt=WAN_PROMPT, negative_prompt=WAN_NEGATIVE, height=WAN_HEIGHT, width=WAN_WIDTH,
                   num_frames=WAN_FRAMES, guidance_scale=WAN_GUIDANCE, max_sequence_length=WAN_TEXT_LEN)
    cases = (
        ("i2v_14b", dict(transformer_cfg=WAN_I2V_14B, clip_cfg=CLIP_VIT_H), dict(num_inference_steps=WAN_I2V_STEPS)),
        ("flf_cut", dict(transformer_cfg=WAN_FLF_CUT, clip_cfg=CLIP_VIT_H),
         dict(num_inference_steps=WAN_CUT_STEPS, last_image=last)),
        ("two_experts_cut", dict(transformer_cfg=WAN_A14B_CUT, transformer_2_cfg=WAN_A14B_CUT,
                                 boundary_ratio=WAN_A14B_BOUNDARY),
         dict(num_inference_steps=WAN_CUT_STEPS, guidance_scale=WAN_A14B_GUIDANCE[0],
              guidance_scale_2=WAN_A14B_GUIDANCE[1])),
    )
    results, paths = {}, {}
    for label, build, call in cases:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe = _build_wan_i2v_pipeline(base, **build)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        resident_gb = torch.cuda.memory_allocated() / 1e9
        log(f"[wan-i2v] {label}: built in {build_s:.1f} s, {resident_gb:.1f} GB resident")
        per_call = _module_launches(pipe.transformer)
        experts = {"transformer": pipe.transformer, **({"transformer_2": pipe.transformer_2}
                                                        if pipe.transformer_2 is not None else {})}
        n_params = {name: sum(p.numel() for p in m.parameters()) for name, m in experts.items()}
        if label == "i2v_14b":
            n_params["image_encoder"] = sum(p.numel() for p in pipe.image_encoder.parameters())
            if per_call["flash_attention_fwd"] != 120:
                raise AssertionError(f"the 14B transformer counts {per_call} launches a call, expected K1 120")
            # the chunked encode of the request's 81-frame clip, alone: its own peak memory
            clip = torch.zeros((1, 3, WAN_FRAMES, WAN_HEIGHT, WAN_WIDTH), device="cuda", dtype=pipe.vae.dtype)
            clip[:, :, 0] = torch.from_numpy(image).permute(2, 0, 1).to("cuda") / 127.5 - 1
            before = torch.cuda.memory_allocated()
            with torch.no_grad():
                _, encode_s, encode_peak = _request_seconds(lambda: pipe.vae.encode(clip).mode())
            encode_peak_gb = encode_peak - before / 1e9
            del clip
        reset_launches()
        spans = CudaSpans({**experts, "text_encoder": pipe.text_encoder,
                           **({"image_encoder": pipe.image_encoder} if pipe.image_encoder is not None else {})},
                          {"vae_encode": (pipe.vae, "encode"), "vae_decode": (pipe.vae, "decode"),
                           "scheduler_step": (pipe.scheduler, "step")})
        with StepLaunches(pipe, pipe.transformer) as steps, spans:
            frames, seconds, peak_gb = _request_seconds(lambda: pipe(
                generator=torch.Generator(device="cuda").manual_seed(SEED), **{**request, **call}).frames)
        ms = spans.ms()
        launches = read_launches()
        _check_steps(f"wan {label}", steps.per_step, wan_i2v_step_launches(pipe, steps.timesteps), steps.after,
                     _launches())
        if not (frames.shape == (1, WAN_FRAMES, WAN_HEIGHT, WAN_WIDTH, 3) and np.isfinite(frames).all()):
            raise AssertionError(f"wan {label}: bad frames {frames.shape}")
        calls = {name: ms[name] for name in experts}
        if label == "two_experts_cut" and not all(calls.values()):
            raise AssertionError(f"wan {label}: an expert was not called: { {k: len(v) for k, v in calls.items()} }")
        # a step's device time: its two transformer calls (the experts' calls come in step order) and its UniPC step
        in_order = [c for v in calls.values() for c in v]
        step_ms = [in_order[2 * i] + in_order[2 * i + 1] + u for i, u in enumerate(ms["scheduler_step"])]
        row = {"build_seconds": build_s, "resident_gb": resident_gb, "parameters": n_params,
               "k1_per_call": per_call["flash_attention_fwd"], "seconds_per_video": seconds, "peak_memory_gb": peak_gb,
               "launches": launches, "steps": len(steps.timesteps), "timesteps": steps.timesteps,
               "transformer_ms_per_call": calls, "transformer_calls": sum(len(v) for v in calls.values()),
               "step_ms": step_ms, "denoise_seconds": sum(step_ms) / 1e3,
               "clip_encode_seconds": sum(ms.get("image_encoder", [])) / 1e3,
               "umt5_encode_seconds": sum(ms["text_encoder"]) / 1e3,
               "vae_encode_seconds": sum(ms["vae_encode"]) / 1e3, "vae_decode_seconds": sum(ms["vae_decode"]) / 1e3,
               "frames_mean": float(frames.mean()), "frames_std": float(frames.std())}
        if label == "i2v_14b":
            row.update(vae_encode_alone_seconds=encode_s, vae_encode_alone_peak_gb=encode_peak_gb)
            row["seconds_per_step"] = row["denoise_seconds"] / len(steps.timesteps)
            if launches["flash_attention_fwd"] != 2 * WAN_I2V_STEPS * 120:
                raise AssertionError(f"the 14B I2V request launched {launches}, expected K1 {2 * WAN_I2V_STEPS * 120}")
        results[label] = row
        log(f"[wan-i2v] {smi}: {label}: built in {build_s:.1f} s ({ {k: f'{v / 1e9:.3f} B' for k, v in n_params.items()} }"
            f" parameters, {resident_gb:.1f} GB resident); {seconds:.2f} s a video ({WAN_FRAMES} x {WAN_HEIGHT} x "
            f"{WAN_WIDTH}, {row['steps']} steps), transformer calls (ms, CUDA events) "
            f"{ {k: [round(x, 1) for x in v] for k, v in calls.items()} }, denoise {row['denoise_seconds']:.2f} s, CLIP "
            f"encode {row['clip_encode_seconds']:.3f} s, UMT5 {row['umt5_encode_seconds']:.3f} s, VAE encode "
            f"{row['vae_encode_seconds']:.2f} s (81 frames, chunked), decode {row['vae_decode_seconds']:.2f} s, peak "
            f"memory {peak_gb:.1f} GB; launches {launches}"
            + (f"; the encode alone: {encode_s:.2f} s, {encode_peak_gb:.2f} GB above the resident weights"
               if label == "i2v_14b" else ""))
        paths[f"wan_{label}"] = launches
        del pipe, experts, spans, steps  # the next case's build needs the 14B's memory back
    RESULTS["wan_i2v"] = {"card": smi, "frames": WAN_FRAMES, "height": WAN_HEIGHT, "width": WAN_WIDTH,
                          "guidance_scale": WAN_GUIDANCE, "text_tokens": WAN_TEXT_LEN, **results}
    return paths


# ------------------------------------------------------------------ phases 10f, 20-22: the rest of the Wan family


def _wan_family_pipeline(kind, base, transformer_cfg, seed, clip_cfg=None):
    """A `WanVACEPipeline` ("vace"), `WanAnimatePipeline` ("animate") or
    `SkyReelsV2Pipeline` ("skyreels") on `base`'s (a WanPipeline's)
    tokenizer, UMT5 and VAE, on its device and in its dtype, with a random
    transformer (and, for Animate, a CLIP vision tower of `clip_cfg`) from
    `seed`."""
    from diffusers_tpu_torch import (
        CLIPVisionModel,
        SkyReelsV2Pipeline,
        SkyReelsV2Transformer3DModel,
        UniPCMultistepScheduler,
        WanAnimatePipeline,
        WanAnimateTransformer3DModel,
        WanVACEPipeline,
        WanVACETransformer3DModel,
    )

    device, dtype = base.device, base.vae.dtype
    pipe_cls, model_cls, unipc = {"vace": (WanVACEPipeline, WanVACETransformer3DModel, WAN_UNIPC),
                                  "animate": (WanAnimatePipeline, WanAnimateTransformer3DModel, WAN_UNIPC),
                                  "skyreels": (SkyReelsV2Pipeline, SkyReelsV2Transformer3DModel, SKYREELS_UNIPC)}[kind]
    parts = dict(tokenizer=base.tokenizer, text_encoder=base.text_encoder, vae=base.vae,
                 scheduler=UniPCMultistepScheduler(**unipc),
                 transformer=_wan_random_model(model_cls, transformer_cfg, device, dtype, seed))
    if kind == "animate":
        parts["image_encoder"] = _wan_random_model(CLIPVisionModel, clip_cfg, device, dtype, seed + 1)
    return pipe_cls(**parts, device=device)


def _box_mask(frames: int, height: int, width: int):
    """float32 [1, 1, frames, H, W]: ones on the middle half of each side (the region to edit or replace)."""
    import numpy as np

    mask = np.zeros((1, 1, frames, height, width), np.float32)
    mask[..., height // 4:3 * height // 4, width // 4:3 * width // 4] = 1
    return mask


def _moving_frames(frames: int, height: int, width: int, step: int):
    """`frames` float32 HWC frames in [0, 1]: one synthetic frame, rolled
    `step` pixels further along its rows each frame (cheap on the host at
    720p)."""
    import numpy as np

    base = synthetic_video(1, height, width)[0]
    return [np.roll(base, step * t, axis=1) for t in range(frames)]


def small_wan_family_cases():
    """Phase 10f's requests: (label, a function that builds the pipeline on
    the CPU in float32, call keyword arguments, transformer calls a step:
    VACE's CFG is one batch-2 call, the others' two batch-1 calls). Each
    call of a build function draws the same weights from SEED."""
    import numpy as np
    import torch
    from PIL import Image

    def base():
        return _build_wan_pipeline(SMALL_WAN, SMALL_WAN_VAE, SMALL_UMT5, "cpu", torch.float32)

    video = synthetic_video(9, 64, 64)
    control = np.ascontiguousarray(video.transpose(3, 0, 1, 2)[None] * 2 - 1)  # [1, 3, 9, 64, 64] in [-1, 1]
    latents = torch.from_numpy(np.random.RandomState(SEED).randn(1, 16, 3, 8, 8).astype(np.float32))
    common = dict(prompt=WAN_PROMPT, negative_prompt=WAN_NEGATIVE, height=64, width=64, output_type="np")
    vace = dict(common, num_frames=9, num_inference_steps=SAMPLE_ROUND_TRIP_STEPS, guidance_scale=WAN_GUIDANCE,
                max_sequence_length=64, latents=latents)
    masked = dict(vace, video=control, mask=_box_mask(9, 64, 64))
    anim = dict(common, image=Image.fromarray(np.round(255 * video[0]).astype(np.uint8)), pose_video=control,
                face_video=np.ascontiguousarray(control[..., ::2, ::2]), segment_frame_length=5,
                num_inference_steps=2, guidance_scale=WAN_GUIDANCE, max_sequence_length=WAN_TEXT_LEN,
                latents=latents)
    box = np.repeat(_box_mask(1, 64, 64)[0, 0, 0][..., None], 3, axis=2)
    replace = dict(anim, mode="replace", background_video=list(video[::-1]), mask_video=[box] * 9)
    sky = dict(common, num_frames=9, num_inference_steps=SAMPLE_ROUND_TRIP_STEPS, guidance_scale=SKYREELS_GUIDANCE,
               max_sequence_length=64, latents=latents)
    vace_build = lambda: _wan_family_pipeline("vace", base(), SMALL_WAN_VACE, SEED + 1)  # noqa: E731
    anim_build = lambda: _wan_family_pipeline("animate", base(), SMALL_ANIMATE, SEED + 2,  # noqa: E731
                                              SMALL_CLIP_VISION)
    return (
        ("vace_t2v", vace_build, vace, 1),
        ("vace_masked_video", vace_build, dict(masked, conditioning_scale=0.8), 1),
        ("vace_scale_list", vace_build, dict(masked, conditioning_scale=[1.2, 0.5]), 1),
        ("animate_two_segments", anim_build, anim, 2),
        ("replace_two_segments", anim_build, replace, 2),
        ("skyreels", lambda: _wan_family_pipeline("skyreels", base(), SMALL_WAN, SEED + 3), sky, 2),
    )


def check_small_wan_family(device: str = "cuda"):
    """Phase 10f: small VACE (dense text-to-video, a masked video, a
    per-layer scale list), Animate (animate and replace, two 5-frame
    segments over a 9-frame pose video) and SkyReels-V2 pipelines on phase
    10d's widths, on the card (bf16, kernels) against the CPU (f32, plain
    versions; held to JAX by tests/test_torch_wan_vace.py,
    test_torch_wan_animate.py and test_torch_skyreels.py) at phase 7's
    tolerance on the [0, 1] video, each step's K1 launches held to the
    module counts; then two SkyReels-V2 transformer calls, 2 frames a block
    with fps (the bool keep-mask through K1) and diffusion forcing ([1, 4]
    timesteps), card against CPU relative to the output's magnitude. Also
    the card's QR (cuSOLVER) of the Animate motion basis against the CPU's
    (LAPACK), which the port uses."""
    import numpy as np
    import torch

    from diffusers_tpu_torch import SkyReelsV2Transformer3DModel

    tol = 0.05  # phase 7: bf16 on the card against f32 on the CPU, on the [0, 1] video
    results = {}
    for label, build, call, calls_per_step in small_wan_family_cases():
        sides = [build(), build().to(device=torch.device(device), dtype=torch.bfloat16)]
        videos = []
        for pipe in sides:  # the CPU, then the card
            reset_launches()
            with StepLaunches(pipe, pipe.transformer) as steps:
                videos.append(pipe(generator=torch.Generator().manual_seed(SEED), **call).frames)
        ref, out = videos
        err = float(np.abs(out - ref).max())
        per_call = _module_launches(pipe.transformer)  # K1 twice a block (3 times with CLIP), once an adapter
        expected = [{k: calls_per_step * v for k, v in per_call.items()}] * len(steps.timesteps)
        results[label] = row = {"max_abs_err": err, "tol": tol, "launches": read_launches(),
                                "steps": len(steps.timesteps), "transformer_calls": len(steps.batches),
                                "transformer_batches": sorted(set(steps.batches))}
        log(f"[ref-wan-family] small {label}, card bf16 vs CPU f32: max |diff| {err:.3e} (tol {tol}); launches "
            f"{row['launches']}; {row['transformer_calls']} transformer calls over {row['steps']} steps")
        if not (out.shape == ref.shape and out.shape[2:] == (64, 64, 3) and np.isfinite(out).all() and err <= tol):
            raise AssertionError(f"small {label}: the card disagrees with the CPU ({out.shape}, {err})")
        _check_steps(f"small {label}", steps.per_step, expected, steps.after, _launches())
    if not (results["animate_two_segments"]["steps"] == 4 and results["vace_t2v"]["transformer_batches"] == [2]):
        raise AssertionError(f"small Wan family: segments or CFG batches wrong: {results}")

    rng = np.random.RandomState(SEED)
    x = torch.from_numpy(rng.randn(1, 16, 4, 8, 8).astype(np.float32))
    ehs = torch.from_numpy(rng.randn(1, 64, 64).astype(np.float32))
    for label, cfg, t, kw in (("skyreels_causal_fps", SMALL_SKYREELS_CAUSAL, torch.tensor([500.0]), {"fps": [1]}),
                              ("skyreels_diffusion_forcing", SMALL_WAN, torch.tensor([[100.0, 300.0, 500.0, 700.0]]),
                               {"enable_diffusion_forcing": True})):
        cpu = _wan_random_model(SkyReelsV2Transformer3DModel, cfg, "cpu", torch.float32, SEED + 4)
        card = _wan_random_model(SkyReelsV2Transformer3DModel, cfg, "cpu", torch.float32, SEED + 4).to(
            device=device, dtype=torch.bfloat16)
        with torch.no_grad():
            ref = cpu(x, t, ehs, **kw).sample
            reset_launches()
            out = card(x.to(device, torch.bfloat16), t.to(device), ehs.to(device, torch.bfloat16), **kw).sample
        out = out.float().cpu()
        launches = read_launches()
        err = float((out - ref).abs().max()) / max(1.0, float(ref.abs().max()))
        results[label] = {"max_rel_err": err, "tol": tol, "launches": launches}
        log(f"[ref-wan-family] small {label} transformer call, card bf16 vs CPU f32: max |diff| / max(1, |ref|) "
            f"{err:.3e} (tol {tol}); launches {launches}")
        if not (torch.isfinite(out).all() and err <= tol and launches == _module_launches(card)):
            raise AssertionError(f"small {label}: the card disagrees with the CPU ({err}, {launches})")

    basis = torch.randn(512, 20, generator=torch.Generator().manual_seed(SEED)) + 1e-8
    q_cpu = torch.linalg.qr(basis)[0]
    q_card = torch.linalg.qr(basis.to(device))[0].cpu()
    same_signs = bool((torch.sign((q_cpu * q_card).sum(0)) > 0).all())
    results["qr_512x20"] = {"max_abs_diff_card_vs_cpu": float((q_cpu - q_card).abs().max()),
                            "same_column_signs": same_signs}
    log(f"[ref-wan-family] Animate's motion basis QR (512 x 20, f32): cuSOLVER vs LAPACK max |diff| "
        f"{results['qr_512x20']['max_abs_diff_card_vs_cpu']:.3e}, same column signs {same_signs} (the port runs "
        f"it on the host)")
    RESULTS["small_wan_family"] = results


def run_wan_vace(smi: str, base):
    """Phase 20: Wan2.1-VACE-1.3B at its published widths and depth
    (WAN_VACE_1_3B: 30 blocks, 15 VACE blocks at layers 0, 2, ..., 28; made
    on the card, bf16) on phase 17's UMT5-XXL and VAE: one 480 x 832,
    81-frame request with a synthetic control video and a box mask, CFG 5.0
    as one batch-2 call a step, WAN_VACE_STEPS steps, 512 text tokens,
    through `WanVACEPipeline.__call__`. K1 exactly 90 a call. Recorded: the
    two chunked control encodes, each transformer call and the decode on
    CUDA events, seconds a video, peak memory."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = _wan_family_pipeline("vace", base, WAN_VACE_1_3B, SEED + 4)
    torch.cuda.synchronize()
    build_s, resident_gb = time.perf_counter() - t0, torch.cuda.memory_allocated() / 1e9
    tr = pipe.transformer
    per_call = _module_launches(tr)
    n_params = sum(p.numel() for p in tr.parameters())
    if per_call["flash_attention_fwd"] != WAN_VACE_K1_PER_CALL:
        raise AssertionError(f"the VACE transformer counts {per_call} launches a call, expected K1 90")
    video = synthetic_video(WAN_FRAMES, WAN_HEIGHT, WAN_WIDTH)
    control = np.ascontiguousarray(video.transpose(3, 0, 1, 2)[None] * 2 - 1)
    reset_launches()
    spans = CudaSpans({"transformer": tr, "text_encoder": pipe.text_encoder},
                      {"vae_encode": (pipe.vae, "encode"), "vae_decode": (pipe.vae, "decode")})
    with StepLaunches(pipe, tr) as steps, spans:
        frames, seconds, peak_gb = _request_seconds(lambda: pipe(
            WAN_PROMPT, WAN_NEGATIVE, video=control, mask=_box_mask(WAN_FRAMES, WAN_HEIGHT, WAN_WIDTH),
            conditioning_scale=1.0, height=WAN_HEIGHT, width=WAN_WIDTH, num_frames=WAN_FRAMES,
            num_inference_steps=WAN_VACE_STEPS, guidance_scale=WAN_GUIDANCE, max_sequence_length=WAN_TEXT_LEN,
            generator=torch.Generator(device="cuda").manual_seed(SEED)).frames)
    ms = spans.ms()
    launches = read_launches()
    _check_steps("wan vace", steps.per_step, [per_call] * WAN_VACE_STEPS, steps.after, _launches())
    if not (frames.shape == (1, WAN_FRAMES, WAN_HEIGHT, WAN_WIDTH, 3) and np.isfinite(frames).all()
            and steps.batches == [2] * WAN_VACE_STEPS and len(ms["vae_encode"]) == 2
            and launches["flash_attention_fwd"] == WAN_VACE_K1_PER_CALL * WAN_VACE_STEPS):
        raise AssertionError(f"wan vace: frames {frames.shape}, batches {steps.batches}, launches {launches}")
    row = {"card": smi, "build_seconds": build_s, "resident_gb": resident_gb, "parameters": n_params,
           "k1_per_call": per_call["flash_attention_fwd"], "steps": WAN_VACE_STEPS, "seconds_per_video": seconds,
           "peak_memory_gb": peak_gb, "launches": launches, "transformer_ms_per_call": ms["transformer"],
           "transformer_ms_mean": float(np.mean(ms["transformer"])),
           "control_encode_seconds": [x / 1e3 for x in ms["vae_encode"]],
           "umt5_encode_seconds": sum(ms["text_encoder"]) / 1e3, "vae_decode_seconds": sum(ms["vae_decode"]) / 1e3,
           "frames_mean": float(frames.mean()), "frames_std": float(frames.std())}
    log(f"[wan-vace] {smi}: Wan2.1-VACE-1.3B ({n_params / 1e9:.3f} B, built in {build_s:.1f} s, {resident_gb:.1f} GB "
        f"resident): {seconds:.2f} s a video ({WAN_FRAMES} x {WAN_HEIGHT} x {WAN_WIDTH}, {WAN_VACE_STEPS} steps), "
        f"transformer calls at batch 2 of {row['transformer_ms_mean']:.1f} ms (CUDA events; "
        f"{[round(x, 1) for x in ms['transformer']]}), control encodes "
        f"{[round(x, 2) for x in row['control_encode_seconds']]} s, UMT5 {row['umt5_encode_seconds']:.3f} s, decode "
        f"{row['vae_decode_seconds']:.2f} s, peak memory {peak_gb:.1f} GB; launches {launches}")
    RESULTS["wan_vace"] = row
    return {"wan_vace": launches}


def run_wan_animate(smi: str, base):
    """Phase 21: Wan2.2-Animate-14B at its published widths cut to
    WAN_ANIMATE_LAYERS blocks (one face adapter; the motion encoder at 512
    px, the face encoder; made on the card, bf16) with a CLIP ViT-H/14 on
    phase 17's UMT5-XXL and VAE, through `WanAnimatePipeline.__call__` at
    720 x 1280: WAN_ANIMATE_SEGMENTS 77-frame segments of a pose and face
    video in animate mode, then one replace segment with a background video
    and a box mask; WAN_ANIMATE_STEPS steps a segment, CFG 5.0, 512 text
    tokens. K1 held to 3 a block and 1 an adapter a call. Recorded: each transformer call, the motion
    and face encoders, the VAE encodes (pose, conditioning, reference), the
    decodes, CLIP and UMT5 on CUDA events; seconds a request; peak
    memory."""
    import gc

    import numpy as np
    import torch
    from PIL import Image

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = _wan_family_pipeline("animate", base, WAN_ANIMATE_14B, SEED + 5, CLIP_VIT_H)
    torch.cuda.synchronize()
    build_s, resident_gb = time.perf_counter() - t0, torch.cuda.memory_allocated() / 1e9
    tr = pipe.transformer
    per_call = _module_launches(tr)
    n_params = {"transformer": sum(p.numel() for p in tr.parameters()),
                "motion_encoder": sum(p.numel() for p in tr.motion_encoder.parameters()),
                "face_encoder": sum(p.numel() for p in tr.face_encoder.parameters()),
                "image_encoder": sum(p.numel() for p in pipe.image_encoder.parameters())}
    if per_call["flash_attention_fwd"] != WAN_ANIMATE_K1_PER_CALL:
        raise AssertionError(f"the Animate transformer counts {per_call} launches a call, expected "
                             f"K1 {WAN_ANIMATE_K1_PER_CALL}")
    h, w, seg = WAN_ANIMATE_HEIGHT, WAN_ANIMATE_WIDTH, WAN_ANIMATE_SEGMENT
    n_frames = WAN_ANIMATE_SEGMENTS * (seg - 1) + 1  # segments sharing one conditioning frame
    pose = _moving_frames(n_frames, h, w, 8)
    face = _moving_frames(n_frames, 512, 512, 4)
    image = Image.fromarray(np.round(255 * pose[0]).astype(np.uint8))
    box = np.repeat(_box_mask(1, h, w)[0, 0, 0][..., None], 3, axis=2)
    request = dict(image=image, prompt=WAN_PROMPT, negative_prompt=WAN_NEGATIVE, height=h, width=w,
                   segment_frame_length=seg, num_inference_steps=WAN_ANIMATE_STEPS, guidance_scale=WAN_GUIDANCE,
                   max_sequence_length=WAN_TEXT_LEN)
    cases = (("animate", WAN_ANIMATE_SEGMENTS, dict(pose_video=pose, face_video=face, mode="animate")),
             ("replace", 1, dict(pose_video=pose[:seg], face_video=face[:seg], mode="replace",
                                 background_video=pose[::-1][:seg], mask_video=[box] * seg)))
    results, paths = {}, {}
    for label, segments, call in cases:
        reset_launches()
        spans = CudaSpans({"transformer": tr, "motion_encoder": tr.motion_encoder, "face_encoder": tr.face_encoder,
                           "image_encoder": pipe.image_encoder, "text_encoder": pipe.text_encoder},
                          {"vae_encode": (pipe.vae, "encode"), "vae_decode": (pipe.vae, "decode")})
        with StepLaunches(pipe, tr) as steps, spans:
            frames, seconds, peak_gb = _request_seconds(lambda: pipe(
                generator=torch.Generator(device="cuda").manual_seed(SEED), **request, **call).frames)
        ms = spans.ms()
        launches = read_launches()
        n_steps = segments * WAN_ANIMATE_STEPS
        step_k1 = _launches(flash_attention_fwd=2 * WAN_ANIMATE_K1_PER_CALL)
        _check_steps(f"wan animate {label}", steps.per_step, [step_k1] * n_steps, steps.after, _launches())
        want = len(call["pose_video"])
        if not (frames.shape == (1, want, h, w, 3) and np.isfinite(frames).all()
                and len(ms["transformer"]) == 2 * n_steps and len(ms["motion_encoder"]) == 2 * segments):
            raise AssertionError(f"wan animate {label}: frames {frames.shape}, {len(ms['transformer'])} calls, "
                                 f"{len(ms['motion_encoder'])} motion encodes")
        row = {"segments": segments, "frames": want, "steps_per_segment": WAN_ANIMATE_STEPS,
               "seconds_per_video": seconds, "peak_memory_gb": peak_gb, "launches": launches,
               "transformer_ms_per_call": ms["transformer"], "transformer_ms_mean": float(np.mean(ms["transformer"])),
               "motion_encoder_ms": ms["motion_encoder"], "face_encoder_ms": ms["face_encoder"],
               "vae_encode_ms": ms["vae_encode"], "vae_decode_ms": ms["vae_decode"],
               "clip_encode_ms": ms["image_encoder"], "umt5_encode_ms": ms["text_encoder"],
               "frames_mean": float(frames.mean()), "frames_std": float(frames.std())}
        results[label] = row
        log(f"[wan-animate] {smi}: {label}: {seconds:.2f} s for {want} frames of {h} x {w} ({segments} segments x "
            f"{WAN_ANIMATE_STEPS} steps), transformer calls (75,600 tokens) of {row['transformer_ms_mean']:.1f} ms "
            f"(CUDA events; {[round(x, 1) for x in ms['transformer']]}), motion encoder "
            f"{[round(x, 1) for x in ms['motion_encoder']]} ms (77 faces at 512 px), face encoder "
            f"{[round(x, 2) for x in ms['face_encoder']]} ms, VAE encodes {[round(x) for x in ms['vae_encode']]} ms, "
            f"decodes {[round(x) for x in ms['vae_decode']]} ms, CLIP {[round(x, 1) for x in ms['image_encoder']]} "
            f"ms, peak memory {peak_gb:.1f} GB; launches {launches}")
        paths[f"wan_animate_{label}"] = launches
        del frames, spans, steps
        gc.collect()
    RESULTS["wan_animate"] = {"card": smi, "height": h, "width": w, "segment_frames": seg, "build_seconds": build_s,
                              "resident_gb": resident_gb, "parameters": n_params,
                              "k1_per_call": per_call["flash_attention_fwd"], **results}
    return paths


def run_skyreels(smi: str, base):
    """Phase 22: SkyReels-V2-T2V-14B-540P at its published widths cut to
    WAN_CUT_LAYERS blocks (made on the card, bf16) on phase 17's UMT5-XXL
    and VAE, through `SkyReelsV2Pipeline.__call__`: one 544 x 960, 97-frame
    request (51,000 tokens), SKYREELS_STEPS steps, CFG 6.0 as two batch-1
    calls a step, 512 text tokens. Recorded: each transformer call, UMT5 and
    the 97-frame decode apart on CUDA events; seconds; peak memory."""
    import numpy as np
    import torch

    pipe = _wan_family_pipeline("skyreels", base, SKYREELS_14B, SEED + 7)
    tr = pipe.transformer
    per_call = _module_launches(tr)
    reset_launches()
    spans = CudaSpans({"transformer": tr, "text_encoder": pipe.text_encoder}, {"vae_decode": (pipe.vae, "decode")})
    with StepLaunches(pipe, tr) as steps, spans:
        frames, seconds, peak_gb = _request_seconds(lambda: pipe(
            WAN_PROMPT, WAN_NEGATIVE, height=SKYREELS_HEIGHT, width=SKYREELS_WIDTH, num_frames=SKYREELS_FRAMES,
            num_inference_steps=SKYREELS_STEPS, guidance_scale=SKYREELS_GUIDANCE, max_sequence_length=WAN_TEXT_LEN,
            generator=torch.Generator(device="cuda").manual_seed(SEED)).frames)
    ms = spans.ms()
    launches = read_launches()
    _check_steps("skyreels", steps.per_step, [{k: 2 * v for k, v in per_call.items()}] * SKYREELS_STEPS, steps.after,
                 _launches())
    if not (frames.shape == (1, SKYREELS_FRAMES, SKYREELS_HEIGHT, SKYREELS_WIDTH, 3) and np.isfinite(frames).all()
            and per_call["flash_attention_fwd"] == 2 * WAN_CUT_LAYERS):
        raise AssertionError(f"skyreels: frames {frames.shape}, K1 {per_call} a call")
    row = {"card": smi, "layers": WAN_CUT_LAYERS, "steps": SKYREELS_STEPS, "seconds_per_video": seconds,
           "peak_memory_gb": peak_gb, "launches": launches, "k1_per_call": per_call["flash_attention_fwd"],
           "transformer_ms_per_call": ms["transformer"], "transformer_ms_mean": float(np.mean(ms["transformer"])),
           "umt5_encode_seconds": sum(ms["text_encoder"]) / 1e3, "vae_decode_seconds": sum(ms["vae_decode"]) / 1e3,
           "frames_mean": float(frames.mean()), "frames_std": float(frames.std())}
    log(f"[skyreels] {smi}: SkyReels-V2 14B widths, {WAN_CUT_LAYERS} blocks: {seconds:.2f} s a video "
        f"({SKYREELS_FRAMES} x {SKYREELS_HEIGHT} x {SKYREELS_WIDTH}, {SKYREELS_STEPS} steps), transformer calls "
        f"(51,000 tokens) of {row['transformer_ms_mean']:.1f} ms (CUDA events), UMT5 {row['umt5_encode_seconds']:.3f} "
        f"s, the 97-frame decode {row['vae_decode_seconds']:.2f} s, peak memory {peak_gb:.1f} GB; launches {launches}")
    RESULTS["skyreels"] = row
    return {"skyreels": launches}


# ------------------------------------------------------------------ phases 10g, 12c, 13b, 23: the rest of the SD slice


def ip_adapter_checkpoint(kind: str, unet, image_dim: int, seed: int, device="cpu", dtype=None, hidden_dims=64,
                          depth=2, heads=1, num_queries=4):
    """An IP-Adapter checkpoint for `unet` in h94/IP-Adapter's key layout,
    random from `seed` on `device`: ``{"image_proj": {...}, "ip_adapter":
    {"{2n+1}.to_{k,v}_ip.weight": ...}}``, one K/V pair a cross attention in
    the reference's down -> up -> mid order. `kind`: "base" (ImageProjection,
    4 tokens over a `image_dim`-wide projected embedding), "plus" (the
    resampler over `image_dim`-wide patch states), "full" (FeedForward +
    LayerNorm over the patch states) or "faceid" (over a `image_dim`-wide id
    embedding, mult 2, 4 tokens)."""
    import torch

    from diffusers_tpu_torch.loaders.ip_adapter import cross_attentions

    gen = torch.Generator(device=device).manual_seed(seed)
    c = unet.config.cross_attention_dim

    def w(*shape, std=0.02):
        return (torch.randn(shape, generator=gen, device=device) * std).to(dtype or torch.float32)

    def norm(prefix, n):
        return {f"{prefix}.weight": 1 + w(n), f"{prefix}.bias": w(n)}

    if kind == "base":
        proj = {"proj.weight": w(4 * c, image_dim), "proj.bias": w(4 * c), **norm("norm", c)}
    elif kind == "full":
        proj = {"proj.0.weight": w(image_dim, image_dim), "proj.0.bias": w(image_dim), "proj.2.weight": w(c, image_dim),
                "proj.2.bias": w(c), **norm("proj.3", c)}
    elif kind == "faceid":
        proj = {"proj.0.weight": w(2 * image_dim, image_dim), "proj.0.bias": w(2 * image_dim),
                "proj.2.weight": w(4 * c, 2 * image_dim), "proj.2.bias": w(4 * c), **norm("norm", c)}
    else:
        h = hidden_dims
        proj = {"latents": w(1, num_queries, h, std=h**-0.5), "proj_in.weight": w(h, image_dim), "proj_in.bias": w(h),
                "proj_out.weight": w(c, h), "proj_out.bias": w(c), **norm("norm_out", c)}
        for n in range(depth):
            proj.update({**norm(f"layers.{n}.0.norm1", h), **norm(f"layers.{n}.0.norm2", h),
                         f"layers.{n}.0.to_q.weight": w(h, h), f"layers.{n}.0.to_kv.weight": w(2 * h, h),
                         f"layers.{n}.0.to_out.weight": w(h, h), **norm(f"layers.{n}.1.0", h),
                         f"layers.{n}.1.1.weight": w(4 * h, h), f"layers.{n}.1.3.weight": w(h, 4 * h)})
        assert h == 64 * heads
    ip = {}
    for n, attn in enumerate(cross_attentions(unet)):
        ip[f"{2 * n + 1}.to_k_ip.weight"] = w(attn.inner_dim, c, std=0.05)
        ip[f"{2 * n + 1}.to_v_ip.weight"] = w(attn.inner_dim, c, std=0.05)
    return {"image_proj": proj, "ip_adapter": ip}


def _build_sd(unet_cfg, vae_cfg, clip_cfg, device, dtype, vision_cfg=None):
    """A StableDiffusionPipeline (PNDM) with random weights from SEED on
    `device`, and a CLIP vision tower with its projection when `vision_cfg`
    is given."""
    import torch

    from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
    from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel, CLIPVisionModelWithProjection
    from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
    from diffusers_tpu_torch.pipelines.stable_diffusion import StableDiffusionPipeline
    from diffusers_tpu_torch.schedulers import PNDMScheduler

    torch.manual_seed(SEED)
    with torch.device(device):
        unet, vae, te = UNet2DConditionModel(**unet_cfg), AutoencoderKL(**vae_cfg), CLIPTextModel(**clip_cfg)
        vision = CLIPVisionModelWithProjection(**vision_cfg) if vision_cfg else None
    kwargs = {} if device == "cuda" else {"device": device}
    pipe = StableDiffusionPipeline(vae=vae, text_encoder=te, tokenizer=StandInTokenizer(), unet=unet,
                                   scheduler=PNDMScheduler(**SD15_PNDM), image_encoder=vision, **kwargs)
    return pipe.to(dtype=dtype)


def small_sd_cases():
    """Phase 10g's cases: (label, pipeline name, request kwargs, IP-Adapters
    to load as (kind, image width) or None, their scales)."""
    image, mask, edges = synthetic_inputs(32)
    prompt_image = (synthetic_inputs(224)[0] * 255).round().astype("uint8")
    vision_w, vision_proj = SMALL_VISION_PROJ["hidden_size"], SMALL_VISION_PROJ["projection_dim"]
    return (
        ("sd_pndm", "sd", dict(), None, None),
        ("sd_ddim", "sd_ddim", dict(), None, None),
        ("sd_img2img", "img2img", dict(image=image, strength=0.6), None, None),
        ("sd_inpaint_9ch", "inpaint_9ch", dict(image=image, mask_image=mask), None, None),
        ("sd_inpaint_4ch", "inpaint_4ch", dict(image=image, mask_image=mask, strength=0.8), None, None),
        ("sd_t2i_adapter", "adapter", dict(image=edges[..., :1], adapter_conditioning_scale=0.8), None, None),
        ("sd_ip_base", "sd", dict(ip_adapter_image=prompt_image), [("base", vision_proj)], None),
        ("sd_ip_plus", "sd", dict(ip_adapter_image=prompt_image), [("plus", vision_w)], None),
        ("sd_ip_full", "sd", dict(ip_adapter_image=prompt_image), [("full", vision_w)], None),
        ("sd_ip_faceid", "sd", dict(ip_adapter_image_embeds="faceid"), [("faceid", 40)], None),
        ("sd_ip_two_adapters", "sd", dict(ip_adapter_image=[prompt_image, prompt_image]),
         [("base", vision_proj), ("plus", vision_w)], [0.7, 0.5]),
        ("sd_ip_scale_0", "sd", dict(ip_adapter_image=prompt_image), [("plus", vision_w)], 0.0),
        ("sdxl_ip_base", "sdxl", dict(ip_adapter_image=prompt_image), [("base", vision_proj)], None),
        ("sdxl_ip_plus", "sdxl", dict(ip_adapter_image=prompt_image), [("plus", vision_w)], None),
    )


def check_small_sd(device: str = "cuda"):
    """Phase 10g: the SD slice on small components, on the card (bf16,
    kernels) against the CPU (f32, plain versions; held to JAX by
    tests/test_torch_stable_diffusion.py, test_torch_ip_adapter.py and
    test_torch_t2i_adapter.py), with phase 7's tolerance: SD text-to-image
    with PNDM and DDIM, img2img, inpaint with the 9- and the 4-channel UNet,
    the T2I-Adapter pipeline, and SD and SDXL with each IP-Adapter head (base,
    Plus, Full, FaceID), two adapters at once and scale 0. Each 4 steps; both
    sides draw from one CPU generator seeded alike. Scale 0 must give the
    image without the adapter bit for bit on each side."""
    import numpy as np
    import torch

    from diffusers_tpu_torch.models.adapter import T2IAdapter
    from diffusers_tpu_torch.models.text_encoders.clip import CLIPVisionModelWithProjection
    from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
    from diffusers_tpu_torch.pipelines.stable_diffusion import (
        StableDiffusionImg2ImgPipeline,
        StableDiffusionInpaintPipeline,
        StableDiffusionPipeline,
    )
    from diffusers_tpu_torch.pipelines.t2i_adapter import StableDiffusionAdapterPipeline
    from diffusers_tpu_torch.schedulers import DDIMScheduler

    sides = []
    for dev in ("cpu", device):
        base = _build_sd(SMALL_SD_UNET, SMALL_VAE, SMALL_CLIP, "cpu", torch.float32, SMALL_VISION_PROJ)
        sdxl = _build_pipeline(SMALL_UNET, SMALL_VAE, SMALL_CLIP, SMALL_CLIP, "cpu", torch.float32)
        torch.manual_seed(SEED + 1)
        unet9 = UNet2DConditionModel(**dict(SMALL_SD_UNET, in_channels=9))
        adapter = T2IAdapter(**SMALL_T2I_ADAPTER)
        vision = CLIPVisionModelWithProjection(**SMALL_VISION_PROJ)
        parts = dict(base.components, device="cpu")
        pipes = {"sd": base, "sd_ddim": StableDiffusionPipeline(**dict(parts, scheduler=DDIMScheduler(**SD15_DDIM))),
                 "img2img": StableDiffusionImg2ImgPipeline(**parts),
                 "inpaint_9ch": StableDiffusionInpaintPipeline(**dict(parts, unet=unet9)),
                 "inpaint_4ch": StableDiffusionInpaintPipeline(**parts),
                 "adapter": StableDiffusionAdapterPipeline(base.vae, base.text_encoder, base.tokenizer, base.unet,
                                                           adapter, base.scheduler, device="cpu"),
                 "sdxl": type(sdxl)(**dict(sdxl.components, image_encoder=vision, device="cpu"))}
        for pipe in pipes.values():
            pipe.to(device=torch.device(dev), dtype=torch.float32 if not sides else torch.bfloat16)
        sides.append(pipes)
    latents = torch.from_numpy(np.random.RandomState(SEED).randn(1, 4, 16, 16).astype(np.float32))
    tol = 0.05  # phase 7: bf16 on the card against f32 on the CPU, on the [0, 1] image
    results = {}
    for label, pipe_name, kwargs, adapters, scale in small_sd_cases():
        images, launches = [], None
        for pipes in sides:  # the CPU, then the card
            pipe = pipes[pipe_name]
            call = dict(kwargs)
            if adapters:
                pipe.load_ip_adapter([ip_adapter_checkpoint(kind, pipe.unet, width, SEED + i)
                                      for i, (kind, width) in enumerate(adapters)])
                if scale is not None:
                    pipe.set_ip_adapter_scale(scale)
                if call.get("ip_adapter_image_embeds") == "faceid":
                    ids = torch.from_numpy(np.random.RandomState(SEED).randn(1, 1, 40).astype(np.float32))
                    call["ip_adapter_image_embeds"] = [torch.cat([torch.zeros_like(ids), ids])]
            if pipe_name not in ("img2img", "inpaint_9ch", "inpaint_4ch", "adapter"):
                call["latents"] = latents
            reset_launches()
            images.append(pipe(SD15_PROMPT, num_inference_steps=4, guidance_scale=SD15_GUIDANCE,
                               generator=torch.Generator().manual_seed(SEED), output_type="np", **call).images)
            launches = read_launches()
            if scale == 0.0:  # every adapter at scale 0 is skipped: the plain request, bit for bit
                plain_kwargs = {k: v for k, v in call.items() if not k.startswith("ip_adapter")}
                pipe.unload_ip_adapter()
                plain = pipe(SD15_PROMPT, num_inference_steps=4, guidance_scale=SD15_GUIDANCE,
                             generator=torch.Generator().manual_seed(SEED), output_type="np", **plain_kwargs).images
                if not np.array_equal(plain, images[-1]):
                    raise AssertionError(f"small {label}: scale 0 differs from the request without the adapter")
            elif adapters:
                pipe.unload_ip_adapter()
        ref, out = images
        err = float(np.abs(out - ref).max())
        results[label] = {"max_abs_err": err, "mean_abs_err": float(np.abs(out - ref).mean()), "tol": tol,
                          "launches": launches}
        log(f"[ref-sd] small {label}, card bf16 vs CPU f32: max |diff| {err:.3e} (tol {tol}); launches {launches}")
        if not (out.shape == ref.shape == (1, 32, 32, 3) and np.isfinite(out).all() and err <= tol):
            raise AssertionError(f"small {label}: the card disagrees with the CPU")
        if min(launches["flash_attention_fwd"], launches["group_norm"]) <= 0:
            raise AssertionError(f"small {label} on the card missed a kernel: {launches}")
    RESULTS["small_sd"] = results


def _held_request(smi, label, pipeline, steps, per_step, first_extra, after, **kwargs):
    """One request through `pipeline` with each step's launches held to
    `per_step` (plus `first_extra` at the first step: what runs before the
    loop) and what follows the last step to `after` (`StepLaunches`); the
    latents going into the decode must be finite. Returns (images, seconds,
    peak GB, launches)."""
    import torch

    latents_seen = []
    decoder = pipeline.vae.decoder
    hook = decoder.register_forward_pre_hook(lambda m, a: latents_seen.append(a[0]))
    reset_launches()
    try:
        with StepLaunches(pipeline, pipeline.unet) as counted:
            images, seconds, peak_gb = _request_seconds(lambda: pipeline(**kwargs).images)
    finally:
        hook.remove()
    launches = read_launches()
    if not latents_seen or not all(bool(torch.isfinite(z).all()) for z in latents_seen):
        raise AssertionError(f"{label}: non-finite latents")
    expected = [dict(per_step) for _ in range(steps)]
    for k, v in first_extra.items():
        expected[0][k] += v
    _check_steps(label, counted.per_step, expected, counted.after, after)
    log(f"[{label}] {smi}: {seconds:.3f} s/request, {steps} UNet calls, peak {peak_gb:.1f} GB; launches {launches} "
        f"(K1 {per_step['flash_attention_fwd']} and K4 {per_step['group_norm']} a step, as the modules count)")
    return images, seconds, peak_gb, launches


def _attention_costs(table, iters=10):
    """`native` attention (the path SD 1.5's and ViT-H's heads take) against
    SDPA at each (label, q shape, kv length, calls) of `table`, bf16: device
    time (CUDA graph) each, and their sums over the calls."""
    import torch
    import torch.nn.functional as F

    from diffusers_tpu_torch.ops.attention import _native_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rows, total_native, total_sdpa = [], 0.0, 0.0
    for label, (b, sq, h, d), sk, calls in table:
        q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((b, sk, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((b, sk, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        native_ms = graph_ms(lambda: _native_attention(q, k, v), iters=iters)
        sdpa_ms = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=iters)
        err = float((_native_attention(q, k, v).float() - F.scaled_dot_product_attention(qt, kt, vt).transpose(
            1, 2).float()).abs().max())
        bms, by = bound_ms(2 * (q.numel() * 2 + k.numel() + v.numel()), 4.0 * b * h * sq * sk * d, PEAK_BF16_FLOPS)
        rows.append({"case": label, "q": [b, sq, h, d], "sk": sk, "calls": calls, "native_device_ms": native_ms,
                     "sdpa_device_ms": sdpa_ms, "bound_ms": bms, "bound_by": by, "max_abs_diff_native_vs_sdpa": err})
        total_native += calls * native_ms
        total_sdpa += calls * sdpa_ms
        log(f"[native] {label}: native {native_ms:.4f} ms, SDPA {sdpa_ms:.4f} ms, bound {bms:.4f} ms ({by}), x{calls}; "
            f"|native - SDPA| {err:.2e}")
        del q, k, v, qt, kt, vt
    return rows, total_native, total_sdpa


def run_sd15(smi: str):
    """Phase 23: Stable Diffusion 1.5 at its published widths (made on the
    card, bf16) through `StableDiffusionPipeline.__call__`: one 512 px
    text-to-image request with PNDM (50 steps: 51 UNet calls, PLMS repeats
    one timestep), one with DDIM (SD15_DDIM_STEPS: 10), img2img at strength
    0.75, then inpaint with
    the 9-channel inpainting UNet at strength 1.0, then one T2I-Adapter
    request (TencentARC/t2iadapter_canny_sd15v2's widths) from a synthetic
    edge map, the adapter's forward timed apart. Each step's launches are
    held to the modules' counts: K4 61 a UNet call, K1 0 (heads of 40, 80
    and 160 run `native`; the count is printed, so a change of the rule
    shows); the UNet's GroupNorm calls are held to `GN_SD15_UNET_CALL`. The
    time of one UNet call and of its attentions (CUDA events), and each SD
    attention shape `native` against SDPA (ROADMAP B1.1). Returns the
    launches by path and the pipeline (phase 24a runs on it)."""
    import collections
    import gc

    import numpy as np
    import torch

    from diffusers_tpu_torch.models.adapter import T2IAdapter
    from diffusers_tpu_torch.models.attention import Attention
    from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
    from diffusers_tpu_torch.ops.module import GroupNorm
    from diffusers_tpu_torch.pipelines.stable_diffusion import (
        StableDiffusionImg2ImgPipeline,
        StableDiffusionInpaintPipeline,
        StableDiffusionPipeline,
    )
    from diffusers_tpu_torch.pipelines.t2i_adapter import StableDiffusionAdapterPipeline
    from diffusers_tpu_torch.schedulers import DDIMScheduler, PNDMScheduler

    t0 = time.perf_counter()
    pipe = _build_sd(SD15_UNET, SD15_VAE, CLIP_L, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    n_params = {name: sum(p.numel() for p in getattr(pipe, name).parameters())
                for name in ("unet", "text_encoder", "vae")}
    log(f"[sd15] built SD 1.5 at full width on the card in {time.perf_counter() - t0:.1f} s: "
        f"{ {k: f'{v / 1e6:.1f} M' for k, v in n_params.items()} }")
    if n_params["unet"] != SD15_UNET_PARAMETERS:
        raise AssertionError(f"the SD 1.5 UNet has {n_params['unet']} parameters, expected {SD15_UNET_PARAMETERS}")
    unet_call, encode, decode = (_module_launches(m) for m in (pipe.unet, pipe.vae.encoder, pipe.vae.decoder))
    if unet_call["flash_attention_fwd"] != 0 or unet_call["group_norm"] != 61:
        raise AssertionError(f"the SD 1.5 UNet's modules count {unet_call}, expected K1 0 and K4 61")
    image, mask, edges = synthetic_inputs(SD15_RESOLUTION)
    out, paths = {}, {}
    common = dict(prompt=SD15_PROMPT, guidance_scale=SD15_GUIDANCE, output_type="pil")

    def request(label, pipeline, steps, per_step, first_extra, **kwargs):
        images, seconds, peak_gb, launches = _held_request(
            smi, label, pipeline, steps, per_step, first_extra, decode, **common,
            generator=torch.Generator(device="cuda").manual_seed(SEED), **kwargs)
        result = np.asarray(images[0])
        if result.shape != (SD15_RESOLUTION, SD15_RESOLUTION, 3) or result.dtype != np.uint8:
            raise AssertionError(f"{label}: bad uint8 image {result.shape} {result.dtype}")
        out[label] = {"card": smi, "seconds_per_request": seconds, "peak_memory_gb": peak_gb, "unet_calls": steps,
                      "launches": launches, "image_mean": float(result.mean())}
        paths[label] = launches
        return result

    # the UNet's GroupNorm calls, and the time of one call and of its attentions, on CUDA events
    seen = collections.Counter()
    hooks = [m.register_forward_pre_hook(lambda mod, args, kw: seen.update([(tuple(args[0].shape),
                                                                             bool(kw.get("apply_silu")))]),
                                         with_kwargs=True) for m in pipe.unet.modules() if isinstance(m, GroupNorm)]
    spans = []

    def attn_start(mod, args):
        spans.append([torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)])
        spans[-1][0].record()

    dev = torch.device("cuda")
    sample = torch.randn(2, 4, 64, 64, device=dev, dtype=torch.bfloat16)
    ehs = torch.randn(2, 77, 768, device=dev, dtype=torch.bfloat16)
    t = torch.tensor(500.0, device=dev)
    with torch.no_grad():
        pipe.unet(sample, t, ehs)
    for h in hooks:
        h.remove()
    if dict(seen) != {(shape, silu): n for shape, silu, n in GN_SD15_UNET_CALL}:
        raise AssertionError(f"the SD 1.5 UNet's GroupNorm calls {dict(seen)} are not GN_SD15_UNET_CALL")
    attns = [m for m in pipe.unet.modules() if isinstance(m, Attention)]
    hooks = [m.register_forward_pre_hook(attn_start) for m in attns]
    hooks += [m.register_forward_hook(lambda mod, args, o: spans[-1][1].record()) for m in attns]
    with torch.no_grad():
        unet_ms = time_ms(lambda: pipe.unet(sample, t, ehs), iters=5)
    for h in hooks:
        h.remove()
    torch.cuda.synchronize()
    attn_ms = sum(a.elapsed_time(b) for a, b in spans) / (len(spans) / len(attns))
    costs, native_total, sdpa_total = _attention_costs(SD15_ATTENTION)
    vit_costs, vit_native, vit_sdpa = _attention_costs((VIT_H_ATTENTION,))
    log(f"[sd15] {smi}: UNet call b=2 512 px {unet_ms:.2f} ms (CUDA events), its {len(attns)} attentions "
        f"{attn_ms:.2f} ms of it ({100 * attn_ms / unet_ms:.0f}%); native attention a UNet call (device, summed over "
        f"shapes) {native_total:.2f} ms, SDPA {sdpa_total:.2f} ms; ViT-H's native attention an encode "
        f"{vit_native:.2f} ms, SDPA {vit_sdpa:.2f} ms")
    out["unet_call"] = {"card": smi, "unet_forward_b2_ms": unet_ms, "attention_ms": attn_ms,
                        "attention_share": attn_ms / unet_ms, "native_attention_device_ms": native_total,
                        "sdpa_device_ms": sdpa_total, "attention_cases": costs, "vit_h_attention": vit_costs,
                        "vit_h_native_device_ms": vit_native, "vit_h_sdpa_device_ms": vit_sdpa,
                        "parameters": n_params, "group_norm_calls": len(list(seen.elements()))}

    with CudaSpans(modules={"text_encoder": pipe.text_encoder, "unet": pipe.unet, "vae_decode": pipe.vae.decoder}) \
            as spans_t2i:
        request("sd15_pndm", pipe, SD15_STEPS + 1, unet_call, {}, num_inference_steps=SD15_STEPS)
    span_ms = spans_t2i.ms()
    out["sd15_pndm"].update({f"{k}_ms": v for k, v in span_ms.items()})
    log(f"[sd15] PNDM request: text {sum(span_ms['text_encoder']):.1f} ms, UNet {sum(span_ms['unet']):.1f} ms over "
        f"{len(span_ms['unet'])} calls (mean {np.mean(span_ms['unet']):.2f}), decode {sum(span_ms['vae_decode']):.1f} ms")
    ddim = StableDiffusionPipeline(**dict(pipe.components, scheduler=DDIMScheduler(**SD15_DDIM)))
    request("sd15_ddim", ddim, SD15_DDIM_STEPS, unet_call, {}, num_inference_steps=SD15_DDIM_STEPS)
    img2img = StableDiffusionImg2ImgPipeline(**dict(pipe.components, scheduler=PNDMScheduler(**SD15_PNDM)))
    state = img2img.scheduler.set_timesteps(SD15_STEPS)
    keep = len(state.timesteps) - (SD15_STEPS - min(int(SD15_STEPS * SD15_IMG2IMG_STRENGTH), SD15_STEPS))
    request("sd15_img2img", img2img, keep, unet_call, encode, num_inference_steps=SD15_STEPS, image=image,
            strength=SD15_IMG2IMG_STRENGTH)

    torch.manual_seed(SEED + 1)
    with torch.device("cuda"):
        unet9 = UNet2DConditionModel(**dict(SD15_UNET, in_channels=9)).to(torch.bfloat16)
    inpaint = StableDiffusionInpaintPipeline(**dict(pipe.components, unet=unet9,
                                                    scheduler=PNDMScheduler(**SD15_PNDM)))
    request("sd15_inpaint_9ch", inpaint, SD15_STEPS + 1, _module_launches(unet9),
            {k: 2 * v for k, v in encode.items()}, num_inference_steps=SD15_STEPS, image=image, mask_image=mask,
            strength=SD15_INPAINT_STRENGTH)
    del inpaint, unet9
    gc.collect()
    torch.cuda.empty_cache()

    torch.manual_seed(SEED + 2)
    with torch.device("cuda"):
        adapter = T2IAdapter(**T2I_CANNY_SD15).to(torch.bfloat16)
    n_adapter = sum(p.numel() for p in adapter.parameters())
    t2i = StableDiffusionAdapterPipeline(pipe.vae, pipe.text_encoder, pipe.tokenizer, pipe.unet, adapter,
                                         PNDMScheduler(**SD15_PNDM))
    adapter_in = _module_launches(adapter)
    request("sd15_t2i_adapter", t2i, SD15_STEPS + 1, unet_call, adapter_in, num_inference_steps=SD15_STEPS,
            image=edges[..., :1])
    control = t2i._control(edges[..., :1])
    with torch.no_grad():
        adapter_ms = time_ms(lambda: adapter(control), iters=10)
    out["sd15_t2i_adapter"].update(adapter_forward_ms=adapter_ms, adapter_parameters=n_adapter)
    log(f"[sd15] {smi}: T2I-Adapter ({n_adapter / 1e6:.1f} M parameters) forward {adapter_ms:.2f} ms once a request "
        f"(CUDA events), against {out['sd15_t2i_adapter']['seconds_per_request']:.3f} s a request")
    RESULTS["sd15"] = out
    return paths, pipe


def run_sdxl_ip_adapter(smi: str, pipe, dense_image):
    """Phase 12c: IP-Adapter on phase 11's full-width SDXL pipeline, with a
    CLIP ViT-H/14 and its projection (made on the card, bf16): the Plus
    adapter (ip-adapter-plus_sdxl_vit-h's widths) written as a safetensors
    file in h94/IP-Adapter's key layout and loaded with
    `pipe.load_ip_adapter(path)`, one 1024 px request (30 Euler steps, CFG
    5.0) from a synthetic image; then the base adapter
    (ip-adapter_sdxl_vit-h's widths), one request; then `unload_ip_adapter()`
    and phase 11's request again, bit-equal to phase 11's image. Each step's
    launches are held to the modules' counts: a UNet call with an adapter
    launches K1 140 + 70 (the image cross attentions) + 4 for Plus (the
    resampler's attentions run inside the UNet call, as in JAX); the ViT-H
    encode none (heads of 80 run `native`). The CLIP encode, the resampler
    and the UNet calls are timed apart (CUDA events). Returns the launches by
    path."""
    import gc
    import os
    import shutil

    import numpy as np
    import torch

    from diffusers_tpu_torch.models.modeling_utils import save_safetensors
    from diffusers_tpu_torch.models.text_encoders.clip import CLIPVisionModelWithProjection
    from diffusers_tpu_torch.pipelines.stable_diffusion_xl import StableDiffusionXLPipeline
    from diffusers_tpu_torch.schedulers import EulerDiscreteScheduler

    torch.manual_seed(SEED + 3)
    with torch.device("cuda"):
        vision = CLIPVisionModelWithProjection(**CLIP_VIT_H_PROJ).to(torch.bfloat16)
    ip_pipe = StableDiffusionXLPipeline(**dict(pipe.components, image_encoder=vision,
                                               scheduler=EulerDiscreteScheduler(**EULER)))
    base_call, decode = _module_launches(pipe.unet), _module_launches(pipe.vae.decoder)
    prompt_image = (synthetic_inputs(RESOLUTION)[0] * 255).round().astype(np.uint8)
    out, paths = {}, {}

    plus = ip_adapter_checkpoint("plus", pipe.unet, CLIP_VIT_H["hidden_size"], SEED + 4, "cuda", torch.bfloat16,
                                 **IP_PLUS_SDXL)
    flat = {f"{group}.{k}": v for group in plus for k, v in plus[group].items()}
    nbytes = sum(v.numel() * v.element_size() for v in flat.values())
    directory = _scratch_dir("ip_adapter", nbytes)
    try:
        path = os.path.join(directory, "ip-adapter-plus_sdxl_vit-h.safetensors")
        t0 = time.perf_counter()
        save_safetensors(flat, path)
        write_s = time.perf_counter() - t0
        del plus, flat
        _, load_s, _ = _request_seconds(lambda: ip_pipe.load_ip_adapter(path))
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    log(f"[ip] Plus adapter: {nbytes / 1e9:.2f} GB written in {write_s:.1f} s, loaded onto the card in {load_s:.1f} s")

    for label, extra in (("sdxl_ip_plus", IP_SDXL_CROSS_ATTENTIONS + IP_PLUS_RESAMPLER_ATTENTIONS),
                         ("sdxl_ip_base", IP_SDXL_CROSS_ATTENTIONS)):
        if label == "sdxl_ip_base":
            ip_pipe.load_ip_adapter(ip_adapter_checkpoint("base", pipe.unet, CLIP_VIT_H_PROJ["projection_dim"],
                                                          SEED + 5, "cuda", torch.bfloat16))
        per_step = _module_launches(pipe.unet)
        if per_step["flash_attention_fwd"] != base_call["flash_attention_fwd"] + extra:
            raise AssertionError(f"{label}: a UNet call counts {per_step}, expected K1 "
                                 f"{base_call['flash_attention_fwd']} + {extra}")
        encode = _module_launches(vision)
        modules = {"clip_encode": vision, "unet": pipe.unet}
        if label == "sdxl_ip_plus":
            modules["resampler"] = pipe.unet.encoder_hid_proj
        with CudaSpans(modules=modules) as spans:
            images, seconds, peak_gb, launches = _held_request(
                smi, label, ip_pipe, STEPS, per_step, encode, decode, prompt=PROMPTS[0], height=RESOLUTION,
                width=RESOLUTION, num_inference_steps=STEPS, guidance_scale=GUIDANCE, ip_adapter_image=prompt_image,
                generator=torch.Generator(device="cuda").manual_seed(SEED), output_type="pil")
        span_ms = spans.ms()
        result = np.asarray(images[0])
        if result.shape != (RESOLUTION, RESOLUTION, 3):
            raise AssertionError(f"{label}: bad image {result.shape}")
        out[label] = {"card": smi, "seconds_per_request": seconds, "peak_memory_gb": peak_gb, "launches": launches,
                      "k1_per_unet_call": per_step["flash_attention_fwd"], "vit_h_encode_launches": encode,
                      "image_cosine_to_dense": _image_cosine(result, dense_image),
                      **{f"{k}_ms": v for k, v in span_ms.items()}}
        paths[label] = launches
        log(f"[ip] {label}: K1 {per_step['flash_attention_fwd']} a UNet call, ViT-H encodes "
            f"{[round(x, 2) for x in span_ms['clip_encode']]} ms"
            + (f", resampler {np.mean(span_ms['resampler']):.3f} ms a UNet call" if "resampler" in span_ms else "")
            + f", UNet {np.mean(span_ms['unet']):.1f} ms a call; cosine to phase 11's image "
            f"{out[label]['image_cosine_to_dense']:.4f}")

    ip_pipe.unload_ip_adapter()
    if _module_launches(pipe.unet) != base_call or pipe.unet.encoder_hid_proj is not None:
        raise AssertionError("unload_ip_adapter left IP-Adapter modules on the UNet")
    images, seconds, _ = _request_seconds(lambda: pipe(
        PROMPTS[0], height=RESOLUTION, width=RESOLUTION, num_inference_steps=STEPS, guidance_scale=GUIDANCE,
        generator=torch.Generator(device="cuda").manual_seed(SEED), output_type="pil").images)
    equal = bool(np.array_equal(np.asarray(images[0]), dense_image))
    out["after_unload"] = {"seconds_per_request": seconds, "bit_equal_to_phase_11": equal}
    log(f"[ip] after unload_ip_adapter(): phase 11's request bit-equal to phase 11's image: {equal}")
    if not equal:
        raise AssertionError("after unload_ip_adapter() the SDXL request differs from phase 11's image")
    del ip_pipe, vision
    gc.collect()
    torch.cuda.empty_cache()
    RESULTS["sdxl_ip_adapter"] = out
    return paths


def run_vae_tiling(smi: str, pipe):
    """Phase 13b: VAE tiling on phase 13's Flux VAE: a 1024 px and a 2048 px
    latent decoded whole and with `tiled_decode` in 512 px tiles (each tile
    a decode through the same K4 path: 30 launches a tile), each timed and
    its peak memory above what was allocated before it printed (the whole
    2048 px decode's mid-block attention runs `native` at d=512 over 65,536
    tokens); the tiled decode against the whole one as the cosine of the
    images; then one Flux request with `vae.enable_tiling()` through
    `FluxPipeline.__call__` (FLUX_TILED_STEPS steps), its decode's launches
    held to the tiles'. Returns the launches by path."""
    import gc

    import numpy as np
    import torch

    vae = pipe.vae
    vae.enable_tiling(VAE_TILE)
    tile_decode = _module_launches(vae.decoder)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    out, paths = {}, {}
    for px in (1024, 2048):
        z = torch.randn((1, 16, px // 8, px // 8), generator=gen, device="cuda").to(torch.bfloat16)
        decoded = {}
        for mode in ("whole", "tiled"):
            gc.collect()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated()
            reset_launches()
            with torch.no_grad():
                sample, seconds, peak_gb = _request_seconds(
                    lambda: (vae.tiled_decode(z) if mode == "tiled" else vae.decode(z)).sample)
            launches = read_launches()
            rows = len(range(0, z.shape[2], int(vae.tile_latent_min_size * (1 - vae.tile_overlap_factor))))
            tiles = rows * rows if mode == "tiled" else 1
            if launches["group_norm"] != tiles * tile_decode["group_norm"] or not bool(torch.isfinite(sample).all()):
                raise AssertionError(f"{px} px {mode} decode: {launches} for {tiles} tiles, or non-finite")
            decoded[mode] = sample
            label = f"vae_decode_{px}_{mode}"
            out[label] = {"card": smi, "seconds": seconds, "peak_above_before_gb": peak_gb - before / 1e9,
                          "tiles": tiles, "launches": launches}
            paths[label] = launches
            log(f"[tiling] {smi}: {px} px {mode} decode ({tiles} tile{'s' if tiles > 1 else ''}): {seconds:.3f} s, "
                f"peak {peak_gb - before / 1e9:.1f} GB above what was allocated before; K4 {launches['group_norm']}")
        a, b = (decoded[m].float().flatten() for m in ("whole", "tiled"))
        out[f"vae_decode_{px}_tiled"]["cosine_to_whole"] = float(torch.dot(a, b) / (a.norm() * b.norm()))
        del decoded, z, a, b
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()
    images, seconds, peak_gb = _request_seconds(lambda: pipe(
        FLUX_PROMPT, height=RESOLUTION, width=RESOLUTION, num_inference_steps=FLUX_TILED_STEPS,
        guidance_scale=FLUX_GUIDANCE, generator=torch.Generator(device="cuda").manual_seed(SEED),
        max_sequence_length=FLUX_MAX_SEQUENCE_LENGTH, output_type="pil").images)
    launches = read_launches()
    vae.disable_tiling()
    image = np.asarray(images[0])
    if image.shape != (RESOLUTION, RESOLUTION, 3) or launches["group_norm"] != 9 * tile_decode["group_norm"]:
        raise AssertionError(f"the tiled Flux request: image {image.shape}, launches {launches} (expected K4 "
                             f"{9 * tile_decode['group_norm']}: 9 tiles)")
    out["flux_tiled"] = {"card": smi, "seconds_per_request": seconds, "steps": FLUX_TILED_STEPS, "peak_memory_gb": peak_gb,
                         "launches": launches, "image_mean": float(image.mean())}
    paths["flux_tiled"] = launches
    log(f"[tiling] {smi}: Flux request with tiling ({FLUX_TILED_STEPS} steps): {seconds:.3f} s, peak {peak_gb:.1f} GB, "
        f"launches {launches}")
    RESULTS["vae_tiling"] = out
    return paths


# ------------------------------------------------------------------ the Flux family (phases 8b, 13c)


def _small_family_pipelines(device: str, dtype):
    """Phase 8b's pipelines, by label: SMALL_FLUX's pipeline and the family's
    pipelines on its components, the family's extra models from fixed seeds,
    built in float32 on the CPU (the same int8 weights on both sides), then
    moved to `device` in `dtype`."""
    import torch

    from diffusers_tpu_torch.models.controlnets.controlnet_flux import FluxControlNetModel
    from diffusers_tpu_torch.models.text_encoders.siglip import SiglipVisionModel
    from diffusers_tpu_torch.models.transformers.transformer_flux import FluxTransformer2DModel
    from diffusers_tpu_torch.pipelines import flux
    from diffusers_tpu_torch.quantizers import quantize_w8a8

    base = _build_flux_pipeline(SMALL_FLUX, SMALL_FLUX_MIN_WEIGHT_SIZE, SMALL_FLUX_VAE, SMALL_FLUX_CLIP, SMALL_T5,
                                "cpu", torch.float32)
    extra = {}
    for i, (name, cls, cfg) in enumerate((
            ("fill", FluxTransformer2DModel, SMALL_FLUX_FILL), ("control", FluxTransformer2DModel, SMALL_FLUX_CONTROL),
            ("controlnet", FluxControlNetModel, SMALL_FLUX_CONTROLNET),
            ("union", FluxControlNetModel, dict(SMALL_FLUX_CONTROLNET, num_mode=10)),
            ("siglip", SiglipVisionModel, SMALL_SIGLIP), ("redux", flux.ReduxImageEncoder, SMALL_REDUX))):
        torch.manual_seed(SEED + 10 + i)
        model = cls(**cfg)
        if isinstance(model, FluxControlNetModel):  # random residual projections, so the residuals act
            for lin in (*model.controlnet_blocks, *model.controlnet_single_blocks, model.controlnet_x_embedder):
                lin.reset_parameters()
        if name in ("fill", "control", "controlnet", "union"):
            quantize_w8a8(model, SMALL_FLUX_MIN_WEIGHT_SIZE)
        extra[name] = model.eval()
    parts = dict(base.components, device="cpu")
    pipes = {"flux": base}
    for label, cls in (("img2img", flux.FluxImg2ImgPipeline), ("inpaint", flux.FluxInpaintPipeline),
                       ("kontext", flux.FluxKontextPipeline), ("kontext_inpaint", flux.FluxKontextInpaintPipeline)):
        pipes[label] = cls(**parts)
    pipes["fill"] = flux.FluxFillPipeline(**dict(parts, transformer=extra["fill"]))
    for label, cls in (("control", flux.FluxControlPipeline), ("control_img2img", flux.FluxControlImg2ImgPipeline),
                       ("control_inpaint", flux.FluxControlInpaintPipeline)):
        pipes[label] = cls(**dict(parts, transformer=extra["control"]))
    for label, cls, net in (("controlnet", flux.FluxControlNetPipeline, "controlnet"),
                            ("controlnet_union", flux.FluxControlNetPipeline, "union"),
                            ("controlnet_img2img", flux.FluxControlNetImg2ImgPipeline, "controlnet"),
                            ("controlnet_inpaint", flux.FluxControlNetInpaintPipeline, "controlnet")):
        pipes[label] = cls(**parts, controlnet=extra[net])
    pipes["redux"] = flux.FluxPriorReduxPipeline(  # with the text encoders: CLIP's pooled embeds fit SMALL_FLUX
        image_encoder=extra["siglip"], image_embedder=extra["redux"], text_encoder=base.text_encoder,
        tokenizer=base.tokenizer, text_encoder_2=base.text_encoder_2, tokenizer_2=base.tokenizer_2, device="cpu")
    for pipe in pipes.values():
        pipe.to(device=torch.device(device), dtype=dtype)
    return pipes


def _check_int4_on_card(device: str):
    """Phase 8b's int4 part: an `Int4Linear` on the card (bf16) against its
    plain dequantize-then-matmul in float32 on the same inputs, element by
    element within 2^-8 (|x| |w| + |ref|) (bf16's rounding of the dequantized
    weight and of the output); then SMALL_T5 quantized by bench.py's int4
    rule at 2^15 elements, the card bf16 against the CPU f32 (cosine)."""
    import numpy as np
    import torch

    from diffusers_tpu_torch.ops.module import Int4Linear
    from diffusers_tpu_torch.quantizers import dequantize_int4, quantize_int4, quantize_int4_linears
    from diffusers_tpu_torch.models.text_encoders.t5 import T5EncoderModel

    gen = torch.Generator().manual_seed(SEED + 20)
    lin = torch.nn.Sequential(torch.nn.Linear(4096, 1280))
    with torch.no_grad():
        lin[0].weight.copy_(torch.randn(1280, 4096, generator=gen) * 4096**-0.5)
    quantize_int4_linears(lin, ["0"], group_size=128)
    q = lin[0].to(device=device, dtype=torch.bfloat16)
    assert isinstance(q, Int4Linear)
    x = torch.randn(333, 4096, generator=gen).to(device=device, dtype=torch.bfloat16)
    with torch.no_grad():
        out = q(x)
    w32 = dequantize_int4(q.weight, q.weight_scale, torch.float32, 4096)
    ref = x.float() @ w32.T + q.bias.float()
    bound = 2.0**-8 * (x.float().abs() @ w32.abs().T + ref.abs()) + 2.0**-8 * q.bias.float().abs()
    share = float(((out.float() - ref).abs() / bound).max())
    resident = q.weight.numel() + 4 * q.weight_scale.numel()

    sides = []
    for dev, dtype in (("cpu", torch.float32), (device, torch.bfloat16)):
        torch.manual_seed(SEED + 21)
        t5 = quantize_int4(T5EncoderModel(**SMALL_T5), min_weight_size=2**15, group_size=128)
        t5.to(device=dev, dtype=dtype)
        ids = torch.from_numpy(np.random.RandomState(SEED).randint(0, 32128, (1, 64))).to(dev)
        with torch.no_grad():
            sides.append(t5(ids).last_hidden_state.float().cpu())
    a, b = (t.flatten() for t in sides)
    cosine = float(torch.dot(a, b) / (a.norm() * b.norm()))
    n_int4 = sum(isinstance(m, Int4Linear) for m in t5.modules())
    RESULTS["small_int4"] = {"linear_share_of_bound": share, "linear_resident_bytes": resident,
                             "t5_int4_linears": n_int4, "t5_cosine_card_vs_cpu": cosine,
                             "t5_max_abs_diff": float((a - b).abs().max())}
    log(f"[ref-flux-family] Int4Linear 4096 -> 1280 (group 128) on the card bf16 vs its plain "
        f"dequantize-then-matmul in f32: share of the per-element bound {share:.3f}; {resident} bytes resident (bf16 weight: "
        f"{2 * 4096 * 1280}); int4 SMALL_T5 ({n_int4} Int4Linears) card bf16 vs CPU f32: cosine {cosine:.6f}, max "
        f"|diff| {RESULTS['small_int4']['t5_max_abs_diff']:.3e} (cosine > 0.999)")
    if not (share <= 1.0 and cosine > 0.999 and n_int4 == 2 * 7):
        raise AssertionError("the int4 Linear or the int4 T5 on the card disagrees with its plain version")


def check_small_flux_family(device: str = "cuda"):
    """Phase 8b: the Flux family on the card (bf16, kernels) against the CPU
    (f32, plain versions; held to JAX by tests/test_torch_flux_family.py,
    test_torch_controlnet_flux.py, test_torch_flux_redux.py and
    test_torch_int4.py): img2img, inpaint, Fill, Kontext, Kontext inpaint,
    Control with its img2img and inpaint, ControlNet plain, Union, img2img
    and inpaint, each SMALL_FAMILY_STEPS steps at 64 px (Kontext with a 64 px
    reference), and Redux's embeds (the prompt's and the image's) fed to
    SMALL_FLUX's pipeline; both sides
    draw from one CPU generator seeded alike. Phase 8's tolerance; every
    forward kernel must launch on each card request (Redux's SigLIP runs K1
    at head_dim 64). Then the int4 Linear and T5 (`_check_int4_on_card`)."""
    import numpy as np
    import torch

    sides = [_small_family_pipelines("cpu", torch.float32), _small_family_pipelines(device, torch.bfloat16)]
    image, mask, edges = synthetic_inputs(64)
    reference = synthetic_inputs(64)[0][::-1].copy()
    latents = torch.from_numpy(np.random.RandomState(SEED).randn(1, 256, 64).astype(np.float32))
    hw = dict(height=64, width=64)
    cases = (
        ("img2img", dict(image=image, strength=0.75)),
        ("inpaint", dict(image=image, mask_image=mask, strength=0.75)),
        ("fill", dict(image=image, mask_image=mask, latents=latents, guidance_scale=FILL_GUIDANCE)),
        ("kontext", dict(image=reference, latents=latents, guidance_scale=KONTEXT_GUIDANCE)),
        ("kontext_inpaint", dict(image=image, mask_image=mask, image_reference=reference)),
        ("control", dict(control_image=edges, latents=latents, **hw)),
        ("control_img2img", dict(image=image, control_image=edges, strength=0.75)),
        ("control_inpaint", dict(image=image, control_image=edges, mask_image=mask, strength=0.75)),
        ("controlnet", dict(control_image=edges, latents=latents, controlnet_conditioning_scale=0.7, **hw)),
        ("controlnet_union", dict(control_image=edges, latents=latents, control_mode=UNION_MODE, **hw)),
        ("controlnet_img2img", dict(image=image, control_image=edges, strength=0.75)),
        ("controlnet_inpaint", dict(image=image, mask_image=mask, control_image=edges, strength=0.75)),
        ("redux", dict(latents=latents, **hw)),
    )
    tol = 0.05  # phase 8's limit on the [0, 1] image
    pixels = torch.from_numpy(np.random.RandomState(SEED + 1).rand(1, 3, 56, 56).astype(np.float32) * 2 - 1)
    results = {}
    for label, kwargs in cases:
        images = []
        for pipes in sides:
            reset_launches()
            run = dict(kwargs, num_inference_steps=SMALL_FAMILY_STEPS, max_sequence_length=64, output_type="np",
                       generator=torch.Generator().manual_seed(SEED))
            if label == "redux":  # the image's embeds stand in for the prompt's
                embeds = pipes["redux"](pixels, prompt=FLUX_PROMPT)
                run.update(prompt_embeds=embeds.prompt_embeds, pooled_prompt_embeds=embeds.pooled_prompt_embeds)
                images.append(pipes["flux"](**run).images)
            else:
                images.append(pipes[label](FLUX_PROMPT, **run).images)
            launches = read_launches()
        ref, out = images
        err = float(np.abs(out - ref).max())
        results[label] = {"max_abs_err": err, "mean_abs_err": float(np.abs(out - ref).mean()), "tol": tol,
                          "launches": launches}
        log(f"[ref-flux-family] small {label}, card bf16 vs CPU f32: max |diff| {err:.3e} (tol {tol}); launches "
            f"{launches}")
        if not (out.shape == ref.shape == (1, 64, 64, 3) and np.isfinite(out).all() and err <= tol):
            raise AssertionError(f"small Flux {label}: the card disagrees with the CPU")
        if min(launches[name] for name in ("flash_attention_fwd", "group_norm", "w8a8_matmul",
                                           "w8a8_quantize_rows")) <= 0:
            raise AssertionError(f"small Flux {label} on the card missed a kernel: {launches}")
    RESULTS["small_flux_family"] = results
    _check_int4_on_card(device)


def _flux_random_model(cls, cfg, seed, device="cuda"):
    """A w8a8 model of `cls` (a Flux transformer or ControlNet) at full width
    with random bf16 weights from `seed`, allocated on the card one unit at a
    time, every Linear of >= 2^20 elements quantized as it is made (bench.py's
    rule); a ControlNet's residual projections random like the rest."""
    import torch

    from diffusers_tpu_torch.models.modeling_utils import materialize_
    from diffusers_tpu_torch.quantizers import quantize_w8a8

    torch.manual_seed(seed)
    with torch.device("meta"):
        model = cls(**cfg)
    materialize_(model, device, torch.bfloat16, lambda unit: quantize_w8a8(unit, W8A8_MIN_WEIGHT_SIZE))
    return model.eval()


def _sum_launches(*terms):
    """The launch dict of `count x module launches` summed over (count, dict) terms."""
    return _launches(**{name: sum(n * d[name] for n, d in terms) for name in launch_counters()})


def _family_request(smi, label, pipe, calls, encodes, controlnet=None, **kwargs):
    """One 1024 px request of a Flux-family pipeline: host seconds ending in a
    synchronize, each transformer and ControlNet call, the VAE encodes and
    the decode on CUDA events, peak memory; the launches held to `calls`
    transformer (and ControlNet) calls, `encodes` VAE encodes and one decode
    by the modules' counts; the uint8 image finite and of its size."""
    import numpy as np
    import torch

    modules = {"transformer": pipe.transformer, "encode": pipe.vae.encoder, "decode": pipe.vae.decoder}
    terms = [(calls, _module_launches(pipe.transformer)), (encodes, _module_launches(pipe.vae.encoder)),
             (1, _module_launches(pipe.vae.decoder))]
    if controlnet is not None:
        modules["controlnet"] = controlnet
        terms.append((calls, _module_launches(controlnet)))
    expected = _sum_launches(*terms)
    seen = []
    hook = pipe.vae.decoder.register_forward_pre_hook(lambda m, a: seen.append(bool(torch.isfinite(a[0]).all())))
    reset_launches()
    try:
        with CudaSpans(modules=modules) as spans:
            images, seconds, peak_gb = _request_seconds(lambda: pipe(
                generator=torch.Generator(device=pipe.device).manual_seed(SEED),
                max_sequence_length=FLUX_MAX_SEQUENCE_LENGTH, output_type="pil", **kwargs).images)
    finally:
        hook.remove()
    launches = read_launches()
    ms = spans.ms()
    image = np.asarray(images[0])
    if image.shape != (RESOLUTION, RESOLUTION, 3) or image.dtype != np.uint8 or seen != [True]:
        raise AssertionError(f"{label}: image {image.shape} {image.dtype}, finite latents into the decode {seen}")
    if len(ms["transformer"]) != calls or len(ms["encode"]) != encodes or launches != expected:
        raise AssertionError(f"{label}: {len(ms['transformer'])} transformer calls (expected {calls}), "
                             f"{len(ms['encode'])} encodes (expected {encodes}), launches {launches} (expected "
                             f"{expected})")
    row = {"card": smi, "seconds_per_request": seconds, "transformer_calls": calls,
           "transformer_ms_per_call": sum(ms["transformer"]) / calls, "encode_ms": ms["encode"],
           "decode_ms": ms["decode"][0], "peak_memory_gb": peak_gb, "launches": launches,
           "image_mean": float(image.mean())}
    if controlnet is not None:
        row["controlnet_ms_per_call"] = sum(ms["controlnet"]) / calls
    log(f"[flux-family] {label} {smi}: {seconds:.3f} s/request ({calls} transformer calls, "
        f"{row['transformer_ms_per_call']:.1f} ms a call"
        + (f"; ControlNet {row['controlnet_ms_per_call']:.1f} ms a call" if controlnet is not None else "")
        + f"; VAE encode {', '.join(f'{t:.1f} ms' for t in ms['encode']) or 'none'}, decode {row['decode_ms']:.1f} ms; "
        f"CUDA "
        f"events), peak {peak_gb:.1f} GB; launches K1 {launches['flash_attention_fwd']}, K4 {launches['group_norm']}, "
        f"K5 {launches['w8a8_matmul']} (as the modules count)")
    return row, launches


def run_flux_family(smi: str, pipe):
    """Phase 13c: the rest of the Flux family at full width through each
    pipeline's `__call__` at 1024 px, on phase 13's FLUX.1-dev components
    (random weights from SEED; synthetic image, mask and edge map):
    img2img and inpaint (strength 0.6); Kontext with a 1024 px reference
    (KONTEXT_STEPS steps, guidance 2.5: K1 at 8,704 tokens) and Kontext
    inpaint; ControlNet at InstantX's Canny widths, plain, img2img and
    inpaint, and its Union form; Redux (SigLIP so400m and the Redux encoder,
    their embeds into a FLUX.1-dev request); then T5-XXL quantized to int4
    in place on the card by bench.py's rule (resident bytes, a 512-token
    encode's time and its embeds beside the bf16 tower's) and one FLUX.1-dev
    request with it; then, each after freeing the transformer before it,
    FLUX.1-Fill-dev (FILL_STEPS steps, guidance 30) and FLUX.1-Canny-dev
    (Control: text-to-image, img2img, inpaint). Each request's launches are
    held to its module counts. Returns the launches by path; the pipeline is
    left with the int4 T5 and no transformer."""
    import gc

    import numpy as np
    import torch

    from diffusers_tpu_torch.models.controlnets.controlnet_flux import FluxControlNetModel
    from diffusers_tpu_torch.models.text_encoders.siglip import SiglipVisionModel
    from diffusers_tpu_torch.models.transformers.transformer_flux import FluxTransformer2DModel
    from diffusers_tpu_torch.ops.module import Int4Linear
    from diffusers_tpu_torch.pipelines import flux
    from diffusers_tpu_torch.quantizers import quantize_int4

    image, mask, edges = synthetic_inputs(RESOLUTION)
    reference = np.ascontiguousarray(image[::-1])
    out, paths = {}, {}
    prompt = dict(prompt=FLUX_PROMPT)
    cut = dict(num_inference_steps=FAMILY_STRENGTH_STEPS, strength=FAMILY_STRENGTH)

    def request(label, cls, calls, encodes, controlnet=None, **kwargs):
        extra = {} if controlnet is None else {"controlnet": controlnet}
        sibling = cls.from_pipe(pipe, **extra)
        out[label], paths[label] = _family_request(smi, label, sibling, calls, encodes, controlnet, **kwargs)

    request("flux_img2img", flux.FluxImg2ImgPipeline, 4, 1, image=image, **prompt, **cut)
    request("flux_inpaint", flux.FluxInpaintPipeline, 4, 1, image=image, mask_image=mask, **prompt, **cut)
    request("flux_kontext", flux.FluxKontextPipeline, KONTEXT_STEPS, 1, image=reference, height=RESOLUTION,
            width=RESOLUTION, num_inference_steps=KONTEXT_STEPS, guidance_scale=KONTEXT_GUIDANCE, **prompt)
    request("flux_kontext_inpaint", flux.FluxKontextInpaintPipeline, FAMILY_CUT_STEPS, 1, image=image,
            mask_image=mask, num_inference_steps=FAMILY_CUT_STEPS, guidance_scale=KONTEXT_GUIDANCE, **prompt)

    for label, cfg, seed in (("controlnet", FLUX_CONTROLNET_CANNY, SEED + 30),
                             ("controlnet_union", FLUX_CONTROLNET_UNION, SEED + 31)):
        t0 = time.perf_counter()
        cn = _flux_random_model(FluxControlNetModel, cfg, seed, pipe.device)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in cn.parameters())
        log(f"[flux-family] built the {label} ({cfg}) at full width, w8a8, in {time.perf_counter() - t0:.1f} s: "
            f"{n_params / 1e9:.3f} B parameters")
        if label == "controlnet":
            request("flux_controlnet", flux.FluxControlNetPipeline, FAMILY_CUT_STEPS, 1, controlnet=cn,
                    control_image=edges, controlnet_conditioning_scale=0.7, height=RESOLUTION, width=RESOLUTION,
                    num_inference_steps=FAMILY_CUT_STEPS, **prompt)
            request("flux_controlnet_img2img", flux.FluxControlNetImg2ImgPipeline, 4, 2, controlnet=cn, image=image,
                    control_image=edges, controlnet_conditioning_scale=0.7, **prompt, **cut)
            request("flux_controlnet_inpaint", flux.FluxControlNetInpaintPipeline, 4, 2, controlnet=cn, image=image,
                    mask_image=mask, control_image=edges, controlnet_conditioning_scale=0.7, **prompt, **cut)
        else:
            request("flux_controlnet_union", flux.FluxControlNetPipeline, FAMILY_CUT_STEPS, 1, controlnet=cn,
                    control_image=edges, control_mode=UNION_MODE, height=RESOLUTION, width=RESOLUTION,
                    num_inference_steps=FAMILY_CUT_STEPS, **prompt)
        out[f"{label}_parameters"] = n_params
        del cn
        gc.collect()
        torch.cuda.empty_cache()

    # Redux: SigLIP so400m's 729 tokens through the Redux encoder, appended to 512 zero T5 tokens
    torch.manual_seed(SEED + 32)
    with torch.device(pipe.device):
        siglip = SiglipVisionModel(**SIGLIP_SO400M).to(torch.bfloat16).eval()
        embedder = flux.ReduxImageEncoder(**REDUX_DEV).to(torch.bfloat16).eval()
    redux = flux.FluxPriorReduxPipeline(image_encoder=siglip, image_embedder=embedder, device=pipe.device)
    size = SIGLIP_SO400M["image_size"]
    tokens = 512 + (size // SIGLIP_SO400M["patch_size"]) ** 2
    pixels = torch.from_numpy(np.ascontiguousarray(synthetic_inputs(size)[0].transpose(2, 0, 1)[None]) * 2 - 1)
    reset_launches()
    with CudaSpans(modules={"siglip": siglip, "redux_encoder": embedder}) as spans:
        embeds, redux_s, _ = _request_seconds(lambda: redux(pixels))
    redux_launches = read_launches()
    redux_ms = spans.ms()
    if (embeds.prompt_embeds.shape != (1, tokens, REDUX_DEV["txt_in_features"])
            or not bool(torch.isfinite(embeds.prompt_embeds).all())):
        raise AssertionError(f"Redux embeds {tuple(embeds.prompt_embeds.shape)} or non-finite")
    native = _attention_costs([SIGLIP_ATTENTION])
    out["redux_embeds"] = {"seconds": redux_s, "siglip_ms": redux_ms["siglip"][0],
                           "redux_encoder_ms": redux_ms["redux_encoder"][0], "launches": redux_launches,
                           "siglip_parameters": sum(p.numel() for p in siglip.parameters()),
                           "siglip_attention_native_vs_sdpa": native[0]}
    log(f"[flux-family] Redux {smi}: {redux_s:.3f} s (SigLIP so400m {redux_ms['siglip'][0]:.1f} ms, Redux encoder "
        f"{redux_ms['redux_encoder'][0]:.1f} ms; CUDA events); launches {redux_launches} (heads of 72: `native`); its "
        f"27 attentions `native` {native[1]:.3f} ms, SDPA {native[2]:.3f} ms (device time)")
    request("flux_redux", flux.FluxPipeline, FAMILY_CUT_STEPS, 0, prompt_embeds=embeds.prompt_embeds,
            pooled_prompt_embeds=embeds.pooled_prompt_embeds, height=RESOLUTION, width=RESOLUTION,
            num_inference_steps=FAMILY_CUT_STEPS, guidance_scale=FLUX_GUIDANCE)
    del redux, siglip, embedder, embeds
    gc.collect()
    torch.cuda.empty_cache()

    # bench.py's int4 T5-XXL: the pipeline's bf16 tower quantized in place on the card
    t5 = pipe.text_encoder_2
    ids = pipe._ids(pipe.tokenizer_2, [FLUX_PROMPT], FLUX_MAX_SEQUENCE_LENGTH)

    def tower_bytes():
        return sum(t.numel() * t.element_size() for t in (*t5.parameters(), *t5.buffers()))

    with torch.no_grad():
        bf16_embeds = t5(ids).last_hidden_state
        bf16_ms = time_ms(lambda: t5(ids), iters=5)
    bf16_bytes, before = tower_bytes(), torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    quantize_int4(t5, min_weight_size=W8A8_MIN_WEIGHT_SIZE, group_size=128)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    freed_gb = (before - torch.cuda.memory_allocated()) / 1e9
    with torch.no_grad():
        int4_embeds = t5(ids).last_hidden_state
        int4_ms = time_ms(lambda: t5(ids), iters=5)
    a, b = bf16_embeds.float().flatten(), int4_embeds.float().flatten()
    int4 = {"card": smi, "bf16_bytes": bf16_bytes, "int4_bytes": tower_bytes(), "freed_gb": freed_gb,
            "int4_linears": sum(isinstance(m, Int4Linear) for m in t5.modules()), "quantize_seconds": quantize_s,
            "bf16_encode_ms": bf16_ms, "int4_encode_ms": int4_ms, "max_abs_diff": float((a - b).abs().max()),
            "bf16_max_abs": float(a.abs().max()), "cosine": float(torch.dot(a, b) / (a.norm() * b.norm()))}
    out["t5_xxl_int4"] = int4
    log(f"[flux-family] T5-XXL int4 (bench.py's rule, {int4['int4_linears']} Int4Linears, group 128) {smi}: resident "
        f"{int4['int4_bytes'] / 1e9:.3f} GB against the bf16 tower's {bf16_bytes / 1e9:.3f} GB "
        f"({freed_gb:.3f} GB freed); "
        f"a 512-token encode {int4_ms:.1f} ms (bf16 {bf16_ms:.1f} ms; CUDA events); prompt embeds max |diff| "
        f"{int4['max_abs_diff']:.3e} (bf16 max |x| {int4['bf16_max_abs']:.3e}), cosine {int4['cosine']:.6f}; "
        f"quantized in {quantize_s:.1f} s")
    # random weights: int4's error (about a tenth of a group's rms a weight) compounds over the 24 layers, so the
    # cosine is reported and held only to > 0.5, which a wrong nibble or group order breaks (cosine near 0)
    if not (int4["int4_linears"] == t5.config.num_layers * 7 and int4["cosine"] > 0.5
            and bool(torch.isfinite(b).all())):
        raise AssertionError(f"the int4 T5-XXL: {int4}")
    del bf16_embeds, int4_embeds, a, b
    request("flux_t5_int4", flux.FluxPipeline, FAMILY_CUT_STEPS, 0, height=RESOLUTION, width=RESOLUTION,
            num_inference_steps=FAMILY_CUT_STEPS, guidance_scale=FLUX_GUIDANCE, **prompt)

    # Fill, then Canny (Control), each built after the transformer before it is freed
    for label, cfg, seed in (("fill", FLUX_FILL_DEV, SEED + 33), ("canny", FLUX_CANNY_DEV, SEED + 34)):
        pipe.transformer = None
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        pipe.transformer = _flux_random_model(FluxTransformer2DModel, cfg, seed, pipe.device)
        torch.cuda.synchronize()
        out[f"{label}_build_seconds"] = time.perf_counter() - t0
        log(f"[flux-family] built the {label} transformer (in_channels {cfg['in_channels']}) at full width and depth, "
            f"w8a8, in {out[f'{label}_build_seconds']:.1f} s; {torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
        if label == "fill":
            request("flux_fill", flux.FluxFillPipeline, FILL_STEPS, 1, image=image, mask_image=mask,
                    num_inference_steps=FILL_STEPS, guidance_scale=FILL_GUIDANCE, **prompt)
        else:
            request("flux_control", flux.FluxControlPipeline, FAMILY_CUT_STEPS, 1, control_image=edges,
                    height=RESOLUTION, width=RESOLUTION, num_inference_steps=FAMILY_CUT_STEPS, **prompt)
            request("flux_control_img2img", flux.FluxControlImg2ImgPipeline, 4, 2, image=image, control_image=edges,
                    **prompt, **cut)
            request("flux_control_inpaint", flux.FluxControlInpaintPipeline, 4, 2, image=image, control_image=edges,
                    mask_image=mask, **prompt, **cut)
    pipe.transformer = None
    gc.collect()
    torch.cuda.empty_cache()
    RESULTS["flux_family"] = out
    return paths


# ------------------------------------------------------------------ phase 18: pipelines from disk


def _scratch_dir(label: str, need_bytes: float) -> str:
    """A new directory for `need_bytes` of checkpoint: under the system
    temporary directory, else under the git-ignored `build/`; raises with
    the numbers when neither has room."""
    import shutil
    import tempfile

    free = {}
    for base in (tempfile.gettempdir(), str(ROOT / "build")):
        Path(base).mkdir(parents=True, exist_ok=True)
        free[base] = shutil.disk_usage(base).free
        if free[base] >= need_bytes + DISK_MARGIN:
            return tempfile.mkdtemp(prefix=f"chip_smoke_{label}_", dir=base)
    raise RuntimeError(f"phase 18 {label}: {need_bytes / 1e9:.1f} GB to write (+{DISK_MARGIN / 1e9:.0f} GB margin), "
                       f"free: { {k: f'{v / 1e9:.1f} GB' for k, v in free.items()} }")


def _state_bytes(pipe) -> int:
    import torch

    return sum(t.numel() * t.element_size() for m in pipe.components.values() if isinstance(m, torch.nn.Module)
               for t in m.state_dict().values())


def _bit_equal_components(saved, loaded) -> dict:
    """{component: True} when every state-dict tensor of the loaded pipeline
    equals the saved one in key order, dtype and bits; raises otherwise."""
    import torch

    out = {}
    for name, model in saved.components.items():
        if not isinstance(model, torch.nn.Module):
            continue
        a, b = model.state_dict(), getattr(loaded, name).state_dict()
        out[name] = list(a) == list(b) and all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)
    if not all(out.values()):
        raise AssertionError(f"from_pretrained did not give back the saved weights bit for bit: {out}")
    return out


def _component_bytes(directory) -> dict:
    """Bytes on disk of each component folder of a saved pipeline."""
    return {d.name: sum(f.stat().st_size for f in d.rglob("*") if f.is_file())
            for d in sorted(Path(directory).iterdir()) if d.is_dir()}


def _evict_page_cache(directory) -> None:
    """Flush each file of `directory` to disk and ask the kernel to drop its
    cached pages (`posix_fadvise` DONTNEED; best effort, no privileges), so
    that the next read comes from the disk."""
    import os

    for f in Path(directory).rglob("*"):
        if f.is_file():
            fd = os.open(f, os.O_RDONLY)
            try:
                os.fsync(fd)
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            finally:
                os.close(fd)


def _uint8_diff(a, b) -> int:
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        raise AssertionError(f"images of shapes {a.shape} and {b.shape}")
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def run_sdxl_from_disk(smi: str, pipe, image):
    """Phase 18a: phase 11's full-width SDXL pipeline written with the
    port's `save_pretrained` (the page cache left warm) and read back onto
    the card with `StableDiffusionXLPipeline.from_pretrained(dir,
    dtype=torch.bfloat16)`, its stand-in tokenizers passed back as
    components; every component bit-equal; then phase 11's request (1024
    px, 30 steps, CFG 5.0, SEED) within 2 uint8 levels of phase 11's image,
    K1 and K4 at the module counts."""
    import shutil

    import numpy as np
    import torch

    from diffusers_tpu_torch import StableDiffusionXLPipeline

    nbytes = _state_bytes(pipe)
    directory = _scratch_dir("sdxl", nbytes)
    try:
        _, save_s, _ = _request_seconds(lambda: pipe.save_pretrained(directory))
        on_disk = _component_bytes(directory)
        base_gb = torch.cuda.memory_allocated() / 1e9
        loaded, load_s, load_peak_gb = _request_seconds(lambda: StableDiffusionXLPipeline.from_pretrained(
            directory, dtype=torch.bfloat16, tokenizer=StandInTokenizer(), tokenizer_2=StandInTokenizer()))
        load_peak_gb -= base_gb
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    equal = _bit_equal_components(pipe, loaded)
    expected = {k: STEPS * v + _module_launches(loaded.vae.decoder)[k] for k, v in _module_launches(loaded.unet).items()}
    reset_launches()
    images, request_s, peak_gb = _request_seconds(lambda: loaded(
        PROMPTS[0], height=RESOLUTION, width=RESOLUTION, num_inference_steps=STEPS, guidance_scale=GUIDANCE,
        generator=torch.Generator(device="cuda").manual_seed(SEED), output_type="pil").images)
    launches = read_launches()
    diff = _uint8_diff(np.asarray(images[0]), image)
    RESULTS["sdxl_from_disk"] = {
        "card": smi, "bytes": nbytes, "bytes_on_disk": on_disk, "save_seconds": save_s, "load_seconds": load_s,
        "load_gb_per_s": nbytes / load_s / 1e9, "page_cache": "warm (just written)", "load_peak_gb": load_peak_gb,
        "request_seconds": request_s, "request_peak_gb": peak_gb, "first_image_seconds": load_s + request_s,
        "bit_equal": equal, "max_diff_to_phase_11": diff, "launches": launches, "expected_launches": expected}
    log(f"[sdxl-disk] {smi}: SDXL {nbytes / 1e9:.2f} GB bf16: save_pretrained {save_s:.1f} s, from_pretrained onto "
        f"the card {load_s:.2f} s ({nbytes / load_s / 1e9:.2f} GB/s, page cache warm), load peak {load_peak_gb:.2f} "
        f"GB; components bit-equal {equal}; request {request_s:.3f} s (first image {load_s + request_s:.2f} s after "
        f"from_pretrained began), peak {peak_gb:.1f} GB; max |diff| to phase 11's image {diff} (uint8 levels; limit "
        f"2); launches {launches} (expected {expected})")
    if diff > 2:
        raise AssertionError(f"the SDXL pipeline read from disk differs from phase 11's image by {diff} levels")
    if launches != expected:
        raise AssertionError(f"the SDXL pipeline read from disk launched {launches}, expected {expected}")
    return {"sdxl_from_disk": launches}


def run_sd3_from_disk(smi: str, pipe):
    """Phase 18b: phase 16's SD3.5 Medium pipeline, given real tokenizers
    (`clip_tokenizer`, `t5_tokenizer`), answers a direct request from SEED;
    then it is written with `save_pretrained` (T5-XXL in 5 GB transformers
    shards, as published), flushed from the page cache, and served by
    `serving.server.serve()` with MODEL_PATH set to the directory, which
    loads it with `StableDiffusion3Pipeline.from_pretrained(MODEL_PATH,
    dtype=torch.bfloat16)` onto the card. The loaded weights must be
    bit-equal, the served image within 2 uint8 levels of the direct one,
    the launches at the module counts."""
    import os
    import shutil
    import tempfile
    import threading

    import torch

    from diffusers_tpu_torch.serving import server

    tokenizer_dir = tempfile.mkdtemp(prefix="chip_smoke_tokenizers_")
    try:
        clip = clip_tokenizer(Path(tokenizer_dir) / "clip")
        pipe.register_modules(tokenizer=clip, tokenizer_2=clip, tokenizer_3=t5_tokenizer(Path(tokenizer_dir) / "t5"))
    finally:
        shutil.rmtree(tokenizer_dir, ignore_errors=True)
    call = dict(height=RESOLUTION, width=RESOLUTION, num_inference_steps=SD3_STEPS, guidance_scale=SD3_GUIDANCE,
                output_type="np")
    direct = pipe(SD3_PROMPTS[0], generator=torch.Generator(device="cuda").manual_seed(SEED), **call).images
    direct_image = server.to_uint8(direct[0])

    nbytes = _state_bytes(pipe)
    directory = _scratch_dir("sd3", nbytes)
    image_dir = tempfile.mkdtemp(prefix="chip_smoke_sd3_images_")
    previous = (os.environ.get("MODEL_PATH"), server.IMAGE_DIR)
    httpd = None
    try:
        _, save_s, _ = _request_seconds(lambda: pipe.save_pretrained(directory))
        on_disk = _component_bytes(directory)
        t5_files = sorted(f.name for f in (Path(directory) / "text_encoder_3").iterdir())
        _evict_page_cache(directory)
        os.environ["MODEL_PATH"] = directory
        server.IMAGE_DIR = image_dir
        base_gb = torch.cuda.memory_allocated() / 1e9
        httpd, load_s, load_peak_gb = _request_seconds(lambda: server.serve(host="127.0.0.1", port=0, seed=SEED))
        load_peak_gb -= base_gb
        loaded = httpd.worker.pipeline
        equal = _bit_equal_components(pipe, loaded)
        per_call, decode = _module_launches(loaded.transformer), _module_launches(loaded.vae.decoder)
        expected = {k: SD3_STEPS * per_call[k] + decode[k] for k in per_call}
        serving = threading.Thread(target=httpd.serve_forever, daemon=True)
        serving.start()
        reset_launches()
        (status, answer), request_s, _ = _request_seconds(lambda: _post(httpd.server_address[1], {
            "prompt": SD3_PROMPTS[0], "size": f"{RESOLUTION}x{RESOLUTION}", "steps": SD3_STEPS,
            "guidance_scale": SD3_GUIDANCE}))
        launches = read_launches()
        if status != 200:
            raise AssertionError(f"the server loaded from MODEL_PATH answered {status}: {answer}")
        served = _fetch_png(httpd.server_address[1], answer["data"][0]["url"])
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.worker.stop()
            httpd.server_close()
        os.environ.pop("MODEL_PATH", None)
        if previous[0] is not None:
            os.environ["MODEL_PATH"] = previous[0]
        server.IMAGE_DIR = previous[1]
        shutil.rmtree(directory, ignore_errors=True)
        shutil.rmtree(image_dir, ignore_errors=True)
    del loaded, httpd
    diff = _uint8_diff(served, direct_image)
    RESULTS["sd3_from_disk"] = {
        "card": smi, "bytes": nbytes, "bytes_on_disk": on_disk, "text_encoder_3_files": t5_files,
        "save_seconds": save_s, "load_seconds": load_s, "load_gb_per_s": nbytes / load_s / 1e9,
        "page_cache": "evicted after the save (fsync + posix_fadvise DONTNEED, best effort)",
        "load_peak_gb": load_peak_gb, "request_seconds": request_s, "first_image_seconds": load_s + request_s,
        "bit_equal": equal, "served_vs_direct_max_diff": diff, "launches": launches, "expected_launches": expected}
    log(f"[sd3-disk] {smi}: SD3.5 Medium {nbytes / 1e9:.2f} GB bf16, on disk "
        f"{ {k: f'{v / 1e9:.3f} GB' for k, v in on_disk.items()} } (text_encoder_3: {t5_files}): save_pretrained "
        f"{save_s:.1f} s; serve() from MODEL_PATH loaded it onto the card in {load_s:.2f} s "
        f"({nbytes / load_s / 1e9:.2f} GB/s, page cache evicted), load peak {load_peak_gb:.2f} GB; components "
        f"bit-equal {equal}; one request {request_s:.3f} s (first image {load_s + request_s:.2f} s after serve() "
        f"began); served vs direct max |diff| {diff} (uint8 levels; limit 2); launches {launches} (expected "
        f"{expected})")
    if diff > 2:
        raise AssertionError(f"the pipeline served from MODEL_PATH differs from the direct call by {diff} levels")
    if launches != expected:
        raise AssertionError(f"the request served from MODEL_PATH launched {launches}, expected {expected}")
    return {"sd3_from_disk": launches}


def run_flux_w8a8_on_load(smi: str):
    """Phase 18c: Flux.1-dev at full width, cut to FLUX_CUT (T5_CUT), built
    in bf16 from SEED and written with `save_pretrained`; the in-memory
    transformer is then quantized by the rule `Int8DynamicActConfig()`
    selects (`quantizers.w8a8_linear_names`, JAX's); the transformer read
    alone with that config must equal it bit for bit (each int8 weight and
    scale `quantize_kernel_int8` of the saved bf16 weight, on the card) with
    a load peak below its bf16 bytes; then `FluxPipeline.from_pretrained`
    with a `PipelineQuantizationConfig` serves one 28-step 1024 px request,
    K5 launched 28 times for each 128-aligned W8A8Linear (all but
    `proj_out`, 3072 -> 64), within 2 uint8 levels of the in-memory
    pipeline's request from the same seed."""
    import shutil

    import numpy as np
    import torch

    from diffusers_tpu_torch import FluxPipeline, Int8DynamicActConfig, PipelineQuantizationConfig
    from diffusers_tpu_torch.models.transformers.transformer_flux import FluxTransformer2DModel
    from diffusers_tpu_torch.ops.module import W8A8Linear
    from diffusers_tpu_torch.quantizers import quantize_linears, w8a8_linear_names

    pipe = _build_flux_pipeline(FLUX_CUT, None, FLUX_VAE, CLIP_L, T5_CUT, "cuda", torch.bfloat16)
    tr = pipe.transformer
    config = Int8DynamicActConfig()
    names = w8a8_linear_names(tr, config)
    bench = [n for n, m in tr.named_modules() if isinstance(m, torch.nn.Linear) and m.weight.numel() >= 2**20]
    bf16_bytes = sum(t.numel() * t.element_size() for t in tr.state_dict().values())
    if len(names) != FLUX_CUT_W8A8:
        raise AssertionError(f"JAX's rule selects {len(names)} Linears of the cut Flux transformer, expected "
                             f"{FLUX_CUT_W8A8}")
    nbytes = _state_bytes(pipe)
    directory = _scratch_dir("flux", nbytes)
    tokenizers = dict(tokenizer=StandInTokenizer(), tokenizer_2=StandInTokenizer(**T5_TOKENIZER))
    try:
        _, save_s, _ = _request_seconds(lambda: pipe.save_pretrained(directory))
        quantize_linears(tr, names)  # the in-memory reference, quantized by the same rule on the card
        base = torch.cuda.memory_allocated()
        alone, alone_s, peak_gb = _request_seconds(lambda: FluxTransformer2DModel.from_pretrained(
            directory, subfolder="transformer", dtype=torch.bfloat16, quantization_config=config))
        load_peak_bytes = peak_gb * 1e9 - base
        a, b = tr.state_dict(), alone.state_dict()
        alone_equal = list(a) == list(b) and all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)
        int8_bytes = sum(t.numel() * t.element_size() for t in b.values())
        del alone, a, b
        torch.cuda.empty_cache()
        quant = PipelineQuantizationConfig(quant_mapping={"transformer": config})
        loaded, load_s, _ = _request_seconds(lambda: FluxPipeline.from_pretrained(
            directory, dtype=torch.bfloat16, quantization_config=quant, **tokenizers))
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    equal = _bit_equal_components(pipe, loaded)
    n_w8a8 = sum(isinstance(m, W8A8Linear) for m in loaded.transformer.modules())
    n_k5 = _module_launches(loaded.transformer)["w8a8_matmul"]  # proj_out's N = 64 takes the dequantized matmul
    call = dict(height=RESOLUTION, width=RESOLUTION, num_inference_steps=FLUX_STEPS, guidance_scale=FLUX_GUIDANCE,
                max_sequence_length=FLUX_MAX_SEQUENCE_LENGTH, output_type="pil")
    reset_launches()
    reference, reference_s, _ = _request_seconds(lambda: pipe(
        FLUX_PROMPT, generator=torch.Generator(device="cuda").manual_seed(SEED), **call).images)
    reference_launches = read_launches()
    reset_launches()
    images, request_s, peak_gb = _request_seconds(lambda: loaded(
        FLUX_PROMPT, generator=torch.Generator(device="cuda").manual_seed(SEED), **call).images)
    launches = read_launches()
    expected = {k: FLUX_STEPS * v + _module_launches(loaded.vae.decoder)[k]
                for k, v in _module_launches(loaded.transformer).items()}
    diff = _uint8_diff(np.asarray(images[0]), np.asarray(reference[0]))
    RESULTS["flux_w8a8_on_load"] = {
        "card": smi, "transformer": FLUX_CUT, "text_encoder_2": T5_CUT, "bytes": nbytes, "save_seconds": save_s,
        "transformer_bf16_bytes": bf16_bytes, "transformer_w8a8_bytes": int8_bytes,
        "transformer_load_seconds": alone_s, "transformer_load_peak_bytes": load_peak_bytes,
        "transformer_bit_equal_to_in_memory": alone_equal, "pipeline_load_seconds": load_s,
        "pipeline_load_gb_per_s": nbytes / load_s / 1e9, "page_cache": "warm (just written)",
        "w8a8_linears": n_w8a8, "w8a8_linears_on_k5": n_k5, "bench_rule_only": sorted(set(bench) - set(names)),
        "jax_rule_only": sorted(set(names) - set(bench)), "bit_equal": equal, "request_seconds": request_s,
        "reference_request_seconds": reference_s, "request_peak_gb": peak_gb, "first_image_seconds": load_s + request_s,
        "max_diff_to_in_memory": diff, "launches": launches, "expected_launches": expected}
    log(f"[flux-w8a8-load] {smi}: Flux.1-dev cut to {FLUX_CUT['num_layers']} dual + {FLUX_CUT['num_single_layers']} "
        f"single blocks, T5-XXL {T5_CUT['num_layers']} layers: {nbytes / 1e9:.2f} GB bf16 saved in {save_s:.1f} s; "
        f"JAX's rule quantizes {n_w8a8} Linears, {n_k5} of them 128-aligned for K5 (bench's rule alone: {sorted(set(bench) - set(names))}; JAX's "
        f"alone: {sorted(set(names) - set(bench))}); the transformer alone loaded in {alone_s:.2f} s, peak "
        f"{load_peak_bytes / 1e9:.3f} GB against its {bf16_bytes / 1e9:.3f} GB bf16 ({int8_bytes / 1e9:.3f} GB "
        f"w8a8), bit-equal to the in-memory quantization {alone_equal}; the pipeline loaded in {load_s:.2f} s "
        f"({nbytes / load_s / 1e9:.2f} GB/s, warm), components bit-equal; request {request_s:.3f} s (in-memory "
        f"{reference_s:.3f} s), max |diff| {diff} (uint8 levels; limit 2); launches {launches} (expected {expected})")
    if not alone_equal:
        raise AssertionError("the transformer quantized on load differs from the same model quantized in memory")
    if load_peak_bytes >= bf16_bytes:
        raise AssertionError(f"the w8a8 load peaked at {load_peak_bytes} bytes, not below the bf16 {bf16_bytes}")
    if n_w8a8 != len(names) or launches["w8a8_matmul"] != n_k5 * FLUX_STEPS or launches != expected:
        raise AssertionError(f"the Flux request read from disk launched {launches}, expected {expected}")
    if diff > 2:
        raise AssertionError(f"the Flux pipeline quantized on load differs from the in-memory one by {diff} levels")
    return {"flux_w8a8_on_load": launches, "flux_w8a8_in_memory": reference_launches}


def small_round_trip_cases():
    """Phase 18d's pipelines (phase 10's small SDXL, Flux with a float
    transformer, SD3.5-style and Wan, and phase 10e's Wan image-to-video,
    built on the CPU in float32 from SEED and moved to the card in bf16),
    their tokenizer slots, and a call."""
    import numpy as np
    import torch

    rng = np.random.RandomState(SEED)
    n = SAMPLE_ROUND_TRIP_STEPS

    def on_card(pipe):
        return pipe.to(device=torch.device("cuda"), dtype=torch.bfloat16)

    sdxl_latents = torch.from_numpy(rng.randn(1, 4, 16, 16).astype(np.float32))
    flux_latents = torch.from_numpy(rng.randn(1, 256, 64).astype(np.float32))
    sd3_latents = torch.from_numpy(rng.randn(1, 16, 16, 16).astype(np.float32))
    wan_latents = torch.from_numpy(rng.randn(1, 16, 3, 8, 8).astype(np.float32))
    wan_image = np.round(255 * synthetic_video(1, 64, 64)[0]).astype(np.uint8)
    return (
        ("sdxl", lambda: on_card(_build_pipeline(SMALL_UNET, SMALL_VAE, SMALL_CLIP, SMALL_CLIP, "cpu",
                                                 torch.float32)), ("clip", "clip"),
         lambda p: p(PROMPTS[0], latents=sdxl_latents, num_inference_steps=n, guidance_scale=GUIDANCE,
                     output_type="np").images),
        ("flux", lambda: on_card(_build_flux_pipeline(SMALL_FLUX, None, SMALL_FLUX_VAE, SMALL_FLUX_CLIP, SMALL_T5,
                                                      "cpu", torch.float32)), ("clip", "t5"),
         lambda p: p(FLUX_PROMPT, latents=flux_latents, height=64, width=64, num_inference_steps=n,
                     guidance_scale=FLUX_GUIDANCE, max_sequence_length=64, output_type="np").images),
        ("sd3", lambda: on_card(_build_sd3_pipeline(SMALL_SD35, SMALL_SD3_VAE, SMALL_SD3_CLIP, SMALL_SD3_CLIP,
                                                    SMALL_T5, "cpu", torch.float32)), ("clip", "clip", "t5"),
         lambda p: p(PROMPTS[0], latents=sd3_latents, num_inference_steps=n, guidance_scale=SD3_GUIDANCE,
                     max_sequence_length=64, output_type="np").images),
        ("wan", lambda: on_card(_build_wan_pipeline(SMALL_WAN, SMALL_WAN_VAE, SMALL_UMT5, "cpu", torch.float32)),
         ("t5",), lambda p: p(WAN_PROMPT, WAN_NEGATIVE, height=64, width=64, num_frames=9, num_inference_steps=n,
                              guidance_scale=WAN_GUIDANCE, max_sequence_length=64, latents=wan_latents,
                              output_type="np").frames),
        # phase 10e's image-to-video pipeline with a transformers CLIPImageProcessor (Wan2.1-I2V's numbers)
        ("wan_i2v", lambda: on_card(_build_wan_i2v_pipeline(
            _build_wan_pipeline(SMALL_WAN, SMALL_WAN_VAE, SMALL_UMT5, "cpu", torch.float32), SMALL_WAN_I2V,
            SMALL_CLIP_VISION, image_processor=clip_image_processor())),
         ("t5",), lambda p: p(image=wan_image, prompt=WAN_PROMPT, negative_prompt=WAN_NEGATIVE, height=64, width=64,
                              num_frames=9, num_inference_steps=n, guidance_scale=WAN_GUIDANCE,
                              max_sequence_length=WAN_TEXT_LEN, latents=wan_latents, output_type="np").frames),
    )


def run_small_round_trips(smi: str):
    """Phase 18d: phase 10's small SDXL, Flux, SD3 and Wan pipelines and
    phase 10e's Wan image-to-video (its CLIP tower and a transformers
    `CLIPImageProcessor` too) on the card, given real tokenizers, each
    through `save_pretrained` and
    `from_pretrained(device="cuda")` (Wan's in 1 MB shards, so its UMT5 is
    several transformers shards); each component bit-equal, each output
    within 2 uint8 levels of the same call before the round trip."""
    import shutil
    import tempfile

    import numpy as np

    from diffusers_tpu_torch.serving.server import to_uint8

    results, root = {}, tempfile.mkdtemp(prefix="chip_smoke_small_")
    reset_launches()
    try:
        tokenizers = {"clip": clip_tokenizer(Path(root) / "clip"), "t5": t5_tokenizer(Path(root) / "t5")}
        for name, build, slots, call in small_round_trip_cases():
            pipe = build()
            pipe.register_modules(**{f"tokenizer{'' if i == 0 else f'_{i + 1}'}": tokenizers[kind]
                                     for i, kind in enumerate(slots)})
            before = call(pipe)
            directory = Path(root) / name
            pipe.save_pretrained(directory, max_shard_size="1MB" if name == "wan" else None)
            files = {d.name: sorted(f.name for f in d.iterdir()) for d in directory.iterdir() if d.is_dir()}
            loaded, load_s, _ = _request_seconds(lambda: type(pipe).from_pretrained(directory, device="cuda"))
            equal = _bit_equal_components(pipe, loaded)
            after = call(loaded)
            diff = _uint8_diff(to_uint8(after), to_uint8(before))
            results[name] = {"load_seconds": load_s, "bit_equal": equal, "max_diff": diff,
                             "max_abs_diff": float(np.abs(after - before).max()), "files": files}
            log(f"[small-disk] {smi}: small {name} through save_pretrained / from_pretrained(device='cuda') in "
                f"{load_s:.2f} s: components bit-equal {equal}, output max |diff| {diff} uint8 levels "
                f"({results[name]['max_abs_diff']:.3e}); files {files.get('text_encoder', files)}")
            if diff > 2:
                raise AssertionError(f"small {name} after the round trip differs by {diff} levels")
            if name == "wan" and sum(f.endswith(".safetensors") for f in files["text_encoder"]) < 2:
                raise AssertionError(f"Wan's UMT5 was not written in shards: {files['text_encoder']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = read_launches()
    RESULTS["small_round_trips"] = dict(results, launches=launches)
    if min(launches[k] for k in ("flash_attention_fwd", "group_norm")) <= 0:
        raise AssertionError(f"the small round trips missed a kernel: {launches}")
    return {"small_round_trips": launches}


# ------------------------------------------------------------------ the ControlNet family (phases 10h, 24)
def _random_residuals(net, seed: int):
    """Make a ControlNet's zero-initialised parts random (a Union net's
    `spatial_ch_projs`; an SD3 net's residual projections and
    `pos_embed_input`), so what they gate acts."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    names = ("spatial_ch_projs", "controlnet_blocks", "pos_embed_input")
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.startswith(names):
                noise = 0.02 * torch.randn(p.shape, generator=gen, device="cpu")
                p.copy_(noise.to(device=p.device, dtype=p.dtype))
    return net


def _small_controlnet_pipelines():
    """Phase 10h's pipelines on the CPU in float32, by label."""
    import torch

    from diffusers_tpu_torch.models.controlnets import ControlNetModel, ControlNetUnionModel, SD3ControlNetModel
    from diffusers_tpu_torch.pipelines.controlnet import (
        StableDiffusionControlNetImg2ImgPipeline,
        StableDiffusionControlNetInpaintPipeline,
        StableDiffusionControlNetPipeline,
        StableDiffusionXLControlNetImg2ImgPipeline,
        StableDiffusionXLControlNetInpaintPipeline,
        StableDiffusionXLControlNetUnionImg2ImgPipeline,
        StableDiffusionXLControlNetUnionInpaintPipeline,
        StableDiffusionXLControlNetUnionPipeline,
    )
    from diffusers_tpu_torch.pipelines.controlnet_sd3 import StableDiffusion3ControlNetPipeline

    sd = _build_sd(SMALL_SD_UNET, SMALL_VAE, SMALL_CLIP, "cpu", torch.float32)
    sdxl = _build_pipeline(SMALL_UNET, SMALL_VAE, SMALL_CLIP, SMALL_CLIP, "cpu", torch.float32)
    sd3 = _build_sd3_pipeline(SMALL_SD35, SMALL_SD3_VAE, SMALL_SD3_CLIP, SMALL_SD3_CLIP, SMALL_T5, "cpu",
                              torch.float32)
    torch.manual_seed(SEED + 3)
    sd_nets = [ControlNetModel(**SMALL_SD_CONTROLNET) for _ in range(2)]
    xl_net = ControlNetModel(**SMALL_CONTROLNET)
    unions = [_random_residuals(ControlNetUnionModel(**SMALL_UNION), SEED + i) for i in range(2)]
    sd3_net = _random_residuals(SD3ControlNetModel.from_transformer(
        sd3.transformer, num_layers=SMALL_SD3_CONTROLNET_LAYERS, num_extra_conditioning_channels=0), SEED)
    sd_parts, xl_parts = dict(sd.components, device="cpu"), dict(sdxl.components, device="cpu")
    return {
        "sd": StableDiffusionControlNetPipeline(**sd_parts, controlnet=sd_nets[0]),
        "sd_multi": StableDiffusionControlNetPipeline(**sd_parts, controlnet=sd_nets),
        "sd_img2img": StableDiffusionControlNetImg2ImgPipeline(**sd_parts, controlnet=sd_nets[0]),
        "sd_inpaint": StableDiffusionControlNetInpaintPipeline(**sd_parts, controlnet=sd_nets[0]),
        "sdxl_img2img": StableDiffusionXLControlNetImg2ImgPipeline(**xl_parts, controlnet=xl_net),
        "sdxl_inpaint": StableDiffusionXLControlNetInpaintPipeline(**xl_parts, controlnet=xl_net),
        "union": StableDiffusionXLControlNetUnionPipeline(**xl_parts, controlnet=unions[0]),
        "union_img2img": StableDiffusionXLControlNetUnionImg2ImgPipeline(**xl_parts, controlnet=unions[0]),
        "union_inpaint": StableDiffusionXLControlNetUnionInpaintPipeline(**xl_parts, controlnet=unions[0]),
        "multi_union": StableDiffusionXLControlNetUnionPipeline(**xl_parts, controlnet=unions),
        "sd3": StableDiffusion3ControlNetPipeline(**dict(sd3.components, device="cpu"), controlnet=sd3_net),
    }


def small_controlnet_cases():
    """Phase 10h's cases: (label, pipeline, guidance scale, request kwargs)."""
    import numpy as np
    import torch

    image, mask, edges = synthetic_inputs(32)
    latents = torch.from_numpy(np.random.RandomState(SEED).randn(1, 4, 16, 16).astype(np.float32))
    latents16 = torch.from_numpy(np.random.RandomState(SEED).randn(1, 16, 16, 16).astype(np.float32))
    union = dict(control_image=[edges, image], control_mode=[UNION_CANNY, UNION_DEPTH],
                 controlnet_conditioning_scale=0.7)
    return (
        ("sd_controlnet", "sd", SD15_GUIDANCE, dict(image=edges, latents=latents, controlnet_conditioning_scale=0.8)),
        ("sd_controlnet_guess_mode", "sd", SD15_GUIDANCE, dict(image=edges, latents=latents, guess_mode=True)),
        ("sd_multi_controlnet", "sd_multi", SD15_GUIDANCE,
         dict(image=[edges, image], latents=latents, controlnet_conditioning_scale=[0.8, 0.5])),
        ("sd_controlnet_img2img", "sd_img2img", SD15_GUIDANCE, dict(image=image, control_image=edges, strength=0.6)),
        ("sd_controlnet_inpaint", "sd_inpaint", SD15_GUIDANCE, dict(image=image, mask_image=mask, control_image=edges)),
        ("sdxl_controlnet_img2img", "sdxl_img2img", GUIDANCE, dict(image=image, control_image=edges, strength=0.6)),
        ("sdxl_controlnet_inpaint", "sdxl_inpaint", GUIDANCE,
         dict(image=image, mask_image=mask, control_image=edges)),
        ("union", "union", GUIDANCE, dict(union, latents=latents)),
        ("union_guess_mode", "union", GUIDANCE, dict(union, latents=latents, guess_mode=True)),
        ("union_img2img", "union_img2img", GUIDANCE, dict(union, image=image, strength=0.6)),
        ("union_inpaint", "union_inpaint", GUIDANCE, dict(union, image=image, mask_image=mask)),
        ("multi_union", "multi_union", GUIDANCE,
         dict(control_image=[edges, [edges, image]], control_mode=[UNION_CANNY, [UNION_CANNY, UNION_DEPTH]],
              controlnet_conditioning_scale=[0.8, 0.5], latents=latents)),
        ("sd3_controlnet", "sd3", SD3_GUIDANCE, dict(control_image=image, controlnet_conditioning_scale=0.7,
                                                     latents=latents16, max_sequence_length=16)),
    )


def check_small_controlnets(device: str = "cuda"):
    """Phase 10h: the ControlNet family on small components, on the card
    (bf16, kernels) against the CPU (f32, plain versions; held to JAX by
    tests/test_torch_controlnet_sd.py, test_torch_controlnet_union.py and
    test_torch_controlnet_sd3.py), with phase 7's tolerance on the [0, 1]
    image: SD ControlNet text-to-image (plain, guess mode, two nets),
    img2img and inpaint; SDXL ControlNet img2img and inpaint; the Union
    pipelines (text-to-image plain and in guess mode, img2img, inpaint, two
    Union nets); the SD3 ControlNet pipeline. Each 4 steps, both sides from
    one CPU generator seeded alike. Then the Union net and an SD3
    single-block net (no pos_embed, fed patch tokens) at model level, card
    bf16 against CPU f32, within 2% of the reference's largest value."""
    import numpy as np
    import torch

    from diffusers_tpu_torch.models.controlnets import SD3ControlNetModel

    sides = []
    for dev in ("cpu", device):
        pipes = _small_controlnet_pipelines()
        for pipe in pipes.values():
            pipe.to(device=torch.device(dev), dtype=torch.float32 if dev == "cpu" else torch.bfloat16)
        sides.append(pipes)
    tol = 0.05  # phase 7: bf16 on the card against f32 on the CPU, on the [0, 1] image
    results = {}
    for label, name, guidance, kwargs in small_controlnet_cases():
        images = []
        for pipes in sides:  # the CPU, then the card
            reset_launches()
            images.append(pipes[name](PROMPTS[0], num_inference_steps=SMALL_CONTROLNET_STEPS,
                                      guidance_scale=guidance, generator=torch.Generator().manual_seed(SEED),
                                      output_type="np", **kwargs).images)
            launches = read_launches()
        ref, out = images
        err = float(np.abs(out - ref).max())
        results[label] = {"max_abs_err": err, "mean_abs_err": float(np.abs(out - ref).mean()), "tol": tol,
                          "launches": launches}
        log(f"[ref-controlnet] small {label}, card bf16 vs CPU f32: max |diff| {err:.3e} (tol {tol}); launches "
            f"{launches}")
        if not (out.shape == ref.shape == (1, 32, 32, 3) and np.isfinite(out).all() and err <= tol):
            raise AssertionError(f"small {label}: the card disagrees with the CPU")
        if min(launches["flash_attention_fwd"], launches["group_norm"]) <= 0:
            raise AssertionError(f"small {label} on the card missed a kernel: {launches}")

    # model level: the Union net (two tasks), and an SD3 single-block net fed patch tokens
    gen = torch.Generator().manual_seed(SEED)
    union_cpu, union_card = sides[0]["union"].controlnet, sides[1]["union"].controlnet
    x, ehs = torch.randn(2, 4, 16, 16, generator=gen), torch.randn(2, 77, 64, generator=gen)
    conds = [torch.rand(2, 3, 32, 32, generator=gen) for _ in range(2)]
    mask = torch.zeros(2, SMALL_UNION["num_control_type"])
    mask[:, [UNION_CANNY, UNION_DEPTH]] = 1
    added = {"text_embeds": torch.randn(2, 32, generator=gen), "time_ids": torch.tensor([[32., 32, 0, 0, 32, 32]] * 2)}

    def union_call(net, dev):
        to = {"device": dev, "dtype": net.dtype}
        return net(x.to(**to), 500.0, ehs.to(**to), [c.to(**to) for c in conds], control_type=mask.to(dev),
                   control_type_idx=[UNION_CANNY, UNION_DEPTH], conditioning_scale=0.7,
                   added_cond_kwargs={"text_embeds": added["text_embeds"].to(**to),
                                      "time_ids": added["time_ids"].to(dev)}, return_dict=False)

    torch.manual_seed(SEED + 5)
    single = _random_residuals(SD3ControlNetModel(**dict(
        SMALL_SD3, num_layers=2, joint_attention_dim=None, use_pos_embed=False)), SEED)
    tokens = torch.randn(2, 64, 128, generator=gen)
    cond16 = torch.randn(2, 16, 16, 16, generator=gen)
    pooled, t = torch.randn(2, 128, generator=gen), torch.tensor([700.0, 300.0])

    def single_call(net, dev):
        to = {"device": dev, "dtype": net.dtype}
        return net(tokens.to(**to), cond16.to(**to), conditioning_scale=0.8, pooled_projections=pooled.to(**to),
                   timestep=t.to(dev), return_dict=False)[0]

    with torch.no_grad():
        union_ref = union_call(union_cpu, "cpu")
        reset_launches()
        union_out = union_call(union_card, device)
        union_launches = read_launches()
        single_ref = single_call(single, "cpu")
        single_card = single.to(device=device, dtype=union_card.dtype)
        reset_launches()
        single_out = single_call(single_card, device)
        single_launches = read_launches()
    for label, ref, out, launches, k1 in (
            ("union model", [*union_ref[0], union_ref[1]], [*union_out[0], union_out[1]], union_launches, True),
            ("sd3 single-block model", single_ref, single_out, single_launches, True)):
        err = max(float((o.float().cpu() - r).abs().max()) for o, r in zip(out, ref))
        scale = max(float(r.abs().max()) for r in ref)
        results[label] = {"max_abs_err": err, "ref_max_abs": scale, "tol": 0.02 * scale, "launches": launches}
        log(f"[ref-controlnet] small {label}, card bf16 vs CPU f32: max |diff| {err:.3e} (tol 2% of "
            f"{scale:.3e}); launches {launches}")
        if not err <= 0.02 * scale or not all(bool(torch.isfinite(o).all()) for o in out):
            raise AssertionError(f"small {label}: the card disagrees with the CPU")
        if k1 and launches["flash_attention_fwd"] <= 0:
            raise AssertionError(f"small {label} on the card missed K1: {launches}")
    RESULTS["small_controlnets"] = results


@contextlib.contextmanager
def plain_routes():
    """Inside, the card runs no kernel: attention takes the `native` backend
    and GroupNorm its plain version (`group_norm_plain`), both in the
    tensors' own dtype with f32 statistics, as the kernels compute."""
    from diffusers_tpu_torch.ops import module
    from diffusers_tpu_torch.ops.attention import attention_backend
    from diffusers_tpu_torch.ops.cuda.group_norm import group_norm_plain

    kernel, module.group_norm = module.group_norm, group_norm_plain
    try:
        with attention_backend("native"):
            yield
    finally:
        module.group_norm = kernel


@contextlib.contextmanager
def module_in_float32(module):
    """Inside, every float parameter and buffer of `module` is float32; after,
    each is back in its own dtype (bf16 -> f32 -> bf16 is exact)."""
    tensors = [t for t in (*module.parameters(), *module.buffers()) if t.is_floating_point()]
    dtypes = [t.dtype for t in tensors]
    for t in tensors:
        t.data = t.data.float()
    try:
        yield
    finally:
        for t, dtype in zip(tensors, dtypes):
            t.data = t.data.to(dtype)


@contextlib.contextmanager
def in_float32(pipeline):
    """`module_in_float32` for each of the pipeline's modules."""
    import torch

    with contextlib.ExitStack() as stack:
        for m in pipeline.components.values():
            if isinstance(m, torch.nn.Module):
                stack.enter_context(module_in_float32(m))
        yield


PLAIN_CHECK_RATIO = 2.0  # the kernels' error against the f32 run, at most this times the plain bf16 run's


def _plain_route_check(label, pipeline, per_step, kwargs):
    """The warm-up request (CONTROLNET_WARMUP_STEPS steps, its own generator
    seeded with SEED) three times on the card: on the kernels (bf16), on the
    plain routes (`plain_routes`, bf16) and on the plain routes in float32
    (`in_float32`). The kernels' [0, 1] image must be as close to the f32
    image as the plain bf16 one is: its max and mean |diff| to it at most
    PLAIN_CHECK_RATIO times the plain bf16 image's. The kernels of
    `per_step` must launch in the first run and none in the others.
    Returns the record."""
    import numpy as np
    import torch

    images, launches = [], []
    for route, f32 in ((contextlib.nullcontext, False), (plain_routes, False), (plain_routes, True)):
        reset_launches()
        with route(), in_float32(pipeline) if f32 else contextlib.nullcontext():
            images.append(np.asarray(pipeline(**dict(
                kwargs, num_inference_steps=CONTROLNET_WARMUP_STEPS, output_type="np",
                generator=torch.Generator(device="cuda").manual_seed(SEED))).images, np.float32))
        torch.cuda.synchronize()
        launches.append(read_launches())
    kernels, plain, f32 = images
    errs = {name: (float(np.abs(a - b).max()), float(np.abs(a - b).mean()))
            for name, a, b in (("kernels_vs_plain", kernels, plain), ("kernels_vs_f32", kernels, f32),
                               ("plain_vs_f32", plain, f32))}
    record = {"steps": CONTROLNET_WARMUP_STEPS, "ratio_tol": PLAIN_CHECK_RATIO, "kernel_launches": launches[0],
              "plain_launches": launches[1], "f32_launches": launches[2],
              **{f"{name}_{stat}": v for name, pair in errs.items() for stat, v in zip(("max", "mean"), pair)}}
    log(f"[controlnet] {label}: {CONTROLNET_WARMUP_STEPS} steps, [0, 1] image max / mean |diff|: kernels vs plain "
        "bf16 {:.3e} / {:.3e}, kernels vs plain f32 {:.3e} / {:.3e}, plain bf16 vs plain f32 {:.3e} / {:.3e} (the "
        "kernels' at most {}x the plain's); launches {} on the kernels".format(
            *errs["kernels_vs_plain"], *errs["kernels_vs_f32"], *errs["plain_vs_f32"], PLAIN_CHECK_RATIO, launches[0]))
    finite = all(np.isfinite(im).all() and im.shape == f32.shape for im in images)
    if not (finite and all(k <= PLAIN_CHECK_RATIO * p for k, p in zip(errs["kernels_vs_f32"], errs["plain_vs_f32"]))):
        raise AssertionError(f"{label}: the kernels are further from the f32 plain run than the plain bf16 run: {errs}")
    if any(launches[0][k] <= 0 for k, n in per_step.items() if n > 0) or any(launches[1].values()) or \
            any(launches[2].values()):
        raise AssertionError(f"{label}: a kernel of the steps not launched on the kernels, or one launched on the "
                             f"plain routes: {launches}")
    return record


def _timed_request(smi, label, pipeline, steps, per_step, first_extra, after, denoiser=None, plain_check=False,
                   **kwargs):
    """One request after a warm-up of CONTROLNET_WARMUP_STEPS steps (its own
    generator; with `plain_check`, the warm-up is `_plain_route_check`): each
    step's launches held to `per_step` (plus `first_extra` at the first
    step), the decode's to `after`, the latents going into the decode
    finite; its time on CUDA events and on the host clock, its peak
    memory, and the mean time of a denoiser call and of a ControlNet call
    within it (CUDA events). `denoiser` is the module the steps call (the
    UNet unless given). Returns (images, record)."""
    import numpy as np
    import torch

    denoiser = denoiser if denoiser is not None else pipeline.unet
    plain = None
    if plain_check:
        plain = _plain_route_check(label, pipeline, per_step, kwargs)
    else:
        pipeline(**dict(kwargs, num_inference_steps=CONTROLNET_WARMUP_STEPS, output_type="latent",
                        generator=torch.Generator(device="cuda").manual_seed(SEED)))
    latents_seen = []
    hook = pipeline.vae.decoder.register_forward_pre_hook(lambda m, a: latents_seen.append(a[0]))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    reset_launches()
    try:
        with StepLaunches(pipeline, denoiser) as counted, \
                CudaSpans(modules={"denoiser": denoiser, "controlnet": pipeline.controlnet}) as spans:
            start.record()
            images, seconds, peak_gb = _request_seconds(lambda: pipeline(**kwargs).images)
            end.record()
    finally:
        hook.remove()
    torch.cuda.synchronize()
    span_ms = {k: float(np.mean(v)) for k, v in spans.ms().items()}
    launches = read_launches()
    if not latents_seen or not all(bool(torch.isfinite(z).all()) for z in latents_seen):
        raise AssertionError(f"{label}: non-finite latents")
    expected = [dict(per_step) for _ in range(steps)]
    for k, v in first_extra.items():
        expected[0][k] += v
    _check_steps(label, counted.per_step, expected, counted.after, after)
    event_s = start.elapsed_time(end) / 1e3
    log(f"[controlnet] {smi}: {label}: {event_s:.3f} s/request on CUDA events ({seconds:.3f} s host), {steps} steps, "
        f"peak {peak_gb:.1f} GB; a denoiser call {span_ms['denoiser']:.1f} ms, a ControlNet call "
        f"{span_ms['controlnet']:.1f} ms; launches {launches} (K1 {per_step['flash_attention_fwd']} and K4 "
        f"{per_step['group_norm']} a step, as the modules count)")
    return images, {"card": smi, "seconds_per_request": event_s, "host_seconds": seconds, "peak_memory_gb": peak_gb,
                    "steps": steps, "launches": launches, "k1_per_step": per_step["flash_attention_fwd"],
                    "k4_per_step": per_step["group_norm"], "denoiser_call_ms": span_ms["denoiser"],
                    "controlnet_call_ms": span_ms["controlnet"], "plain_route_check": plain}


def _check_image(label, images, size):
    import numpy as np

    result = np.asarray(images[0])
    if result.shape != (size, size, 3) or result.dtype != np.uint8:
        raise AssertionError(f"{label}: bad uint8 image {result.shape} {result.dtype}")
    return float(result.mean())


def _n_params(*models) -> int:
    return sum(p.numel() for m in models for p in m.parameters())


def run_sd15_controlnet(smi: str, pipe):
    """Phase 24a: the SD 1.5 ControlNet pipelines at full width on phase
    23's pipeline (its CLIP-L, UNet and VAE): a ControlNet at
    lllyasviel/control_v11p_sd15_canny's widths (made on the card, bf16),
    512 px, PNDM 50 steps (51 calls), CFG 7.5: text-to-image from the edge
    map, img2img (0.75) and inpaint (1.0, the 4-channel UNet), then two such
    nets as a Multi-ControlNet (the edge map and the image). Each step's
    launches are held to the modules' counts (K1 0: heads of 40, 80 and 160
    run `native`); text-to-image's warm-up is held to the plain routes on the
    card (`_plain_route_check`). Returns the launches by path."""
    import gc

    import torch

    from diffusers_tpu_torch.models.controlnets import ControlNetModel
    from diffusers_tpu_torch.pipelines.controlnet import (
        StableDiffusionControlNetImg2ImgPipeline,
        StableDiffusionControlNetInpaintPipeline,
        StableDiffusionControlNetPipeline,
    )
    from diffusers_tpu_torch.schedulers import PNDMScheduler

    torch.manual_seed(SEED + 11)
    with torch.device("cuda"):
        nets = [ControlNetModel(**SD15_CONTROLNET).to(torch.bfloat16) for _ in range(2)]
    unet_call, encode, decode = (_module_launches(m) for m in (pipe.unet, pipe.vae.encoder, pipe.vae.decoder))
    cn_call = _module_launches(nets[0])
    image, mask, edges = synthetic_inputs(SD15_RESOLUTION)
    parts = dict(pipe.components)
    out, paths = {}, {}

    def request(label, cls, controlnet, steps, first_extra, **kwargs):
        pipeline = cls(**dict(parts, controlnet=controlnet, scheduler=PNDMScheduler(**SD15_PNDM)))
        n_nets = len(controlnet) if isinstance(controlnet, list) else 1
        per_step = {k: unet_call[k] + n_nets * cn_call[k] for k in unet_call}
        images, record = _timed_request(
            smi, label, pipeline, steps, per_step, first_extra, decode, prompt=SD15_PROMPT,
            guidance_scale=SD15_GUIDANCE, num_inference_steps=SD15_STEPS,
            generator=torch.Generator(device="cuda").manual_seed(SEED), output_type="pil", **kwargs)
        record.update(image_mean=_check_image(label, images, SD15_RESOLUTION),
                      controlnet_parameters=_n_params(*([controlnet] if n_nets == 1 else controlnet)))
        out[label], paths[label] = record, record["launches"]

    state = PNDMScheduler(**SD15_PNDM).set_timesteps(SD15_STEPS)
    keep = len(state.timesteps) - (SD15_STEPS - min(int(SD15_STEPS * SD15_IMG2IMG_STRENGTH), SD15_STEPS))
    request("sd15_controlnet", StableDiffusionControlNetPipeline, nets[0], SD15_STEPS + 1, {}, image=edges,
            controlnet_conditioning_scale=SD15_CONTROLNET_SCALE, plain_check=True)
    request("sd15_controlnet_img2img", StableDiffusionControlNetImg2ImgPipeline, nets[0], keep, encode, image=image,
            control_image=edges, strength=SD15_IMG2IMG_STRENGTH)
    request("sd15_controlnet_inpaint", StableDiffusionControlNetInpaintPipeline, nets[0], SD15_STEPS + 1, encode,
            image=image, mask_image=mask, control_image=edges, strength=SD15_INPAINT_STRENGTH)
    request("sd15_multi_controlnet", StableDiffusionControlNetPipeline, nets, SD15_STEPS + 1, {},
            image=[edges, image], controlnet_conditioning_scale=[SD15_CONTROLNET_SCALE, 0.5])
    log(f"[controlnet] SD 1.5 ControlNet: {_n_params(nets[0]) / 1e6:.1f} M parameters, "
        f"K1 {cn_call['flash_attention_fwd']} and K4 {cn_call['group_norm']} a call")
    RESULTS["sd15_controlnet"] = out
    del nets
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def run_sdxl_controlnets(smi: str, pipe):
    """Phase 24b: on phase 11's full-width SDXL pipeline, 1024 px, CFG 5.0,
    SDXL_CONTROLNET_FAMILY_STEPS Euler steps: ControlNet img2img (0.3) and inpaint (0.99) with
    SDXL_CONTROLNET (made on the card), then ControlNet-Union
    (xinsir/controlnet-union-sdxl-1.0's layout) text-to-image on the edge map
    (canny), img2img and inpaint at the same strengths, and two Union nets as
    a MultiControlNetUnionModel (canny on the edge map, depth on the image).
    Each step's launches are held to the modules' counts; the warm-ups of
    ControlNet inpaint and Union text-to-image are held to the plain routes
    on the card (`_plain_route_check`). Returns the launches by path."""
    import gc

    import torch

    from diffusers_tpu_torch.models.controlnets import ControlNetModel, ControlNetUnionModel
    from diffusers_tpu_torch.pipelines.controlnet import (
        StableDiffusionXLControlNetImg2ImgPipeline,
        StableDiffusionXLControlNetInpaintPipeline,
        StableDiffusionXLControlNetUnionImg2ImgPipeline,
        StableDiffusionXLControlNetUnionInpaintPipeline,
        StableDiffusionXLControlNetUnionPipeline,
    )
    from diffusers_tpu_torch.schedulers import EulerDiscreteScheduler

    torch.manual_seed(SEED + 12)
    with torch.device("cuda"):
        controlnet = ControlNetModel(**SDXL_CONTROLNET).to(torch.bfloat16)
    unet_call, encode, decode = (_module_launches(m) for m in (pipe.unet, pipe.vae.encoder, pipe.vae.decoder))
    image, mask, edges = synthetic_inputs(RESOLUTION)
    parts = {k: v for k, v in pipe.components.items() if k not in ("image_encoder", "feature_extractor")}
    out, paths = {}, {}

    steps_total = SDXL_CONTROLNET_FAMILY_STEPS

    def request(label, cls, net, steps, first_extra, **kwargs):
        pipeline = cls(**dict(parts, controlnet=net, scheduler=EulerDiscreteScheduler(**EULER)))
        nets = net if isinstance(net, list) else [net]
        cn_calls = [_module_launches(n) for n in nets]
        per_step = {k: unet_call[k] + sum(c[k] for c in cn_calls) for k in unet_call}
        images, record = _timed_request(
            smi, label, pipeline, steps, per_step, first_extra, decode, prompt=PROMPTS[0], guidance_scale=GUIDANCE,
            num_inference_steps=steps_total, generator=torch.Generator(device="cuda").manual_seed(SEED),
            output_type="pil", **kwargs)
        record.update(image_mean=_check_image(label, images, RESOLUTION), controlnet_parameters=_n_params(*nets))
        out[label], paths[label] = record, record["launches"]

    img2img_steps, inpaint_steps = int(steps_total * IMG2IMG_STRENGTH), int(steps_total * INPAINT_STRENGTH)
    request("sdxl_controlnet_img2img", StableDiffusionXLControlNetImg2ImgPipeline, controlnet, img2img_steps, encode,
            image=image, control_image=edges, strength=IMG2IMG_STRENGTH,
            controlnet_conditioning_scale=CONTROLNET_SCALE)
    request("sdxl_controlnet_inpaint", StableDiffusionXLControlNetInpaintPipeline, controlnet, inpaint_steps, encode,
            image=image, mask_image=mask, control_image=edges, strength=INPAINT_STRENGTH,
            controlnet_conditioning_scale=CONTROLNET_SCALE, plain_check=True)
    del controlnet
    gc.collect()
    torch.cuda.empty_cache()
    with torch.device("cuda"):
        unions = [_random_residuals(ControlNetUnionModel(**SDXL_UNION).to(torch.bfloat16), SEED + i)
                  for i in range(2)]
    union = dict(control_image=[edges], control_mode=[UNION_CANNY], controlnet_conditioning_scale=CONTROLNET_SCALE)
    request("union", StableDiffusionXLControlNetUnionPipeline, unions[0], steps_total, {}, plain_check=True, **union)
    request("union_img2img", StableDiffusionXLControlNetUnionImg2ImgPipeline, unions[0], img2img_steps, encode,
            image=image, strength=IMG2IMG_STRENGTH, **union)
    request("union_inpaint", StableDiffusionXLControlNetUnionInpaintPipeline, unions[0], inpaint_steps, encode,
            image=image, mask_image=mask, strength=INPAINT_STRENGTH, **union)
    request("multi_union", StableDiffusionXLControlNetUnionPipeline, unions, steps_total, {},
            control_image=[[edges], [image]], control_mode=[[UNION_CANNY], [UNION_DEPTH]],
            controlnet_conditioning_scale=[CONTROLNET_SCALE, CONTROLNET_SCALE])
    log(f"[controlnet] SDXL ControlNet-Union: {_n_params(unions[0]) / 1e9:.3f} B parameters a net")
    RESULTS["sdxl_controlnets"] = out
    del unions
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def run_sd3_controlnet(smi: str, pipe):
    """Phase 24c: the SD3 ControlNet on phase 16's SD3.5 Medium pipeline:
    the joint-block kind built by `SD3ControlNetModel.from_transformer`
    (SD3_CONTROLNET_LAYERS blocks, no extra conditioning channel), its
    residual projections and `pos_embed_input` random from SEED, through
    `StableDiffusion3ControlNetPipeline.__call__` at 1024 px, 28 steps, CFG
    7.0, from the synthetic image as the control image, its warm-up held to
    the plain routes on the card (`_plain_route_check`). Each step's launches
    are held to the transformer's and the ControlNet's module counts (the
    control image's VAE encode booked to the first step). Returns the
    launches by path."""
    import gc

    import torch

    from diffusers_tpu_torch.models.controlnets import SD3ControlNetModel
    from diffusers_tpu_torch.pipelines.controlnet_sd3 import StableDiffusion3ControlNetPipeline

    t0 = time.perf_counter()
    controlnet = _random_residuals(SD3ControlNetModel.from_transformer(
        pipe.transformer, num_layers=SD3_CONTROLNET_LAYERS, num_extra_conditioning_channels=0), SEED)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    pipeline = StableDiffusion3ControlNetPipeline(**pipe.components, controlnet=controlnet)
    per_step = {k: a + b for (k, a), b in zip(_module_launches(pipe.transformer).items(),
                                              _module_launches(controlnet).values())}
    image, _, _ = synthetic_inputs(RESOLUTION)
    images, record = _timed_request(
        smi, "sd3_controlnet", pipeline, SD3_STEPS, per_step, _module_launches(pipe.vae.encoder),
        _module_launches(pipe.vae.decoder), denoiser=pipe.transformer, plain_check=True, prompt=SD3_PROMPTS[0],
        control_image=image, controlnet_conditioning_scale=0.7, guidance_scale=SD3_GUIDANCE,
        num_inference_steps=SD3_STEPS, generator=torch.Generator(device="cuda").manual_seed(SEED), output_type="pil")
    record.update(image_mean=_check_image("sd3_controlnet", images, RESOLUTION),
                  controlnet_parameters=_n_params(controlnet), from_transformer_seconds=build_s)
    log(f"[controlnet] SD3 ControlNet by from_transformer ({SD3_CONTROLNET_LAYERS} blocks, "
        f"{record['controlnet_parameters'] / 1e9:.3f} B parameters) in {build_s:.2f} s")
    RESULTS["sd3_controlnet"] = record
    del pipeline, controlnet
    gc.collect()
    torch.cuda.empty_cache()
    return {"sd3_controlnet": record["launches"]}


def check_int8_routes():
    """Phase 5b: the per-tensor int8 routes (`ops/int8.py`) on K5's GEMM at
    INT8_ROUTE_CASES, bf16: each route held to its plain version (the same
    function without padding or im2col, the int8 sum exact in float64) bit
    for bit, with K5's skipped-K-tile control through the route failing;
    the route's time (quantization, im2col, GEMM, slice), its GEMM's alone,
    the plain version's, `torch._int_mm` + the same epilogue on the same
    int8 operands, and a bf16 `F.linear` / `F.conv2d` of the dequantized
    weight; the bound of the function (int8 operations at 1,979 TOP/s, or
    x read, the weight read and the output written at 3.35 TB/s)."""
    import torch
    import torch.nn.functional as F

    from diffusers_tpu_torch.ops import int8 as routes
    from diffusers_tpu_torch.quantizers import quantize_kernel_int8

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    out = []
    for label, kind, shape, n, ksize in INT8_ROUTE_CASES:
        x = (torch.randn(*shape, generator=gen, device=dev) * 2).to(torch.bfloat16)
        cin = shape[1]
        wshape = (n, cin) if kind == "linear" else (n, cin, ksize, ksize)
        fan_in = cin * (ksize or 1) ** 2
        weight, scale = quantize_kernel_int8(torch.randn(*wshape, generator=gen, device=dev) / fan_in ** 0.5)
        bias = (0.1 * torch.randn(n, generator=gen, device=dev)).to(torch.bfloat16)
        ops = routes.gemm_operands(weight, scale, bias)
        k = weight[0].numel()
        kp = ops[0][0].shape[1]
        if kind == "linear":
            route = lambda skip=-1: routes.int8_linear_per_tensor(x, ops, n, _skip_k_tile=skip)  # noqa: E731
            plain = lambda: routes.int8_linear_per_tensor_plain(x, weight, scale, bias)  # noqa: E731
            qx, s = routes.quantize_tensor(x)
            cols = qx
            m = shape[0]
            bf16 = (weight.float() * scale[:, None]).to(torch.bfloat16)
            library_bf16 = lambda: F.linear(x, bf16, bias)  # noqa: E731
        else:
            route = lambda skip=-1: routes.int8_conv2d(x, ops, n, (ksize, ksize), (1, 1), 1, (1, 1),  # noqa: E731
                                                       _skip_k_tile=skip)
            plain = lambda: routes.int8_conv2d_plain(x, weight, scale, bias, 1, 1, 1)  # noqa: E731
            qx, s = routes.quantize_tensor(x)
            cols, ho, wo = routes._im2col(qx, (ksize, ksize), (1, 1), (1, 1, 1, 1), (1, 1), kp)
            m = cols.shape[0]
            bf16 = (weight.float() * scale[:, None, None, None]).to(torch.bfloat16)
            library_bf16 = lambda: F.conv2d(x, bf16, bias, padding=1)  # noqa: E731
        y, ref = route(), plain()
        torch.cuda.synchronize()
        equal = bool(torch.equal(y, ref))
        ulp = bf16_ulp(ref)
        used = float(((y.float() - ref.float()).abs() / ulp).max())
        control = float(((route(skip=(kp // 64) // 2).float() - ref.float()).abs() / ulp).max())
        ms, plain_ms = time_pair(route, plain, iters=10, plain_iters=2)
        qw, ws, b = ops[0]
        ones = torch.ones(m, device=dev)
        gemm = lambda: routes.w8a8_matmul_2d(cols, qw, ones, s * ws, torch.bfloat16, b)  # noqa: E731
        int_mm = lambda: (torch._int_mm(cols, qw.t()).float() * (s * ws)).to(torch.bfloat16) + b  # noqa: E731
        gemm_ms, int_mm_ms, bf16_ms = time_ms(gemm, 10), time_ms(int_mm, 10), time_ms(library_bf16, 10)
        nbytes = 2 * x.numel() + weight.numel() + 4 * n + 2 * n + 2 * m * n
        bms, by = bound_ms(nbytes, 2.0 * m * n * k, PEAK_INT8_OPS)
        row = {"case": label, "m": m, "k": k, "n": n, "k_padded": kp, "n_padded": qw.shape[0], "bit_equal": equal,
               "max_ulps_vs_plain": used, "control_skipped_k_tile_max_ulps": control, "ms": ms, "plain_ms": plain_ms,
               "gemm_ms": gemm_ms, "int_mm_epilogue_ms": int_mm_ms, "bf16_library_ms": bf16_ms, "bound_ms": bms,
               "bound_by": by, "share_of_bound": bms / ms}
        out.append(row)
        log(f"[K5 route] {label}: M {m} K {k} (padded {kp}) N {n} (padded {qw.shape[0]}): bit-equal {equal} "
            f"({used:.2f} ulp; control {control:.1f} ulp); route {ms:.4f} ms ({100 * bms / ms:.1f}% of its bound "
            f"{bms:.4f}, {by}), its K5 GEMM {gemm_ms:.4f}, plain {plain_ms:.3f}, _int_mm+epilogue {int_mm_ms:.4f}, "
            f"bf16 {'F.linear' if kind == 'linear' else 'F.conv2d'} {bf16_ms:.4f}")
        if not (equal and torch.isfinite(y).all()):
            raise AssertionError(f"the int8 route disagrees with its plain version: {label}")
        if control <= 1.0:
            raise AssertionError(f"the route's limit does not reject a skipped K tile: {label}")
    RESULTS["int8_routes"] = out


def _small_q_unet_inputs(device, dtype):
    import numpy as np
    import torch

    rng = np.random.RandomState(SEED)
    sample = torch.from_numpy(rng.randn(2, 4, 16, 16).astype(np.float32))
    ehs = torch.from_numpy(rng.randn(2, 77, 64).astype(np.float32))
    cond = {"text_embeds": torch.from_numpy(rng.randn(2, 32).astype(np.float32)),
            "time_ids": torch.tensor([[128.0, 128, 0, 0, 128, 128]] * 2)}
    return (sample.to(device, dtype), torch.tensor([500, 500], device=device), ehs.to(device, dtype),
            {"text_embeds": cond["text_embeds"].to(device, dtype), "time_ids": cond["time_ids"].to(device)})


def _copy_model(model):
    """A copy of a port model (its own tensors, on its device, in its dtypes)."""
    import torch

    with torch.device("meta"):
        clone = type(model).from_config(model.config)
    clone.load_state_dict({k: v.clone() for k, v in model.state_dict().items()}, assign=True)
    return clone.eval()


def quantization_configs():
    """(label, config) of the four configs the port quantizes a UNet with."""
    from diffusers_tpu_torch.quantizers import Fp8WeightOnlyConfig, Int8DynamicActConfig, Int8WeightOnlyConfig

    return (("w8a8", Int8DynamicActConfig()), ("w8a8_xla", Int8DynamicActConfig(impl="xla")),
            ("int8_weight_only", Int8WeightOnlyConfig()), ("fp8_weight_only", Fp8WeightOnlyConfig()))


def check_small_family(device: str = "cuda"):
    """Phase 10i: the modules of this slice on small components, card
    (kernels) against CPU (plain versions; held to JAX by
    tests/test_torch_quantized_layers.py, test_torch_instruct_pix2pix.py and
    test_torch_lcm_tcd_upscale.py): SMALL_Q_UNET quantized by each of the
    four configs (`quantize_model`), one UNet call in bf16 on both sides,
    within SMALL_Q_TOL of the output's largest magnitude, K5's launches held
    to the modules' counts; then, card bf16 against CPU f32, InstructPix2Pix on SD
    and SDXL, the x4 upscaler (the noise level through the class-embedding
    table), LCM and TCD (eta 0.3) on small components, 4 steps, within phase
    7's 0.05 on the [0, 1] image. Both sides draw from one CPU generator
    seeded alike."""
    import numpy as np
    import torch

    from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
    from diffusers_tpu_torch.pipelines.latent_consistency_models import LatentConsistencyModelPipeline
    from diffusers_tpu_torch.pipelines.stable_diffusion import (
        StableDiffusionInstructPix2PixPipeline,
        StableDiffusionUpscalePipeline,
    )
    from diffusers_tpu_torch.pipelines.stable_diffusion_xl import StableDiffusionXLInstructPix2PixPipeline
    from diffusers_tpu_torch.pipelines.tcd import TCDPipeline
    from diffusers_tpu_torch.quantizers import quantize_model
    from diffusers_tpu_torch.schedulers import DDIMScheduler, DDPMScheduler, LCMScheduler, TCDScheduler

    results = {}
    torch.manual_seed(SEED)
    float_unet = UNet2DConditionModel(**SMALL_Q_UNET).eval()
    for label, config in quantization_configs():
        outs, launches = [], None
        for dev in ("cpu", device):  # bf16 on both sides: the kernels against their plain versions
            dtype = torch.bfloat16
            unet = quantize_model(_copy_model(float_unet).to(device=dev, dtype=dtype), config)
            reset_launches()
            with torch.no_grad():
                sample, t, ehs, cond = _small_q_unet_inputs(dev, dtype)
                outs.append(unet(sample, t, ehs, added_cond_kwargs=cond).sample.float().cpu())
            launches, expected = read_launches(), _module_launches(unet)
        ref, out = outs
        err, scale = float((out - ref).abs().max()), float(ref.abs().max())
        results[label] = {"max_abs_err": err, "ref_max": scale, "launches": launches}
        log(f"[ref-family] small UNet {label}, card vs CPU (bf16): max |diff| {err:.3e} (tol "
            f"{SMALL_Q_TOL * scale:.3e}); launches {launches}")
        if not (torch.isfinite(out).all() and err <= SMALL_Q_TOL * scale):
            raise AssertionError(f"small UNet {label}: the card disagrees with the CPU")
        if device == "cuda" and launches != expected:
            raise AssertionError(f"small UNet {label}: launches {launches}, the modules count {expected}")
        if label.startswith("w8a8") and device == "cuda" and launches["w8a8_matmul"] <= 0:
            raise AssertionError(f"small UNet {label} missed K5")

    image = synthetic_inputs(32)[0]
    low_res = synthetic_inputs(16)[0]
    sides = []
    for dev in ("cpu", device):
        sd = _build_sd(SMALL_SD_UNET, SMALL_VAE, SMALL_CLIP, "cpu", torch.float32)
        sdxl = _build_pipeline(SMALL_UNET, SMALL_VAE, SMALL_CLIP, SMALL_CLIP, "cpu", torch.float32)
        torch.manual_seed(SEED + 3)
        unet8 = UNet2DConditionModel(**dict(SMALL_SD_UNET, in_channels=8))
        unet8_xl = UNet2DConditionModel(**dict(SMALL_UNET, in_channels=8))
        lcm_unet = UNet2DConditionModel(**dict(SMALL_SD_UNET, time_cond_proj_dim=32))
        up_unet = UNet2DConditionModel(**dict(SMALL_SD_UNET, in_channels=7, num_class_embeds=1000,
                                              only_cross_attention=(True, False), use_linear_projection=True))
        parts = dict(sd.components, device="cpu")
        pipes = {
            "sd_instruct_pix2pix": StableDiffusionInstructPix2PixPipeline(**dict(parts, unet=unet8)),
            "sdxl_instruct_pix2pix": StableDiffusionXLInstructPix2PixPipeline(
                **dict(sdxl.components, unet=unet8_xl, device="cpu")),
            "upscale": StableDiffusionUpscalePipeline(sd.vae, sd.text_encoder, sd.tokenizer, up_unet,
                                                      DDPMScheduler(**UPSCALE_DDPM), DDIMScheduler(**UPSCALE_DDIM),
                                                      device="cpu"),
            "lcm": LatentConsistencyModelPipeline(**dict(parts, unet=lcm_unet,
                                                         scheduler=LCMScheduler(**LCM_SCHEDULER))),
            "tcd": TCDPipeline(**dict(parts, scheduler=TCDScheduler(**LCM_SCHEDULER))),
        }
        for pipe in pipes.values():
            pipe.to(device=torch.device(dev), dtype=torch.float32 if not sides else torch.bfloat16)
        sides.append(pipes)
    cases = (("sd_instruct_pix2pix", dict(image=image, guidance_scale=7.5, image_guidance_scale=1.5)),
             ("sdxl_instruct_pix2pix", dict(image=image, guidance_scale=5.0, image_guidance_scale=1.5)),
             ("upscale", dict(image=low_res, guidance_scale=9.0, noise_level=UPSCALE_NOISE_LEVEL)),
             ("lcm", dict(guidance_scale=LCM_GUIDANCE)),
             ("tcd", dict(eta=TCD_ETA)))
    for label, kwargs in cases:
        images, launches = [], None
        for pipes in sides:
            reset_launches()
            images.append(pipes[label](SD15_PROMPT, num_inference_steps=4, output_type="np",
                                       generator=torch.Generator().manual_seed(SEED), **kwargs).images)
            launches = read_launches()
        ref, out = images
        err = float(np.abs(out - ref).max())
        results[label] = {"max_abs_err": err, "tol": 0.05, "launches": launches, "shape": list(out.shape)}
        log(f"[ref-family] small {label} {out.shape}, card bf16 vs CPU f32: max |diff| {err:.3e} (tol 0.05); "
            f"launches {launches}")
        if not (out.shape == ref.shape and np.isfinite(out).all() and err <= 0.05):
            raise AssertionError(f"small {label}: the card disagrees with the CPU")
        if device == "cuda" and min(launches["flash_attention_fwd"], launches["group_norm"]) <= 0:
            raise AssertionError(f"small {label} on the card missed a kernel: {launches}")
    RESULTS["small_family"] = results


def _weight_bytes(module) -> int:
    return sum(t.numel() * t.element_size() for t in (*module.parameters(), *module.buffers()))


def run_sdxl_w8a8(smi: str, pipe, dense_image):
    """Phase 12d: SDXL at 1024 px (STEPS steps, CFG 5.0, PROMPTS[0], SEED:
    phase 11's request) with a copy of phase 11's UNet quantized by
    `Int8DynamicActConfig()` (`quantize_model`): SDXL_W8A8_LINEARS per-row
    Linears on K5 with its row quantization and SDXL_INT8_CONVS int8 convs
    on K5's GEMM through the per-tensor route; each step's launches held to
    the modules' counts (K1 140, K4 46, K5 171 a step), its time, its peak
    memory with phase 11's bf16 UNet moved off the card, the UNet's weight
    bytes against bf16, and the image's cosine against phase 11's. Then one
    UNet call at b=2 each under `impl="xla"`, `Int8WeightOnlyConfig` and
    `Fp8WeightOnlyConfig` (and w8a8), timed on CUDA events, with its weight
    bytes, launches and cosine against the bf16 UNet's output."""
    import gc

    import numpy as np
    import torch

    from diffusers_tpu_torch.ops.module import Int8Conv2d, W8A8Linear
    from diffusers_tpu_torch.pipelines.stable_diffusion_xl import StableDiffusionXLPipeline
    from diffusers_tpu_torch.quantizers import quantize_model, quantized_module_names

    float_unet = pipe.unet
    dev = torch.device("cuda")
    sample = torch.randn(2, 4, 128, 128, device=dev, dtype=torch.bfloat16,
                         generator=torch.Generator(device=dev).manual_seed(SEED))
    ehs = torch.randn(2, 77, 2048, device=dev, dtype=torch.bfloat16)
    cond = {"text_embeds": torch.randn(2, 1280, device=dev, dtype=torch.bfloat16),
            "time_ids": torch.tensor([[1024, 1024, 0, 0, 1024, 1024]] * 2, device=dev, dtype=torch.float32)}
    t = torch.tensor(500.0, device=dev)
    with torch.no_grad():
        dense_out = float_unet(sample, t, ehs, added_cond_kwargs=cond).sample.float()
    bf16_bytes = _weight_bytes(float_unet)
    out = {"card": smi, "unet_bf16_weight_gb": bf16_bytes / 1e9}
    calls = {}
    for label, config in quantization_configs():
        names = quantized_module_names(float_unet, config)
        unet = quantize_model(_copy_model(float_unet), config)
        kinds = {}
        for m in unet.modules():
            kinds[type(m).__name__] = kinds.get(type(m).__name__, 0) + 1
        launches_per_call = _module_launches(unet)
        reset_launches()
        with torch.no_grad():
            y = unet(sample, t, ehs, added_cond_kwargs=cond).sample.float()
            got = read_launches()
            ms = time_ms(lambda: unet(sample, t, ehs, added_cond_kwargs=cond), iters=5)
        cos = float(torch.nn.functional.cosine_similarity(y.flatten(), dense_out.flatten(), dim=0))
        wbytes = _weight_bytes(unet)
        calls[label] = {"quantized_layers": len(names), "unet_forward_b2_ms": ms, "weight_gb": wbytes / 1e9,
                        "launches": got, "cosine_vs_bf16": cos,
                        "layers": {k: v for k, v in kinds.items() if k in ("W8A8Linear", "Int8PerTensorLinear",
                                                                           "Int8Conv2d", "WeightOnlyLinear")}}
        log(f"[sdxl-quant] {smi}: UNet {label}: {len(names)} layers quantized {calls[label]['layers']}, weights "
            f"{wbytes / 1e9:.3f} GB (bf16 {bf16_bytes / 1e9:.3f}), forward b=2 {ms:.2f} ms (CUDA events), launches "
            f"{got}, cosine vs bf16 {cos:.5f}")
        if got != launches_per_call or not torch.isfinite(y).all() or cos < 0.9:
            raise AssertionError(f"SDXL UNet {label}: launches {got} (the modules count {launches_per_call}), "
                                 f"cosine {cos}")
        if label == "w8a8":
            n_lin = sum(isinstance(m, W8A8Linear) for m in unet.modules())
            n_conv = sum(isinstance(m, Int8Conv2d) for m in unet.modules())
            if (n_lin, n_conv) != (SDXL_W8A8_LINEARS, SDXL_INT8_CONVS) or got["w8a8_matmul"] != n_lin + n_conv:
                raise AssertionError(f"SDXL w8a8: {n_lin} Linears and {n_conv} convs, K5 {got['w8a8_matmul']}")
            w8a8_unet = unet
        else:
            del unet
        gc.collect()
        torch.cuda.empty_cache()
    out["unet_calls"] = calls

    # the request, with phase 11's bf16 UNet off the card
    float_unet.to("cpu")
    gc.collect()
    torch.cuda.empty_cache()
    wpipe = StableDiffusionXLPipeline(**dict(pipe.components, unet=w8a8_unet))
    wpipe(PROMPTS[0], height=RESOLUTION, width=RESOLUTION, num_inference_steps=2, guidance_scale=GUIDANCE,
          output_type="latent", generator=torch.Generator(device="cuda").manual_seed(SEED))  # warm-up
    resident_gb = torch.cuda.memory_allocated() / 1e9
    per_step = _module_launches(w8a8_unet)
    images, seconds, peak_gb, launches = _held_request(
        smi, "sdxl_w8a8", wpipe, STEPS, per_step, {}, _module_launches(pipe.vae.decoder), prompt=PROMPTS[0],
        height=RESOLUTION, width=RESOLUTION, num_inference_steps=STEPS, guidance_scale=GUIDANCE,
        generator=torch.Generator(device="cuda").manual_seed(SEED), output_type="pil")
    image = np.asarray(images[0])
    cos = _image_cosine(image, dense_image)
    out["request"] = {"seconds_per_request": seconds, "steps": STEPS, "peak_memory_gb": peak_gb,
                      "resident_gb_before": resident_gb, "launches": launches, "per_step": per_step,
                      "image_cosine_vs_bf16": cos, "dense_seconds_per_request": RESULTS["pipeline"][
                          "seconds_per_request"][0], "dense_peak_memory_gb": RESULTS["pipeline"]["peak_memory_gb"]}
    log(f"[sdxl-w8a8] {smi}: {seconds:.3f} s/request ({STEPS} steps; bf16 phase 11: "
        f"{RESULTS['pipeline']['seconds_per_request'][0]:.3f}), peak {peak_gb:.2f} GB (bf16 phase 11: "
        f"{RESULTS['pipeline']['peak_memory_gb']:.2f}), K1 {per_step['flash_attention_fwd']}, K4 "
        f"{per_step['group_norm']}, K5 {per_step['w8a8_matmul']} ({per_step['w8a8_quantize_rows']} row "
        f"quantizations) a step; image cosine vs bf16 {cos:.5f}")
    if image.shape != (RESOLUTION, RESOLUTION, 3) or cos < 0.9:
        raise AssertionError(f"SDXL w8a8: image {image.shape}, cosine {cos}")
    del wpipe, w8a8_unet
    gc.collect()
    torch.cuda.empty_cache()
    float_unet.to("cuda")
    RESULTS["sdxl_w8a8"] = out
    return {"sdxl_w8a8": launches}


def run_sdxl_ip2p(smi: str, pipe):
    """Phase 12e: SDXL InstructPix2Pix at 768 px (IP2P_STEPS steps of 100, a
    batch-3 UNet call a step) with an 8-channel SDXL UNet made from a seed on
    phase 11's VAE and text towers; each step's launches held to the UNet's
    module counts (the VAE encode booked to the first step)."""
    import gc

    import numpy as np
    import torch

    from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
    from diffusers_tpu_torch.pipelines.stable_diffusion_xl import StableDiffusionXLInstructPix2PixPipeline

    torch.manual_seed(SEED + 7)
    with torch.device("cuda"):
        unet8 = UNet2DConditionModel(**dict(SDXL_UNET, in_channels=8)).to(torch.bfloat16)
    ip2p = StableDiffusionXLInstructPix2PixPipeline(**dict(pipe.components, unet=unet8))
    image = synthetic_inputs(IP2P_RESOLUTION_XL)[0]
    kwargs = dict(prompt=PROMPTS[1], image=image, guidance_scale=IP2P_GUIDANCE,
                  image_guidance_scale=IP2P_IMAGE_GUIDANCE)
    ip2p(**kwargs, num_inference_steps=2, output_type="latent")  # warm-up
    images, seconds, peak_gb, launches = _held_request(
        smi, "sdxl_instruct_pix2pix", ip2p, IP2P_STEPS, _module_launches(unet8), _module_launches(pipe.vae.encoder),
        _module_launches(pipe.vae.decoder), num_inference_steps=IP2P_STEPS, output_type="pil", **kwargs)
    result = np.asarray(images[0])
    if result.shape != (IP2P_RESOLUTION_XL, IP2P_RESOLUTION_XL, 3):
        raise AssertionError(f"SDXL InstructPix2Pix: bad image {result.shape}")
    RESULTS["sdxl_instruct_pix2pix"] = {"card": smi, "seconds_per_request": seconds, "steps": IP2P_STEPS,
                                        "published_steps": 100, "peak_memory_gb": peak_gb, "launches": launches,
                                        "resolution": IP2P_RESOLUTION_XL}
    del ip2p, unet8
    gc.collect()
    torch.cuda.empty_cache()
    return {"sdxl_instruct_pix2pix": launches}


def run_sd15_family(smi: str, pipe):
    """Phase 23b, on phase 23's SD 1.5 components: InstructPix2Pix at 512 px,
    LCM at 768 px, TCD at 512 px and the x4 upscaler from 128 to 512 px, at
    the published widths (made from a seed, bf16), each request warmed up
    once at fewer steps, then held step by step to the modules' counts (K4
    in every UNet call; K1 0 at SD 1.5's heads, and in the upscaler's UNet at
    its heads of 64 and 128). Returns the launches by path."""
    import gc

    import numpy as np
    import torch

    from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
    from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel
    from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
    from diffusers_tpu_torch.pipelines.latent_consistency_models import LatentConsistencyModelPipeline
    from diffusers_tpu_torch.pipelines.stable_diffusion import (
        StableDiffusionInstructPix2PixPipeline,
        StableDiffusionUpscalePipeline,
    )
    from diffusers_tpu_torch.pipelines.tcd import TCDPipeline
    from diffusers_tpu_torch.schedulers import (
        DDIMScheduler,
        DDPMScheduler,
        EulerDiscreteScheduler,
        LCMScheduler,
        TCDScheduler,
    )

    out, paths = {}, {}
    decode = _module_launches(pipe.vae.decoder)

    def request(label, pipeline, steps, size, first_extra, after, published, warm_steps=2, **kwargs):
        pipeline(SD15_PROMPT, num_inference_steps=warm_steps, output_type="latent",
                 generator=torch.Generator(device="cuda").manual_seed(SEED), **kwargs)
        images, seconds, peak_gb, launches = _held_request(
            smi, label, pipeline, steps, _module_launches(pipeline.unet), first_extra, after, prompt=SD15_PROMPT,
            num_inference_steps=steps, output_type="pil", generator=torch.Generator(device="cuda").manual_seed(SEED),
            **kwargs)
        result = np.asarray(images[0])
        if result.shape != (size, size, 3) or result.dtype != np.uint8:
            raise AssertionError(f"{label}: bad uint8 image {result.shape} {result.dtype}")
        out[label] = {"card": smi, "seconds_per_request": seconds, "peak_memory_gb": peak_gb, "steps": steps,
                      "published_steps": published, "launches": launches, "image_mean": float(result.mean()),
                      "per_step": _module_launches(pipeline.unet)}
        paths[label] = launches

    image = synthetic_inputs(SD15_RESOLUTION)[0]
    torch.manual_seed(SEED + 8)
    with torch.device("cuda"):
        unet8 = UNet2DConditionModel(**dict(SD15_UNET, in_channels=8)).to(torch.bfloat16)
    ip2p = StableDiffusionInstructPix2PixPipeline(**dict(pipe.components, unet=unet8,
                                                         scheduler=EulerDiscreteScheduler(**EULER)))
    request("sd15_instruct_pix2pix", ip2p, IP2P_STEPS, SD15_RESOLUTION, _module_launches(pipe.vae.encoder), decode,
            100, image=image, guidance_scale=SD15_GUIDANCE, image_guidance_scale=IP2P_IMAGE_GUIDANCE)
    del ip2p, unet8
    gc.collect()
    torch.cuda.empty_cache()

    torch.manual_seed(SEED + 9)
    with torch.device("cuda"):
        lcm_unet = UNet2DConditionModel(**LCM_UNET).to(torch.bfloat16)
    lcm = LatentConsistencyModelPipeline(**dict(pipe.components, unet=lcm_unet,
                                                scheduler=LCMScheduler(**LCM_SCHEDULER)))
    request("sd15_lcm", lcm, LCM_STEPS, LCM_RESOLUTION, {}, decode, 4, warm_steps=1, height=LCM_RESOLUTION,
            width=LCM_RESOLUTION, guidance_scale=LCM_GUIDANCE)
    del lcm, lcm_unet
    gc.collect()
    torch.cuda.empty_cache()

    tcd = TCDPipeline(**dict(pipe.components, scheduler=TCDScheduler(**LCM_SCHEDULER)))
    request("sd15_tcd", tcd, TCD_STEPS, SD15_RESOLUTION, {}, decode, 4, warm_steps=1, eta=TCD_ETA)

    torch.manual_seed(SEED + 10)
    with torch.device("cuda"):
        up_unet = UNet2DConditionModel(**UPSCALE_UNET)
        up_vae = AutoencoderKL(**UPSCALE_VAE)
        up_text = CLIPTextModel(**CLIP_H_TEXT)
    n_params = {k: sum(p.numel() for p in m.parameters()) for k, m in
                (("unet", up_unet), ("vae", up_vae), ("text_encoder", up_text))}
    upscale = StableDiffusionUpscalePipeline(up_vae, up_text, pipe.tokenizer, up_unet, DDPMScheduler(**UPSCALE_DDPM),
                                             DDIMScheduler(**UPSCALE_DDIM)).to(dtype=torch.bfloat16)
    low_res = synthetic_inputs(UPSCALE_LOW_RES)[0]
    request("sd_x4_upscale", upscale, UPSCALE_STEPS, 4 * UPSCALE_LOW_RES, {}, _module_launches(up_vae.decoder), 75,
            image=low_res, guidance_scale=UPSCALE_GUIDANCE, noise_level=UPSCALE_NOISE_LEVEL)
    out["sd_x4_upscale"]["parameters"] = n_params
    log(f"[sd-family] {smi}: x4 upscaler parameters {n_params}")
    del upscale, up_unet, up_vae, up_text
    gc.collect()
    torch.cuda.empty_cache()
    RESULTS["sd15_family"] = out
    return paths


def _guidance_cases():
    """Phase 10j's small pipelines (label, pipeline name, guidance scale, request kwargs)."""
    import numpy as np
    import torch

    image, mask, edges = synthetic_inputs(32)
    latents = torch.from_numpy(np.random.RandomState(SEED).randn(1, 4, 16, 16).astype(np.float32))
    latents16 = torch.from_numpy(np.random.RandomState(SEED).randn(1, 16, 16, 16).astype(np.float32))
    sd3 = dict(max_sequence_length=16, pag_applied_layers=r"transformer_blocks\.1")
    return (
        ("sdxl_pag", "sdxl", GUIDANCE, dict(latents=latents, pag_scale=PAG_SCALE)),
        ("sdxl_pag_img2img", "sdxl_img2img", GUIDANCE, dict(image=image, strength=0.6, pag_scale=PAG_SCALE)),
        ("sdxl_pag_inpaint_9ch", "sdxl_inpaint_9ch", GUIDANCE, dict(image=image, mask_image=mask, pag_stop=0.5)),
        ("sd_pag", "sd", SD15_GUIDANCE, dict(latents=latents, pag_scale=PAG_SCALE)),
        ("sd_pag_img2img", "sd_img2img", SD15_GUIDANCE, dict(image=image, strength=0.6, pag_start=0.3)),
        ("sd_pag_inpaint_9ch", "sd_inpaint_9ch", SD15_GUIDANCE, dict(image=image, mask_image=mask)),
        ("sd3_pag", "sd3", SD3_GUIDANCE, dict(sd3, latents=latents16, pag_scale=PAG_SCALE)),
        ("sd3_pag_img2img", "sd3_img2img", SD3_GUIDANCE, dict(sd3, image=image, strength=0.6)),
        ("sd_controlnet_pag", "sd_controlnet", SD15_GUIDANCE,
         dict(image=edges, latents=latents, controlnet_conditioning_scale=0.8)),
        ("sd_controlnet_pag_inpaint", "sd_controlnet_inpaint", SD15_GUIDANCE,
         dict(image=image, mask_image=mask, control_image=edges)),
        ("sdxl_controlnet_pag", "sdxl_controlnet", GUIDANCE,
         dict(image=edges, latents=latents, controlnet_conditioning_scale=0.5, pag_applied_layers=["mid", "up"])),
        ("sdxl_controlnet_pag_img2img", "sdxl_controlnet_img2img", GUIDANCE,
         dict(image=image, control_image=edges, strength=0.6)),
        ("sdxl_freeu", "sdxl_freeu", GUIDANCE, dict(latents=latents)),
    )


def _guidance_pipelines():
    """Phase 10j's pipelines on the CPU in float32, by name: the twelve PAG
    pipelines on phase 10b's SDXL, phase 10g's SD and phase 10c's SD3.5
    components (9-channel UNets and small ControlNets from SEED + 4), and
    the SDXL pipeline that takes FreeU."""
    import torch

    from diffusers_tpu_torch.models.controlnets import ControlNetModel
    from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
    from diffusers_tpu_torch.pipelines import pag

    sd = _build_sd(SMALL_SD_UNET, SMALL_VAE, SMALL_CLIP, "cpu", torch.float32)
    sdxl = _build_pipeline(SMALL_UNET, SMALL_VAE, SMALL_CLIP, SMALL_CLIP, "cpu", torch.float32)
    sd3 = _build_sd3_pipeline(SMALL_SD35, SMALL_SD3_VAE, SMALL_SD3_CLIP, SMALL_SD3_CLIP, SMALL_T5, "cpu",
                              torch.float32)
    torch.manual_seed(SEED + 4)
    xl9, sd9 = (UNet2DConditionModel(**dict(cfg, in_channels=9)) for cfg in (SMALL_UNET, SMALL_SD_UNET))
    xl_net, sd_net = ControlNetModel(**SMALL_CONTROLNET), ControlNetModel(**SMALL_SD_CONTROLNET)
    xl, s, s3 = (dict(p.components, device="cpu") for p in (sdxl, sd, sd3))
    return {
        "sdxl": pag.StableDiffusionXLPAGPipeline(**xl),
        "sdxl_img2img": pag.StableDiffusionXLPAGImg2ImgPipeline(**xl),
        "sdxl_inpaint_9ch": pag.StableDiffusionXLPAGInpaintPipeline(**dict(xl, unet=xl9)),
        "sd": pag.StableDiffusionPAGPipeline(**s),
        "sd_img2img": pag.StableDiffusionPAGImg2ImgPipeline(**s),
        "sd_inpaint_9ch": pag.StableDiffusionPAGInpaintPipeline(**dict(s, unet=sd9)),
        "sd3": pag.StableDiffusion3PAGPipeline(**s3),
        "sd3_img2img": pag.StableDiffusion3PAGImg2ImgPipeline(**s3),
        "sd_controlnet": pag.StableDiffusionControlNetPAGPipeline(**s, controlnet=sd_net),
        "sd_controlnet_inpaint": pag.StableDiffusionControlNetPAGInpaintPipeline(**s, controlnet=sd_net),
        "sdxl_controlnet": pag.StableDiffusionXLControlNetPAGPipeline(**xl, controlnet=xl_net),
        "sdxl_controlnet_img2img": pag.StableDiffusionXLControlNetPAGImg2ImgPipeline(**xl, controlnet=xl_net),
        "sdxl_freeu": type(sdxl)(**xl),
    }


GUIDER_CONFIGS = (  # phase 10j: each guider at a step inside its window, with guidance_rescale where it reads one
    ("ClassifierFreeGuidance", dict(guidance_scale=6.0, guidance_rescale=0.4)),
    ("ClassifierFreeZeroStarGuidance", dict(guidance_scale=5.0, zero_init_steps=1, guidance_rescale=0.3)),
    ("AdaptiveProjectedGuidance", dict(guidance_scale=7.0, eta=0.6, adaptive_projected_guidance_rescale=4.0)),
    ("AdaptiveProjectedMixGuidance", dict(adaptive_projected_guidance_start_step=1, guidance_rescale=0.2)),
    ("AutoGuidance", dict(guidance_scale=4.0, auto_guidance_layers=[1], guidance_rescale=0.5)),
    ("FrequencyDecoupledGuidance", dict(guidance_scales=(9.0, 4.0), parallel_weights=(1.0, 0.5))),
    ("MagnitudeAwareGuidance", dict(guidance_scale=9.0, alpha=2.0, guidance_rescale=0.3)),
    ("PerturbedAttentionGuidance", dict(perturbed_guidance_scale=2.0, perturbed_guidance_start=0.0)),
    ("SkipLayerGuidance", dict(skip_layer_guidance_scale=3.0, skip_layer_guidance_start=0.0)),
    ("SmoothedEnergyGuidance", dict(seg_guidance_scale=2.5, guidance_rescale=0.3)),
    ("TangentialClassifierFreeGuidance", dict(guidance_scale=5.0, guidance_rescale=0.3)),
)


def check_small_guidance(device: str = "cuda"):
    """Phase 10j: the guidance modules on small components, card (bf16,
    kernels) against CPU (f32, plain versions; held to JAX by
    tests/test_torch_pag*.py, test_torch_guiders.py and
    test_torch_freeu.py): the twelve PAG pipelines and an SDXL request with
    FreeU, 4 steps, within phase 7's 0.05 on the [0, 1] image, each on the
    card launching K1 and K4; a small SDXL UNet call under SEG (the mid
    block's self-attentions, sigma 3 over a 4 x 4 grid: a pad wider than the
    grid) and a small SD3.5-style transformer call under Skip Layer Guidance
    (block 1), within GUIDANCE_MODEL_TOL of the reference's largest value;
    each guider on the card on bf16 predictions against the CPU in f32, within
    the same share. Both sides draw from one CPU generator seeded alike."""
    import numpy as np
    import torch

    from diffusers_tpu_torch import guiders

    sides = []
    for dev in ("cpu", device):
        pipes = _guidance_pipelines()
        for pipe in pipes.values():
            pipe.to(device=torch.device(dev), dtype=torch.float32 if not sides else torch.bfloat16)
        sides.append(pipes)
    results, tol = {}, 0.05  # phase 7's
    for label, name, guidance, kwargs in _guidance_cases():
        images, launches = [], None
        for pipes in sides:  # the CPU, then the card
            pipe = pipes[name]
            if name == "sdxl_freeu":  # on the UNet the SDXL PAG pipelines share: off again after the request
                pipe.enable_freeu(**SDXL_FREEU)
            reset_launches()
            try:
                images.append(pipe(PROMPTS[0], num_inference_steps=4, guidance_scale=guidance, output_type="np",
                                   generator=torch.Generator().manual_seed(SEED), **kwargs).images)
            finally:
                if name == "sdxl_freeu":
                    pipe.disable_freeu()
            launches = read_launches()
        ref, out = images
        err = float(np.abs(out - ref).max())
        results[label] = {"max_abs_err": err, "mean_abs_err": float(np.abs(out - ref).mean()), "tol": tol,
                          "launches": launches}
        log(f"[ref-guidance] small {label}, card bf16 vs CPU f32: max |diff| {err:.3e} (tol {tol}); launches "
            f"{launches}")
        if not (out.shape == ref.shape == (1, 32, 32, 3) and np.isfinite(out).all() and err <= tol):
            raise AssertionError(f"small {label}: the card disagrees with the CPU")
        if device == "cuda" and min(launches["flash_attention_fwd"], launches["group_norm"]) <= 0:
            raise AssertionError(f"small {label} on the card missed a kernel: {launches}")

    def compare(label, outs):
        ref, out = (o.float().cpu() for o in outs)
        err, scale = float((out - ref).abs().max()), float(ref.abs().max())
        results[label] = {"max_abs_err": err, "ref_max": scale, "tol": GUIDANCE_MODEL_TOL * scale}
        log(f"[ref-guidance] {label}, card bf16 vs CPU f32: max |diff| {err:.3e} "
            f"(tol {GUIDANCE_MODEL_TOL * scale:.3e})")
        if not (torch.isfinite(out).all() and err <= GUIDANCE_MODEL_TOL * scale):
            raise AssertionError(f"{label}: the card disagrees with the CPU")

    rng = np.random.RandomState(SEED)
    sample, ehs = rng.randn(1, 4, 16, 16).astype(np.float32), rng.randn(1, 77, 64).astype(np.float32)
    text_embeds = rng.randn(1, 32).astype(np.float32)
    latents, embeds = rng.randn(1, 16, 16, 16).astype(np.float32), rng.randn(1, 24, 256).astype(np.float32)
    pooled = rng.randn(1, 128).astype(np.float32)
    seg, slg = [], []
    for pipes in sides:
        unet, tr = pipes["sdxl"].unet, pipes["sd3"].transformer
        dev, dtype = unet.device, unet.dtype

        def t(x):
            return torch.from_numpy(x).to(device=dev, dtype=dtype)

        cond = {"text_embeds": t(text_embeds),
                "time_ids": torch.tensor([[32, 32, 0, 0, 32, 32]], device=dev, dtype=torch.float32)}
        with torch.no_grad():
            with guiders.seg_blurred(guiders.select_pag_layers(unet, "mid"), SEG_SIGMA):
                seg.append(unet(t(sample), torch.tensor(500.0, device=dev), t(ehs), added_cond_kwargs=cond).sample)
            with guiders.layers_skipped(guiders.select_skip_blocks(tr, [1])):
                slg.append(tr(t(latents), t(embeds), t(pooled), torch.tensor([500.0], device=dev)).sample)
    compare("sdxl_unet_seg", seg)
    compare("sd3_transformer_slg", slg)
    preds = [rng.randn(2, 4, 16, 16).astype(np.float32) for _ in range(3)]
    for name, config in GUIDER_CONFIGS:
        guider = getattr(guiders, name)(**config)
        n = guider.num_conditions
        compare(f"guider_{name}", [guider(*(torch.from_numpy(p).to(device=d, dtype=dt) for p in preds[:n]), step=2,
                                          num_steps=4) for d, dt in (("cpu", torch.float32), (device, torch.bfloat16))])
    RESULTS["small_guidance"] = results


def _guided_request(smi, label, pipeline, denoiser, expected, after, warmup_steps=PAG_WARMUP_STEPS, **kwargs):
    """One request after a warm-up of `warmup_steps` steps (each with its own
    generator seeded with SEED): its host seconds ending in a synchronise,
    its peak memory, each denoiser call on CUDA events by its batch size
    (the CFG pair at b=2, PAG's perturbed call at b=1), each step's launches
    held to `expected` (one dict a step) and the decode's to `after`, the
    latents entering the decode finite. Returns (images, record)."""
    import numpy as np
    import torch

    pipeline(**dict(kwargs, num_inference_steps=warmup_steps, output_type="latent",
                    generator=torch.Generator(device="cuda").manual_seed(SEED)))
    latents_seen = []
    hook = pipeline.vae.decoder.register_forward_pre_hook(lambda m, a: latents_seen.append(a[0]))
    reset_launches()
    try:
        with StepLaunches(pipeline, denoiser) as counted, CudaSpans(modules={"denoiser": denoiser}) as spans:
            images, seconds, peak_gb = _request_seconds(lambda: pipeline(
                generator=torch.Generator(device="cuda").manual_seed(SEED), **kwargs).images)
    finally:
        hook.remove()
    launches = read_launches()
    by_batch = {}
    for batch, ms in zip(counted.batches, spans.ms()["denoiser"]):
        by_batch.setdefault(f"b{batch}", []).append(ms)
    if not latents_seen or not all(bool(torch.isfinite(z).all()) for z in latents_seen):
        raise AssertionError(f"{label}: non-finite latents")
    _check_steps(label, counted.per_step, expected, counted.after, after)
    call_ms = {b: float(np.mean(v)) for b, v in sorted(by_batch.items())}
    calls = {b: len(v) for b, v in sorted(by_batch.items())}
    per_step = counted.per_step[0]
    log(f"[guidance] {smi}: {label}: {seconds:.3f} s/request (host clock), {len(expected)} steps, peak "
        f"{peak_gb:.1f} GB; denoiser calls {calls}, mean ms a call {call_ms} (CUDA events); K1 "
        f"{per_step['flash_attention_fwd']} and K4 {per_step['group_norm']} at step 0, as the modules count; "
        f"launches {launches}")
    return images, {"card": smi, "seconds_per_request": seconds, "peak_memory_gb": peak_gb, "steps": len(expected),
                    "launches": launches, "launches_per_step": counted.per_step, "denoiser_calls": calls,
                    "denoiser_call_ms": call_ms}


def _perturbed_launches(call, layers):
    """The launches of a PAG-perturbed call: `call`'s, less K1 for each
    self-attention of `layers` (turned identities) at a head dim K1 takes."""
    from diffusers_tpu_torch.ops.cuda.flash_attention import HEAD_DIMS

    return dict(call, flash_attention_fwd=call["flash_attention_fwd"] - sum(m.dim_head in HEAD_DIMS for m in layers))


def _uint8_mean_diff(a, b) -> float:
    import numpy as np

    return float(np.abs(np.asarray(a).astype(np.float64) - np.asarray(b).astype(np.float64)).mean())


def run_sdxl_guidance(smi: str, pipe, controlnet, dense_image):
    """Phase 25a: guidance at SDXL's full width on phase 11's pipeline, 1024
    px, CFG 5.0: the dense request again (warm, the PAG request's
    baseline), then `StableDiffusionXLPAGPipeline.from_pipe` (30 steps,
    pag_scale 3.0, "mid": K1 270 and K4 92 a step), a PAG img2img request at
    phase 12b's strength (9 steps, the VAE encode booked to the first), a
    PAG ControlNet request on phase 12b's ControlNet (PAG_CONTROLNET_STEPS
    steps), a FreeU request (SDXL_FREEU, 30 steps, K1 140 and K4 46 a step),
    and one UNet call at b=1 under SEG (the mid block's 10 self-attentions
    at sigma 3: K1 takes the blurred queries) beside a plain one. Each
    request warms up for PAG_WARMUP_STEPS steps first; its b=2 and b=1 UNet
    calls are timed apart on CUDA events. Returns the launches by path."""
    import numpy as np
    import torch

    from diffusers_tpu_torch.guiders import seg_blurred, select_pag_layers
    from diffusers_tpu_torch.pipelines.pag import (
        StableDiffusionXLControlNetPAGPipeline,
        StableDiffusionXLPAGImg2ImgPipeline,
        StableDiffusionXLPAGPipeline,
    )

    unet = pipe.unet
    unet_call, encode, decode = (_module_launches(m) for m in (unet, pipe.vae.encoder, pipe.vae.decoder))
    identities = select_pag_layers(unet, "mid")
    pag_step = _sum_launches((1, unet_call), (1, _perturbed_launches(unet_call, identities)))
    if {k: pag_step[k] for k in SDXL_PAG_STEP} != SDXL_PAG_STEP:
        raise AssertionError(f"an SDXL PAG step counts {pag_step}, expected {SDXL_PAG_STEP}")
    image, _, edges = synthetic_inputs(RESOLUTION)
    common = dict(prompt=PROMPTS[0], guidance_scale=GUIDANCE, output_type="pil")
    out, paths = {}, {}

    _, dense = _guided_request(smi, "sdxl_dense", pipe, unet, [unet_call] * STEPS, decode, num_inference_steps=STEPS,
                               height=RESOLUTION, width=RESOLUTION, **common)
    images, rec = _guided_request(smi, "sdxl_pag", StableDiffusionXLPAGPipeline.from_pipe(pipe), unet,
                                  [pag_step] * STEPS, decode, num_inference_steps=STEPS, height=RESOLUTION,
                                  width=RESOLUTION, pag_scale=PAG_SCALE, pag_applied_layers="mid", **common)
    rec.update(image_mean=_check_image("sdxl_pag", images, RESOLUTION), dense_seconds=dense["seconds_per_request"],
               dense_denoiser_call_ms=dense["denoiser_call_ms"],
               ratio_to_dense=rec["seconds_per_request"] / dense["seconds_per_request"],
               ratio_to_phase_11=rec["seconds_per_request"] / RESULTS["pipeline"]["seconds_per_request"][0],
               uint8_mean_diff_to_phase_11=_uint8_mean_diff(images[0], dense_image))
    log(f"[guidance] {smi}: SDXL PAG request {rec['seconds_per_request']:.3f} s, {rec['ratio_to_dense']:.2f} x the "
        f"dense request beside it ({dense['seconds_per_request']:.3f} s), {rec['ratio_to_phase_11']:.2f} x phase 11's; "
        f"UNet b=2 {rec['denoiser_call_ms']['b2']:.2f} ms, perturbed b=1 {rec['denoiser_call_ms']['b1']:.2f} ms "
        f"(CUDA events); K1 {SDXL_PAG_STEP['flash_attention_fwd']} and K4 {SDXL_PAG_STEP['group_norm']} a step")
    out["sdxl_pag"], out["sdxl_dense_warm"] = rec, dense
    paths["sdxl_dense_warm"], paths["sdxl_pag"] = dense["launches"], rec["launches"]

    steps = int(STEPS * IMG2IMG_STRENGTH)
    expected = [dict(pag_step) for _ in range(steps)]
    expected[0] = _sum_launches((1, pag_step), (1, encode))
    images, rec = _guided_request(smi, "sdxl_pag_img2img", StableDiffusionXLPAGImg2ImgPipeline.from_pipe(pipe), unet,
                                  expected, decode, num_inference_steps=STEPS, image=image, strength=IMG2IMG_STRENGTH,
                                  pag_scale=PAG_SCALE, **common)
    rec.update(image_mean=_check_image("sdxl_pag_img2img", images, RESOLUTION))
    out["sdxl_pag_img2img"], paths["sdxl_pag_img2img"] = rec, rec["launches"]

    cn_step = _sum_launches((1, pag_step), (1, _module_launches(controlnet)))
    images, rec = _guided_request(smi, "sdxl_pag_controlnet",
                                  StableDiffusionXLControlNetPAGPipeline.from_pipe(pipe, controlnet=controlnet), unet,
                                  [cn_step] * PAG_CONTROLNET_STEPS, decode, num_inference_steps=PAG_CONTROLNET_STEPS,
                                  image=edges, controlnet_conditioning_scale=CONTROLNET_SCALE, pag_scale=PAG_SCALE,
                                  **common)
    rec.update(image_mean=_check_image("sdxl_pag_controlnet", images, RESOLUTION))
    out["sdxl_pag_controlnet"], paths["sdxl_pag_controlnet"] = rec, rec["launches"]

    pipe.enable_freeu(**SDXL_FREEU)
    try:
        images, rec = _guided_request(smi, "sdxl_freeu", pipe, unet, [unet_call] * STEPS, decode,
                                      num_inference_steps=STEPS, height=RESOLUTION, width=RESOLUTION, **common)
    finally:
        pipe.disable_freeu()
    rec.update(image_mean=_check_image("sdxl_freeu", images, RESOLUTION), freeu=SDXL_FREEU,
               ratio_to_dense=rec["seconds_per_request"] / dense["seconds_per_request"],
               uint8_mean_diff_to_phase_11=_uint8_mean_diff(images[0], dense_image))
    if not rec["uint8_mean_diff_to_phase_11"] > 0:
        raise AssertionError("FreeU left the SDXL image unchanged")
    out["sdxl_freeu"], paths["sdxl_freeu"] = rec, rec["launches"]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sample = torch.randn(1, 4, 128, 128, generator=gen, device=dev).to(torch.bfloat16)
    ehs = torch.randn(1, 77, 2048, generator=gen, device=dev).to(torch.bfloat16)
    cond = {"text_embeds": torch.randn(1, 1280, generator=gen, device=dev).to(torch.bfloat16),
            "time_ids": torch.tensor([[1024, 1024, 0, 0, 1024, 1024]], device=dev, dtype=torch.float32)}
    t = torch.tensor(500.0, device=dev)

    def call():
        return unet(sample, t, ehs, added_cond_kwargs=cond).sample

    with torch.no_grad():
        plain = call()
        reset_launches()
        with seg_blurred(identities, SEG_SIGMA):
            blurred = call()
            torch.cuda.synchronize()
            seg_launches = read_launches()
            seg_ms = time_ms(call, iters=5)
        plain_ms = time_ms(call, iters=5)
    diff = float((blurred.float() - plain.float()).abs().mean())
    rec = {"card": smi, "sigma": SEG_SIGMA, "layers": len(identities), "launches": seg_launches, "ms": seg_ms,
           "plain_ms": plain_ms, "mean_abs_diff_to_plain": diff}
    log(f"[guidance] {smi}: SDXL UNet call at b=1 under SEG (sigma {SEG_SIGMA}, {len(identities)} mid-block "
        f"self-attentions): {seg_ms:.2f} ms against {plain_ms:.2f} ms plain (CUDA events, 5 calls each); mean |diff| "
        f"{diff:.3e}; launches {seg_launches}")
    if not (bool(torch.isfinite(blurred).all()) and diff > 0):
        raise AssertionError("the SEG call is not finite or equals the plain call")
    if seg_launches != unet_call:
        raise AssertionError(f"the SEG call launched {seg_launches}, the modules count {unet_call}")
    out["sdxl_seg_call"], paths["sdxl_seg_call"] = rec, seg_launches
    RESULTS["sdxl_guidance"] = out
    return paths


def run_sd15_guidance(smi: str, pipe):
    """Phase 25b: `StableDiffusionPAGPipeline.from_pipe` of phase 23's SD 1.5
    (PNDM, 50 steps: 51 UNet steps; 512 px, CFG 7.5, pag_scale 3.0, "mid"):
    K4 61 + 61 a step and K1 0 (its heads run `native`), the 51st step
    without the perturbed call (step 50 of 50 is past PAG's window, as in
    JAX); the b=2 and b=1 UNet calls on CUDA events. Returns the launches by
    path."""
    from diffusers_tpu_torch.guiders import select_pag_layers
    from diffusers_tpu_torch.pipelines.pag import StableDiffusionPAGPipeline
    from diffusers_tpu_torch.schedulers import PNDMScheduler

    unet_call, decode = _module_launches(pipe.unet), _module_launches(pipe.vae.decoder)
    perturbed = _perturbed_launches(unet_call, select_pag_layers(pipe.unet, "mid"))
    pag_step = _sum_launches((1, unet_call), (1, perturbed))
    expected = [pag_step] * SD15_STEPS + [unet_call]
    pag = StableDiffusionPAGPipeline.from_pipe(pipe, scheduler=PNDMScheduler(**SD15_PNDM))
    images, rec = _guided_request(smi, "sd15_pag", pag, pipe.unet, expected, decode, prompt=SD15_PROMPT,
                                  height=SD15_RESOLUTION, width=SD15_RESOLUTION, num_inference_steps=SD15_STEPS,
                                  guidance_scale=SD15_GUIDANCE, pag_scale=PAG_SCALE, output_type="pil")
    rec.update(image_mean=_check_image("sd15_pag", images, SD15_RESOLUTION),
               ratio_to_phase_23=rec["seconds_per_request"] / RESULTS["sd15"]["sd15_pndm"]["seconds_per_request"])
    log(f"[guidance] {smi}: SD 1.5 PAG {rec['ratio_to_phase_23']:.2f} x phase 23's PNDM request")
    RESULTS["sd15_guidance"] = {"sd15_pag": rec}
    return {"sd15_pag": rec["launches"]}


def run_sd3_guidance(smi: str, pipe):
    """Phase 25c: on phase 16's SD3.5 Medium, `StableDiffusion3PAGPipeline.from_pipe`
    (1024 px, 28 steps, CFG 7.0, pag_scale 3.0, block 13: K1 37 + 37 a step,
    the perturbed call's block-13 joint attention under the identity mask),
    then one transformer call at b=1 under Skip Layer Guidance (blocks 7-9
    skipped: 6 fewer K1 launches) beside a full one, on CUDA events.
    Returns the launches by path."""
    import torch

    from diffusers_tpu_torch.guiders import layers_skipped, select_skip_blocks
    from diffusers_tpu_torch.pipelines.pag import StableDiffusion3PAGPipeline

    tr = pipe.transformer
    call, decode = _module_launches(tr), _module_launches(pipe.vae.decoder)
    step = _sum_launches((2, call))  # block 13's joint attention runs K1 under the mask
    if step["flash_attention_fwd"] != SD3_PAG_STEP_K1:
        raise AssertionError(f"an SD3 PAG step counts {step}, expected K1 {SD3_PAG_STEP_K1}")
    images, rec = _guided_request(smi, "sd3_pag", StableDiffusion3PAGPipeline.from_pipe(pipe), tr,
                                  [step] * SD3_STEPS, decode, prompt=SD3_PROMPTS[0], height=RESOLUTION,
                                  width=RESOLUTION, num_inference_steps=SD3_STEPS, guidance_scale=SD3_GUIDANCE,
                                  pag_scale=PAG_SCALE, pag_applied_layers=SD3_PAG_LAYERS, output_type="pil")
    rec.update(image_mean=_check_image("sd3_pag", images, RESOLUTION),
               ratio_to_phase_16=rec["seconds_per_request"] / RESULTS["sd3"]["direct_seconds"])
    log(f"[guidance] {smi}: SD3.5 Medium PAG {rec['ratio_to_phase_16']:.2f} x phase 16's direct request")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    latents = torch.randn(1, 16, 128, 128, generator=gen, device=dev).to(torch.bfloat16)
    embeds = torch.randn(1, 333, 4096, generator=gen, device=dev).to(torch.bfloat16)
    pooled = torch.randn(1, 2048, generator=gen, device=dev).to(torch.bfloat16)
    t = torch.tensor([500.0], device=dev)
    blocks = select_skip_blocks(tr, list(SLG_BLOCKS))
    expected = dict(call, flash_attention_fwd=call["flash_attention_fwd"] - sum(
        _module_launches(b)["flash_attention_fwd"] for b in blocks))

    def forward():
        return tr(latents, embeds, pooled, t).sample

    with torch.no_grad():
        full = forward()
        full_ms = time_ms(forward, iters=5)
        reset_launches()
        with layers_skipped(blocks):
            skipped = forward()
            torch.cuda.synchronize()
            slg_launches = read_launches()
            slg_ms = time_ms(forward, iters=5)
    diff = float((skipped.float() - full.float()).abs().mean())
    slg = {"card": smi, "blocks": list(SLG_BLOCKS), "launches": slg_launches, "ms": slg_ms, "full_ms": full_ms,
           "mean_abs_diff_to_full": diff}
    log(f"[guidance] {smi}: SD3.5 Medium transformer call at b=1 with blocks {list(SLG_BLOCKS)} skipped (SLG): "
        f"{slg_ms:.2f} ms against {full_ms:.2f} ms whole (CUDA events, 5 calls each); mean |diff| {diff:.3e}; "
        f"launches {slg_launches} (K1 {expected['flash_attention_fwd']} by the modules)")
    if not (bool(torch.isfinite(skipped).all()) and diff > 0):
        raise AssertionError("the SLG call is not finite or equals the whole call")
    if slg_launches != expected:
        raise AssertionError(f"the SLG call launched {slg_launches}, the modules count {expected}")
    RESULTS["sd3_guidance"] = {"sd3_pag": rec, "sd3_slg_call": slg}
    return {"sd3_pag": rec["launches"], "sd3_slg_call": slg_launches}


# ------------------------------------------------------------------ phase 26: the loaders
# LoRA (PEFT and kohya's SGM layout on SDXL, XLabs on Flux.1-dev before w8a8), single-file checkpoints (SDXL's LDM
# layout; the Flux, SD3 and Wan transformers in their original layouts) and textual inversion, at full width
LORA_RANK = 16
LORA_SCALES = (0.3, 0.7)  # the two-adapter request's set_adapters weights
SDXL_LORA_UNET = ("attn1.to_q", "attn1.to_k", "attn1.to_v", "attn1.to_out.0", "attn2.to_q", "attn2.to_k",
                  "attn2.to_v", "attn2.to_out.0", "ff.net.0.proj", "ff.net.2")
SDXL_LORA_TEXT = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.out_proj", "mlp.fc1",
                  "mlp.fc2")
TI_TOKEN = "<lora-cat>"
TI_VECTORS = 2
SINGLE_FILE_DEPTH = 2  # the transformers' blocks in phase 26e (full width)


def _lora_pair(gen, d_in: int, d_out: int):
    """A seeded rank-LORA_RANK (A, B) pair on the card in bf16, ``B @ A`` about
    1% of a unit-variance weight's entries."""
    import torch

    a = torch.randn(LORA_RANK, d_in, device="cuda", generator=gen) / d_in ** 0.5
    b = torch.randn(d_out, LORA_RANK, device="cuda", generator=gen) * 0.01 / LORA_RANK ** 0.5
    return a.to(torch.bfloat16), b.to(torch.bfloat16)


def sdxl_peft_lora(pipe, seed: int) -> dict:
    """A PEFT-format LoRA (``<component>.<path>.lora_A/B.weight`` and ``alpha``)
    on every UNet attention projection and feed-forward Linear (SDXL_LORA_UNET)
    and every Linear of both text encoders' layers (SDXL_LORA_TEXT)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    sd = {}
    for comp, suffixes in (("unet", SDXL_LORA_UNET), ("text_encoder", SDXL_LORA_TEXT),
                           ("text_encoder_2", SDXL_LORA_TEXT)):
        for name, m in getattr(pipe, comp).named_modules():
            if isinstance(m, torch.nn.Linear) and name.endswith(suffixes):
                sd[f"{comp}.{name}.lora_A.weight"], sd[f"{comp}.{name}.lora_B.weight"] = _lora_pair(
                    gen, m.in_features, m.out_features)
                sd[f"{comp}.{name}.alpha"] = torch.tensor(float(LORA_RANK))
    return sd


def kohya_sgm_lora(peft: dict, layers_per_block: int) -> dict:
    """The UNet part of a PEFT LoRA under kohya's SGM-layout names
    (``lora_unet_input_blocks_4_1_transformer_blocks_0_attn1_to_q.lora_down.weight``),
    the names `ldm_unet_keys` gives each module."""
    out = {}
    for key, value in peft.items():
        if not key.startswith("unet."):
            continue
        path, _, leaf = key[len("unet."):].rpartition(".lora_") if ".lora_" in key else (
            key[len("unet."):-len(".alpha")], "", "alpha")
        ldm = next(iter(ldm_unet_keys({path + ".weight": None}, layers_per_block, prefix="")))[:-len(".weight")]
        flat = "lora_unet_" + ldm.replace(".", "_")
        leaf = {"A.weight": "lora_down.weight", "B.weight": "lora_up.weight"}.get(leaf, "alpha")
        out[f"{flat}.{leaf}"] = value
    return out


def _pristine_bytes(pipe) -> int:
    return sum(t.numel() * t.element_size() for kept in pipe.__dict__.get("_lora_base", {}).values()
               for _, weight, bias in kept.values() for t in (weight, bias) if t is not None)


def _sdxl_request(smi, label, pipe, prompt=PROMPTS[0]):
    """Phase 11's request (1024 px, STEPS steps, CFG 5.0, SEED), each step's
    launches held to the UNet's and the decode's module counts. Returns
    (uint8 image, seconds, peak GB, launches)."""
    import numpy as np
    import torch

    images, seconds, peak_gb, launches = _held_request(
        smi, label, pipe, STEPS, _module_launches(pipe.unet), {}, _module_launches(pipe.vae.decoder), prompt=prompt,
        height=RESOLUTION, width=RESOLUTION, num_inference_steps=STEPS, guidance_scale=GUIDANCE,
        generator=torch.Generator(device="cuda").manual_seed(SEED), output_type="pil")
    image = np.asarray(images[0])
    _check_image(label, images, RESOLUTION)
    return image, seconds, peak_gb, launches


def run_sdxl_lora(smi: str, pipe, dense):
    """Phase 26a: LoRA on phase 11's full-width SDXL pipeline: two seeded
    rank-16 PEFT LoRAs on the UNet's attention projections and feed-forward
    Linears and on both text encoders, loaded with `load_lora_weights` (host
    clock ending in a synchronise; the pristine copies' bytes on the card);
    one request with the first adapter; `set_adapters` of both at
    LORA_SCALES and a request; a kohya SGM-layout twin of the first
    adapter's UNet part, whose fused UNet weights must equal the first
    adapter's bit for bit; `disable_lora`, then phase 11's request again
    (the dense request beside the others, its seconds theirs to compare
    with) bit-equal to phase 11's image `dense`, and every touched weight
    equal to its pristine copy. Each request's launches held to the
    modules' counts (K1 140, K4 46 a step, as dense)."""
    import numpy as np
    import torch

    out = {"card": smi, "rank": LORA_RANK}
    dense_peak = RESULTS["pipeline"]["peak_memory_gb"]
    loras = [sdxl_peft_lora(pipe, SEED + 101 + i) for i in range(2)]
    out["lora_tensors"] = len(loras[0])
    out["lora_bytes"] = sum(t.numel() * t.element_size() for t in loras[0].values())
    _, out["load_seconds"], _ = _request_seconds(lambda: pipe.load_lora_weights(loras[0], adapter_name="a"))
    out["pristine_bytes"] = _pristine_bytes(pipe)
    out["touched_modules"] = {k: len(v) for k, v in pipe._lora_base.items()}
    image_a, out["one_adapter_seconds"], out["one_adapter_peak_gb"], launches_a = _sdxl_request(
        smi, "sdxl_lora", pipe)
    _, out["second_load_seconds"], _ = _request_seconds(lambda: pipe.load_lora_weights(loras[1], adapter_name="b"))
    _, out["set_adapters_seconds"], _ = _request_seconds(lambda: pipe.set_adapters(["a", "b"], list(LORA_SCALES)))
    image_ab, out["two_adapters_seconds"], out["two_adapters_peak_gb"], launches_ab = _sdxl_request(
        smi, "sdxl_lora_two_adapters", pipe)

    # kohya's SGM layout: the first adapter's UNet part under LDM names fuses into the same modules
    pipe.set_adapters("a")
    fused = {p: w.clone() for p, (m, _, _) in pipe._lora_base["unet"].items() for w in (m.weight,)}
    pipe.load_lora_weights(kohya_sgm_lora(loras[0], pipe.unet.config.layers_per_block), adapter_name="kohya")
    kohya_equal = all(torch.equal(pipe._lora_base["unet"][p][0].weight, w) for p, w in fused.items())
    out["kohya_sgm_modules"] = len(pipe._lora_adapters["kohya"]["unet"])
    del fused

    _, out["disable_seconds"], _ = _request_seconds(pipe.disable_lora)
    restored = all(torch.equal(m.weight, w) and (b is None or torch.equal(m.bias, b))
                   for kept in pipe._lora_base.values() for m, w, b in kept.values())
    image_off, off_s, off_peak, launches_off = _sdxl_request(smi, "sdxl_lora_disabled", pipe)
    diff_off = _uint8_diff(image_off, dense)
    pipe.delete_adapters(["a", "b", "kohya"])
    out.update(dense_peak_gb=dense_peak, disabled_seconds=off_s, disabled_peak_gb=off_peak,
               kohya_sgm_equal_to_peft=kohya_equal, restored_bit_equal=restored, disabled_max_diff_to_dense=diff_off,
               one_adapter_mean_diff_to_dense=float(np.abs(image_a.astype(np.float32) - dense).mean()),
               two_adapters_mean_diff_to_one=float(np.abs(image_ab.astype(np.float32) - image_a).mean()),
               launches={"one_adapter": launches_a, "two_adapters": launches_ab, "disabled": launches_off},
               pristine_left_after_delete=_pristine_bytes(pipe))
    RESULTS["sdxl_lora"] = out
    log(f"[sdxl-lora] {smi}: rank {LORA_RANK} on {out['touched_modules']} Linears ({out['lora_bytes'] / 1e6:.1f} MB "
        f"an adapter): load_lora_weights {out['load_seconds']:.3f} s (second {out['second_load_seconds']:.3f} s), "
        f"set_adapters {LORA_SCALES} {out['set_adapters_seconds']:.3f} s, disable_lora {out['disable_seconds']:.3f} "
        f"s; pristine copies {out['pristine_bytes'] / 1e9:.3f} GB on the card; requests: one adapter "
        f"{out['one_adapter_seconds']:.3f} s (peak {out['one_adapter_peak_gb']:.2f} GB), two "
        f"{out['two_adapters_seconds']:.3f} s, disabled (dense weights) {off_s:.3f} s (peak {off_peak:.2f} GB with "
        f"the copies; phase 11's {dense_peak:.2f} GB); mean |diff| to dense "
        f"{out['one_adapter_mean_diff_to_dense']:.2f} levels; kohya SGM twin fuses bit-equal {kohya_equal} ({out['kohya_sgm_modules']} modules); restored "
        f"{restored}, disabled max |diff| to phase 11's image {diff_off}; launches {launches_a}")
    if not (kohya_equal and restored and diff_off == 0):
        raise AssertionError(f"SDXL LoRA: kohya twin equal {kohya_equal}, weights restored {restored}, disabled "
                             f"request differs from dense by {diff_off} levels")
    if not launches_a == launches_ab == launches_off == RESULTS["pipeline"]["launches"]:
        raise AssertionError(f"SDXL LoRA requests launched {out['launches']}")
    if out["one_adapter_mean_diff_to_dense"] == 0 or out["two_adapters_mean_diff_to_one"] == 0:
        raise AssertionError("SDXL LoRA: an adapter did not change the image")
    if out["pristine_left_after_delete"]:
        raise AssertionError("SDXL LoRA: pristine copies left after every adapter was deleted")
    return {"sdxl_lora": launches_a, "sdxl_lora_two_adapters": launches_ab, "sdxl_lora_disabled": launches_off}


def run_sdxl_single_file(smi: str, pipe, dense):
    """Phase 26c: phase 11's full-width SDXL UNet, VAE and CLIP-L written as
    one LDM-layout safetensors file (`ldm_unet_keys`, `ldm_vae_keys`,
    `ldm_clip_keys`) under the system temp dir, read back through
    `loaders.single_file` (`load_single_file_checkpoint`, the three LDM
    converters, `model_from_state_dict` onto the card; the page cache warm)
    with its read rate; every state dict bit-equal, then phase 11's request
    with the loaded components bit-equal to `dense` (phase 11's image)."""
    import shutil

    import torch

    from diffusers_tpu_torch.loaders import single_file as sf
    from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
    from diffusers_tpu_torch.models.modeling_utils import save_safetensors
    from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel
    from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
    from diffusers_tpu_torch.pipelines.stable_diffusion_xl import StableDiffusionXLPipeline

    layers = pipe.unet.config.layers_per_block
    sd = {**ldm_unet_keys(pipe.unet.state_dict(), layers), **ldm_vae_keys(pipe.vae.state_dict()),
          **ldm_clip_keys(pipe.text_encoder.state_dict())}
    nbytes = sum(t.numel() * t.element_size() for t in sd.values())
    directory = _scratch_dir("sdxl_single_file", nbytes)
    path = f"{directory}/sd_xl_ldm.safetensors"

    split = {}

    def read():  # the header and the memory map, the key maps, then each tensor onto the card
        t0 = time.perf_counter()
        raw = sf.load_single_file_checkpoint(path)
        t1 = time.perf_counter()
        converted = {"unet": sf.convert_ldm_unet_state_dict(raw, dict(pipe.unet.config)),
                     "vae": sf.convert_ldm_vae_state_dict(raw), "text_encoder": sf.convert_ldm_clip_state_dict(raw)}
        t2 = time.perf_counter()
        classes = {"unet": UNet2DConditionModel, "vae": AutoencoderKL, "text_encoder": CLIPTextModel}
        parts = {}
        for name, sd in converted.items():
            t3 = time.perf_counter()
            parts[name] = sf.model_from_state_dict(classes[name], dict(getattr(pipe, name).config), sd,
                                                   device=pipe.device)
            torch.cuda.synchronize()
            split[f"place_{name}_seconds"] = time.perf_counter() - t3
        split.update(open_seconds=t1 - t0, convert_seconds=t2 - t1, place_seconds=time.perf_counter() - t2)
        return parts, sf.infer_single_file_checkpoint_type(raw)

    try:
        _, write_s, _ = _request_seconds(lambda: save_safetensors(sd, path))
        del sd
        (parts, kind), read_s, read_peak = _request_seconds(read)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    equal = {}
    for name, model in parts.items():
        a, b = getattr(pipe, name).state_dict(), model.state_dict()
        equal[name] = sorted(a) == sorted(b) and all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)
    loaded = StableDiffusionXLPipeline(**dict(pipe.components, **parts), device=pipe.device)
    image, seconds, peak_gb, launches = _sdxl_request(smi, "sdxl_single_file", loaded)
    diff = _uint8_diff(image, dense)
    RESULTS["sdxl_single_file"] = {
        "card": smi, "bytes": nbytes, "write_seconds": write_s, "read_seconds": read_s,
        "read_gb_per_s": nbytes / read_s / 1e9, "page_cache": "warm (just written)", "read_peak_gb": read_peak, **split,
        "sniffed_type": kind, "bit_equal": equal, "request_seconds": seconds, "request_peak_gb": peak_gb,
        "max_diff_to_dense": diff, "launches": launches}
    log(f"[sdxl-single-file] {smi}: SDXL UNet + VAE + CLIP-L as one LDM file, {nbytes / 1e9:.2f} GB: written in "
        f"{write_s:.1f} s; read, converted and placed on the card in {read_s:.2f} s ({nbytes / read_s / 1e9:.2f} GB/s, "
        f"page cache warm; open {split['open_seconds']:.2f}, convert {split['convert_seconds']:.2f}, place "
        f"{split['place_seconds']:.2f} s), sniffed {kind!r}; state dicts bit-equal {equal}; request {seconds:.3f} s, "
        f"max |diff| to phase 11's image {diff} (uint8 levels)")
    if not all(equal.values()) or diff != 0:
        raise AssertionError(f"SDXL single file: state dicts equal {equal}, request differs by {diff} levels")
    del loaded, parts
    return {"sdxl_single_file": launches}


def run_sdxl_textual_inversion(smi: str, pipe):
    """Phase 26d: a seeded TI_VECTORS-vector embedding (A1111's
    ``string_to_param`` format) loaded into phase 11's CLIP-L with
    `load_textual_inversion`, the pipeline given real CLIP tokenizers of
    CLIP's 49,408 ids (`clip_tokenizer`: the new token's ids are the
    appended rows; CLIP-bigG's tokenizer does not have it), then phase 11's
    request with a prompt that uses the token (`maybe_convert_prompt`). The
    token's rows must be the embedding's, and the prompt's CLIP-L hidden
    states must differ from those of the prompt without it. The stand-in
    tokenizers are put back after."""
    import tempfile

    import torch
    import transformers

    from diffusers_tpu_torch.loaders.textual_inversion import load_textual_inversion, maybe_convert_prompt

    stand_ins = dict(tokenizer=pipe.tokenizer, tokenizer_2=pipe.tokenizer_2)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tokenizer_") as directory:
        clip_tokenizer(directory, vocab_size=49408)
        tokenizers = {name: transformers.CLIPTokenizer.from_pretrained(directory) for name in stand_ins}
    tokenizer_s = time.perf_counter() - t0
    pipe.register_modules(**tokenizers)
    try:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 201)
        width = pipe.text_encoder.config.hidden_size
        emb = torch.randn(TI_VECTORS, width, device="cuda", generator=gen) * 0.02
        rows_before = pipe.text_encoder.text_model.embeddings.token_embedding.num_embeddings
        _, load_s, _ = _request_seconds(lambda: load_textual_inversion(
            {"string_to_param": {"*": emb}}, TI_TOKEN, pipe.tokenizer, pipe.text_encoder))
        table = pipe.text_encoder.text_model.embeddings.token_embedding.weight
        ids = pipe.tokenizer.convert_tokens_to_ids([TI_TOKEN] + [f"{TI_TOKEN}_{i}" for i in range(1, TI_VECTORS)])
        rows_equal = ids == list(range(rows_before, rows_before + TI_VECTORS)) and torch.equal(
            table[ids], emb.to(table.dtype))
        t1 = time.perf_counter()
        prompt = maybe_convert_prompt(f"a photo of {TI_TOKEN} riding a horse on mars", pipe.tokenizer)
        plain = "a photo of riding a horse on mars"
        with torch.no_grad():
            hidden = [pipe.text_encoder(torch.tensor(pipe.tokenizer([p], padding="max_length", max_length=77,
                                                                       truncation=True).input_ids, device="cuda"))[0]
                      for p in (prompt, plain)]
        changed = not torch.equal(hidden[0], hidden[1])
        check_s = time.perf_counter() - t1
        image, seconds, peak_gb, launches = _sdxl_request(smi, "sdxl_textual_inversion", pipe, prompt=prompt)
    finally:
        pipe.register_modules(**stand_ins)
    RESULTS["sdxl_textual_inversion"] = {
        "card": smi, "vectors": TI_VECTORS, "prompt": prompt, "tokenizers_seconds": tokenizer_s,
        "load_seconds": load_s, "prompt_check_seconds": check_s, "token_ids": ids,
        "rows_equal": rows_equal, "hidden_states_changed": changed, "request_seconds": seconds,
        "request_peak_gb": peak_gb, "image_mean": float(image.mean()), "launches": launches}
    log(f"[sdxl-ti] {smi}: {TI_VECTORS}-vector embedding into CLIP-L ({rows_before} -> {table.shape[0]} rows) in "
        f"{load_s * 1e3:.1f} ms, token ids {ids}, rows equal {rows_equal}; prompt {prompt!r}: CLIP-L hidden states "
        f"changed {changed}; request {seconds:.3f} s, peak {peak_gb:.2f} GB, launches {launches}; tokenizers made in "
        f"{tokenizer_s:.2f} s, the prompt check {check_s:.2f} s")
    if not (rows_equal and changed):
        raise AssertionError(f"textual inversion: rows equal {rows_equal}, hidden states changed {changed}")
    return {"sdxl_textual_inversion": launches}


def xlabs_flux_lora(cfg: dict, seed: int) -> dict:
    """A seeded rank-16 XLabs-format Flux LoRA (``double_blocks.N.processor.
    {qkv,proj}_lora{1,2}.{down,up}.weight``, ``single_blocks.N.processor.
    {qkv,proj}_lora...``) at the widths of `cfg`, bf16 on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    inner = cfg.get("num_attention_heads", 24) * cfg.get("attention_head_dim", 128)
    sd = {}

    def put(key, d_in, d_out):
        sd[f"{key}.down.weight"], sd[f"{key}.up.weight"] = _lora_pair(gen, d_in, d_out)

    for i in range(cfg.get("num_layers", 19)):
        for name, d_out in (("qkv_lora1", 3 * inner), ("qkv_lora2", 3 * inner), ("proj_lora1", inner),
                            ("proj_lora2", inner)):
            put(f"double_blocks.{i}.processor.{name}", inner, d_out)
    for i in range(cfg.get("num_single_layers", 38)):
        put(f"single_blocks.{i}.processor.qkv_lora", inner, 3 * inner)
        put(f"single_blocks.{i}.processor.proj_lora", 5 * inner, inner)
    return sd


@contextlib.contextmanager
def plain_w8a8():
    """Inside, `W8A8Linear` takes K5's plain versions (`quantize_rows_plain`,
    `w8a8_matmul_2d_plain`) on the card."""
    from diffusers_tpu_torch.ops.cuda import w8a8_matmul as k5

    kernels = k5.quantize_rows, k5.w8a8_matmul_2d
    k5.quantize_rows, k5.w8a8_matmul_2d = k5.quantize_rows_plain, k5.w8a8_matmul_2d_plain
    try:
        yield
    finally:
        k5.quantize_rows, k5.w8a8_matmul_2d = kernels


def _flux_call_inputs(dtype):
    """One 1024 px Flux.1-dev transformer call's inputs (4,096 image tokens,
    512 text tokens, guidance 3.5), from SEED."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 301)
    img, txt = (RESOLUTION // 16) ** 2, FLUX_MAX_SEQUENCE_LENGTH
    rows, cols = torch.meshgrid(torch.arange(RESOLUTION // 16), torch.arange(RESOLUTION // 16), indexing="ij")
    img_ids = torch.stack([torch.zeros_like(rows), rows, cols], -1).reshape(-1, 3).float().cuda()
    return dict(hidden_states=torch.randn(1, img, 64, device="cuda", generator=gen).to(dtype),
                encoder_hidden_states=torch.randn(1, txt, 4096, device="cuda", generator=gen).to(dtype),
                pooled_projections=torch.randn(1, 768, device="cuda", generator=gen).to(dtype),
                timestep=torch.tensor([0.7], device="cuda"), guidance=torch.tensor([FLUX_GUIDANCE], device="cuda"),
                img_ids=img_ids, txt_ids=torch.zeros(txt, 3, device="cuda"))


def run_flux_lora_w8a8(smi: str, pipe):
    """Phase 26b: FLUX.1-dev's transformer at full width in bf16 (made on the
    card from SEED), a seeded XLabs-format LoRA fused into it
    (`loaders.lora.load_lora_weights`, timed), bench.py's
    `quantize_w8a8(model, 2**20)` (timed); on phase 13's pipeline given this
    w8a8 transformer, `load_lora_weights` of the same LoRA must raise (it
    lands on W8A8Linears); then one 1024 px transformer call
    held against its plain routes (`plain_routes` and `plain_w8a8`): on the
    kernels (K1 57, K5 500 and its row quantization 500), on the plain
    routes in bf16 and in float32; the kernels' output must be as close to
    the f32 one as the plain bf16 one is (PLAIN_CHECK_RATIO)."""
    import gc

    import torch

    from diffusers_tpu_torch.loaders.lora import load_lora_weights
    from diffusers_tpu_torch.models.modeling_utils import materialize_
    from diffusers_tpu_torch.models.transformers.transformer_flux import FluxTransformer2DModel
    from diffusers_tpu_torch.ops.module import W8A8Linear
    from diffusers_tpu_torch.quantizers import quantize_w8a8

    sd = xlabs_flux_lora(FLUX_DEV, SEED + 401)
    torch.manual_seed(SEED)
    with torch.device("meta"):
        tr = FluxTransformer2DModel(**FLUX_DEV)
    _, build_s, _ = _request_seconds(lambda: materialize_(tr, "cuda", torch.bfloat16))
    _, fuse_s, _ = _request_seconds(lambda: load_lora_weights(sd, tr, component="transformer"))
    _, quant_s, _ = _request_seconds(lambda: quantize_w8a8(tr, 2**20))
    n_w8a8 = sum(isinstance(m, W8A8Linear) for m in tr.modules())
    pipe.transformer = tr  # phase 13's pipeline (its transformer freed by phase 13c)
    try:
        pipe.load_lora_weights(sd)
        refused = None
    except ValueError as e:
        refused = str(e)
    if refused is None or "W8A8Linear" not in refused:
        raise AssertionError(f"load_lora_weights on the w8a8 Flux transformer did not refuse: {refused}")
    expected = _module_launches(tr)
    inputs = _flux_call_inputs(torch.bfloat16)
    outs, launches = [], []
    with torch.no_grad():
        for route, f32 in ((contextlib.nullcontext, False), (plain_routes, False), (plain_routes, True)):
            reset_launches()
            call_inputs = {k: v.float() if f32 and v.is_floating_point() else v for k, v in inputs.items()}
            with route(), plain_w8a8() if route is plain_routes else contextlib.nullcontext(), \
                    module_in_float32(tr) if f32 else contextlib.nullcontext():
                outs.append(tr(**call_inputs).sample.float())
            torch.cuda.synchronize()
            launches.append(read_launches())
        call_ms = time_ms(lambda: tr(**inputs), iters=5)
    kernels, plain, f32 = outs
    errs = {name: (float((a - b).abs().max()), float((a - b).abs().mean()))
            for name, a, b in (("kernels_vs_plain", kernels, plain), ("kernels_vs_f32", kernels, f32),
                               ("plain_vs_f32", plain, f32))}
    RESULTS["flux_lora_w8a8"] = {
        "card": smi, "refused_on_w8a8": refused, "lora_tensors": len(sd), "build_seconds": build_s,
        "fuse_seconds": fuse_s, "quantize_seconds": quant_s, "w8a8_linears": n_w8a8, "call_ms": call_ms,
        "launches": launches[0], "expected_launches": expected, "plain_launches": launches[1:],
        **{f"{name}_{stat}": v for name, pair in errs.items() for stat, v in zip(("max", "mean"), pair)}}
    log(f"[flux-lora] {smi}: load_lora_weights on the w8a8 transformer refused ({refused[:80]}...); FLUX.1-dev bf16 "
        f"made in {build_s:.1f} s, XLabs LoRA ({len(sd)} tensors) fused in {fuse_s:.3f} s, quantize_w8a8 in "
        f"{quant_s:.2f} s ({n_w8a8} W8A8Linears); a 1024 px call {call_ms:.1f} ms; max / mean |diff|: kernels vs "
        "plain bf16 {:.3e} / {:.3e}, kernels vs f32 {:.3e} / {:.3e}, plain bf16 vs f32 {:.3e} / {:.3e}; launches "
        "{} (expected {})".format(*errs["kernels_vs_plain"], *errs["kernels_vs_f32"], *errs["plain_vs_f32"],
                                  launches[0], expected))
    if launches[0] != expected or any(any(v.values()) for v in launches[1:]):
        raise AssertionError(f"Flux LoRA w8a8 call: launches {launches}, expected {expected} then none")
    if not (torch.isfinite(kernels).all() and all(k <= PLAIN_CHECK_RATIO * p for k, p in
                                                   zip(errs["kernels_vs_f32"], errs["plain_vs_f32"]))):
        raise AssertionError(f"Flux LoRA w8a8 call: the kernels are further from f32 than the plain routes: {errs}")
    pipe.transformer = None
    del tr, outs, kernels, plain, f32
    gc.collect()
    torch.cuda.empty_cache()
    return {"flux_lora_w8a8_call": launches[0]}


def sd3_pos_embed_table(model):
    """The [1, m², D] sin-cos table an SAI SD3 file carries for `model`'s
    `pos_embed_max_size` m (the port derives it from the config)."""
    import torch

    from diffusers_tpu_torch.models.embeddings import get_2d_sincos_pos_embed

    pe, m = model.pos_embed, model.config.pos_embed_max_size
    return torch.from_numpy(get_2d_sincos_pos_embed(pe.embed_dim, m, pe.base_size, pe.interpolation_scale))[None]


def _transformer_single_file_cases():
    """(label, class, config, the writer of a model's original-layout dict,
    loader name, loader overrides, call inputs) of phase 26e, at full width,
    SINGLE_FILE_DEPTH blocks each."""
    import torch

    from diffusers_tpu_torch.models.transformers.transformer_flux import FluxTransformer2DModel
    from diffusers_tpu_torch.models.transformers.transformer_sd3 import SD3Transformer2DModel
    from diffusers_tpu_torch.models.transformers.transformer_wan import WanTransformer3DModel

    gen = torch.Generator(device="cuda").manual_seed(SEED + 501)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)

    t = torch.tensor([500.0], device="cuda")
    return [
        ("flux", FluxTransformer2DModel, dict(FLUX_DEV, num_layers=SINGLE_FILE_DEPTH,
                                              num_single_layers=SINGLE_FILE_DEPTH),
         lambda m: bfl_flux_keys(m.state_dict()), "load_flux_transformer_single_file", {},
         lambda: _flux_call_inputs(torch.bfloat16)),
        ("sd3", SD3Transformer2DModel, dict(SD35_MEDIUM, num_layers=SINGLE_FILE_DEPTH,
                                            dual_attention_layers=tuple(range(SINGLE_FILE_DEPTH))),
         lambda m: sai_sd3_keys(m.state_dict(), sd3_pos_embed_table(m).to(torch.bfloat16)),
         "load_sd3_transformer_single_file", {},
         lambda: dict(hidden_states=randn(2, 16, 128, 128), encoder_hidden_states=randn(2, 333, 4096),
                      pooled_projections=randn(2, 2048), timestep=t.expand(2))),
        ("wan_i2v", WanTransformer3DModel, dict(WAN_I2V_14B, num_layers=SINGLE_FILE_DEPTH),
         lambda m: wan_original_keys(m.state_dict()), "load_wan_transformer_single_file", {},
         lambda: dict(hidden_states=randn(1, 36, 21, 60, 104), timestep=t, encoder_hidden_states=randn(1, 512, 4096),
                      encoder_hidden_states_image=randn(1, 257, 1280))),
    ]


def run_transformers_single_file(smi: str):
    """Phase 26e: FLUX.1-dev's, SD3.5 Medium's and Wan2.1-I2V-14B's
    transformers at full width and SINGLE_FILE_DEPTH blocks, made on the card
    from SEED (bf16), written in their original layouts (BFL's, SAI's with
    its sin-cos table, Wan's) under the system temp dir and read back with
    `load_flux/sd3/wan_transformer_single_file` (config from the keys; the
    page cache warm), with the read rate; each state dict bit-equal, and one
    forward each on the card equal bit for bit to the source model's, its K1
    launches the modules' count."""
    import gc
    import shutil

    import torch

    from diffusers_tpu_torch.loaders import single_file as sf
    from diffusers_tpu_torch.models.modeling_utils import save_safetensors

    out, paths = {"card": smi}, {}
    for label, cls, cfg, writer, loader, overrides, inputs in _transformer_single_file_cases():
        model = _wan_random_model(cls, cfg, "cuda", torch.bfloat16, SEED)
        state, original = model.state_dict(), writer(model)
        nbytes = sum(t.numel() * t.element_size() for t in original.values())
        directory = _scratch_dir(f"{label}_single_file", nbytes)
        path = f"{directory}/{label}.safetensors"
        try:
            _, write_s, _ = _request_seconds(lambda: save_safetensors(original, path))
            del original
            loaded, read_s, _ = _request_seconds(lambda: getattr(sf, loader)(path, config_overrides=overrides))
        finally:
            shutil.rmtree(directory, ignore_errors=True)
        got = loaded.state_dict()
        equal = sorted(got) == sorted(state) and all(got[k].dtype == state[k].dtype and torch.equal(got[k], state[k])
                                                      for k in state)
        kwargs = inputs()
        with torch.no_grad():
            ref = model(**kwargs).sample
            reset_launches()
            y = loaded(**kwargs).sample
            torch.cuda.synchronize()
            launches = read_launches()
        same = torch.equal(ref, y) and bool(torch.isfinite(y).all())
        expected = _module_launches(loaded)
        out[label] = {"config": {k: v for k, v in dict(loaded.config).items() if not k.startswith("_")},
                      "bytes": nbytes, "write_seconds": write_s, "read_seconds": read_s,
                      "read_gb_per_s": nbytes / read_s / 1e9, "page_cache": "warm (just written)",
                      "state_bit_equal": equal, "forward_bit_equal": same, "launches": launches,
                      "expected_launches": expected}
        log(f"[single-file] {smi}: {label} at full width, {SINGLE_FILE_DEPTH} blocks, {nbytes / 1e9:.2f} GB in its "
            f"original layout: written in {write_s:.1f} s, read onto the card in {read_s:.2f} s "
            f"({nbytes / read_s / 1e9:.2f} GB/s, warm); state bit-equal {equal}, forward bit-equal {same}; launches "
            f"{launches} (expected {expected})")
        if not (equal and same) or launches != expected:
            raise AssertionError(f"{label} single file: state equal {equal}, forward equal {same}, launches "
                                 f"{launches} (expected {expected})")
        paths[f"{label}_single_file_call"] = launches
        del model, loaded, state, got, ref, y
        gc.collect()
        torch.cuda.empty_cache()
    RESULTS["transformers_single_file"] = out
    return paths


# ------------------------------------------------------------------ Qwen-Image and LTX-Video (phases 10k, 10l, 27, 28)

def qwen_tokenizer(directory):
    """A real Qwen2 tokenizer (transformers' `Qwen2TokenizerFast`, or
    `Qwen2Tokenizer` where transformers has no separate fast class) over a
    byte-level BPE written on the spot into `directory` (no download):
    trained to 600 tokens on the chat template around this script's prompts,
    with Qwen's special tokens ``<|endoftext|>`` (the padding),
    ``<|im_start|>`` and ``<|im_end|>``. Loaded with `from_pretrained`."""
    import transformers
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    from diffusers_tpu_torch.pipelines.qwenimage.pipeline_qwenimage import PROMPT_TEMPLATE

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=600, special_tokens=["<|endoftext|>", "<|im_start|>", "<|im_end|>"],
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet(), show_progress=False)
    tok.train_from_iterator([PROMPT_TEMPLATE.format(p) for p in (QWEN_PROMPT, " ", *PROMPTS)] * 4, trainer=trainer)
    tok.save(str(directory / "tokenizer.json"))
    cls = getattr(transformers, "Qwen2TokenizerFast", None) or transformers.Qwen2Tokenizer
    (directory / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": cls.__name__, "model_max_length": 32768, "eos_token": "<|im_end|>",
         "pad_token": "<|endoftext|>", "add_prefix_space": False}))
    return cls.from_pretrained(str(directory))


def _build_qwen_pipeline(transformer_cfg, text_cfg, vae_cfg, tokenizer, device, dtype):
    """A QwenImagePipeline with random weights from SEED: on the card the text
    tower and the transformer are built on the meta device and allocated a
    unit at a time (`_wan_random_model`), the VAE in float32, then cast."""
    import torch

    from diffusers_tpu_torch import (AutoencoderKLQwenImage, FlowMatchEulerDiscreteScheduler, QwenImagePipeline,
                                     Qwen2_5_VLTextEncoder, QwenImageTransformer2DModel)

    text_encoder = _wan_random_model(Qwen2_5_VLTextEncoder, text_cfg, device, dtype, SEED)
    transformer = _wan_random_model(QwenImageTransformer2DModel, transformer_cfg, device, dtype, SEED + 1)
    torch.manual_seed(SEED + 2)
    with torch.device(device):
        vae = AutoencoderKLQwenImage(**vae_cfg).to(dtype).eval()
    kwargs = {} if device == "cuda" else {"device": device}
    return QwenImagePipeline(scheduler=FlowMatchEulerDiscreteScheduler(**QWEN_SCHEDULER), vae=vae,
                             text_encoder=text_encoder, tokenizer=tokenizer, transformer=transformer, **kwargs)


def _qwen_requests(pipe, size, steps, edit_steps, text_len, generator):
    """(label, pipeline, kwargs) of the three Qwen-Image requests on `pipe`'s
    components: text-to-image, img2img and inpaint on a synthetic image."""
    from diffusers_tpu_torch import QwenImageImg2ImgPipeline, QwenImageInpaintPipeline

    image, mask, _ = synthetic_inputs(size)
    common = dict(true_cfg_scale=QWEN_TRUE_CFG, max_sequence_length=text_len, output_type="np")
    return (
        ("text2image", pipe, dict(height=size, width=size, num_inference_steps=steps, **common)),
        ("img2img", QwenImageImg2ImgPipeline.from_pipe(pipe),
         dict(image=image, strength=QWEN_STRENGTH, num_inference_steps=edit_steps[0], **common)),
        ("inpaint", QwenImageInpaintPipeline.from_pipe(pipe),
         dict(image=image, mask_image=mask, strength=QWEN_STRENGTH, num_inference_steps=edit_steps[1], **common)),
    )


def check_small_qwenimage(device: str = "cuda"):
    """Phase 10k: small Qwen-Image pipelines (SMALL_QWEN: head_dim 128, a
    2-layer Qwen2.5-VL tower, a 4-level Qwen-Image VAE; 64 px, 16 text
    tokens) on the card (bf16, K1) against the CPU (f32, plain versions; held
    to JAX by tests/test_torch_pipeline_qwenimage.py): text-to-image, img2img
    and inpaint, each step's launches held to the module counts (K1 one a
    block: the joint attention under the key-padding bias), phase 7's
    tolerance on the [0, 1] image. Both sides draw from one CPU generator
    seeded alike."""
    import numpy as np
    import torch

    tokenizer = qwen_tokenizer(ROOT / "build" / "qwen_tokenizer")
    cpu = _build_qwen_pipeline(SMALL_QWEN, SMALL_QWEN_TEXT, SMALL_QWEN_VAE, tokenizer, "cpu", torch.float32)
    card = _build_qwen_pipeline(SMALL_QWEN, SMALL_QWEN_TEXT, SMALL_QWEN_VAE, tokenizer, "cpu", torch.float32)
    card.to(device=torch.device(device), dtype=torch.bfloat16)
    tol = 0.05
    results = {}
    per_call = _module_launches(card.transformer)
    for (label, cpu_pipe, kwargs), (_, card_pipe, _) in zip(_qwen_requests(cpu, 64, 4, (5, 4), 16, None),
                                                            _qwen_requests(card, 64, 4, (5, 4), 16, None)):
        images = []
        for pipe in (cpu_pipe, card_pipe):
            reset_launches()
            with StepLaunches(pipe, pipe.transformer) as steps:
                images.append(pipe(QWEN_PROMPT, generator=torch.Generator().manual_seed(SEED), **kwargs).images)
        ref, out = images
        err = float(np.abs(out - ref).max())
        results[label] = {"max_abs_err": err, "tol": tol, "launches": read_launches(),
                          "steps": len(steps.per_step), "batches": steps.batches}
        log(f"[ref-qwen] small Qwen-Image {label}, card bf16 vs CPU f32: max |diff| {err:.3e} (tol {tol}); launches "
            f"{results[label]['launches']} over {len(steps.per_step)} steps (batches {steps.batches})")
        if not (out.shape == ref.shape == (1, 64, 64, 3) and np.isfinite(out).all() and err <= tol):
            raise AssertionError(f"small Qwen-Image {label}: the card disagrees with the CPU")
        _check_steps(f"small Qwen-Image {label}", steps.per_step, [per_call] * len(steps.per_step), steps.after,
                     _launches())
        if set(steps.batches) != {2} or per_call["flash_attention_fwd"] != SMALL_QWEN["num_layers"]:
            raise AssertionError(f"small Qwen-Image {label}: batches {steps.batches}, per call {per_call}")
    nets = [qwen_controlnet(p.transformer, 1) for p in (cpu, card)]
    outs = []
    for pipe, net in zip((cpu, card), nets):
        reset_launches()
        outs.append(qwen_controlnet_call(pipe.transformer, net, 16, 16, pipe.transformer.device)[0].float().cpu())
    ref, out = outs
    err = float((out - ref).abs().max()) / float(ref.abs().max())
    results["controlnet"] = {"max_abs_err_of_largest": err, "tol": tol, "launches": read_launches()}
    log(f"[ref-qwen] small Qwen-Image ControlNet (1 block, residual paths random) into the transformer, card bf16 vs "
        f"CPU f32: max |diff| {err:.3e} of the largest value (tol {tol}); launches {results['controlnet']['launches']}")
    if not (torch.isfinite(out).all() and err <= tol
            and read_launches() == _launches(flash_attention_fwd=1 + SMALL_QWEN["num_layers"])):
        raise AssertionError("small Qwen-Image ControlNet: the card disagrees with the CPU")
    RESULTS["small_qwenimage"] = results


def qwen_controlnet(transformer, num_layers):
    """`QwenImageControlNetModel.from_transformer(transformer, num_layers)`
    (its embedders and first blocks copied) with random residual projections
    and condition embedder from SEED, where an untrained net has zeros."""
    import torch

    from diffusers_tpu_torch import QwenImageControlNetModel

    c = transformer.config
    net = QwenImageControlNetModel.from_transformer(transformer, num_layers=num_layers,
                                                    attention_head_dim=c.attention_head_dim,
                                                    num_attention_heads=c.num_attention_heads)
    gen = torch.Generator().manual_seed(SEED + 5)
    with torch.no_grad():
        for lin in (*net.controlnet_blocks, net.controlnet_x_embedder):
            fan_in = lin.weight.shape[1]
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen) / fan_in ** 0.5)
            lin.bias.copy_(0.01 * torch.randn(lin.bias.shape, generator=gen))
    return net.eval()


def qwen_controlnet_call(transformer, net, side, text_len, device, spans=None):
    """(output, residuals) of one Qwen-Image transformer call at b=2 on a
    `side` x `side` packed latent grid, with `net`'s residuals of a random
    condition added by the interval rule; inputs drawn from SEED on the CPU,
    the text kept to QWEN_KEPT_TEXT tokens of `text_len`."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 6)
    dtype = next(transformer.parameters()).dtype
    c = transformer.config
    x, cond = (torch.randn((2, side * side, c.in_channels), generator=gen).to(device, dtype) for _ in range(2))
    text = torch.randn((2, text_len, c.joint_attention_dim), generator=gen).to(device, dtype)
    lengths = torch.tensor([min(k, text_len) for k in QWEN_KEPT_TEXT])
    mask = (torch.arange(text_len)[None] < lengths[:, None]).long().to(device)
    t = torch.tensor([0.9, 0.4], device=device, dtype=dtype)
    shapes = [(1, side, side)]  # one image a sample
    with torch.no_grad(), spans or contextlib.nullcontext():
        samples = net(x, cond, conditioning_scale=0.8, encoder_hidden_states=text, encoder_hidden_states_mask=mask,
                      timestep=t, img_shapes=shapes).controlnet_block_samples
        out = transformer(x, text, mask, t, img_shapes=shapes, controlnet_block_samples=samples).sample
    return out, samples


def run_qwenimage(smi: str):
    """Phase 27: Qwen-Image at its published widths (QWEN_IMAGE: 20.4 B;
    QWEN_TEXT: the 7.07 B Qwen2.5-VL tower; QWEN_VAE; random bf16 weights from
    SEED made on the card), with a Qwen2 BPE tokenizer written on the spot:
    one 1024 px text-to-image request through `QwenImagePipeline.__call__`
    (true CFG 4.0 as one batch-2 transformer call a step over 1,024 padded
    text + 4,096 image tokens; QWEN_STEPS steps), then img2img and inpaint
    on a synthetic image (3 and 2 transformer calls). Recorded: each
    transformer call, the text encodes, the VAE encode and decode on CUDA
    events, seconds a request, peak memory; every step's launches held to
    the module counts (K1 60 a call; the text tower's plain attention and the
    VAE launch nothing). Returns the paths' launches."""
    import gc

    import numpy as np
    import torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tokenizer = qwen_tokenizer(ROOT / "build" / "qwen_tokenizer")
    pipe = _build_qwen_pipeline(QWEN_IMAGE, QWEN_TEXT, QWEN_VAE, tokenizer, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = {name: sum(p.numel() for p in getattr(pipe, name).parameters())
                for name in ("transformer", "text_encoder", "vae")}
    resident_gb = torch.cuda.memory_allocated() / 1e9
    prefix = len(tokenizer(pipe.prompt_template_encode.format(""))["input_ids"])
    log(f"[qwen] built Qwen-Image at full width on the card in {build_s:.1f} s: parameters "
        f"{ {k: f'{v / 1e9:.3f} B' for k, v in n_params.items()} }, bf16, {resident_gb:.1f} GB resident; the "
        f"tokenizer's template takes {prefix} tokens around an empty prompt (Qwen's: 34 before it)")
    per_call = _module_launches(pipe.transformer)
    if per_call["flash_attention_fwd"] != 60:
        raise AssertionError(f"the Qwen-Image transformer counts {per_call} launches a call, expected K1 60")
    results, paths = {}, {}
    for label, pipeline, kwargs in _qwen_requests(pipe, RESOLUTION, QWEN_STEPS, QWEN_EDIT_STEPS, QWEN_TEXT_LEN,
                                                  None):
        reset_launches()
        spans = CudaSpans({"transformer": pipe.transformer, "text_encoder": pipe.text_encoder},
                          {"vae_decode": (pipe.vae, "decode"), "vae_encode": (pipe.vae, "encode")})
        with StepLaunches(pipeline, pipe.transformer) as steps, spans:
            images, seconds, peak_gb = _request_seconds(lambda: pipeline(
                QWEN_PROMPT, generator=torch.Generator(device="cuda").manual_seed(SEED), **kwargs).images)
        ms = spans.ms()
        _check_steps(f"qwen {label}", steps.per_step, [per_call] * len(steps.per_step), steps.after, _launches())
        expected_calls = {"text2image": QWEN_STEPS, "img2img": 3, "inpaint": 2}[label]
        if not (images.shape == (1, RESOLUTION, RESOLUTION, 3) and np.isfinite(images).all()
                and steps.batches == [2] * expected_calls):
            raise AssertionError(f"qwen {label}: images {images.shape}, batches {steps.batches}")
        row = {"seconds_per_image": seconds, "peak_memory_gb": peak_gb, "launches": read_launches(),
               "transformer_calls": len(ms["transformer"]), "transformer_ms_per_call": ms["transformer"],
               "transformer_ms_mean": float(np.mean(ms["transformer"])),
               "text_encode_ms": ms["text_encoder"], "vae_encode_ms": ms["vae_encode"],
               "vae_decode_ms": ms["vae_decode"], "image_mean": float(images.mean()), "image_std": float(images.std())}
        results[label] = row
        paths[f"qwenimage_{label}"] = row["launches"]
        log(f"[qwen] {smi}: {label}: {seconds:.2f} s an image ({RESOLUTION} px), {row['transformer_calls']} transformer "
            f"calls of {row['transformer_ms_mean']:.1f} ms (CUDA events; min {min(ms['transformer']):.1f}, max "
            f"{max(ms['transformer']):.1f}), text encodes {[round(t, 1) for t in ms['text_encoder']]} ms, VAE encode "
            f"{[round(t, 1) for t in ms['vae_encode']]} ms, decode {[round(t, 1) for t in ms['vae_decode']]} ms, peak "
            f"memory {peak_gb:.1f} GB; launches {row['launches']}")
    net = qwen_controlnet(pipe.transformer, QWEN_CONTROLNET_LAYERS)
    reset_launches()
    spans = CudaSpans({"controlnet": net, "transformer": pipe.transformer})
    (out, samples), seconds, peak_gb = _request_seconds(lambda: qwen_controlnet_call(
        pipe.transformer, net, RESOLUTION // 16, QWEN_TEXT_LEN, "cuda", spans))
    ms = spans.ms()
    launches = read_launches()
    if not (launches == _launches(flash_attention_fwd=QWEN_CONTROLNET_LAYERS + 60) and len(samples) ==
            QWEN_CONTROLNET_LAYERS and bool(torch.isfinite(out).all()) and tuple(out.shape) == (2, 4096, 64)):
        raise AssertionError(f"qwen controlnet: launches {launches}, {len(samples)} residuals, output {out.shape}")
    results["controlnet"] = {"layers": QWEN_CONTROLNET_LAYERS, "parameters": sum(p.numel() for p in net.parameters()),
                             "controlnet_ms": ms["controlnet"], "transformer_ms": ms["transformer"],
                             "seconds": seconds, "peak_memory_gb": peak_gb, "launches": launches}
    paths["qwenimage_controlnet"] = launches
    log(f"[qwen] {smi}: ControlNet ({QWEN_CONTROLNET_LAYERS} blocks from the transformer, "
        f"{results['controlnet']['parameters'] / 1e9:.3f} B) at b=2 over 1,024 + 4,096 tokens "
        f"{ms['controlnet'][0]:.1f} ms, then the transformer with its residuals {ms['transformer'][0]:.1f} ms (CUDA "
        f"events), peak memory {peak_gb:.1f} GB; launches {launches}")
    del net, samples, out
    RESULTS["qwenimage"] = {"card": smi, "steps": QWEN_STEPS, "edit_steps": QWEN_EDIT_STEPS, "strength": QWEN_STRENGTH,
                            "resolution": RESOLUTION, "true_cfg_scale": QWEN_TRUE_CFG, "text_tokens": QWEN_TEXT_LEN,
                            "build_seconds": build_s, "parameters": n_params, "resident_gb": resident_gb,
                            "template_tokens": prefix, "k1_per_call": per_call["flash_attention_fwd"], **results}
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def _build_ltx_pipeline(transformer_cfg, vae_cfg, t5_cfg, device, dtype):
    """An LTXPipeline with random weights from SEED (T5 and the transformer
    through `_wan_random_model`, the VAE in float32 then cast, its noise
    scales and latent statistics drawn from SEED)."""
    import torch

    from diffusers_tpu_torch import AutoencoderKLLTXVideo, FlowMatchEulerDiscreteScheduler, LTXPipeline, \
        LTXVideoTransformer3DModel
    from diffusers_tpu_torch.models.text_encoders.t5 import T5EncoderModel

    text_encoder = _wan_random_model(T5EncoderModel, t5_cfg, device, dtype, SEED)
    transformer = _wan_random_model(LTXVideoTransformer3DModel, transformer_cfg, device, dtype, SEED + 1)
    gen = torch.Generator().manual_seed(SEED + 2)
    torch.manual_seed(SEED + 2)
    with torch.device(device):
        vae = AutoencoderKLLTXVideo(**vae_cfg)
    with torch.no_grad():
        for name, p in vae.named_parameters():
            if "per_channel_scale" in name:
                p.copy_(0.05 * torch.randn(p.shape, generator=gen))
        c = vae.latents_mean.shape[0]
        vae.latents_mean.copy_(0.1 * torch.randn(c, generator=gen))
        vae.latents_std.copy_(1.0 + 0.2 * torch.rand(c, generator=gen))
    kwargs = {} if device == "cuda" else {"device": device}
    return LTXPipeline(scheduler=FlowMatchEulerDiscreteScheduler(**LTX_SCHEDULER), vae=vae.to(dtype).eval(),
                       text_encoder=text_encoder, tokenizer=StandInTokenizer(**T5_TOKENIZER), transformer=transformer,
                       **kwargs)


def ltx_step_launches(config, pipe, timesteps, fbc_decisions=None):
    """The launches expected at each denoise step of an LTX request under
    `config` (CFG as one batch-2 call a step), from the module counts and the
    cache's host-made schedule: a TaylorSeer or MagCache step that predicts,
    nothing; a FasterCache step, the pair's two calls or the cond call; a PAB
    broadcast step, the cross attentions alone; a FirstBlockCache step that
    skips, the first block's."""
    import numpy as np

    from diffusers_tpu_torch.hooks import (
        FasterCacheConfig,
        FirstBlockCacheConfig,
        MagCacheConfig,
        PyramidAttentionBroadcastConfig,
        TaylorSeerCacheConfig,
        faster_cache_schedules,
        mag_cache_compute_mask,
        pab_compute_mask,
        taylorseer_compute_mask,
    )

    tr, n = pipe.transformer, len(timesteps)
    full, none = _module_launches(tr), _launches()
    if isinstance(config, TaylorSeerCacheConfig):
        return [full if c else none for c in taylorseer_compute_mask(n, config)]
    if isinstance(config, MagCacheConfig):
        return [full if c else none for c in mag_cache_compute_mask(config)]
    if isinstance(config, FasterCacheConfig):
        skip = faster_cache_schedules(np.asarray(timesteps), config)[0]
        return [{k: (1 if s else 2) * v for k, v in full.items()} for s in skip]
    if isinstance(config, PyramidAttentionBroadcastConfig):
        mask = pab_compute_mask(np.asarray(timesteps), config.spatial_attention_block_skip_range,
                                config.spatial_attention_timestep_skip_range)
        return [full if c else _launches(flash_attention_fwd=len(tr.transformer_blocks)) for c in mask]
    if isinstance(config, FirstBlockCacheConfig):
        first = _module_launches(tr.transformer_blocks[0])
        return [full if c else first for c in fbc_decisions]
    return [full] * n  # dense, TextKV, a callback


def small_ltx_cases():
    """Phase 10l's text-to-video cases: (label, cache config or None, callback or None)."""
    from diffusers_tpu_torch.hooks import (
        FasterCacheConfig,
        FirstBlockCacheConfig,
        MagCacheConfig,
        PyramidAttentionBroadcastConfig,
        TaylorSeerCacheConfig,
        TextKVCacheConfig,
    )

    n = SMALL_CACHE_STEPS
    return (
        ("dense", None, None),
        ("taylorseer", TaylorSeerCacheConfig(cache_interval=3, disable_cache_before_step=2, max_order=2), None),
        ("mag_cache", MagCacheConfig(threshold=0.5, max_skip_steps=1, retention_ratio=0.25, num_inference_steps=n,
                                     mag_ratios=(1.0,) * n), None),
        ("text_kv", TextKVCacheConfig(), None),
        ("faster_cache", FasterCacheConfig(unconditional_batch_skip_range=3,
                                           unconditional_batch_timestep_skip_range=(-1, 1000)), None),
        ("pab", PyramidAttentionBroadcastConfig(spatial_attention_timestep_skip_range=(100, 950)), None),
        ("first_block_cache", FirstBlockCacheConfig(threshold=SMALL_FBC_THRESHOLD), None),
        ("callback_latents", None, lambda p, i, t, kw: {"latents": kw["latents"] * 0.5} if i == 3 else {}),
    )


def check_small_ltx(device: str = "cuda"):
    """Phase 10l: small LTX-Video pipelines (SMALL_LTX: head_dim 64; a
    timestep-conditioned VAE with noise; 9 frames of 64 x 64) on the card
    (bf16, K1; the upsampler's K4) against the CPU (f32, plain versions; held
    to JAX by tests/test_torch_pipeline_ltx.py, test_torch_ltx_condition.py
    and test_torch_ltx_i2v.py): text-to-video dense, with each of the six
    caches and with a step callback, each step's launches held to the cache's
    schedule (`ltx_step_launches`); image-to-video; a condition request (an
    image at frame 0, a 5-frame video at frame 4); the latent upsampler (K4 5
    a call at 1 block a stage) with its pipeline's latent output. Phase 7's
    tolerance on the [0, 1] frames and on the latents' largest value. Both
    sides draw from one CPU generator seeded alike."""
    import numpy as np
    import torch

    from diffusers_tpu_torch import (FlowMatchEulerDiscreteScheduler, LTXConditionPipeline, LTXImageToVideoPipeline,
                                     LTXLatentUpsamplePipeline, LTXLatentUpsamplerModel, LTXVideoCondition)

    sides = [_build_ltx_pipeline(SMALL_LTX, SMALL_LTX_VAE, SMALL_LTX_T5, "cpu", torch.float32) for _ in range(2)]
    torch.manual_seed(SEED + 3)
    upsampler = LTXLatentUpsamplerModel(**SMALL_LTX_UPSAMPLER).eval()
    upsamplers = [upsampler, _copy_model(upsampler).to(device=torch.device(device), dtype=torch.bfloat16)]
    sides[1].to(device=torch.device(device), dtype=torch.bfloat16)
    tol = 0.05
    video = synthetic_video(9, 64, 64)
    call = dict(height=64, width=64, num_frames=9, guidance_scale=LTX_GUIDANCE, max_sequence_length=32,
                decode_timestep=LTX_DECODE_TIMESTEP, decode_noise_scale=LTX_DECODE_NOISE_SCALE)
    results = {}

    def compare(label, outs, shape, scale=1.0):
        ref, out = (o.float().cpu().numpy() if isinstance(o, torch.Tensor) else o for o in outs)
        ref, out = np.asarray(ref, np.float32), np.asarray(out, np.float32)
        err = float(np.abs(out - ref).max()) / scale
        results[label] = dict(results.get(label, {}), max_abs_err=err, tol=tol, launches=read_launches())
        log(f"[ref-ltx] small LTX {label}, card bf16 vs CPU f32: max |diff| {err:.3e}"
            f"{' of the largest value' if scale != 1.0 else ''} (tol {tol}); launches {results[label]['launches']}")
        if not (out.shape == ref.shape == shape and np.isfinite(out).all() and err <= tol):
            raise AssertionError(f"small LTX {label}: the card disagrees with the CPU ({out.shape}, {err})")

    for label, config, callback in small_ltx_cases():
        outs = []
        for pipe in sides:
            if config is not None:
                pipe.enable_cache(config)
            reset_launches()
            try:
                with StepLaunches(pipe, pipe.transformer) as steps:
                    outs.append(pipe(LTX_PROMPT, LTX_NEGATIVE, num_inference_steps=SMALL_CACHE_STEPS,
                                     generator=torch.Generator().manual_seed(SEED), callback_on_step_end=callback,
                                     **call).frames)
            finally:
                pipe.disable_cache()
        compare(label, outs, (1, 9, 64, 64, 3))
        decisions = pipe.fbc_record["decisions"] if label == "first_block_cache" else None
        _check_steps(f"small LTX {label}", steps.per_step, ltx_step_launches(config, pipe, steps.timesteps, decisions),
                     steps.after, _launches())
        results[label]["transformer_batches"] = steps.batches

    edit = dict(call, num_inference_steps=4)
    cond_sched = dict(scheduler=FlowMatchEulerDiscreteScheduler(shift=1.0))  # the condition pipeline sets timesteps
    for label, make, args in (
            ("image2video", lambda p: LTXImageToVideoPipeline.from_pipe(p), dict(image=video[0])),
            ("condition", lambda p: LTXConditionPipeline.from_pipe(p, **cond_sched),
             dict(conditions=[LTXVideoCondition(image=video[0], frame_index=0, strength=1.0),
                              LTXVideoCondition(video=video[:5], frame_index=4, strength=0.8)]))):
        outs = []
        for pipe in sides:
            pipeline = make(pipe)
            reset_launches()
            with StepLaunches(pipeline, pipeline.transformer) as steps:
                outs.append(pipeline(prompt=LTX_PROMPT, negative_prompt=LTX_NEGATIVE,
                                     generator=torch.Generator().manual_seed(SEED), **args, **edit).frames)
        compare(label, outs, (1, 9, 64, 64, 3))
        _check_steps(f"small LTX {label}", steps.per_step, [_module_launches(pipeline.transformer)] * 4, steps.after,
                     _launches())

    outs = []
    latents = torch.from_numpy(np.random.RandomState(SEED).randn(1, 16, 3, 8, 8).astype(np.float32))
    for pipe, up in zip(sides, upsamplers):
        reset_launches()
        outs.append(LTXLatentUpsamplePipeline(vae=pipe.vae, latent_upsampler=up, device=up.device)(
            latents=latents, adain_factor=1.0, output_type="latent").frames)
    ref = outs[0]
    compare("latent_upsample", outs, (1, 16, 3, 16, 16), scale=float(ref.abs().max()))
    if read_launches()["group_norm"] != 5:
        raise AssertionError(f"the small upsampler launched {read_launches()}, expected K4 5")
    RESULTS["small_ltx"] = results


def run_ltx(smi: str):
    """Phase 28: LTX-Video at full width (LTX_VIDEO: 28 blocks of 32 x 64
    heads; T5-XXL at 128 tokens; the 0.9.1-style timestep-conditioned VAE;
    random bf16 weights from SEED made on the card): one 512 x 704 x 161
    request through `LTXPipeline.__call__` (CFG 3.0 as one batch-2 call a step
    over 7,392 tokens, LTX_STEPS steps; the decode at LTX_DECODE_TIMESTEP with
    noise), then image-to-video and a condition request (an image at frame
    0, a 17-frame video at frame 80: 704 prefix tokens), LTX_EDIT_STEPS steps
    each without decode, then the latent upsampler (LTX_UPSAMPLER) through
    `LTXLatentUpsamplePipeline` on the first request's latents. Recorded:
    each transformer call, the T5 encodes, the VAE encodes and the decode on
    CUDA events, seconds a request, peak memory; every step's launches held
    to the module counts (K1 56 a call: 28 self + 28 cross), K4 17 an
    upsampler call. Returns the paths' launches."""
    import gc

    import numpy as np
    import torch

    from diffusers_tpu_torch import (FlowMatchEulerDiscreteScheduler, LTXConditionPipeline, LTXImageToVideoPipeline,
                                     LTXLatentUpsamplePipeline, LTXLatentUpsamplerModel, LTXVideoCondition)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = _build_ltx_pipeline(LTX_VIDEO, LTX_VAE, T5_XXL, "cuda", torch.bfloat16)
    torch.manual_seed(SEED + 4)
    with torch.device("cuda"):
        upsampler = LTXLatentUpsamplerModel(**LTX_UPSAMPLER).to(torch.bfloat16).eval()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = {name: sum(p.numel() for p in getattr(pipe, name).parameters())
                for name in ("transformer", "text_encoder", "vae")}
    n_params["latent_upsampler"] = sum(p.numel() for p in upsampler.parameters())
    resident_gb = torch.cuda.memory_allocated() / 1e9
    log(f"[ltx] built LTX-Video at full width on the card in {build_s:.1f} s: parameters "
        f"{ {k: f'{v / 1e9:.3f} B' for k, v in n_params.items()} }, bf16, {resident_gb:.1f} GB resident")
    per_call = _module_launches(pipe.transformer)
    if per_call["flash_attention_fwd"] != 56:
        raise AssertionError(f"the LTX transformer counts {per_call} launches a call, expected K1 56")
    video = synthetic_video(17, LTX_HEIGHT, LTX_WIDTH)
    common = dict(prompt=LTX_PROMPT, negative_prompt=LTX_NEGATIVE, height=LTX_HEIGHT, width=LTX_WIDTH,
                  num_frames=LTX_FRAMES, frame_rate=LTX_FRAME_RATE, guidance_scale=LTX_GUIDANCE,
                  max_sequence_length=LTX_TEXT_LEN, decode_timestep=LTX_DECODE_TIMESTEP,
                  decode_noise_scale=LTX_DECODE_NOISE_SCALE)
    requests = (
        ("text2video", pipe, dict(num_inference_steps=LTX_STEPS, output_type="np"), LTX_STEPS),
        ("image2video", LTXImageToVideoPipeline.from_pipe(pipe),
         dict(image=video[0], num_inference_steps=LTX_EDIT_STEPS, output_type="latent"), LTX_EDIT_STEPS),
        ("condition", LTXConditionPipeline.from_pipe(pipe, scheduler=FlowMatchEulerDiscreteScheduler(shift=1.0)),
         dict(conditions=[LTXVideoCondition(image=video[0], frame_index=0, strength=1.0),
                          LTXVideoCondition(video=video, frame_index=80, strength=0.8)],
              num_inference_steps=LTX_EDIT_STEPS, output_type="latent"), LTX_EDIT_STEPS),
    )
    captured = {}
    decode = pipe.decode_latents
    pipe.decode_latents = lambda latents, *a, **k: decode(captured.setdefault("latents", latents), *a, **k)
    results, paths = {}, {}
    try:
        for label, pipeline, kwargs, n_steps in requests:
            reset_launches()
            spans = CudaSpans({"transformer": pipe.transformer, "text_encoder": pipe.text_encoder},
                              {"vae_decode": (pipe.vae, "decode"), "vae_encode": (pipe.vae, "encode")})
            with StepLaunches(pipeline, pipe.transformer) as steps, spans:
                out, seconds, peak_gb = _request_seconds(lambda: pipeline(
                    generator=torch.Generator(device="cuda").manual_seed(SEED), **common, **kwargs).frames)
            ms = spans.ms()
            _check_steps(f"ltx {label}", steps.per_step, [per_call] * n_steps, steps.after, _launches())
            shape = {"text2video": (1, LTX_FRAMES, LTX_HEIGHT, LTX_WIDTH, 3), "image2video": (1, LTX_TOKENS, 128),
                     "condition": (1, 128, 21, LTX_HEIGHT // 32, LTX_WIDTH // 32)}[label]  # i2v's latents are packed
            finite = bool(np.isfinite(out).all()) if isinstance(out, np.ndarray) else bool(torch.isfinite(out).all())
            if not (tuple(out.shape) == shape and finite and steps.batches == [2] * n_steps):
                raise AssertionError(f"ltx {label}: output {tuple(out.shape)}, batches {steps.batches}")
            row = {"seconds_per_video": seconds, "peak_memory_gb": peak_gb, "launches": read_launches(),
                   "transformer_calls": len(ms["transformer"]), "transformer_ms_per_call": ms["transformer"],
                   "transformer_ms_mean": float(np.mean(ms["transformer"])), "text_encode_ms": ms["text_encoder"],
                   "vae_encode_ms": ms["vae_encode"], "vae_decode_ms": ms["vae_decode"],
                   "tokens": LTX_TOKENS + (704 if label == "condition" else 0)}
            results[label] = row
            paths[f"ltx_{label}"] = row["launches"]
            log(f"[ltx] {smi}: {label}: {seconds:.2f} s a request ({LTX_FRAMES} x {LTX_HEIGHT} x {LTX_WIDTH}, "
                f"{n_steps} steps, {row['tokens']} tokens), {row['transformer_calls']} transformer calls of "
                f"{row['transformer_ms_mean']:.1f} ms (CUDA events; min {min(ms['transformer']):.1f}, max "
                f"{max(ms['transformer']):.1f}), T5 encodes {[round(t, 1) for t in ms['text_encoder']]} ms, VAE "
                f"encodes {[round(t, 1) for t in ms['vae_encode']]} ms, decode {[round(t, 1) for t in ms['vae_decode']]}"
                f" ms, peak memory {peak_gb:.1f} GB; launches {row['launches']}")
    finally:
        del pipe.decode_latents

    upsample = LTXLatentUpsamplePipeline(vae=pipe.vae, latent_upsampler=upsampler)
    latents = captured["latents"]
    reset_launches()
    spans = CudaSpans({"upsampler": upsampler})
    with spans:
        up, seconds, peak_gb = _request_seconds(lambda: upsample(latents=latents, adain_factor=1.0,
                                                                 output_type="latent").frames)
    launches = read_launches()
    if not (tuple(up.shape) == (1, 128, 21, 32, 44) and bool(torch.isfinite(up).all())
            and launches == _launches(group_norm=17)):
        raise AssertionError(f"ltx upsampler: output {tuple(up.shape)}, launches {launches}")
    results["latent_upsample"] = {"seconds": seconds, "peak_memory_gb": peak_gb, "launches": launches,
                                  "upsampler_ms": spans.ms()["upsampler"]}
    paths["ltx_latent_upsample"] = launches
    log(f"[ltx] {smi}: latent upsampler on the request's latents {tuple(latents.shape)} -> {tuple(up.shape)}: "
        f"{seconds:.3f} s, the model {spans.ms()['upsampler'][0]:.1f} ms (CUDA events), peak memory {peak_gb:.1f} GB; "
        f"launches {launches}")
    RESULTS["ltx"] = {"card": smi, "steps": LTX_STEPS, "edit_steps": LTX_EDIT_STEPS, "frames": LTX_FRAMES,
                      "height": LTX_HEIGHT, "width": LTX_WIDTH, "guidance_scale": LTX_GUIDANCE,
                      "text_tokens": LTX_TEXT_LEN, "build_seconds": build_s, "parameters": n_params,
                      "resident_gb": resident_gb, "k1_per_call": per_call["flash_attention_fwd"], **results}
    del pipe, upsample, upsampler
    gc.collect()
    torch.cuda.empty_cache()
    return paths


class WordTokenizer:
    """Deterministic word-level stand-in for HunyuanVideo's Llama-3
    tokenizer (no vocabulary in the repository): BOS, one id a
    whitespace-separated word from a CRC of it, EOS; padded with 0 to
    `max_length` (a row longer than it kept whole with `truncation=False`),
    with the attention mask."""

    def __init__(self, vocab_size: int = HUNYUAN_LLAMA_VOCAB, bos: int = 128000, eos: int = 128009):
        self.vocab_size, self.bos, self.eos = vocab_size, bos, eos

    def ids(self, text: str):
        return [self.bos] + [zlib.crc32(w.encode("utf-8")) % 120000 + 10 for w in text.split()] + [self.eos]

    def __call__(self, texts, padding=None, max_length=256, truncation=True, return_tensors="np"):
        import numpy as np

        class Out:
            pass

        rows = [self.ids(t) for t in ([texts] if isinstance(texts, str) else texts)]
        width = max_length if truncation else max(max_length, *map(len, rows))
        out = Out()
        out.input_ids = np.array([(r + [0] * width)[:width] for r in rows], dtype=np.int64)
        out.attention_mask = (out.input_ids != 0).astype(np.int64)
        return out


def hunyuan_template():
    """HunyuanVideo's Llama template with the crop the stand-in tokenizer
    gives it: BOS and the template's words before the prompt (the real
    tokenizer's 95)."""
    from diffusers_tpu_torch.pipelines.hunyuan_video import DEFAULT_PROMPT_TEMPLATE

    prefix = DEFAULT_PROMPT_TEMPLATE["template"].split("{}")[0]
    return dict(DEFAULT_PROMPT_TEMPLATE, crop_start=len(WordTokenizer().ids(prefix)) - 1)


class SiglipResize:
    """Stand-in for SigLIP's image processor on the card's machine: NCHW
    images in [0, 1] resized (bilinear) to `size` and mapped to [-1, 1]."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, images, return_tensors="np", do_rescale=False):
        import torch
        import torch.nn.functional as F

        x = torch.as_tensor(images, dtype=torch.float32)
        x = F.interpolate(x, size=(self.size, self.size), mode="bilinear", align_corners=False)
        return {"pixel_values": (x * 2.0 - 1.0).numpy()}


def _build_hunyuan_pipeline(transformer_cfg, llama_cfg, clip_cfg, vae_cfg, device, dtype):
    """A HunyuanVideoPipeline with random weights from SEED: the Llama tower
    and the transformer through `_wan_random_model`, CLIP-L and the VAE
    built in float32 then cast."""
    import torch

    from diffusers_tpu_torch import (AutoencoderKLHunyuanVideo, FlowMatchEulerDiscreteScheduler, HunyuanVideoPipeline,
                                     HunyuanVideoTransformer3DModel, LlamaModel)
    from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel

    text_encoder = _wan_random_model(LlamaModel, llama_cfg, device, dtype, SEED)
    transformer = _wan_random_model(HunyuanVideoTransformer3DModel, transformer_cfg, device, dtype, SEED + 1)
    torch.manual_seed(SEED + 2)
    with torch.device(device):
        text_encoder_2 = CLIPTextModel(**clip_cfg).to(dtype).eval()
        vae = AutoencoderKLHunyuanVideo(**vae_cfg).to(dtype).eval()
    kwargs = {} if device == "cuda" else {"device": device}
    return HunyuanVideoPipeline(text_encoder=text_encoder, tokenizer=WordTokenizer(), transformer=transformer, vae=vae,
                                scheduler=FlowMatchEulerDiscreteScheduler(shift=HUNYUAN_SHIFT),
                                text_encoder_2=text_encoder_2, tokenizer_2=StandInTokenizer(), **kwargs)


def _framepack_from(base, transformer_cfg, siglip_cfg, device, dtype, image_size):
    """A HunyuanVideoFramepackPipeline on `base`'s Llama tower, CLIP-L, VAE
    and scheduler, with a FramePack transformer of `transformer_cfg` and a
    SigLIP of `siglip_cfg`, random from SEED."""
    from diffusers_tpu_torch import HunyuanVideoFramepackPipeline, HunyuanVideoFramepackTransformer3DModel
    from diffusers_tpu_torch.models.text_encoders.siglip import SiglipVisionModel

    cfg = dict(transformer_cfg, **FRAMEPACK, image_proj_dim=siglip_cfg["hidden_size"])  # 1,152: so400m's width
    transformer = _wan_random_model(HunyuanVideoFramepackTransformer3DModel, cfg, device, dtype, SEED + 3)
    siglip = _wan_random_model(SiglipVisionModel, siglip_cfg, device, dtype, SEED + 4)
    parts = {k: v for k, v in base.components.items() if k != "transformer"}
    kwargs = {} if device == "cuda" else {"device": device}
    return HunyuanVideoFramepackPipeline(transformer=transformer, image_encoder=siglip,
                                         feature_extractor=SiglipResize(image_size), **{**parts, **kwargs})


def hunyuan_step_launches(config, pipe, n_steps):
    """The launches expected at each denoise step of a HunyuanVideo request
    (one call a step, two under true CFG): the module counts, or nothing on a
    step TaylorSeer or MagCache predicts; under TextKV the refiner's first
    attention runs once a request, before the first step."""
    from diffusers_tpu_torch.hooks import MagCacheConfig, TaylorSeerCacheConfig, TextKVCacheConfig
    from diffusers_tpu_torch.hooks import mag_cache_compute_mask, taylorseer_compute_mask

    full, none = _module_launches(pipe.transformer), _launches()
    if isinstance(config, TaylorSeerCacheConfig):
        return [full if c else none for c in taylorseer_compute_mask(n_steps, config)]
    if isinstance(config, MagCacheConfig):
        return [full if c else none for c in mag_cache_compute_mask(config)]
    if isinstance(config, TextKVCacheConfig):
        cached = dict(full, flash_attention_fwd=full["flash_attention_fwd"] - 1)
        return [full] + [cached] * (n_steps - 1)
    return [full] * n_steps


def small_hunyuan_cases():
    """Phase 10m's text-to-video cases: (label, cache config or None, extra call arguments)."""
    from diffusers_tpu_torch.hooks import MagCacheConfig, TaylorSeerCacheConfig, TextKVCacheConfig

    n = SMALL_CACHE_STEPS
    return (
        ("dense", None, {}),
        ("true_cfg", None, dict(negative_prompt="blurry, low quality", true_cfg_scale=3.0)),
        ("taylorseer", TaylorSeerCacheConfig(cache_interval=3, disable_cache_before_step=2, max_order=2), {}),
        ("mag_cache", MagCacheConfig(threshold=0.5, max_skip_steps=1, retention_ratio=0.25, num_inference_steps=n,
                                     mag_ratios=(1.0,) * n), {}),
        ("text_kv", TextKVCacheConfig(), {}),
    )


def check_small_hunyuan_video(device: str = "cuda"):
    """Phases 10m and 10n: small HunyuanVideo and FramePack pipelines
    (SMALL_HUNYUAN: head_dim 128, a 3-layer Llama, a 1-layer CLIP, a VAE of
    widths 32; 9 frames of 64 x 64) on the card (bf16, K1, K4) against the
    CPU (f32, plain versions; held to JAX by
    tests/test_torch_pipeline_hunyuan_video.py and test_torch_framepack.py):
    text-to-video dense, under true CFG and with TaylorSeer, MagCache and
    TextKV, each step's launches held to the schedule
    (`hunyuan_step_launches`) and the decode's to the decoder's GroupNorms;
    then FramePack image-to-video over two sections in both sampling orders
    (a 64 px SigLIP), each section's calls held to the module counts. Phase
    7's tolerance on the [0, 1] frames. Both sides draw from one CPU
    generator seeded alike."""
    import numpy as np
    import torch

    sides = [_build_hunyuan_pipeline(SMALL_HUNYUAN, SMALL_HUNYUAN_LLAMA, SMALL_HUNYUAN_CLIP, SMALL_HUNYUAN_VAE, "cpu",
                                     torch.float32) for _ in range(2)]
    packs = [_framepack_from(p, SMALL_HUNYUAN, SMALL_FRAMEPACK_SIGLIP, "cpu", torch.float32, 64) for p in sides]
    for pipe in (sides[1], packs[1]):
        pipe.to(device=torch.device(device), dtype=torch.bfloat16)
    tol = 0.05
    template = hunyuan_template()
    call = dict(height=64, width=64, num_frames=9, guidance_scale=HUNYUAN_GUIDANCE, max_sequence_length=32,
                prompt_template=template)
    decode = _module_launches(sides[1].vae.decoder)
    results = {}

    def compare(label, outs, shape):
        ref, out = (np.asarray(o, np.float32) for o in outs)
        err = float(np.abs(out - ref).max())
        results[label] = dict(results.get(label, {}), max_abs_err=err, tol=tol, launches=read_launches())
        log(f"[ref-hunyuan] small {label}, card bf16 vs CPU f32: max |diff| {err:.3e} (tol {tol}); launches "
            f"{results[label]['launches']}")
        if not (out.shape == ref.shape == shape and np.isfinite(out).all() and err <= tol):
            raise AssertionError(f"small {label}: the card disagrees with the CPU ({out.shape}, {err})")

    for label, config, extra in small_hunyuan_cases():
        outs = []
        for pipe in sides:
            if config is not None:
                pipe.enable_cache(config)
            reset_launches()
            try:
                with StepLaunches(pipe, pipe.transformer) as steps:
                    outs.append(pipe(HUNYUAN_PROMPT, num_inference_steps=SMALL_CACHE_STEPS,
                                     generator=torch.Generator().manual_seed(SEED), **call, **extra).frames)
            finally:
                pipe.disable_cache()
        compare(f"HunyuanVideo {label}", outs, (1, 9, 64, 64, 3))
        expected = hunyuan_step_launches(config, pipe, SMALL_CACHE_STEPS)
        if label == "true_cfg":
            expected = [{k: 2 * v for k, v in e.items()} for e in expected]
        _check_steps(f"small HunyuanVideo {label}", steps.per_step, expected, steps.after, decode)
        results[f"HunyuanVideo {label}"]["transformer_batches"] = steps.batches

    image = synthetic_video(1, 64, 64)[0]
    per_call = _module_launches(packs[1].transformer)
    for order in ("inverted_anti_drifting", "vanilla"):
        outs = []
        for pipe in packs:
            reset_launches()
            with StepLaunches(pipe, pipe.transformer) as steps:
                outs.append(pipe(image=image, prompt=HUNYUAN_PROMPT, latent_window_size=2, num_inference_steps=3,
                                 sampling_type=order, generator=torch.Generator().manual_seed(SEED),
                                 **dict(call, num_frames=10)).frames)
        label = f"FramePack {order}"
        compare(label, outs, outs[0].shape)
        if outs[0].shape[1] < 10 or steps.batches != [1] * 6:
            raise AssertionError(f"small {label}: frames {outs[0].shape}, batches {steps.batches}")
        # each step one call; the VAE's image encode (before the first step) and the first section's decode
        # (before the second section's first step) add the VAE's GroupNorms
        calls = [dict(per_call) for _ in steps.per_step]
        for i in (0, 3):
            calls[i]["group_norm"] = steps.per_step[i]["group_norm"]
        _check_steps(f"small {label}", steps.per_step, calls, steps.after, decode)
        if not (steps.per_step[0]["group_norm"] == _module_launches(pipe.vae.encoder)["group_norm"]
                and steps.per_step[3]["group_norm"] == decode["group_norm"]):
            raise AssertionError(f"small {label}: the VAE's launches {steps.per_step[0]}, {steps.per_step[3]}")
    RESULTS["small_hunyuan_video"] = results


def run_hunyuan_video(smi: str):
    """Phase 29: HunyuanVideo at its published widths (HUNYUAN_VIDEO: the
    13 B transformer; HUNYUAN_LLAMA: the 8 B llava-llama-3 text tower;
    CLIP-L; HUNYUAN_VAE; random bf16 weights from SEED made on the card):
    one 320 x 512 x 61 text-to-video request through
    `HunyuanVideoPipeline.__call__` (guidance 6.0 distilled: one batch-1 call
    a step over 10,240 image + 256 text tokens, HUNYUAN_STEPS steps) with
    the decode, then one TaylorSeer request (latents) held to its schedule.
    Recorded: each transformer call, the Llama and CLIP encodes and the
    decode on CUDA events, seconds a request, peak memory; every step's
    launches held to the module counts (K1 62 a call: 60 joint attentions
    under the key-padding bias and the refiner's 2), the decode's to the
    decoder's GroupNorms (K4; its d = 512 attention runs `native`). Returns
    (the paths' launches, the pipeline)."""
    import numpy as np
    import torch

    from diffusers_tpu_torch.hooks import TaylorSeerCacheConfig

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = _build_hunyuan_pipeline(HUNYUAN_VIDEO, HUNYUAN_LLAMA, CLIP_L, HUNYUAN_VAE, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = {name: sum(p.numel() for p in getattr(pipe, name).parameters())
                for name in ("transformer", "text_encoder", "text_encoder_2", "vae")}
    resident_gb = torch.cuda.memory_allocated() / 1e9
    template = hunyuan_template()
    log(f"[hunyuan] built HunyuanVideo at full width on the card in {build_s:.1f} s: parameters "
        f"{ {k: f'{v / 1e9:.3f} B' for k, v in n_params.items()} }, bf16, {resident_gb:.1f} GB resident; the stand-in "
        f"tokenizer's template crop {template['crop_start']} (the real tokenizer's 95)")
    per_call = _module_launches(pipe.transformer)
    decode = _module_launches(pipe.vae.decoder)
    if per_call["flash_attention_fwd"] != 62 or decode["flash_attention_fwd"] != 0:
        raise AssertionError(f"HunyuanVideo counts {per_call} launches a call and {decode} a decode, expected K1 62")
    _, _, mask = pipe.encode_prompt(HUNYUAN_PROMPT, prompt_template=template, max_sequence_length=HUNYUAN_TEXT_LEN)
    if int(mask.sum()) != HUNYUAN_KEPT_TEXT[0]:
        raise AssertionError(f"the prompt keeps {int(mask.sum())} text tokens, phase 3 checked {HUNYUAN_KEPT_TEXT}")
    common = dict(prompt=HUNYUAN_PROMPT, height=HUNYUAN_HEIGHT, width=HUNYUAN_WIDTH, num_frames=HUNYUAN_FRAMES,
                  num_inference_steps=HUNYUAN_STEPS, guidance_scale=HUNYUAN_GUIDANCE,
                  max_sequence_length=HUNYUAN_TEXT_LEN, prompt_template=template)
    requests = (("text2video", None, dict(output_type="np")),
                ("taylorseer", TaylorSeerCacheConfig(**HUNYUAN_TAYLORSEER), dict(output_type="latent")))
    results, paths = {}, {}
    for label, config, kwargs in requests:
        if config is not None:
            pipe.enable_cache(config)
        reset_launches()
        spans = CudaSpans({"transformer": pipe.transformer, "text_encoder": pipe.text_encoder,
                           "text_encoder_2": pipe.text_encoder_2}, {"vae_decode": (pipe.vae, "decode")})
        try:
            with StepLaunches(pipe, pipe.transformer) as steps, spans:
                out, seconds, peak_gb = _request_seconds(lambda: pipe(
                    generator=torch.Generator(device="cuda").manual_seed(SEED), **common, **kwargs).frames)
        finally:
            pipe.disable_cache()
        ms = spans.ms()
        expected = hunyuan_step_launches(config, pipe, HUNYUAN_STEPS)
        _check_steps(f"hunyuan {label}", steps.per_step, expected, steps.after,
                     decode if kwargs["output_type"] == "np" else _launches())
        shape = ((1, HUNYUAN_FRAMES, HUNYUAN_HEIGHT, HUNYUAN_WIDTH, 3) if kwargs["output_type"] == "np"
                 else (1, 16, 16, HUNYUAN_HEIGHT // 8, HUNYUAN_WIDTH // 8))
        finite = bool(np.isfinite(out).all()) if isinstance(out, np.ndarray) else bool(torch.isfinite(out).all())
        calls = sum(e["flash_attention_fwd"] > 0 for e in expected)
        if not (tuple(out.shape) == shape and finite and steps.batches == [1] * calls):
            raise AssertionError(f"hunyuan {label}: output {tuple(out.shape)}, batches {steps.batches}")
        row = {"seconds_per_video": seconds, "peak_memory_gb": peak_gb, "launches": read_launches(),
               "transformer_calls": len(ms["transformer"]), "transformer_ms_per_call": ms["transformer"],
               "transformer_ms_mean": float(np.mean(ms["transformer"])), "llama_encode_ms": ms["text_encoder"],
               "clip_encode_ms": ms["text_encoder_2"], "vae_decode_ms": ms["vae_decode"],
               "tokens": HUNYUAN_JOINT_ATTENTION[1], "per_step_launches": steps.per_step}
        results[label] = row
        paths[f"hunyuan_video_{label}"] = row["launches"]
        log(f"[hunyuan] {smi}: {label}: {seconds:.2f} s a request ({HUNYUAN_FRAMES} x {HUNYUAN_HEIGHT} x "
            f"{HUNYUAN_WIDTH}, {HUNYUAN_STEPS} steps, {row['tokens']} tokens), {row['transformer_calls']} transformer "
            f"calls of {row['transformer_ms_mean']:.1f} ms (CUDA events; min {min(ms['transformer']):.1f}, max "
            f"{max(ms['transformer']):.1f}), Llama encode {[round(t, 1) for t in ms['text_encoder']]} ms, CLIP "
            f"{[round(t, 1) for t in ms['text_encoder_2']]} ms, decode {[round(t, 1) for t in ms['vae_decode']]} ms, "
            f"peak memory {peak_gb:.1f} GB; launches {row['launches']}")
    RESULTS["hunyuan_video"] = {"card": smi, "steps": HUNYUAN_STEPS, "frames": HUNYUAN_FRAMES, "height": HUNYUAN_HEIGHT,
                                "width": HUNYUAN_WIDTH, "guidance_scale": HUNYUAN_GUIDANCE,
                                "text_tokens": HUNYUAN_TEXT_LEN, "build_seconds": build_s, "parameters": n_params,
                                "resident_gb": resident_gb, "k1_per_call": per_call["flash_attention_fwd"],
                                "k4_per_decode": decode["group_norm"], **results}
    return paths, pipe


def run_framepack(smi: str, base):
    """Phase 30: FramePack at its published widths (HunyuanVideo's plus
    FRAMEPACK's SigLIP projection and history embedders; SigLIP so400m at 384
    px; random bf16 weights from SEED) on phase 29's Llama tower, CLIP-L and
    VAE: one 832 x 480 image-to-video request through
    `HunyuanVideoFramepackPipeline.__call__`, 2 sections of FRAMEPACK_WINDOW
    latent frames and FRAMEPACK_STEPS steps, in each sampling order.
    Recorded: each transformer call, the SigLIP, Llama and CLIP encodes, the
    VAE encode and each section's decode on CUDA events, seconds a request,
    peak memory; every step's K1 held to the module counts (62 a call), the
    VAE's K4 to its encoder's and decoder's GroupNorms; the joint attention's
    length and the VAE's largest GroupNorm spans held to the shapes phases 3
    and 4 check K1 and K4 at. Returns the paths' launches."""
    import gc

    import numpy as np
    import torch

    base.transformer = None  # the text-to-video transformer makes room for FramePack's
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = _framepack_from(base, HUNYUAN_VIDEO, SIGLIP_SO400M, "cuda", torch.bfloat16, SIGLIP_SO400M["image_size"])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = {name: sum(p.numel() for p in getattr(pipe, name).parameters())
                for name in ("transformer", "image_encoder")}
    resident_gb = torch.cuda.memory_allocated() / 1e9
    log(f"[framepack] built FramePack's transformer and SigLIP on the card in {build_s:.1f} s: parameters "
        f"{ {k: f'{v / 1e9:.3f} B' for k, v in n_params.items()} }, {resident_gb:.1f} GB resident with phase 29's "
        f"tower, CLIP-L and VAE")
    per_call = _module_launches(pipe.transformer)
    encode, decode = _module_launches(pipe.vae.encoder), _module_launches(pipe.vae.decoder)
    if per_call["flash_attention_fwd"] != 62:
        raise AssertionError(f"the FramePack transformer counts {per_call} launches a call, expected K1 62")
    image = synthetic_video(1, FRAMEPACK_HEIGHT, FRAMEPACK_WIDTH)[0]
    # the joint attention's length and the VAE's GroupNorm spans that phases 3 and 4 check K1 and K4 at
    seen = {"joint": set(), "decode": set(), "encode": set()}
    hooks = [module.register_forward_pre_hook(lambda _, args, key=key, fn=fn: seen[key].add(fn(args)))
             for key, module, fn in (
                 ("joint", pipe.transformer.transformer_blocks[0], lambda a: a[0].shape[1] + a[1].shape[1]),
                 ("decode", pipe.vae.decoder.conv_norm_out, lambda a: tuple(a[0].shape)),
                 ("encode", pipe.vae.encoder.down_blocks[0].resnets[0].norm1, lambda a: tuple(a[0].shape)))]
    results, paths = {}, {}
    for order in ("inverted_anti_drifting", "vanilla"):
        reset_launches()
        spans = CudaSpans({"transformer": pipe.transformer, "text_encoder": pipe.text_encoder,
                           "text_encoder_2": pipe.text_encoder_2, "image_encoder": pipe.image_encoder},
                          {"vae_decode": (pipe.vae, "decode"), "vae_encode": (pipe.vae, "encode")})
        with StepLaunches(pipe, pipe.transformer) as steps, spans:
            out, seconds, peak_gb = _request_seconds(lambda: pipe(
                image=image, prompt=HUNYUAN_PROMPT, height=FRAMEPACK_HEIGHT, width=FRAMEPACK_WIDTH,
                num_frames=FRAMEPACK_FRAMES, latent_window_size=FRAMEPACK_WINDOW,
                num_inference_steps=FRAMEPACK_STEPS, guidance_scale=FRAMEPACK_GUIDANCE,
                max_sequence_length=HUNYUAN_TEXT_LEN, prompt_template=hunyuan_template(), sampling_type=order,
                generator=torch.Generator(device="cuda").manual_seed(SEED)).frames)
        ms = spans.ms()
        n = 2 * FRAMEPACK_STEPS
        calls = [dict(per_call) for _ in range(n)]
        calls[0]["group_norm"] += encode["group_norm"]  # the image's encode comes before the first step
        calls[FRAMEPACK_STEPS]["group_norm"] += decode["group_norm"]  # the first section's decode
        _check_steps(f"framepack {order}", steps.per_step, calls, steps.after, decode)
        if not (out.ndim == 5 and out.shape[1] >= FRAMEPACK_FRAMES and out.shape[2:] == (FRAMEPACK_HEIGHT,
                FRAMEPACK_WIDTH, 3) and np.isfinite(out).all() and steps.batches == [1] * n):
            raise AssertionError(f"framepack {order}: frames {out.shape}, batches {steps.batches}")
        row = {"seconds_per_video": seconds, "peak_memory_gb": peak_gb, "launches": read_launches(),
               "frames": out.shape[1], "transformer_calls": len(ms["transformer"]),
               "transformer_ms_per_call": ms["transformer"], "transformer_ms_mean": float(np.mean(ms["transformer"])),
               "siglip_encode_ms": ms["image_encoder"], "llama_encode_ms": ms["text_encoder"],
               "clip_encode_ms": ms["text_encoder_2"], "vae_encode_ms": ms["vae_encode"],
               "vae_decode_ms": ms["vae_decode"]}
        results[order] = row
        paths[f"framepack_{order}"] = row["launches"]
        log(f"[framepack] {smi}: {order}: {seconds:.2f} s a request ({out.shape[1]} frames of {FRAMEPACK_HEIGHT} x "
            f"{FRAMEPACK_WIDTH}, 2 sections of {FRAMEPACK_STEPS} steps), {row['transformer_calls']} transformer calls "
            f"of {row['transformer_ms_mean']:.1f} ms (CUDA events; {[round(t, 1) for t in ms['transformer']]}), "
            f"SigLIP {[round(t, 1) for t in ms['image_encoder']]} ms, Llama {[round(t, 1) for t in ms['text_encoder']]}"
            f" ms, VAE encode {[round(t, 1) for t in ms['vae_encode']]} ms, decodes "
            f"{[round(t, 1) for t in ms['vae_decode']]} ms, peak memory {peak_gb:.1f} GB; launches {row['launches']}")
    for hook in hooks:
        hook.remove()
    largest = max(seen["decode"], key=math.prod)
    if (seen["joint"] != {FRAMEPACK_JOINT_ATTENTION[1]} or largest != GN_FRAMEPACK_VAE[1][0]
            or seen["encode"] != {GN_FRAMEPACK_VAE[2][0]}):
        raise AssertionError(f"framepack: joint lengths {seen['joint']}, decode spans {seen['decode']}, encode spans "
                             f"{seen['encode']}: not the shapes phases 3 and 4 check")
    RESULTS["framepack"] = {"card": smi, "steps": FRAMEPACK_STEPS, "window": FRAMEPACK_WINDOW,
                            "num_frames": FRAMEPACK_FRAMES, "height": FRAMEPACK_HEIGHT, "width": FRAMEPACK_WIDTH,
                            "build_seconds": build_s, "parameters": n_params, "resident_gb": resident_gb,
                            "k1_per_call": per_call["flash_attention_fwd"], **results}
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def timed(fn, *args):
    """`fn(*args)`, its wall time logged and kept in RESULTS["phase_seconds"]
    under the function's name."""
    t0 = time.perf_counter()
    out = fn(*args)
    seconds = RESULTS.setdefault("phase_seconds", {})[fn.__name__] = time.perf_counter() - t0
    log(f"[phase] {fn.__name__}: {seconds:.1f} s")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=None, help="directory for chip_smoke.json")
    args = parser.parse_args()
    t_start = time.perf_counter()
    if args.out is not None:  # the detailed results, written on the way out whether or not a phase failed
        def write_results():
            args.out.mkdir(parents=True, exist_ok=True)
            (args.out / "chip_smoke.json").write_text(json.dumps(RESULTS, indent=2, default=str))

        atexit.register(write_results)
    smi = setup()
    import gc

    import torch

    timed(build_kernels)
    summary = timed(check_kernels)
    summary.update(timed(check_group_norm))
    summary.update(timed(check_w8a8))
    timed(check_int8_routes)
    summary.update(timed(check_flash_bwd))
    timed(check_small_reference)
    timed(check_small_flux_reference)
    timed(check_small_flux_family)
    timed(check_small_training)
    timed(check_small_caches)
    timed(check_small_image_pipelines)
    timed(check_small_sd3)
    timed(check_small_wan)
    timed(check_small_wan_i2v)
    timed(check_small_wan_family)
    timed(check_small_sd)
    timed(check_small_controlnets)
    timed(check_small_family)
    timed(check_small_guidance)
    timed(check_small_qwenimage)
    timed(check_small_ltx)
    timed(check_small_hunyuan_video)
    sdxl, pipe, image = timed(run_pipeline, smi)
    paths = {"sdxl": sdxl, **timed(run_sdxl_cached, smi, pipe, image)}
    image_paths, controlnet = timed(run_image_pipelines, smi, pipe)
    paths.update(image_paths)
    paths.update(timed(run_sdxl_guidance, smi, pipe, controlnet, image))
    del controlnet
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(timed(run_sdxl_ip_adapter, smi, pipe, image))
    paths.update(timed(run_sdxl_from_disk, smi, pipe, image))
    paths.update(timed(run_sdxl_controlnets, smi, pipe))
    paths.update(timed(run_sdxl_w8a8, smi, pipe, image))
    paths.update(timed(run_sdxl_ip2p, smi, pipe))
    paths.update(timed(run_sdxl_lora, smi, pipe, image))
    paths.update(timed(run_sdxl_single_file, smi, pipe, image))
    paths.update(timed(run_sdxl_textual_inversion, smi, pipe))
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    sd15_paths, pipe = timed(run_sd15, smi)
    paths.update(sd15_paths)
    paths.update(timed(run_sd15_controlnet, smi, pipe))
    paths.update(timed(run_sd15_family, smi, pipe))
    paths.update(timed(run_sd15_guidance, smi, pipe))
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    flux, pipe, image = timed(run_flux_pipeline, smi)
    paths.update(flux=flux, **timed(run_flux_cached, smi, pipe, image))
    paths.update(timed(run_vae_tiling, smi, pipe))
    paths.update(timed(run_flux_family, smi, pipe))
    paths.update(timed(run_flux_lora_w8a8, smi, pipe))
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(timed(run_flux_w8a8_on_load, smi))
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(timed(run_transformers_single_file, smi))
    paths.update(timed(run_small_round_trips, smi))
    sd3_paths, pipe = timed(run_sd3_served, smi)
    paths.update(sd3_paths)
    paths.update(timed(run_sd3_from_disk, smi, pipe))
    paths.update(timed(run_sd3_controlnet, smi, pipe))
    paths.update(timed(run_sd3_guidance, smi, pipe))
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    wan_paths, pipe = timed(run_wan, smi)
    paths.update(wan_paths)
    paths.update(timed(run_wan_v2v, smi, pipe))
    paths.update(timed(run_wan_vace, smi, pipe))
    pipe.transformer = None  # phases 19-22 keep phase 17's UMT5-XXL and VAE
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(timed(run_wan_i2v, smi, pipe))
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(timed(run_wan_animate, smi, pipe))
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(timed(run_skyreels, smi, pipe))
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(timed(run_qwenimage, smi))
    paths.update(timed(run_ltx, smi))
    hunyuan_paths, pipe = timed(run_hunyuan_video, smi)
    paths.update(hunyuan_paths)
    paths.update(timed(run_framepack, smi, pipe))
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    paths["training"] = timed(run_training, smi)
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
        "group_norm": ("cuda", "diffusers_tpu_torch/csrc/group_norm.cu", "diffusers_tpu/ops/pallas/group_norm.py:150",
                       "one SDXL UNet call at b=2 (1024 px): the sum over its 46 launches at their 14 shapes; "
                       "library: F.group_norm (+ F.silu)"),
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

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

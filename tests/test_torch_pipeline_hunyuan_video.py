"""The port's `HunyuanVideoPipeline` against JAX's end to end on the CPU: the
distilled-guidance request to decoded frames under both `crop_start`
branches (given by the template, and computed from the template's own
tokens), true CFG as a second call a step, the three caches JAX's pipeline
honours (TaylorSeer, MagCache, TextKV; TextKV bit-equal to the dense
request), a step callback, an original-layout HunyuanVideo LoRA loaded
through `pipe.load_lora_weights`, and the pipeline through `save_pretrained`
/ `DiffusionPipeline.from_pretrained`.

Tiny components: the fixture of `tests/test_pipeline_hunyuan_video.py:38-61`
(the transformer 2 heads x 10, one dual and one single block, one refiner
layer; a 2-layer Llama 16 wide; a 1-layer CLIP 8 wide; the VAE of widths 8,
4x in time and 8x in space), 5 frames of 16 x 16 (2 x 2 x 2 latents). The
port's seeded weights are carried into JAX with `convert_torch_state_dict`;
both pipelines get the same numpy latents. JAX's text towers run under
`jax.jit` (`JitEncoder`, `JitCLIP`).

Tolerance: 5e-4 on the latents and the [0, 1] frames (the README's
whole-pipeline bound), f32 on both sides.
"""

import functools
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusers_tpu.hooks as jhooks
from diffusers_tpu.hooks.generic_cache import TextKVCacheConfig as JaxTextKV
from diffusers_tpu.loaders import lora as jlora
from diffusers_tpu.models.autoencoders.autoencoder_kl_hunyuan_video import AutoencoderKLHunyuanVideo as JaxHVVAE
from diffusers_tpu.models.text_encoders.clip import CLIPTextModel as JaxCLIP
from diffusers_tpu.models.text_encoders.llama import LlamaModel as JaxLlama
from diffusers_tpu.models.transformers.transformer_hunyuan_video import HunyuanVideoTransformer3DModel as JaxHVT
from diffusers_tpu.pipelines.hunyuan_video import HunyuanVideoPipeline as JaxHVPipeline
from diffusers_tpu.schedulers import FlowMatchEulerDiscreteScheduler as JaxFlowMatch
import diffusers_tpu_torch.hooks as hooks
from diffusers_tpu_torch import (
    AutoencoderKLHunyuanVideo,
    DiffusionPipeline,
    FlowMatchEulerDiscreteScheduler,
    HunyuanVideoPipeline,
    HunyuanVideoTransformer3DModel,
    LlamaModel,
)
from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel
from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention_full
from test_torch_lora import _assert_weights, _pair
from test_torch_pipeline_qwenimage import JitEncoder
from test_torch_qwenimage import carry, seeded
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

ATOL = 5e-4
ACTS = 1e-4
PROMPT = "a cat walks on grass"
STEPS = 5
TXT_LEN = 8
TRANSFORMER = dict(in_channels=4, out_channels=4, num_attention_heads=2, attention_head_dim=10, num_layers=1,
                   num_single_layers=1, num_refiner_layers=1, patch_size=1, patch_size_t=1, guidance_embeds=True,
                   text_embed_dim=16, pooled_projection_dim=8, rope_axes_dim=(2, 4, 4))
VAE = dict(in_channels=3, out_channels=3, latent_channels=4, block_out_channels=(8, 8, 8, 8), layers_per_block=1,
           norm_num_groups=4)
LLAMA = dict(vocab_size=500, hidden_size=16, intermediate_size=32, num_hidden_layers=2, num_attention_heads=2,
             num_key_value_heads=2)
CLIP = dict(vocab_size=500, hidden_size=8, intermediate_size=16, num_hidden_layers=1, num_attention_heads=2,
            max_position_embeddings=77, projection_dim=8)
TEMPLATE = {"template": "sys: {}", "crop_start": 2}
# a template longer than the text budget, whose crop is computed: its 10 tokens less 2
LONG_TEMPLATE = {"template": "system: describe the video in detail: {} thanks", "crop_start": None}
CALL = dict(height=16, width=16, num_frames=5, guidance_scale=6.0, max_sequence_length=TXT_LEN)
LATENTS = np.random.RandomState(1).randn(1, 4, 2, 2, 2).astype(np.float32)


class WordTokenizer:
    """Deterministic tokenizer stand-in: BOS (1), one id a word from a CRC of
    the word, EOS (2); padded with 0 to `max_length` (truncated only with
    `truncation`), with the attention mask."""

    def __call__(self, texts, padding=None, max_length=TXT_LEN, truncation=True, return_tensors="np"):
        class Out:
            pass

        texts = [texts] if isinstance(texts, str) else texts
        rows = [[1] + [zlib.crc32(w.encode("utf-8")) % 480 + 10 for w in t.split()] + [2] for t in texts]
        width = max(max_length, *(len(r) for r in rows)) if not truncation else max_length
        rows = [(r + [0] * width)[:width] for r in rows]
        out = Out()
        out.input_ids = np.array(rows, np.int64)
        out.attention_mask = (out.input_ids != 0).astype(np.int64)
        return out


class JitCLIP:
    """A JAX CLIP text tower whose pooled output runs under `jax.jit`."""

    def __init__(self, module):
        self._fn = jax.jit(lambda p, ids: module(p, ids).pooler_output)

    def __call__(self, params, ids):
        return types.SimpleNamespace(pooler_output=self._fn(params, ids))


def hv_parts(seed=0, transformer_cls=HunyuanVideoTransformer3DModel, jax_transformer_cls=JaxHVT,
             transformer_cfg=TRANSFORMER):
    """({name: JAX component}, {name: port component}) of the tiny pipeline."""
    torch_parts = {"transformer": seeded(transformer_cls, transformer_cfg, seed),
                   "vae": seeded(AutoencoderKLHunyuanVideo, VAE, seed + 1),
                   "text_encoder": seeded(LlamaModel, LLAMA, seed + 2),
                   "text_encoder_2": seeded(CLIPTextModel, CLIP, seed + 3)}
    jt, jv = carry(jax_transformer_cls, torch_parts["transformer"], transformer_cfg), carry(
        JaxHVVAE, torch_parts["vae"], VAE)
    jte, jte2 = carry(JaxLlama, torch_parts["text_encoder"], LLAMA), carry(JaxCLIP, torch_parts["text_encoder_2"],
                                                                          CLIP)
    jax_parts = {"transformer": jt, "vae": jv, "text_encoder": (JitEncoder(jte[0]), jte[1]),
                 "text_encoder_2": (JitCLIP(jte2[0]), jte2[1])}
    return jax_parts, torch_parts


@functools.lru_cache(maxsize=None)
def build():
    jax_parts, torch_parts = hv_parts()
    jpipe = JaxHVPipeline(scheduler=JaxFlowMatch(shift=7.0), tokenizer=WordTokenizer(), tokenizer_2=WordTokenizer(),
                          **jax_parts)
    tpipe = HunyuanVideoPipeline(scheduler=FlowMatchEulerDiscreteScheduler(shift=7.0), tokenizer=WordTokenizer(),
                                 tokenizer_2=WordTokenizer(), device="cpu", **torch_parts)
    dense = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), num_inference_steps=STEPS, output_type="latent",
                  prompt_template=TEMPLATE, **CALL).frames
    return jpipe, tpipe, dense


def _calls(module):
    calls = []
    return calls, module.register_forward_pre_hook(lambda mod, args: calls.append(args[0].shape[0]))


REQUESTS = {
    "template_crop": dict(prompt_template=TEMPLATE),
    "computed_crop": dict(prompt_template=LONG_TEMPLATE),
    "true_cfg": dict(prompt_template=TEMPLATE, negative_prompt="blurry and dark", true_cfg_scale=3.0),
}


@pytest.mark.parametrize("name", list(REQUESTS))
def test_pipeline_matches_jax(name):
    """The request to frames [B, F, H, W, C]: one transformer call a step (two
    under true CFG); no launch on the CPU."""
    jpipe, tpipe, _ = build()
    kwargs = dict(CALL, num_inference_steps=STEPS, **REQUESTS[name])
    ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), **kwargs).frames)
    flash_attention_full.launches = 0
    calls, handle = _calls(tpipe.transformer)
    try:
        out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).frames
    finally:
        handle.remove()
    assert flash_attention_full.launches == 0
    assert calls == [1] * STEPS * (2 if name == "true_cfg" else 1)
    assert out.shape == ref.shape == (1, 5, 16, 16, 3) and out.min() >= 0 and out.max() <= 1
    assert float(np.abs(out - ref).max()) <= ATOL, float(np.abs(out - ref).max())


def test_crop_start_from_the_template():
    """Without a `crop_start` the crop is the template's own token count
    less 2, as JAX computes it; the embeds and mask are cropped to
    `max_sequence_length`; the hidden states read are the third from last."""
    _, tpipe, _ = build()
    assert tpipe.crop_start(TEMPLATE, TXT_LEN) == 2
    n = len(WordTokenizer()(LONG_TEMPLATE["template"], truncation=False).input_ids[0])
    assert n > TXT_LEN and tpipe.crop_start(LONG_TEMPLATE, TXT_LEN) == n - 2
    embeds, pooled, mask = tpipe.encode_prompt(PROMPT, prompt_template=LONG_TEMPLATE, max_sequence_length=TXT_LEN)
    assert embeds.shape == (1, TXT_LEN, 16) and mask.shape == (1, TXT_LEN) and pooled.shape == (1, 8)
    ids = WordTokenizer()([LONG_TEMPLATE["template"].format(PROMPT)], max_length=TXT_LEN + n - 2)
    full = tpipe.text_encoder(torch.from_numpy(ids.input_ids), attention_mask=torch.from_numpy(ids.attention_mask),
                              output_hidden_states=True).hidden_states
    assert torch.equal(embeds, full[-3][:, n - 2:])


CONFIGS = {
    "taylorseer": lambda m: m.TaylorSeerCacheConfig(cache_interval=2, disable_cache_before_step=2, max_order=1),
    "mag_cache": lambda m: m.MagCacheConfig(threshold=0.5, max_skip_steps=1, retention_ratio=0.25,
                                            num_inference_steps=STEPS, mag_ratios=(1.0,) * STEPS),
    "text_kv": lambda m: hooks.TextKVCacheConfig() if m is hooks else JaxTextKV(),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cache_matches_jax(name):
    """Each cache against JAX's cached request; TaylorSeer and MagCache skip
    calls, TextKV is bit-equal to the dense request."""
    jpipe, tpipe, dense = build()
    jpipe.enable_cache(CONFIGS[name](jhooks))
    tpipe.enable_cache(CONFIGS[name](hooks))
    calls, handle = _calls(tpipe.transformer)
    try:
        kwargs = dict(CALL, num_inference_steps=STEPS, output_type="latent", prompt_template=TEMPLATE)
        ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), **kwargs).frames)
        out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).frames
    finally:
        handle.remove()
        jpipe.disable_cache()
        tpipe.disable_cache()
    assert float(np.abs(out.numpy() - ref).max()) <= ATOL, float(np.abs(out.numpy() - ref).max())
    if name == "text_kv":
        assert torch.equal(out, dense) and len(calls) == STEPS
    else:
        assert float((out - dense).abs().max()) > ACTS and len(calls) < STEPS


def test_callback_matches_jax_and_refuses_a_cache():
    jpipe, tpipe, _ = build()
    seen = []

    def callback(pipe, i, t, kwargs):
        seen.append(i)
        return {"latents": kwargs["latents"] * 0.95} if i == 2 else {}

    kwargs = dict(CALL, num_inference_steps=STEPS, output_type="latent", prompt_template=TEMPLATE,
                  callback_on_step_end=callback)
    ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), **kwargs).frames)
    seen.clear()
    out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).frames
    assert seen == list(range(STEPS))
    assert float(np.abs(out.numpy() - ref).max()) <= ATOL
    tpipe.enable_cache(hooks.TextKVCacheConfig())
    try:
        with pytest.raises(ValueError, match="callback_on_step_end"):
            tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs)
    finally:
        tpipe.disable_cache()


def test_lora_and_round_trip(tmp_path):
    """An original-layout LoRA through `pipe.load_lora_weights` (the
    transformer's weights equal to JAX's `load_lora_weights`), then the
    pipeline through `save_pretrained` and `DiffusionPipeline.from_pretrained`:
    the registered classes, every component bit-equal, the same latents."""
    jax_parts, torch_parts = hv_parts(seed=5)
    tpipe = HunyuanVideoPipeline(scheduler=FlowMatchEulerDiscreteScheduler(shift=7.0), tokenizer=WordTokenizer(),
                                 tokenizer_2=WordTokenizer(), device="cpu", **torch_parts)
    rng = np.random.RandomState(6)
    sd = {**_pair(rng, "diffusion_model.double_blocks.0.img_attn_qkv", 20, 60, "lora_A", "lora_B"),
          **_pair(rng, "diffusion_model.single_blocks.0.linear2", 100, 20, "lora_A", "lora_B")}
    jm, params = jax_parts["transformer"]
    fused = jlora.load_lora_weights(dict(sd), params, component="transformer")
    tpipe.load_lora_weights(dict(sd))
    _assert_weights(jm, fused, tpipe.transformer)

    kwargs = dict(CALL, num_inference_steps=2, output_type="latent", prompt_template=TEMPLATE)
    before = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).frames
    tpipe.save_pretrained(tmp_path / "hv")
    loaded = DiffusionPipeline.from_pretrained(tmp_path / "hv", device="cpu", tokenizer=WordTokenizer(),
                                               tokenizer_2=WordTokenizer())
    assert type(loaded).__name__ == "HunyuanVideoPipeline"
    for name in ("transformer", "vae", "text_encoder", "text_encoder_2"):
        state = getattr(tpipe, name).state_dict()
        assert all(torch.equal(v, state[k]) for k, v in getattr(loaded, name).state_dict().items()), name
    assert torch.equal(loaded(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).frames, before)

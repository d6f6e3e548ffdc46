"""The port's HunyuanImage-2.1 family against the JAX package on the CPU:
`HunyuanImageTransformer2DModel` with the ByT5 glyph stream on and off,
under distilled guidance and meanflow; `merge_text_streams` on ragged masks,
the 2-axis RoPE tables and the joint key bias against JAX's bool mask;
`AutoencoderKLHunyuanImage` and the refiner's `AutoencoderKLHunyuanImageRefiner`
(encode moments and decode); and `HunyuanImagePipeline` end to end: the OCR
guider (`AdaptiveProjectedMixGuidance`, its momentum carried step to step)
for a prompt with quoted text, the default guider (CFG) for one without,
the distilled meanflow loop, TaylorSeer and MagCache on the guidance-free
path and their refusal on the others, a step callback, `from_pretrained`
round trips and the default device.

Tiny widths: the transformer of JAX's fixture
(`tests/test_hunyuan_image.py:23-36`: 2 heads x 12, one dual and one single
block, one refiner layer, ByT5 10 wide), its VAE (widths 32 and 64, 2x in
space), a 2-layer Qwen2.5-VL tower 16 wide and a 2-layer ByT5 10 wide
behind deterministic tokenizer stand-ins (8 Qwen tokens after the
template's 34; both pipelines' ByT5 budget set to 16 of the published
128), 16 x 16 images (8 x 8 latents).
The port's seeded weights reach JAX through `convert_torch_state_dict`;
both pipelines get the same numpy latents. JAX's sub-modules run under
`jax.jit` (`JitModule`).

Tolerance: 5e-4 on models and pipelines (the README's whole-model bound),
f32 on both sides; the tables, masks and biases exact.
"""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusers_tpu.hooks as jhooks
from diffusers_tpu.guiders import AdaptiveProjectedMixGuidance as JaxAPGMix
from diffusers_tpu.guiders import ClassifierFreeGuidance as JaxCFG
from diffusers_tpu.models.autoencoders.autoencoder_kl_hunyuanimage import AutoencoderKLHunyuanImage as JaxVAE
from diffusers_tpu.models.autoencoders.autoencoder_kl_hunyuanimage_refiner import (
    AutoencoderKLHunyuanImageRefiner as JaxRefinerVAE,
)
from diffusers_tpu.models.text_encoders.qwen2_vl import Qwen2_5_VLTextEncoder as JaxQwenTE
from diffusers_tpu.models.text_encoders.t5 import T5EncoderModel as JaxT5
from diffusers_tpu.models.transformers import transformer_hunyuanimage as jhi
from diffusers_tpu.pipelines.hunyuan_image import HunyuanImagePipeline as JaxPipeline
from diffusers_tpu.schedulers import FlowMatchEulerDiscreteScheduler as JaxFlowMatch
import diffusers_tpu_torch.hooks as hooks
from diffusers_tpu_torch import (
    AutoencoderKLHunyuanImage,
    AutoencoderKLHunyuanImageRefiner,
    DiffusionPipeline,
    HunyuanImagePipeline,
    HunyuanImageTransformer2DModel,
    Qwen2_5_VLTextEncoder,
)
from diffusers_tpu_torch.guiders import AdaptiveProjectedMixGuidance, ClassifierFreeGuidance
from diffusers_tpu_torch.models.text_encoders.t5 import T5EncoderModel
from diffusers_tpu_torch.models.transformers.transformer_hunyuan_video import validity_bias
from diffusers_tpu_torch.models.transformers.transformer_hunyuanimage import joint_bias, merge_text_streams
from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention_full
from diffusers_tpu_torch.schedulers import FlowMatchEulerDiscreteScheduler
from test_torch_jit_reference import JitModule
from test_torch_qwenimage import carry, seeded
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

ATOL = 5e-4
TF = dict(in_channels=4, out_channels=4, num_attention_heads=2, attention_head_dim=12, num_layers=1,
          num_single_layers=1, num_refiner_layers=1, patch_size=(1, 1), text_embed_dim=16, text_embed_2_dim=10,
          rope_axes_dim=(6, 6))
VAE = dict(in_channels=3, out_channels=3, latent_channels=4, block_out_channels=(32, 64), layers_per_block=1,
           spatial_compression_ratio=2, sample_size=32, scaling_factor=0.75)
REFINER_VAE = dict(in_channels=3, out_channels=3, latent_channels=4, block_out_channels=(8, 16, 16),
                   layers_per_block=1, spatial_compression_ratio=4, temporal_compression_ratio=4)
QWEN = dict(vocab_size=100, hidden_size=16, intermediate_size=32, num_hidden_layers=2, num_attention_heads=2,
            num_key_value_heads=2)
BYT5 = dict(vocab_size=384, d_model=10, d_ff=24, num_layers=2, num_heads=2, d_kv=5, feed_forward_proj="gated-gelu")
TXT_LEN = 8
BYT5_LEN = 16
STEPS = 3
SIZE = dict(height=16, width=16)
GLYPH_PROMPT = 'a neon sign reading "OPEN"'
PLAIN_PROMPT = "a misty forest"
LATENTS = np.random.RandomState(1).randn(1, 4, 8, 8).astype(np.float32)


class QwenTokenizer:
    """Qwen tokenizer stand-in: ids from a CRC of the text, 34 + 2-5 tokens
    long (the template's 34 are dropped), padded to `max_length`."""

    def __call__(self, texts, max_length=64, padding=None, truncation=True, return_tensors="np", **kw):
        texts = [texts] if isinstance(texts, str) else texts
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros_like(ids)
        for i, text in enumerate(texts):
            h = zlib.crc32(text.encode("utf-8"))
            n = min(max_length, 34 + 2 + len(text) % 4)
            ids[i, :n] = [(h + 7 * j) % 97 + 1 for j in range(n)]
            mask[i, :n] = 1
        return {"input_ids": ids, "attention_mask": mask}


class ByT5Tokenizer:
    """ByT5 stand-in: one id a UTF-8 byte (+ 3) and EOS (1), padded to `max_length`."""

    def __call__(self, text, max_length=128, padding=None, truncation=True, add_special_tokens=True,
                 return_tensors="np"):
        ids = [b + 3 for b in text.encode("utf-8")][:max_length - 1] + [1]
        row = np.zeros((1, max_length), np.int64)
        row[0, :len(ids)] = ids
        return {"input_ids": row, "attention_mask": (row != 0).astype(np.int64)}


def _inputs(with_byt5=True, seed=0):
    rng = np.random.RandomState(seed)
    mask = np.ones((2, 7), np.int64)
    mask[0, 5:] = 0
    mask[1, 0] = 0  # a padded first token: the refiner's column-0 rule, and no prefix
    mask_2 = np.ones((2, 5), np.int64)
    mask_2[1, 2:] = 0
    out = dict(hidden_states=rng.randn(2, 4, 4, 6).astype(np.float32), timestep=np.array([100.0, 700.0], np.float32),
               encoder_hidden_states=rng.randn(2, 7, 16).astype(np.float32), encoder_attention_mask=mask)
    if with_byt5:
        out.update(encoder_hidden_states_2=rng.randn(2, 5, 10).astype(np.float32), encoder_attention_mask_2=mask_2)
    return out


MODEL_CASES = {
    "byt5": ({}, {}),
    "no_byt5": ({}, {}),
    "byt5_guidance_meanflow": (dict(guidance_embeds=True, use_meanflow=True),
                               dict(guidance=np.array([4000.0, 4000.0], np.float32),
                                    timestep_r=np.array([50.0, 650.0], np.float32))),
}


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_transformer_matches_jax(name):
    extra_cfg, extra_in = MODEL_CASES[name]
    cfg = dict(TF, **extra_cfg)
    tm = seeded(HunyuanImageTransformer2DModel, cfg, seed=1)
    jm, params = carry(jhi.HunyuanImageTransformer2DModel, tm, cfg)
    ins = dict(_inputs(with_byt5=name != "no_byt5"), **extra_in)
    ref = np.asarray(jax.jit(lambda p, kw: jm(p, **kw).sample)(params, {k: jnp.asarray(v) for k, v in ins.items()}))
    flash_attention_full.launches = 0
    with torch.no_grad():
        out = tm(**{k: torch.from_numpy(v) for k, v in ins.items()}).sample.numpy()
    assert flash_attention_full.launches == 0  # CPU tensors take the plain path
    assert out.shape == ref.shape == (2, 4, 4, 6)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_merge_rope_and_bias_match_jax():
    """The merged streams and mask equal JAX's on ragged masks (rows of
    each validity pattern); the RoPE tables bit-equal to JAX's at an odd grid;
    the joint key bias is JAX's bool mask, and after the merge it is
    `validity_bias` of the merged count (the kept keys are a prefix)."""
    rng = np.random.RandomState(3)
    text, text_2 = rng.randn(3, 6, 4).astype(np.float32), rng.randn(3, 5, 4).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0, 0], [0, 1, 0, 1, 1, 0], [1, 1, 1, 1, 1, 1]], np.int64)
    mask_2 = np.array([[0, 0, 0, 0, 0], [1, 0, 1, 1, 0], [1, 1, 1, 1, 1]], np.int64)
    ref, ref_mask = jhi._merge_text_streams(*map(jnp.asarray, (text, mask, text_2, mask_2)))
    out, out_mask = merge_text_streams(*map(torch.from_numpy, (text, mask, text_2, mask_2)))
    assert np.array_equal(out.numpy(), np.asarray(ref)) and np.array_equal(out_mask.numpy(), np.asarray(ref_mask))
    img_len = 4
    keep = np.concatenate([np.ones((3, img_len), bool), np.asarray(ref_mask)], axis=1)
    bias = joint_bias(out_mask, img_len).numpy()
    assert bias.shape == (3, 1, 1, img_len + 11) and np.array_equal(bias[:, 0, 0] == 0, keep)
    assert np.all(np.isneginf(bias[:, 0, 0][~keep]))
    assert np.array_equal(bias, validity_bias(out_mask, img_len).numpy())
    for cfg, sizes in ((TF, (5, 7)), (dict(TF, patch_size=(2, 2)), (6, 10)),
                       (dict(TF, patch_size=(1, 2, 2), rope_axes_dim=(4, 4, 4)), (3, 6, 10))):
        for r, o in zip(jhi.HunyuanImageTransformer2DModel(**cfg).rope(*sizes),
                        HunyuanImageTransformer2DModel(**cfg).rope(*sizes)):
            assert np.array_equal(o, r)


@pytest.mark.parametrize("kind", ["vae", "refiner"])
def test_vaes_match_jax(kind, tmp_path):
    """Encode (the posterior's moments) and decode: the 2-D 32x VAE at 2x
    for its fixture, the refiner's causal 3-D VAE over 9 frames; each model
    through `save_pretrained` / `from_pretrained`, its weights bit-equal."""
    cls, jcls, cfg = ((AutoencoderKLHunyuanImage, JaxVAE, VAE) if kind == "vae"
                      else (AutoencoderKLHunyuanImageRefiner, JaxRefinerVAE, REFINER_VAE))
    tm = seeded(cls, cfg, seed=2)
    jm, params = carry(jcls, tm, cfg)
    rng = np.random.RandomState(4)
    x = rng.randn(*((1, 3, 16, 16) if kind == "vae" else (1, 3, 9, 16, 16))).astype(np.float32)
    z = rng.randn(*((1, 4, 8, 8) if kind == "vae" else (1, 4, 9, 4, 4))).astype(np.float32)
    mom_ref = np.asarray(jax.jit(lambda p, v: jm.encode(p, v).latent_dist.parameters)(params, x))
    dec_ref = np.asarray(jax.jit(lambda p, v: jm.decode(p, v).sample)(params, z))
    with torch.no_grad():
        mom = tm.encode(torch.from_numpy(x)).latent_dist.parameters.numpy()
        dec = tm.decode(torch.from_numpy(z)).sample.numpy()
    assert mom.shape == mom_ref.shape and dec.shape == dec_ref.shape == x.shape
    np.testing.assert_allclose(mom, mom_ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(dec, dec_ref, atol=ATOL, rtol=0)
    tm.save_pretrained(tmp_path)
    loaded = cls.from_pretrained(tmp_path, device="cpu")
    assert type(loaded) is cls and all(list(loaded.config[k]) == list(v) if isinstance(v, tuple)
                                       else loaded.config[k] == v for k, v in cfg.items())
    a, b = tm.state_dict(), loaded.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------------------------ pipelines
APG = dict(guidance_scale=3.0, adaptive_projected_guidance_start_step=1, adaptive_projected_guidance_momentum=-0.5)


@functools.lru_cache(maxsize=None)
def parts(distilled: bool):
    """({name: JAX component}, {name: port component}) of a tiny pipeline; the
    distilled transformer takes the guidance embedding and meanflow."""
    cfg = dict(TF, guidance_embeds=True, use_meanflow=True) if distilled else TF
    torch_parts = {"transformer": seeded(HunyuanImageTransformer2DModel, cfg, seed=5),
                   "vae": seeded(AutoencoderKLHunyuanImage, VAE, seed=6),
                   "text_encoder": seeded(Qwen2_5_VLTextEncoder, QWEN, seed=7),
                   "text_encoder_2": seeded(T5EncoderModel, BYT5, seed=8)}
    jax_parts = {}
    for name, jcls, c in (("transformer", jhi.HunyuanImageTransformer2DModel, cfg), ("vae", JaxVAE, VAE),
                          ("text_encoder", JaxQwenTE, QWEN), ("text_encoder_2", JaxT5, BYT5)):
        jm, params = carry(jcls, torch_parts[name], c)
        jax_parts[name] = (jm if name == "transformer" else JitModule(jm), params)
    return jax_parts, torch_parts


@functools.lru_cache(maxsize=None)
def pipelines(distilled=False, guided=True):
    """(JAX pipeline, port pipeline), made once a configuration (so JAX
    compiles each of its loops once a module)."""
    jax_parts, torch_parts = parts(distilled)
    jguiders = dict(ocr_guider=JaxAPGMix(**APG), guider=JaxCFG(guidance_scale=2.0)) if guided else {}
    tguiders = (dict(ocr_guider=AdaptiveProjectedMixGuidance(**APG), guider=ClassifierFreeGuidance(guidance_scale=2.0))
                if guided else {})
    jpipe = JaxPipeline(scheduler=JaxFlowMatch(shift=5.0), tokenizer=QwenTokenizer(), tokenizer_2=ByT5Tokenizer(),
                        **jax_parts, **jguiders)
    tpipe = HunyuanImagePipeline(scheduler=FlowMatchEulerDiscreteScheduler(shift=5.0), tokenizer=QwenTokenizer(),
                                 tokenizer_2=ByT5Tokenizer(), device="cpu", **torch_parts, **tguiders)
    assert (tpipe.tokenizer_max_length, tpipe.tokenizer_2_max_length) == (jpipe.tokenizer_max_length,
                                                                          jpipe.tokenizer_2_max_length) == (1000, 128)
    for pipe in (jpipe, tpipe):  # a small ByT5 budget on both sides
        pipe.tokenizer_2_max_length = BYT5_LEN
    return jpipe, tpipe


def _batches(module):
    calls = []
    return calls, module.register_forward_pre_hook(lambda mod, args, kwargs: calls.append(
        (args[0].shape[0], kwargs.get("timestep_r") is not None)), with_kwargs=True)


def _run_both(jpipe, tpipe, prompt, port_kwargs=None, **kwargs):
    common = dict(SIZE, num_inference_steps=STEPS, max_sequence_length=TXT_LEN, **kwargs)
    ref = np.asarray(jpipe(prompt, latents=jnp.asarray(LATENTS), output_type="np", **common).images)
    calls, handle = _batches(tpipe.transformer)
    flash_attention_full.launches = 0
    try:
        out = tpipe(prompt, latents=torch.from_numpy(LATENTS), output_type="np", **common,
                    **(port_kwargs or {})).images
    finally:
        handle.remove()
    assert flash_attention_full.launches == 0
    assert out.shape == ref.shape == (1, 16, 16, 3)
    assert float(np.abs(out - ref).max()) <= ATOL, float(np.abs(out - ref).max())
    return calls


REQUESTS = {
    # quoted text: ByT5 runs and the OCR guider (APG-Mix, CFG then APG from step 1) guides the batch-2 pair
    "ocr_guider": (dict(distilled=False), GLYPH_PROMPT, dict(negative_prompt="blurry"), [(2, False)] * STEPS),
    # no quotes: zero glyph embeds and mask, the default guider (CFG)
    "default_guider": (dict(distilled=False), PLAIN_PROMPT, {}, [(2, False)] * STEPS),
    # no guider: the distilled model's guidance embedding and meanflow's timestep_r, batch 1
    "distilled_meanflow": (dict(distilled=True, guided=False), GLYPH_PROMPT, dict(distilled_guidance_scale=3.5),
                           [(1, True)] * STEPS),
}


@pytest.mark.parametrize("name", list(REQUESTS))
def test_pipeline_matches_jax(name):
    build, prompt, kwargs, expected = REQUESTS[name]
    jpipe, tpipe = pipelines(**build)
    assert tpipe.select_guider(prompt) is (tpipe.ocr_guider if name == "ocr_guider" else tpipe.guider)
    assert _run_both(jpipe, tpipe, prompt, **kwargs) == expected


def test_apg_momentum_is_carried():
    """The OCR path's APG-Mix momentum is carried from step to step: the
    guider sees JAX's buffer, ``beta * m + (cond - uncond)``, and a fresh
    buffer each step would give another image."""
    _, tpipe = pipelines()
    seen = []
    guider = tpipe.ocr_guider
    original = type(guider).__call__

    def spy(self, cond, uncond, step=0, num_steps=1, momentum=None):
        seen.append(None if momentum is None else momentum.clone())
        return original(self, cond, uncond, step=step, num_steps=num_steps, momentum=momentum)

    type(guider).__call__ = spy
    try:
        tpipe(GLYPH_PROMPT, latents=torch.from_numpy(LATENTS), output_type="latent", num_inference_steps=STEPS,
              max_sequence_length=TXT_LEN, **SIZE)
    finally:
        type(guider).__call__ = original
    assert len(seen) == STEPS and torch.count_nonzero(seen[0]) == 0
    assert all(torch.count_nonzero(m) > 0 for m in seen[1:])


CACHES = {
    "taylorseer": lambda m: m.TaylorSeerCacheConfig(cache_interval=2, disable_cache_before_step=1, max_order=1),
    "mag_cache": lambda m: m.MagCacheConfig(threshold=0.5, max_skip_steps=1, retention_ratio=0.25,
                                            num_inference_steps=STEPS, mag_ratios=(1.0,) * STEPS),
}


@pytest.mark.parametrize("name", sorted(CACHES))
def test_cache_on_the_guidance_free_path_matches_jax(name):
    """With no guider the loop honours TaylorSeer and MagCache as JAX's does
    (fewer transformer calls than steps); on the CFG and meanflow paths,
    whose JAX loops ignore a cache, the port raises `TypeError`."""
    jpipe, tpipe = pipelines(guided=False)
    jpipe.enable_cache(CACHES[name](jhooks))
    tpipe.enable_cache(CACHES[name](hooks))
    try:
        calls = _run_both(jpipe, tpipe, PLAIN_PROMPT)
    finally:
        jpipe.disable_cache()
        tpipe.disable_cache()
    assert 0 < len(calls) < STEPS
    for build in (dict(distilled=False), dict(distilled=True, guided=False)):
        _, guarded = pipelines(**build)
        guarded.enable_cache(CACHES[name](hooks))
        try:
            with pytest.raises(TypeError, match="guidance-free path only"):
                guarded(GLYPH_PROMPT, output_type="latent", num_inference_steps=STEPS, max_sequence_length=TXT_LEN,
                        distilled_guidance_scale=3.5, **SIZE)
        finally:
            guarded.disable_cache()


def test_callback_matches_jax_and_runs_on_every_path():
    """On the guidance-free path a callback that scales the latents at step
    1 gives JAX's image; on the CFG path, where JAX's scan never calls it,
    the port calls it after each step (ROADMAP C3) and, returning nothing,
    leaves JAX's image."""
    def scale(pipe, i, t, kw):
        return {"latents": kw["latents"] * 0.9} if i == 1 else {}

    jpipe, tpipe = pipelines(guided=False)
    _run_both(jpipe, tpipe, PLAIN_PROMPT, callback_on_step_end=scale)
    steps = []
    jpipe, tpipe = pipelines()
    _run_both(jpipe, tpipe, PLAIN_PROMPT, port_kwargs=dict(callback_on_step_end=lambda pipe, i, t, kw: steps.append(i)))
    assert steps == list(range(STEPS))


def test_from_pretrained_round_trip_and_default_device(tmp_path):
    """`save_pretrained` then `DiffusionPipeline.from_pretrained` (the class
    `model_index.json` names; ByT5 as `T5EncoderModel`, the Qwen tower, both
    guiders from their configs): the same weights and the same image. The
    pipeline defaults to the card and raises without one."""
    _, tpipe = pipelines()
    tpipe.save_pretrained(tmp_path)
    loaded = DiffusionPipeline.from_pretrained(tmp_path, device="cpu", tokenizer=QwenTokenizer(),
                                               tokenizer_2=ByT5Tokenizer())
    loaded.tokenizer_2_max_length = BYT5_LEN
    assert type(loaded) is HunyuanImagePipeline and isinstance(loaded.text_encoder_2, T5EncoderModel)
    public = lambda guider: {k: v for k, v in guider.config.items() if not k.startswith("_")}  # noqa: E731
    assert public(loaded.ocr_guider) == public(tpipe.ocr_guider)
    assert type(loaded.guider) is ClassifierFreeGuidance
    for name in ("transformer", "vae", "text_encoder", "text_encoder_2"):
        a, b = getattr(tpipe, name).state_dict(), getattr(loaded, name).state_dict()
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    kwargs = dict(latents=torch.from_numpy(LATENTS), output_type="np", num_inference_steps=2,
                  max_sequence_length=TXT_LEN, **SIZE)
    assert np.array_equal(loaded(GLYPH_PROMPT, **kwargs).images, tpipe(GLYPH_PROMPT, **kwargs).images)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HunyuanImagePipeline(**{k: v for k, v in tpipe.components.items()})

"""The port's `WanImageToVideoPipeline` and `WanVideoToVideoPipeline` against
the JAX package's on the CPU: image-to-video with a CLIP branch and 512 text
tokens, first-last-frame, the Wan 2.2 two-expert loop, video-to-video, and
the places where the port follows upstream diffusers rather than JAX.

Tiny components: Wan transformers of 2 layers (2 heads x 12), a 2-layer
UMT5, a 3-layer CLIP vision tower (28 px, 5 tokens), a one-level VAE (2x in
time and space) with non-trivial latent statistics; for the two experts the
transformers and VAE of tests/test_chronoedit.py's two-stage fixture (1
layer, 10 input channels; its VAE's `temperal_downsample=[True, False]`).
UniPC with flow prediction and flow shift 3.0. The port's seeded weights go
to JAX with `convert_torch_state_dict`; both sides take the same numpy
latents (JAX's draws) and the same image (uint8 HWC, 32 x 32).

Tolerance: `ATOL` = 5e-4 on the [0, 1] frames and on the latents, float32
on both sides (measured below 1e-5).

The divergences from JAX (ROADMAP C3/C4), each shown on both sides:
  (a) first-last-frame: JAX CLIP-encodes the first image alone, which a
      2x-token image table cannot take; the port encodes both, and equals
      JAX given both images' `image_embeds`;
  (b) JAX's I2V accepts TaylorSeer and MagCache and runs them uncached; the
      port raises TypeError on every cache config;
  (c) with an image branch JAX splits the context at 512 text tokens
      whatever `max_sequence_length` is; the port raises ValueError;
  (d) JAX's V2V steps the cut schedule from step index 0, the head of the
      sigma ladder, and ends short of sigma 0; the port steps the kept
      timesteps' sigmas, as upstream does, and equals that rule composed
      from JAX's parts (its encode, `add_noise` and `_denoise` over the cut
      ladder);
  (e) tests/test_wan_variants.py::test_wan_video2video fails on its fixture's
      VAE, whose `dim_mult=[1, 2]` and `temperal_downsample=[False, True]`
      never downsample in time but claim `scale_factor_temporal=2`: JAX's
      V2V raises there and runs on a consistent VAE.
"""

import json
import zlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

import chip_smoke
import diffusers_tpu.hooks as jhooks
from diffusers_tpu.models.autoencoders.autoencoder_kl_wan import AutoencoderKLWan as JaxVAE
from diffusers_tpu.models.text_encoders.clip import CLIPVisionModel as JaxCLIPVision
from diffusers_tpu.models.text_encoders.t5 import UMT5EncoderModel as JaxUMT5
from diffusers_tpu.models.transformers.transformer_wan import WanTransformer3DModel as JaxWan
from diffusers_tpu.pipelines.wan.pipeline_wan_i2v import WanImageToVideoPipeline as JaxI2V
from diffusers_tpu.pipelines.wan.pipeline_wan_video2video import WanVideoToVideoPipeline as JaxV2V
from diffusers_tpu.schedulers import UniPCMultistepScheduler as JaxUniPC
from diffusers_tpu.video_processor import VideoProcessor as JaxVideoProcessor
import diffusers_tpu_torch.hooks as hooks
from diffusers_tpu_torch import (
    AutoencoderKLWan,
    CLIPVisionModel,
    UMT5EncoderModel,
    UniPCMultistepScheduler,
    VideoProcessor,
    WanImageToVideoPipeline,
    WanTransformer3DModel,
    WanVideoToVideoPipeline,
)
from diffusers_tpu_torch.models.text_encoders.clip import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD
from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention_full
from diffusers_tpu_torch.utils import torch_utils
from test_torch_pipeline_cache import _parts
from test_torch_pipeline_wan import jit_reference
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)
from test_torch_jit_reference import fast_randn as jax_randn

torch.set_num_threads(1)

ATOL = 5e-4
PROMPT = "a sailing boat drifting at dusk"
TXT_LEN = 512
STEPS = 3
UMT5 = dict(vocab_size=1000, d_model=16, d_kv=8, d_ff=32, num_layers=2, num_heads=2, feed_forward_proj="gated-gelu")
VAE = dict(base_dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1, temperal_downsample=(True,),
           latents_mean=[0.1, -0.2, 0.0, 0.3], latents_std=[1.0, 0.5, 2.0, 1.5], scale_factor_temporal=2,
           scale_factor_spatial=2)
CLIP = dict(hidden_size=32, intermediate_size=37, num_hidden_layers=3, num_attention_heads=4, image_size=28,
            patch_size=14, hidden_act="gelu")
CLIP_TOKENS = (28 // 14) ** 2 + 1
# 4 latent + 2 mask (the VAE's temporal scale) + 4 condition channels
WAN_I2V = dict(patch_size=(1, 2, 2), num_attention_heads=2, attention_head_dim=12, in_channels=10, out_channels=4,
               text_dim=16, freq_dim=16, ffn_dim=32, num_layers=2, cross_attn_norm=True, rope_max_seq_len=64,
               image_dim=32, added_kv_proj_dim=24)
WAN_FLF = dict(WAN_I2V, pos_embed_seq_len=2 * CLIP_TOKENS)
# tests/test_chronoedit.py's two-stage fixture (`test_wan_i2v_two_stage_smoke`)
EXPERT = dict(patch_size=(1, 2, 2), num_attention_heads=2, attention_head_dim=12, in_channels=10, out_channels=4,
              text_dim=16, freq_dim=16, ffn_dim=32, num_layers=1, cross_attn_norm=True, rope_max_seq_len=64)
EXPERT_VAE = dict(base_dim=16, z_dim=4, dim_mult=(1, 2), num_res_blocks=1, temperal_downsample=(True, False),
                  latents_mean=[0.0] * 4, latents_std=[1.0] * 4, scale_factor_temporal=2, scale_factor_spatial=2)
UNIPC = dict(prediction_type="flow_prediction", use_flow_sigmas=True, flow_shift=3.0)
CALL = dict(height=32, width=32, num_frames=9, guidance_scale=5.0)
LATENTS = np.random.RandomState(1).randn(1, 4, 5, 16, 16).astype(np.float32)  # 9 frames of 32 x 32
_rng = np.random.RandomState(2)
IMAGE, LAST_IMAGE = ((_rng.rand(32, 32, 3) * 255).astype(np.uint8) for _ in range(2))


class MaskTokenizer:
    """Deterministic tokenizer stand-in: 5 ids from a CRC of the prompt, EOS
    (1), padding with 0, and the attention mask."""

    def __call__(self, prompts, padding=None, max_length=TXT_LEN, truncation=True, return_tensors="np"):
        class Out:
            pass

        ids = []
        for p in prompts:
            h = zlib.crc32(p.encode("utf-8"))
            ids.append(([(h + i * 31) % 900 + 2 for i in range(5)] + [1] + [0] * max_length)[:max_length])
        out = Out()
        out.input_ids = np.array(ids, dtype=np.int64)
        out.attention_mask = (out.input_ids != 0).astype(np.int64)
        return out


def clip_processor():
    return transformers.CLIPImageProcessor(size={"shortest_edge": 28}, crop_size={"height": 28, "width": 28},
                                           image_mean=list(OPENAI_CLIP_MEAN), image_std=list(OPENAI_CLIP_STD))


def build_i2v(transformer_cfg=WAN_I2V, seed=0):
    jax_parts, torch_parts = _parts([("vae", JaxVAE, AutoencoderKLWan, VAE),
                                     ("text_encoder", JaxUMT5, UMT5EncoderModel, UMT5),
                                     ("transformer", JaxWan, WanTransformer3DModel, transformer_cfg),
                                     ("image_encoder", JaxCLIPVision, CLIPVisionModel, CLIP)], seed=seed)
    jpipe = jit_reference(JaxI2V(tokenizer=MaskTokenizer(), scheduler=JaxUniPC(**UNIPC),
                                 image_processor=clip_processor(), **jax_parts))
    tpipe = WanImageToVideoPipeline(tokenizer=MaskTokenizer(), scheduler=UniPCMultistepScheduler(**UNIPC),
                                    image_processor=clip_processor(), device="cpu", **torch_parts)
    return jpipe, tpipe


def build_two_experts(boundary_ratio=0.5):
    jax_parts, torch_parts = _parts([("vae", JaxVAE, AutoencoderKLWan, EXPERT_VAE),
                                     ("text_encoder", JaxUMT5, UMT5EncoderModel, UMT5),
                                     ("transformer", JaxWan, WanTransformer3DModel, EXPERT),
                                     ("transformer_2", JaxWan, WanTransformer3DModel, EXPERT)], seed=3)
    jpipe = jit_reference(JaxI2V(tokenizer=MaskTokenizer(), scheduler=JaxUniPC(**UNIPC),
                                 boundary_ratio=boundary_ratio, **jax_parts))
    tpipe = WanImageToVideoPipeline(tokenizer=MaskTokenizer(), scheduler=UniPCMultistepScheduler(**UNIPC),
                                    boundary_ratio=boundary_ratio, device="cpu", **torch_parts)
    return jpipe, tpipe


def build_v2v(vae_cfg=VAE):
    from test_torch_pipeline_wan import WAN

    jax_parts, torch_parts = _parts([("vae", JaxVAE, AutoencoderKLWan, vae_cfg),
                                     ("text_encoder", JaxUMT5, UMT5EncoderModel, UMT5),
                                     ("transformer", JaxWan, WanTransformer3DModel, WAN)], seed=4)
    jpipe = jit_reference(JaxV2V(tokenizer=MaskTokenizer(), scheduler=JaxUniPC(**UNIPC), **jax_parts))
    tpipe = WanVideoToVideoPipeline(tokenizer=MaskTokenizer(), scheduler=UniPCMultistepScheduler(**UNIPC),
                                    device="cpu", **torch_parts)
    return jpipe, tpipe


def _frames(out):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.dtype == np.float32 and np.isfinite(out).all()
    return out


def _run_i2v(jpipe, tpipe, steps=STEPS, jax_kw=None, text_len=TXT_LEN, **kw):
    kwargs = dict(CALL, num_inference_steps=steps, max_sequence_length=text_len, **kw)
    ref = _frames(jpipe(image=IMAGE, prompt=PROMPT, latents=jnp.asarray(LATENTS), **kwargs, **(jax_kw or {})).frames)
    out = _frames(tpipe(image=IMAGE, prompt=PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).frames)
    assert out.shape == ref.shape
    return ref, out


def _calls(module):
    calls = []
    return calls, module.register_forward_pre_hook(lambda mod, args: calls.append(args[0].shape[0]))


@pytest.fixture(scope="module")
def i2v():
    return build_i2v()


@pytest.fixture(scope="module")
def flf():
    return build_i2v(WAN_FLF, seed=1)


@pytest.fixture(scope="module")
def experts():
    return build_two_experts()


@pytest.fixture(scope="module")
def v2v():
    return build_v2v()


def test_i2v_matches_jax(i2v):
    """Image-to-video with the CLIP branch and 512 text tokens, to decoded
    frames; CFG as two batch-1 calls a step; no kernel launch on the CPU."""
    jpipe, tpipe = i2v
    flash_attention_full.launches = 0
    calls, handle = _calls(tpipe.transformer)
    try:
        ref, out = _run_i2v(jpipe, tpipe, output_type="np")
    finally:
        handle.remove()
    assert flash_attention_full.launches == 0
    assert out.shape == (1, 9, 32, 32, 3) and out.min() >= 0 and out.max() <= 1
    assert calls == [1] * (2 * STEPS)
    assert float(np.abs(out - ref).max()) <= ATOL, float(np.abs(out - ref).max())


def test_i2v_condition_and_image_context_match_jax(i2v):
    """The pieces: the CLIP context (penultimate hidden states of the
    preprocessed image) and the 6-channel condition (the mask, the
    normalised latents of the zero-padded clip)."""
    jpipe, tpipe = i2v
    ref = np.asarray(jpipe.encode_image(IMAGE))
    out = tpipe.encode_image(IMAGE).numpy()
    assert out.shape == ref.shape == (1, CLIP_TOKENS, 32)
    np.testing.assert_allclose(out, ref, atol=1e-5)
    pixels = jnp.transpose(jnp.asarray(IMAGE, jnp.float32)[None], (0, 3, 1, 2)) / 127.5 - 1.0
    _, jcond = jpipe.prepare_latents(pixels, 1, 4, 32, 32, 9, jax.random.PRNGKey(0), latents=jnp.asarray(LATENTS))
    _, cond = tpipe.prepare_latents(torch.from_numpy(np.array(pixels)), 1, 4, 32, 32, 9,
                                    latents=torch.from_numpy(LATENTS))
    assert cond.shape == (1, 6, 5, 16, 16)
    np.testing.assert_array_equal(cond[:, :2].numpy(), np.asarray(jcond[:, :2]))  # the mask
    np.testing.assert_allclose(cond.numpy(), np.asarray(jcond), atol=2e-5)


def test_i2v_draws_through_randn_tensor(i2v, monkeypatch):
    """Without `latents` the port's one draw is `randn_tensor`'s: JAX's draw
    stood in for it gives JAX's request."""
    jpipe, tpipe = i2v
    _, lat_key = jax.random.split(jax.random.PRNGKey(0))
    draws = [np.array(jax_randn(LATENTS.shape, key=lat_key, dtype=jnp.float32))]
    monkeypatch.setattr(torch_utils, "randn_tensor", lambda shape, generator=None, device=None: torch.from_numpy(
        draws.pop(0)).to(device))
    kwargs = dict(CALL, num_inference_steps=2, max_sequence_length=TXT_LEN, output_type="latent")
    ref = _frames(jpipe(image=IMAGE, prompt=PROMPT, key=jax.random.PRNGKey(0), **kwargs).frames)
    out = _frames(tpipe(image=IMAGE, prompt=PROMPT, **kwargs).frames)
    assert not draws
    assert float(np.abs(out - ref).max()) <= ATOL


def test_flf_matches_jax_given_both_image_embeds(flf):
    """(a) First-last-frame with a 2 x 5-token image table: the port encodes
    [image, last_image] (upstream) and equals JAX given those two images'
    `image_embeds`; its own two-image context equals JAX's encode of both."""
    jpipe, tpipe = flf
    both = jpipe.encode_image([IMAGE, LAST_IMAGE])
    assert both.shape == (2, CLIP_TOKENS, 32)
    np.testing.assert_allclose(tpipe.encode_image([IMAGE, LAST_IMAGE]).numpy(), np.asarray(both), atol=1e-5)
    ref, out = _run_i2v(jpipe, tpipe, last_image=LAST_IMAGE, output_type="np", jax_kw=dict(image_embeds=both))
    assert float(np.abs(out - ref).max()) <= ATOL, float(np.abs(out - ref).max())
    # the mask marks video frame 0 (twice: latent frame 0's two channels) and the last, video frame 8
    pixels = torch.from_numpy(IMAGE).permute(2, 0, 1)[None].float() / 127.5 - 1
    _, cond = tpipe.prepare_latents(pixels, 1, 4, 32, 32, 9, latents=torch.from_numpy(LATENTS), last_image=pixels)
    assert cond[0, :2, :, 0, 0].tolist() == [[1, 0, 0, 0, 0], [1, 0, 0, 0, 1]]


def test_flf_jax_encodes_the_first_image_alone(flf):
    """(a), JAX's side: without `image_embeds` JAX encodes `image` alone, 5
    tokens that the 10-token image table cannot take for one prompt."""
    jpipe, tpipe = flf
    kwargs = dict(CALL, num_inference_steps=1, max_sequence_length=TXT_LEN, output_type="latent")
    with pytest.raises(TypeError, match="reshape"):
        jpipe(image=IMAGE, last_image=LAST_IMAGE, prompt=PROMPT, latents=jnp.asarray(LATENTS), **kwargs)
    out = tpipe(image=IMAGE, last_image=LAST_IMAGE, prompt=PROMPT, latents=torch.from_numpy(LATENTS), **kwargs)
    assert np.isfinite(out.frames.numpy()).all()


def test_two_experts_match_jax(experts):
    """Wan 2.2's loop: the steps at t >= 0.5 x 1000 on `transformer` at
    guidance 2.0, the rest on `transformer_2` at 1.5, no CLIP context."""
    jpipe, tpipe = experts
    steps = 4
    k = int((tpipe.scheduler.set_timesteps(steps).timesteps >= 500).sum())
    assert 0 < k < steps
    first, h1 = _calls(tpipe.transformer)
    second, h2 = _calls(tpipe.transformer_2)
    try:
        ref, out = _run_i2v(jpipe, tpipe, steps=steps, output_type="np", guidance_scale=2.0, guidance_scale_2=1.5)
    finally:
        h1.remove()
        h2.remove()
    assert (len(first), len(second)) == (2 * k, 2 * (steps - k))
    assert float(np.abs(out - ref).max()) <= ATOL, float(np.abs(out - ref).max())
    one_expert = WanImageToVideoPipeline(**{**tpipe.components, "boundary_ratio": None}, device="cpu")
    with pytest.raises(ValueError, match="boundary_ratio"):  # as JAX raises
        one_expert(image=IMAGE, prompt=PROMPT, guidance_scale_2=1.5, **CALL)


@pytest.mark.parametrize("name", ["taylorseer", "mag_cache"])
def test_i2v_refuses_every_cache_jax_runs_them_uncached(i2v, name):
    """(b) JAX's I2V accepts TaylorSeer and MagCache and its loop never reads
    them (the cached request is the dense one); the port raises TypeError,
    as for every cache config."""
    jpipe, tpipe = i2v
    make = {"taylorseer": lambda m: m.TaylorSeerCacheConfig(cache_interval=2, disable_cache_before_step=1),
            "mag_cache": lambda m: m.MagCacheConfig(num_inference_steps=STEPS, mag_ratios=(1.0,) * STEPS)}[name]
    kwargs = dict(CALL, num_inference_steps=STEPS, max_sequence_length=TXT_LEN, output_type="latent")
    dense = np.asarray(jpipe(image=IMAGE, prompt=PROMPT, latents=jnp.asarray(LATENTS), **kwargs).frames)
    jpipe.enable_cache(make(jhooks))
    try:
        cached = np.asarray(jpipe(image=IMAGE, prompt=PROMPT, latents=jnp.asarray(LATENTS), **kwargs).frames)
    finally:
        jpipe.disable_cache()
    np.testing.assert_array_equal(cached, dense)
    for config in (make(hooks), hooks.TextKVCacheConfig(), hooks.FirstBlockCacheConfig()):
        with pytest.raises(TypeError, match="does not support cache config"):
            tpipe.enable_cache(config)


def test_i2v_text_length_must_be_512_with_an_image_branch(i2v, experts):
    """(c) JAX splits the context at 512 text tokens whatever the text length:
    at 226 it runs, taking no image tokens apart; the port raises. Without an
    image branch (the two experts) any length is taken."""
    jpipe, tpipe = i2v
    kwargs = dict(CALL, num_inference_steps=1, max_sequence_length=226, output_type="latent")
    ref = np.asarray(jpipe(image=IMAGE, prompt=PROMPT, latents=jnp.asarray(LATENTS), **kwargs).frames)
    assert np.isfinite(ref).all()
    with pytest.raises(ValueError, match="max_sequence_length must be 512"):
        tpipe(image=IMAGE, prompt=PROMPT, latents=torch.from_numpy(LATENTS), **kwargs)
    ref, out = _run_i2v(*experts, steps=2, text_len=226, output_type="latent")
    assert float(np.abs(out - ref).max()) <= ATOL


def test_expand_timesteps_raises(i2v):
    _, tpipe = i2v
    with pytest.raises(NotImplementedError, match="expand_timesteps"):
        WanImageToVideoPipeline(**{**tpipe.components, "expand_timesteps": True}, device="cpu")
    with pytest.raises(NotImplementedError, match="expand_timesteps"):
        JaxI2V(tokenizer=None, text_encoder=None, transformer=None, vae=None, scheduler=None, expand_timesteps=True)


def test_pipelines_default_to_the_card(i2v, v2v, monkeypatch):
    """Built without `device`, each pipeline goes to "cuda"; with no card
    visible it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls, (_, tpipe) in ((WanImageToVideoPipeline, i2v), (WanVideoToVideoPipeline, v2v)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(**tpipe.components)


def test_i2v_from_pretrained_in_the_checkpoint_layout(i2v, tmp_path):
    """A directory laid out as Wan-AI/Wan2.1-I2V-14B-480P-Diffusers: a
    transformers tokenizer, UMT5 and CLIP vision tower (saved by transformers
    itself), `image_processor/`, the transformer and VAE in diffusers'
    layout, UniPC; `transformer_2` [null, null] and `boundary_ratio` null.
    The port loads it, bit-equal in weights and output."""
    _, tpipe = i2v
    root = tmp_path / "wan_i2v"
    tokenizer = chip_smoke.t5_tokenizer(tmp_path / "t5")
    for name in ("text_encoder", "transformer", "vae"):
        getattr(tpipe, name).save_pretrained(root / name)
    tpipe.scheduler.save_config(root / "scheduler")
    tokenizer.save_pretrained(root / "tokenizer")
    tpipe.image_processor.save_pretrained(root / "image_processor")
    vision = transformers.CLIPVisionModel(transformers.CLIPVisionConfig(**CLIP)).eval()
    assert not vision.load_state_dict(tpipe.image_encoder.state_dict(), strict=True).missing_keys
    vision.save_pretrained(root / "image_encoder")
    index = {"_class_name": "WanImageToVideoPipeline", "_diffusers_version": "0.33.0.dev0",
             "image_encoder": ["transformers", "CLIPVisionModel"],
             "image_processor": ["transformers", "CLIPImageProcessor"],
             "scheduler": ["diffusers", "UniPCMultistepScheduler"], "text_encoder": ["transformers", "UMT5EncoderModel"],
             "tokenizer": ["transformers", "T5TokenizerFast"], "transformer": ["diffusers", "WanTransformer3DModel"],
             "transformer_2": [None, None], "vae": ["diffusers", "AutoencoderKLWan"], "boundary_ratio": None}
    (root / "model_index.json").write_text(json.dumps(index))
    loaded = WanImageToVideoPipeline.from_pretrained(root, device="cpu")
    assert isinstance(loaded.image_encoder, CLIPVisionModel) and loaded.transformer_2 is None
    assert type(loaded.image_processor).__name__.startswith("CLIPImageProcessor")
    for name in ("image_encoder", "text_encoder", "transformer", "vae"):
        mine, theirs = getattr(tpipe, name).state_dict(), getattr(loaded, name).state_dict()
        assert mine.keys() == theirs.keys() and all(torch.equal(mine[k], theirs[k]) for k in mine), name
    tpipe_t5 = WanImageToVideoPipeline(**{**tpipe.components, "tokenizer": tokenizer}, device="cpu")
    kwargs = dict(CALL, num_inference_steps=2, max_sequence_length=TXT_LEN, output_type="latent")
    a = tpipe_t5(image=IMAGE, prompt=PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).frames
    b = loaded(image=IMAGE, prompt=PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).frames
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the port's own save reads back, the processor listed under transformers
    loaded.save_pretrained(tmp_path / "again")
    saved = json.loads((tmp_path / "again" / "model_index.json").read_text())
    assert saved["image_processor"] == ["transformers", "CLIPImageProcessor"]
    assert saved["image_encoder"][1] == "CLIPVisionModel" and saved["boundary_ratio"] is None
    again = WanImageToVideoPipeline.from_pretrained(tmp_path / "again", device="cpu")
    torch.testing.assert_close(again(image=IMAGE, prompt=PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).frames,
                               b, rtol=0, atol=0)


# ---------------------------------------------------------------------------------------------- video-to-video

VIDEO = np.random.RandomState(5).rand(1, 9, 16, 16, 3).astype(np.float32)  # [B, T, H, W, C] in [0, 1]
V2V_CALL = dict(height=16, width=16, guidance_scale=5.0)
V2V_STEPS, STRENGTH = 5, 0.6


def _v2v_composed(jpipe, noise, steps=V2V_STEPS, strength=STRENGTH, text_len=TXT_LEN, cut=True, guidance=5.0):
    """Upstream's V2V from JAX's parts: JAX's encode (`mode()`, normalised),
    `add_noise` at the first kept timestep, `_denoise` over the kept steps
    with the ladder cut there (`cut`; else JAX's own: the whole ladder from
    step index 0), JAX's decode. Returns the final latents."""
    transformer, t_params = jpipe.transformer
    vae, vae_params = jpipe.vae
    pe, ne = jpipe.encode_prompt(PROMPT, None, True, text_len)
    vid = jnp.asarray(jpipe.video_processor.preprocess_video(VIDEO, height=16, width=16))
    state = jpipe.scheduler.set_timesteps(steps, sample_shape=noise.shape)
    t_start = steps - int(steps * strength)
    timesteps = state.timesteps[t_start:]
    if cut:
        state = state.replace(timesteps=state.timesteps[t_start:], sigmas=state.sigmas[t_start:])
    init = vae.encode(vae_params, vid).mode()
    lm = jnp.asarray(vae.config.latents_mean).reshape(1, -1, 1, 1, 1)
    ls = jnp.asarray(vae.config.latents_std).reshape(1, -1, 1, 1, 1)
    latents = jpipe.scheduler.add_noise(state, (init - lm) / ls, jnp.asarray(noise), timesteps[:1])
    cos, sin = transformer.rope(*latents.shape[2:])
    denoise = jpipe._jit("composed_denoise", partial(jpipe._denoise, guidance_scale=guidance, do_cfg=True),
                         static=(guidance,))  # JAX's own per-pipeline jit cache, keyed by the cache config too
    return np.asarray(denoise(t_params, latents, pe, ne, cos, sin, timesteps, state))


@pytest.fixture(scope="module")
def jax_v2v_request(v2v):
    """JAX's own V2V request (strength 0.6, 5 steps, key 0), made once for
    the tests that read it."""
    jpipe, _ = v2v
    return np.asarray(jpipe(PROMPT, video=VIDEO, strength=STRENGTH, num_inference_steps=V2V_STEPS,
                            max_sequence_length=TXT_LEN, output_type="latent", key=jax.random.PRNGKey(0),
                            **V2V_CALL).frames)


@pytest.fixture(scope="module")
def v2v_noise():
    return np.random.RandomState(6).randn(1, 4, 5, 8, 8).astype(np.float32)


def _port_v2v(tpipe, noise, monkeypatch, **kw):
    draws = [noise]
    monkeypatch.setattr(torch_utils, "randn_tensor", lambda shape, generator=None, device=None: torch.from_numpy(
        draws.pop(0)).to(device))
    kwargs = dict(V2V_CALL, video=VIDEO, num_inference_steps=V2V_STEPS, strength=STRENGTH, output_type="latent")
    kwargs.update(kw)
    out = _frames(tpipe(PROMPT, **kwargs).frames)
    assert not draws
    return out


def test_v2v_matches_upstream_rule_from_jax_parts(v2v, v2v_noise, monkeypatch):
    """(d) The port's V2V (strength 0.6: the last 3 of 5 steps) equals
    upstream's rule composed from JAX's parts, on the latents and on the
    decoded frames; its transformer runs 2 x 3 times."""
    jpipe, tpipe = v2v
    ref = _v2v_composed(jpipe, v2v_noise)
    calls, handle = _calls(tpipe.transformer)
    try:
        out = _port_v2v(tpipe, v2v_noise, monkeypatch)
    finally:
        handle.remove()
    assert out.shape == ref.shape == (1, 4, 5, 8, 8) and calls == [1] * 6
    assert float(np.abs(out - ref).max()) <= ATOL, float(np.abs(out - ref).max())
    frames = _port_v2v(tpipe, v2v_noise, monkeypatch, output_type="np")
    vae, vae_params = jpipe.vae
    lm = jnp.asarray(vae.config.latents_mean).reshape(1, -1, 1, 1, 1)
    ls = jnp.asarray(vae.config.latents_std).reshape(1, -1, 1, 1, 1)
    ref_frames = np.asarray(jnp.transpose(jnp.clip(vae.decode(vae_params, jnp.asarray(ref) * ls + lm).sample / 2 + 0.5,
                                                   0, 1), (0, 2, 3, 4, 1)))
    assert frames.shape == (1, 9, 16, 16, 3)
    assert float(np.abs(frames - ref_frames).max()) <= ATOL


def test_jax_v2v_steps_the_head_of_the_ladder(v2v, v2v_noise, jax_v2v_request):
    """(d), JAX's side: JAX's V2V is the composed rule with the whole ladder
    from step index 0, so it ends at sigma[S - t_start] > 0, not at 0, and
    differs from upstream's rule."""
    jpipe, _ = v2v
    _, noise_key = jax.random.split(jax.random.PRNGKey(0))
    noise = np.array(jax_randn(v2v_noise.shape, key=noise_key, dtype=jnp.float32))
    ref = jax_v2v_request
    head = _v2v_composed(jpipe, noise, cut=False)
    upstream = _v2v_composed(jpipe, noise)
    assert float(np.abs(ref - head).max()) <= 1e-5
    assert float(np.abs(ref - upstream).max()) > 1e-2
    sigmas = np.asarray(jpipe.scheduler.set_timesteps(V2V_STEPS).sigmas)
    assert sigmas[V2V_STEPS - int(V2V_STEPS * STRENGTH)] > 0 and sigmas[-1] == 0


def test_v2v_text_length_226(v2v, v2v_noise, monkeypatch):
    """The port's default is 512 text tokens; at JAX's default 226 it equals
    the composed rule at 226, and the two lengths give different videos."""
    jpipe, tpipe = v2v
    ref = _v2v_composed(jpipe, v2v_noise, text_len=226)
    out = _port_v2v(tpipe, v2v_noise, monkeypatch, max_sequence_length=226)
    assert float(np.abs(out - ref).max()) <= ATOL
    default = _port_v2v(tpipe, v2v_noise, monkeypatch)
    assert float(np.abs(default - out).max()) > 1e-3


V2V_CACHES = {
    "taylorseer": lambda m: m.TaylorSeerCacheConfig(cache_interval=2, disable_cache_before_step=1, max_order=1),
    "mag_cache": lambda m: m.MagCacheConfig(threshold=0.5, max_skip_steps=1, retention_ratio=0.25,
                                            num_inference_steps=3, mag_ratios=(1.0,) * 3),
    "text_kv": lambda m: m.TextKVCacheConfig(),
    "first_block_cache": lambda m: m.FirstBlockCacheConfig(threshold=0.5),
}


@pytest.mark.parametrize("name", sorted(V2V_CACHES))
def test_v2v_caches_match_jax(v2v, v2v_noise, monkeypatch, name):
    """The configs JAX's V2V honours through `WanPipeline._denoise`, against
    the composed rule under the same config."""
    jpipe, tpipe = v2v
    jconfig = V2V_CACHES[name](jhooks) if name != "text_kv" else __import__(
        "diffusers_tpu.hooks.generic_cache", fromlist=["x"]).TextKVCacheConfig()
    jpipe.enable_cache(jconfig)
    tpipe.enable_cache(V2V_CACHES[name](hooks))
    try:
        ref = _v2v_composed(jpipe, v2v_noise)
        out = _port_v2v(tpipe, v2v_noise, monkeypatch)
    finally:
        jpipe.disable_cache()
        tpipe.disable_cache()
    assert float(np.abs(out - ref).max()) <= ATOL, float(np.abs(out - ref).max())


def test_v2v_refuses_what_jax_v2v_does_not_honour(v2v, v2v_noise, monkeypatch, jax_v2v_request):
    """FasterCache runs dense in JAX's V2V (its schedule is made only in
    `WanPipeline.__call__`) and PAB raises there; the port raises TypeError
    on both, and ValueError under FreeInit (which JAX's V2V ignores)."""
    jpipe, tpipe = v2v
    kwargs = dict(V2V_CALL, video=VIDEO, num_inference_steps=V2V_STEPS, strength=STRENGTH,
                  max_sequence_length=TXT_LEN, output_type="latent", key=jax.random.PRNGKey(0))
    dense = jax_v2v_request
    jpipe.enable_cache(jhooks.FasterCacheConfig(unconditional_batch_skip_range=2,
                                                unconditional_batch_timestep_skip_range=(-1, 1000)))
    try:
        np.testing.assert_array_equal(np.asarray(jpipe(PROMPT, **kwargs).frames), dense)
    finally:
        jpipe.disable_cache()
    from diffusers_tpu.hooks.pyramid_attention_broadcast import PyramidAttentionBroadcastConfig as JaxPAB

    jpipe.enable_cache(JaxPAB(spatial_attention_block_skip_range=2))
    try:
        with pytest.raises(ValueError, match="does not support cache config"):
            jpipe(PROMPT, **kwargs)
    finally:
        jpipe.disable_cache()
    for config in (hooks.FasterCacheConfig(), hooks.PyramidAttentionBroadcastConfig()):
        with pytest.raises(TypeError, match="does not support cache config"):
            tpipe.enable_cache(config)
    tpipe.enable_free_init(num_iters=2)
    try:
        with pytest.raises(ValueError, match="FreeInit"):
            _port_v2v(tpipe, v2v_noise, monkeypatch)
    finally:
        tpipe.disable_free_init()


def test_jax_v2v_fixture_vae_never_downsamples_in_time(v2v, jax_v2v_request):
    """(e) tests/test_wan_variants.py::test_wan_video2video's VAE
    (`dim_mult=[1, 2]`, `temperal_downsample=[False, True]`) keeps 5 frames
    where its `scale_factor_temporal=2` promises 3, so JAX's V2V raises on
    it; on a consistent VAE (`[True]`, the module's pair) JAX's V2V runs, and
    the port's chunked encode refuses a frame count that is not 1 + 2 k."""
    jpipe, tpipe = v2v
    bad = dict(VAE, base_dim=16, temperal_downsample=(False, True))
    jm, params = _parts([("vae", JaxVAE, AutoencoderKLWan, bad)], seed=0)[0]["vae"]
    assert jm.encode(params, jnp.zeros((1, 3, 5, 16, 16))).mode().shape[2] == 5
    jbad = jit_reference(JaxV2V(tokenizer=MaskTokenizer(), text_encoder=jpipe.text_encoder,
                                transformer=jpipe.transformer, vae=(jm, params), scheduler=JaxUniPC(**UNIPC)), ("vae",))
    kwargs = dict(V2V_CALL, video=VIDEO, strength=STRENGTH, num_inference_steps=V2V_STEPS,
                  max_sequence_length=TXT_LEN, output_type="latent", key=jax.random.PRNGKey(0))
    with pytest.raises(TypeError, match="add got incompatible shapes|Incompatible shapes"):
        jbad(PROMPT, **kwargs)
    assert np.isfinite(jax_v2v_request).all()  # the module's consistent VAE: JAX's V2V runs
    with pytest.raises(ValueError, match="takes 1 \\+ 2 k frames"):
        tpipe.vae.encode(torch.zeros(1, 3, 4, 16, 16))


@pytest.mark.parametrize("layout", ["BTHWC", "BCTHW", "BTCHW", "THWC", "TCHW", "list of THWC", "torch BTHWC"])
def test_preprocess_video_layouts_match_jax(layout):
    video = np.random.RandomState(7).rand(2, 5, 8, 12, 3).astype(np.float32)  # [B, T, H, W, C]
    given = {"BTHWC": video, "BCTHW": video.transpose(0, 4, 1, 2, 3), "BTCHW": video.transpose(0, 1, 4, 2, 3),
             "THWC": video[0], "TCHW": video[0].transpose(0, 3, 1, 2), "list of THWC": list(video),
             "torch BTHWC": torch.from_numpy(video)}[layout]
    out = VideoProcessor().preprocess_video(given)
    ref = JaxVideoProcessor().preprocess_video(given.numpy() if isinstance(given, torch.Tensor) else given)
    assert out.shape == ref.shape == ((1,) if layout in ("THWC", "TCHW") else (2,)) + (3, 5, 8, 12)
    np.testing.assert_array_equal(out, ref)
    assert out.min() >= -1 and out.max() <= 1 and out.min() < 0

"""The port's HunyuanVideo 1.5 family against the JAX package on the CPU:
`HunyuanVideo15Transformer3DModel` for text-to-video (all-zero image embeds)
and image-to-video, with meanflow's `timestep_r`; `merge_condition_streams`
on ragged masks, the 3-axis RoPE tables and the joint key bias against JAX's
bool mask; `AutoencoderKLHunyuanVideo15` (encode moments and decode over 3
latent frames, the causal convs' span-wise path included) and its mid
block's frame-causal attention, served a query frame at a time, against
JAX's dense keep-mask; `HunyuanVideo15Pipeline` (CFG through
`guidance_scale` as one batch-2 call, the chat template and JAX's fallback
string, TaylorSeer and MagCache on the guidance-free path and their refusal
under CFG, a step callback, `calculate_default_height_width`) and
`HunyuanVideo15ImageToVideoPipeline` (SigLIP's embeds, the first frame's
VAE mode as the condition) end to end; `from_pretrained` round trips and
the default device.

Tiny widths: the transformer 2 heads x 12, two dual blocks (one in the
pipelines), one refiner layer (9 input channels: 4 latent, 4 condition, the mask); a VAE of widths
(8, 16, 16), 4x in space and time; a 2-layer Qwen2.5-VL tower 16 wide, a
2-layer ByT5 10 wide and a 1-layer SigLIP 12 wide (16 px, patches of 4)
behind stand-in tokenizers; 9 frames of 16 x 16 (3 x 4 x 4 latents). Both
pipelines get the same small token budgets (`BUDGETS`: the stand-in
template's 34-token prefix, 8 Qwen, 16 ByT5 and 4 text-to-video image
tokens) after their defaults are checked equal (108, 1,000, 256, 729). The
port's seeded weights reach JAX through `convert_torch_state_dict`; both
pipelines get the same numpy latents. JAX's sub-modules run under `jax.jit`.

Tolerance: 5e-4 on models and pipelines (the README's whole-model bound),
f32 on both sides; the tables, masks and biases exact; the frame-wise
attention within 1e-5 of the dense mask's (f32 rounding).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusers_tpu.hooks as jhooks
from diffusers_tpu.models.autoencoders.autoencoder_kl_hunyuanvideo15 import AutoencoderKLHunyuanVideo15 as JaxVAE
from diffusers_tpu.models.text_encoders.qwen2_vl import Qwen2_5_VLTextEncoder as JaxQwenTE
from diffusers_tpu.models.text_encoders.siglip import SiglipVisionModel as JaxSiglip
from diffusers_tpu.models.text_encoders.t5 import T5EncoderModel as JaxT5
from diffusers_tpu.models.transformers import transformer_hunyuan_video15 as jhv
from diffusers_tpu.ops.attention import dispatch_attention_fn as jax_attention
from diffusers_tpu.pipelines.hunyuan_video1_5 import HunyuanVideo15ImageToVideoPipeline as JaxI2V
from diffusers_tpu.pipelines.hunyuan_video1_5 import HunyuanVideo15Pipeline as JaxT2V
from diffusers_tpu.pipelines.hunyuan_video1_5.pipeline_hunyuan_video1_5 import (
    calculate_default_height_width as jax_default_height_width,
)
from diffusers_tpu.schedulers import FlowMatchEulerDiscreteScheduler as JaxFlowMatch
import diffusers_tpu_torch.hooks as hooks
from diffusers_tpu_torch import (
    AutoencoderKLHunyuanVideo15,
    DiffusionPipeline,
    HunyuanVideo15ImageToVideoPipeline,
    HunyuanVideo15Pipeline,
    HunyuanVideo15Transformer3DModel,
    Qwen2_5_VLTextEncoder,
    SiglipVisionModel,
)
from diffusers_tpu_torch.models.autoencoders.autoencoder_kl_hunyuan_video import HYCausalConv3d, frame_causal_sdpa
from diffusers_tpu_torch.models.text_encoders.t5 import T5EncoderModel
from diffusers_tpu_torch.models.transformers.transformer_hunyuan_video import validity_bias
from diffusers_tpu_torch.models.transformers.transformer_hunyuan_video15 import merge_condition_streams
from diffusers_tpu_torch.models.transformers.transformer_hunyuanimage import joint_bias
from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention_full
from diffusers_tpu_torch.pipelines.hunyuan_video1_5.pipeline_hunyuan_video1_5 import calculate_default_height_width
from diffusers_tpu_torch.schedulers import FlowMatchEulerDiscreteScheduler
from test_torch_hunyuan_image import BYT5, QWEN, ByT5Tokenizer, QwenTokenizer
from test_torch_jit_reference import JitModule
from test_torch_qwenimage import carry, seeded
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

ATOL = 5e-4
TF = dict(in_channels=9, out_channels=4, num_attention_heads=2, attention_head_dim=12, num_layers=2,
          num_refiner_layers=1, text_embed_dim=16, text_embed_2_dim=10, image_embed_dim=12, rope_axes_dim=(4, 4, 4))
PIPE_TF = dict(TF, num_layers=1)  # the pipelines' transformer: one dual block
VAE = dict(in_channels=3, out_channels=3, latent_channels=4, block_out_channels=(8, 16, 16), layers_per_block=1,
           spatial_compression_ratio=4, temporal_compression_ratio=4)
SIGLIP = dict(hidden_size=12, intermediate_size=24, num_hidden_layers=1, num_attention_heads=2, image_size=16,
              patch_size=4)
STEPS = 3
CALL = dict(height=16, width=16, num_frames=9, num_inference_steps=STEPS)
PROMPT = 'a fox runs past a sign that says "STOP"'
LATENTS = np.random.RandomState(1).randn(1, 4, 3, 4, 4).astype(np.float32)
IMAGE = np.random.RandomState(2).uniform(-1, 1, (3, 16, 16)).astype(np.float32)


class ChatTokenizer(QwenTokenizer):
    """`QwenTokenizer` with a chat template: the conversation rendered as
    Qwen2's template renders it, then tokenized."""

    def apply_chat_template(self, conversations, add_generation_prompt=True, tokenize=True, return_dict=True,
                            **kwargs):
        texts = ["".join(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n" for m in c)
                 + ("<|im_start|>assistant\n" if add_generation_prompt else "") for c in conversations]
        return self(texts, **kwargs)


def _inputs(image_embeds, seed=0):
    rng = np.random.RandomState(seed)
    mask = np.ones((2, 7), np.int64)
    mask[0, 5:] = 0
    mask[1, 0] = 0
    mask_2 = np.zeros((2, 5), np.int64)
    mask_2[1, :3] = 1  # row 0: no glyph text
    return dict(hidden_states=rng.randn(2, 9, 2, 4, 6).astype(np.float32), timestep=np.array([900.0, 300.0], np.float32),
                encoder_hidden_states=rng.randn(2, 7, 16).astype(np.float32), encoder_attention_mask=mask,
                encoder_hidden_states_2=rng.randn(2, 5, 10).astype(np.float32), encoder_attention_mask_2=mask_2,
                image_embeds=image_embeds)


IMAGE_EMBEDS = np.random.RandomState(5).randn(2, 3, 12).astype(np.float32)
MODEL_CASES = {
    "t2v": ({}, dict(image_embeds=np.zeros((2, 3, 12), np.float32))),
    "i2v": ({}, dict(image_embeds=IMAGE_EMBEDS)),
    "i2v_meanflow": (dict(use_meanflow=True), dict(image_embeds=IMAGE_EMBEDS,
                                                   timestep_r=np.array([800.0, 0.0], np.float32))),
}


@functools.lru_cache(maxsize=None)
def transformer_pair(use_meanflow: bool):
    """(port transformer, jitted JAX call, JAX params) of TF, shared by the
    cases of one config (JAX traces a call once a pytree and shape)."""
    cfg = dict(TF, use_meanflow=use_meanflow)
    tm = seeded(HunyuanVideo15Transformer3DModel, cfg, seed=1)
    jm, params = carry(jhv.HunyuanVideo15Transformer3DModel, tm, cfg)
    return tm, jax.jit(lambda p, kw: jm(p, **kw).sample), params


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_transformer_matches_jax(name):
    extra_cfg, extra_in = MODEL_CASES[name]
    tm, jax_call, params = transformer_pair(extra_cfg.get("use_meanflow", False))
    ins = dict(_inputs(extra_in["image_embeds"]), **extra_in)
    ref = np.asarray(jax_call(params, {k: jnp.asarray(v) for k, v in ins.items()}))
    flash_attention_full.launches = 0
    with torch.no_grad():
        out = tm(**{k: torch.from_numpy(v) for k, v in ins.items()}).sample.numpy()
    assert flash_attention_full.launches == 0
    assert out.shape == ref.shape == (2, 4, 2, 4, 6)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_merge_rope_and_bias_match_jax():
    """The merged condition stream and mask equal JAX's on ragged masks
    (image rows valid in one batch row, not in the other); the RoPE tables
    bit-equal to JAX's; the joint key bias is JAX's bool mask and
    `validity_bias` of the merged count."""
    rng = np.random.RandomState(3)
    image, text_2, text = (rng.randn(2, n, 4).astype(np.float32) for n in (3, 4, 5))
    image_mask = np.array([[True] * 3, [False] * 3])
    mask_2 = np.array([[1, 0, 1, 0], [0, 0, 0, 0]], np.int64)
    mask = np.array([[1, 1, 0, 0, 0], [0, 1, 1, 1, 0]], np.int64)
    ref, ref_mask = jhv._merge_condition_streams(jnp.asarray(image), jnp.asarray(image_mask), jnp.asarray(text_2),
                                                 jnp.asarray(mask_2.astype(bool)), jnp.asarray(text),
                                                 jnp.asarray(mask.astype(bool)))
    out, out_mask = merge_condition_streams(*map(torch.from_numpy, (image, image_mask, text_2, mask_2, text, mask)))
    assert np.array_equal(out.numpy(), np.asarray(ref)) and np.array_equal(out_mask.numpy(), np.asarray(ref_mask))
    keep = np.concatenate([np.ones((2, 6), bool), np.asarray(ref_mask)], axis=1)
    bias = joint_bias(out_mask, 6).numpy()
    assert np.array_equal(bias[:, 0, 0] == 0, keep) and np.all(np.isneginf(bias[:, 0, 0][~keep]))
    assert np.array_equal(bias, validity_bias(out_mask, 6).numpy())
    for cfg, sizes in ((TF, (3, 5, 7)), (dict(TF, patch_size=2, rope_axes_dim=(16, 56, 56)), (9, 30, 54))):
        for r, o in zip(jhv.HunyuanVideo15Transformer3DModel(**cfg).rope(*sizes),
                        HunyuanVideo15Transformer3DModel(**cfg).rope(*sizes)):
            assert np.array_equal(o, r)


def test_frame_causal_attention_matches_the_dense_mask():
    """A query of frame f over the keys of frames 0..f, a frame at a time,
    against JAX's attention under the dense [N, N] keep-mask."""
    rng = np.random.RandomState(6)
    t, hw = 3, 5
    q, k, v = (rng.randn(2, t * hw, 1, 16).astype(np.float32) for _ in range(3))
    frame = np.repeat(np.arange(t), hw)
    keep = jnp.asarray(frame[None, :] <= frame[:, None])[None, None]
    ref = np.asarray(jax.jit(lambda a, b, c: jax_attention(a, b, c, attn_mask=keep))(q, k, v))
    out = frame_causal_sdpa(*map(torch.from_numpy, (q, k, v)), hw).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@functools.lru_cache(maxsize=None)
def vae_reference():
    """(port VAE, video, latents, JAX's moments, JAX's decode): one JAX run
    for both cases."""
    tm = seeded(AutoencoderKLHunyuanVideo15, VAE, seed=2)
    jm, params = carry(JaxVAE, tm, VAE)
    x = np.random.RandomState(3).randn(1, 3, 9, 16, 16).astype(np.float32)
    z = np.random.RandomState(4).randn(1, 4, 3, 4, 4).astype(np.float32)
    mom_ref = np.asarray(jax.jit(lambda p, v: jm.encode(p, v).parameters)(params, x))
    dec_ref = np.asarray(jax.jit(lambda p, v: jm.decode(p, v).sample)(params, z))
    return tm, x, z, mom_ref, dec_ref


@pytest.mark.parametrize("chunked", [False, True])
def test_vae_matches_jax(chunked, monkeypatch):
    """Encode (the moments) and decode over 9 frames (3 latent frames): the
    first frame shuffled in space only, the frame-causal mid-block attention;
    chunked, each causal conv over 600 bytes convolves a span of output
    frames at a time."""
    if chunked:
        monkeypatch.setattr(HYCausalConv3d, "chunk_bytes", 600)
    tm, x, z, mom_ref, dec_ref = vae_reference()
    with torch.no_grad():
        mom = tm.encode(torch.from_numpy(x)).latent_dist.parameters.numpy()
        dec = tm.decode(torch.from_numpy(z)).sample.numpy()
    assert mom.shape == mom_ref.shape == (1, 8, 3, 4, 4) and dec.shape == dec_ref.shape == x.shape
    np.testing.assert_allclose(mom, mom_ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(dec, dec_ref, atol=ATOL, rtol=0)


# ------------------------------------------------------------------ pipelines
@functools.lru_cache(maxsize=None)
def parts():
    torch_parts = {"transformer": seeded(HunyuanVideo15Transformer3DModel, PIPE_TF, seed=5),
                   "vae": seeded(AutoencoderKLHunyuanVideo15, VAE, seed=6),
                   "text_encoder": seeded(Qwen2_5_VLTextEncoder, QWEN, seed=7),
                   "text_encoder_2": seeded(T5EncoderModel, BYT5, seed=8),
                   "image_encoder": seeded(SiglipVisionModel, SIGLIP, seed=9)}
    jax_parts = {}
    for name, jcls, cfg in (("transformer", jhv.HunyuanVideo15Transformer3DModel, PIPE_TF), ("vae", JaxVAE, VAE),
                            ("text_encoder", JaxQwenTE, QWEN), ("text_encoder_2", JaxT5, BYT5),
                            ("image_encoder", JaxSiglip, SIGLIP)):
        jm, params = carry(jcls, torch_parts[name], cfg)
        jax_parts[name] = (jm if name == "transformer" else JitModule(jm), params)
    return jax_parts, torch_parts


@functools.lru_cache(maxsize=None)
def pipelines(i2v=False):
    """(JAX pipeline, port pipeline), made once a configuration."""
    jax_parts, torch_parts = parts()
    if not i2v:
        jax_parts = {k: v for k, v in jax_parts.items() if k != "image_encoder"}
        torch_parts = {k: v for k, v in torch_parts.items() if k != "image_encoder"}
    jcls, tcls = (JaxI2V, HunyuanVideo15ImageToVideoPipeline) if i2v else (JaxT2V, HunyuanVideo15Pipeline)
    jpipe = jcls(scheduler=JaxFlowMatch(shift=7.0), tokenizer=QwenTokenizer(), tokenizer_2=ByT5Tokenizer(),
                 **jax_parts)
    tpipe = tcls(scheduler=FlowMatchEulerDiscreteScheduler(shift=7.0), tokenizer=QwenTokenizer(),
                 tokenizer_2=ByT5Tokenizer(), device="cpu", **torch_parts)
    assert {k: getattr(tpipe, k) for k in BUDGETS} == {k: getattr(jpipe, k) for k in BUDGETS} == DEFAULT_BUDGETS
    return with_budgets(jpipe), with_budgets(tpipe)


# the text and image token budgets: the published ones (both pipelines' defaults), and the tiny ones the tests give
# both pipelines (the stand-in tokenizer's template prefix is 34 tokens long)
DEFAULT_BUDGETS = dict(prompt_template_encode_start_idx=108, tokenizer_max_length=1000, tokenizer_2_max_length=256,
                       vision_num_semantic_tokens=729)
BUDGETS = dict(prompt_template_encode_start_idx=34, tokenizer_max_length=8, tokenizer_2_max_length=16,
               vision_num_semantic_tokens=4)


def with_budgets(pipe):
    for k, v in BUDGETS.items():
        setattr(pipe, k, v)
    return pipe


def _run_both(jpipe, tpipe, *args, **kwargs):
    ref = np.asarray(jpipe(*args, latents=jnp.asarray(LATENTS), **CALL, **kwargs).frames)
    calls = []
    handle = tpipe.transformer.register_forward_pre_hook(lambda mod, a: calls.append(a[0].shape[0]))
    flash_attention_full.launches = 0
    try:
        out = tpipe(*args, latents=torch.from_numpy(LATENTS), **CALL, **kwargs).frames
    finally:
        handle.remove()
    assert flash_attention_full.launches == 0
    assert out.shape == ref.shape == (1, 9, 16, 16, 3) and out.min() >= 0 and out.max() <= 1
    assert float(np.abs(out - ref).max()) <= ATOL, float(np.abs(out - ref).max())
    return calls


REQUESTS = {
    "t2v_cfg": (dict(), (PROMPT,), dict(guidance_scale=6.0, negative_prompt="blurry"), [2] * STEPS),
    "t2v_chat_template": (dict(chat=True), (PROMPT,), dict(guidance_scale=6.0), [2] * STEPS),
    "t2v_plain": (dict(), ("a quiet lake",), {}, [1] * STEPS),
    "i2v_cfg": (dict(i2v=True), (IMAGE, PROMPT), dict(guidance_scale=6.0), [2] * STEPS),
}


@pytest.mark.parametrize("name", list(REQUESTS))
def test_pipeline_matches_jax(name):
    """Each request to frames [B, F, H, W, C]: the chat template (a tokenizer
    that has one, on both pipelines) or JAX's fallback string, the ByT5
    stream on and off, CFG as one batch-2 call a step; image-to-video with
    SigLIP's embeds and the first frame's VAE mode."""
    build, args, kwargs, expected = REQUESTS[name]
    pipes = pipelines(**{k: v for k, v in build.items() if k != "chat"})
    if build.get("chat"):
        for pipe in pipes:
            pipe.tokenizer = ChatTokenizer()
    try:
        assert _run_both(*pipes, *args, **kwargs) == expected
    finally:
        for pipe in pipes:
            pipe.tokenizer = QwenTokenizer()


def test_image_to_video_condition():
    """The condition latents: the first frame's posterior mode times the
    scaling factor, zeros after it, the mask 1 on frame 0 only; SigLIP's
    embeds broadcast over the batch, from the [0, 1] image where there is a
    feature extractor (FramePack's preprocessing)."""
    _, tpipe = pipelines(i2v=True)
    latents = torch.zeros(2, 4, 3, 4, 4)
    cond, mask = tpipe.prepare_cond_latents_and_mask_i2v(latents, IMAGE)
    with torch.no_grad():
        first = tpipe.vae.encode(torch.from_numpy(IMAGE)[None, :, None]).latent_dist.mode()
    assert torch.equal(cond[:, :, :1], (first * tpipe.vae.config.scaling_factor).expand(2, -1, -1, -1, -1))
    assert not cond[:, :, 1:].any() and mask[:, :, 0].eq(1).all() and not mask[:, :, 1:].any()
    seen = []

    def extractor(images, return_tensors="np", do_rescale=True):
        seen.append((float(np.min(images)), do_rescale))
        return {"pixel_values": images * 2.0 - 1.0}

    embeds = tpipe.encode_image(IMAGE, 2)
    tpipe.feature_extractor = extractor
    try:
        assert torch.allclose(tpipe.encode_image(IMAGE, 2), embeds, atol=1e-6)
    finally:
        tpipe.feature_extractor = None
    assert embeds.shape == (2, 16, 12) and seen[0][0] >= 0 and seen[0][1] is False


CACHES = {
    "taylorseer": lambda m: m.TaylorSeerCacheConfig(cache_interval=2, disable_cache_before_step=1, max_order=1),
    "mag_cache": lambda m: m.MagCacheConfig(threshold=0.5, max_skip_steps=1, retention_ratio=0.25,
                                            num_inference_steps=STEPS, mag_ratios=(1.0,) * STEPS),
}


@pytest.mark.parametrize("name", sorted(CACHES))
def test_cache_on_the_guidance_free_path_matches_jax(name):
    """TaylorSeer and MagCache skip calls on the guidance-free path as JAX's
    do; under CFG, whose JAX loop ignores a cache, the port raises."""
    jpipe, tpipe = pipelines()
    jpipe.enable_cache(CACHES[name](jhooks))
    tpipe.enable_cache(CACHES[name](hooks))
    try:
        calls = _run_both(jpipe, tpipe, "a quiet lake")
        assert 0 < len(calls) < STEPS
        with pytest.raises(TypeError, match="guidance-free path only"):
            tpipe(PROMPT, guidance_scale=6.0, output_type="latent", **CALL)
    finally:
        jpipe.disable_cache()
        tpipe.disable_cache()


def test_callback_and_default_size():
    """A callback that scales the latents at step 1 gives JAX's frames on the
    guidance-free path, and runs after every step under CFG (where JAX's
    scan never calls it; ROADMAP C3); the default size is JAX's bucket."""
    jpipe, tpipe = pipelines()
    _run_both(jpipe, tpipe, "a quiet lake",
              callback_on_step_end=lambda pipe, i, t, kw: {"latents": kw["latents"] * 0.9} if i == 1 else {})
    steps = []
    tpipe(PROMPT, guidance_scale=6.0, output_type="latent", latents=torch.from_numpy(LATENTS),
          callback_on_step_end=lambda pipe, i, t, kw: steps.append(i), **CALL)
    assert steps == list(range(STEPS))
    for args in ((9, 16, 640, 16), (16, 9, 640, 16), (480, 848, 480, 16), (1, 1, 256, 16)):
        assert calculate_default_height_width(*args) == jax_default_height_width(*args)


def test_from_pretrained_round_trip_and_default_device(tmp_path):
    """The image-to-video pipeline through `save_pretrained` and
    `DiffusionPipeline.from_pretrained`: the same weights (ByT5 as
    `T5EncoderModel`, SigLIP) and the same frames; the text-to-video
    pipeline's directory loads as its class with the same weights; the
    default device is the card."""
    _, tpipe = pipelines(i2v=True)
    tpipe.save_pretrained(tmp_path)
    loaded = with_budgets(DiffusionPipeline.from_pretrained(tmp_path, device="cpu", tokenizer=QwenTokenizer(),
                                                            tokenizer_2=ByT5Tokenizer()))
    assert type(loaded) is HunyuanVideo15ImageToVideoPipeline and loaded.guider is None
    for name in ("transformer", "vae", "text_encoder", "text_encoder_2", "image_encoder"):
        a, b = getattr(tpipe, name).state_dict(), getattr(loaded, name).state_dict()
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    kwargs = dict(CALL, num_inference_steps=2, latents=torch.from_numpy(LATENTS), output_type="latent")
    assert torch.equal(loaded(IMAGE, "a quiet lake", **kwargs).frames, tpipe(IMAGE, "a quiet lake", **kwargs).frames)
    HunyuanVideo15Pipeline.from_pipe(tpipe).save_pretrained(tmp_path / "t2v")
    t2v = DiffusionPipeline.from_pretrained(tmp_path / "t2v", device="cpu", tokenizer=QwenTokenizer(),
                                            tokenizer_2=ByT5Tokenizer())
    assert type(t2v) is HunyuanVideo15Pipeline
    a, b = tpipe.transformer.state_dict(), t2v.transformer.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HunyuanVideo15Pipeline(**{k: v for k, v in tpipe.components.items()
                                      if k not in ("image_encoder", "feature_extractor")})

"""The port's Wan2.2-Animate modules and pipeline against the JAX package on
the CPU.

Tiny components at tests/test_transformer_wan_animate.py's widths: a
transformer of 2 layers of 2 heads x 12 with a face adapter after each, a
motion encoder at 16 px ({"4": 8, "8": 8, "16": 8} channels, motion dim 4),
a face encoder of 2 heads x 8; a 2-layer CLIP vision tower (16 px, 5
tokens), a 2-layer UMT5 and a VAE that downsamples 4x in time and space, so
a 5-frame segment has 2 latent frames plus the reference frame, as many as
the face encoder's 3 motion frames. The port's seeded weights (1-D ones
jittered) go to JAX with `convert_torch_state_dict`; both sides take the
same numpy inputs, float32.

Tolerances: 1e-5 for `Conv1d`, `MotionConv2d` with its blur, the motion
encoder with its QR and the face encoder; 5e-4 for the face adapter, the
transformer and the pipeline (animate and replace, two segments, to decoded
frames; measured below 1e-5); exact for `pad_video_frames`, `get_i2v_mask`
and replace mode's nearest mask resize.

The reference-side fault (ROADMAP C4 (e) again): JAX's own Animate test
fixture (tests/test_wan_variants.py) takes the VAE of
tests/test_pipeline_wan.py, which claims `scale_factor_temporal=2` but never
downsamples in time, and JAX's pipeline fails there on the i2v mask's frame
count; on a consistent VAE it runs.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from PIL import Image

import diffusers_tpu.models.transformers.transformer_wan_animate as janimate
from diffusers_tpu.models.autoencoders.autoencoder_kl_wan import AutoencoderKLWan as JaxVAE
from diffusers_tpu.models.modeling_utils import convert_torch_state_dict, flatten_to_torch_state_dict
from diffusers_tpu.models.text_encoders.clip import CLIPVisionModel as JaxCLIPVision
from diffusers_tpu.models.text_encoders.t5 import UMT5EncoderModel as JaxUMT5
from diffusers_tpu.ops.module import Conv1d as JaxConv1d
from diffusers_tpu.pipelines.wan.pipeline_wan_animate import WanAnimatePipeline as JaxAnimatePipeline
from diffusers_tpu.schedulers import UniPCMultistepScheduler as JaxUniPC
from diffusers_tpu_torch import (
    AutoencoderKLWan,
    CLIPVisionModel,
    UMT5EncoderModel,
    UniPCMultistepScheduler,
    WanAnimatePipeline,
    WanAnimateTransformer3DModel,
)
from diffusers_tpu_torch.models.modeling_utils import load_jax_params
from diffusers_tpu_torch.models.text_encoders.clip import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD
from diffusers_tpu_torch.models.transformers import transformer_wan_animate as animate
from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention_full
from diffusers_tpu_torch.ops.module import Conv1d
from diffusers_tpu_torch.utils import torch_utils
from test_torch_pipeline_cache import _parts
from test_torch_pipeline_wan import UMT5, UNIPC, MaskTokenizer, jit_reference
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)
from test_torch_jit_reference import fast_randn as jax_randn

torch.set_num_threads(1)

ATOL = 5e-4
MODULE_ATOL = 1e-5
PROMPT = "a dancer on a stage"
TXT_LEN = 16
STEPS = 2
TINY = dict(patch_size=(1, 2, 2), num_attention_heads=2, attention_head_dim=12, latent_channels=4, in_channels=12,
            out_channels=4, text_dim=16, freq_dim=32, ffn_dim=32, num_layers=2, image_dim=8, rope_max_seq_len=64,
            motion_encoder_size=16, motion_style_dim=8, motion_dim=4, motion_encoder_dim=8, face_encoder_hidden_dim=8,
            face_encoder_num_heads=2, inject_face_latents_blocks=1, motion_encoder_channel_sizes={"4": 8, "8": 8,
                                                                                                 "16": 8})
# the image branch of the published model (added k / v for the CLIP tokens), a face adapter every 2 blocks
TINY_IMAGE_BRANCH = dict(TINY, added_kv_proj_dim=24, inject_face_latents_blocks=2)
VAE = dict(base_dim=8, z_dim=4, dim_mult=(1, 2, 2), num_res_blocks=1, temperal_downsample=(True, True),
           latents_mean=[0.1, -0.2, 0.0, 0.3], latents_std=[1.0, 0.5, 2.0, 1.5], scale_factor_temporal=4,
           scale_factor_spatial=4)
CLIP = dict(hidden_size=8, intermediate_size=16, num_hidden_layers=2, num_attention_heads=2, image_size=16,
            patch_size=8)
H = W = 32
SEGMENT, N_FRAMES = 5, 7  # two segments: frames [0, 5) and [4, 9), the pose video padded from 7 to 9
_rng = np.random.RandomState(0)
IMAGE = Image.fromarray((_rng.rand(H, W, 3) * 255).astype(np.uint8))
POSE = (_rng.rand(1, 3, N_FRAMES, H, W) * 2 - 1).astype(np.float32)
FACE = (_rng.rand(1, 3, N_FRAMES, 16, 16) * 2 - 1).astype(np.float32)
BACKGROUND = [_rng.rand(H, W, 3).astype(np.float32) for _ in range(N_FRAMES)]
MASK_VIDEO = [np.repeat((_rng.rand(H, W, 1) > 0.5).astype(np.float32), 3, axis=2) for _ in range(N_FRAMES)]
LATENTS = np.random.RandomState(1).randn(1, 4, 3, 8, 8).astype(np.float32)  # 2 latent frames + the reference


def _to_jax(jm, model):
    return convert_torch_state_dict(jm, {k: v.numpy() for k, v in model.state_dict().items()})


def _seeded(module, seed):
    torch.manual_seed(seed)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)) * (0.5 if p.ndim > 1 else 0.1))
    return module.eval()


# ---------------------------------------------------------------------------------------------- the leaf modules


@pytest.mark.parametrize("kernel,stride,padding,groups", [(3, 1, 0, 1), (3, 2, 1, 1), (1, 1, 0, 1), (3, 1, 1, 2)])
def test_conv1d_matches_jax(kernel, stride, padding, groups):
    """`Conv1d` over NCL, weight OIK, against JAX's over NLC (kernel KIO)."""
    conv = _seeded(Conv1d(4, 6, kernel_size=kernel, stride=stride, padding=padding, groups=groups), 0)
    jconv = JaxConv1d(4, 6, kernel_size=kernel, stride=stride, padding=padding, groups=groups)
    x = np.random.RandomState(1).randn(2, 4, 9).astype(np.float32)
    ref = np.asarray(jax.jit(jconv)(_to_jax(jconv, conv), jnp.asarray(x.transpose(0, 2, 1)))).transpose(0, 2, 1)
    with torch.no_grad():
        out = conv(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=MODULE_ATOL)
    again = load_jax_params(Conv1d(4, 6, kernel_size=kernel, stride=stride, padding=padding, groups=groups),
                            jax.device_get(_to_jax(jconv, conv)))
    assert torch.equal(again.weight, conv.weight)


@pytest.mark.parametrize("case", ["blur_stride2", "blur_skip", "plain_3x3", "conv_out_4x4"])
def test_motion_conv2d_matches_jax(case):
    """The scaled convolution with the FIR blur's asymmetric padding, the
    fused leaky ReLU, the plain-bias form; OIHW here, HWIO in JAX."""
    kw = {"blur_stride2": dict(in_channels=4, out_channels=6, kernel_size=3, stride=2, blur_kernel=(1, 3, 3, 1)),
          "blur_skip": dict(in_channels=4, out_channels=6, kernel_size=1, stride=2, bias=False,
                            blur_kernel=(1, 3, 3, 1), use_activation=False),
          "plain_3x3": dict(in_channels=4, out_channels=4, kernel_size=3, padding=1),
          "conv_out_4x4": dict(in_channels=4, out_channels=5, kernel_size=4, bias=True, use_activation=False)}[case]
    conv = _seeded(animate.MotionConv2d(**kw), 2)
    jconv = janimate.MotionConv2d(**kw)
    params = _to_jax(jconv, conv)
    x = np.random.RandomState(3).randn(2, 4, 8, 8).astype(np.float32)
    ref = np.asarray(jax.jit(jconv)(params, jnp.asarray(x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    with torch.no_grad():
        out = conv(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=MODULE_ATOL)
    again = load_jax_params(animate.MotionConv2d(**kw), jax.device_get(params))
    assert all(torch.equal(a, b) for a, b in zip(again.state_dict().values(), conv.state_dict().values()))


def _motion_encoder():
    kw = dict(size=16, style_dim=8, motion_dim=4, out_dim=8, channels=TINY["motion_encoder_channel_sizes"])
    return _seeded(animate.WanAnimateMotionEncoder(**kw), 4), janimate.WanAnimateMotionEncoder(**kw)


def test_motion_encoder_matches_jax():
    """Residual blocks, the MLP and the QR decomposition of the synthesis
    basis; the port's Q (the host's LAPACK) equals JAX's column for column."""
    enc, jenc = _motion_encoder()
    params = _to_jax(jenc, enc)
    x = np.random.RandomState(5).randn(3, 3, 16, 16).astype(np.float32)
    ref = np.asarray(jax.jit(jenc)(params, jnp.asarray(x)))
    with torch.no_grad():
        out = enc(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (3, 8)
    np.testing.assert_allclose(out, ref, atol=MODULE_ATOL)
    w = enc.motion_synthesis_weight.detach().float() + 1e-8
    np.testing.assert_allclose(torch.linalg.qr(w)[0].numpy(), np.asarray(jnp.linalg.qr(jnp.asarray(w.numpy()))[0]),
                               atol=1e-6)
    with pytest.raises(ValueError, match="16x16"):
        enc(torch.zeros(1, 3, 8, 8))


def test_face_encoder_matches_jax():
    """The causal edge-padded convolutions (strides 1, 2, 2), the heads and
    the learned padding token: 9 frames -> 3."""
    kw = dict(in_dim=8, out_dim=24, hidden_dim=8, num_heads=2)
    enc, jenc = _seeded(animate.WanAnimateFaceEncoder(**kw), 6), janimate.WanAnimateFaceEncoder(**kw)
    x = np.random.RandomState(7).randn(2, 9, 8).astype(np.float32)
    ref = np.asarray(jax.jit(jenc)(_to_jax(jenc, enc), jnp.asarray(x)))
    with torch.no_grad():
        out = enc(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 3, 3, 24)
    np.testing.assert_allclose(out, ref, atol=MODULE_ATOL)
    np.testing.assert_array_equal(out[:, :, -1], np.broadcast_to(enc.padding_tokens.detach().numpy()[0, 0], (2, 3, 24)))


def test_face_adapter_matches_jax():
    """Each latent frame's tokens attend to that frame's N + 1 motion tokens."""
    kw = dict(dim=24, heads=2, dim_head=12, eps=1e-6, cross_attention_dim_head=12)
    att = _seeded(animate.WanAnimateFaceBlockCrossAttention(**kw), 8)
    jatt = janimate.WanAnimateFaceBlockCrossAttention(**kw)
    rng = np.random.RandomState(9)
    x, motion = rng.randn(2, 3 * 16, 24).astype(np.float32), rng.randn(2, 3, 3, 24).astype(np.float32)
    ref = np.asarray(jax.jit(jatt)(_to_jax(jatt, att), jnp.asarray(x), jnp.asarray(motion)))
    with torch.no_grad():
        out = att(torch.from_numpy(x), torch.from_numpy(motion)).numpy()
    assert float(np.abs(out - ref).max()) <= ATOL
    with pytest.raises(ValueError, match="must divide"):
        att(torch.zeros(1, 47, 24), torch.zeros(1, 3, 3, 24))


# ---------------------------------------------------------------------------------------------- the transformer


def _transformer_inputs(cfg, seed):
    rng = np.random.RandomState(seed)
    text = 512 if cfg.get("added_kv_proj_dim") else 5  # with the image branch the last 512 tokens are the text
    return dict(hidden_states=rng.randn(1, 12, 3, 8, 8).astype(np.float32), timestep=np.array([500.0], np.float32),
                encoder_hidden_states=rng.randn(1, text, 16).astype(np.float32),
                encoder_hidden_states_image=rng.randn(1, 5, 8).astype(np.float32),
                pose_hidden_states=rng.randn(1, 4, 2, 8, 8).astype(np.float32),
                face_pixel_values=rng.randn(1, 3, 5, 16, 16).astype(np.float32))


@pytest.mark.parametrize("cfg", ["fixture", "image_branch"])
def test_transformer_matches_jax(cfg):
    """The pose stream on patch frames 1 and later, the face motion tokens
    (encoded inside, 5 face frames -> 3 motion frames for 3 latent frames)
    and the adapters (after every block; every other block with the image
    branch); 5e-4; no K1 launch on the CPU."""
    config = {"fixture": TINY, "image_branch": TINY_IMAGE_BRANCH}[cfg]
    jp, tp = _parts([("transformer", janimate.WanAnimateTransformer3DModel, WanAnimateTransformer3DModel, config)],
                    seed=10)
    (jm, params), model = jp["transformer"], tp["transformer"]
    ins = _transformer_inputs(config, 11)
    ref = np.asarray(jax.jit(lambda p, kw: jm(p, **kw).sample)(params, {k: jnp.asarray(v) for k, v in ins.items()}))
    flash_attention_full.launches = 0
    with torch.no_grad():
        out = model(**{k: torch.from_numpy(v) for k, v in ins.items()}).sample.numpy()
        motion = model.encode_face_motion(torch.from_numpy(ins["face_pixel_values"])).numpy()
    assert flash_attention_full.launches == 0
    assert out.shape == ref.shape == (1, 4, 3, 8, 8) and motion.shape == (1, 3, 3, 24)
    assert float(np.abs(out - ref).max()) <= ATOL, float(np.abs(out - ref).max())
    jmotion = jax.jit(jm.encode_face_motion)(params, jnp.asarray(ins["face_pixel_values"]))
    np.testing.assert_allclose(motion, np.asarray(jmotion), atol=MODULE_ATOL)
    with pytest.raises(ValueError, match="one less"):
        model(**{**{k: torch.from_numpy(v) for k, v in ins.items()}, "pose_hidden_states": torch.zeros(1, 4, 3, 8, 8)})


def test_transformer_state_dict_round_trips(tmp_path):
    """Upstream's key names (`motion_encoder.*.weight` OIHW, `act_fn.bias`,
    `motion_synthesis_weight`, `face_encoder.padding_tokens`): JAX's params
    flattened equal the port's state dict, `load_jax_params` reads them
    back, and `save_pretrained` / `from_pretrained` round-trip bit-equal."""
    jp, tp = _parts([("transformer", janimate.WanAnimateTransformer3DModel, WanAnimateTransformer3DModel, TINY)],
                    seed=12)
    (jm, params), model = jp["transformer"], tp["transformer"]
    state = model.state_dict()
    for key in ("motion_encoder.conv_in.weight", "motion_encoder.conv_in.act_fn.bias",
                "motion_encoder.res_blocks.0.conv_skip.weight", "motion_encoder.motion_synthesis_weight",
                "motion_encoder.motion_network.3.bias", "face_encoder.padding_tokens",
                "face_encoder.conv1_local.weight",
                "face_adapter.1.norm_k.weight", "pose_patch_embedding.weight"):
        assert key in state, key
    assert state["motion_encoder.conv_in.weight"].shape == (8, 3, 1, 1)  # OIHW
    flat = flatten_to_torch_state_dict(jm, jax.device_get(params))
    assert flat.keys() == state.keys() and all(np.array_equal(flat[k], state[k].numpy()) for k in state)
    again = load_jax_params(WanAnimateTransformer3DModel(**TINY), jax.device_get(params))
    assert all(torch.equal(again.state_dict()[k], v) for k, v in state.items())
    model.save_pretrained(tmp_path / "t")
    loaded = WanAnimateTransformer3DModel.from_pretrained(tmp_path / "t", device="cpu")
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in state.items())
    with pytest.raises(ValueError, match="2 \\* latent_channels \\+ 4"):
        WanAnimateTransformer3DModel(**dict(TINY, in_channels=13))


# ---------------------------------------------------------------------------------------------- the pipeline


def clip_processor():
    return transformers.CLIPImageProcessor(size={"shortest_edge": 16}, crop_size={"height": 16, "width": 16},
                                           image_mean=list(OPENAI_CLIP_MEAN), image_std=list(OPENAI_CLIP_STD))


@pytest.fixture(scope="module")
def animate_pipes():
    jparts, tparts = _parts([("vae", JaxVAE, AutoencoderKLWan, VAE), ("text_encoder", JaxUMT5, UMT5EncoderModel, UMT5),
                             ("transformer", janimate.WanAnimateTransformer3DModel, WanAnimateTransformer3DModel, TINY),
                             ("image_encoder", JaxCLIPVision, CLIPVisionModel, CLIP)], seed=0)
    jpipe = jit_reference(JaxAnimatePipeline(tokenizer=MaskTokenizer(), scheduler=JaxUniPC(**UNIPC),
                                             image_processor=clip_processor(), **jparts))
    tpipe = WanAnimatePipeline(tokenizer=MaskTokenizer(), scheduler=UniPCMultistepScheduler(**UNIPC),
                               image_processor=clip_processor(), device="cpu", **tparts)
    return jpipe, tpipe


def _second_segment_draw():
    """JAX's draw for segment 2 (its key split once a segment from PRNGKey(0))."""
    key, _ = jax.random.split(jax.random.PRNGKey(0))
    _, lat_key = jax.random.split(key)
    return np.array(jax_randn(LATENTS.shape, key=lat_key, dtype=jnp.float32))


def _run(jpipe, tpipe, monkeypatch, mode, **kw):
    kwargs = dict(image=IMAGE, pose_video=POSE, face_video=FACE, prompt=PROMPT, height=H, width=W,
                  segment_frame_length=SEGMENT, num_inference_steps=STEPS, guidance_scale=5.0, mode=mode,
                  max_sequence_length=TXT_LEN, **kw)
    if mode == "replace":
        kwargs.update(background_video=BACKGROUND, mask_video=MASK_VIDEO)
    ref = np.asarray(jpipe(key=jax.random.PRNGKey(0), latents=jnp.asarray(LATENTS),
                           **{k: jnp.asarray(v) if k in ("pose_video", "face_video") else v
                              for k, v in kwargs.items()}).frames)
    draws = [_second_segment_draw()]
    monkeypatch.setattr(torch_utils, "randn_tensor", lambda shape, generator=None, device=None: torch.from_numpy(
        draws.pop(0)).to(device))
    out = tpipe(latents=torch.from_numpy(LATENTS), **kwargs).frames
    assert not draws and out.dtype == np.float32 and np.isfinite(out).all()
    return ref, out


@pytest.mark.parametrize("mode", ["animate", "replace"])
def test_pipeline_matches_jax(animate_pipes, monkeypatch, mode):
    """Two segments (7 pose frames padded to 9: frames [0, 5) and [4, 9)),
    to decoded frames: the reference latents behind the i2v mask, the
    previous segment's last frame, replace mode's background and inverted
    mask, CFG with the face blanked; each segment's face motion encoded once
    a branch (cond, uncond), two batch-1 calls a step."""
    jpipe, tpipe = animate_pipes
    calls, faces = [], []
    h1 = tpipe.transformer.register_forward_pre_hook(lambda mod, args: calls.append(args[0].shape[0]))
    h2 = tpipe.transformer.motion_encoder.register_forward_pre_hook(lambda mod, args: faces.append(args[0].shape[0]))
    try:
        ref, out = _run(jpipe, tpipe, monkeypatch, mode)
    finally:
        h1.remove()
        h2.remove()
    assert out.shape == ref.shape == (1, N_FRAMES, H, W, 3)
    assert calls == [1] * (2 * 2 * STEPS) and faces == [SEGMENT] * 4
    assert float(np.abs(out - ref).max()) <= ATOL, float(np.abs(out - ref).max())


def test_image_context_and_masks_match_jax(animate_pipes):
    """CLIP's penultimate hidden states through `clip_image_preprocess`
    (1e-5 of JAX through transformers' processor); `get_i2v_mask` with and
    without pixel values, `pad_video_frames` and the nearest mask resize
    exact."""
    jpipe, tpipe = animate_pipes
    np.testing.assert_allclose(tpipe.encode_image(IMAGE).numpy(), np.asarray(jpipe.encode_image(IMAGE)), atol=1e-5)
    pixels = (np.random.RandomState(13).rand(1, 1, 5, 8, 8) > 0.5).astype(np.float32)
    for args in ((1, 1, 8, 8, 1, None), (1, 2, 8, 8, 0, None), (1, 2, 8, 8, 1, pixels), (2, 3, 4, 4, 1, None)):
        np.testing.assert_array_equal(tpipe.get_i2v_mask(*args), np.asarray(jpipe.get_i2v_mask(*args)))
    for n, target in ((7, 9), (3, 10), (5, 5), (2, 7)):
        frames = list(range(n))
        assert tpipe.pad_video_frames(frames, target) == jpipe.pad_video_frames(frames, target)
    from diffusers_tpu_torch.pipelines.wan.pipeline_wan_vace import nearest_indices

    for n_in, n_out in ((32, 8), (720, 90), (1280, 160), (17, 5)):
        x = jnp.arange(n_in, dtype=jnp.float32)[None]
        np.testing.assert_array_equal(nearest_indices(n_in, n_out),
                                      np.asarray(jax.image.resize(x, (1, n_out), method="nearest")[0]).astype(np.int64))


def test_pipeline_errors_and_caches(animate_pipes, monkeypatch):
    jpipe, tpipe = animate_pipes
    with pytest.raises(ValueError, match="mode must be"):
        tpipe(image=IMAGE, pose_video=POSE, face_video=FACE, prompt=PROMPT, mode="swap")
    with pytest.raises(ValueError, match="replace mode requires"):
        tpipe(image=IMAGE, pose_video=POSE, face_video=FACE, prompt=PROMPT, mode="replace")
    from diffusers_tpu_torch.hooks import TaylorSeerCacheConfig

    with pytest.raises(TypeError, match="does not support cache config"):
        tpipe.enable_cache(TaylorSeerCacheConfig())
    with pytest.raises(TypeError, match="does not support cache config"):
        from diffusers_tpu.hooks import TaylorSeerCacheConfig as JaxTaylorSeer

        jpipe.enable_cache(JaxTaylorSeer())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WanAnimatePipeline(**tpipe.components)


def test_jax_fixture_vae_never_downsamples_in_time(animate_pipes):
    """(e) JAX's Animate on tests/test_wan_variants.py's VAE (`dim_mult=[1,
    2]`, `temperal_downsample=[False, True]`, claiming a temporal scale of
    2) fails joining the i2v mask's 3 latent frames to the encoder's 5; the
    port's chunked encode refuses the 5-frame segment a 4x-in-time VAE
    cannot take in 1 + 4 k chunks only when its length is wrong."""
    jpipe, tpipe = animate_pipes
    bad = dict(base_dim=16, z_dim=4, dim_mult=(1, 2), num_res_blocks=1, temperal_downsample=(False, True),
               latents_mean=[0.0] * 4, latents_std=[1.0] * 4, scale_factor_temporal=2, scale_factor_spatial=2)
    jm, params = _parts([("vae", JaxVAE, AutoencoderKLWan, bad)], seed=0)[0]["vae"]
    jbad = jit_reference(JaxAnimatePipeline(
        tokenizer=MaskTokenizer(), text_encoder=jpipe.text_encoder, transformer=jpipe.transformer, vae=(jm, params),
        scheduler=JaxUniPC(**UNIPC), image_encoder=jpipe.image_encoder, image_processor=clip_processor()), ("vae",))
    with pytest.raises(TypeError, match="concatenat"):
        jbad(image=IMAGE, pose_video=jnp.asarray(POSE[:, :, :, :16, :16]), face_video=jnp.asarray(FACE), prompt=PROMPT,
             height=16, width=16, segment_frame_length=5, num_inference_steps=1, max_sequence_length=TXT_LEN,
             key=jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="takes 1 \\+ 4 k frames"):
        tpipe.vae.encode(torch.zeros(1, 3, 6, H, W))


def test_from_pretrained_in_the_checkpoint_layout(animate_pipes, tmp_path, monkeypatch):
    """A directory laid out as Wan-AI/Wan2.2-Animate-14B-Diffusers (the
    CLIP tower saved by transformers, `image_processor/`), read back by
    `model_index.json`; the loaded pipeline's request bit-equal to the
    in-memory one's."""
    _, tpipe = animate_pipes
    root = tmp_path / "wan_animate"
    for name in ("text_encoder", "transformer", "vae"):
        getattr(tpipe, name).save_pretrained(root / name)
    tpipe.scheduler.save_config(root / "scheduler")
    tpipe.image_processor.save_pretrained(root / "image_processor")
    vision = transformers.CLIPVisionModel(transformers.CLIPVisionConfig(**CLIP)).eval()
    assert not vision.load_state_dict(tpipe.image_encoder.state_dict(), strict=True).missing_keys
    vision.save_pretrained(root / "image_encoder")
    index = {"_class_name": "WanAnimatePipeline", "_diffusers_version": "0.36.0.dev0",
             "image_encoder": ["transformers", "CLIPVisionModel"],
             "image_processor": ["transformers", "CLIPImageProcessor"],
             "scheduler": ["diffusers", "UniPCMultistepScheduler"],
             "text_encoder": ["transformers", "UMT5EncoderModel"],
             "tokenizer": ["transformers", "T5TokenizerFast"],
             "transformer": ["diffusers", "WanAnimateTransformer3DModel"], "vae": ["diffusers", "AutoencoderKLWan"]}
    (root / "model_index.json").write_text(json.dumps(index))
    loaded = WanAnimatePipeline.from_pretrained(root, tokenizer=MaskTokenizer(), device="cpu")
    assert isinstance(loaded.transformer, WanAnimateTransformer3DModel)
    for name in ("image_encoder", "text_encoder", "transformer", "vae"):
        mine, theirs = getattr(tpipe, name).state_dict(), getattr(loaded, name).state_dict()
        assert mine.keys() == theirs.keys() and all(torch.equal(mine[k], theirs[k]) for k in mine), name
    kwargs = dict(image=IMAGE, pose_video=POSE[:, :, :5], face_video=FACE[:, :, :5], prompt=PROMPT, height=H, width=W,
                  segment_frame_length=SEGMENT, num_inference_steps=1, max_sequence_length=TXT_LEN,
                  latents=torch.from_numpy(LATENTS), output_type="latent")
    torch.testing.assert_close(loaded(**kwargs).frames, tpipe(**kwargs).frames, rtol=0, atol=0)

"""The models of the port's Wan image- and video-conditioned slice against the
JAX package's on the CPU: the CLIP vision tower, the chunked causal VAE
encode, and the CLIP image preprocessing against transformers'
`CLIPImageProcessor`.

Tolerances (float32 on both sides):
  * the CLIP vision tower (`hidden_states[-2]`, the pooled output and the
    projected `image_embeds`) against JAX's `CLIPVisionModel(WithProjection)`
    with the same weights: 1e-5 (the same math in another order); against
    transformers' own model: 1e-5;
  * the chunked encode (frame 0, then one latent frame's worth of frames a
    chunk) against JAX's whole-sequence `encode`: 2e-5, the decode's bound
    (measured below 1e-6);
  * `clip_image_preprocess` against transformers' `CLIPImageProcessor`
    (PIL's 8-bit bicubic resize, centre crop, rescale, normalise): 1e-6
    (measured 4.8e-7: the float32 normalisation; the resize is PIL's to the
    last integer).
"""

import numpy as np
import pytest
import torch
import transformers

import jax.numpy as jnp
from diffusers_tpu.models.autoencoders.autoencoder_kl_wan import AutoencoderKLWan as JaxVAE
from diffusers_tpu.models.modeling_utils import convert_torch_state_dict, flatten_to_torch_state_dict
from diffusers_tpu.models.text_encoders.clip import CLIPVisionModel as JaxCLIPVisionModel
from diffusers_tpu.models.text_encoders.clip import CLIPVisionModelWithProjection as JaxCLIPVisionModelWithProjection
from diffusers_tpu_torch import AutoencoderKLWan, CLIPVisionModel, CLIPVisionModelWithProjection
from diffusers_tpu_torch.models.autoencoders.autoencoder_kl_wan import CausalCache
from diffusers_tpu_torch.models.modeling_utils import iter_safetensors, save_safetensors
from diffusers_tpu_torch.models.text_encoders.clip import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD, clip_image_preprocess
from test_torch_wan import VAE, seeded, to_jax
from test_torch_jit_reference import JitModule
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

CLIP = dict(hidden_size=32, intermediate_size=37, num_hidden_layers=3, num_attention_heads=4, image_size=28,
            patch_size=14, hidden_act="gelu", projection_dim=24)
# Wan's VAE layout cut to two downsampling levels: 4x in time (encode chunks of 4 frames), 4x in space
WAN_LIKE_VAE = dict(base_dim=8, z_dim=4, dim_mult=(1, 2, 2), num_res_blocks=1, temperal_downsample=(True, True),
                    latents_mean=[0.0] * 4, latents_std=[1.0] * 4)
VISION = {"plain": (CLIPVisionModel, JaxCLIPVisionModel, transformers.CLIPVisionModel),
          "projection": (CLIPVisionModelWithProjection, JaxCLIPVisionModelWithProjection,
                         transformers.CLIPVisionModelWithProjection)}


def _vision(name, seed=0):
    """The port's tower from `seed`, every weight jittered (no LayerNorm or
    position trivial)."""
    cls = VISION[name][0]
    torch.manual_seed(seed)
    model = cls(**CLIP).eval()
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy(0.05 * rng.randn(*p.shape).astype(np.float32)))
    return model


def _pixels(batch=2):
    return np.random.RandomState(3).randn(batch, 3, 28, 28).astype(np.float32)


@pytest.mark.parametrize("name", sorted(VISION))
def test_vision_tower_matches_jax(name):
    model = _vision(name)
    jcls = VISION[name][1]
    jm = jcls(**CLIP)
    params = convert_torch_state_dict(jm, {k: v.numpy() for k, v in model.state_dict().items()})
    x = _pixels()
    ref = JitModule(jm)(params, jnp.asarray(x), output_hidden_states=True)
    with torch.no_grad():
        out = model(torch.from_numpy(x), output_hidden_states=True)
    assert len(out.hidden_states) == len(ref.hidden_states) == CLIP["num_hidden_layers"] + 1
    assert out.hidden_states[-2].shape == (2, 5, 32)  # the class token and 2 x 2 patches
    np.testing.assert_allclose(out.hidden_states[-2].numpy(), np.asarray(ref.hidden_states[-2]), atol=1e-5)
    np.testing.assert_allclose(out.last_hidden_state.numpy(), np.asarray(ref.last_hidden_state), atol=1e-5)
    np.testing.assert_allclose(out.pooler_output.numpy(), np.asarray(ref.pooler_output), atol=1e-5)
    if name == "projection":
        np.testing.assert_allclose(out.image_embeds.numpy(), np.asarray(ref.image_embeds), atol=1e-5)
    else:
        assert out.image_embeds is None and ref.image_embeds is None


@pytest.mark.parametrize("name", sorted(VISION))
def test_vision_tower_matches_transformers(name):
    model = _vision(name, seed=1)
    tm = VISION[name][2](transformers.CLIPVisionConfig(**CLIP)).eval()
    result = tm.load_state_dict(model.state_dict(), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    x = torch.from_numpy(_pixels())
    with torch.no_grad():
        out, ref = model(x, output_hidden_states=True), tm(x, output_hidden_states=True)
    np.testing.assert_allclose(out.hidden_states[-2].numpy(), ref.hidden_states[-2].numpy(), atol=1e-5)
    pooled = out.image_embeds if name == "projection" else out.pooler_output
    np.testing.assert_allclose(pooled.numpy(), (ref.image_embeds if name == "projection" else ref.pooler_output)
                               .numpy(), atol=1e-5)


@pytest.mark.parametrize("name", sorted(VISION))
def test_vision_tower_round_trips_in_transformers_layout(name, tmp_path):
    """transformers' own save (with the legacy `position_ids` buffer added, as
    old checkpoints hold it) loads into the port; the port's save loads into
    transformers and into JAX's `from_pretrained` bit for bit."""
    model = _vision(name, seed=2)
    pcls, jcls, tcls = VISION[name]
    tm = tcls(transformers.CLIPVisionConfig(**CLIP)).eval()
    tm.load_state_dict(model.state_dict())
    tm.save_pretrained(tmp_path / "hf", safe_serialization=True)
    path = tmp_path / "hf" / "model.safetensors"
    state = {k: v.clone() for k, v in iter_safetensors(path)}
    state["vision_model.embeddings.position_ids"] = torch.arange(5)[None]
    path.unlink()  # the read maps the file: write a new one
    save_safetensors(state, path)
    loaded = pcls.from_pretrained(tmp_path / "hf", device="cpu")
    assert loaded.config.hidden_act == "gelu" and loaded.config.image_size == 28
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k

    model.save_pretrained(tmp_path / "port")
    keys = {k for k, _ in iter_safetensors(tmp_path / "port" / "model.safetensors")}
    assert keys == set(model.state_dict()) and "vision_model.pre_layrnorm.weight" in keys
    back = tcls.from_pretrained(tmp_path / "port").eval()
    assert all(torch.equal(back.state_dict()[k], v) for k, v in model.state_dict().items())
    jm, params = jcls.from_pretrained(str(tmp_path / "port"))
    jstate = flatten_to_torch_state_dict(jm, params)
    assert jstate.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(np.asarray(jstate[k]).reshape(v.shape), v.numpy(), err_msg=k)


@pytest.mark.parametrize("frames,size", [(9, 24), (13, 20)])
def test_chunked_encode_matches_jax_whole_sequence(frames, size):
    """frame 0, then 4 frames a chunk (two temporal downsamples), against JAX's
    whole-sequence encode; 20 px gives an odd 5 x 5 latent."""
    model = seeded(AutoencoderKLWan, WAN_LIKE_VAE, seed=3)
    assert model.encode_chunk == 4
    jm = JaxVAE(**WAN_LIKE_VAE)
    x = np.random.RandomState(frames).uniform(-1, 1, (1, 3, frames, size, size)).astype(np.float32)
    ref = JitModule(jm).encode(to_jax(jm, model), jnp.asarray(x))
    with torch.no_grad():
        out = model.encode(torch.from_numpy(x))
    assert out.mean.shape == (1, 4, 1 + (frames - 1) // 4, size // 4, size // 4)
    np.testing.assert_allclose(out.mean.numpy(), np.asarray(ref.mean), atol=2e-5)
    np.testing.assert_allclose(out.logvar.numpy(), np.asarray(ref.logvar), atol=2e-5)


def test_chunked_encode_carries_and_refuses_ragged_lengths():
    """One temporal downsample: chunks of 2 frames. After an encode every
    causal conv carries its last two input frames and each temporal
    downsample its last frame; the encode is the whole-sequence rule of the
    port's own modules; 1 + 2 k frames only."""
    model = seeded(AutoencoderKLWan, VAE, seed=4)
    assert model.encode_chunk == 2
    x = torch.from_numpy(np.random.RandomState(4).uniform(-1, 1, (1, 3, 7, 8, 8)).astype(np.float32))
    cache = CausalCache()
    with torch.no_grad():
        chunks = [model.encoder(x[:, :, i:j], cache) for i, j in ((0, 1), (1, 3), (3, 5), (5, 7))]
        whole = model.encoder(x)  # the port's modules on the whole sequence
    downsample, = [b.time_conv for b in model.encoder.down_blocks if getattr(b, "mode", None) == "downsample3d"]
    assert cache.frames[downsample].shape[2] == 1
    assert all(t.shape[2] == 2 for conv, t in cache.frames.items() if conv is not downsample)
    np.testing.assert_allclose(torch.cat(chunks, dim=2).numpy(), whole.numpy(), atol=2e-5)
    with pytest.raises(ValueError, match="takes 1 \\+ 2 k frames, got 6"):
        model.encode(x[:, :, :6])


@pytest.mark.parametrize("height,width", [(480, 832), (64, 96), (300, 200), (224, 224), (225, 301)])
def test_clip_preprocess_matches_transformers(height, width):
    """Landscape and portrait, down- and upscaled, and already 224: PIL's
    bicubic through transformers against the port's fixed-point emulation."""
    processor = transformers.CLIPImageProcessor(size={"shortest_edge": 224}, crop_size={"height": 224, "width": 224},
                                                image_mean=list(OPENAI_CLIP_MEAN), image_std=list(OPENAI_CLIP_STD))
    rng = np.random.RandomState(height + width)
    images = [(rng.rand(height, width, 3) * 255).astype(np.uint8) for _ in range(2)]
    ref = processor(images=images, return_tensors="np")["pixel_values"]
    out = clip_image_preprocess(images).numpy()
    assert out.shape == ref.shape == (2, 3, 224, 224) and out.dtype == np.float32
    assert float(np.abs(out - ref).max()) <= 1e-6, float(np.abs(out - ref).max())
    one = clip_image_preprocess(torch.from_numpy(images[0])).numpy()  # a tensor, one image
    np.testing.assert_array_equal(one, out[:1])

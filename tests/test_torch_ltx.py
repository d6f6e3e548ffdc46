"""The port's LTX-Video models against the JAX package on the CPU: the
transformer (per-token timesteps, the cross attention's -10000 mask bias,
RoPE from the token grid or from video coordinates, the first-block cache
and PAB forms), the causal VAE with both down-block kinds and the
timestep-conditioned decoder with its injected noise, the latent upsampler
in every mode, the per-token flow-match step, the LTX single file, and a
diffusers-named LTX LoRA fused against JAX's `fuse_lora`.

Tiny widths (the transformer 2 blocks of 2 heads x 14, so its RoPE pads 4
channels; VAEs of 8 to 32 channels; the upsampler 32 wide), f32 on both
sides; tolerance 5e-4 (the README's whole-model bound; measured below 1e-5),
the single file and the scheduler's f32 step bit-equal. The decoder's noise:
the port's `randn_tensor` returns JAX's draws, made by walking JAX's key
splits in the order the decoder runs its noised convs (ROADMAP C3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.hooks.first_block_cache import FirstBlockCacheConfig as JaxFBCConfig
from diffusers_tpu.hooks.first_block_cache import init_fbc_single_state as jax_init_fbc
from diffusers_tpu.loaders import lora as jlora
from diffusers_tpu.loaders import single_file as jsingle
from diffusers_tpu.models.autoencoders.autoencoder_kl_ltx import AutoencoderKLLTXVideo as JaxLTXVAE
from diffusers_tpu.models.modeling_utils import flatten_to_torch_state_dict
from diffusers_tpu.models.transformers.transformer_ltx import LTXVideoTransformer3DModel as JaxLTX
from diffusers_tpu.pipelines.ltx.modeling_latent_upsampler import LTXLatentUpsamplerModel as JaxUpsampler
from diffusers_tpu.schedulers import FlowMatchEulerDiscreteScheduler as JaxFlowMatch
import diffusers_tpu_torch.hooks as hooks
from diffusers_tpu_torch import AutoencoderKLLTXVideo, FlowMatchEulerDiscreteScheduler, LTXVideoTransformer3DModel
from diffusers_tpu_torch.hooks.first_block_cache import init_fbc_single_state
from diffusers_tpu_torch.loaders import lora
from diffusers_tpu_torch.loaders.single_file import load_ltx_transformer_single_file
from diffusers_tpu_torch.models.modeling_utils import save_safetensors
from diffusers_tpu_torch.ops.cuda.group_norm import group_norm
from diffusers_tpu_torch.pipelines.ltx import LTXLatentUpsamplerModel
from diffusers_tpu_torch.utils import torch_utils
from test_torch_lora import _assert_weights, _pair
from test_torch_qwenimage import carry, seeded

torch.set_num_threads(1)

ATOL = 5e-4
LTX = dict(in_channels=8, out_channels=8, num_attention_heads=2, attention_head_dim=14, cross_attention_dim=28,
           num_layers=2, caption_channels=16)
VAE = dict(latent_channels=8, block_out_channels=(8, 8, 8, 8), decoder_block_out_channels=(8, 8, 8, 8),
           layers_per_block=(1, 1, 1, 1, 1), decoder_layers_per_block=(1, 1, 1, 1, 1),
           spatio_temporal_scaling=(True, True, False, False), decoder_spatio_temporal_scaling=(True, True, False, False),
           patch_size=1)
VAE_095 = dict(VAE, block_out_channels=(8, 16, 16, 32), down_block_types=("LTXVideo095DownBlock3D",) * 4,
               downsample_type=("spatial", "temporal", "spatiotemporal", "conv"),
               spatio_temporal_scaling=(True, True, True, False), patch_size=2)
VAE_TC = dict(VAE, timestep_conditioning=True, decoder_inject_noise=(True,) * 5,
              upsample_residual=(True, True, False, False), decoder_block_out_channels=(8, 16, 16, 16),
              upsample_factor=(2, 2, 1, 1), decoder_spatio_temporal_scaling=(True, True, True, False))
TOKENS = (2, 3, 4)  # latent frames, height, width


def _sample(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _transformer_inputs(seed=0, per_token=True):
    f, h, w = TOKENS
    s = f * h * w
    x = _sample(seed, 2, s, 8)
    enc = _sample(seed + 1, 2, 5, 16)
    mask = np.ones((2, 5), np.float32)
    mask[1, 3:] = 0
    if per_token:
        t = np.tile(np.array([[900.0], [250.0]], np.float32), (1, s))
        t[:, : h * w] = 0.0  # a conditioned first frame
    else:
        t = np.array([900.0, 250.0], np.float32)
    return x, enc, mask, t


GRID_KW = dict(num_frames=TOKENS[0], height=TOKENS[1], width=TOKENS[2], rope_interpolation_scale=(8 / 25, 32, 32))


@pytest.mark.parametrize("per_token", [True, False])
def test_transformer_matches_jax(per_token):
    tm = seeded(LTXVideoTransformer3DModel, LTX, seed=1)
    jm, params = carry(JaxLTX, tm, LTX)
    x, enc, mask, t = _transformer_inputs(per_token=per_token)
    fn = jax.jit(lambda p, x, e, t, m: jm(p, x, e, t, encoder_attention_mask=m, **GRID_KW).sample)
    ref = np.asarray(fn(params, *map(jnp.asarray, (x, enc, t, mask))))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(enc), torch.from_numpy(t),
                 encoder_attention_mask=torch.from_numpy(mask), **GRID_KW).sample
    assert out.shape == (2, 24, 8)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_transformer_video_coords_and_masked_text():
    """RoPE from video coordinates (the condition pipeline's form); the masked
    text token changes nothing beyond what -10000 leaves."""
    tm = seeded(LTXVideoTransformer3DModel, LTX, seed=2)
    jm, params = carry(JaxLTX, tm, LTX)
    x, enc, mask, t = _transformer_inputs(seed=3)
    f, h, w = TOKENS
    grid = np.stack(np.meshgrid(np.arange(f), np.arange(h), np.arange(w), indexing="ij")).reshape(3, -1)
    coords = np.broadcast_to((grid * np.array([[8 / 25], [32], [32]]))[None], (2, 3, f * h * w)).astype(np.float32)
    fn = jax.jit(lambda p, x, e, t, m, c: jm(p, x, e, t, encoder_attention_mask=m, video_coords=c).sample)
    ref = np.asarray(fn(params, *map(jnp.asarray, (x, enc, t, mask, coords))))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(enc), torch.from_numpy(t),
                 encoder_attention_mask=torch.from_numpy(mask), video_coords=torch.from_numpy(coords)).sample
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_transformer_cache_forms_match_jax():
    """The first-block cache (a compute step, then a replay) and PAB (a
    compute step, then a broadcast) against JAX's forward under each."""
    tm = seeded(LTXVideoTransformer3DModel, LTX, seed=4)
    jm, params = carry(JaxLTX, tm, LTX)
    x, enc, mask, t = _transformer_inputs(seed=5, per_token=False)
    args = tuple(map(jnp.asarray, (x, enc, t)))
    targs = tuple(map(torch.from_numpy, (x, enc, t)))
    kw = dict(GRID_KW, encoder_attention_mask=jnp.asarray(mask))
    tkw = dict(GRID_KW, encoder_attention_mask=torch.from_numpy(mask))

    jstate, state = jax_init_fbc((2, 24, 28)), init_fbc_single_state((2, 24, 28))
    jcfg, cfg = JaxFBCConfig(threshold=10.0), hooks.FirstBlockCacheConfig(threshold=10.0)
    fbc = jax.jit(lambda p, st, *a: jm(p, *a, fbc_state=st, fbc_config=jcfg, **kw))
    for step in range(2):  # step 0 computes; step 1 replays the tail under the huge threshold
        xs = (args[0] * (1 + 0.01 * step),) + args[1:]
        ref, jstate = fbc(params, jstate, *xs)
        with torch.no_grad():
            out, state = tm(targs[0] * (1 + 0.01 * step), *targs[1:], fbc_state=state, fbc_config=cfg, **tkw)
        np.testing.assert_allclose(out.sample.numpy(), np.asarray(ref.sample), atol=ATOL, rtol=0)
    assert state.decisions == [True, False]

    jcache, cache = jm.init_pab_cache(2, 24), tm.init_pab_cache(2, 24)
    for compute in (True, False):
        pab = jax.jit(lambda p, c, *a: jm(p, *a, pab_compute=compute, pab_cache=c, **kw))
        ref, jcache = pab(params, jcache, *args)
        with torch.no_grad():
            out, cache = tm(*targs, pab_compute=compute, pab_cache=cache, **tkw)
        np.testing.assert_allclose(out.sample.numpy(), np.asarray(ref.sample), atol=ATOL, rtol=0)


def _vae_pair(cfg, seed):
    tm = seeded(AutoencoderKLLTXVideo, cfg, seed)
    with torch.no_grad():  # non-zero noise scales and latent statistics
        for name, p in tm.named_parameters():
            if "per_channel_scale" in name:
                p.copy_(torch.from_numpy(0.5 * _sample(seed, *p.shape)))
        tm.latents_mean.copy_(torch.from_numpy(0.1 * _sample(seed + 1, 8)))
        tm.latents_std.copy_(torch.from_numpy(1.0 + 0.2 * np.abs(_sample(seed + 2, 8))))
    return (tm, *carry(JaxLTXVAE, tm, cfg))


@pytest.mark.parametrize("cfg,frames,size", [(VAE, 5, 16), (VAE_095, 9, 32)], ids=["ltx_090", "ltx_095"])
def test_vae_encode_decode_matches_jax(cfg, frames, size):
    """Both down-block kinds (the 0.9.5 kind through its spatial, temporal
    and spatiotemporal `LTXDownsampler3d`s at patch 2), the moments and the
    decode at 5e-4."""
    tm, jm, params = _vae_pair(cfg, seed=6)
    video = np.random.RandomState(7).uniform(-1, 1, (1, 3, frames, size, size)).astype(np.float32)
    ref_m = np.asarray(jax.jit(lambda p, x: jm.encode(p, x).latent_dist.parameters)(params, jnp.asarray(video)))
    with torch.no_grad():
        moments = tm.encode(torch.from_numpy(video)).latent_dist.parameters
    np.testing.assert_allclose(moments.numpy(), ref_m, atol=ATOL, rtol=0)
    z = np.array(ref_m[:, :8])
    ref_x = np.asarray(jax.jit(lambda p, z: jm.decode(p, z).sample)(params, jnp.asarray(z)))
    with torch.no_grad():
        x = tm.decode(torch.from_numpy(z)).sample
    assert x.shape == ref_x.shape
    np.testing.assert_allclose(x.numpy(), ref_x, atol=ATOL, rtol=0)


def jax_decoder_noise(cfg, key, latent_hw):
    """JAX's injected-noise draws of a decode, in the order the decoder runs
    its noised convs: mid-block resnets (each from a split of the decode's
    key), then each up block (a split of it): its `conv_in` (the block's key
    itself) and resnets (splits of the block's key); two [H, W] draws a
    resnet, each from a split of the resnet's key."""
    draws = []

    def resnet(k, hw):
        for _ in range(2):
            k, sub = jax.random.split(k)
            draws.append(np.array(jax.random.normal(sub, hw, jnp.float32)))

    channels = tuple(reversed(cfg["decoder_block_out_channels"]))
    spatio = tuple(reversed(cfg["decoder_spatio_temporal_scaling"]))
    layers = tuple(reversed(cfg["decoder_layers_per_block"]))
    factors = tuple(reversed(cfg["upsample_factor"]))
    hw = latent_hw
    k = key
    for _ in range(layers[0]):
        k, sub = jax.random.split(k)
        resnet(sub, hw)
    out = channels[0]
    k = key
    for i in range(len(channels)):
        k, block_key = jax.random.split(k)
        in_c, out = out // factors[i], channels[i] // factors[i]
        if in_c != out:
            resnet(block_key, hw)
        if spatio[i]:
            hw = (hw[0] * 2, hw[1] * 2)
        bk = block_key
        for _ in range(layers[i + 1]):
            bk, sub = jax.random.split(bk)
            resnet(sub, hw)
    return draws


def test_timestep_conditioned_decode_with_noise_matches_jax(monkeypatch):
    """The timestep-conditioned decoder (embedders, 4-way resnet tables, the
    output modulation, ``timestep_scale_multiplier``) with injected noise in
    every resnet, residual upsamplers of factor 2, against JAX given its own
    draws; and with no noise scale the decode is the noise-free one."""
    tm, jm, params = _vae_pair(VAE_TC, seed=8)
    z = _sample(9, 1, 8, 2, 4, 4)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jax.jit(lambda p, z, t, k: jm.decode(p, z, t, key=k).sample)(
        params, jnp.asarray(z), jnp.asarray([0.05], jnp.float32), key))
    queue = jax_decoder_noise(VAE_TC, key, (4, 4))

    def randn_tensor(shape, generator=None, device=None):
        out = queue.pop(0)
        assert tuple(shape) == out.shape
        return torch.from_numpy(out)

    monkeypatch.setattr(torch_utils, "randn_tensor", randn_tensor)
    with torch.no_grad():
        out = tm.decode(torch.from_numpy(z), torch.tensor([0.05])).sample
    assert not queue and out.shape == ref.shape == (1, 3, 9, 32, 32)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["spatial3d", "temporal3d", "both3d", "spatial2d"])
def test_latent_upsampler_matches_jax(mode):
    """Each mode against JAX; K4's plain version runs every GroupNorm (17 a
    call at 4 blocks a stage; 5 at the 1 here), none launched on the CPU."""
    cfg = dict(in_channels=8, mid_channels=32, num_blocks_per_stage=1, dims=2 if mode.endswith("2d") else 3,
               spatial_upsample=mode != "temporal3d", temporal_upsample=mode in ("temporal3d", "both3d"))
    tm = seeded(LTXLatentUpsamplerModel, cfg, seed=10)
    jm, params = carry(JaxUpsampler, tm, cfg)
    x = _sample(11, 1, 8, 3, 4, 4)
    ref = np.asarray(jax.jit(lambda p, x: jm(p, x))(params, jnp.asarray(x)))
    group_norm.launches = 0
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert group_norm.launches == 0
    expected = {"spatial3d": (1, 8, 3, 8, 8), "temporal3d": (1, 8, 5, 4, 4), "both3d": (1, 8, 5, 8, 8),
                "spatial2d": (1, 8, 3, 8, 8)}[mode]
    assert out.shape == ref.shape == expected
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_per_token_scheduler_step_matches_jax():
    """Per-token timesteps on and between the schedule's values, 0 and the
    top, against JAX's step bit for bit; the scalar step as before."""
    sched, jsched = FlowMatchEulerDiscreteScheduler(), JaxFlowMatch()
    timesteps = [1000.0, 800.0, 500.0, 250.0]
    state, jstate = sched.set_timesteps(timesteps=timesteps), jsched.set_timesteps(timesteps=timesteps)
    sample, model_output = _sample(12, 2, 6, 3), _sample(13, 2, 6, 3)
    per_token = np.array([[1000.0, 800.0, 600.0, 250.0, 0.0, 100.0], [500.0] * 3 + [799.9] * 3], np.float32)
    ref = np.asarray(jsched.step(jstate, jnp.asarray(model_output), 800.0, jnp.asarray(sample),
                                 per_token_timesteps=jnp.asarray(per_token)).prev_sample)
    out = sched.step(state, torch.from_numpy(model_output), state.timesteps[1], torch.from_numpy(sample),
                     per_token_timesteps=torch.from_numpy(per_token)).prev_sample
    np.testing.assert_array_equal(out.numpy(), ref)
    ref2 = np.asarray(jsched.step(jstate, jnp.asarray(model_output), jstate.timesteps[1],
                                  jnp.asarray(sample)).prev_sample)
    out2 = sched.step(state, torch.from_numpy(model_output), state.timesteps[1], torch.from_numpy(sample)).prev_sample
    np.testing.assert_array_equal(out2.numpy(), ref2)


_ORIGINAL = [("proj_in", "patchify_proj"), ("time_embed", "adaln_single"), ("norm_q", "q_norm"), ("norm_k", "k_norm")]


def test_ltx_single_file(tmp_path):
    """A seeded model written in Lightricks' layout (``model.diffusion_model.``,
    ``patchify_proj``, ``adaln_single``, ``q_norm``; a VAE key to skip) loads
    bit-equal, with its config inferred as JAX's."""
    tm = seeded(LTXVideoTransformer3DModel, LTX, seed=14)
    original = {}
    for k, v in tm.state_dict().items():
        for new, old in _ORIGINAL:
            k = k.replace(new, old)
        original["model.diffusion_model." + k] = v
    original["vae.decoder.conv_in.conv.weight"] = torch.zeros(2, 2)
    path = tmp_path / "ltx.safetensors"
    save_safetensors(original, path)
    loaded = load_ltx_transformer_single_file(str(path), config_overrides={"attention_head_dim": 14}, device="cpu")
    assert {k: loaded.config[k] for k in LTX} == LTX
    for k, v in tm.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    jm, params = jsingle.load_ltx_transformer_single_file(
        {k: v.numpy() for k, v in original.items()}, config_overrides={"attention_head_dim": 14})
    ref = flatten_to_torch_state_dict(jm, params)
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(np.asarray(ref[k]), v.numpy(), err_msg=k)


def test_ltx_lora_fused_matches_jax():
    """A diffusers-named LoRA on the self and cross attention, the
    feed-forward, the caption projection and the timestep's linear, fused
    against JAX's `fuse_lora`, then a forward."""
    tm = seeded(LTXVideoTransformer3DModel, LTX, seed=15)
    jm, params = carry(JaxLTX, tm, LTX)
    rng = np.random.RandomState(16)
    sd = {
        **_pair(rng, "transformer.transformer_blocks.0.attn1.to_q", 28, 28, "lora_A", "lora_B"),
        **_pair(rng, "transformer.transformer_blocks.1.attn2.to_k", 28, 28, "lora_A", "lora_B", alpha=2.0),
        **_pair(rng, "transformer.transformer_blocks.1.ff.net.0.proj", 28, 112, "lora_A", "lora_B"),
        **_pair(rng, "transformer.caption_projection.linear_1", 16, 28, "lora_A", "lora_B"),
        **_pair(rng, "transformer.time_embed.linear", 28, 168, "lora_A", "lora_B"),
    }
    fused = jlora.fuse_lora(params, jlora.group_lora_weights(dict(sd), component="transformer"), scale=0.6)
    lora.fuse_lora(tm, lora.group_lora_weights(dict(sd), component="transformer"), scale=0.6)
    _assert_weights(jm, fused, tm)
    x, enc, mask, t = _transformer_inputs(seed=17)
    fn = jax.jit(lambda p, x, e, t, m: jm(p, x, e, t, encoder_attention_mask=m, **GRID_KW).sample)
    ref = np.asarray(fn(fused, *map(jnp.asarray, (x, enc, t, mask))))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(enc), torch.from_numpy(t),
                 encoder_attention_mask=torch.from_numpy(mask), **GRID_KW).sample
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)

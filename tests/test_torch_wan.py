"""The port's Wan 2.1 modules against the JAX package on the CPU.

Tiny configs: a transformer of 2 layers, 2 heads x 12 (RoPE splits 12 into
4 + 4 + 4), with and without the image-context branch; a VAE of base_dim 8
with both temporal and spatial resampling and the mid-block attention; a
UMT5 of 2 layers. The port's seeded weights (1-D ones jittered) are carried
into JAX with `convert_torch_state_dict` and both sides get the same numpy
inputs, float32. Tolerances: `5e-4` for the whole transformer (README
"Numerical parity"), `1e-5` for UMT5 (as tests/test_torch_t5.py), `2e-5`
for the VAE (convolutions of outputs of order 1; the differences are
summation order), `1e-6` (relative to the sample's magnitude) for each UniPC
step, bit-equal for the RoPE tables and the state-dict round trips.

The VAE decode: the port decodes in causal temporal chunks (one latent frame
a chunk, the last two input frames of every causal conv carried, as upstream
diffusers decodes); JAX decodes the whole sequence in one graph. They are
held together here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.models.autoencoders.autoencoder_kl_wan import AutoencoderKLWan as JaxVAE
from diffusers_tpu.models.modeling_utils import convert_torch_state_dict, flatten_to_torch_state_dict
from diffusers_tpu.models.text_encoders.t5 import UMT5EncoderModel as JaxUMT5
from diffusers_tpu.models.transformers.transformer_wan import WanRotaryPosEmbed as JaxRope
from diffusers_tpu.models.transformers.transformer_wan import WanTransformer3DModel as JaxWan
from diffusers_tpu.ops.module import Conv3d as JaxConv3d
from diffusers_tpu.schedulers import UniPCMultistepScheduler as JaxUniPC
from diffusers_tpu_torch import (
    AutoencoderKLWan,
    UMT5EncoderModel,
    UniPCMultistepScheduler,
    WanTransformer3DModel,
)
from diffusers_tpu_torch.models.autoencoders.autoencoder_kl_wan import CausalCache
from diffusers_tpu_torch.models.modeling_utils import load_jax_params
from diffusers_tpu_torch.models.transformers.transformer_wan import WanRotaryPosEmbed
from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention_full
from diffusers_tpu_torch.ops.module import Conv3d
from test_torch_jit_reference import JitModule
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

WAN = dict(patch_size=(1, 2, 2), num_attention_heads=2, attention_head_dim=12, in_channels=4, out_channels=4,
           text_dim=16, freq_dim=16, ffn_dim=32, num_layers=2, cross_attn_norm=True, rope_max_seq_len=64)
WAN_I2V = dict(WAN, image_dim=8, added_kv_proj_dim=24)
VAE = dict(base_dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1, temperal_downsample=(True,),
           latents_mean=[0.0] * 4, latents_std=[1.0] * 4, scale_factor_temporal=2, scale_factor_spatial=2)
UMT5 = dict(vocab_size=1000, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4, feed_forward_proj="gated-gelu")


def seeded(cls, cfg, seed=0):
    """A port model from `seed`, its 1-D parameters jittered."""
    torch.manual_seed(seed)
    model = cls(**cfg).eval()
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim == 1:
                p.add_(torch.from_numpy(0.1 * rng.randn(*p.shape).astype(np.float32)))
    return model


def to_jax(jax_model, model):
    return convert_torch_state_dict(jax_model, {k: v.numpy() for k, v in model.state_dict().items()})


@pytest.mark.parametrize("kernel,stride,padding",
                         [((3, 3, 3), 1, 1), ((1, 2, 2), (1, 2, 2), 0), ((3, 1, 1), (2, 1, 1), 0)])
def test_conv3d_matches_jax(kernel, stride, padding):
    torch.manual_seed(0)
    conv = Conv3d(3, 5, kernel_size=kernel, stride=stride, padding=padding)
    jconv = JaxConv3d(3, 5, kernel_size=kernel, stride=stride, padding=padding)
    params = to_jax(jconv, conv)
    x = np.random.RandomState(0).randn(2, 3, 5, 6, 6).astype(np.float32)
    ref = np.asarray(jconv(params, jnp.asarray(x.transpose(0, 2, 3, 4, 1)))).transpose(0, 4, 1, 2, 3)
    with torch.no_grad():
        out = conv(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "padding-mask"])
def test_umt5_matches_jax(masked):
    model = seeded(UMT5EncoderModel, UMT5)
    keys = model.state_dict().keys()
    assert all(f"encoder.block.{i}.layer.0.SelfAttention.relative_attention_bias.weight" in keys for i in range(2))
    jm = JaxUMT5(**UMT5)
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 1000, (2, 40))
    mask = np.ones((2, 40), np.int64)
    mask[1, 25:] = 0
    ref = jax.jit(lambda p, i, m: jm(p, i, attention_mask=m).last_hidden_state)(
        to_jax(jm, model), jnp.asarray(ids), jnp.asarray(mask) if masked else None)
    with torch.no_grad():
        out = model(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask) if masked else None)
    np.testing.assert_allclose(out.last_hidden_state.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("solver_type", ["bh1", "bh2"])
@pytest.mark.parametrize("kind", ["epsilon", "flow"])
def test_unipc_steps_match_jax(solver_type, kind):
    cfg = dict(solver_type=solver_type)
    cfg.update(dict(prediction_type="flow_prediction", use_flow_sigmas=True, flow_shift=3.0) if kind == "flow"
               else dict(prediction_type="epsilon"))
    jsched, sched = JaxUniPC(**cfg), UniPCMultistepScheduler(**cfg)
    shape, n = (1, 4, 3, 4, 4), 7
    jstate, state = jsched.set_timesteps(n, sample_shape=shape), sched.set_timesteps(n)
    np.testing.assert_array_equal(state.timesteps.numpy(), np.asarray(jstate.timesteps))
    np.testing.assert_array_equal(state.sigmas.numpy(), np.asarray(jstate.sigmas))
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for i in range(n):  # orders 1, 2, ..., 2, then 1 at the last step (lower_order_final)
        model_output = rng.randn(*shape).astype(np.float32)
        out = jsched.step(jstate, jnp.asarray(model_output), jstate.timesteps[i], jx)
        jx, jstate = out.prev_sample, out.state
        tx = sched.step(state, torch.from_numpy(model_output), state.timesteps[i], tx).prev_sample
        ref = np.asarray(jx)
        assert np.abs(tx.numpy() - ref).max() <= 1e-6 * (1 + np.abs(ref).max()), (i, np.abs(tx.numpy() - ref).max())
    noise = rng.randn(*shape).astype(np.float32)
    t = state.timesteps[3]
    ref = jsched.add_noise(jstate, jnp.asarray(x), jnp.asarray(noise), jnp.asarray([float(t)]))
    out = sched.add_noise(state, torch.from_numpy(x), torch.from_numpy(noise), t[None])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("head_dim,grid", [(12, (3, 4, 6)), (128, (21, 30, 52))])
def test_rope_tables_bit_equal(head_dim, grid):
    """The frame / row / column split (d - 4(d // 6), 2(d // 6), 2(d // 6)), up
    to Wan2.1-T2V-1.3B's full grid of 21 x 30 x 52 patches."""
    jcos, jsin = JaxRope(head_dim, (1, 2, 2), 1024)(grid[0], 2 * grid[1], 2 * grid[2])
    cos, sin = WanRotaryPosEmbed(head_dim, (1, 2, 2), 1024)(grid[0], 2 * grid[1], 2 * grid[2])
    assert cos.shape == (1, int(np.prod(grid)), 1, head_dim)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))


def _wan_inputs(rng, cfg, text_len=8, image_len=0):
    x = rng.randn(2, cfg["in_channels"], 3, 8, 12).astype(np.float32)
    ehs = rng.randn(2, text_len, cfg["text_dim"]).astype(np.float32)
    image = rng.randn(2, image_len, cfg["image_dim"]).astype(np.float32) if image_len else None
    return x, np.array([999.0, 312.5], np.float32), ehs, image


@pytest.mark.parametrize("image_context", [False, True], ids=["t2v", "image-context"])
def test_transformer_matches_jax(image_context):
    cfg = WAN_I2V if image_context else WAN
    model = seeded(WanTransformer3DModel, cfg, seed=int(image_context))
    jm = JaxWan(**cfg)
    x, t, ehs, image = _wan_inputs(np.random.RandomState(2), cfg, text_len=512 if image_context else 8,
                                   image_len=6 if image_context else 0)
    jimage = None if image is None else jnp.asarray(image)
    ref = np.asarray(jax.jit(lambda p, x, t, e, i: jm(p, x, t, e, encoder_hidden_states_image=i).sample)(
        to_jax(jm, model), jnp.asarray(x), jnp.asarray(t), jnp.asarray(ehs), jimage))
    flash_attention_full.launches = 0
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ehs),
                    encoder_hidden_states_image=None if image is None else torch.from_numpy(image)).sample.numpy()
    assert flash_attention_full.launches == 0  # CPU tensors take the plain version
    assert out.shape == x.shape and np.isfinite(out).all()
    assert np.abs(out - ref).max() < 5e-4, np.abs(out - ref).max()


@pytest.mark.parametrize("compute", [True, False], ids=["pab-compute", "pab-broadcast"])
def test_transformer_pab_matches_jax(compute):
    """The PAB path: a computing step returns the self-attention outputs it
    made; a broadcast step runs no self attention and uses the cache given."""
    model = seeded(WanTransformer3DModel, WAN)
    jm = JaxWan(**WAN)
    x, t, ehs, _ = _wan_inputs(np.random.RandomState(3), WAN)
    tokens = 3 * 4 * 6
    cache = {i: np.random.RandomState(10 + i).randn(2, tokens, 24).astype(np.float32) for i in range(2)}
    jout, jcache = jm(to_jax(jm, model), jnp.asarray(x), jnp.asarray(t), jnp.asarray(ehs), pab_compute=compute,
                      pab_cache={i: jnp.asarray(c) for i, c in cache.items()})
    flash_attention_full.launches = 0
    with torch.no_grad():
        out, tcache = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ehs), pab_compute=compute,
                            pab_cache={i: torch.from_numpy(c) for i, c in cache.items()})
    assert np.abs(out.sample.numpy() - np.asarray(jout.sample)).max() < 5e-4
    for i in range(2):
        assert np.abs(tcache[i].numpy() - np.asarray(jcache[i])).max() < 5e-4
        if not compute:
            assert np.array_equal(tcache[i].numpy(), cache[i])


def _video(rng, frames=5, size=8):
    return rng.uniform(-1, 1, (1, 3, frames, size, size)).astype(np.float32)


def test_vae_encode_matches_jax():
    model = seeded(AutoencoderKLWan, VAE)
    jm = JaxVAE(**VAE)
    x = _video(np.random.RandomState(4))
    ref = JitModule(jm).encode(to_jax(jm, model), jnp.asarray(x))
    with torch.no_grad():
        out = model.encode(torch.from_numpy(x))
    assert out.mean.shape == (1, 4, 3, 4, 4)  # 1 + (5 - 1) / 2 frames, 8 / 2 pixels
    np.testing.assert_allclose(out.mean.numpy(), np.asarray(ref.mean), atol=2e-5)
    np.testing.assert_allclose(out.logvar.numpy(), np.asarray(ref.logvar), atol=2e-5)


@pytest.mark.parametrize("cfg", [VAE, dict(VAE, dim_mult=(1, 2, 2), temperal_downsample=(True, True))],
                         ids=["one-temporal-upsample", "two-temporal-upsamples"])
def test_vae_chunked_decode_matches_jax_whole_sequence(cfg):
    """The port's chunked decode (1 + 2 (T' - 1) or 1 + 4 (T' - 1) frames, one
    latent frame a chunk) against JAX's whole-sequence decode."""
    model = seeded(AutoencoderKLWan, cfg, seed=5)
    jm = JaxVAE(**cfg)
    z = np.random.RandomState(5).randn(1, 4, 4, 4, 4).astype(np.float32)
    ref = np.asarray(JitModule(jm).decode(to_jax(jm, model), jnp.asarray(z)).sample)
    with torch.no_grad():
        out = model.decode(torch.from_numpy(z)).sample.numpy()
        whole = model.post_quant_conv(torch.from_numpy(z))
        whole = model.decoder(whole).clamp(-1, 1).numpy()  # the port's modules on the whole sequence
    ups = sum(1 for b in model.decoder.up_blocks if b.upsamplers is not None and b.upsamplers[0].mode == "upsample3d")
    assert out.shape == ref.shape == (1, 3, 1 + 2**ups * 3, 4 * 2**ups, 4 * 2**ups)
    np.testing.assert_allclose(out, ref, atol=2e-5)
    np.testing.assert_allclose(whole, ref, atol=2e-5)


def test_causal_cache_carries_two_frames():
    """Every causal conv with a temporal kernel of 3 carries exactly its last
    two input frames after a chunk; the temporal upsamples are marked started."""
    model = seeded(AutoencoderKLWan, VAE)
    cache = CausalCache()
    with torch.no_grad():
        z = model.post_quant_conv(torch.from_numpy(np.random.RandomState(6).randn(1, 4, 3, 4, 4).astype(np.float32)))
        for i in range(3):
            model.decoder(z[:, :, i:i + 1], cache)
    assert cache.frames and all(t.shape[2] == 2 for t in cache.frames.values())
    assert len(cache.started) == 1


@pytest.mark.parametrize("name", ["transformer", "transformer-image-context", "vae", "umt5"])
def test_state_dict_round_trips_through_jax(name, tmp_path):
    """port state_dict -> convert_torch_state_dict (JAX) -> flatten_to_torch_state_dict
    -> the port, bit-equal; and the JAX tree through `load_jax_params`; and
    `save_pretrained` -> `from_pretrained` on the CPU."""
    cls, jcls, cfg = {"transformer": (WanTransformer3DModel, JaxWan, WAN),
                      "transformer-image-context": (WanTransformer3DModel, JaxWan, WAN_I2V),
                      "vae": (AutoencoderKLWan, JaxVAE, VAE), "umt5": (UMT5EncoderModel, JaxUMT5, UMT5)}[name]
    model = seeded(cls, cfg)
    state = model.state_dict()
    if cls is AutoencoderKLWan:
        assert state["decoder.up_blocks.0.resnets.0.norm1.gamma"].shape == (16, 1, 1, 1)
        assert state["decoder.mid_block.attentions.0.norm.gamma"].shape == (16, 1, 1)
        assert "decoder.up_blocks.0.upsamplers.0.resample.1.weight" in state
        assert "decoder.up_blocks.0.upsamplers.0.time_conv.weight" in state
        assert state["encoder.conv_in.weight"].shape == (8, 3, 3, 3, 3)  # OIDHW
    if cls is WanTransformer3DModel:
        assert state["scale_shift_table"].shape == (1, 2, 24)
        assert state["blocks.0.scale_shift_table"].shape == (1, 6, 24)
    params = to_jax(jcls(**cfg), model)
    back = flatten_to_torch_state_dict(jcls(**cfg), params)
    assert back.keys() == state.keys()
    again = cls(**cfg)
    again.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in back.items()})
    tree = jax.tree_util.tree_map(np.asarray, params)
    third = load_jax_params(cls(**cfg), tree)
    model.save_pretrained(str(tmp_path))
    loaded = cls.from_pretrained(str(tmp_path), device="cpu")
    for k, v in state.items():
        for other in (again, third, loaded):
            assert torch.equal(other.state_dict()[k], v), k


def test_jax_saved_vae_loads_with_from_pretrained(tmp_path):
    """The JAX package writes `WanRMSNorm.gamma` flat [C]; the port's
    `from_pretrained` takes it into upstream's [C, 1, 1, 1] / [C, 1, 1],
    values bit-equal."""
    jm = JaxVAE(**VAE)
    params = jax.tree_util.tree_map(lambda a: a + 0.25, to_jax(jm, seeded(AutoencoderKLWan, VAE)))
    jm.save_pretrained(str(tmp_path), params)
    loaded = AutoencoderKLWan.from_pretrained(str(tmp_path), device="cpu")
    ref = flatten_to_torch_state_dict(jm, params)
    state = loaded.state_dict()
    assert sorted(ref) == sorted(state)
    assert state["encoder.down_blocks.0.norm1.gamma"].shape == (8, 1, 1, 1)
    for k, v in state.items():
        np.testing.assert_array_equal(v.numpy().ravel(), np.asarray(ref[k]).ravel(), err_msg=k)

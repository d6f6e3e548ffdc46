"""Port models (`diffusers_tpu_torch.models`) against the JAX package on the CPU.

Each case builds the JAX model and its port from one config, carries the
port's seeded parameters across with `convert_torch_state_dict` (1-D leaves
jittered so norm scales/biases are not the trivial 1/0; JAX's eager `init` of
a tiny UNet alone takes ~15 s on a CPU, and the bridge's other direction,
`load_jax_params`, has its own tests below), feeds both the same numpy inputs in
float32 and compares at the public boundary (NCHW for UNet/VAE). Tolerance:
max-abs `< 5e-4`, the README's whole-model parity bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.models.autoencoders.autoencoder_kl import AutoencoderKL as JaxAutoencoderKL
from diffusers_tpu.models.embeddings import TextTimeEmbedding as JaxTextTimeEmbedding
from diffusers_tpu.models.modeling_utils import convert_torch_state_dict, flatten_to_torch_state_dict
from diffusers_tpu.models.text_encoders.clip import CLIPTextModel as JaxCLIPTextModel
from diffusers_tpu.models.text_encoders.clip import CLIPTextModelWithProjection as JaxCLIPTextModelWithProjection
from diffusers_tpu.models.unets.unet_2d_condition import UNet2DConditionModel as JaxUNet2DConditionModel
from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
from diffusers_tpu_torch.models.embeddings import TextTimeEmbedding
from diffusers_tpu_torch.models.modeling_utils import load_jax_params
from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel, CLIPTextModelWithProjection
from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
from test_torch_jit_reference import JitModule
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

ATOL = 5e-4

# the tiny configs of tests/test_unet_2d_condition.py
SD_TINY = dict(
    sample_size=16, in_channels=4, out_channels=4,
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"), up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    block_out_channels=(32, 64), layers_per_block=2, attention_head_dim=8, cross_attention_dim=32,
    norm_num_groups=32,
)
SDXL_TINY = dict(
    sample_size=16, in_channels=4, out_channels=4,
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"), up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
    block_out_channels=(32, 64), layers_per_block=2, attention_head_dim=(2, 4), transformer_layers_per_block=(1, 2),
    use_linear_projection=True, addition_embed_type="text_time", addition_time_embed_dim=8,
    projection_class_embeddings_input_dim=80,  # 2*32 text + 6*8 time ids
    cross_attention_dim=64, norm_num_groups=32,
)
VAE_TINY = dict(
    in_channels=3, out_channels=3, down_block_types=("DownEncoderBlock2D",) * 2,
    up_block_types=("UpDecoderBlock2D",) * 2, block_out_channels=(32, 64), latent_channels=4,
    layers_per_block=1, norm_num_groups=32, sample_size=32,
)
CLIP_TINY = dict(vocab_size=1000, hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                 num_attention_heads=4, max_position_embeddings=77, projection_dim=24)


def carry_params(jax_model, torch_model, seed=0):
    """The port's weights from `seed` (its modules' own initialisation, 1-D
    leaves jittered), carried into the JAX model; returns the JAX params
    (jnp) of the same weights."""
    torch.manual_seed(seed)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in torch_model.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters()
        for p in torch_model.parameters():
            if p.ndim == 1:
                p.add_(torch.from_numpy(0.1 * rng.randn(*p.shape).astype(np.float32)))
    torch_model.eval()
    return convert_torch_state_dict(jax_model, {k: v.numpy() for k, v in torch_model.state_dict().items()})


def jax_tree(jax_model, torch_model, seed=0):
    """A JAX parameter tree (numpy leaves, JAX layouts) of `carry_params`'
    weights, for the `load_jax_params` direction of the bridge."""
    return jax.device_get(carry_params(jax_model, torch_model, seed))


def _max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


@pytest.mark.parametrize("config", ["sdxl", "sd"])
def test_unet_matches_jax(config):
    cfg = SDXL_TINY if config == "sdxl" else SD_TINY
    jm, tm = JaxUNet2DConditionModel(**cfg), UNet2DConditionModel(**cfg)
    params = carry_params(jm, tm)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 4, 16, 16).astype(np.float32)
    ehs = rng.randn(2, 8, cfg["cross_attention_dim"]).astype(np.float32)
    cond = {"text_embeds": rng.randn(2, 32).astype(np.float32), "time_ids": rng.randn(2, 6).astype(np.float32)}
    added = cond if config == "sdxl" else None
    jadded = None if added is None else {k: jnp.asarray(v) for k, v in added.items()}
    ref = jax.jit(lambda p, x, e, a: jm(p, x, 5, e, added_cond_kwargs=a).sample)(
        params, jnp.asarray(x), jnp.asarray(ehs), jadded)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), 5, torch.from_numpy(ehs),
                 added_cond_kwargs=None if added is None else {k: torch.from_numpy(v) for k, v in added.items()}).sample
    assert out.shape == (2, 4, 16, 16)
    assert _max_diff(out.numpy(), ref) < ATOL


def test_vae_decode_and_encode_match_jax():
    jm, tm = JaxAutoencoderKL(**VAE_TINY), AutoencoderKL(**VAE_TINY)
    params = carry_params(jm, tm, seed=2)
    rng = np.random.RandomState(3)
    z = rng.randn(1, 4, 8, 8).astype(np.float32)
    image = rng.rand(1, 3, 16, 16).astype(np.float32) * 2 - 1
    with torch.no_grad():
        dec = tm.decode(torch.from_numpy(z)).sample
        post = tm.encode(torch.from_numpy(image))
    assert dec.shape == (1, 3, 16, 16)
    assert _max_diff(dec.numpy(), jax.jit(lambda p, z: jm.decode(p, z).sample)(params, jnp.asarray(z))) < ATOL

    def encode(p, x):
        posterior = jm.encode(p, x)
        return posterior.mean, posterior.std

    ref_mean, ref_std = jax.jit(encode)(params, jnp.asarray(image))
    assert _max_diff(post.mean.numpy(), ref_mean) < ATOL
    assert _max_diff(post.std.numpy(), ref_std) < ATOL


@pytest.mark.parametrize("projection", [False, True])
def test_clip_text_towers_match_jax(projection):
    jcls, tcls = (JaxCLIPTextModelWithProjection, CLIPTextModelWithProjection) if projection else (
        JaxCLIPTextModel, CLIPTextModel)
    cfg = dict(CLIP_TINY, hidden_act="gelu") if projection else CLIP_TINY
    jm, tm = jcls(**cfg), tcls(**cfg)
    params = carry_params(jm, tm, seed=4)
    rng = np.random.RandomState(5)
    ids = np.concatenate([np.full((2, 1), 998), rng.randint(2, 990, (2, 9)), np.full((2, 1), 999),
                          np.zeros((2, 66), np.int64)], axis=1)  # BOS, tokens, EOS (highest id), padding
    ref = JitModule(jm)(params, jnp.asarray(ids), output_hidden_states=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(ids), output_hidden_states=True)
    assert _max_diff(out.last_hidden_state.numpy(), ref.last_hidden_state) < ATOL
    assert _max_diff(out.hidden_states[-2].numpy(), ref.hidden_states[-2]) < ATOL
    assert _max_diff(out.pooler_output.numpy(), ref.pooler_output) < ATOL
    if projection:
        assert _max_diff(out.text_embeds.numpy(), ref.text_embeds) < ATOL


def test_text_time_embedding_matches_jax():
    jm, tm = JaxTextTimeEmbedding(32, 48, num_heads=4), TextTimeEmbedding(32, 48, num_heads=4)
    params = carry_params(jm, tm, seed=6)
    x = np.random.RandomState(7).randn(2, 10, 32).astype(np.float32)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert out.shape == (2, 48)
    assert _max_diff(out.numpy(), jm(params, jnp.asarray(x))) < ATOL


@pytest.mark.parametrize("config", ["sdxl", "sd"])
def test_weight_bridge_matches_flatten_to_torch_state_dict(config):
    """load_jax_params applies `_leaf_convert_to_torch`'s layout rules: the
    port's state dict equals the JAX package's torch-layout export, key for
    key and bit for bit."""
    cfg = SDXL_TINY if config == "sdxl" else SD_TINY
    jm, tm = JaxUNet2DConditionModel(**cfg), UNet2DConditionModel(**cfg)
    params = jax_tree(jm, UNet2DConditionModel(**cfg), seed=8)
    load_jax_params(tm, params)
    expected = flatten_to_torch_state_dict(jm, params)
    got = {k: v.numpy() for k, v in tm.state_dict().items()}
    assert sorted(got) == sorted(expected)
    for k, v in expected.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_weight_bridge_is_strict():
    cfg = SDXL_TINY
    jm, tm = JaxUNet2DConditionModel(**cfg), UNet2DConditionModel(**cfg)
    params = jax_tree(jm, UNet2DConditionModel(**cfg), seed=9)
    del params["conv_in"]["bias"]
    with pytest.raises(RuntimeError, match="conv_in.bias"):
        load_jax_params(tm, params)


def test_unet_optional_conditioning_matches_jax():
    """The UNet options beyond SDXL's defaults that the port carries: the
    `text` addition embedding, an LCM `timestep_cond`, post/embedding
    activations, centered input and a 2-D encoder attention mask."""
    cfg = dict(SD_TINY, addition_embed_type="text", addition_embed_type_num_heads=4, time_cond_proj_dim=16,
               center_input_sample=True, time_embedding_act_fn="silu", timestep_post_act="silu")
    jm, tm = JaxUNet2DConditionModel(**cfg), UNet2DConditionModel(**cfg)
    params = carry_params(jm, tm, seed=10)
    rng = np.random.RandomState(11)
    x = rng.rand(2, 4, 16, 16).astype(np.float32)
    ehs = rng.randn(2, 8, 32).astype(np.float32)
    cond = rng.randn(2, 16).astype(np.float32)
    mask = np.array([[1] * 8, [1] * 5 + [0] * 3], dtype=np.float32)
    ref = jax.jit(lambda p, x, e, c, m: jm(p, x, 7, e, timestep_cond=c, encoder_attention_mask=m).sample)(
        params, jnp.asarray(x), jnp.asarray(ehs), jnp.asarray(cond), jnp.asarray(mask))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), 7, torch.from_numpy(ehs), timestep_cond=torch.from_numpy(cond),
                 encoder_attention_mask=torch.from_numpy(mask)).sample
    assert _max_diff(out.numpy(), ref) < ATOL


@pytest.mark.parametrize(
    "kwargs,temb",
    [
        (dict(in_channels=32, out_channels=64), True),
        (dict(in_channels=32, time_embedding_norm="scale_shift"), True),
        (dict(in_channels=32, up=True), True),
        (dict(in_channels=32, down=True, output_scale_factor=2.0), True),
        (dict(in_channels=32, non_linearity="gelu", temb_channels=None), False),
    ],
    ids=["shortcut", "scale-shift", "up", "down", "gelu-no-temb"],
)
def test_resnet_block_matches_jax(kwargs, temb):
    from diffusers_tpu.models.resnet import ResnetBlock2D as JaxResnetBlock2D
    from diffusers_tpu_torch.models.resnet import ResnetBlock2D

    kwargs = dict(dict(temb_channels=24, groups=8), **kwargs)
    jm, tm = JaxResnetBlock2D(**kwargs), ResnetBlock2D(**kwargs)
    params = carry_params(jm, tm, seed=12)
    rng = np.random.RandomState(13)
    x = rng.randn(2, 32, 8, 8).astype(np.float32)
    t = rng.randn(2, 24).astype(np.float32) if temb else None
    ref = JitModule(jm)(params, jnp.asarray(x.transpose(0, 2, 3, 1)), None if t is None else jnp.asarray(t))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), None if t is None else torch.from_numpy(t))
    assert _max_diff(out.numpy(), np.asarray(ref).transpose(0, 3, 1, 2)) < ATOL


@pytest.mark.parametrize(
    "kwargs,cross,masked",
    [
        (dict(query_dim=32, heads=1, dim_head=32, norm_num_groups=8, residual_connection=True, bias=True,
              rescale_output_factor=2.0), False, False),
        (dict(query_dim=32, cross_attention_dim=24, heads=4, dim_head=8, cross_attention_norm="layer_norm"),
         True, True),
        (dict(query_dim=32, heads=4, dim_head=8, kv_heads=2), False, False),
        (dict(query_dim=32, heads=2, dim_head=16, pre_only=True, out_dim=32), False, True),
    ],
    ids=["vae-mid-block", "cross-norm-mask", "grouped-kv", "pre-only"],
)
def test_attention_matches_jax(kwargs, cross, masked):
    from diffusers_tpu.models.attention import Attention as JaxAttention
    from diffusers_tpu_torch.models.attention import Attention

    jm, tm = JaxAttention(**kwargs), Attention(**kwargs)
    params = carry_params(jm, tm, seed=14)
    rng = np.random.RandomState(15)
    x = rng.randn(2, 12, 32).astype(np.float32)
    ctx = rng.randn(2, 7, 24).astype(np.float32) if cross else None
    sk = 7 if cross else 12
    mask = np.where(rng.rand(2, 1, 12, sk) < 0.3, -1e4, 0.0).astype(np.float32) if masked else None
    ref = JitModule(jm)(params, jnp.asarray(x), None if ctx is None else jnp.asarray(ctx),
             None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), None if ctx is None else torch.from_numpy(ctx),
                 None if mask is None else torch.from_numpy(mask))
    assert _max_diff(out.numpy(), ref) < ATOL


def test_posterior_sample_uses_the_generator():
    tm = AutoencoderKL(**VAE_TINY).eval()
    image = torch.from_numpy(np.random.RandomState(16).rand(1, 3, 16, 16).astype(np.float32) * 2 - 1)
    with torch.no_grad():
        post = tm.encode(image)
    a = post.sample(torch.Generator().manual_seed(3))
    b = post.sample(torch.Generator().manual_seed(3))
    noise = torch.randn(post.mean.shape, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b)
    torch.testing.assert_close(a, post.mean + post.std * noise)
    assert a.shape == (1, 4, 8, 8)


def test_config_round_trips_through_json():
    import json

    tm = UNet2DConditionModel(**SDXL_TINY)
    cfg = json.loads(tm.to_json_string())
    assert cfg["_class_name"] == "UNet2DConditionModel"
    rebuilt = UNet2DConditionModel.from_config(cfg)
    assert rebuilt.to_json_string() == tm.to_json_string()
    assert {k: v.shape for k, v in rebuilt.state_dict().items()} == {k: v.shape for k, v in tm.state_dict().items()}

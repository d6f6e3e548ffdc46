"""The port's HunyuanVideo models against the JAX package on the CPU: the
transformer under each `image_condition_type` (None, ``token_replace``,
``latent_concat``) with a prompt whose first token is padding (the refiner's
column-0 rule), the RoPE tables, the refiner's 2-D mask, the causal 3-D
VAE's encode and decode over more than one latent frame (its mid-block
attention by query frame against JAX's dense frame-causal mask), an
original-layout HunyuanVideo LoRA fused into the transformer against JAX's
fused weights, and both models through `save_pretrained` /
`from_pretrained`.

Tiny widths: the transformer of JAX's fixture
(`tests/test_transformer_hunyuan_video.py:14-28`: 2 heads x 10, 2 dual and 2
single blocks, 1 refiner layer, text 16 wide, pooled 8), the VAE of
`tests/test_pipeline_hunyuan_video.py:50-53` (widths 8, 4 groups, 8x in
space, 4x in time). f32 on both sides; tolerance 5e-4 on the models (the
README's whole-model bound), the tables and masks exact. JAX models run under
`jax.jit`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.loaders import lora as jlora
from diffusers_tpu.models.attention import Attention as JaxAttention
from diffusers_tpu.models.autoencoders.autoencoder_kl_hunyuan_video import AutoencoderKLHunyuanVideo as JaxHVVAE
from diffusers_tpu.models.autoencoders.autoencoder_kl_hunyuan_video import prepare_causal_attention_mask
from diffusers_tpu.models.transformers.transformer_hunyuan_video import HunyuanVideoTransformer3DModel as JaxHVT
from diffusers_tpu_torch import AutoencoderKLHunyuanVideo, HunyuanVideoTransformer3DModel
from diffusers_tpu_torch.loaders import lora
from diffusers_tpu_torch.models.attention import Attention
from diffusers_tpu_torch.models.autoencoders.autoencoder_kl_hunyuan_video import HYCausalConv3d, frame_causal_attention
from diffusers_tpu_torch.models.transformers.transformer_hunyuan_video import refiner_mask, validity_bias
from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention_full
from test_torch_lora import _assert_weights, _pair
from test_torch_qwenimage import carry, seeded
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

ATOL = 5e-4
TINY = dict(in_channels=4, out_channels=4, num_attention_heads=2, attention_head_dim=10, num_layers=2,
            num_single_layers=2, num_refiner_layers=1, patch_size=1, patch_size_t=1, guidance_embeds=True,
            text_embed_dim=16, pooled_projection_dim=8, rope_axes_dim=(2, 4, 4))
VAE = dict(in_channels=3, out_channels=3, latent_channels=4, block_out_channels=(8, 8, 8, 8), layers_per_block=1,
           norm_num_groups=4)
# row 0's first token is padding: its refiner rows keep column 0 only where the mask says so
MASK = np.array([[0, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 0]], np.int64)


def _inputs(in_channels=4, seed=0):
    rng = np.random.RandomState(seed)
    return dict(hidden_states=rng.randn(2, in_channels, 2, 4, 4).astype(np.float32),
                timestep=np.array([900.0, 250.0], np.float32),
                encoder_hidden_states=rng.randn(2, 6, 16).astype(np.float32), encoder_attention_mask=MASK,
                pooled_projections=rng.randn(2, 8).astype(np.float32),
                guidance=np.array([6000.0, 6000.0], np.float32))


def _run(tm, jm, params, ins):
    ref = np.asarray(jax.jit(lambda p, kw: jm(p, **kw).sample)(params, {k: jnp.asarray(v) for k, v in ins.items()}))
    with torch.no_grad():
        out = tm(**{k: torch.from_numpy(v) for k, v in ins.items()}).sample.numpy()
    return out, ref


CONDITIONS = {None: {}, "token_replace": dict(guidance_embeds=False), "latent_concat": dict(in_channels=9)}


@pytest.mark.parametrize("condition", list(CONDITIONS))
def test_transformer_matches_jax(condition):
    cfg = dict(TINY, image_condition_type=condition, **CONDITIONS[condition])
    tm = seeded(HunyuanVideoTransformer3DModel, cfg, seed=1)
    jm, params = carry(JaxHVT, tm, cfg)
    ins = _inputs(cfg["in_channels"])
    if not cfg["guidance_embeds"]:
        ins.pop("guidance")
    flash_attention_full.launches = 0
    out, ref = _run(tm, jm, params, ins)
    assert flash_attention_full.launches == 0  # CPU tensors take the plain path
    assert out.shape == ref.shape == (2, 4, 2, 4, 4)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_rope_tables_and_masks_match_jax():
    """The RoPE tables bit-equal to JAX's at an odd grid; the refiner's 2-D
    mask (column 0 forced on) and the joined sequence's validity equal to
    JAX's bool masks."""
    jm = JaxHVT(**dict(TINY, patch_size=2))
    tm = HunyuanVideoTransformer3DModel(**dict(TINY, patch_size=2))
    for ref, out in zip(jm.rope(3, 6, 10), tm.rope(3, 6, 10)):
        assert out.shape == (3 * 3 * 5, 10) and np.array_equal(out, ref)
    m = MASK.astype(bool)
    ref2d = m[:, None, :, None] & m[:, None, None, :]
    ref2d[:, :, :, 0] = True
    assert np.array_equal(refiner_mask(torch.from_numpy(MASK)).numpy(), ref2d)
    eff = 5 + MASK.sum(axis=1)
    keep = np.arange(11)[None, :] < eff[:, None]
    bias = validity_bias(torch.from_numpy(MASK), 5).numpy()
    assert bias.shape == (2, 1, 1, 11) and np.array_equal(bias[:, 0, 0] == 0, keep)
    assert np.all(np.isneginf(bias[:, 0, 0][~keep]))


@pytest.mark.parametrize("frames, chunked", [(5, False), (9, True)])
def test_vae_matches_jax(frames, chunked, monkeypatch):
    """Encode (the posterior's moments) and decode at 2 and 3 latent frames:
    the mid block's frame-wise attention against JAX's dense mask; at 3, each
    causal conv over 600 bytes convolves a span of output frames at a time."""
    if chunked:
        monkeypatch.setattr(HYCausalConv3d, "chunk_bytes", 600)
    tm = seeded(AutoencoderKLHunyuanVideo, VAE, seed=2)
    jm, params = carry(JaxHVVAE, tm, VAE)
    x = np.random.RandomState(3).randn(1, 3, frames, 16, 24).astype(np.float32)
    mom_ref = np.asarray(jax.jit(lambda p, v: jm.encode(p, v).parameters)(params, x))
    z = np.random.RandomState(4).randn(1, 4, (frames - 1) // 4 + 1, 2, 3).astype(np.float32)
    dec_ref = np.asarray(jax.jit(lambda p, v: jm.decode(p, v).sample)(params, z))
    with torch.no_grad():
        mom = tm.encode(torch.from_numpy(x)).latent_dist.parameters.numpy()
        dec = tm.decode(torch.from_numpy(z)).sample.numpy()
    assert mom.shape == mom_ref.shape == (1, 8, (frames - 1) // 4 + 1, 2, 3)
    assert dec.shape == dec_ref.shape == (1, 3, frames, 16, 24)
    np.testing.assert_allclose(mom, mom_ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(dec, dec_ref, atol=ATOL, rtol=0)


def test_frame_causal_attention_matches_the_dense_mask():
    """The mid block's attention by query frame against JAX's `Attention`
    under `prepare_causal_attention_mask`, at 4 frames of 3 x 5 tokens and
    one head of 16."""
    torch.manual_seed(5)
    attn = Attention(16, heads=1, dim_head=16, eps=1e-6, norm_num_groups=4, residual_connection=True, bias=True)
    jattn = JaxAttention(16, heads=1, dim_head=16, eps=1e-6, norm_num_groups=4, residual_connection=True, bias=True,
                         upcast_softmax=True)
    params = carry(lambda: jattn, attn, {})[1]
    x = np.random.RandomState(6).randn(2, 16, 4, 3, 5).astype(np.float32)
    flat = x.transpose(0, 2, 3, 4, 1).reshape(2, 60, 16)
    mask = jnp.asarray(prepare_causal_attention_mask(4, 15, 2))[:, None]
    ref = np.asarray(jax.jit(lambda p, v: jattn(p, v, attention_mask=mask))(params, flat))
    with torch.no_grad():
        out = frame_causal_attention(attn, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out.transpose(0, 2, 3, 4, 1).reshape(2, 60, 16), ref, atol=1e-5, rtol=0)


def test_hunyuan_video_lora_fused_matches_jax():
    """An original-layout HunyuanVideo LoRA (the dual block's fused qkv of
    both streams, its MLP and text modulation, a single block's `linear2`)
    through `load_lora_weights`, held weight by weight to JAX's fused
    params and then on a forward. These keys are outside ROADMAP C4 (p)."""
    tm = seeded(HunyuanVideoTransformer3DModel, TINY, seed=7)
    jm, params = carry(JaxHVT, tm, TINY)
    rng = np.random.RandomState(8)
    sd = {
        **_pair(rng, "diffusion_model.double_blocks.0.img_attn_qkv", 20, 60, "lora_A", "lora_B"),
        **_pair(rng, "diffusion_model.double_blocks.1.txt_attn_qkv", 20, 60, "lora_A", "lora_B"),
        **_pair(rng, "diffusion_model.double_blocks.0.img_mlp.fc1", 20, 80, "lora_A", "lora_B"),
        **_pair(rng, "diffusion_model.double_blocks.1.txt_mod.linear", 20, 120, "lora_A", "lora_B"),
        **_pair(rng, "diffusion_model.single_blocks.1.linear2", 100, 20, "lora_A", "lora_B"),
    }
    fused = jlora.load_lora_weights(dict(sd), params, component="transformer", scale=0.8)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    lora.load_lora_weights(dict(sd), tm, component="transformer", scale=0.8)
    changed = {k for k, v in tm.state_dict().items() if not torch.equal(v, before[k])}
    assert len(changed) == 9, sorted(changed)  # q, k, v twice, fc1, the text modulation, linear2
    _assert_weights(jm, fused, tm)
    out, ref = _run(tm, jm, fused, _inputs(seed=9))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_models_round_trip_through_from_pretrained(tmp_path):
    """Both models written by `save_pretrained` and read back by the port
    (bit-equal) and by JAX (the same weights)."""
    for cls, jcls, cfg, name in ((HunyuanVideoTransformer3DModel, JaxHVT, TINY, "transformer"),
                                 (AutoencoderKLHunyuanVideo, JaxHVVAE, VAE, "vae")):
        tm = seeded(cls, cfg, seed=10)
        tm.save_pretrained(tmp_path / name)
        back = cls.from_pretrained(tmp_path / name, device="cpu")
        state = back.state_dict()
        assert sorted(state) == sorted(tm.state_dict())
        assert all(torch.equal(v, state[k]) for k, v in tm.state_dict().items())
        jm, jparams = jcls.from_pretrained(str(tmp_path / name))
        _assert_weights(jm, jparams, tm, atol=0)

"""The port's Qwen-Image models against the JAX package on the CPU: the
double-stream transformer (a padding mask that covers whole 128-key tiles of
the joint sequence, the centre-symmetric RoPE tables, ControlNet residuals
by the interval rule), its VAE (the Wan-family subclass: config keys, a
one-frame encode and decode), and a Qwen kohya LoRA fused into the
transformer against JAX's `fuse_lora`.

Tiny widths: the transformer of JAX's own fixture (`tests/test_qwenimage.py`:
2 blocks of 2 heads x 16, joint dim 24, in 16, out 4), a VAE of base 8 and
z 4 with three spatial downsamples. f32 on both sides; tolerance 5e-4 on the
transformer and the decode (the README's whole-model bound; measured below
1e-5), the RoPE tables bit-equal. JAX models run under `jax.jit`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffusers_tpu.loaders import lora as jlora
from diffusers_tpu.models.autoencoders.autoencoder_kl_qwenimage import AutoencoderKLQwenImage as JaxQwenVAE
from diffusers_tpu.models.modeling_utils import convert_torch_state_dict
from diffusers_tpu.models.transformers.transformer_qwenimage import QwenEmbedRope as JaxRope
from diffusers_tpu.models.transformers.transformer_qwenimage import QwenImageTransformer2DModel as JaxQwenT
from diffusers_tpu_torch import AutoencoderKLQwenImage, QwenImageTransformer2DModel
from diffusers_tpu_torch.loaders import lora
from diffusers_tpu_torch.models.transformers.transformer_qwenimage import QwenEmbedRope
from test_torch_lora import _assert_weights, _pair

torch.set_num_threads(1)

ATOL = 5e-4
TINY = dict(patch_size=2, in_channels=16, out_channels=4, num_layers=2, attention_head_dim=16, num_attention_heads=2,
            joint_attention_dim=24, axes_dims_rope=(8, 4, 4))
VAE = dict(base_dim=8, z_dim=4, dim_mult=(1, 2, 2, 2), num_res_blocks=1, latents_mean=[0.1, -0.2, 0.0, 0.3],
           latents_std=[1.0, 0.5, 2.0, 1.5])


def seeded(cls, cfg, seed):
    """A port model with seeded weights, its 1-D ones jittered, and its JAX
    twin with the same weights: (port model, JAX model, JAX params)."""
    torch.manual_seed(seed)
    rng = np.random.RandomState(seed)
    tm = cls(**cfg).eval()
    with torch.no_grad():
        for p in tm.parameters():
            if p.ndim == 1:
                p.add_(torch.from_numpy((0.1 * rng.randn(*p.shape)).astype(np.float32)))
    return tm


def carry(jcls, tm, cfg):
    jm = jcls(**cfg)
    return jm, convert_torch_state_dict(jm, {k: v.numpy() for k, v in tm.state_dict().items()})


def _transformer_inputs(seed=0, txt=300, keep=(10, 37)):
    """Image tokens of a 4 x 4 grid, `txt` text tokens of which each row keeps
    its first `keep[i]`: keys 128-255 are masked in both rows (a whole
    128-key tile of the joint sequence), the first tile only in part."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 16, 16).astype(np.float32)
    ehs = rng.randn(2, txt, 24).astype(np.float32)
    mask = np.zeros((2, txt), np.int64)
    for i, k in enumerate(keep):
        mask[i, :k] = 1
    t = np.array([0.5, 0.9], np.float32)
    return x, ehs, mask, t


def _run_jax(jm, params, x, ehs, mask, t, samples=None):
    fn = jax.jit(lambda p, *a: jm(p, *a, img_shapes=[(1, 4, 4)], controlnet_block_samples=samples).sample)
    return np.asarray(fn(params, *map(jnp.asarray, (x, ehs, mask, t))))


def test_rope_tables_match_jax():
    """The image and text tables, bit-equal, at odd and even grids and a
    second image."""
    for shapes, txt in (([(1, 4, 4)], 7), ([(1, 5, 7)], 12), ([(1, 3, 4), (1, 2, 2)], 5)):
        (ic, is_), (tc, ts) = QwenEmbedRope(10000, (8, 4, 4), scale_rope=True)(shapes, txt)
        (jic, jis), (jtc, jts) = JaxRope(10000, [8, 4, 4], scale_rope=True)(shapes, txt)
        for a, b in ((ic, jic), (is_, jis), (tc, jtc), (ts, jts)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_transformer_matches_jax_under_the_padding_mask():
    tm = seeded(QwenImageTransformer2DModel, TINY, seed=1)
    jm, params = carry(JaxQwenT, tm, TINY)
    x, ehs, mask, t = _transformer_inputs()
    ref = _run_jax(jm, params, x, ehs, mask, t)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(ehs), torch.from_numpy(mask), torch.from_numpy(t),
                 img_shapes=[(1, 4, 4)]).sample
    assert out.shape == (2, 16, 16)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    # the masked text tokens reach nothing: changing them leaves the output as it is
    ehs2 = ehs.copy()
    ehs2[:, 40:] += 1.0
    with torch.no_grad():
        out2 = tm(torch.from_numpy(x), torch.from_numpy(ehs2), torch.from_numpy(mask), torch.from_numpy(t),
                  img_shapes=[(1, 4, 4)]).sample
    torch.testing.assert_close(out2, out, atol=1e-6, rtol=0)


def test_transformer_controlnet_block_samples():
    """One residual for two blocks (the interval rule's ceil), added after each."""
    tm = seeded(QwenImageTransformer2DModel, TINY, seed=2)
    jm, params = carry(JaxQwenT, tm, TINY)
    x, ehs, mask, t = _transformer_inputs(seed=3, txt=12, keep=(12, 5))
    sample = np.random.RandomState(4).randn(2, 16, 32).astype(np.float32)
    ref = _run_jax(jm, params, x, ehs, mask, t, samples=[jnp.asarray(sample)])
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(ehs), torch.from_numpy(mask), torch.from_numpy(t),
                 img_shapes=[(1, 4, 4)], controlnet_block_samples=[torch.from_numpy(sample)]).sample
        plain = tm(torch.from_numpy(x), torch.from_numpy(ehs), torch.from_numpy(mask), torch.from_numpy(t),
                   img_shapes=[(1, 4, 4)]).sample
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    assert float((out - plain).abs().max()) > 1e-3


def test_vae_matches_jax():
    """The config surface is JAX's (QwenImage's keys), with the statistics
    recorded; a one-frame encode (mode) and decode at 5e-4."""
    tm = seeded(AutoencoderKLQwenImage, VAE, seed=5)
    jm, params = carry(JaxQwenVAE, tm, VAE)
    assert set(tm.config) == set(jm.config)
    assert list(tm.config.latents_mean) == VAE["latents_mean"]
    # with the defaults the port records Qwen-Image's statistics; JAX records None (ROADMAP C4)
    default = AutoencoderKLQwenImage(base_dim=8, dim_mult=(1, 2))
    assert len(default.config.latents_mean) == 16 and JaxQwenVAE(base_dim=8, dim_mult=(1, 2)).config.latents_mean is None
    image = np.random.RandomState(6).uniform(-1, 1, (1, 3, 1, 32, 32)).astype(np.float32)
    ref_z = np.asarray(jax.jit(lambda p, x: jm.encode(p, x).mode())(params, jnp.asarray(image)))
    ref_x = np.asarray(jax.jit(lambda p, z: jm.decode(p, z).sample)(params, jnp.asarray(ref_z)))
    with torch.no_grad():
        z = tm.encode(torch.from_numpy(image)).mode()
        x = tm.decode(z).sample
    assert z.shape == (1, 4, 1, 4, 4) and x.shape == (1, 3, 1, 32, 32)
    np.testing.assert_allclose(z.numpy(), ref_z, atol=ATOL, rtol=0)
    np.testing.assert_allclose(x.numpy(), ref_x, atol=ATOL, rtol=0)


def test_qwen_kohya_lora_fused_matches_jax():
    """A Qwen kohya LoRA (attention, added projections, MLP, modulation,
    the top-level projections) fused into the transformer, held weight by
    weight to JAX's `fuse_lora` and then on a forward."""
    tm = seeded(QwenImageTransformer2DModel, TINY, seed=7)
    jm, params = carry(JaxQwenT, tm, TINY)
    rng = np.random.RandomState(8)
    sd = {
        **_pair(rng, "lora_unet_transformer_blocks_0_attn_to_q", 32, 32, alpha=8.0),
        **_pair(rng, "lora_unet_transformer_blocks_1_attn_add_k_proj", 32, 32),
        **_pair(rng, "lora_unet_transformer_blocks_1_attn_to_add_out", 32, 32, alpha=2.0),
        **_pair(rng, "lora_unet_transformer_blocks_0_img_mlp_net_0_proj", 32, 128, alpha=2.0),
        **_pair(rng, "lora_unet_transformer_blocks_1_txt_mod_1", 32, 192),
        **_pair(rng, "lora_unet_img_in", 16, 32),
        **_pair(rng, "lora_unet_norm_out_linear", 32, 64),
    }
    fused = jlora.fuse_lora(params, jlora.group_lora_weights(dict(sd), component="transformer"), scale=0.7)
    grouped = lora.group_lora_weights(dict(sd), component="transformer")
    assert len(grouped) == 7
    lora.fuse_lora(tm, grouped, scale=0.7)
    _assert_weights(jm, fused, tm)
    x, ehs, mask, t = _transformer_inputs(seed=9, txt=12, keep=(12, 5))
    ref = _run_jax(jm, fused, x, ehs, mask, t)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(ehs), torch.from_numpy(mask), torch.from_numpy(t),
                 img_shapes=[(1, 4, 4)]).sample
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)

"""The port's SD3 modules against the JAX package on the CPU.

`PatchEmbed`'s position table: the port computes only the crop a call needs,
and it must equal JAX's crop of the full `pos_embed_max_size`² table bit for
bit (96 and 384, narrow `embed_dim`). `SD3Transformer2DModel` SD3.0-style
and SD3.5-style (dual attention on the first layers, qk RMSNorm), with and
without ControlNet residuals: the port's seeded weights (1-D ones jittered)
carried into JAX with `convert_torch_state_dict`, the same numpy inputs,
float32 on both sides, tolerance `5e-4` (README "Numerical parity"; the
differences are summation order). Also: `load_jax_params` carries a JAX tree
back unchanged, and `from_pretrained` takes upstream's `pos_embed.pos_embed`
buffer through its one named rule.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.models.embeddings import PatchEmbed as JaxPatchEmbed
from diffusers_tpu.models.modeling_utils import convert_torch_state_dict
from diffusers_tpu.models.transformers.transformer_sd3 import SD3Transformer2DModel as JaxSD3
from diffusers_tpu_torch.models.embeddings import PatchEmbed, get_2d_sincos_pos_embed
from diffusers_tpu_torch.models.modeling_utils import load_jax_params, save_safetensors
from diffusers_tpu_torch.models.transformers.transformer_sd3 import SD3Transformer2DModel
from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention_full

torch.set_num_threads(1)

ATOL = 5e-4
SD30 = dict(sample_size=16, patch_size=2, in_channels=4, num_layers=3, attention_head_dim=8, num_attention_heads=4,
            joint_attention_dim=24, caption_projection_dim=32, pooled_projection_dim=16, out_channels=4,
            pos_embed_max_size=96)
SD35 = dict(SD30, dual_attention_layers=(0, 1), qk_norm="rms_norm")


def seeded(cfg, seed=0):
    """A port transformer from `seed`, its 1-D parameters jittered (norm
    weights and biases away from their 1 / 0 init)."""
    torch.manual_seed(seed)
    model = SD3Transformer2DModel(**cfg).eval()
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim == 1:
                p.add_(torch.from_numpy(0.1 * rng.randn(*p.shape).astype(np.float32)))
    return model


def to_jax(jax_model, model):
    return convert_torch_state_dict(jax_model, {k: v.numpy() for k, v in model.state_dict().items()})


@pytest.mark.parametrize("m,dim,h,w", [(96, 32, 8, 8), (96, 32, 5, 7), (384, 64, 64, 64), (384, 64, 3, 128)])
def test_patch_embed_crop_equals_jax(m, dim, h, w):
    jax_pe = JaxPatchEmbed(height=128, width=128, patch_size=2, in_channels=4, embed_dim=dim, pos_embed_max_size=m)
    pe = PatchEmbed(height=128, width=128, patch_size=2, in_channels=4, embed_dim=dim, pos_embed_max_size=m)
    ref = jax_pe.cropped_pos_embed(2 * h, 2 * w)[0]
    out = pe.pos_table(h, w)
    assert out.dtype == np.float32 and out.shape == ref.shape
    assert np.array_equal(out, ref)
    # the position table is no parameter and no state-dict entry
    assert set(pe.state_dict()) == {"proj.weight", "proj.bias"}


@pytest.mark.parametrize("m", [96, None])
def test_patch_embed_forward_matches_jax(m):
    """With `pos_embed_max_size` the centre crop for the call's grid (a 6 x 5
    one here); without it, the whole table of the configured 8 x 8 grid."""
    jax_pe = JaxPatchEmbed(height=16, width=16, patch_size=2, in_channels=4, embed_dim=32, pos_embed_max_size=m)
    pe = PatchEmbed(height=16, width=16, patch_size=2, in_channels=4, embed_dim=32, pos_embed_max_size=m)
    params = convert_torch_state_dict(jax_pe, {k: v.numpy() for k, v in pe.state_dict().items()})
    x = np.random.RandomState(0).randn(2, 4, *((12, 10) if m else (16, 16))).astype(np.float32)
    ref = np.asarray(jax_pe(params, jnp.asarray(x)))
    with torch.no_grad():
        out = pe(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 30 if m else 64, 32)
    assert np.abs(out - ref).max() <= 1e-5
    if m:
        with pytest.raises(ValueError, match="exceeds pos_embed_max_size"):
            pe(torch.zeros(1, 4, 2 * 97, 2))


def _inputs(rng, cfg, batch=2, size=16, txt=8):
    return (rng.randn(batch, cfg["in_channels"], size, size).astype(np.float32),
            rng.randn(batch, txt, cfg["joint_attention_dim"]).astype(np.float32),
            rng.randn(batch, cfg["pooled_projection_dim"]).astype(np.float32),
            np.array([999.0, 312.5][:batch], dtype=np.float32))


@pytest.mark.parametrize("style", ["sd3.0", "sd3.5"])
@pytest.mark.parametrize("controlnet", [False, True])
def test_transformer_matches_jax(style, controlnet):
    cfg = SD30 if style == "sd3.0" else SD35
    model = seeded(cfg, seed=1 if controlnet else 0)
    jm = JaxSD3(**cfg)
    params = to_jax(jm, model)
    rng = np.random.RandomState(2)
    x, ehs, pooled, t = _inputs(rng, cfg)
    residuals = [rng.randn(2, 64, 32).astype(np.float32) for _ in range(2)] if controlnet else None
    ref = np.asarray(jax.jit(lambda p, x, e, pool, t, res: jm(p, x, e, pool, t, block_controlnet_hidden_states=res)
                             .sample)(params, jnp.asarray(x), jnp.asarray(ehs), jnp.asarray(pooled), jnp.asarray(t),
                                      None if residuals is None else [jnp.asarray(r) for r in residuals]))
    flash_attention_full.launches = 0
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(ehs), torch.from_numpy(pooled), torch.from_numpy(t),
                    block_controlnet_hidden_states=None if residuals is None else [torch.from_numpy(r) for r in residuals]
                    ).sample.numpy()
    assert flash_attention_full.launches == 0  # CPU tensors take the plain version
    assert out.shape == x.shape and np.isfinite(out).all()
    assert np.abs(out - ref).max() < ATOL, np.abs(out - ref).max()
    if controlnet:  # the residuals act
        with torch.no_grad():
            plain = model(torch.from_numpy(x), torch.from_numpy(ehs), torch.from_numpy(pooled),
                          torch.from_numpy(t)).sample.numpy()
        assert np.abs(out - plain).max() > 1e-2


@pytest.mark.parametrize("compute", [True, False])
def test_transformer_pab_with_controlnet_matches_jax(compute):
    """The PAB path (a computing step, then a broadcast step from its cache)
    adds the ControlNet residuals as JAX's does."""
    model = seeded(SD35, seed=3)
    jm = JaxSD3(**SD35)
    params = to_jax(jm, model)
    rng = np.random.RandomState(4)
    x, ehs, pooled, t = _inputs(rng, SD35)
    residuals = [rng.randn(2, 64, 32).astype(np.float32) for _ in range(2)]
    jcache = jm.init_pab_cache(2, 64, 8)
    cache = model.init_pab_cache(2, 64, 8)
    steps = [True] if compute else [True, False]
    for step in steps:
        ref, jcache = jm(params, jnp.asarray(x), jnp.asarray(ehs), jnp.asarray(pooled), jnp.asarray(t),
                         block_controlnet_hidden_states=[jnp.asarray(r) for r in residuals], pab_compute=step,
                         pab_cache=jcache)
        with torch.no_grad():
            out, cache = model(torch.from_numpy(x), torch.from_numpy(ehs), torch.from_numpy(pooled),
                               torch.from_numpy(t), block_controlnet_hidden_states=[torch.from_numpy(r) for r in residuals],
                               pab_compute=step, pab_cache=cache)
        x = x * 0.9  # the next step's input
    assert np.abs(out.sample.numpy() - np.asarray(ref.sample)).max() < ATOL
    for i, entry in cache.items():
        for k, v in entry.items():
            assert np.abs(v.numpy() - np.asarray(jcache[i][k])).max() < ATOL, (i, k)


def test_transformer_block_layout():
    """SD3.5's widths in miniature: the last block is context_pre_only (no
    to_add_out, an AdaLayerNormContinuous norm1_context, no context FF), the
    dual blocks carry attn2 and a 9-way norm1, qk RMSNorm is per head."""
    model = SD3Transformer2DModel(**SD35)
    keys = set(model.state_dict())
    last = len(model.transformer_blocks) - 1
    assert not any(k.startswith(f"transformer_blocks.{last}.attn.to_add_out") for k in keys)
    assert not any(k.startswith(f"transformer_blocks.{last}.ff_context") for k in keys)
    assert model.transformer_blocks[last].norm1_context.linear.out_features == 2 * 32
    assert model.transformer_blocks[0].norm1.linear.out_features == 9 * 32
    assert "transformer_blocks.1.attn2.norm_q.weight" in keys and "transformer_blocks.2.attn2.to_q.weight" not in keys
    assert model.transformer_blocks[0].attn.norm_q.weight.shape == (8,)
    assert not any("pos_embed.pos_embed" in k for k in keys)


def test_load_jax_params_round_trip():
    model = seeded(SD35)
    tree = jax.tree_util.tree_map(np.asarray, to_jax(JaxSD3(**SD35), model))
    again = load_jax_params(SD3Transformer2DModel(**SD35), tree)
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def _save_with_upstream_table(model, path, table=None):
    """`save_pretrained`, then the weights rewritten with `pos_embed.pos_embed`
    added as upstream writes it: a float32 [1, m², D] buffer."""
    model.save_pretrained(path)
    cfg = model.config
    m, dim = cfg.pos_embed_max_size, cfg.num_attention_heads * cfg.attention_head_dim
    if table is None:
        table = torch.from_numpy(get_2d_sincos_pos_embed(dim, m, cfg.sample_size // cfg.patch_size))[None]
    state = dict(model.state_dict(), **{"pos_embed.pos_embed": table})
    save_safetensors(state, os.path.join(path, "diffusion_pytorch_model.safetensors"))
    return table


def test_from_pretrained_takes_upstream_pos_embed(tmp_path):
    model = seeded(SD35)
    _save_with_upstream_table(model, str(tmp_path))
    loaded = SD3Transformer2DModel.from_pretrained(str(tmp_path), device="cpu")
    assert loaded.state_dict().keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    x, ehs, pooled, t = (torch.from_numpy(a) for a in _inputs(np.random.RandomState(0), SD35))
    with torch.no_grad():
        assert torch.equal(loaded(x, ehs, pooled, t).sample, model(x, ehs, pooled, t).sample)


@pytest.mark.parametrize("fault", ["shape", "values", "other_key"])
def test_from_pretrained_refuses_a_wrong_table(tmp_path, fault):
    model = seeded(SD30)
    m, dim = SD30["pos_embed_max_size"], 32
    if fault == "shape":
        _save_with_upstream_table(model, str(tmp_path), torch.zeros(1, (m - 1) ** 2, dim))
        match = "has shape"
    elif fault == "values":  # the table of another base size
        _save_with_upstream_table(model, str(tmp_path), torch.from_numpy(get_2d_sincos_pos_embed(dim, m, 16))[None])
        match = "differs from the sin-cos table"
    else:  # loading stays strict for any other extra key
        model.save_pretrained(str(tmp_path))
        state = dict(model.state_dict(), **{"pos_embed.other": torch.zeros(3)})
        save_safetensors(state, os.path.join(str(tmp_path), "diffusion_pytorch_model.safetensors"))
        match = "does not match the model"
    with pytest.raises(ValueError, match=match):
        SD3Transformer2DModel.from_pretrained(str(tmp_path), device="cpu")
    with open(os.path.join(str(tmp_path), "config.json")) as f:
        assert json.load(f)["_class_name"] == "SD3Transformer2DModel"

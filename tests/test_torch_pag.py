"""The port's guidance flags and PAG pipelines against the JAX package on the CPU.

The flags: `Attention.pag_identity` and `Attention.seg_blur_sigma` (a finite
sigma on grids smaller than the pad, the infinite-sigma mean, a grid that is
not square), SD3's joint-attention PAG mask at a ragged token count,
`layer_skip` on an SD3 block and on a UNet's transformer blocks, the layer
and block selectors giving JAX's dotted names, and every context manager
clearing its flag when the body raises.

The PAG pipelines are in `test_torch_pag_sdxl.py`, `test_torch_pag_sd.py`,
`test_torch_pag_sd3.py`, `test_torch_pag_controlnet.py` and
`test_torch_pag_controlnet_sdxl.py` (one file a family, each within ~30 s
on one worker: most of it JAX's compile of its two-forward scan); they share
this file's helpers. Tolerance: a module 5e-4 max-abs (float32 on both
sides).
"""

import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusers_tpu.guiders as jguiders
from diffusers_tpu.models.attention import Attention as JaxAttention
from diffusers_tpu.models.autoencoders.autoencoder_kl import AutoencoderKL as JaxAutoencoderKL
from diffusers_tpu.models.modeling_utils import convert_torch_state_dict
from diffusers_tpu.models.text_encoders.clip import CLIPTextModel as JaxCLIPTextModel
from diffusers_tpu.models.text_encoders.clip import CLIPTextModelWithProjection as JaxCLIPTextModelWithProjection
from diffusers_tpu.models.transformers.transformer_sd3 import JointAttention as JaxJointAttention
from diffusers_tpu.models.transformers.transformer_sd3 import SD3Transformer2DModel as JaxSD3
from diffusers_tpu.models.unets.unet_2d_condition import UNet2DConditionModel as JaxUNet2DConditionModel
from diffusers_tpu_torch.guiders import (
    layers_skipped,
    pag_perturbed,
    seg_blurred,
    select_pag_layers,
    select_skip_blocks,
)
from diffusers_tpu_torch.guiders.perturbed_attention_guidance import iter_self_attention_names
from diffusers_tpu_torch.models.attention import Attention
from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel, CLIPTextModelWithProjection
from diffusers_tpu_torch.models.transformers.transformer_sd3 import JointAttention, SD3Transformer2DModel
from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
from test_torch_controlnet_sd import JitVAE
from test_torch_pipeline_cache import _parts
from test_torch_pipeline_sd3 import SD35
from test_torch_pipeline_sdxl import CLIP, UNET, VAE
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

MODEL_ATOL = 5e-4
IMAGE_ATOL = 5e-4
SD3_ATOL = 2e-3
PROMPT = "a lighthouse on a cliff at dusk"
RNG = np.random.RandomState(18)
LATENTS = RNG.randn(1, 4, 8, 8).astype(np.float32)


class JitInpaintVAE(JitVAE):
    """`JitVAE` whose encode also gives the posterior's `mode()` under
    `jax.jit` (the 9-channel inpaint path encodes the masked image so)."""

    def __init__(self, module):
        super().__init__(module)
        self._mode = jax.jit(lambda p, x: module.encode(p, x).mode())

    def encode(self, params, x):
        return types.SimpleNamespace(sample=lambda key: self._encode(params, x, key),
                                     mode=lambda: self._mode(params, x))


def jit_vae(jpipe):
    """The JAX pipeline with its VAE's encode and decode jitted."""
    jpipe.vae = (JitInpaintVAE(jpipe.vae[0]), jpipe.vae[1])
    return jpipe


def _max_diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def _seeded(module, seed):
    """`module` with its weights from `seed` (1-D ones jittered), and its state dict as numpy."""
    torch.manual_seed(seed)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape) * 0.3 if p.ndim > 1 else
                    torch.randn(p.shape) * 0.1 + torch.from_numpy(0.1 * rng.randn(*p.shape).astype(np.float32)))
    return module.eval(), {k: v.numpy() for k, v in module.state_dict().items()}


# ---------------------------------------------------------------------------- the flags

ATTN = dict(query_dim=16, heads=2, dim_head=8, norm_num_groups=4, residual_connection=True,
            rescale_output_factor=1.5, bias=True)


@pytest.fixture(scope="module")
def attention():
    port, state = _seeded(Attention(**ATTN), 31)
    jm = JaxAttention(**ATTN)
    return port, jm, convert_torch_state_dict(jm, state)


@pytest.mark.parametrize("case,tokens,sigma", [
    ("pag", 16, None),
    ("seg_grid_smaller_than_pad", 4, 1.0),  # a 2 x 2 grid, kernel 7: pad 3
    ("seg_sd15_deepest", 64, 3.0),  # an 8 x 8 grid, kernel 19: pad 9
    ("seg_wide_grid", 36, 0.5),
    ("seg_infinite_sigma", 16, 9999999.0),
    ("seg_not_square", 12, 2.0),
])
def test_attention_flags_match_jax(attention, case, tokens, sigma):
    port, jm, params = attention
    x = RNG.randn(2, tokens, 16).astype(np.float32)
    ctx = RNG.randn(2, 5, 16).astype(np.float32)
    if case == "pag":
        flag, jflag = pag_perturbed([port]), jguiders.pag_perturbed([jm])
    else:
        flag, jflag = seg_blurred([port], sigma), jguiders.seg_blurred([jm], sigma)
    with jflag:
        ref = jax.jit(lambda p, h: jm(p, h))(params, jnp.asarray(x))
        ref_cross = jax.jit(lambda p, h, c: jm(p, h, encoder_hidden_states=c))(params, jnp.asarray(x), jnp.asarray(ctx))
    plain = jax.jit(lambda p, h: jm(p, h))(params, jnp.asarray(x))
    with torch.no_grad(), flag:
        out = port(torch.from_numpy(x))
        out_cross = port(torch.from_numpy(x), encoder_hidden_states=torch.from_numpy(ctx))
        assert (port.pag_identity, port.seg_blur_sigma) == ((True, None) if case == "pag" else (False, sigma))
    assert _max_diff(out, ref) < MODEL_ATOL and _max_diff(out_cross, ref_cross) < MODEL_ATOL
    if case != "seg_not_square":
        assert _max_diff(ref, plain) > 1e-4  # the flag changed the self-attention
    assert not port.pag_identity and port.seg_blur_sigma is None
    with torch.no_grad():
        assert _max_diff(port(torch.from_numpy(x)), plain) < MODEL_ATOL


@pytest.mark.parametrize("sample_len,text_len,pre_only", [(9, 5, False), (13, 7, True)])
def test_sd3_joint_attention_pag_mask_matches_jax(sample_len, text_len, pre_only):
    """The identity image block and the open text keys at ragged token counts."""
    cfg = dict(query_dim=16, heads=2, dim_head=8, added_kv_proj_dim=16, context_pre_only=pre_only,
               qk_norm="rms_norm", out_dim=16)
    port, state = _seeded(JointAttention(**cfg), 32)
    jm = JaxJointAttention(**cfg)
    params = convert_torch_state_dict(jm, state)
    x, ctx = RNG.randn(2, sample_len, 16).astype(np.float32), RNG.randn(2, text_len, 16).astype(np.float32)
    with jguiders.pag_perturbed([jm]):
        ref = jax.jit(lambda p, h, c: jm(p, h, c))(params, jnp.asarray(x), jnp.asarray(ctx))
    with torch.no_grad(), pag_perturbed([port]):
        out = port(torch.from_numpy(x), torch.from_numpy(ctx))
    for a, b in zip(out, ref):
        assert a.shape == b.shape and _max_diff(a, b) < MODEL_ATOL
    from diffusers_tpu_torch.models.transformers.transformer_sd3 import pag_identity_mask

    mask = pag_identity_mask(sample_len + text_len, sample_len)[0, 0]
    low = torch.finfo(torch.float32).min
    assert mask.shape == (sample_len + text_len,) * 2 and mask.dtype == torch.float32
    assert torch.equal(mask[:sample_len, :sample_len], torch.where(torch.eye(sample_len, dtype=torch.bool), 0.0, low))
    assert not mask[:, sample_len:].any() and not mask[sample_len:].any()


@pytest.fixture(scope="module")
def sd3_models():
    jax_parts, torch_parts = _parts([("transformer", JaxSD3, SD3Transformer2DModel, dict(SD35, num_layers=3))], seed=33)
    return jax_parts["transformer"], torch_parts["transformer"]


@pytest.mark.parametrize("mode", ["pag", "skip"])
def test_sd3_transformer_flags_match_jax(sd3_models, mode):
    """PAG on block 1 and SLG skipping blocks 1-2 (the last, context_pre_only block included)."""
    (jm, params), port = sd3_models
    x = RNG.randn(2, 4, 8, 8).astype(np.float32)
    ehs, pooled = RNG.randn(2, 6, 32).astype(np.float32), RNG.randn(2, 32).astype(np.float32)
    t = np.array([500.0, 20.0], np.float32)
    if mode == "pag":
        flag, jflag = (pag_perturbed(select_pag_layers(port, r"transformer_blocks\.1")),
                       jguiders.pag_perturbed(jguiders.select_pag_layers(jm, r"transformer_blocks\.1")))
    else:
        flag, jflag = (layers_skipped(select_skip_blocks(port, [1, 2])),
                       jguiders.layers_skipped(jguiders.select_skip_blocks(jm, [1, 2])))
    with jflag:
        ref = jax.jit(lambda p, *a: jm(p, *a).sample)(params, *map(jnp.asarray, (x, ehs, pooled, t)))
    with torch.no_grad():
        with flag:
            out = port(*map(torch.from_numpy, (x, ehs, pooled, t))).sample
        plain = port(*map(torch.from_numpy, (x, ehs, pooled, t))).sample
    assert _max_diff(out, ref) < MODEL_ATOL and _max_diff(out, plain) > 1e-3
    if mode == "skip":  # a skipped block hands back the PAB cache it was given
        block = port.transformer_blocks[1]
        cached = {"attn": torch.zeros(1)}
        with layers_skipped([block]):
            h, c, entry = block(torch.ones(1, 2, 4), torch.ones(1, 3, 4), None, pab=(False, cached))
        assert entry is cached and torch.equal(h, torch.ones(1, 2, 4)) and torch.equal(c, torch.ones(1, 3, 4))


@pytest.fixture(scope="module")
def unet_models():
    jax_parts, torch_parts = _parts([("unet", JaxUNet2DConditionModel, UNet2DConditionModel, UNET)], seed=34)
    return jax_parts["unet"], torch_parts["unet"]


def _jax_names(jm, blocks):
    """JAX's dotted names of the UNet transformer blocks `blocks` (by identity)."""
    names = {}
    for name, _ in jguiders.perturbed_attention_guidance.iter_self_attention_names(jm):
        node = jm
        prefix = name.rsplit(".attn1", 1)[0]
        for seg in prefix.split("."):
            node = node[int(seg)] if seg.isdigit() else getattr(node, seg)
        names[id(node)] = prefix
    return [names[id(b)] for b in blocks]


def test_selectors_give_jax_names(unet_models, sd3_models):
    (jm, _), port = unet_models
    names = [n for n, _ in iter_self_attention_names(port)]
    assert names == [n for n, _ in jguiders.perturbed_attention_guidance.iter_self_attention_names(jm)]
    assert len(names) == 8 and names[3] == "mid_block.attentions.0.transformer_blocks.1.attn1"
    by_id = {id(m): n for n, m in port.named_modules()}
    for patterns in ("mid", ["down_blocks.1", "up"], r"attentions\.0\.transformer_blocks\.1", "attn1"):
        got = [by_id[id(m)] for m in select_pag_layers(port, patterns)]
        listed = [patterns] if isinstance(patterns, str) else patterns
        assert got == [n for n in names if any(re.search(p, n) for p in listed)]
        assert len(got) == len(jguiders.select_pag_layers(jm, patterns))
    with pytest.raises(ValueError, match="no self-attention layers matched"):
        select_pag_layers(port, "nowhere")
    for indices in ([0, 2], 4, [6, 1]):
        got = [by_id[id(b)] for b in select_skip_blocks(port, indices)]
        assert got == _jax_names(jm, jguiders.select_skip_blocks(jm, indices))
    (jsd3, _), sd3 = sd3_models
    sd3_names = [n for n, _ in iter_self_attention_names(sd3)]
    assert sd3_names == [n for n, _ in jguiders.perturbed_attention_guidance.iter_self_attention_names(jsd3)]
    assert [by for by in select_skip_blocks(sd3, [2, 0])] == [sd3.transformer_blocks[2], sd3.transformer_blocks[0]]


@pytest.mark.parametrize("mode", ["pag_mid", "skip_blocks", "seg_mid"])
def test_unet_flags_match_jax(unet_models, mode):
    (jm, params), port = unet_models
    x = RNG.randn(2, 4, 8, 8).astype(np.float32)
    ehs = RNG.randn(2, 77, 32).astype(np.float32)
    added = {"text_embeds": RNG.randn(2, 16).astype(np.float32),
             "time_ids": np.array([[16, 16, 0, 0, 16, 16]] * 2, np.float32)}
    if mode == "pag_mid":
        flag, jflag = pag_perturbed(select_pag_layers(port, "mid")), jguiders.pag_perturbed(
            jguiders.select_pag_layers(jm, "mid"))
    elif mode == "skip_blocks":
        flag, jflag = layers_skipped(select_skip_blocks(port, [0, 3])), jguiders.layers_skipped(
            jguiders.select_skip_blocks(jm, [0, 3]))
    else:
        flag, jflag = seg_blurred(select_pag_layers(port, "mid"), 1.0), jguiders.seg_blurred(
            jguiders.select_pag_layers(jm, "mid"), 1.0)
    with jflag:
        ref = jax.jit(lambda p, x, e, a: jm(p, x, jnp.asarray([500.0, 500.0]), encoder_hidden_states=e,
                                            added_cond_kwargs=a).sample)(
            params, jnp.asarray(x), jnp.asarray(ehs), {k: jnp.asarray(v) for k, v in added.items()})
    with torch.no_grad():
        args = (torch.from_numpy(x), torch.tensor([500.0, 500.0]), torch.from_numpy(ehs))
        kwargs = dict(added_cond_kwargs={k: torch.from_numpy(v) for k, v in added.items()})
        with flag:
            out = port(*args, **kwargs).sample
        plain = port(*args, **kwargs).sample
    assert _max_diff(out, ref) < MODEL_ATOL and _max_diff(out, plain) > 1e-4


def test_flags_are_cleared_when_the_body_raises(unet_models, sd3_models):
    _, unet = unet_models
    _, sd3 = sd3_models
    attns, blocks = select_pag_layers(unet, "attn1"), select_skip_blocks(unet, [0, 1, 2])
    joint, sd3_blocks = select_pag_layers(sd3, "transformer_blocks"), select_skip_blocks(sd3, [0, 2])
    for manager, check in ((pag_perturbed(attns + joint), lambda: [m.pag_identity for m in attns + joint]),
                           (layers_skipped(blocks + sd3_blocks), lambda: [b.layer_skip for b in blocks + sd3_blocks]),
                           (seg_blurred(attns, 2.0), lambda: [m.seg_blur_sigma is not None for m in attns])):
        with pytest.raises(RuntimeError, match="inside"):
            with manager:
                assert all(check())
                raise RuntimeError("inside")
        assert not any(check())
    # the class defaults stay untouched
    assert Attention.pag_identity is False and JointAttention.pag_identity is False


# ---------------------------------------------------------------------------- shared by the pipeline tests


def _sdxl_parts(in_channels, seed):
    return _parts([
        ("unet", JaxUNet2DConditionModel, UNet2DConditionModel, dict(UNET, in_channels=in_channels)),
        ("vae", JaxAutoencoderKL, AutoencoderKL, VAE),
        ("text_encoder", JaxCLIPTextModel, CLIPTextModel, CLIP),
        ("text_encoder_2", JaxCLIPTextModelWithProjection, CLIPTextModelWithProjection, CLIP),
    ], seed=seed)

"""The port's SD3 ControlNet and its pipeline against the JAX package on the
CPU.

`SD3ControlNetModel` in both kinds: the joint-block kind (InstantX's
layout), plain and with qk RMSNorm, and the single-block kind with its own
`pos_embed` and without (SD3.5 Large's layout, fed patch tokens); the port's
seeded weights (1-D ones jittered, the zero-initialised residual Linears
and `pos_embed_input` made random) carried into JAX with
`convert_torch_state_dict`, float32 on both sides, max-abs `< 5e-4`.
`from_transformer` at a width with `qk_norm` and at SD3.5 Medium's layout
(dual attention on the first blocks): the port follows upstream, keeping
both config keys and copying the blocks whole, and its net equals a JAX net
of its config given its weights; JAX's `from_transformer` drops the keys,
and at SD3.5 Medium's layout its net fails in its forward (ROADMAP C4).
`SD3MultiControlNetModel`'s sum. The pipeline on
tests/test_torch_pipeline_sd3.py's tiny SD3.5 components at its tolerance
(2e-3 on the [0, 1] image), with the ControlNet's
`force_zeros_for_pooled_projection` on (zero pooled input, unshifted
control latents) and off, and with a single-block net; the port's
`randn_tensor` returns JAX's encoder sample.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.models.controlnets.controlnet_sd3 import SD3ControlNetModel as JaxSD3ControlNet
from diffusers_tpu.models.controlnets.controlnet_sd3 import SD3MultiControlNetModel as JaxSD3Multi
from diffusers_tpu.models.transformers.transformer_sd3 import SD3Transformer2DModel as JaxSD3
from diffusers_tpu.pipelines.controlnet_sd3.pipeline_stable_diffusion_3_controlnet import (
    StableDiffusion3ControlNetPipeline as JaxSD3ControlNetPipeline,
)
from diffusers_tpu.utils.jax_utils import randn_tensor as jax_randn
from diffusers_tpu_torch import StableDiffusion3ControlNetPipeline as RootExport
from diffusers_tpu_torch.hooks import TaylorSeerCacheConfig
from diffusers_tpu_torch.models.controlnets import SD3ControlNetModel, SD3MultiControlNetModel
from diffusers_tpu_torch.pipelines.controlnet_sd3 import StableDiffusion3ControlNetPipeline
from diffusers_tpu_torch.pipelines.pipeline_utils import resolve_component_class
from diffusers_tpu_torch.utils import torch_utils
from test_torch_controlnet_sd import to_jax
from test_torch_pipeline_sd3 import PROMPT, SD35, TXT_LEN, build
from test_torch_sd3 import SD30, seeded

torch.set_num_threads(1)

MODEL_ATOL = 5e-4
IMAGE_ATOL = 2e-3
CN_JOINT = dict(SD30, num_layers=2, extra_conditioning_channels=1)
CN_QK = dict(CN_JOINT, qk_norm="rms_norm")
CN_SINGLE = dict(CN_JOINT, joint_attention_dim=None)
CN_SINGLE_NO_POS = dict(CN_SINGLE, use_pos_embed=False)
RNG = np.random.RandomState(3)
LATENTS = RNG.randn(2, 4, 12, 10).astype(np.float32)
COND = RNG.randn(2, 5, 12, 10).astype(np.float32)
EHS = RNG.randn(2, 6, 24).astype(np.float32)
POOLED = RNG.randn(2, 16).astype(np.float32)
T = np.array([700.0, 300.0], np.float32)
PIPE_LATENTS = np.random.RandomState(1).randn(1, 4, 8, 8).astype(np.float32)
CONTROL = np.random.RandomState(2).rand(8, 8, 3).astype(np.float32)


def randomize(net: SD3ControlNetModel, seed: int) -> SD3ControlNetModel:
    """Jitter the 1-D weights and make the zero-initialised residual
    Linears and `pos_embed_input` random, so the residuals act."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.startswith(("controlnet_blocks", "pos_embed_input")):
                p.copy_(torch.from_numpy(0.2 * rng.randn(*p.shape).astype(np.float32)))
            elif p.ndim == 1:
                p.add_(torch.from_numpy(0.1 * rng.randn(*p.shape).astype(np.float32)))
    return net


def seeded_controlnet(cfg, seed=0):
    torch.manual_seed(seed)
    return randomize(SD3ControlNetModel(**cfg).eval(), seed)


def _run(jm, params, tm, hidden, scale=0.8, cond=COND):
    ehs = None if tm.context_embedder is None else EHS
    ref = jax.jit(lambda p: jm(p, jnp.asarray(hidden), jnp.asarray(cond), conditioning_scale=scale,
                               encoder_hidden_states=ehs, pooled_projections=jnp.asarray(POOLED),
                               timestep=jnp.asarray(T)))(params)
    with torch.no_grad():
        out = tm(torch.from_numpy(hidden), torch.from_numpy(cond), conditioning_scale=scale,
                 encoder_hidden_states=None if ehs is None else torch.from_numpy(ehs),
                 pooled_projections=torch.from_numpy(POOLED), timestep=torch.from_numpy(T))
    return ref.controlnet_block_samples, out.controlnet_block_samples


def _max_diff(mine, ref) -> float:
    return max(float(np.abs(a.numpy() - np.asarray(b)).max()) for a, b in zip(mine, ref))


@pytest.mark.parametrize("cfg", [CN_JOINT, CN_QK, CN_SINGLE, CN_SINGLE_NO_POS],
                         ids=["joint", "joint-qk-norm", "single", "single-no-pos-embed"])
def test_sd3_controlnet_model_matches_jax(cfg):
    tm = seeded_controlnet(cfg)
    jm = JaxSD3ControlNet(**cfg)
    hidden = LATENTS
    if not cfg.get("use_pos_embed", True):  # SD3.5 Large's layout: the transformer's patch tokens come in
        hidden = RNG.randn(2, 30, 32).astype(np.float32)
    ref, out = _run(jm, to_jax(jm, tm), tm, hidden)
    assert len(out) == 2 and out[0].shape == (2, 30, 32)
    assert _max_diff(out, ref) < MODEL_ATOL
    bad = LATENTS if hidden.ndim == 3 else np.zeros((2, 30, 32), np.float32)  # the other kind's input
    with pytest.raises(ValueError, match="hidden states must be"):
        tm(torch.from_numpy(bad), torch.from_numpy(COND), pooled_projections=torch.zeros(2, 16),
           timestep=torch.from_numpy(T), encoder_hidden_states=torch.from_numpy(EHS))


def test_sd3_multi_controlnet_sums_like_jax():
    nets = [seeded_controlnet(CN_JOINT, 0), seeded_controlnet(CN_JOINT, 1)]
    jnets = [JaxSD3ControlNet(**CN_JOINT) for _ in nets]
    params = [to_jax(j, t) for j, t in zip(jnets, nets)]
    cond2 = COND[::-1].copy()
    ref = jax.jit(lambda p: JaxSD3Multi(jnets)(p, jnp.asarray(LATENTS), [jnp.asarray(COND), jnp.asarray(cond2)],
                                               conditioning_scale=[0.7, 0.4], encoder_hidden_states=jnp.asarray(EHS),
                                               pooled_projections=jnp.asarray(POOLED), timestep=jnp.asarray(T)))(params)
    with torch.no_grad():
        out = SD3MultiControlNetModel(nets)(
            torch.from_numpy(LATENTS), [torch.from_numpy(COND), torch.from_numpy(cond2)], conditioning_scale=[0.7, 0.4],
            encoder_hidden_states=torch.from_numpy(EHS), pooled_projections=torch.from_numpy(POOLED),
            timestep=torch.from_numpy(T))
    assert _max_diff(out.controlnet_block_samples, ref.controlnet_block_samples) < MODEL_ATOL


def _from_transformer_pair(transformer_cfg):
    """(port transformer, its JAX params, port ControlNet by `from_transformer`,
    JAX's (net, params) by its `from_transformer`), 1 layer, 1 extra channel."""
    transformer = seeded(transformer_cfg, seed=4)
    jt = JaxSD3(**transformer_cfg)
    tparams = to_jax(jt, transformer)
    net = SD3ControlNetModel.from_transformer(transformer, num_layers=1, num_extra_conditioning_channels=1)
    jnet, jparams = JaxSD3ControlNet.from_transformer(jt, tparams, num_layers=1, num_extra_conditioning_channels=1,
                                                      key=jax.random.PRNGKey(0))
    return transformer, tparams, net, (jnet, jparams)


def _held_to_jax_net_of_its_config(net):
    """The port's net, its residual Linears and `pos_embed_input` made
    random, against a JAX net of its config given its weights."""
    randomize(net, 9)
    jm = JaxSD3ControlNet(**dict(net.config))
    ref, out = _run(jm, to_jax(jm, net), net, LATENTS[:, :, :8, :8], cond=COND[:, :, :8, :8])
    return _max_diff(out, ref)


def test_from_transformer_with_qk_norm_matches_jax():
    """A base with qk RMSNorm and no dual attention (SD3.5 Large's blocks):
    the port keeps `qk_norm`, as upstream does, and copies the embedders and
    the first block whole, `norm_q` / `norm_k` included; `pos_embed_input` is
    zero. JAX's `from_transformer` drops `qk_norm` (ROADMAP C4). The port's
    net equals a JAX net of the port's config given its weights."""
    cfg = dict(SD30, qk_norm="rms_norm")
    transformer, _, net, (jnet, _) = _from_transformer_pair(cfg)
    assert net.config.qk_norm == "rms_norm" and jnet.config.get("qk_norm") is None
    base, mine = transformer.transformer_blocks[0].state_dict(), net.transformer_blocks[0].state_dict()
    assert {k for k in base if "norm_q" in k or "norm_k" in k} and mine.keys() == base.keys()
    assert all(torch.equal(v, base[k]) for k, v in mine.items())
    assert not any(p.any() for p in net.pos_embed_input.parameters())
    assert _held_to_jax_net_of_its_config(net) < MODEL_ATOL


def test_from_transformer_at_sd35_medium_layout_and_the_jax_fault():
    """Dual attention on the first blocks and qk RMSNorm (SD3.5 Medium's
    layout): JAX drops both config keys, copies the 9-way `norm1` kernel
    into a 6-way block and its forward fails (ROADMAP C4). The port keeps
    both keys, as upstream does, so each block is the base's, `attn2` and its
    9-way `norm1` included, and its net equals a JAX net of its config given
    its weights."""
    cfg = dict(SD30, dual_attention_layers=(0, 1), qk_norm="rms_norm")
    transformer, _, net, (jnet, jparams) = _from_transformer_pair(cfg)
    hidden, cond = LATENTS[:, :, :8, :8], COND[:, :, :8, :8]
    call = dict(encoder_hidden_states=jnp.asarray(EHS), pooled_projections=jnp.asarray(POOLED), timestep=jnp.asarray(T))
    with pytest.raises(TypeError, match=r"incompatible shapes for broadcasting: \(2, 16, 32\), \(2, 1, 48\)"):
        jax.jit(lambda p: jnet(p, jnp.asarray(hidden), jnp.asarray(cond), **call))(jparams)
    assert tuple(net.config.dual_attention_layers) == (0, 1) and net.config.qk_norm == "rms_norm"
    base, mine = transformer.transformer_blocks[0].state_dict(), net.transformer_blocks[0].state_dict()
    assert mine["norm1.linear.weight"].shape[0] == 9 * 32 and mine.keys() == base.keys()
    assert all(torch.equal(v, base[k]) for k, v in mine.items())
    assert net.transformer_blocks[0].attn2 is not None
    assert _held_to_jax_net_of_its_config(net) < MODEL_ATOL
    with pytest.raises(ValueError, match="context_pre_only"):  # the base's last block cannot seed a block
        SD3ControlNetModel.from_transformer(transformer, num_layers=3)


# ---------------------------------------------------------------------------- the pipeline


def _pipelines(cn_cfg):
    """The tiny SD3.5 pair (test_torch_pipeline_sd3.build) with a ControlNet
    of `cn_cfg` (seeded, residuals random), on both sides."""
    jbase, tbase = build(seed=5)
    net = seeded_controlnet(cn_cfg, seed=6)
    jnet = JaxSD3ControlNet(**cn_cfg)
    parts = {k: v for k, v in tbase.components.items() if k != "controlnet"}
    tpipe = StableDiffusion3ControlNetPipeline(**parts, controlnet=net, device="cpu")
    jparts = {k: getattr(jbase, k) for k in parts}
    jpipe = JaxSD3ControlNetPipeline(**jparts, controlnet=(jnet, to_jax(jnet, net)))
    return jpipe, tpipe


PIPE_CN = dict(SD35, num_layers=1, extra_conditioning_channels=0, dual_attention_layers=(), qk_norm=None)


@pytest.mark.parametrize("cn_cfg", [PIPE_CN, dict(PIPE_CN, force_zeros_for_pooled_projection=False),
                                    dict(PIPE_CN, joint_attention_dim=None)],
                         ids=["force-zeros", "shifted", "single-block"])
def test_sd3_controlnet_pipeline_matches_jax(monkeypatch, cn_cfg):
    """Against JAX's pipeline (the encoder's sample: JAX's draw for its
    split key). The ControlNet is shown zeros as its pooled input and
    ``z * scaling_factor`` as its control latents under
    `force_zeros_for_pooled_projection`, else the prompt's pooled embeddings
    and ``(z - shift_factor) * scaling_factor``."""
    jpipe, tpipe = _pipelines(cn_cfg)
    _, enc_key = jax.random.split(jax.random.PRNGKey(3))
    draw = np.array(jax_randn((1, 4, 8, 8), key=enc_key))
    monkeypatch.setattr(torch_utils, "randn_tensor", lambda shape, generator=None, device=None: torch.from_numpy(draw))
    kwargs = dict(control_image=CONTROL, controlnet_conditioning_scale=0.7, num_inference_steps=3,
                  guidance_scale=5.0, max_sequence_length=TXT_LEN, output_type="np")
    ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(PIPE_LATENTS), key=jax.random.PRNGKey(3), **kwargs).images)
    seen = []
    hook = tpipe.controlnet.register_forward_pre_hook(lambda m, a, kw: seen.append((a[1], kw)), with_kwargs=True)
    try:
        out = tpipe(PROMPT, latents=torch.from_numpy(PIPE_LATENTS), **kwargs).images
    finally:
        hook.remove()
    assert out.shape == (1, 8, 8, 3) and np.isfinite(out).all()
    assert float(np.abs(out - ref).max()) <= IMAGE_ATOL
    control, call = seen[0]
    vae = tpipe.vae
    with torch.no_grad():
        posterior = vae.encode(torch.from_numpy(tpipe.image_processor.preprocess(CONTROL)))
        z = posterior.mean + posterior.std * torch.from_numpy(draw)
    force_zeros = cn_cfg.get("force_zeros_for_pooled_projection", True)
    shift = 0.0 if force_zeros else vae.config.shift_factor
    assert control.shape == (2, 4, 8, 8)  # tiled over the CFG batch
    torch.testing.assert_close(control, ((z - shift) * vae.config.scaling_factor).repeat(2, 1, 1, 1),
                               atol=1e-5, rtol=1e-5)
    assert (not call["pooled_projections"].any()) == force_zeros


def test_sd3_controlnet_pipeline_rules():
    """JAX's defaults; no cache; the multi model and a net without
    `pos_embed` refused (JAX's pipeline gives latents to such a net and
    fails, ROADMAP C4)."""
    import inspect

    params = inspect.signature(StableDiffusion3ControlNetPipeline.__call__).parameters
    jparams = inspect.signature(JaxSD3ControlNetPipeline.__call__).parameters
    for name, value in (("num_inference_steps", 28), ("guidance_scale", 7.0), ("max_sequence_length", 256)):
        assert params[name].default == jparams[name].default == value
    jpipe, tpipe = _pipelines(dict(PIPE_CN, joint_attention_dim=None, use_pos_embed=False))
    kwargs = dict(control_image=CONTROL, num_inference_steps=1, guidance_scale=5.0, max_sequence_length=TXT_LEN,
                  output_type="latent")
    with pytest.raises(ValueError, match="Incompatible shapes"):  # JAX: [B, C, H, W] latents + [B, N, D] tokens
        jpipe(PROMPT, latents=jnp.asarray(PIPE_LATENTS), **kwargs)
    with pytest.raises(ValueError, match="use_pos_embed=False"):
        tpipe(PROMPT, latents=torch.from_numpy(PIPE_LATENTS), **kwargs)
    with pytest.raises(TypeError, match="does not support cache config"):
        tpipe.enable_cache(TaylorSeerCacheConfig())
    parts = {k: v for k, v in tpipe.components.items() if k != "controlnet"}
    with pytest.raises(TypeError, match="SD3ControlNetModel"):
        StableDiffusion3ControlNetPipeline(**parts, controlnet=SD3MultiControlNetModel([tpipe.controlnet]),
                                           device="cpu")
    assert RootExport is StableDiffusion3ControlNetPipeline
    assert resolve_component_class("diffusers", "SD3ControlNetModel")[0] is SD3ControlNetModel


# ---------------------------------------------------------------------------- ROADMAP C1: Flux's image encoder


def test_flux_registers_and_ignores_an_image_encoder_like_jax():
    """JAX's `FluxPipeline` registers `image_encoder` / `feature_extractor`
    and never reads them (it has no Flux IP-Adapter); the port does the
    same: both accept a CLIP vision tower, and the port's request is the
    one it makes without it, bit for bit."""
    from diffusers_tpu.models.autoencoders.autoencoder_kl import AutoencoderKL as JaxAutoencoderKL
    from diffusers_tpu.models.text_encoders.clip import CLIPVisionModelWithProjection as JaxCLIPVision
    from diffusers_tpu.pipelines.flux.pipeline_flux import FluxPipeline as JaxFluxPipeline
    from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
    from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel, CLIPVisionModelWithProjection
    from diffusers_tpu_torch.models.text_encoders.t5 import T5EncoderModel
    from diffusers_tpu_torch.models.transformers.transformer_flux import FluxTransformer2DModel
    from diffusers_tpu_torch.pipelines.flux.pipeline_flux import FluxPipeline
    from diffusers_tpu_torch.schedulers import FlowMatchEulerDiscreteScheduler
    from test_torch_pipeline_sdxl import CRCTokenizer

    vae = dict(in_channels=3, out_channels=3, block_out_channels=(8,), down_block_types=("DownEncoderBlock2D",),
               up_block_types=("UpDecoderBlock2D",), latent_channels=4, layers_per_block=1, norm_num_groups=4,
               sample_size=8, use_quant_conv=False, use_post_quant_conv=False)
    vision = dict(hidden_size=32, intermediate_size=48, num_hidden_layers=1, num_attention_heads=2, image_size=28,
                  patch_size=14, projection_dim=16)
    torch.manual_seed(0)
    parts = dict(vae=AutoencoderKL(**vae), transformer=FluxTransformer2DModel(
        patch_size=1, in_channels=16, num_layers=1, num_single_layers=1, attention_head_dim=16, num_attention_heads=2,
        joint_attention_dim=32, pooled_projection_dim=32, guidance_embeds=False, axes_dims_rope=(4, 6, 6)),
        text_encoder=CLIPTextModel(vocab_size=1000, hidden_size=32, intermediate_size=32, num_hidden_layers=1,
                                   num_attention_heads=2),
        text_encoder_2=T5EncoderModel(vocab_size=1000, d_model=32, d_kv=16, d_ff=32, num_layers=1, num_heads=2),
        tokenizer=CRCTokenizer(), tokenizer_2=CRCTokenizer(), scheduler=FlowMatchEulerDiscreteScheduler())
    encoder = CLIPVisionModelWithProjection(**vision).eval()
    jencoder = JaxCLIPVision(**vision)
    jflux = JaxFluxPipeline(scheduler=None, vae=(JaxAutoencoderKL(**vae), None), text_encoder=None, tokenizer=None,
                            text_encoder_2=None, tokenizer_2=None, transformer=None,
                            image_encoder=(jencoder, to_jax(jencoder, encoder)))
    tflux = FluxPipeline(**parts, image_encoder=encoder, device="cpu")
    assert jflux.image_encoder[0] is jencoder and tflux.image_encoder is encoder
    assert jflux.config["image_encoder"][1] == tflux.config["image_encoder"][1] == "CLIPVisionModelWithProjection"
    kwargs = dict(height=8, width=8, num_inference_steps=2, max_sequence_length=8, output_type="latent")
    with_encoder = tflux("a cat", generator=torch.Generator().manual_seed(0), **kwargs).images
    without = FluxPipeline(**parts, device="cpu")("a cat", generator=torch.Generator().manual_seed(0), **kwargs).images
    assert torch.isfinite(with_encoder).all() and torch.equal(with_encoder, without)

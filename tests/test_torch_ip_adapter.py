"""IP-Adapter in the port against the JAX package on the CPU: each projection
head, the loader's down -> up -> mid key order, the UNet with one and two
adapters, `set_ip_adapter_scale` and scale 0, unloading back to the base
UNet bit for bit, the SD and SDXL pipelines with `ip_adapter_image` and with
`ip_adapter_image_embeds`, and the SD callback path against JAX's fault (h).

The checkpoints are written on the spot in `h94/IP-Adapter`'s key layout
(``image_proj.*``, ``ip_adapter.{2n+1}.to_{k,v}_ip.weight``), from numpy
with a seed, and the same dict (or the same safetensors file) goes to both
packages' loaders. The UNets, VAE, CLIP towers and pipelines are those of
tests/test_torch_stable_diffusion.py and tests/test_torch_pipeline_sdxl.py,
with a small CLIP vision tower (`CLIPVisionModelWithProjection`) beside
them. Image prompts are passed as pixel values, which JAX takes as they are.

Tolerances (the README's): a head alone 2e-5 (attention-sized sums); a UNet
call and a pipeline's [0, 1] image or latents 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.loaders.ip_adapter import _convert_image_proj as jax_convert_image_proj
from diffusers_tpu.loaders.ip_adapter import _iter_cross_attention_paths
from diffusers_tpu.loaders.ip_adapter import load_ip_adapter as jax_load_ip_adapter
from diffusers_tpu.loaders.ip_adapter import set_ip_adapter_scale as jax_set_ip_adapter_scale
from diffusers_tpu.models.autoencoders.autoencoder_kl import AutoencoderKL as JaxAutoencoderKL
from diffusers_tpu.models.text_encoders.clip import CLIPTextModel as JaxCLIPTextModel
from diffusers_tpu.models.text_encoders.clip import CLIPTextModelWithProjection as JaxCLIPTextModelWithProjection
from diffusers_tpu.models.text_encoders.clip import CLIPVisionModelWithProjection as JaxCLIPVision
from diffusers_tpu.models.unets.unet_2d_condition import UNet2DConditionModel as JaxUNet2DConditionModel
from diffusers_tpu.pipelines.stable_diffusion.pipeline_stable_diffusion import (
    StableDiffusionPipeline as JaxStableDiffusionPipeline,
)
from diffusers_tpu.pipelines.stable_diffusion_xl.pipeline_stable_diffusion_xl import (
    StableDiffusionXLPipeline as JaxStableDiffusionXLPipeline,
)
from diffusers_tpu.schedulers import EulerDiscreteScheduler as JaxEulerDiscreteScheduler
from diffusers_tpu_torch.loaders import load_ip_adapter, set_ip_adapter_scale, unload_ip_adapter
from diffusers_tpu_torch.loaders.ip_adapter import convert_image_proj, cross_attentions
from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
from diffusers_tpu_torch.models.ip_adapter import MultiIPAdapterImageProjection
from diffusers_tpu_torch.models.modeling_utils import save_safetensors
from diffusers_tpu_torch.models.text_encoders.clip import (
    CLIPTextModel,
    CLIPTextModelWithProjection,
    CLIPVisionModelWithProjection,
)
from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
from diffusers_tpu_torch.pipelines.stable_diffusion import StableDiffusionPipeline
from diffusers_tpu_torch.pipelines.stable_diffusion_xl import StableDiffusionXLPipeline
from diffusers_tpu_torch.schedulers import EulerDiscreteScheduler
from test_torch_pipeline_cache import _parts
from test_torch_pipeline_sdxl import CLIP, EULER, UNET, VAE, CRCTokenizer
from test_torch_stable_diffusion import LATENTS, PROMPT, SCHEDULERS, UNET_SD
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

HEAD_ATOL = 2e-5
ATOL = 5e-4
# a small CLIP ViT with its projection: 28 px, patches of 14 -> 5 tokens of 64; the projected embedding 24 wide
VISION = dict(hidden_size=64, intermediate_size=96, num_hidden_layers=3, num_attention_heads=2, image_size=28,
              patch_size=14, hidden_act="gelu", projection_dim=24)
VISION_TOKENS = (28 // 14) ** 2 + 1
PIXELS = np.random.RandomState(5).randn(1, 3, 28, 28).astype(np.float32)


def _w(rng, *shape, scale=0.2):
    return (scale * rng.randn(*shape)).astype(np.float32)


def image_proj_state(kind: str, cross_dim: int, seed: int) -> dict:
    """A projection head's ``image_proj`` group in the published key layout."""
    rng = np.random.RandomState(seed)
    d, c = VISION["projection_dim"], cross_dim
    if kind == "base":  # ImageProjection over the projected image embedding, 4 tokens
        return {"proj.weight": _w(rng, 4 * c, d), "proj.bias": _w(rng, 4 * c), "norm.weight": 1 + _w(rng, c),
                "norm.bias": _w(rng, c)}
    if kind == "full":  # over the per-patch states (width VISION hidden)
        h = VISION["hidden_size"]
        return {"proj.0.weight": _w(rng, h, h), "proj.0.bias": _w(rng, h), "proj.2.weight": _w(rng, c, h),
                "proj.2.bias": _w(rng, c), "proj.3.weight": 1 + _w(rng, c), "proj.3.bias": _w(rng, c)}
    if kind == "faceid":  # over a 40-wide id embedding, mult 2, 3 tokens
        return {"proj.0.weight": _w(rng, 80, 40), "proj.0.bias": _w(rng, 80), "proj.2.weight": _w(rng, 3 * c, 80),
                "proj.2.bias": _w(rng, 3 * c), "norm.weight": 1 + _w(rng, c), "norm.bias": _w(rng, c)}
    assert kind == "plus"  # the resampler: 64 wide (one head of 64), depth 2, 4 queries, ffn 4x
    h, e = 64, VISION["hidden_size"]
    state = {"latents": _w(rng, 1, 4, h, scale=0.125), "proj_in.weight": _w(rng, h, e), "proj_in.bias": _w(rng, h),
             "proj_out.weight": _w(rng, c, h), "proj_out.bias": _w(rng, c), "norm_out.weight": 1 + _w(rng, c),
             "norm_out.bias": _w(rng, c)}
    for n in range(2):
        state.update({
            f"layers.{n}.0.norm1.weight": 1 + _w(rng, h), f"layers.{n}.0.norm1.bias": _w(rng, h),
            f"layers.{n}.0.norm2.weight": 1 + _w(rng, h), f"layers.{n}.0.norm2.bias": _w(rng, h),
            f"layers.{n}.0.to_q.weight": _w(rng, h, h), f"layers.{n}.0.to_kv.weight": _w(rng, 2 * h, h),
            f"layers.{n}.0.to_out.weight": _w(rng, h, h),
            f"layers.{n}.1.0.weight": 1 + _w(rng, h), f"layers.{n}.1.0.bias": _w(rng, h),
            f"layers.{n}.1.1.weight": _w(rng, 4 * h, h), f"layers.{n}.1.3.weight": _w(rng, h, 4 * h, scale=0.1)})
    return state


def checkpoint(kind: str, jax_unet, cross_dim: int, seed: int) -> dict:
    """A whole IP-Adapter checkpoint for `jax_unet`: the head, and one
    to_k_ip / to_v_ip pair for each cross attention in the reference's order."""
    rng = np.random.RandomState(seed + 100)
    ip = {}
    for n, (_, attn) in enumerate(_iter_cross_attention_paths(jax_unet)):
        ip[f"{2 * n + 1}.to_k_ip.weight"] = _w(rng, attn.inner_dim, cross_dim, scale=0.5)
        ip[f"{2 * n + 1}.to_v_ip.weight"] = _w(rng, attn.inner_dim, cross_dim, scale=0.5)
    return {"image_proj": image_proj_state(kind, cross_dim, seed), "ip_adapter": ip}


def image_embeds(kind: str, batch: int, seed: int) -> np.ndarray:
    """Random inputs of one head: [B, 1, (tokens,) width]."""
    rng = np.random.RandomState(seed)
    shape = {"base": (VISION["projection_dim"],), "full": (VISION_TOKENS, VISION["hidden_size"]), "faceid": (40,),
             "plus": (VISION_TOKENS, VISION["hidden_size"])}[kind]
    return rng.randn(batch, 1, *shape).astype(np.float32)


def sd_parts(seed=1):
    return _parts([("unet", JaxUNet2DConditionModel, UNet2DConditionModel, UNET_SD),
                   ("vae", JaxAutoencoderKL, AutoencoderKL, VAE),
                   ("text_encoder", JaxCLIPTextModel, CLIPTextModel, CLIP),
                   ("image_encoder", JaxCLIPVision, CLIPVisionModelWithProjection, VISION)], seed=seed)


def _max_diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


# ---------------------------------------------------------------------------- heads and loader


@pytest.mark.parametrize("kind", ["base", "full", "faceid", "plus"])
def test_projection_head_matches_jax(kind):
    state = image_proj_state(kind, 16, seed=3)
    jmod, jparams, jtokens = jax_convert_image_proj(state)
    module, renamed, tokens = convert_image_proj({k: torch.from_numpy(v) for k, v in state.items()})
    module.load_state_dict(renamed, strict=True)
    assert tokens == jtokens and type(module).__name__ == type(jmod).__name__
    x = image_embeds(kind, 2, seed=4)[:, 0]
    ref = jax.jit(jmod)(jparams, jnp.asarray(x))
    with torch.no_grad():
        out = module(torch.from_numpy(x))
    assert out.shape == ref.shape and _max_diff(out, ref) <= HEAD_ATOL


def test_loader_key_order_is_down_up_mid():
    """key_id = 2n + 1 counts cross attentions down -> up -> mid, as the
    reference registers up_blocks before mid_block; the port registers
    mid_block first, so its named_modules() order would put the mid block's
    weights on an up block."""
    jax_parts, torch_parts = sd_parts()
    unet = torch_parts["unet"]
    ckpt = checkpoint("base", jax_parts["unet"][0], 16, seed=0)
    paths = [".".join(map(str, path)) for path, _ in _iter_cross_attention_paths(jax_parts["unet"][0])]
    assert paths == ["down_blocks.0.attentions.0.transformer_blocks.0.attn2",
                     "up_blocks.1.attentions.0.transformer_blocks.0.attn2",
                     "up_blocks.1.attentions.1.transformer_blocks.0.attn2",
                     "mid_block.attentions.0.transformer_blocks.0.attn2"]
    names = {id(m): n for n, m in unet.named_modules()}
    assert [names[id(a)] for a in cross_attentions(unet)] == paths
    named_order = [n for n, m in unet.named_modules() if n.endswith("attn2")]
    assert named_order != paths  # the order the port's module tree would give
    load_ip_adapter(unet, ckpt)
    for n, path in enumerate(paths):
        attn = unet.get_submodule(path)
        np.testing.assert_array_equal(attn.to_k_ip[0].weight.detach().numpy(),
                                      ckpt["ip_adapter"][f"{2 * n + 1}.to_k_ip.weight"])
        np.testing.assert_array_equal(attn.to_v_ip[0].weight.detach().numpy(),
                                      ckpt["ip_adapter"][f"{2 * n + 1}.to_v_ip.weight"])
    bad = {"image_proj": ckpt["image_proj"], "ip_adapter": dict(list(ckpt["ip_adapter"].items())[:-2])}
    with pytest.raises(ValueError, match="cross attentions"):
        load_ip_adapter(unet, bad)


# ---------------------------------------------------------------------------- the UNet


def _unet_pair(kinds, tmp_path=None):
    """The SD-shaped UNet in both packages with the adapters `kinds` loaded
    (the port from a safetensors file when `tmp_path` is given)."""
    jax_parts, torch_parts = sd_parts()
    jax_unet, jax_params = jax_parts["unet"]
    unet = torch_parts["unet"]
    ckpts = [checkpoint(kind, jax_unet, 16, seed=i) for i, kind in enumerate(kinds)]
    jax_params = jax_load_ip_adapter(jax_unet, jax_params, ckpts)
    sources = ckpts
    if tmp_path is not None:
        sources = []
        for i, ckpt in enumerate(ckpts):
            path = tmp_path / f"ip_{i}.safetensors"
            save_safetensors({f"{g}.{k}": torch.from_numpy(v) for g in ckpt for k, v in ckpt[g].items()}, path)
            sources.append(str(path))
    load_ip_adapter(unet, sources)
    return jax_unet, jax_params, unet


def _unet_call(jax_unet, jax_params, unet, embeds):
    rng = np.random.RandomState(9)
    sample, ehs = rng.randn(2, 4, 8, 8).astype(np.float32), rng.randn(2, 77, 16).astype(np.float32)
    jfn = jax.jit(lambda p, x, e, ie: jax_unet(p, x, jnp.asarray([500, 500]), encoder_hidden_states=e,
                                               added_cond_kwargs={"image_embeds": ie}).sample)
    ref = jfn(jax_params, jnp.asarray(sample), jnp.asarray(ehs), [jnp.asarray(e) for e in embeds])
    with torch.no_grad():
        out = unet(torch.from_numpy(sample), torch.tensor([500, 500]), torch.from_numpy(ehs),
                   added_cond_kwargs={"image_embeds": [torch.from_numpy(e) for e in embeds]}).sample
    return out, ref


@pytest.mark.parametrize("kinds", [("plus",), ("base", "full")], ids=["one-plus", "two-base-full"])
def test_unet_with_adapters_matches_jax(kinds, tmp_path):
    jax_unet, jax_params, unet = _unet_pair(kinds, tmp_path)
    embeds = [image_embeds(kind, 2, seed=10 + i) for i, kind in enumerate(kinds)]
    out, ref = _unet_call(jax_unet, jax_params, unet, embeds)
    assert _max_diff(out, ref) <= ATOL
    assert isinstance(unet.encoder_hid_proj, MultiIPAdapterImageProjection)
    assert all(a.ip_adapter_scale == [1.0] * len(kinds) for a in cross_attentions(unet))


def test_scale_zero_and_unload_restore_the_base_unet():
    jax_parts, torch_parts = sd_parts()
    unet = torch_parts["unet"]
    before = {k: v.clone() for k, v in unet.state_dict().items()}
    modules_before = [n for n, _ in unet.named_modules()]
    rng = np.random.RandomState(9)
    sample, ehs = torch.from_numpy(rng.randn(2, 4, 8, 8).astype(np.float32)), torch.from_numpy(
        rng.randn(2, 77, 16).astype(np.float32))
    with torch.no_grad():
        base = unet(sample, 500, ehs).sample
    jax_unet, jax_params, unet2 = _unet_pair(("base", "faceid"))
    unet = unet2  # same seed: the same base weights, now with two adapters
    embeds = [image_embeds("base", 2, seed=1), image_embeds("faceid", 2, seed=2)]
    cond = {"image_embeds": [torch.from_numpy(e) for e in embeds]}
    # scales per adapter, against JAX at the same scales
    set_ip_adapter_scale(unet, [0.5, 0.0])
    jax_set_ip_adapter_scale(jax_unet, [0.5, 0.0])
    out, ref = _unet_call(jax_unet, jax_params, unet, embeds)
    assert _max_diff(out, ref) <= ATOL and _max_diff(out, base) > ATOL
    # every adapter at scale 0 is skipped: the base UNet's output, bit for bit
    set_ip_adapter_scale(unet, 0.0)
    with torch.no_grad():
        np.testing.assert_array_equal(unet(sample, 500, ehs, added_cond_kwargs=cond).sample.numpy(), base.numpy())
    unload_ip_adapter(unet)
    assert [n for n, _ in unet.named_modules()] == modules_before
    after = unet.state_dict()
    assert after.keys() == before.keys() and all(torch.equal(after[k], before[k]) for k in before)
    with torch.no_grad():
        np.testing.assert_array_equal(unet(sample, 500, ehs).sample.numpy(), base.numpy())
    assert unet.encoder_hid_proj is None and all(a.to_k_ip is None for a in cross_attentions(unet))


# ---------------------------------------------------------------------------- pipelines


def sd_pipelines(kinds, scheduler="ddim"):
    jsched, tsched, cfg = SCHEDULERS[scheduler]
    jax_parts, torch_parts = sd_parts()
    jpipe = JaxStableDiffusionPipeline(tokenizer=CRCTokenizer(), scheduler=jsched(**cfg), **jax_parts)
    tpipe = StableDiffusionPipeline(tokenizer=CRCTokenizer(), scheduler=tsched(**cfg), device="cpu", **torch_parts)
    ckpts = [checkpoint(kind, jax_parts["unet"][0], 16, seed=i) for i, kind in enumerate(kinds)]
    jpipe.load_ip_adapter(ckpts)
    tpipe.load_ip_adapter(ckpts)
    return jpipe, tpipe


@pytest.mark.parametrize("kind", ["base", "plus"])
def test_sd_pipeline_ip_adapter_image_matches_jax(kind):
    """The image prompt encoded by each package's CLIP vision tower (the
    negative: zeros for the base head, the zero image's states for Plus),
    then the whole request; also `ip_adapter_image_embeds` given directly."""
    jpipe, tpipe = sd_pipelines([kind])
    kwargs = dict(num_inference_steps=3, guidance_scale=7.5, output_type="np")
    ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), ip_adapter_image=PIXELS, **kwargs).images)
    out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), ip_adapter_image=PIXELS, **kwargs).images
    assert out.shape == (1, 8, 8, 3) and _max_diff(out, ref) <= ATOL
    jembeds = jpipe.prepare_ip_adapter_image_embeds(PIXELS, 1, True)
    tembeds = tpipe.prepare_ip_adapter_image_embeds(PIXELS, 1, True)
    assert [tuple(e.shape) for e in tembeds] == [tuple(e.shape) for e in jembeds]
    assert _max_diff(tembeds[0], jembeds[0]) <= HEAD_ATOL
    given = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), ip_adapter_image_embeds=tembeds, **kwargs).images
    np.testing.assert_array_equal(given, out)
    plain = tpipe.unet.encoder_hid_proj
    tpipe.unload_ip_adapter()
    no_ip = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).images
    assert plain is not None and _max_diff(no_ip, out) > ATOL


def test_sd_pipeline_two_adapters_and_image_from_hwc():
    """Two adapters with their own images; an HWC uint8 image goes through
    `clip_image_preprocess` on the pipeline's device (JAX given the same
    pixel values)."""
    from diffusers_tpu_torch.models.text_encoders.clip import clip_image_preprocess, clip_processor_numbers

    jpipe, tpipe = sd_pipelines(["base", "plus"])
    hwc = (np.random.RandomState(6).rand(40, 36, 3) * 255).round().astype(np.uint8)
    numbers = dict(clip_processor_numbers(None), size=28, crop_size=(28, 28))
    tpipe.feature_extractor = type("FE", (), {"size": {"shortest_edge": 28}, "crop_size": {"height": 28, "width": 28},
                                              "image_mean": numbers["image_mean"], "image_std": numbers["image_std"],
                                              "rescale_factor": 1 / 255})()
    pixels = clip_image_preprocess(hwc, **numbers).numpy()
    jpipe.set_ip_adapter_scale([0.6, 0.8])
    tpipe.set_ip_adapter_scale([0.6, 0.8])
    kwargs = dict(num_inference_steps=2, guidance_scale=7.5, output_type="latent")
    ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), ip_adapter_image=[pixels, PIXELS], **kwargs).images)
    out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), ip_adapter_image=[hwc, PIXELS], **kwargs).images
    assert _max_diff(out, ref) <= ATOL


def test_sd_callback_path_keeps_the_image_prompt_jax_fault_h():
    """Fault (h): JAX's SD callback loop (`_denoise_eager`) calls the UNet
    without the image embeds, so with an IP-Adapter loaded a request with
    `callback_on_step_end` fails there (the UNet asks for them); the port's
    callback path keeps the image prompt, as upstream's does: with a no-op
    callback it gives the uncallbacked request's result bit for bit, and
    JAX's uncallbacked result within the tolerance."""
    jpipe, tpipe = sd_pipelines(["plus"])
    kwargs = dict(num_inference_steps=3, guidance_scale=7.5, output_type="latent", ip_adapter_image=PIXELS)
    with pytest.raises(ValueError, match="image_embeds"):
        jpipe(PROMPT, latents=jnp.asarray(LATENTS), callback_on_step_end=lambda p, i, t, k: k, **kwargs)
    ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), **kwargs).images)
    calls = []
    out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), callback_on_step_end=lambda p, i, t, k: calls.append(i) or {},
                **kwargs).images
    dense = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).images
    assert calls == [0, 1, 2]
    np.testing.assert_array_equal(out.numpy(), dense.numpy())
    assert _max_diff(out, ref) <= ATOL
    # with the CFG cutoff the image embeds follow the text: the positive half after the cutoff
    from diffusers_tpu_torch.callbacks import SDCFGCutoffCallback

    cut = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), callback_on_step_end=SDCFGCutoffCallback(
        cutoff_step_index=1), **kwargs).images
    assert torch.isfinite(cut).all() and _max_diff(cut, dense) > 0


def sdxl_pipelines(kind):
    jax_parts, torch_parts = _parts([
        ("unet", JaxUNet2DConditionModel, UNet2DConditionModel, UNET),
        ("vae", JaxAutoencoderKL, AutoencoderKL, VAE),
        ("text_encoder", JaxCLIPTextModel, CLIPTextModel, CLIP),
        ("text_encoder_2", JaxCLIPTextModelWithProjection, CLIPTextModelWithProjection, CLIP),
        ("image_encoder", JaxCLIPVision, CLIPVisionModelWithProjection, VISION),
    ], seed=0)
    jpipe = JaxStableDiffusionXLPipeline(tokenizer=CRCTokenizer(), tokenizer_2=CRCTokenizer(),
                                         scheduler=JaxEulerDiscreteScheduler(**EULER), **jax_parts)
    tpipe = StableDiffusionXLPipeline(tokenizer=CRCTokenizer(), tokenizer_2=CRCTokenizer(),
                                      scheduler=EulerDiscreteScheduler(**EULER), device="cpu", **torch_parts)
    ckpt = checkpoint(kind, jax_parts["unet"][0], UNET["cross_attention_dim"], seed=4)
    jpipe.load_ip_adapter(ckpt)
    tpipe.load_ip_adapter(ckpt)
    return jpipe, tpipe


@pytest.mark.parametrize("kind", ["base", "plus"])
def test_sdxl_pipeline_ip_adapter_matches_jax(kind):
    jpipe, tpipe = sdxl_pipelines(kind)
    assert len(cross_attentions(tpipe.unet)) == 8
    kwargs = dict(num_inference_steps=3, guidance_scale=5.0, output_type="np")
    ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), ip_adapter_image=PIXELS, **kwargs).images)
    out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), ip_adapter_image=PIXELS, **kwargs).images
    assert out.shape == (1, 8, 8, 3) and _max_diff(out, ref) <= ATOL
    embeds = tpipe.prepare_ip_adapter_image_embeds(PIXELS, 1, True)
    given = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), ip_adapter_image_embeds=embeds, **kwargs).images
    np.testing.assert_array_equal(given, out)
    # the caches JAX applies with image embeds run; FasterCache runs uncached, as in JAX
    from diffusers_tpu_torch.hooks import FasterCacheConfig

    tpipe.enable_cache(FasterCacheConfig())
    np.testing.assert_array_equal(tpipe(PROMPT, latents=torch.from_numpy(LATENTS), ip_adapter_image_embeds=embeds,
                                        **kwargs).images, out)
    tpipe.disable_cache()
    with pytest.raises(TypeError, match="CLIPVisionModelWithProjection"):
        StableDiffusionXLPipeline(**dict(tpipe.components, image_encoder=object(), device="cpu"))

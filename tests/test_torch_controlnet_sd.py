"""The port's Multi-ControlNet and the Stable Diffusion (1.x) ControlNet
pipelines against the JAX package on the CPU.

`MultiControlNetModel`: the residuals summed over the nets, JAX's
`ValueError` on a length mismatch, and the `controlnet`, `controlnet_1`, ...
directory layout read back by the port and by JAX. The pipelines
(text-to-image single and multi, img2img, inpaint) on
tests/test_torch_stable_diffusion.py's tiny SD 1.5-shaped components and a
tiny SD ControlNet (its conditioning embedding halves a 16 x 16 edge map to
the 8 x 8 latents), the port's seeded weights carried into JAX with
`convert_torch_state_dict`, both pipelines given the same numpy latents or
JAX's random draws (`test_torch_pipeline_img2img.draws`). Tolerances:
models max-abs `< 5e-4`, pipelines 5e-4 on the [0, 1] image (the SD twin's,
float32 on both sides).

Guess mode under CFG follows upstream diffusers, not JAX (ROADMAP C4): the
port is held to a loop composed here from JAX's own ControlNet, UNet and
PNDM at upstream's rule, and JAX's pipeline is shown to differ from it.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.models.controlnets.controlnet import ControlNetModel as JaxControlNetModel
from diffusers_tpu.models.controlnets.multicontrolnet import MultiControlNetModel as JaxMultiControlNetModel
from diffusers_tpu.models.modeling_utils import convert_torch_state_dict
from diffusers_tpu.pipelines.controlnet.pipeline_controlnet import (
    StableDiffusionControlNetPipeline as JaxSDControlNet,
)
from diffusers_tpu.pipelines.controlnet.pipeline_controlnet_img2img import (
    StableDiffusionControlNetImg2ImgPipeline as JaxSDControlNetImg2Img,
)
from diffusers_tpu.pipelines.controlnet.pipeline_controlnet_inpaint import (
    StableDiffusionControlNetInpaintPipeline as JaxSDControlNetInpaint,
)
from diffusers_tpu.schedulers.scheduling_pndm import PNDMScheduler as JaxPNDM
from diffusers_tpu_torch import StableDiffusionControlNetPipeline as RootExport
from diffusers_tpu_torch.models.controlnets import ControlNetModel, MultiControlNetModel
from diffusers_tpu_torch.pipelines.controlnet import (
    StableDiffusionControlNetImg2ImgPipeline,
    StableDiffusionControlNetInpaintPipeline,
    StableDiffusionControlNetPipeline,
)
from diffusers_tpu_torch.schedulers import PNDMScheduler
from test_torch_pipeline_img2img import IMAGE, MASK, SEED, draws  # noqa: F401 (draws: a fixture)
from test_torch_pipeline_sdxl import CRCTokenizer
from test_torch_stable_diffusion import PNDM, sd_parts
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

MODEL_ATOL = 5e-4
IMAGE_ATOL = 5e-4
PROMPT = "a lighthouse on a cliff at dusk"
# an SD 1.5-shaped ControlNet at tiny widths (UNET_SD's down half; no added embedding)
CN_SD = dict(
    in_channels=4, down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"), block_out_channels=(8, 16),
    layers_per_block=1, attention_head_dim=2, cross_attention_dim=16, norm_num_groups=4,
    use_linear_projection=False, conditioning_embedding_out_channels=(8, 16),
)
RNG = np.random.RandomState(5)
EDGES = (RNG.rand(16, 16, 3) > 0.7).astype(np.float32)  # binary edge maps, HWC
EDGES_2 = (RNG.rand(16, 16, 3) > 0.5).astype(np.float32)
LATENTS = RNG.randn(1, 4, 8, 8).astype(np.float32)
X = RNG.randn(2, 4, 8, 8).astype(np.float32)
EHS = RNG.randn(2, 77, 16).astype(np.float32)
CONDS = [RNG.rand(2, 3, 16, 16).astype(np.float32) for _ in range(2)]


def seeded_controlnet(cls=ControlNetModel, cfg=CN_SD, seed=11):
    """A port ControlNet from `seed`, its 1-D weights jittered."""
    torch.manual_seed(seed)
    tm = cls(**cfg).eval()
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in tm.parameters():
            if p.ndim == 1:
                p.add_(torch.from_numpy(0.1 * rng.randn(*p.shape).astype(np.float32)))
    return tm


def to_jax(jax_model, model):
    return convert_torch_state_dict(jax_model, {k: v.numpy() for k, v in model.state_dict().items()})


class JitVAE:
    """A JAX VAE whose `encode(...).sample(key)` and `decode(...).sample`
    run under `jax.jit` (the JAX image pipelines call the encode eagerly)."""

    def __init__(self, module):
        self._module = module
        self._encode = jax.jit(lambda p, x, k: module.encode(p, x).sample(k))
        self._decode = jax.jit(lambda p, z: module.decode(p, z).sample)

    def __getattr__(self, name):
        return getattr(self._module, name)

    def encode(self, params, x):
        return types.SimpleNamespace(sample=lambda key: self._encode(params, x, key))

    def decode(self, params, z):
        return types.SimpleNamespace(sample=self._decode(params, z))


def jit_vae(jpipe):
    jpipe.vae = (JitVAE(jpipe.vae[0]), jpipe.vae[1])
    return jpipe


def _max_diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


# ---------------------------------------------------------------------------- MultiControlNetModel


def _multi(n=2):
    nets = [seeded_controlnet(seed=11 + i) for i in range(n)]
    jnets = [JaxControlNetModel(**CN_SD) for _ in nets]
    return MultiControlNetModel(nets), JaxMultiControlNetModel(jnets), [to_jax(j, t) for j, t in zip(jnets, nets)]


@pytest.mark.parametrize("scale,guess_mode", [(0.7, False), ([0.6, 1.3], True)], ids=["one-scale", "scales-guess"])
def test_multicontrolnet_sums_like_jax(scale, guess_mode):
    multi, jmulti, params = _multi()
    ref = jax.jit(lambda p: jmulti(p, jnp.asarray(X), 421.0, jnp.asarray(EHS), [jnp.asarray(c) for c in CONDS],
                                   conditioning_scale=scale, guess_mode=guess_mode))(params)
    with torch.no_grad():
        out = multi(torch.from_numpy(X), 421.0, torch.from_numpy(EHS), [torch.from_numpy(c) for c in CONDS],
                    conditioning_scale=scale, guess_mode=guess_mode)
        scales = scale if isinstance(scale, list) else [scale] * 2
        singles = [net(torch.from_numpy(X), 421.0, torch.from_numpy(EHS), torch.from_numpy(c), conditioning_scale=s,
                       guess_mode=guess_mode) for net, c, s in zip(multi.nets, CONDS, scales)]
    mine = (*out.down_block_res_samples, out.mid_block_res_sample)
    for i, (a, b) in enumerate(zip(mine, (*ref.down_block_res_samples, ref.mid_block_res_sample))):
        assert a.shape == b.shape and _max_diff(a, b) < MODEL_ATOL
        parts = [(*s.down_block_res_samples, s.mid_block_res_sample)[i] for s in singles]
        assert torch.equal(a, parts[0] + parts[1])  # the sum, in net order


def test_multicontrolnet_length_mismatch_raises_like_jax():
    multi, jmulti, params = _multi()
    for images, scale in (([CONDS[0]], 1.0), (CONDS, [1.0, 0.5, 0.2])):
        with pytest.raises(ValueError, match="Expected 2 conditioning images/scales"):
            jmulti(params, jnp.asarray(X), 421.0, jnp.asarray(EHS), [jnp.asarray(c) for c in images],
                   conditioning_scale=scale)
        with pytest.raises(ValueError, match="Expected 2 conditioning images/scales"):
            multi(torch.from_numpy(X), 421.0, torch.from_numpy(EHS), [torch.from_numpy(c) for c in images],
                  conditioning_scale=scale)


def test_multicontrolnet_directory_layout(tmp_path):
    """`save_pretrained(dir)` writes `dir` and `dir_1`; the port reads them
    back bit-equal, and so does JAX's `MultiControlNetModel.from_pretrained`."""
    multi, _, params = _multi()
    multi.save_pretrained(tmp_path / "controlnet")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["controlnet", "controlnet_1"]
    back = MultiControlNetModel.from_pretrained(tmp_path / "controlnet", device="cpu")
    assert len(back) == 2 and isinstance(back.nets[1], ControlNetModel)
    for a, b in zip(multi.nets, back.nets):
        for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb)
    jback, jparams = JaxMultiControlNetModel.from_pretrained(tmp_path / "controlnet")
    assert len(jback) == 2
    for p, q in zip(jparams, params):
        jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)), p, q)
    with pytest.raises(ValueError, match="No ControlNets found"):
        MultiControlNetModel.from_pretrained(tmp_path / "absent", device="cpu")


# ---------------------------------------------------------------------------- the pipelines


def sd_controlnet_pipelines(jcls, tcls, n_nets=1):
    """(JAX pipeline, port pipeline) on the tiny SD components and `n_nets`
    seeded ControlNets (a list of them: a Multi-ControlNet)."""
    jax_parts, torch_parts = sd_parts()
    nets = [seeded_controlnet(seed=11 + i) for i in range(n_nets)]
    jnets = [(JaxControlNetModel(**CN_SD), None) for _ in nets]
    jnets = [(j, to_jax(j, t)) for (j, _), t in zip(jnets, nets)]
    jpipe = jit_vae(jcls(tokenizer=CRCTokenizer(), scheduler=JaxPNDM(**PNDM),
                         controlnet=jnets if n_nets > 1 else jnets[0], **jax_parts))
    tpipe = tcls(tokenizer=CRCTokenizer(), scheduler=PNDMScheduler(**PNDM), controlnet=nets if n_nets > 1 else nets[0],
                 device="cpu", **torch_parts)
    return jpipe, tpipe


@pytest.mark.parametrize("n_nets", [1, 2], ids=["single", "multi"])
def test_sd_controlnet_pipeline_matches_jax(n_nets):
    jpipe, tpipe = sd_controlnet_pipelines(JaxSDControlNet, StableDiffusionControlNetPipeline, n_nets)
    image = EDGES if n_nets == 1 else [EDGES, EDGES_2]
    scale = 0.8 if n_nets == 1 else [0.8, 0.6]
    kwargs = dict(image=image, height=8, width=8, num_inference_steps=3, guidance_scale=7.5,
                  controlnet_conditioning_scale=scale, output_type="np")
    ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), **kwargs).images)
    out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).images
    assert out.shape == (1, 8, 8, 3) and np.isfinite(out).all()
    assert _max_diff(out, ref) <= IMAGE_ATOL
    assert isinstance(tpipe.controlnet, MultiControlNetModel) == (n_nets == 2)
    assert tpipe.controlnet in tpipe.components.values() and RootExport is StableDiffusionControlNetPipeline
    with pytest.raises(TypeError, match="does not support cache config"):
        from diffusers_tpu_torch.hooks import TaylorSeerCacheConfig

        tpipe.enable_cache(TaylorSeerCacheConfig())


def test_sd_controlnet_img2img_matches_jax(draws):  # noqa: F811
    jpipe, tpipe = sd_controlnet_pipelines(JaxSDControlNetImg2Img, StableDiffusionControlNetImg2ImgPipeline)
    kwargs = dict(image=IMAGE, control_image=EDGES, strength=0.75, num_inference_steps=4, guidance_scale=7.5,
                  controlnet_conditioning_scale=0.9, output_type="np")
    ref = np.asarray(jpipe(PROMPT, key=jax.random.PRNGKey(SEED), **kwargs).images)
    out = tpipe(PROMPT, **kwargs).images
    assert not draws  # the port drew the encoder's sample, then the noise
    assert out.shape == (1, 8, 8, 3) and _max_diff(out, ref) <= IMAGE_ATOL


def test_sd_controlnet_inpaint_matches_jax(draws):  # noqa: F811
    """At JAX's defaults (strength 1.0: the init latents noised to the first
    timestep; scale 0.5), with the next-timestep blend."""
    jpipe, tpipe = sd_controlnet_pipelines(JaxSDControlNetInpaint, StableDiffusionControlNetInpaintPipeline)
    kwargs = dict(image=IMAGE, mask_image=MASK, control_image=EDGES, num_inference_steps=3, guidance_scale=7.5,
                  output_type="latent")
    ref = np.asarray(jpipe(PROMPT, key=jax.random.PRNGKey(SEED), **kwargs).images)
    out = tpipe(PROMPT, **kwargs).images.numpy()
    assert not draws
    assert out.shape == (1, 4, 8, 8) and _max_diff(out, ref) <= IMAGE_ATOL


def _upstream_guess_mode_latents(jpipe, steps, guidance_scale, scale):
    """SD guess mode under CFG at upstream's rule, composed from the JAX
    pipeline's CLIP, ControlNet, UNet and PNDM: the ControlNet sees the
    conditional half, the unconditional half's residuals are zeros."""
    unet, unet_params = jpipe.unet
    cn, cn_params = jpipe.controlnet
    sched = jpipe.scheduler
    cond = jnp.clip((jnp.asarray(jpipe.image_processor.preprocess(EDGES)) + 1) / 2, 0, 1)
    embeds = jpipe.encode_prompt(PROMPT, None, True)

    @jax.jit
    def noise_pred(latents, t, state):
        x = sched.scale_model_input(state, jnp.concatenate([latents, latents]), t)
        res = cn(cn_params, sched.scale_model_input(state, latents, t), jnp.broadcast_to(t, (1,)), embeds[1:], cond,
                 conditioning_scale=scale, guess_mode=True)
        down = tuple(jnp.concatenate([jnp.zeros_like(r), r]) for r in res.down_block_res_samples)
        mid = jnp.concatenate([jnp.zeros_like(res.mid_block_res_sample), res.mid_block_res_sample])
        out = unet(unet_params, x, jnp.broadcast_to(t, (2,)), encoder_hidden_states=embeds,
                   down_block_additional_residuals=down, mid_block_additional_residual=mid).sample
        uncond, text = jnp.split(out, 2)
        return uncond + guidance_scale * (text - uncond)

    state = sched.set_timesteps(steps)
    latents = jnp.asarray(LATENTS) * state.init_noise_sigma
    for t in state.timesteps:
        out = sched.step(state, noise_pred(latents, t, state), t, latents)
        latents, state = out.prev_sample, out.state
    return np.asarray(latents)


def test_sd_guess_mode_under_cfg_follows_upstream():
    """The port: upstream's rule (the composed loop; the UNet sees zeros as
    the unconditional half's residuals). JAX's pipeline runs the ControlNet
    on both halves and lands elsewhere (ROADMAP C4)."""
    jpipe, tpipe = sd_controlnet_pipelines(JaxSDControlNet, StableDiffusionControlNetPipeline)
    ref = _upstream_guess_mode_latents(jpipe, steps=3, guidance_scale=7.5, scale=0.8)
    kwargs = dict(image=EDGES, height=8, width=8, num_inference_steps=3, guidance_scale=7.5,
                  controlnet_conditioning_scale=0.8, guess_mode=True, output_type="latent")
    seen = []
    hook = tpipe.unet.register_forward_pre_hook(
        lambda mod, args, kw: seen.append(kw["mid_block_additional_residual"]), with_kwargs=True)
    try:
        out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).images.numpy()
    finally:
        hook.remove()
    assert _max_diff(out, ref) <= IMAGE_ATOL
    assert len(seen) == 4 and all(not m[0].any() and m[1].abs().max() > 0 for m in seen)  # PNDM: 3 steps, 4 calls
    jax_out = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), **kwargs).images)
    assert _max_diff(jax_out, ref) > 100 * IMAGE_ATOL  # JAX's both-halves rule

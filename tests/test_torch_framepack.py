"""The port's FramePack against the JAX package on the CPU: the transformer
with its 1x / 2x / 4x history streams, SigLIP image tokens and explicit frame
indices; the packed RoPE table with its centre-averaged history parts; and
`HunyuanVideoFramepackPipeline` over two sections in both sampling orders,
with and without `last_image`, every section's denoised latents and the
decoded, cross-faded video held to JAX's. `enable_cache` raises `TypeError`,
as JAX's pipeline honours no cache.

Tiny components: the transformer of JAX's fixture
(`tests/test_transformer_framepack.py`: 2 heads x 10, patch 2, image
projection from 12, history embedders) and the SigLIP of
`tests/test_pipeline_framepack.py` (12 wide, one layer, 32 px in patches of
8), beside tests/test_torch_pipeline_hunyuan_video.py's Llama, CLIP and VAE.
Images of 32 x 32 (4 x 4 latents), windows of 2 latent frames. JAX's draws
stand in for the port's `randn_tensor` in JAX's order of use (the image's
posterior, the last image's, then each section's latents), and JAX's VAE and
SigLIP run under `jax.jit`.

Tolerance: 5e-4 on the model, the latents and the [0, 1] frames (the
README's whole-pipeline bound), f32 on both sides; the tables exact.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.models.text_encoders.siglip import SiglipVisionModel as JaxSiglip
from diffusers_tpu.models.transformers.transformer_hunyuan_video_framepack import (
    HunyuanVideoFramepackTransformer3DModel as JaxFramepack,
)
from diffusers_tpu.pipelines.hunyuan_video import HunyuanVideoFramepackPipeline as JaxFramepackPipeline
from diffusers_tpu.schedulers import FlowMatchEulerDiscreteScheduler as JaxFlowMatch
import diffusers_tpu_torch.hooks as hooks
from diffusers_tpu_torch import (
    FlowMatchEulerDiscreteScheduler,
    HunyuanVideoFramepackPipeline,
    HunyuanVideoFramepackTransformer3DModel,
    SiglipVisionModel,
)
from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention_full
from diffusers_tpu_torch.utils import torch_utils
from test_torch_pipeline_hunyuan_video import TEMPLATE, WordTokenizer, hv_parts
from test_torch_pipeline_qwenimage import JitVAE
from test_torch_qwenimage import carry, seeded
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)
from test_torch_jit_reference import fast_randn as jax_randn

torch.set_num_threads(1)

ATOL = 5e-4
TINY = dict(in_channels=4, out_channels=4, num_attention_heads=2, attention_head_dim=10, num_layers=1,
            num_single_layers=1, num_refiner_layers=1, patch_size=2, patch_size_t=1, guidance_embeds=True,
            text_embed_dim=16, pooled_projection_dim=8, rope_axes_dim=(2, 4, 4), has_image_proj=True,
            image_proj_dim=12, has_clean_x_embedder=True)
SIGLIP = dict(hidden_size=12, intermediate_size=24, num_hidden_layers=1, num_attention_heads=2, image_size=32,
              patch_size=8)
PROMPT = "a sailing ship"
KEY_SEED = 3
WINDOW = 2
STEPS = 2
RNG = np.random.RandomState(0)
IMAGE, LAST_IMAGE = RNG.rand(1, 3, 32, 32).astype(np.float32), RNG.rand(1, 3, 32, 32).astype(np.float32)


def test_transformer_matches_jax():
    """Batch 2 with history at 1x, 2x and 4x (the 2x and 4x streams padded to
    their kernel), image tokens before a padded prompt, explicit indices."""
    tm = seeded(HunyuanVideoFramepackTransformer3DModel, TINY, seed=1)
    jm, params = carry(JaxFramepack, tm, TINY)
    rng = np.random.RandomState(2)
    ins = dict(hidden_states=rng.randn(2, 4, 2, 8, 8).astype(np.float32),
               timestep=np.array([500.0, 120.0], np.float32),
               encoder_hidden_states=rng.randn(2, 6, 16).astype(np.float32),
               encoder_attention_mask=np.array([[1, 1, 1, 1, 1, 1], [0, 1, 1, 0, 0, 0]], np.int64),
               pooled_projections=rng.randn(2, 8).astype(np.float32),
               image_embeds=rng.randn(2, 3, 12).astype(np.float32),
               guidance=np.array([6000.0, 6000.0], np.float32),
               latents_clean=rng.randn(2, 4, 2, 8, 8).astype(np.float32),
               latents_history_2x=rng.randn(2, 4, 3, 8, 8).astype(np.float32),
               latents_history_4x=rng.randn(2, 4, 5, 6, 6).astype(np.float32))
    indices = dict(indices_latents=np.arange(1, 3), indices_latents_clean=np.array([0, 3]),
                   indices_latents_history_2x=np.array([4, 5, 6]),
                   indices_latents_history_4x=np.array([7, 8, 9, 10, 11]))
    # JAX assembles its history tables on the host inside the call, which jit cannot trace: it gets
    # its `pack_rope` table, the port assembles its own from the indices
    rope = tuple(map(jnp.asarray, jm.pack_rope(8, 8, indices["indices_latents"], indices["indices_latents_clean"],
                                               indices["indices_latents_history_2x"],
                                               indices["indices_latents_history_4x"])))
    ref = np.asarray(jax.jit(lambda p, kw: jm(p, **kw, image_rotary_emb=rope).sample)(
        params, {k: jnp.asarray(v) for k, v in ins.items()}))
    with torch.no_grad():
        out = tm(**{k: torch.from_numpy(v) for k, v in ins.items()}, **indices).sample.numpy()
    assert out.shape == ref.shape == (2, 4, 2, 8, 8)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_packed_rope_matches_jax():
    """The [4x, 2x, clean, latents] table, bit-equal, at a grid the 4x pool
    pads (5 x 3 tokens)."""
    jm, tm = JaxFramepack(**TINY), HunyuanVideoFramepackTransformer3DModel(**TINY)
    kwargs = dict(height=10, width=6, indices_latents=np.arange(20, 22), indices_clean=np.array([0, 22]),
                  indices_2x=np.arange(23, 25), indices_4x=np.arange(25, 41))
    for ref, out in zip(jm.pack_rope(**kwargs), tm.pack_rope(**kwargs)):
        assert out.shape == ref.shape and np.array_equal(out, ref)


class JitSiglip:
    def __init__(self, module):
        self._fn = jax.jit(lambda p, x: module(p, x).last_hidden_state)

    def __call__(self, params, pixel_values):
        return types.SimpleNamespace(last_hidden_state=self._fn(params, pixel_values))


@functools.lru_cache(maxsize=None)
def build():
    jax_parts, torch_parts = hv_parts(seed=11, transformer_cls=HunyuanVideoFramepackTransformer3DModel,
                                      jax_transformer_cls=JaxFramepack, transformer_cfg=TINY)
    siglip = seeded(SiglipVisionModel, SIGLIP, seed=15)
    jsig = carry(JaxSiglip, siglip, SIGLIP)
    jv = jax_parts.pop("vae")
    jpipe = JaxFramepackPipeline(scheduler=JaxFlowMatch(shift=7.0), tokenizer=WordTokenizer(),
                                 tokenizer_2=WordTokenizer(), vae=(JitVAE(jv[0]), jv[1]),
                                 image_encoder=(JitSiglip(jsig[0]), jsig[1]), **jax_parts)
    tpipe = HunyuanVideoFramepackPipeline(scheduler=FlowMatchEulerDiscreteScheduler(shift=7.0),
                                          tokenizer=WordTokenizer(), tokenizer_2=WordTokenizer(),
                                          image_encoder=siglip, device="cpu", **torch_parts)
    return jpipe, tpipe


def _jax_draws(monkeypatch, shapes):
    """The port's `randn_tensor` returns JAX's draws: the keys the JAX
    pipeline splits off PRNGKey(KEY_SEED), one a draw, in order."""
    key, queue = jax.random.PRNGKey(KEY_SEED), []
    for shape in shapes:
        key, sub = jax.random.split(key)
        queue.append(np.array(jax_randn(shape, key=sub)))

    def randn_tensor(shape, generator=None, device=None):
        out = queue.pop(0)
        assert tuple(shape) == out.shape
        return torch.from_numpy(out).to(device)

    monkeypatch.setattr(torch_utils, "randn_tensor", randn_tensor)
    return queue


def _record(monkeypatch, jpipe, tpipe):
    """(JAX's, the port's) denoised latents of each section, in order."""
    jax_sections, port_sections = [], []
    jit = jpipe._jit

    def recording_jit(name, fn=None, **kwargs):
        compiled = jit(name, fn, **kwargs)
        if name != "denoise_section":
            return compiled

        def run(*args):
            out = compiled(*args)
            jax_sections.append(np.asarray(out))
            return out

        return run

    monkeypatch.setattr(jpipe, "_jit", recording_jit)
    denoise = tpipe._denoise_section

    def recording_denoise(*args):
        out = denoise(*args)
        port_sections.append(out.numpy())
        return out

    monkeypatch.setattr(tpipe, "_denoise_section", recording_denoise)
    return jax_sections, port_sections


REQUESTS = {
    "inverted": dict(sampling_type="inverted_anti_drifting"),
    "vanilla": dict(sampling_type="vanilla"),
    "inverted-last_image": dict(sampling_type="inverted_anti_drifting", last_image=LAST_IMAGE),
    "vanilla-true_cfg": dict(sampling_type="vanilla", negative_prompt="blurry", true_cfg_scale=2.0),
}


@pytest.mark.parametrize("name", list(REQUESTS))
def test_pipeline_sections_match_jax(name, monkeypatch):
    """Two sections of 2 latent frames: each section's latents, then the
    decoded video (the last section of the inverted order holds the image's
    latents too) against JAX's."""
    jpipe, tpipe = build()
    kwargs = dict(REQUESTS[name], prompt=PROMPT, height=32, width=32, num_frames=2 * ((WINDOW - 1) * 4 + 1),
                  latent_window_size=WINDOW, num_inference_steps=STEPS, guidance_scale=6.0, prompt_template=TEMPLATE,
                  max_sequence_length=8)
    jax_sections, port_sections = _record(monkeypatch, jpipe, tpipe)
    ref = np.asarray(jpipe(image=IMAGE, key=jax.random.PRNGKey(KEY_SEED), **kwargs).frames)
    posterior = (1, 4, 1, 4, 4)
    section = (1, 4, WINDOW, 4, 4)
    queue = _jax_draws(monkeypatch, [posterior] * (2 if "last_image" in kwargs else 1) + [section, section])
    flash_attention_full.launches = 0
    out = tpipe(image=IMAGE, **kwargs).frames
    assert flash_attention_full.launches == 0 and not queue
    assert len(jax_sections) == len(port_sections) == 2
    for k, (o, r) in enumerate(zip(port_sections, jax_sections)):
        assert o.shape == r.shape == section
        assert float(np.abs(o - r).max()) <= ATOL, (k, float(np.abs(o - r).max()))
    assert out.shape == ref.shape and out.shape[1] >= kwargs["num_frames"] and out.shape[-1] == 3
    assert float(np.abs(out - ref).max()) <= ATOL, float(np.abs(out - ref).max())


def test_enable_cache_raises():
    _, tpipe = build()
    with pytest.raises(TypeError, match="supported here: none"):
        tpipe.enable_cache(hooks.TaylorSeerCacheConfig())
    with pytest.raises(ValueError, match="sampling_type"):
        tpipe(image=IMAGE, prompt=PROMPT, height=32, width=32, sampling_type="backwards")

"""The port's `LTXImageToVideoPipeline` (the encoded first frame and its
frozen, timestep-0 tokens) and `LTXLatentUpsamplePipeline` (latents in,
AdaIN and tone mapping, latents out; a video in, decoded frames out)
against JAX's end to end on the CPU, on the components and with the draws
of tests/test_torch_ltx_condition.py (the port's `randn_tensor` returns
JAX's draws in the port's order of use, ROADMAP C3). Tolerance 5e-4 (the
README's whole-pipeline bound), f32 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusers_tpu_torch.hooks as hooks
from test_torch_ltx_condition import IMAGE, KEY_SEED, STEPS, VIDEO, _check, _queue, build
from test_torch_pipeline_ltx import PROMPT, TXT_LEN

torch.set_num_threads(1)


def test_image_to_video_matches_jax(monkeypatch):
    jpipe, tpipe = build("i2v")
    kwargs = dict(height=16, width=16, num_frames=5, num_inference_steps=STEPS, guidance_scale=3.0,
                  guidance_rescale=0.5, max_sequence_length=TXT_LEN, decode_timestep=0.05)
    key = jax.random.PRNGKey(KEY_SEED)
    ref = jpipe(IMAGE, PROMPT, key=key, **kwargs).frames
    keys = jax.random.split(key, 4)
    queue = _queue(monkeypatch, [(keys[1], (1, 8, 1, 4, 4)), (keys[2], (1, 8, 2, 4, 4)), (keys[3], (1, 8, 2, 4, 4))])
    out = tpipe(IMAGE, PROMPT, **kwargs).frames
    assert not queue
    _check(out, ref, (1, 5, 16, 16, 3))


def test_image_to_video_freezes_the_first_frame():
    """The first latent frame's tokens stay the encoded image's, bit for bit."""
    _, tpipe = build("i2v")
    gen = torch.Generator().manual_seed(0)
    out = tpipe(IMAGE, PROMPT, height=16, width=16, num_frames=5, num_inference_steps=2, generator=gen,
                max_sequence_length=TXT_LEN, output_type="latent").frames
    gen = torch.Generator().manual_seed(0)
    pixels = torch.from_numpy(2 * IMAGE.transpose(2, 0, 1)[None] - 1)
    vae = tpipe.vae
    init = tpipe._normalize_latents(vae.encode(pixels[:, :, None]).latent_dist.sample(gen), vae.latents_mean,
                                    vae.latents_std, vae.config.scaling_factor)
    assert torch.equal(out[:, :16], tpipe._pack_latents(init))
    with pytest.raises(TypeError, match="does not support cache config"):
        tpipe.enable_cache(hooks.TextKVCacheConfig())


@pytest.mark.parametrize("case", ["latents", "video"])
def test_latent_upsample_pipeline_matches_jax(case, monkeypatch):
    jpipe, tpipe = build("upsample")
    key = jax.random.PRNGKey(KEY_SEED)
    if case == "latents":
        latents = np.random.RandomState(4).randn(1, 8, 2, 4, 4).astype(np.float32)
        kwargs = dict(adain_factor=0.5, tone_map_compression_ratio=0.3, output_type="latent")
        ref = jpipe(latents=jnp.asarray(latents), key=key, **kwargs).frames
        out = tpipe(latents=torch.from_numpy(latents), **kwargs).frames
        _check(out, ref, (1, 8, 2, 8, 8))
        return
    kwargs = dict(height=16, width=16, adain_factor=1.0, decode_timestep=0.05, output_type="np")
    ref = jpipe(video=VIDEO[:5], key=key, **kwargs).frames
    keys = jax.random.split(key, 3)
    queue = _queue(monkeypatch, [(keys[1], (1, 8, 2, 4, 4)), (keys[2], (1, 8, 2, 8, 8))])
    out = tpipe(video=VIDEO[:5], **kwargs).frames
    assert not queue
    _check(out, ref, (1, 5, 32, 32, 3))

"""The port's `LTXConditionPipeline` against JAX's end to end on the CPU: an
image at frame 0 and a video at a nonzero `frame_index` (the lerp by
strength, the prefix tokens with their scaled video ids, the latent frames
lerped past the prefix, the per-token step clamp and update, the re-noising
of the hard conditioning tokens), and given latents under
`denoise_strength`. Its `build` and draw helpers serve tests/test_torch_ltx_i2v.py.

The components are tests/test_torch_pipeline_ltx.py's, with a non-dynamic
flow-match scheduler (the condition pipeline sets its own timesteps) and a
latent upsampler of 32 channels. The port's `randn_tensor` returns JAX's
draws, made by following JAX's key splits in the port's order of use
(ROADMAP C3). Tolerance 5e-4 on the frames and latents (the README's
whole-pipeline bound), f32 on both sides.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.pipelines.ltx import LTXConditionPipeline as JaxCondition
from diffusers_tpu.pipelines.ltx import LTXImageToVideoPipeline as JaxI2V
from diffusers_tpu.pipelines.ltx import LTXLatentUpsamplePipeline as JaxUpsample
from diffusers_tpu.pipelines.ltx import LTXVideoCondition as JaxLTXVideoCondition
from diffusers_tpu.pipelines.ltx.modeling_latent_upsampler import LTXLatentUpsamplerModel as JaxUpsampler
from diffusers_tpu.schedulers import FlowMatchEulerDiscreteScheduler as JaxFlowMatch
from diffusers_tpu_torch import (
    FlowMatchEulerDiscreteScheduler,
    LTXConditionPipeline,
    LTXImageToVideoPipeline,
    LTXLatentUpsamplePipeline,
    LTXLatentUpsamplerModel,
    LTXVideoCondition,
)
from diffusers_tpu_torch.utils import torch_utils
from test_torch_pipeline_ltx import PROMPT, TXT_LEN, ltx_parts
from test_torch_pipeline_qwenimage import JitVAE
from test_torch_pipeline_wan import MaskTokenizer
from test_torch_qwenimage import carry, seeded
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)
from test_torch_jit_reference import fast_randn as jax_randn

torch.set_num_threads(1)

ATOL = 5e-4
KEY_SEED = 5
STEPS = 3
FLOW = dict(shift=1.0)
UPSAMPLER = dict(in_channels=8, mid_channels=32, num_blocks_per_stage=1, dims=3)
IMAGE = np.random.RandomState(0).rand(16, 16, 3).astype(np.float32)
VIDEO = np.random.RandomState(1).rand(9, 16, 16, 3).astype(np.float32)  # [T, H, W, C] in [0, 1]


@functools.lru_cache(maxsize=None)
def build(kind):
    jax_parts, torch_parts = ltx_parts()
    jax_parts["vae"] = (JitVAE(jax_parts["vae"][0]), jax_parts["vae"][1])
    if kind == "upsample":
        up = seeded(LTXLatentUpsamplerModel, UPSAMPLER, seed=9)
        jpipe = JaxUpsample(vae=jax_parts["vae"], latent_upsampler=carry(JaxUpsampler, up, UPSAMPLER))
        return jpipe, LTXLatentUpsamplePipeline(vae=torch_parts["vae"], latent_upsampler=up, device="cpu")
    jcls, tcls = {"i2v": (JaxI2V, LTXImageToVideoPipeline), "condition": (JaxCondition, LTXConditionPipeline)}[kind]
    jpipe = jcls(scheduler=JaxFlowMatch(**FLOW), tokenizer=MaskTokenizer(), **jax_parts)
    tpipe = tcls(scheduler=FlowMatchEulerDiscreteScheduler(**FLOW), tokenizer=MaskTokenizer(), device="cpu",
                 **torch_parts)
    return jpipe, tpipe


def _queue(monkeypatch, draws):
    """The port's `randn_tensor` returns `draws` ((key, shape) pairs) in order."""
    queue = [np.array(jax_randn(shape, key=key)) for key, shape in draws]

    def randn_tensor(shape, generator=None, device=None):
        out = queue.pop(0)
        assert tuple(shape) == out.shape, (shape, out.shape)
        return torch.from_numpy(out).to(device)

    monkeypatch.setattr(torch_utils, "randn_tensor", randn_tensor)
    return queue


def _check(out, ref, shape):
    out = out.numpy() if isinstance(out, torch.Tensor) else out
    assert out.shape == np.shape(ref) == shape and np.isfinite(out).all()
    err = float(np.abs(out - np.asarray(ref)).max())
    assert err <= ATOL, err


def _condition_draws(key, steps, tokens, with_conditions=True):
    """JAX's draws of a condition request in the port's order: the base noise,
    each condition's encoder sample (and, at a nonzero index, its prefix
    noise), a re-noising draw a step, the decode noise."""
    key, _, decode_key = jax.random.split(key, 3)
    key, noise_key = jax.random.split(key)
    draws = [(noise_key, (1, 8, 5, 4, 4))]
    if with_conditions:
        key, enc_key, _ = jax.random.split(key, 3)
        draws.append((enc_key, (1, 8, 1, 4, 4)))  # the image at frame 0
        key, enc_key, cn_key = jax.random.split(key, 3)
        draws += [(enc_key, (1, 8, 3, 4, 4)), (cn_key, (1, 8, 2, 4, 4))]  # the video at frame 4, its 2 prefix frames
        key, scan_key = jax.random.split(key)
        draws += [(k, (1, tokens, 8)) for k in jax.random.split(scan_key, steps)]
    draws.append((decode_key, (1, 8, 5, 4, 4)))
    return draws


@pytest.mark.parametrize("case", ["conditions", "denoise_strength"])
def test_condition_pipeline_matches_jax(case, monkeypatch):
    jpipe, tpipe = build("condition")
    kwargs = dict(height=16, width=16, num_frames=17, num_inference_steps=STEPS, guidance_scale=3.0,
                  max_sequence_length=TXT_LEN, decode_timestep=0.05)
    key = jax.random.PRNGKey(KEY_SEED)
    latents = np.random.RandomState(3).randn(1, 8, 5, 4, 4).astype(np.float32)
    if case == "conditions":
        def conds(cls):
            return [cls(image=IMAGE, frame_index=0, strength=1.0), cls(video=VIDEO, frame_index=4, strength=0.8)]

        ref = jpipe(conditions=conds(JaxLTXVideoCondition), prompt=PROMPT, key=key, **kwargs).frames
        queue = _queue(monkeypatch, _condition_draws(key, STEPS, 80 + 32))
        out = tpipe(conditions=conds(LTXVideoCondition), prompt=PROMPT, **kwargs).frames
    else:
        ref = jpipe(prompt=PROMPT, latents=jnp.asarray(latents), denoise_strength=0.7, key=key, **kwargs).frames
        queue = _queue(monkeypatch, _condition_draws(key, STEPS, 80, with_conditions=False))
        out = tpipe(prompt=PROMPT, latents=torch.from_numpy(latents), denoise_strength=0.7, **kwargs).frames
    assert not queue
    _check(out, ref, (1, 17, 16, 16, 3))


def test_condition_pipeline_with_a_dynamic_shift_scheduler_raises_as_jax():
    """The condition pipeline sets its own timesteps without a mu, so a
    scheduler that shifts dynamically (LTX-Video's own config) raises in
    JAX and in the port alike (ROADMAP C4)."""
    jax_parts, torch_parts = ltx_parts()
    flow = dict(use_dynamic_shifting=True)
    jpipe = JaxCondition(scheduler=JaxFlowMatch(**flow), tokenizer=MaskTokenizer(), **jax_parts)
    tpipe = LTXConditionPipeline(scheduler=FlowMatchEulerDiscreteScheduler(**flow), tokenizer=MaskTokenizer(),
                                 device="cpu", **torch_parts)
    kwargs = dict(height=16, width=16, num_frames=9, num_inference_steps=2, max_sequence_length=TXT_LEN,
                  output_type="latent")
    with pytest.raises(ValueError, match="mu"):
        jpipe(prompt=PROMPT, key=jax.random.PRNGKey(0), **kwargs)
    with pytest.raises(ValueError, match="mu"):
        tpipe(prompt=PROMPT, **kwargs)

"""The port's `LTXPipeline` against JAX's end to end on the CPU: the dense
request to decoded frames (CFG with `guidance_rescale`, the dynamic shift,
the timestep-conditioned decode with `decode_timestep` and
`decode_noise_scale`), each of the six cache configs JAX's pipeline honours
(TaylorSeer, MagCache, TextKV, FirstBlockCache, FasterCache on the CFG
pair, PAB) with its transformer calls, and a step callback.

Tiny components: JAX's own fixture widths (`tests/test_pipeline_ltx.py`) at
2 blocks: the transformer 2 heads x 12, a 1-layer T5 (16 wide), a VAE 4x in
time and space with a timestep-conditioned decoder and non-trivial latent
statistics; 5 frames of 16 x 16 (2 x 4 x 4 latent tokens). The port's seeded
weights are carried into JAX with `convert_torch_state_dict`, both pipelines
get the same numpy latents, and the port's `randn_tensor` returns JAX's
decode noise.

Tolerance: 5e-4 on the latents and the [0, 1] frames (the README's
whole-pipeline bound), f32 on both sides. Each cached request differs from
the dense one by more than `ACTS` (the cache acts), except TextKV, which is
bit-equal to it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusers_tpu.hooks as jhooks
from diffusers_tpu.hooks.generic_cache import TextKVCacheConfig as JaxTextKV
from diffusers_tpu.hooks.pyramid_attention_broadcast import PyramidAttentionBroadcastConfig as JaxPAB
from diffusers_tpu.models.autoencoders.autoencoder_kl_ltx import AutoencoderKLLTXVideo as JaxLTXVAE
from diffusers_tpu.models.text_encoders.t5 import T5EncoderModel as JaxT5
from diffusers_tpu.models.transformers.transformer_ltx import LTXVideoTransformer3DModel as JaxLTX
from diffusers_tpu.pipelines.ltx.pipeline_ltx import LTXPipeline as JaxLTXPipeline
from diffusers_tpu.schedulers import FlowMatchEulerDiscreteScheduler as JaxFlowMatch
from diffusers_tpu.utils.jax_utils import randn_tensor as jax_randn
import diffusers_tpu_torch.hooks as hooks
from diffusers_tpu_torch import AutoencoderKLLTXVideo, FlowMatchEulerDiscreteScheduler, LTXPipeline, \
    LTXVideoTransformer3DModel
from diffusers_tpu_torch.models.text_encoders.t5 import T5EncoderModel
from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention_full
from diffusers_tpu_torch.utils import torch_utils
from test_torch_pipeline_wan import MaskTokenizer
from test_torch_qwenimage import carry, seeded

torch.set_num_threads(1)

ATOL = 5e-4
ACTS = 1e-4
PROMPT = "a river of stars"
STEPS = 6
TXT_LEN = 8
KEY_SEED = 2
LTX = dict(in_channels=8, out_channels=8, num_attention_heads=2, attention_head_dim=12, cross_attention_dim=24,
           num_layers=2, caption_channels=16)
VAE = dict(latent_channels=8, block_out_channels=(8, 8, 8, 8), decoder_block_out_channels=(8, 8, 8, 8),
           layers_per_block=(1, 1, 1, 1, 1), decoder_layers_per_block=(1, 1, 1, 1, 1),
           spatio_temporal_scaling=(True, True, False, False), decoder_spatio_temporal_scaling=(True, True, False, False),
           timestep_conditioning=True, patch_size=1)
T5 = dict(vocab_size=1000, d_model=16, d_kv=8, d_ff=32, num_layers=1, num_heads=2, feed_forward_proj="gated-gelu")
FLOW = dict(use_dynamic_shifting=True, base_shift=0.5, max_shift=1.15, base_image_seq_len=256, max_image_seq_len=4096)
CALL = dict(height=16, width=16, num_frames=5, guidance_scale=3.0, max_sequence_length=TXT_LEN)
LATENTS = np.random.RandomState(1).randn(1, 32, 8).astype(np.float32)  # 2 x 4 x 4 tokens


def ltx_vae(seed):
    """A seeded LTX VAE with non-trivial latent statistics."""
    vae = seeded(AutoencoderKLLTXVideo, VAE, seed)
    with torch.no_grad():
        vae.latents_mean.copy_(torch.linspace(-0.2, 0.3, 8))
        vae.latents_std.copy_(torch.linspace(0.5, 1.5, 8))
    return vae


def ltx_parts(seed=0):
    """({name: (JAX model, params)}, {name: port model}) of the tiny LTX components."""
    torch_parts = {"transformer": seeded(LTXVideoTransformer3DModel, LTX, seed), "vae": ltx_vae(seed + 1),
                   "text_encoder": seeded(T5EncoderModel, T5, seed + 2)}
    jax_parts = {name: carry(jcls, torch_parts[name], cfg) for name, jcls, cfg in (
        ("transformer", JaxLTX, LTX), ("vae", JaxLTXVAE, VAE), ("text_encoder", JaxT5, T5))}
    return jax_parts, torch_parts


@functools.lru_cache(maxsize=None)
def build():
    jax_parts, torch_parts = ltx_parts()
    jpipe = JaxLTXPipeline(scheduler=JaxFlowMatch(**FLOW), tokenizer=MaskTokenizer(), **jax_parts)
    tpipe = LTXPipeline(scheduler=FlowMatchEulerDiscreteScheduler(**FLOW), tokenizer=MaskTokenizer(), device="cpu",
                        **torch_parts)
    dense = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), num_inference_steps=STEPS, output_type="latent",
                  **CALL).frames
    return jpipe, tpipe, dense


def decode_noise(monkeypatch, shape=(1, 8, 2, 4, 4)):
    """The port's `randn_tensor` returns JAX's decode noise (the third key of
    the pipeline's split)."""
    queue = [np.array(jax_randn(shape, key=jax.random.split(jax.random.PRNGKey(KEY_SEED), 3)[2]))]

    def randn_tensor(shape, generator=None, device=None):
        out = queue.pop(0)
        assert tuple(shape) == out.shape
        return torch.from_numpy(out).to(device)

    monkeypatch.setattr(torch_utils, "randn_tensor", randn_tensor)
    return queue


def _calls(module):
    calls = []
    return calls, module.register_forward_pre_hook(lambda mod, args: calls.append(args[0].shape[0]))


def test_pipeline_matches_jax(monkeypatch):
    """The dense request to frames [B, F, H, W, C], with the rescale and the
    timestep-conditioned decode: one batch-2 call a step; no launch on the CPU."""
    jpipe, tpipe, _ = build()
    kwargs = dict(CALL, num_inference_steps=STEPS, guidance_rescale=0.7, decode_timestep=0.05,
                  decode_noise_scale=0.025)
    ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), key=jax.random.PRNGKey(KEY_SEED), **kwargs).frames)
    queue = decode_noise(monkeypatch)
    flash_attention_full.launches = 0
    calls, handle = _calls(tpipe.transformer)
    try:
        out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).frames
    finally:
        handle.remove()
    assert flash_attention_full.launches == 0 and not queue and calls == [2] * STEPS
    assert out.shape == ref.shape == (1, 5, 16, 16, 3) and out.min() >= 0 and out.max() <= 1
    assert float(np.abs(out - ref).max()) <= ATOL, float(np.abs(out - ref).max())


CONFIGS = {
    "taylorseer": lambda m: m.TaylorSeerCacheConfig(cache_interval=2, disable_cache_before_step=2, max_order=1),
    "mag_cache": lambda m: m.MagCacheConfig(threshold=0.5, max_skip_steps=1, retention_ratio=0.25,
                                            num_inference_steps=STEPS, mag_ratios=(1.0,) * STEPS),
    "text_kv": lambda m: hooks.TextKVCacheConfig() if m is hooks else JaxTextKV(),
    "first_block_cache": lambda m: m.FirstBlockCacheConfig(threshold=0.5),
    "faster_cache": lambda m: m.FasterCacheConfig(unconditional_batch_skip_range=3,
                                                  unconditional_batch_timestep_skip_range=(-1, 1000)),
    "pab": lambda m: (hooks.PyramidAttentionBroadcastConfig if m is hooks else JaxPAB)(
        spatial_attention_block_skip_range=2, spatial_attention_timestep_skip_range=(100, 950)),
}
# transformer calls of each request: a step's batch sizes (FasterCache: the pair or the cond call alone)
CALLS = {"taylorseer": [2, 2, 2, 2, 2], "mag_cache": None, "text_kv": [2] * STEPS, "first_block_cache": [2] * STEPS,
         "faster_cache": None, "pab": [2] * STEPS}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cache_matches_jax(name):
    jpipe, tpipe, dense = build()
    jpipe.enable_cache(CONFIGS[name](jhooks))
    tpipe.enable_cache(CONFIGS[name](hooks))
    calls, handle = _calls(tpipe.transformer)
    try:
        kwargs = dict(CALL, num_inference_steps=STEPS, output_type="latent")
        ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), **kwargs).frames)
        out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).frames
    finally:
        handle.remove()
        jpipe.disable_cache()
        tpipe.disable_cache()
    assert float(np.abs(out.numpy() - ref).max()) <= ATOL, float(np.abs(out.numpy() - ref).max())
    if name == "text_kv":
        assert torch.equal(out, dense)
    else:
        assert float((out - dense).abs().max()) > ACTS
    if name == "faster_cache":  # computed steps run the pair as two batch-1 calls, skipped ones the cond call
        assert set(calls) == {1} and STEPS < len(calls) < 2 * STEPS
    elif name == "mag_cache":
        assert set(calls) == {2} and len(calls) < STEPS
    elif name == "taylorseer":
        assert set(calls) == {2} and len(calls) < STEPS
    else:
        assert calls == CALLS[name]
    if name == "first_block_cache":
        assert tpipe.fbc_record["decisions"][0] and not all(tpipe.fbc_record["decisions"])


def test_callback_matches_jax_and_refuses_a_cache():
    """The callback is shown the latents after each step and may replace
    them, as JAX's generic callback; with a cache it raises."""
    jpipe, tpipe, _ = build()
    seen = []

    def callback(pipe, i, t, kwargs):
        seen.append(i)
        return {"latents": kwargs["latents"] * 0.95} if i == 2 else {}

    kwargs = dict(CALL, num_inference_steps=STEPS, output_type="latent", callback_on_step_end=callback)
    ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), **kwargs).frames)
    seen.clear()
    out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).frames
    assert seen == list(range(STEPS))
    assert float(np.abs(out.numpy() - ref).max()) <= ATOL
    tpipe.enable_cache(hooks.TextKVCacheConfig())
    try:
        with pytest.raises(ValueError, match="callback_on_step_end"):
            tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs)
    finally:
        tpipe.disable_cache()


def test_faster_cache_without_cfg_raises_as_in_jax():
    _, tpipe, _ = build()
    tpipe.enable_cache(CONFIGS["faster_cache"](hooks))
    try:
        with pytest.raises(ValueError, match="does not support cache config"):
            tpipe(PROMPT, latents=torch.from_numpy(LATENTS), num_inference_steps=2, output_type="latent",
                  **dict(CALL, guidance_scale=1.0))
    finally:
        tpipe.disable_cache()


def test_save_and_from_pretrained_round_trip(tmp_path):
    """The LTX pipeline and the latent-upsample pipeline through
    `save_pretrained` and `DiffusionPipeline.from_pretrained`: the registered
    classes, every component bit-equal (the VAE's latent statistics buffers
    too), the same latents."""
    from diffusers_tpu_torch import DiffusionPipeline, LTXLatentUpsamplePipeline, LTXLatentUpsamplerModel
    from test_torch_qwenimage import seeded as seeded_model

    _, tpipe, dense = build()
    tpipe.save_pretrained(tmp_path / "ltx")
    loaded = DiffusionPipeline.from_pretrained(tmp_path / "ltx", device="cpu", tokenizer=MaskTokenizer())
    assert type(loaded).__name__ == "LTXPipeline"
    for name in ("transformer", "text_encoder", "vae"):
        state = getattr(tpipe, name).state_dict()
        assert all(torch.equal(v, state[k]) for k, v in getattr(loaded, name).state_dict().items()), name
    out = loaded(PROMPT, latents=torch.from_numpy(LATENTS), num_inference_steps=STEPS, output_type="latent",
                 **CALL).frames
    assert torch.equal(out, dense)

    up = seeded_model(LTXLatentUpsamplerModel, dict(in_channels=8, mid_channels=32, num_blocks_per_stage=1), seed=3)
    LTXLatentUpsamplePipeline(vae=tpipe.vae, latent_upsampler=up, device="cpu").save_pretrained(tmp_path / "up")
    again = DiffusionPipeline.from_pretrained(tmp_path / "up", device="cpu")
    assert type(again).__name__ == "LTXLatentUpsamplePipeline"
    assert all(torch.equal(v, up.state_dict()[k]) for k, v in again.latent_upsampler.state_dict().items())

"""The port's `WanPipeline` against the JAX `WanPipeline` end to end on the CPU:
the dense loop, each of the six caches, a step callback and FreeInit, and the
512 / 226 text-length defaults.

Tiny components: a Wan transformer of 2 layers (2 heads x 12), a 2-layer
UMT5, a one-level VAE (2x in time and space, the mid-block attention), with
non-trivial `latents_mean` / `latents_std`; UniPC with flow prediction and
flow shift 3.0, Wan's. The port's seeded weights (1-D ones jittered) are
carried into JAX with `convert_torch_state_dict`; both pipelines get the same
numpy latents and a deterministic tokenizer with an attention mask. For
FreeInit the port's one `randn_tensor` is made to return JAX's draws.

Tolerance: `2e-4` on the latents and on the [0, 1] frames, float32 on both
sides, so the differences are summation order (measured below 1e-6). Each
cached request also differs from the port's dense latents by more than
`ACTS` = 1e-4 (the cache acts), and its transformer calls follow the cache's
schedule.
"""

import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusers_tpu.hooks as jhooks
from diffusers_tpu.hooks.generic_cache import TextKVCacheConfig as JaxTextKVCacheConfig
from diffusers_tpu.hooks.pyramid_attention_broadcast import (
    PyramidAttentionBroadcastConfig as JaxPyramidAttentionBroadcastConfig,
)
from diffusers_tpu.models.autoencoders.autoencoder_kl_wan import AutoencoderKLWan as JaxVAE
from diffusers_tpu.models.text_encoders.t5 import UMT5EncoderModel as JaxUMT5
from diffusers_tpu.models.transformers.transformer_wan import WanTransformer3DModel as JaxWan
from diffusers_tpu.pipelines.wan.pipeline_wan import WanPipeline as JaxWanPipeline
from diffusers_tpu.schedulers import UniPCMultistepScheduler as JaxUniPC
from diffusers_tpu.utils.jax_utils import randn_tensor as jax_randn
import diffusers_tpu_torch.hooks as hooks
from diffusers_tpu_torch import (
    AutoencoderKLWan,
    UMT5EncoderModel,
    UniPCMultistepScheduler,
    WanPipeline,
    WanTransformer3DModel,
)
from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention_full
from diffusers_tpu_torch.utils import torch_utils
from test_torch_pipeline_cache import _parts

torch.set_num_threads(1)

ATOL = 2e-4
ACTS = 1e-4
PROMPT = "a robot dancing in the rain"
STEPS = 6
TXT_LEN = 16
WAN = dict(patch_size=(1, 2, 2), num_attention_heads=2, attention_head_dim=12, in_channels=4, out_channels=4,
           text_dim=16, freq_dim=16, ffn_dim=32, num_layers=2, cross_attn_norm=True, rope_max_seq_len=64)
VAE = dict(base_dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1, temperal_downsample=(True,),
           latents_mean=[0.1, -0.2, 0.0, 0.3], latents_std=[1.0, 0.5, 2.0, 1.5], scale_factor_temporal=2,
           scale_factor_spatial=2)
UMT5 = dict(vocab_size=1000, d_model=16, d_kv=8, d_ff=32, num_layers=2, num_heads=2, feed_forward_proj="gated-gelu")
UNIPC = dict(prediction_type="flow_prediction", use_flow_sigmas=True, flow_shift=3.0)
LATENTS = np.random.RandomState(1).randn(1, 4, 3, 8, 8).astype(np.float32)  # 5 frames of 16 x 16
CALL = dict(height=16, width=16, num_frames=5, guidance_scale=5.0)


class MaskTokenizer:
    """Deterministic tokenizer stand-in: 5 ids from a CRC of the prompt, EOS
    (1), padding with 0, and the attention mask over the 6 tokens."""

    def __call__(self, prompts, padding=None, max_length=TXT_LEN, truncation=True, return_tensors="np"):
        class Out:
            pass

        ids = []
        for p in prompts:
            h = zlib.crc32(p.encode("utf-8"))
            ids.append(([(h + i * 31) % 900 + 2 for i in range(5)] + [1] + [0] * max_length)[:max_length])
        out = Out()
        out.input_ids = np.array(ids, dtype=np.int64)
        out.attention_mask = (out.input_ids != 0).astype(np.int64)
        return out


class JitReference:
    """A JAX module whose sub-calls that JAX's Wan pipelines make outside
    their jitted loops (the VAE's `encode(...).mode()` and `decode(...).sample`,
    a vision tower's hidden states, Animate's `encode_face_motion`) run
    under `jax.jit`: the same functions, compiled once a shape instead of
    dispatched op by op. Anything else is the module's own."""

    def __init__(self, module):
        self._module = module
        self._encode = jax.jit(lambda p, x: module.encode(p, x).mode())
        self._decode = jax.jit(lambda p, z: module.decode(p, z).sample)
        self._hidden = jax.jit(lambda p, x: tuple(module(p, x, output_hidden_states=True).hidden_states))
        self._face = jax.jit(lambda p, x: module.encode_face_motion(p, x))

    def __getattr__(self, name):
        return getattr(self._module, name)

    def __call__(self, params, *args, **kwargs):
        if kwargs == {"output_hidden_states": True} and len(args) == 1:
            return types.SimpleNamespace(hidden_states=self._hidden(params, *args))
        return self._module(params, *args, **kwargs)

    def encode(self, params, x):
        z = self._encode(params, x)
        return types.SimpleNamespace(mode=lambda: z)

    def decode(self, params, z):
        return types.SimpleNamespace(sample=self._decode(params, z))

    def encode_face_motion(self, params, x):
        return self._face(params, x)


def jit_reference(jpipe, names=("vae", "image_encoder", "transformer")):
    """`jpipe` with its components `names` wrapped in `JitReference`."""
    for name in names:
        part = getattr(jpipe, name, None)
        if part is not None and part[0] is not None:
            setattr(jpipe, name, (JitReference(part[0]), part[1]))
    return jpipe


def build():
    jax_parts, torch_parts = _parts([("vae", JaxVAE, AutoencoderKLWan, VAE),
                                     ("text_encoder", JaxUMT5, UMT5EncoderModel, UMT5),
                                     ("transformer", JaxWan, WanTransformer3DModel, WAN)], seed=0)
    jpipe = JaxWanPipeline(tokenizer=MaskTokenizer(), scheduler=JaxUniPC(**UNIPC), **jax_parts)
    tpipe = WanPipeline(tokenizer=MaskTokenizer(), scheduler=UniPCMultistepScheduler(**UNIPC), device="cpu",
                        **torch_parts)
    return jpipe, tpipe


def _run_pair(jpipe, tpipe, output_type="latent", steps=STEPS, **kw):
    kwargs = dict(CALL, num_inference_steps=steps, max_sequence_length=TXT_LEN, output_type=output_type, **kw)
    ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), **kwargs).frames)
    out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).frames
    out = out.numpy() if isinstance(out, torch.Tensor) else out
    assert out.shape == ref.shape and out.dtype == np.float32 and np.isfinite(out).all()
    return ref, out


@pytest.fixture(scope="module")
def pair():
    jpipe, tpipe = build()
    dense = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), num_inference_steps=STEPS,
                  max_sequence_length=TXT_LEN, output_type="latent", **CALL).frames.numpy()
    return jpipe, tpipe, dense


def _calls(module):
    calls = []
    return calls, module.register_forward_pre_hook(lambda mod, args: calls.append(args[0].shape[0]))


def test_pipeline_matches_jax(pair):
    """The dense request to decoded frames [B, F, H, W, C]; no kernel launch on the CPU."""
    jpipe, tpipe, _ = pair
    flash_attention_full.launches = 0
    calls, handle = _calls(tpipe.transformer)
    try:
        ref, out = _run_pair(jpipe, tpipe, output_type="np")
    finally:
        handle.remove()
    assert flash_attention_full.launches == 0  # CPU tensors took the plain version
    assert out.shape == (1, 5, 16, 16, 3) and out.min() >= 0 and out.max() <= 1
    assert calls == [1] * (2 * STEPS)  # CFG as two batch-1 forwards a step
    assert float(np.abs(out - ref).max()) <= ATOL, float(np.abs(out - ref).max())


def test_encode_prompt_zeroes_the_padding(pair):
    _, tpipe, _ = pair
    embeds, negative = tpipe.encode_prompt(PROMPT, "blurry", max_sequence_length=TXT_LEN)
    assert embeds.shape == negative.shape == (1, TXT_LEN, 16)
    assert torch.count_nonzero(embeds[:, 6:]) == 0 and torch.count_nonzero(embeds[:, :6]) > 0


CONFIGS = {
    "taylorseer": lambda m: m.TaylorSeerCacheConfig(cache_interval=2, disable_cache_before_step=2, max_order=1),
    "mag_cache": lambda m: m.MagCacheConfig(threshold=0.5, max_skip_steps=1, retention_ratio=0.25,
                                            num_inference_steps=STEPS, mag_ratios=(1.0,) * STEPS),
    "faster_cache": lambda m: m.FasterCacheConfig(unconditional_batch_skip_range=3,
                                                  unconditional_batch_timestep_skip_range=(-1, 1000)),
    "pab": lambda m: (hooks.PyramidAttentionBroadcastConfig if m is hooks else JaxPyramidAttentionBroadcastConfig)(
        spatial_attention_block_skip_range=2, spatial_attention_timestep_skip_range=(100, 950)),
    "first_block_cache": lambda m: m.FirstBlockCacheConfig(threshold=0.5),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cache_matches_jax(pair, name):
    jpipe, tpipe, dense = pair
    transformer = tpipe.transformer
    calls, h1 = _calls(transformer)
    tail, h2 = _calls(transformer.blocks[1])
    attn, h3 = _calls(transformer.blocks[1].attn1)
    jpipe.enable_cache(CONFIGS[name](jhooks))
    tpipe.enable_cache(CONFIGS[name](hooks))
    try:
        ref, out = _run_pair(jpipe, tpipe)
    finally:
        jpipe.disable_cache()
        tpipe.disable_cache()
        for h in (h1, h2, h3):
            h.remove()
    assert float(np.abs(out - ref).max()) <= ATOL, float(np.abs(out - ref).max())
    assert float(np.abs(out - dense).max()) > ACTS, "the cache did not act"
    # a skipped step makes no transformer call, or none of what it skips
    if name == "taylorseer":  # computes at steps 0, 1, 3, 5
        assert calls == [1] * 8
    elif name == "mag_cache":
        assert len(calls) == 2 * 4
    elif name == "faster_cache":  # both branches at steps 0 and 3, the cond branch alone at 1, 2, 4, 5
        assert len(calls) == 2 + 1 + 1 + 2 + 1 + 1
    elif name == "pab":
        assert len(calls) == len(tail) == 2 * STEPS and 0 < len(attn) < 2 * STEPS
    else:
        record = tpipe.fbc_record
        decisions = record["cond"]["decisions"] + record["uncond"]["decisions"]
        assert len(calls) == len(decisions) == 2 * STEPS and record["cond"]["decisions"][0]
        assert not all(decisions) and len(tail) == sum(decisions)


def test_text_kv_is_the_uncached_path(pair):
    """TextKV: the text embedder once per context and each cross attention's
    K/V once per context (cond and uncond) a request; the latents bit-equal
    to the dense path's."""
    jpipe, tpipe, dense = pair
    embedder, h1 = _calls(tpipe.transformer.condition_embedder.text_embedder)
    to_k, h2 = _calls(tpipe.transformer.blocks[0].attn2.to_k)
    jpipe.enable_cache(JaxTextKVCacheConfig())
    tpipe.enable_cache(hooks.TextKVCacheConfig())
    try:
        ref, out = _run_pair(jpipe, tpipe)
    finally:
        jpipe.disable_cache()
        tpipe.disable_cache()
        h1.remove()
        h2.remove()
    assert len(embedder) == 2 and len(to_k) == 2
    np.testing.assert_array_equal(out, dense)
    assert float(np.abs(out - ref).max()) <= ATOL
    assert all(m.text_kv is None for m in tpipe.transformer.modules() if hasattr(m, "text_kv"))


def test_callback_matches_jax(pair):
    jpipe, tpipe, dense = pair
    seen = []

    def callback(pipe, i, t, kwargs):
        seen.append((i, sorted(kwargs)))
        return {"latents": kwargs["latents"] * 0.5} if i == 2 else {}

    ref, out = _run_pair(jpipe, tpipe, callback_on_step_end=callback)
    assert float(np.abs(out - ref).max()) <= ATOL
    assert float(np.abs(out - dense).max()) > ACTS
    port_seen = seen[len(seen) // 2:]
    assert [s[0] for s in port_seen] == list(range(STEPS))
    assert port_seen[0][1] == ["guidance_scale", "latents", "negative_prompt_embeds", "prompt_embeds"]
    tpipe.enable_cache(hooks.TaylorSeerCacheConfig())
    try:
        with pytest.raises(ValueError, match="callback_on_step_end cannot"):
            tpipe(PROMPT, num_inference_steps=2, callback_on_step_end=callback, output_type="latent",
                  max_sequence_length=TXT_LEN, **CALL)
    finally:
        tpipe.disable_cache()


def test_free_init_matches_jax(pair, monkeypatch):
    """Two FreeInit passes with fast sampling (3, then 6 steps): the port's
    fresh noise is JAX's draw from the split key."""
    jpipe, tpipe, dense = pair
    _, reinit = jax.random.split(jax.random.PRNGKey(0))  # JAX's second pass draws from this key
    draws = [np.array(jax_randn(LATENTS.shape, key=reinit, dtype=jnp.float32))]

    def randn_tensor(shape, generator=None, device=None):
        out = draws.pop(0)
        assert tuple(shape) == out.shape
        return torch.from_numpy(out).to(device)

    monkeypatch.setattr(torch_utils, "randn_tensor", randn_tensor)
    for pipe in (jpipe, tpipe):
        pipe.enable_free_init(num_iters=2, use_fast_sampling=True)
    try:
        ref, out = _run_free_init(jpipe, tpipe)
    finally:
        jpipe.disable_free_init()
        tpipe.disable_free_init()
    assert not draws  # the port drew the fresh noise once
    assert float(np.abs(out - ref).max()) <= ATOL, float(np.abs(out - ref).max())
    assert float(np.abs(out - dense).max()) > ACTS


def _run_free_init(jpipe, tpipe):
    kwargs = dict(CALL, num_inference_steps=STEPS, max_sequence_length=TXT_LEN, output_type="latent")
    ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), key=jax.random.PRNGKey(0), **kwargs).frames)
    out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).frames.numpy()
    return ref, out


def test_text_length_defaults_diverge(pair):
    """The port defaults to 512 text tokens (upstream diffusers, Wan's trained
    length), JAX to 226. The cross attention has no mask, so the zeroed
    padding counts: the two defaults give different videos, and each side at
    the other's length agrees with the other."""
    jpipe, tpipe, _ = pair
    kwargs = dict(CALL, num_inference_steps=2, output_type="latent")
    jax_default = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), **kwargs).frames)
    port_default = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).frames.numpy()
    port_226 = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), max_sequence_length=226, **kwargs).frames.numpy()
    port_512 = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), max_sequence_length=512, **kwargs).frames.numpy()
    np.testing.assert_array_equal(port_default, port_512)
    assert float(np.abs(port_226 - jax_default).max()) <= ATOL
    assert float(np.abs(port_default - jax_default).max()) > 1e-3


def test_pipeline_defaults_to_the_card(pair, monkeypatch):
    """Built without `device`, the pipeline goes to "cuda"; with no card
    visible it raises instead of running on the CPU."""
    _, tpipe, _ = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WanPipeline(**tpipe.components)

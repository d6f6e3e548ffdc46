"""The port's SkyReels-V2 transformer and text-to-video pipeline against the
JAX package on the CPU.

Tiny components at tests/test_skyreels.py's widths: a transformer of 2
layers of 2 heads x 12, standard (one frame a block, no fps), causal (2
frames a block: a bool keep-mask on every self attention) with fps
injection, and under diffusion forcing ([B, F'] timesteps broadcast to a
modulation a token); a 2-layer UMT5 and a one-level VAE for the pipeline.
The port's seeded weights (1-D ones jittered) go to JAX with
`convert_torch_state_dict`; both sides take the same numpy inputs, float32.

Tolerances: 5e-4 for the transformer in each config and for the pipeline
to decoded frames (measured below 1e-5); the block-causal mask exactly JAX's.

The reference-side fault shown on both sides (ROADMAP C4 (g)): JAX's
pipeline passes no fps, so a transformer with `inject_sample_info` fails
inside `jnp.asarray(None)` (ValueError); the port's pipeline refuses such a transformer
with ValueError before it runs, and its transformer raises ValueError
without an fps.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.models.autoencoders.autoencoder_kl_wan import AutoencoderKLWan as JaxVAE
from diffusers_tpu.models.modeling_utils import flatten_to_torch_state_dict
from diffusers_tpu.models.text_encoders.t5 import UMT5EncoderModel as JaxUMT5
from diffusers_tpu.models.transformers.transformer_skyreels_v2 import SkyReelsV2Transformer3DModel as JaxSkyReels
from diffusers_tpu.pipelines.skyreels_v2 import SkyReelsV2Pipeline as JaxSkyReelsPipeline
from diffusers_tpu.schedulers import UniPCMultistepScheduler as JaxUniPC
from diffusers_tpu_torch import (
    AutoencoderKLWan,
    SkyReelsV2Pipeline,
    SkyReelsV2Transformer3DModel,
    UMT5EncoderModel,
    UniPCMultistepScheduler,
)
from diffusers_tpu_torch.models.modeling_utils import load_jax_params
from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention_full
from test_torch_pipeline_cache import _parts
from test_torch_pipeline_wan import UMT5, VAE, MaskTokenizer, jit_reference

torch.set_num_threads(1)

ATOL = 5e-4
PROMPT = "a lighthouse in a storm, waves crashing"
TXT_LEN = 16
STEPS = 3
TINY = dict(patch_size=(1, 2, 2), num_attention_heads=2, attention_head_dim=12, in_channels=4, out_channels=4,
            text_dim=16, freq_dim=32, ffn_dim=32, num_layers=2, cross_attn_norm=True, inject_sample_info=False,
            num_frame_per_block=1)
CAUSAL_FPS = dict(TINY, num_frame_per_block=2, inject_sample_info=True)
UNIPC = dict(prediction_type="flow_prediction", use_flow_sigmas=True, flow_shift=8.0)
CALL = dict(height=16, width=16, num_frames=5, guidance_scale=6.0)
LATENTS = np.random.RandomState(1).randn(1, 4, 3, 8, 8).astype(np.float32)  # 5 frames of 16 x 16


def _models(cfg, seed=0):
    jp, tp = _parts([("transformer", JaxSkyReels, SkyReelsV2Transformer3DModel, cfg)], seed=seed)
    return jp["transformer"], tp["transformer"]


CASES = {
    # (config, batch, timesteps, transformer keyword arguments)
    "standard": (TINY, 2, np.array([500.0, 100.0], np.float32), {}),
    "causal_fps": (CAUSAL_FPS, 1, np.array([300.0], np.float32), {"fps": [1]}),
    "diffusion_forcing": (TINY, 1, np.array([[100.0, 200.0, 300.0, 400.0]], np.float32),
                          {"enable_diffusion_forcing": True}),
    "diffusion_forcing_fps": (CAUSAL_FPS, 1, np.array([[50.0, 50.0, 700.0, 700.0]], np.float32),
                              {"enable_diffusion_forcing": True, "fps": [0]}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_transformer_matches_jax(case):
    """Standard; 2 frames a block with fps injection; diffusion forcing (a
    timestep a latent frame), with and without the mask and fps; 5e-4."""
    cfg, b, t, kw = CASES[case]
    (jm, params), model = _models(cfg, seed=len(case))
    rng = np.random.RandomState(len(case))
    x = rng.randn(b, 4, 4, 8, 8).astype(np.float32)
    ehs = rng.randn(b, 6, 16).astype(np.float32)
    jkw = {k: jnp.asarray(v) if k == "fps" else v for k, v in kw.items()}
    flags = {k: v for k, v in jkw.items() if k == "enable_diffusion_forcing"}
    arrays = {k: v for k, v in jkw.items() if k not in flags}
    ref = np.asarray(jax.jit(lambda p, *a, **kw: jm(p, *a, **kw, **flags).sample)(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ehs), **arrays))
    flash_attention_full.launches = 0
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ehs), **kw).sample.numpy()
    assert flash_attention_full.launches == 0
    assert out.shape == ref.shape == x.shape
    assert float(np.abs(out - ref).max()) <= ATOL, float(np.abs(out - ref).max())


@pytest.mark.parametrize("grid", [(4, 4, 4), (6, 2, 3), (21, 1, 2)])
def test_causal_mask_is_jax(grid):
    """JAX's keep-mask exactly; a frame count that does not split into
    blocks raises ValueError on both sides."""
    (jm, _), model = _models(CAUSAL_FPS, seed=2)
    if grid[0] % 2:
        with pytest.raises(ValueError):
            jm._causal_mask(*grid)
        with pytest.raises(ValueError, match="do not split into blocks"):
            model.causal_mask(*grid)
        return
    np.testing.assert_array_equal(model.causal_mask(*grid), jm._causal_mask(*grid))
    assert model.causal_mask(*grid).shape == (1, 1, np.prod(grid), np.prod(grid))
    _, standard = _models(TINY, seed=2)
    assert standard.causal_mask(*grid) is None


def test_transformer_fps_required_and_state_dicts(tmp_path):
    """Without fps a model with `inject_sample_info` raises; the fps
    embedding and projection round-trip through JAX's flatten and
    `load_jax_params`, and through `save_pretrained` / `from_pretrained`."""
    (jm, params), model = _models(CAUSAL_FPS, seed=7)
    with pytest.raises(ValueError, match="needs `fps`"):
        model(torch.zeros(1, 4, 2, 8, 8), torch.zeros(1), torch.zeros(1, 6, 16))
    state = model.state_dict()
    assert {"fps_embedding.weight", "fps_projection.net.0.proj.weight", "fps_projection.net.2.bias"} <= set(state)
    flat = flatten_to_torch_state_dict(jm, jax.device_get(params))
    assert flat.keys() == state.keys() and all(np.array_equal(flat[k], state[k].numpy()) for k in state)
    again = load_jax_params(SkyReelsV2Transformer3DModel(**CAUSAL_FPS), jax.device_get(params))
    assert all(torch.equal(again.state_dict()[k], v) for k, v in state.items())
    model.save_pretrained(tmp_path / "t")
    loaded = SkyReelsV2Transformer3DModel.from_pretrained(tmp_path / "t", device="cpu")
    assert loaded.config.num_frame_per_block == 2 and loaded.config.inject_sample_info
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in state.items())


@pytest.fixture(scope="module")
def skyreels():
    jparts, tparts = _parts([("vae", JaxVAE, AutoencoderKLWan, VAE), ("text_encoder", JaxUMT5, UMT5EncoderModel, UMT5),
                             ("transformer", JaxSkyReels, SkyReelsV2Transformer3DModel, TINY)], seed=0)
    jpipe = jit_reference(JaxSkyReelsPipeline(tokenizer=MaskTokenizer(), scheduler=JaxUniPC(**UNIPC), **jparts))
    tpipe = SkyReelsV2Pipeline(tokenizer=MaskTokenizer(), scheduler=UniPCMultistepScheduler(**UNIPC), device="cpu",
                               **tparts)
    return jpipe, tpipe


def test_pipeline_matches_jax(skyreels):
    """Text-to-video to decoded frames: two batch-1 calls a step (cond, then
    uncond), UniPC at flow shift 8.0; 5e-4 of JAX, the latents too."""
    jpipe, tpipe = skyreels
    kwargs = dict(CALL, num_inference_steps=STEPS, max_sequence_length=TXT_LEN)
    calls = []
    handle = tpipe.transformer.register_forward_pre_hook(lambda mod, args: calls.append(args[0].shape[0]))
    try:
        ref = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), **kwargs).frames)
        out = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).frames
    finally:
        handle.remove()
    assert calls == [1] * (2 * STEPS)
    assert out.shape == ref.shape == (1, 5, 16, 16, 3) and np.isfinite(out).all()
    assert float(np.abs(out - ref).max()) <= ATOL, float(np.abs(out - ref).max())


def test_pipeline_defaults(skyreels, monkeypatch):
    """JAX's defaults: 544 x 960 x 97 frames, 50 steps, guidance 6.0, 512
    text tokens (read from the signature); the port builds on the card and
    raises without one; no cache config."""
    import inspect

    _, tpipe = skyreels
    sig = inspect.signature(SkyReelsV2Pipeline.__call__).parameters
    jsig = inspect.signature(JaxSkyReelsPipeline.__call__).parameters
    for name, value in (("height", 544), ("width", 960), ("num_frames", 97), ("num_inference_steps", 50),
                        ("guidance_scale", 6.0), ("max_sequence_length", 512)):
        assert sig[name].default == jsig[name].default == value
    from diffusers_tpu_torch.hooks import TextKVCacheConfig

    with pytest.raises(TypeError, match="does not support cache config"):
        tpipe.enable_cache(TextKVCacheConfig())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SkyReelsV2Pipeline(**tpipe.components)


def test_pipeline_with_fps_model_fails_on_both_sides(skyreels):
    """(g) JAX's pipeline passes no fps: with `inject_sample_info` it fails
    in `jnp.asarray(None)`; the port raises a ValueError that says why,
    before the loop."""
    jpipe, tpipe = skyreels
    jparts, tparts = _parts([("transformer", JaxSkyReels, SkyReelsV2Transformer3DModel,
                              dict(TINY, inject_sample_info=True))], seed=1)
    jfps = JaxSkyReelsPipeline(tokenizer=jpipe.tokenizer, text_encoder=jpipe.text_encoder, vae=jpipe.vae,
                               scheduler=JaxUniPC(**UNIPC), transformer=jparts["transformer"])
    kwargs = dict(CALL, num_inference_steps=1, max_sequence_length=TXT_LEN, output_type="latent")
    with pytest.raises(ValueError, match="None is not a valid value"):
        jfps(PROMPT, latents=jnp.asarray(LATENTS), **kwargs)
    tfps = SkyReelsV2Pipeline(**{**tpipe.components, "transformer": tparts["transformer"]}, device="cpu")
    with pytest.raises(ValueError, match="inject_sample_info"):
        tfps(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs)


def test_from_pretrained_in_the_checkpoint_layout(skyreels, tmp_path):
    """A directory laid out as Skywork/SkyReels-V2-T2V-14B-540P-Diffusers,
    read back by `model_index.json`; bit-equal to the in-memory pipeline."""
    _, tpipe = skyreels
    root = tmp_path / "skyreels"
    for name in ("text_encoder", "transformer", "vae"):
        getattr(tpipe, name).save_pretrained(root / name)
    tpipe.scheduler.save_config(root / "scheduler")
    index = {"_class_name": "SkyReelsV2Pipeline", "_diffusers_version": "0.35.0.dev0",
             "scheduler": ["diffusers", "UniPCMultistepScheduler"],
             "text_encoder": ["transformers", "UMT5EncoderModel"],
             "tokenizer": ["transformers", "T5TokenizerFast"],
             "transformer": ["diffusers", "SkyReelsV2Transformer3DModel"], "vae": ["diffusers", "AutoencoderKLWan"]}
    (root / "model_index.json").write_text(json.dumps(index))
    loaded = SkyReelsV2Pipeline.from_pretrained(root, tokenizer=MaskTokenizer(), device="cpu")
    assert isinstance(loaded.transformer, SkyReelsV2Transformer3DModel)
    kwargs = dict(CALL, num_inference_steps=2, max_sequence_length=TXT_LEN, output_type="latent")
    torch.testing.assert_close(loaded(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).frames,
                               tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).frames, rtol=0, atol=0)

"""The port's Wan-VACE transformer and pipeline against the JAX package on the
CPU, and the Wan block's two paths that VACE and SkyReels-V2 brought in.

Tiny components at tests/test_wan_vace.py's widths: a VACE transformer of
2 layers of 2 heads x 8 with VACE blocks at layers [0, 1]; a 2-layer UMT5;
a one-level VAE (2x in time and space, non-trivial latent statistics), so
the control latents have 2 x 4 + 2² = 12 channels. The port's seeded
weights (1-D ones jittered) go to JAX with `convert_torch_state_dict`; both
sides take the same numpy inputs, float32; JAX's attention runs its plain
path on the CPU.

Tolerances: 5e-4 for the transformer and the pipeline to decoded frames
(measured below 1e-5); exact for the control mask's space-to-depth fold and
its nearest-exact frame resize; bit-equal for the Wan block's old paths
(3-D modulation, PAB) against today's formula and for the state-dict round
trips.

The reference-side fault shown on both sides (ROADMAP C4 (f)): JAX's VACE
with `num_videos_per_prompt` > 1 never repeats the prompt embeddings, so its
cross attention reshapes fewer text rows over the video rows (no error, each
video sees half a prompt); the port repeats them per video, as upstream
does.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.models.autoencoders.autoencoder_kl_wan import AutoencoderKLWan as JaxVAE
from diffusers_tpu.models.modeling_utils import convert_torch_state_dict, flatten_to_torch_state_dict
from diffusers_tpu.models.text_encoders.t5 import UMT5EncoderModel as JaxUMT5
from diffusers_tpu.models.transformers.transformer_wan import WanTransformerBlock as JaxWanBlock
from diffusers_tpu.models.transformers.transformer_wan_vace import WanVACETransformer3DModel as JaxVACE
from diffusers_tpu.pipelines.wan.pipeline_wan_vace import WanVACEPipeline as JaxVACEPipeline
from diffusers_tpu.schedulers import UniPCMultistepScheduler as JaxUniPC
from diffusers_tpu_torch import (
    AutoencoderKLWan,
    UMT5EncoderModel,
    UniPCMultistepScheduler,
    WanVACEPipeline,
    WanVACETransformer3DModel,
)
from diffusers_tpu_torch.models.modeling_utils import load_jax_params
from diffusers_tpu_torch.models.transformers.transformer_wan import WanTransformerBlock
from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention_full
from diffusers_tpu_torch.pipelines.wan.pipeline_wan_vace import nearest_indices
from test_torch_pipeline_cache import _parts
from test_torch_pipeline_wan import MaskTokenizer, jit_reference
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

ATOL = 5e-4
PROMPT = "replace the sky with a storm"
TXT_LEN = 16
STEPS = 2
VACE = dict(patch_size=(1, 2, 2), num_attention_heads=2, attention_head_dim=8, in_channels=4, out_channels=4,
            text_dim=16, freq_dim=16, ffn_dim=32, num_layers=2, cross_attn_norm=True, qk_norm="rms_norm_across_heads",
            eps=1e-6, rope_max_seq_len=64, vace_layers=[0, 1], vace_in_channels=4 * 2 + 4)
VAE = dict(base_dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1, temperal_downsample=(True,),
           latents_mean=[0.1, -0.2, 0.0, 0.3], latents_std=[1.0, 0.5, 2.0, 1.5], scale_factor_temporal=2,
           scale_factor_spatial=2)
UMT5 = dict(vocab_size=1000, d_model=16, d_kv=8, d_ff=32, num_layers=2, num_heads=2, feed_forward_proj="gated-gelu")
UNIPC = dict(prediction_type="flow_prediction", use_flow_sigmas=True, flow_shift=3.0)
CALL = dict(height=16, width=16, num_frames=5, guidance_scale=5.0)
LATENTS = np.random.RandomState(1).randn(1, 4, 3, 8, 8).astype(np.float32)  # 5 frames of 16 x 16
_rng = np.random.RandomState(2)
VIDEO = (_rng.rand(1, 3, 5, 16, 16) * 2 - 1).astype(np.float32)
MASK = (_rng.rand(1, 1, 5, 16, 16) > 0.5).astype(np.float32)


def _port_to_jax(jm, model):
    return convert_torch_state_dict(jm, {k: v.numpy() for k, v in model.state_dict().items()})


@pytest.fixture(scope="module")
def vace():
    (jparts, tparts) = _parts([("vae", JaxVAE, AutoencoderKLWan, VAE),
                               ("text_encoder", JaxUMT5, UMT5EncoderModel, UMT5),
                               ("transformer", JaxVACE, WanVACETransformer3DModel, VACE)], seed=0)
    jpipe = jit_reference(JaxVACEPipeline(tokenizer=MaskTokenizer(), scheduler=JaxUniPC(**UNIPC), **jparts))
    tpipe = WanVACEPipeline(tokenizer=MaskTokenizer(), scheduler=UniPCMultistepScheduler(**UNIPC), device="cpu",
                            **tparts)
    return jpipe, tpipe


def _frames(out):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.dtype == np.float32 and np.isfinite(out).all()
    return out


def _run(jpipe, tpipe, text_len=TXT_LEN, **kw):
    kwargs = dict(CALL, num_inference_steps=STEPS, **kw)
    if text_len is not None:
        kwargs["max_sequence_length"] = text_len
    jkw = {k: jnp.asarray(v) if k in ("video", "mask") else v for k, v in kwargs.items()}
    ref = _frames(jpipe(PROMPT, latents=jnp.asarray(LATENTS), **jkw).frames)
    out = _frames(tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).frames)
    assert out.shape == ref.shape
    return ref, out


# ------------------------------------------------------------------------------------ the Wan block's paths


def _old_block_forward(block, hidden_states, encoder_hidden_states, temb, rotary_emb, pab=None):
    """The Wan block's forward as it was before the mask and the 4-D
    modulation came in: the 3-D path and PAB."""
    mods = (block.scale_shift_table.float() + temb.float()).chunk(6, dim=1)
    shift_msa, scale_msa, gate_msa, c_shift_msa, c_scale_msa, c_gate_msa = mods
    dtype = hidden_states.dtype
    norm_h = (block.norm1(hidden_states.float()) * (1 + scale_msa) + shift_msa).to(dtype)
    attn_out = block.attn1(norm_h, None, rotary_emb) if pab is None or pab[0] else pab[1]
    hidden_states = (hidden_states.float() + attn_out.float() * gate_msa).to(dtype)
    norm2 = block.norm2
    norm_h = hidden_states if norm2 is None else torch.nn.functional.layer_norm(
        hidden_states.float(), norm2.normalized_shape, norm2.weight.float(), norm2.bias.float(), norm2.eps).to(dtype)
    hidden_states = hidden_states + block.attn2(norm_h, encoder_hidden_states)
    norm_h = (block.norm3(hidden_states.float()) * (1 + c_scale_msa) + c_shift_msa).to(dtype)
    hidden_states = (hidden_states.float() + block.ffn(norm_h).float() * c_gate_msa).to(dtype)
    return (hidden_states, attn_out) if pab is not None else hidden_states


def _block_inputs(n=12, dim=24, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(2, n, dim).astype(np.float32))
    ctx = torch.from_numpy(rng.randn(2, 5, dim).astype(np.float32))
    temb = torch.from_numpy(rng.randn(2, 6, dim).astype(np.float32))
    ang = rng.rand(1, n, 1, 12).astype(np.float32)
    return x, ctx, temb, (torch.from_numpy(np.cos(ang)), torch.from_numpy(np.sin(ang)))


@pytest.mark.parametrize("path", ["3d", "pab_compute", "pab_cached"])
def test_block_old_paths_bit_equal(path):
    """The 3-D modulation path and PAB (computing and replaying) give the
    bits today's formula gives."""
    torch.manual_seed(0)
    block = WanTransformerBlock(24, 32, 2, cross_attn_norm=True).eval()
    x, ctx, temb, rope = _block_inputs()
    pab = {"3d": None, "pab_compute": (True, None), "pab_cached": (False, torch.randn(2, 12, 24))}[path]
    with torch.no_grad():
        new, old = block(x, ctx, temb, rope, pab=pab), _old_block_forward(block, x, ctx, temb, rope, pab=pab)
    for a, b in zip(*((new, old) if pab is not None else ((new,), (old,)))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["mask", "per_token"])
def test_block_mask_and_per_token_modulation_match_jax(case):
    """JAX `:225-236`: a bool keep-mask on the self attention, and a [B, 6, N,
    D] modulation a token; 5e-4 of JAX's block."""
    torch.manual_seed(1)
    block = WanTransformerBlock(24, 32, 2, cross_attn_norm=True).eval()
    jblock = JaxWanBlock(24, 32, 2, "rms_norm_across_heads", True, 1e-6, None)
    params = _port_to_jax(jblock, block)
    x, ctx, temb, rope = _block_inputs(seed=1)
    mask = None
    if case == "mask":
        mask = np.tril(np.ones((12, 12), bool))[None, None]
    else:
        temb = torch.from_numpy(np.random.RandomState(3).randn(2, 6, 12, 24).astype(np.float32))
    ref = np.asarray(jax.jit(jblock)(params, *(jnp.asarray(t.numpy()) for t in (x, ctx, temb)),
                                     tuple(jnp.asarray(t.numpy()) for t in rope),
                                     attention_mask=None if mask is None else jnp.asarray(mask)))
    with torch.no_grad():
        out = block(x, ctx, temb, rope, attention_mask=None if mask is None else torch.from_numpy(mask)).numpy()
    assert float(np.abs(out - ref).max()) <= ATOL
    if case == "per_token":  # the same modulation on every token is the 3-D path
        with torch.no_grad():
            flat = block(x, ctx, temb[:, :, :1], rope)
            spread = block(x, ctx, temb[:, :, :1].expand(2, 6, 12, 24), rope)
        assert torch.equal(flat, spread)


# ------------------------------------------------------------------------------------ the VACE transformer


@pytest.mark.parametrize("scale", ["ones", "per_layer"])
def test_vace_transformer_matches_jax(scale):
    """The VACE blocks' hints added after layers 0 and 1, scaled per layer;
    control tokens zero-padded to the main count (2 control frames of 3);
    5e-4 of JAX; K1 never launches on the CPU."""
    jp, tp = _parts([("transformer", JaxVACE, WanVACETransformer3DModel, VACE)], seed=3)
    (jm, params), model = jp["transformer"], tp["transformer"]
    rng = np.random.RandomState(4)
    x = rng.randn(2, 4, 3, 8, 8).astype(np.float32)
    ctrl = rng.randn(2, 12, 2, 8, 8).astype(np.float32)
    ehs = rng.randn(2, 5, 16).astype(np.float32)
    t = np.array([3.0, 900.0], np.float32)
    s = None if scale == "ones" else np.array([0.8, 1.2], np.float32)
    ref = np.asarray(jax.jit(lambda p, *a, **kw: jm(p, *a, **kw).sample)(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ehs), control_hidden_states=jnp.asarray(ctrl),
        control_hidden_states_scale=None if s is None else jnp.asarray(s)))
    flash_attention_full.launches = 0
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ehs),
                    control_hidden_states=torch.from_numpy(ctrl),
                    control_hidden_states_scale=None if s is None else s.tolist()).sample.numpy()
    assert flash_attention_full.launches == 0
    assert out.shape == ref.shape == (2, 4, 3, 8, 8)
    assert float(np.abs(out - ref).max()) <= ATOL, float(np.abs(out - ref).max())


def test_vace_transformer_errors():
    with pytest.raises(ValueError, match="must include layer 0"):
        WanVACETransformer3DModel(**dict(VACE, vace_layers=[1]))
    with pytest.raises(ValueError, match="must include layer 0"):
        JaxVACE(**dict(VACE, vace_layers=[1]))
    model = WanVACETransformer3DModel(**VACE).eval()
    x, ehs = torch.zeros(1, 4, 1, 8, 8), torch.zeros(1, 5, 16)
    with pytest.raises(ValueError, match="control_hidden_states"):
        model(x, torch.zeros(1), ehs)
    with pytest.raises(ValueError, match="one scale per VACE layer"):
        model(x, torch.zeros(1), ehs, control_hidden_states=torch.zeros(1, 12, 1, 8, 8),
              control_hidden_states_scale=[1.0, 1.0, 1.0])


def test_vace_state_dict_round_trips(tmp_path):
    """JAX's params read back into the port bit-equal (`load_jax_params`),
    the port's state dict through `flatten_to_torch_state_dict` bit-equal,
    and `save_pretrained` / `from_pretrained` in upstream's key names."""
    jp, tp = _parts([("transformer", JaxVACE, WanVACETransformer3DModel, VACE)], seed=5)
    (jm, params), model = jp["transformer"], tp["transformer"]
    state = model.state_dict()
    assert {"vace_blocks.0.proj_in.weight", "vace_blocks.1.proj_out.bias", "vace_blocks.1.scale_shift_table",
            "vace_patch_embedding.weight"} <= set(state) and "vace_blocks.1.proj_in.weight" not in state
    flat = flatten_to_torch_state_dict(jm, jax.device_get(params))
    assert flat.keys() == state.keys() and all(np.array_equal(flat[k], state[k].numpy()) for k in state)
    again = load_jax_params(WanVACETransformer3DModel(**VACE), jax.device_get(params))
    assert all(torch.equal(again.state_dict()[k], v) for k, v in state.items())
    model.save_pretrained(tmp_path / "t")
    assert json.loads((tmp_path / "t" / "config.json").read_text())["vace_layers"] == [0, 1]
    loaded = WanVACETransformer3DModel.from_pretrained(tmp_path / "t", device="cpu")
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in state.items())


# ------------------------------------------------------------------------------------ the pipeline


def test_control_latents_mask_is_exact(vace):
    """The control latents: the two `mode()` encodes within 2e-5 of JAX, the
    space-to-depth mask and its nearest-exact frame resize exact."""
    jpipe, tpipe = vace
    video, mask = VIDEO[:, :, :5], MASK * np.ones_like(VIDEO[:, :1])
    ref = np.asarray(jpipe.prepare_control_latents(jnp.asarray(video), jnp.asarray(mask), jax.random.PRNGKey(0)))
    out = tpipe.prepare_control_latents(torch.from_numpy(video), torch.from_numpy(mask)).numpy()
    assert out.shape == ref.shape == (1, 12, 3, 8, 8)
    np.testing.assert_array_equal(out[:, 8:], ref[:, 8:])
    np.testing.assert_allclose(out[:, :8], ref[:, :8], atol=2e-5)
    for f, lf in ((5, 3), (81, 21), (7, 3), (9, 2)):
        idx = np.asarray(jnp.floor((jnp.arange(lf) + 0.5) * f / lf).astype(jnp.int32))
        np.testing.assert_array_equal(nearest_indices(f, lf), idx)


@pytest.mark.parametrize("case", ["t2v", "masked_video", "scale_list"])
def test_vace_pipeline_matches_jax(vace, case):
    """Dense text-to-video (zero video, all-ones mask), a masked video, and a
    per-layer `conditioning_scale` list, to decoded frames; CFG is one batch-2
    call a step."""
    jpipe, tpipe = vace
    kw = {"t2v": {}, "masked_video": dict(video=VIDEO, mask=MASK, conditioning_scale=0.7),
          "scale_list": dict(video=VIDEO, mask=MASK, conditioning_scale=[1.3, 0.4])}[case]
    calls = []
    handle = tpipe.transformer.register_forward_pre_hook(lambda mod, args: calls.append(args[0].shape[0]))
    try:
        ref, out = _run(jpipe, tpipe, **kw)
    finally:
        handle.remove()
    assert out.shape == (1, 5, 16, 16, 3) and calls == [2] * STEPS
    assert float(np.abs(out - ref).max()) <= ATOL, float(np.abs(out - ref).max())


def test_vace_text_length_default_is_512(vace):
    """The port's default is 512 text tokens; at JAX's default, 226, it
    equals JAX, and the two lengths give different latents."""
    jpipe, tpipe = vace
    ref, out = _run(jpipe, tpipe, text_len=226, output_type="latent")
    assert float(np.abs(out - ref).max()) <= ATOL
    default = _frames(tpipe(PROMPT, latents=torch.from_numpy(LATENTS), num_inference_steps=STEPS,
                            output_type="latent", **CALL).frames)
    assert float(np.abs(default - out).max()) > 1e-4


def test_vace_num_videos_per_prompt(vace):
    """(f) JAX never repeats the prompt embeddings per video: its cross
    attention reshapes 2 rows of text to the 4 rows of the CFG batch, each
    video seeing half of one prompt's tokens, so two videos from the same
    latents differ from each other and from the one-video request. The port
    repeats the embeddings per video: each of its two videos equals the
    one-video request."""
    jpipe, tpipe = vace
    kwargs = dict(CALL, num_inference_steps=STEPS, max_sequence_length=TXT_LEN, output_type="latent")
    jtwo = np.asarray(jpipe(PROMPT, num_videos_per_prompt=2, latents=jnp.asarray(np.concatenate([LATENTS] * 2)),
                            **kwargs).frames)
    jone = np.asarray(jpipe(PROMPT, latents=jnp.asarray(LATENTS), **kwargs).frames)
    assert jtwo.shape[0] == 2 and np.abs(jtwo[0] - jtwo[1]).max() > 1e-2 and np.abs(jtwo[:1] - jone).max() > 1e-2
    two = tpipe(PROMPT, num_videos_per_prompt=2, latents=torch.from_numpy(np.concatenate([LATENTS] * 2)),
                **kwargs).frames
    one = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).frames
    assert two.shape[0] == 2 and torch.equal(two[0], two[1])
    torch.testing.assert_close(two[:1], one, rtol=0, atol=1e-5)  # batch 4 against batch 2: summation order


def test_vace_pipeline_errors(vace, monkeypatch):
    _, tpipe = vace
    with pytest.raises(ValueError, match="takes 1 \\+ 2 k frames"):
        tpipe(PROMPT, latents=torch.from_numpy(LATENTS), num_inference_steps=1, max_sequence_length=TXT_LEN,
              **dict(CALL, num_frames=4))
    with pytest.raises(TypeError, match="does not support cache config"):
        from diffusers_tpu_torch.hooks import TaylorSeerCacheConfig

        tpipe.enable_cache(TaylorSeerCacheConfig())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WanVACEPipeline(**tpipe.components)


def test_vace_from_pretrained_in_the_checkpoint_layout(vace, tmp_path):
    """A directory laid out as Wan-AI/Wan2.1-VACE-1.3B-diffusers: the
    pipeline loads it by `model_index.json` and runs bit-equal to the
    in-memory one."""
    _, tpipe = vace
    root = tmp_path / "wan_vace"
    for name in ("text_encoder", "transformer", "vae"):
        getattr(tpipe, name).save_pretrained(root / name)
    tpipe.scheduler.save_config(root / "scheduler")
    index = {"_class_name": "WanVACEPipeline", "_diffusers_version": "0.34.0.dev0",
             "scheduler": ["diffusers", "UniPCMultistepScheduler"],
             "text_encoder": ["transformers", "UMT5EncoderModel"],
             "tokenizer": ["transformers", "T5TokenizerFast"],
             "transformer": ["diffusers", "WanVACETransformer3DModel"],
             "vae": ["diffusers", "AutoencoderKLWan"]}
    (root / "model_index.json").write_text(json.dumps(index))
    loaded = WanVACEPipeline.from_pretrained(root, tokenizer=MaskTokenizer(), device="cpu")
    assert isinstance(loaded, WanVACEPipeline) and isinstance(loaded.transformer, WanVACETransformer3DModel)
    kwargs = dict(CALL, num_inference_steps=2, max_sequence_length=TXT_LEN, video=VIDEO, mask=MASK,
                  output_type="latent")
    torch.testing.assert_close(loaded(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).frames,
                               tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).frames, rtol=0, atol=0)

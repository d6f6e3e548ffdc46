"""The port's single-file loaders (`diffusers_tpu_torch.loaders.single_file`)
against the JAX package's on the CPU.

Each case builds a tiny port model from a seed (1-D weights jittered) and
writes its state dict in a community layout with `chip_smoke.py`'s inverse
maps (`ldm_unet_keys`, `ldm_vae_keys`, `ldm_clip_keys`, `bfl_flux_keys`,
`sai_sd3_keys`, `wan_original_keys`). JAX's converter must give the state
dict back (the inverse map is right); the port's converter must equal JAX's
key for key and bit for bit; the loaded model's state must equal the source
bit for bit, and its forward equal JAX's model loaded from the same file
within the whole-model bound 5e-4 (JAX jitted). The LDM file goes through
the disk (the port's safetensors writer and `load_single_file_checkpoint`).
`infer_single_file_checkpoint_type` is held to JAX's on one synthetic dict a
sniffed type; a pickle path raises in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from diffusers_tpu.loaders import single_file as jsf
from diffusers_tpu.models.autoencoders.autoencoder_kl import AutoencoderKL as JaxAutoencoderKL
from diffusers_tpu.models.modeling_utils import convert_torch_state_dict
from diffusers_tpu.models.text_encoders.clip import CLIPTextModel as JaxCLIPTextModel
from diffusers_tpu.models.unets.unet_2d_condition import UNet2DConditionModel as JaxUNet
from diffusers_tpu_torch.loaders import single_file as sf
from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
from diffusers_tpu_torch.models.modeling_utils import save_safetensors
from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel
from diffusers_tpu_torch.models.transformers.transformer_flux import FluxTransformer2DModel
from diffusers_tpu_torch.models.transformers.transformer_sd3 import SD3Transformer2DModel
from diffusers_tpu_torch.models.transformers.transformer_wan import WanTransformer3DModel
from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
from test_torch_flux import FLOAT as FLUX
from test_torch_models import CLIP_TINY, SD_TINY, SDXL_TINY
from test_torch_sd3 import SD35
from test_torch_wan import WAN, WAN_I2V

torch.set_num_threads(1)

MODEL_ATOL = 5e-4
# the LDM layout's VAE has four blocks (JAX's tests/test_single_file.py VAE_CFG)
VAE4 = dict(in_channels=3, out_channels=3, block_out_channels=(32, 32, 64, 64),
            down_block_types=("DownEncoderBlock2D",) * 4, up_block_types=("UpDecoderBlock2D",) * 4, latent_channels=4,
            layers_per_block=1, norm_num_groups=32)


def seeded(cls, cfg, seed):
    torch.manual_seed(seed)
    model = cls(**cfg).eval()
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim == 1:
                p.add_(torch.from_numpy(0.1 * rng.randn(*p.shape).astype(np.float32)))
    return model


def _np(d):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)) for k, v in d.items()}


def _same(a, b):
    a, b = _np(a), _np(b)
    assert sorted(a) == sorted(b), sorted(set(a) ^ set(b))[:8]
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and np.array_equal(a[k], b[k]), k


def _assert_state(model, state):
    loaded = model.state_dict()
    assert sorted(loaded) == sorted(state)
    for k, v in state.items():
        assert loaded[k].dtype == v.dtype and torch.equal(loaded[k], v), k


def _jit(fn):
    return jax.jit(fn)


# ------------------------------------------------------------------ the LDM layout (SD 1.x / SDXL)

def _ldm_file(tmp_path, unet, vae, clip, layers_per_block):
    sd = {**chip_smoke.ldm_unet_keys(unet.state_dict(), layers_per_block), **chip_smoke.ldm_vae_keys(vae.state_dict()),
          **chip_smoke.ldm_clip_keys(clip.state_dict())}
    path = tmp_path / "model.safetensors"
    save_safetensors(sd, path)
    return path


@pytest.fixture(scope="module")
def ldm(tmp_path_factory):
    unets = {"sd": seeded(UNet2DConditionModel, SD_TINY, 0), "sdxl": seeded(UNet2DConditionModel, SDXL_TINY, 1)}
    vae, clip = seeded(AutoencoderKL, VAE4, 2), seeded(CLIPTextModel, CLIP_TINY, 3)
    files = {name: sf.load_single_file_checkpoint(_ldm_file(tmp_path_factory.mktemp(name), unet, vae, clip, 2))
             for name, unet in unets.items()}
    return unets, vae, clip, files


@pytest.mark.parametrize("name", ["sd", "sdxl"])
def test_ldm_unet_matches_jax(ldm, name):
    unets, _, _, files = ldm
    cfg = SD_TINY if name == "sd" else SDXL_TINY
    unet, sd = unets[name], files[name]
    ref = jsf.convert_ldm_unet_state_dict(_np(sd), cfg)
    _same(ref, unet.state_dict())  # the inverse map is right
    out = sf.convert_ldm_unet_state_dict(sd, cfg)
    _same(ref, out)
    model = sf.model_from_state_dict(UNet2DConditionModel, cfg, out, device="cpu")
    _assert_state(model, unet.state_dict())

    jm = JaxUNet(**cfg)
    params = convert_torch_state_dict(jm, ref)
    rng = np.random.RandomState(4)
    x = rng.randn(2, 4, 16, 16).astype(np.float32)
    ehs = rng.randn(2, 8, cfg["cross_attention_dim"]).astype(np.float32)
    added = {"text_embeds": rng.randn(2, 32).astype(np.float32), "time_ids": rng.randn(2, 6).astype(np.float32)}
    added = added if name == "sdxl" else None
    run = _jit(lambda p, x, e, a: jm(p, x, 5, e, added_cond_kwargs=a).sample)
    expected = np.asarray(run(params, jnp.asarray(x), jnp.asarray(ehs),
                              None if added is None else {k: jnp.asarray(v) for k, v in added.items()}))
    with torch.no_grad():
        got = model(torch.from_numpy(x), 5, torch.from_numpy(ehs),
                    added_cond_kwargs=None if added is None else {k: torch.from_numpy(v) for k, v in added.items()})
    np.testing.assert_allclose(got.sample.numpy(), expected, atol=MODEL_ATOL, rtol=0)


def test_ldm_vae_and_clip_match_jax(ldm):
    _, vae, clip, files = ldm
    sd = files["sd"]
    ref_vae, out_vae = jsf.convert_ldm_vae_state_dict(_np(sd)), sf.convert_ldm_vae_state_dict(sd)
    _same(ref_vae, vae.state_dict())
    _same(ref_vae, out_vae)
    ref_clip, out_clip = jsf.convert_ldm_clip_state_dict(_np(sd)), sf.convert_ldm_clip_state_dict(sd)
    _same(ref_clip, clip.state_dict())  # position_ids dropped
    _same(ref_clip, out_clip)
    # SD 1.x's CLIP prefix
    sd1 = chip_smoke.ldm_clip_keys(clip.state_dict(), "cond_stage_model.transformer.")
    _same(jsf.convert_ldm_clip_state_dict(_np(sd1)), sf.convert_ldm_clip_state_dict(sd1))

    vae_model = sf.model_from_state_dict(AutoencoderKL, VAE4, out_vae, device="cpu")
    clip_model = sf.model_from_state_dict(CLIPTextModel, CLIP_TINY, out_clip, device="cpu")
    _assert_state(vae_model, vae.state_dict())
    _assert_state(clip_model, clip.state_dict())

    jvae, jclip = JaxAutoencoderKL(**VAE4), JaxCLIPTextModel(**CLIP_TINY)
    rng = np.random.RandomState(5)
    z = rng.randn(1, 4, 4, 4).astype(np.float32)
    ids = rng.randint(0, 999, (2, 77)).astype(np.int64)
    ref = np.asarray(_jit(lambda p, z: jvae.decode(p, z).sample)(convert_torch_state_dict(jvae, ref_vae),
                                                                   jnp.asarray(z)))
    ref_hidden = np.asarray(_jit(lambda p, i: jclip(p, i)[0])(convert_torch_state_dict(jclip, ref_clip),
                                                              jnp.asarray(ids)))
    with torch.no_grad():
        np.testing.assert_allclose(vae_model.decode(torch.from_numpy(z)).sample.numpy(), ref, atol=MODEL_ATOL, rtol=0)
        np.testing.assert_allclose(clip_model(torch.from_numpy(ids))[0].numpy(), ref_hidden, atol=MODEL_ATOL, rtol=0)


def test_pickle_and_unknown_checkpoints_raise(tmp_path):
    for fn in (jsf.load_single_file_checkpoint, sf.load_single_file_checkpoint):
        with pytest.raises(ValueError, match="no pickle"):
            fn(str(tmp_path / "model.ckpt"))
    for fn in (jsf.infer_single_file_checkpoint_type, sf.infer_single_file_checkpoint_type):
        with pytest.raises(ValueError, match="could not infer"):
            fn({"some.key": np.zeros(1)})
    with pytest.raises(ValueError, match="does not match"):
        sf.model_from_state_dict(CLIPTextModel, CLIP_TINY, {"text_model.final_layer_norm.weight": np.ones(32)},
                                 device="cpu")


# ------------------------------------------------------------------ the transformer layouts

def _flux_case():
    model = seeded(FluxTransformer2DModel, FLUX, 6)
    return model, chip_smoke.bfl_flux_keys(model.state_dict()), dict(axes_dims_rope=FLUX["axes_dims_rope"])


def _sd3_case():
    model = seeded(SD3Transformer2DModel, SD35, 7)
    return model, chip_smoke.sai_sd3_keys(model.state_dict(), chip_smoke.sd3_pos_embed_table(model).float()), dict(
        attention_head_dim=SD35["attention_head_dim"], num_attention_heads=SD35["num_attention_heads"],
        sample_size=SD35["sample_size"])


def _wan_case(cfg, seed):
    model = seeded(WanTransformer3DModel, cfg, seed)
    return model, chip_smoke.wan_original_keys(model.state_dict()), dict(
        attention_head_dim=cfg["attention_head_dim"], freq_dim=cfg["freq_dim"],
        rope_max_seq_len=cfg["rope_max_seq_len"])


CASES = {
    "flux": (_flux_case, "convert_flux_transformer_state_dict", "load_flux_transformer_single_file"),
    "sd3": (_sd3_case, "convert_sd3_transformer_state_dict", "load_sd3_transformer_single_file"),
    "wan": (lambda: _wan_case(WAN, 8), "convert_wan_transformer_state_dict", "load_wan_transformer_single_file"),
    "wan_i2v": (lambda: _wan_case(WAN_I2V, 9), "convert_wan_transformer_state_dict",
                "load_wan_transformer_single_file"),
}


def _forward(name, jm, params, model):
    rng = np.random.RandomState(10)
    if name == "flux":
        img, txt = 16, 8
        inputs = dict(hidden_states=rng.randn(1, img, 4), encoder_hidden_states=rng.randn(1, txt, 32),
                      pooled_projections=rng.randn(1, 32), timestep=np.array([0.7]))
        inputs = {k: v.astype(np.float32) for k, v in inputs.items()}
        ids = np.concatenate([np.zeros((txt, 3), np.float32), rng.randint(0, 4, (img, 3)).astype(np.float32)])
        cos, sin = jm.pos_embed({}, ids)
        ref = _jit(lambda p, kw, rope: jm(p, **kw, image_rotary_emb=rope).sample)(
            params, {k: jnp.asarray(v) for k, v in inputs.items()}, (jnp.asarray(cos), jnp.asarray(sin)))
        with torch.no_grad():
            out = model(**{k: torch.from_numpy(v) for k, v in inputs.items()}, img_ids=torch.from_numpy(ids[txt:]),
                        txt_ids=torch.from_numpy(ids[:txt])).sample
    elif name == "sd3":
        args = (rng.randn(1, 4, 16, 16), rng.randn(1, 8, 24), rng.randn(1, 16), np.array([500.0]))
        args = [a.astype(np.float32) for a in args]
        ref = _jit(lambda p, *a: jm(p, *a).sample)(params, *map(jnp.asarray, args))
        with torch.no_grad():
            out = model(*map(torch.from_numpy, args)).sample
    else:
        cfg = WAN_I2V if name == "wan_i2v" else WAN
        args = [rng.randn(1, 4, 3, 8, 12), np.array([999.0]), rng.randn(1, 512 if cfg.get("image_dim") else 8, 16)]
        args = [a.astype(np.float32) for a in args]
        image = rng.randn(1, 6, cfg["image_dim"]).astype(np.float32) if cfg.get("image_dim") else None
        ref = _jit(lambda p, x, t, e, i: jm(p, x, t, e, encoder_hidden_states_image=i).sample)(
            params, *map(jnp.asarray, args), None if image is None else jnp.asarray(image))
        with torch.no_grad():
            out = model(*map(torch.from_numpy, args),
                        encoder_hidden_states_image=None if image is None else torch.from_numpy(image)).sample
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=MODEL_ATOL, rtol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_transformer_single_file_matches_jax(name, tmp_path):
    build, convert, load = CASES[name]
    model, original, overrides = build()
    ref = getattr(jsf, convert)(_np(original))
    out = getattr(sf, convert)(original)
    _same(ref, out)
    expected = model.state_dict()
    _same({k: v for k, v in ref.items() if k in expected}, expected)  # the inverse map is right
    assert set(ref) - set(expected) <= {"pos_embed.pos_embed"}

    path = tmp_path / "transformer.safetensors"
    save_safetensors(original, path)
    loaded = getattr(sf, load)(str(path), config_overrides=overrides, device="cpu")
    _assert_state(loaded, expected)
    assert dict(loaded.config) == {**dict(loaded.config), **overrides}
    jm, params = getattr(jsf, load)(_np(original), config_overrides=overrides)
    _forward(name, jm, params, loaded)


def test_sd3_half_precision_table_within_its_epsilon():
    """An SAI file in bf16 carries the sin-cos table rounded to bf16: it loads
    (within bf16's epsilon); a table off by more than that raises."""
    model, original, overrides = _sd3_case()
    half = dict(original, pos_embed=original["pos_embed"].to(torch.bfloat16))
    loaded = sf.load_sd3_transformer_single_file(half, config_overrides=overrides, device="cpu")
    _assert_state(loaded, model.state_dict())
    wrong = dict(half, pos_embed=half["pos_embed"] + 0.02)
    with pytest.raises(ValueError, match="sin-cos table"):
        sf.load_sd3_transformer_single_file(wrong, config_overrides=overrides, device="cpu")


def test_ltx_converter_and_loader():
    rng = np.random.RandomState(11)
    sd = {k: rng.randn(2).astype(np.float32) for k in (
        "model.diffusion_model.patchify_proj.weight", "model.diffusion_model.adaln_single.linear.weight",
        "model.diffusion_model.transformer_blocks.0.attn1.q_norm.weight", "vae.decoder.conv_in.weight")}
    _same(jsf.convert_ltx_transformer_state_dict(dict(sd)), sf.convert_ltx_transformer_state_dict(dict(sd)))
    # the loader returns the port's LTX transformer; its bit-equal round trip from the original layout,
    # held to JAX's loader, is tests/test_torch_ltx.py::test_ltx_single_file
    from diffusers_tpu_torch.models.transformers.transformer_ltx import LTXVideoTransformer3DModel

    state = LTXVideoTransformer3DModel(in_channels=8, out_channels=8, num_attention_heads=2, attention_head_dim=8,
                                       cross_attention_dim=16, num_layers=1, caption_channels=12).state_dict()
    loaded = sf.load_ltx_transformer_single_file(state, config_overrides={"attention_head_dim": 8}, device="cpu")
    assert isinstance(loaded, LTXVideoTransformer3DModel)


# ------------------------------------------------------------------ the sniff table

SNIFF = {
    "flux2": {"single_stream_modulation.lin.weight": (1,)},
    "flux": {"double_blocks.0.img_attn.qkv.weight": (1,)},
    "sd3": {"model.diffusion_model.joint_blocks.0.x_block.attn.qkv.weight": (1,)},
    "sdxl_refiner": {"conditioner.embedders.0.model.transformer.resblocks.9.mlp.c_proj.bias": (1,)},
    "sdxl": {"conditioner.embedders.1.model.transformer.resblocks.9.mlp.c_proj.bias": (1,),
             "model.diffusion_model.input_blocks.0.0.weight": (320, 4, 3, 3)},
    "sd2": {"model.diffusion_model.input_blocks.2.1.transformer_blocks.0.attn2.to_k.weight": (320, 1024)},
    "animatediff": {"mid_block.motion_modules.0.temporal_transformer.norm.bias": (1,)},
    "controlnet": {"control_model.input_blocks.0.0.weight": (1,)},
    "auraflow": {"cond_seq_linear.weight": (1,)},
    "ltx2": {"audio_vae.per_channel_statistics.mean-of-means": (1,)},
    "ltx_video": {"patchify_proj.weight": (1,)},
    "hunyuan_video": {"txt_in.individual_token_refiner.blocks.0.adaLN_modulation.1.bias": (1,)},
    "mochi": {"blocks.0.attn.qkv_x.weight": (1,)},
    "lumina2": {"cap_embedder.0.weight": (1,)},
    "wan_vace": {"vace_blocks.0.after_proj.bias": (1,), "head.modulation": (1,)},
    "wan_animate": {"motion_encoder.dec.direction.weight": (1,)},
    "wan": {"model.diffusion_model.head.modulation": (1,)},
    "wan_vae": {"decoder.middle.0.residual.0.gamma": (1,)},
    "z_image": {"layers.0.adaLN_modulation.0.weight": (1,)},
    "hidream": {"double_stream_blocks.0.block.adaLN_modulation.1.bias": (1,)},
    "sana": {"blocks.0.cross_attn.q_linear.weight": (1,)},
    "cosmos": {"net.x_embedder.proj.1.weight": (1,)},
    "autoencoder_dc": {"encoder.project_in.conv.bias": (1,)},
    "instruct_pix2pix": {"model.diffusion_model.input_blocks.0.0.weight": (320, 8, 3, 3)},
    "sd1": {"model.diffusion_model.input_blocks.2.1.transformer_blocks.0.attn2.to_k.weight": (320, 768)},
}


@pytest.mark.parametrize("kind", sorted(SNIFF))
def test_checkpoint_type_matches_jax(kind):
    sd = {k: np.zeros(shape, np.float32) for k, shape in SNIFF[kind].items()}
    assert sf.infer_single_file_checkpoint_type(sd) == jsf.infer_single_file_checkpoint_type(sd) == kind
    assert sf.infer_single_file_checkpoint_type({k: torch.from_numpy(v) for k, v in sd.items()}) == kind
    assert [name for name, _ in sf._CHECKPOINT_SNIFF_KEYS] == [name for name, _ in jsf._CHECKPOINT_SNIFF_KEYS]

"""The port's LoRA loaders (`diffusers_tpu_torch.loaders.lora`) against the
JAX package's on the CPU.

Converters: one synthetic key dict a format, made from a numpy seed, through
JAX's function and the port's: the same keys and bit-equal arrays. Where
JAX's map names a module that does not exist (ROADMAP C4), the test asserts
JAX's wrong path and the port's right one, and that the port's path is a
module of the port's model while JAX's is not.

Fusing: a tiny SDXL UNet and a tiny Flux transformer with the port's seeded
weights, carried into JAX with `convert_torch_state_dict`, fused with the same
LoRA on both sides: the weights within 1e-6 (both add a float32 delta), a
forward within the whole-model bound 5e-4 (JAX jitted). The pipeline mixin
runs JAX's `test_lora_runtime_set_adapters_and_unfuse` sequence
(`tests/test_lora.py:89`) on a tiny SD pipeline, its fused weights held to
JAX's `fuse_lora_multi` on the same base, and `disable_lora` bit-equal to the
base; hotswap, its refusal of other paths, `delete_adapters`, the text
encoders and the refusal on every quantized layer class.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.loaders import lora as jlora
from diffusers_tpu.models.modeling_utils import convert_torch_state_dict, flatten_to_torch_state_dict
from diffusers_tpu.models.transformers.transformer_flux import FluxTransformer2DModel as JaxFlux
from diffusers_tpu.models.unets.unet_2d_condition import UNet2DConditionModel as JaxUNet
from diffusers_tpu_torch.loaders import lora
from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel, CLIPTextModelWithProjection
from diffusers_tpu_torch.models.transformers.transformer_flux import FluxTransformer2DModel
from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
from diffusers_tpu_torch.ops.module import (
    Int4Linear,
    Int8Conv2d,
    Int8PerTensorLinear,
    W8A8Linear,
    WeightOnlyLinear,
)
from diffusers_tpu_torch.pipelines.stable_diffusion import StableDiffusionPipeline
from diffusers_tpu_torch.pipelines.stable_diffusion_xl.pipeline_stable_diffusion_xl import StableDiffusionXLPipeline
from diffusers_tpu_torch.quantizers import quantize_w8a8
from diffusers_tpu_torch.schedulers import EulerDiscreteScheduler, PNDMScheduler
from test_torch_flux import FLOAT as FLUX_FLOAT, W8A8 as FLUX_W8A8, quantize_tree_w8a8
from test_torch_models import SDXL_TINY
from test_torch_pipeline_sdxl import CLIP, EULER, UNET as SDXL_UNET, VAE, CRCTokenizer
from test_torch_stable_diffusion import PNDM, UNET_SD

torch.set_num_threads(1)

WEIGHT_ATOL = 1e-6
MODEL_ATOL = 5e-4
RANK = 4


def _rand(rng, *shape, scale=0.1):
    return (scale * rng.randn(*shape)).astype(np.float32)


def _same(a: dict, b: dict):
    """Same keys, bit-equal arrays."""
    assert sorted(a) == sorted(b), sorted(set(a) ^ set(b))[:8]
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), k


def _same_grouped(a: dict, b: dict):
    assert sorted(a) == sorted(b), sorted(set(a) ^ set(b))[:8]
    for path in a:
        (ja, jb, jalpha, jbias), (ta, tb, talpha, tbias) = a[path], b[path]
        assert np.array_equal(np.asarray(ja), np.asarray(ta)) and np.array_equal(np.asarray(jb), np.asarray(tb)), path
        assert jalpha == talpha and (jbias is None) == (tbias is None), path
        if jbias is not None:
            assert np.array_equal(np.asarray(jbias), np.asarray(tbias)), path


# ------------------------------------------------------------------ one synthetic dict a format

def _pair(rng, base, d_in, d_out, down="lora_down", up="lora_up", alpha=None):
    sd = {f"{base}.{down}.weight": _rand(rng, RANK, d_in), f"{base}.{up}.weight": _rand(rng, d_out, RANK)}
    if alpha is not None:
        sd[f"{base}.alpha"] = np.array(alpha, np.float32)
    return sd


def format_dicts():
    rng = np.random.RandomState(0)
    dicts = {}
    dicts["peft"] = {
        **_pair(rng, "unet.down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q", 16, 16, "lora_A", "lora_B"),
        **_pair(rng, "text_encoder.text_model.encoder.layers.0.self_attn.k_proj", 16, 16, "lora_A", "lora_B",
                alpha=2.0),
        "unet.mid_block.attentions.0.proj_in.lora_A.default.weight": _rand(rng, RANK, 16),
        "unet.mid_block.attentions.0.proj_in.lora_B.default.weight": _rand(rng, 16, RANK),
    }
    dicts["kohya"] = {  # names JAX's map gets right
        **_pair(rng, "lora_unet_down_blocks_1_attentions_0_transformer_blocks_0_attn2_to_k", 32, 16, alpha=4.0),
        **_pair(rng, "lora_unet_mid_block_attentions_0_proj_out", 16, 16),
        **_pair(rng, "lora_te1_text_model_final_layer_norm", 16, 16),
        **_pair(rng, "lora_te2_text_projection", 16, 16),
    }
    xlabs = {}
    for i in range(2):
        for name, out in (("qkv_lora1", 96), ("qkv_lora2", 96), ("proj_lora1", 32), ("proj_lora2", 32)):
            xlabs[f"double_blocks.{i}.processor.{name}.down.weight"] = _rand(rng, RANK, 32)
            xlabs[f"double_blocks.{i}.processor.{name}.up.weight"] = _rand(rng, out, RANK)
        xlabs[f"single_blocks.{i}.processor.qkv_lora.down.weight"] = _rand(rng, RANK, 32)
        xlabs[f"single_blocks.{i}.processor.qkv_lora.up.weight"] = _rand(rng, 96, RANK)
        xlabs[f"single_blocks.{i}.processor.proj_lora.down.weight"] = _rand(rng, RANK, 160)
        xlabs[f"single_blocks.{i}.processor.proj_lora.up.weight"] = _rand(rng, 32, RANK)
    dicts["xlabs"] = xlabs
    dicts["wan"] = {
        **_pair(rng, "diffusion_model.blocks.0.self_attn.q", 32, 32, alpha=8.0),
        **_pair(rng, "diffusion_model.blocks.0.cross_attn.k_img", 32, 32, alpha=2.0),
        **_pair(rng, "diffusion_model.blocks.1.ffn.0", 32, 64),
        **_pair(rng, "diffusion_model.head.head", 32, 64, alpha=1.0),
        "diffusion_model.blocks.0.self_attn.q.diff_b": _rand(rng, 32),
        "diffusion_model.blocks.0.norm3.diff": _rand(rng, 32),
    }
    dicts["wan_ab"] = {  # the lora_A / lora_B spelling
        **_pair(rng, "diffusion_model.blocks.0.cross_attn.o", 32, 32, "lora_A", "lora_B", alpha=16.0),
        **_pair(rng, "diffusion_model.time_projection.1", 32, 192, "lora_A", "lora_B"),
    }
    dicts["musubi"] = {
        **_pair(rng, "lora_unet_blocks_0_self_attn_q", 32, 32, alpha=4.0),
        **_pair(rng, "lora_unet_blocks_3_cross_attn_k_img", 32, 32, alpha=1.0),
        **_pair(rng, "lora_unet_blocks_1_ffn_2", 64, 32),
    }
    dicts["diffusion_model"] = {
        **_pair(rng, "diffusion_model.transformer_blocks.0.attn1.to_q", 32, 32, "lora_A", "lora_B"),
        **_pair(rng, "diffusion_model.proj_out", 32, 8, "lora_A", "lora_B"),
    }
    dicts["qwen"] = {
        **_pair(rng, "lora_unet_transformer_blocks_0_attn_to_q", 32, 32, alpha=8.0),
        **_pair(rng, "lora_unet_transformer_blocks_2_attn_add_k_proj", 32, 32),
        **_pair(rng, "lora_unet_transformer_blocks_1_img_mlp_net_0_proj", 32, 128, alpha=2.0),
        **_pair(rng, "lora_unet_norm_out_linear", 32, 64),
    }
    dicts["hunyuan_video"] = {  # keys JAX's map gets right
        **_pair(rng, "diffusion_model.double_blocks.0.img_attn_qkv", 32, 96, "lora_A", "lora_B"),
        **_pair(rng, "diffusion_model.double_blocks.0.txt_attn_qkv", 32, 96, "lora_A", "lora_B"),
        **_pair(rng, "diffusion_model.double_blocks.0.img_mlp.fc1", 32, 128, "lora_A", "lora_B"),
        **_pair(rng, "diffusion_model.double_blocks.0.txt_mod.linear", 32, 192, "lora_A", "lora_B"),
        **_pair(rng, "diffusion_model.single_blocks.0.linear2", 160, 32, "lora_A", "lora_B"),
        **_pair(rng, "diffusion_model.txt_in.individual_token_refiner.blocks.0.self_attn_qkv", 32, 96, "lora_A",
                "lora_B"),
        **_pair(rng, "diffusion_model.txt_in.individual_token_refiner.blocks.0.adaLN_modulation.1", 32, 64, "lora_A",
                "lora_B"),
        **_pair(rng, "diffusion_model.txt_in.t_embedder.mlp.0", 32, 32, "lora_A", "lora_B"),
    }
    return dicts


FORMATS = format_dicts()
CONVERTERS = {"kohya": "convert_kohya_lora", "xlabs": "convert_xlabs_flux_lora", "wan": "convert_wan_lora",
              "wan_ab": "convert_wan_lora", "musubi": "convert_musubi_wan_lora",
              "diffusion_model": "convert_diffusion_model_prefix_lora", "qwen": "convert_qwen_lora",
              "hunyuan_video": "convert_hunyuan_video_lora"}
DETECTORS = ("_is_xlabs_lora", "_is_hunyuan_video_lora", "_is_musubi_wan_lora", "_is_wan_lora", "_is_qwen_kohya_lora")


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_converters_and_grouping_match_jax(fmt):
    sd = FORMATS[fmt]
    for name in DETECTORS:
        assert getattr(lora, name)(sd) == getattr(jlora, name)(sd), name
    if fmt in CONVERTERS:
        _same(getattr(jlora, CONVERTERS[fmt])(dict(sd)), getattr(lora, CONVERTERS[fmt])(dict(sd)))
    for component in (None, "unet", "transformer", "text_encoder", "text_encoder_2"):
        _same_grouped(jlora.group_lora_weights(dict(sd), component=component),
                      lora.group_lora_weights(dict(sd), component=component))
    # torch tensors convert to the same values as numpy arrays
    as_torch = lora.group_lora_weights({k: torch.from_numpy(v) for k, v in sd.items()})
    _same_grouped(lora.group_lora_weights(dict(sd)), {p: tuple(e if not isinstance(e, torch.Tensor) else e.numpy()
                                                               for e in v) for p, v in as_torch.items()})


# ------------------------------------------------------------------ the JAX faults the port does not copy (C4)

KOHYA_FAULTS = {  # kohya key -> (JAX's path, the port's path), on SDXL_TINY's UNet and CLIP
    "ff_net": ("lora_unet_down_blocks_1_attentions_0_transformer_blocks_0_ff_net_0_proj",
               "unet.down_blocks.1.attentions.0.transformer_blocks.0.ff_net.0.proj",
               "unet.down_blocks.1.attentions.0.transformer_blocks.0.ff.net.0.proj"),
    "encoder_layers": ("lora_te1_text_model_encoder_layers_0_self_attn_q_proj",
                       "text_encoder.text_model.encoder_layers.0.self_attn.q_proj",
                       "text_encoder.text_model.encoder.layers.0.self_attn.q_proj"),
    "sgm_input": ("lora_unet_input_blocks_4_1_transformer_blocks_0_attn1_to_q",
                  "unet.input.blocks.4.1.transformer_blocks.0.attn1.to_q",
                  "unet.down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q"),
    "sgm_middle": ("lora_unet_middle_block_1_proj_in", "unet.middle.block.1.proj_in",
                   "unet.mid_block.attentions.0.proj_in"),
    "sgm_output": ("lora_unet_output_blocks_2_1_transformer_blocks_1_ff_net_2",
                   "unet.output.blocks.2.1.transformer_blocks.1.ff_net.2",
                   "unet.up_blocks.0.attentions.2.transformer_blocks.1.ff.net.2"),
    "sgm_resnet": ("lora_unet_output_blocks_3_0_emb_layers_1", "unet.output.blocks.3.0.emb.layers.1",
                   "unet.up_blocks.1.resnets.0.time_emb_proj"),
    "sgm_time_embed": ("lora_unet_time_embed_0", "unet.time.embed.0", "unet.time_embedding.linear_1"),
}


@pytest.mark.parametrize("case", sorted(KOHYA_FAULTS))
def test_kohya_paths_jax_fault_1(case):
    key, jax_path, port_path = KOHYA_FAULTS[case]
    assert jlora._kohya_path(key) == jax_path
    assert lora._kohya_path(key) == port_path
    component, _, inner = port_path.partition(".")
    model = (UNet2DConditionModel(**SDXL_TINY) if component == "unet"
             else CLIPTextModel(**CLIP))
    names = dict(model.named_modules())
    assert inner in names and jax_path.partition(".")[2] not in names


def test_kohya_sgm_layout_outside_the_map_raises():
    with pytest.raises(ValueError, match="SGM"):
        lora._kohya_path("lora_unet_input_blocks_3_1_transformer_blocks_0_attn1_to_q", 2)  # a downsampler slot


def test_hunyuan_video_faults_3():
    rng = np.random.RandomState(3)
    hidden, rank = 32, RANK
    sd = {
        "txt_in.individual_token_refiner.blocks.0.mlp.fc1.lora_A.weight": _rand(rng, rank, hidden),
        "txt_in.individual_token_refiner.blocks.0.mlp.fc1.lora_B.weight": _rand(rng, 4 * hidden, rank),
        "txt_in.individual_token_refiner.blocks.0.self_attn_proj.lora_A.weight": _rand(rng, rank, hidden),
        "txt_in.individual_token_refiner.blocks.0.self_attn_proj.lora_B.weight": _rand(rng, hidden, rank),
        "txt_in.input_embedder.lora_A.weight": _rand(rng, rank, 24),
        "txt_in.input_embedder.lora_B.weight": _rand(rng, hidden, rank),
        # 7 x 13 = 91 rows, divisible by 13: JAX's guess takes 91 * 3 // 13 = 21 rows for q, not 13
        "single_blocks.0.linear1.lora_A.weight": _rand(rng, rank, 13),
        "single_blocks.0.linear1.lora_B.weight": _rand(rng, 91, rank),
        "final_layer.adaLN_modulation.1.lora_A.weight": _rand(rng, rank, hidden),
        "final_layer.adaLN_modulation.1.lora_B.weight": _rand(rng, 2 * hidden, rank),
    }
    ref, out = jlora.convert_hunyuan_video_lora(dict(sd)), lora.convert_hunyuan_video_lora(dict(sd))
    refiner = "transformer.context_embedder.token_refiner.refiner_blocks.0"
    # (a) the token refiner's keys: JAX skips the rename table
    assert f"{refiner}.ff.fc1.lora_B.weight" in ref and f"{refiner}.self_attn_proj.lora_B.weight" in ref
    assert "transformer.context_embedder.input_embedder.lora_B.weight" in ref
    assert np.array_equal(out[f"{refiner}.ff.net.0.proj.lora_B.weight"], sd[
        "txt_in.individual_token_refiner.blocks.0.mlp.fc1.lora_B.weight"])
    assert f"{refiner}.attn.to_out.0.lora_B.weight" in out
    assert "transformer.context_embedder.proj_in.lora_B.weight" in out
    # (b) linear1 splits at the width its lora_A reads (13), where JAX guesses 21
    b = sd["single_blocks.0.linear1.lora_B.weight"]
    single = "transformer.single_transformer_blocks.0"
    assert ref[f"{single}.attn.to_q.lora_B.weight"].shape[0] == 21
    for j, name in enumerate(("attn.to_q", "attn.to_k", "attn.to_v")):
        assert np.array_equal(out[f"{single}.{name}.lora_B.weight"], b[13 * j:13 * (j + 1)])
    assert np.array_equal(out[f"{single}.proj_mlp.lora_B.weight"], b[39:])
    # (c) the final layer's (shift, scale) rows are swapped into diffusers' (scale, shift)
    b = sd["final_layer.adaLN_modulation.1.lora_B.weight"]
    assert np.array_equal(ref["transformer.norm_out.linear.lora_B.weight"], b)
    assert np.array_equal(out["transformer.norm_out.linear.lora_B.weight"], np.concatenate([b[hidden:], b[:hidden]]))
    assert np.array_equal(out["transformer.norm_out.linear.lora_A.weight"],
                          sd["final_layer.adaLN_modulation.1.lora_A.weight"])


# ------------------------------------------------------------------ fusing into models

def _carry(jcls, tcls, cfg, seed):
    """(port model with seeded weights, 1-D ones jittered; its JAX twin; JAX params)."""
    torch.manual_seed(seed)
    rng = np.random.RandomState(seed)
    tm = tcls(**cfg).eval()
    with torch.no_grad():
        for p in tm.parameters():
            if p.ndim == 1:
                p.add_(torch.from_numpy(_rand(rng, *p.shape)))
    jm = jcls(**cfg)
    return tm, jm, convert_torch_state_dict(jm, {k: v.numpy() for k, v in tm.state_dict().items()})


def _assert_weights(jm, params, tm, atol=WEIGHT_ATOL):
    ref = flatten_to_torch_state_dict(jm, params)
    state = tm.state_dict()
    assert sorted(ref) == sorted(state)
    for k, v in state.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(ref[k]), atol=atol, rtol=0, err_msg=k)


def _sdxl_unet_lora(rng):
    """PEFT keys on the attention projections and `ff` of SDXL_TINY's two transformer
    blocks of down block 1, attention 0, with a kohya SGM-layout twin of it."""
    peft, kohya = {}, {}
    dims = {"attn1.to_q": (64, 64), "attn1.to_k": (64, 64), "attn1.to_v": (64, 64), "attn1.to_out.0": (64, 64),
            "attn2.to_k": (64, 64), "attn2.to_v": (64, 64), "ff.net.0.proj": (64, 512), "ff.net.2": (256, 64)}
    for blk in (0, 1):
        for name, (d_in, d_out) in dims.items():
            a, b = _rand(rng, RANK, d_in), _rand(rng, d_out, RANK)
            base = f"down_blocks.1.attentions.0.transformer_blocks.{blk}.{name}"
            peft[f"unet.{base}.lora_A.weight"], peft[f"unet.{base}.lora_B.weight"] = a, b
            peft[f"unet.{base}.alpha"] = np.array(8.0, np.float32)
            flat = f"lora_unet_input_blocks_4_1_transformer_blocks_{blk}_{name.replace('.', '_')}"
            kohya[f"{flat}.lora_down.weight"], kohya[f"{flat}.lora_up.weight"] = a, b
            kohya[f"{flat}.alpha"] = np.array(8.0, np.float32)
    return peft, kohya


def test_sdxl_unet_fused_matches_jax():
    tm, jm, params = _carry(JaxUNet, UNet2DConditionModel, SDXL_TINY, seed=0)
    peft, kohya = _sdxl_unet_lora(np.random.RandomState(1))
    fused = jlora.fuse_lora(params, jlora.group_lora_weights(peft, component="unet"), scale=0.8)
    lora.fuse_lora(tm, lora.group_lora_weights(peft, component="unet"), scale=0.8)
    _assert_weights(jm, fused, tm)

    # the kohya SGM-layout twin fuses into the same modules (JAX's map finds none of them)
    tm2, _, _ = _carry(JaxUNet, UNet2DConditionModel, SDXL_TINY, seed=0)
    assert not set(jlora.group_lora_weights(kohya, component="unet")) & set(dict(tm2.named_modules()))
    lora.fuse_lora(tm2, lora.group_lora_weights(kohya, component="unet"), scale=0.8)
    for (k, v), v2 in zip(tm.state_dict().items(), tm2.state_dict().values()):
        assert torch.equal(v, v2), k

    rng = np.random.RandomState(2)
    x = rng.randn(2, 4, 16, 16).astype(np.float32)
    ehs = rng.randn(2, 8, 64).astype(np.float32)
    te, ti = rng.randn(2, 32).astype(np.float32), rng.randn(2, 6).astype(np.float32)
    run = jax.jit(lambda p, x, e, te, ti: jm(p, x, 5, e, added_cond_kwargs={"text_embeds": te, "time_ids": ti}).sample)
    ref = np.asarray(run(fused, *map(jnp.asarray, (x, ehs, te, ti))))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), 5, torch.from_numpy(ehs),
                 added_cond_kwargs={"text_embeds": torch.from_numpy(te), "time_ids": torch.from_numpy(ti)}).sample
    np.testing.assert_allclose(out.numpy(), ref, atol=MODEL_ATOL, rtol=0)


def test_flux_xlabs_fused_matches_jax():
    tm, jm, params = _carry(JaxFlux, FluxTransformer2DModel, FLUX_FLOAT, seed=3)
    sd = FORMATS["xlabs"]
    fused = jlora.fuse_lora(params, jlora.group_lora_weights(dict(sd), component="transformer"), scale=0.7)
    lora.fuse_lora(tm, lora.group_lora_weights(dict(sd), component="transformer"), scale=0.7)
    _assert_weights(jm, fused, tm)

    rng = np.random.RandomState(4)
    img, txt = 16, 8
    inputs = dict(hidden_states=rng.randn(1, img, 4), encoder_hidden_states=rng.randn(1, txt, 32),
                  pooled_projections=rng.randn(1, 32), timestep=np.array([0.7]))
    inputs = {k: v.astype(np.float32) for k, v in inputs.items()}
    ids = np.concatenate([np.zeros((txt, 3), np.float32), rng.randint(0, 4, (img, 3)).astype(np.float32)])
    cos, sin = jm.pos_embed({}, ids)
    run = jax.jit(lambda p, kw, rope: jm(p, **kw, image_rotary_emb=rope).sample)
    ref = np.asarray(run(fused, {k: jnp.asarray(v) for k, v in inputs.items()}, (jnp.asarray(cos), jnp.asarray(sin))))
    with torch.no_grad():
        out = tm(**{k: torch.from_numpy(v) for k, v in inputs.items()}, img_ids=torch.from_numpy(ids[txt:]),
                 txt_ids=torch.from_numpy(ids[:txt])).sample
    np.testing.assert_allclose(out.numpy(), ref, atol=MODEL_ATOL, rtol=0)


def test_fuse_lora_bias_and_multi_bias_jax_divergence():
    """`lora_B.bias` (a Wan ``diff_b``) adds ``scale * bias`` in `fuse_lora`, as
    JAX's; JAX's `fuse_lora_multi` (its pipelines' path) drops it, the port's
    adds it there too."""
    rng = np.random.RandomState(5)
    layer = torch.nn.Linear(8, 8)
    jparams = {"kernel": jnp.asarray(layer.weight.detach().numpy().T.copy()),
               "bias": jnp.asarray(layer.bias.detach().numpy().copy())}
    grouped = {"": (_rand(rng, 2, 8), _rand(rng, 8, 2), None, _rand(rng, 8))}
    base_bias = layer.bias.detach().clone()
    jfused = jlora.fuse_lora({"layer": jparams}, {"layer": grouped[""]}, scale=0.5)["layer"]
    wrapped = torch.nn.ModuleDict({"layer": layer})
    lora.fuse_lora(wrapped, {"layer": grouped[""]}, scale=0.5)
    np.testing.assert_allclose(layer.bias.detach().numpy(), np.asarray(jfused["bias"]), atol=WEIGHT_ATOL, rtol=0)
    np.testing.assert_allclose(layer.weight.detach().numpy(), np.asarray(jfused["kernel"]).T, atol=WEIGHT_ATOL, rtol=0)
    jmulti = jlora.fuse_lora_multi({"layer": jparams}, [({"layer": grouped[""]}, 0.5)])["layer"]
    assert np.array_equal(np.asarray(jmulti["bias"]), base_bias.numpy())  # the JAX fault
    layer2 = torch.nn.Linear(8, 8)
    with torch.no_grad():
        layer2.weight.copy_(torch.from_numpy(np.asarray(jparams["kernel"]).T.copy()))
        layer2.bias.copy_(base_bias)
    lora.fuse_lora_multi(torch.nn.ModuleDict({"layer": layer2}), [({"layer": grouped[""]}, 0.5)])
    assert torch.equal(layer2.bias, layer.bias) and torch.equal(layer2.weight, layer.weight)


def _quantized_layers():
    conv = torch.nn.Conv2d(128, 128, 1)
    return {"w8a8": W8A8Linear(128, 128), "int8_per_tensor": Int8PerTensorLinear(128, 128),
            "int8_weight_only": WeightOnlyLinear(128, 128), "fp8_weight_only": WeightOnlyLinear(
                128, 128, weight_dtype=torch.float8_e4m3fn), "int4": Int4Linear(128, 128, 1),
            "int8_conv": Int8Conv2d.like(conv)}


@pytest.mark.parametrize("kind", sorted(_quantized_layers()))
def test_lora_on_a_quantized_layer_raises(kind):
    layer = _quantized_layers()[kind]
    model = torch.nn.ModuleDict({"proj": layer})
    grouped = {"proj": (np.ones((2, 128), np.float32), np.ones((128, 2), np.float32), None, None)}
    with pytest.raises(ValueError, match=f"{type(layer).__name__}.*before quantizing"):
        lora.fuse_lora(model, grouped)
    with pytest.raises(ValueError, match="before quantizing"):
        lora.fuse_lora_multi(model, [(grouped, 1.0)])


def test_fuse_on_w8a8_rounds_away_in_jax_fault_2():
    """JAX adds the float delta to the int8 kernel and casts back, ignoring
    ``kernel_scale_w8a8``: the fused weight misses the delta by about the
    delta. The port refuses, and fusing before quantizing lands within a
    quantization step."""
    tm, jm, params = _carry(JaxFlux, FluxTransformer2DModel, FLUX_W8A8, seed=6)
    rng = np.random.RandomState(7)
    path = "single_transformer_blocks.0.proj_mlp"
    a, b = _rand(rng, RANK, 128, scale=0.5), _rand(rng, 512, RANK, scale=0.5)
    grouped = {path: (a, b, None, None)}
    delta = b @ a
    leaf = jlora._get_nested(params, [int(p) if p.isdigit() else p for p in path.split(".")])
    w = np.asarray(leaf["kernel"]).T
    qtree = quantize_tree_w8a8(jax.tree_util.tree_map(np.asarray, params))
    qleaf = jlora._get_nested(qtree, [int(p) if p.isdigit() else p for p in path.split(".")])
    step = np.asarray(qleaf["kernel_scale_w8a8"])[:, None]  # per output channel
    jfused = jlora._get_nested(jlora.fuse_lora(qtree, grouped), [int(p) if p.isdigit() else p for p in path.split(".")])
    jax_weight = np.asarray(jfused["kernel"]).T.astype(np.float32) * step
    assert np.abs(delta).max() > 20 * step.max()
    assert np.abs(jax_weight - (w + delta)).max() > 0.5 * np.abs(delta).max()

    quantize_w8a8(tm, 128 * 128)
    with pytest.raises(ValueError, match="W8A8Linear"):
        lora.fuse_lora(tm, grouped)
    tm2, _, _ = _carry(JaxFlux, FluxTransformer2DModel, FLUX_W8A8, seed=6)
    lora.fuse_lora(tm2, grouped)
    quantize_w8a8(tm2, 128 * 128)
    layer = tm2.get_submodule(path)
    port_weight = layer.weight.float().numpy() * layer.weight_scale.numpy()[:, None]
    assert np.abs(port_weight - (w + delta)).max() <= 0.5 * layer.weight_scale.numpy().max() + 1e-6


# ------------------------------------------------------------------ the pipeline's adapters

def _sd_pipeline():
    torch.manual_seed(8)
    with torch.no_grad():
        unet, vae, te = UNet2DConditionModel(**UNET_SD), AutoencoderKL(**VAE), CLIPTextModel(**CLIP)
    return StableDiffusionPipeline(vae=vae, text_encoder=te, tokenizer=CRCTokenizer(), unet=unet,
                                   scheduler=PNDMScheduler(**PNDM), device="cpu")


def _tiny_sd_lora(seed, scale_mag=0.1):
    """JAX's `tests/test_lora.py::_tiny_sd_lora`: the mid block's attn1.to_q."""
    rng = np.random.RandomState(seed)
    return {
        "unet.mid_block.attentions.0.transformer_blocks.0.attn1.to_q.lora_A.weight":
            (rng.randn(2, 16) * scale_mag).astype(np.float32),
        "unet.mid_block.attentions.0.transformer_blocks.0.attn1.to_q.lora_B.weight":
            (rng.randn(16, 2) * scale_mag).astype(np.float32),
    }


TO_Q = "mid_block.attentions.0.transformer_blocks.0.attn1.to_q"


def test_lora_runtime_set_adapters_and_unfuse():
    """JAX's sequence (`tests/test_lora.py:89`) on the port's tiny SD pipeline:
    each fused weight held to JAX's `fuse_lora_multi` on the same base."""
    pipe = _sd_pipeline()
    jm = JaxUNet(**UNET_SD)
    base_params = convert_torch_state_dict(jm, {k: v.numpy() for k, v in pipe.unet.state_dict().items()})
    latents = torch.from_numpy(np.random.RandomState(0).randn(1, 4, 8, 8).astype(np.float32))

    def call():
        return pipe("lora test", latents=latents.clone(), num_inference_steps=1, output_type="latent").images

    def held_to_jax(adapters):
        _assert_weights(jm, jlora.fuse_lora_multi(
            base_params, [(jlora.group_lora_weights(_tiny_sd_lora(s), component="unet"), w) for s, w in adapters]),
            pipe.unet)

    base_out = call()
    base_state = {k: v.clone() for k, v in pipe.unet.state_dict().items()}
    weight = pipe.unet.get_submodule(TO_Q).weight

    pipe.load_lora_weights(_tiny_sd_lora(0), adapter_name="style_a")
    a_out = call()
    assert not torch.allclose(a_out, base_out) and pipe.get_active_adapters() == {"style_a": 1.0}
    held_to_jax([(0, 1.0)])
    assert pipe.unet.get_submodule(TO_Q).weight is weight  # fused in place

    pipe.load_lora_weights(_tiny_sd_lora(1), adapter_name="style_b")
    pipe.set_adapters(["style_a", "style_b"], [0.3, 0.7])
    ab_out = call()
    assert not torch.allclose(ab_out, a_out)
    held_to_jax([(0, 0.3), (1, 0.7)])

    pipe.set_adapters("style_a", 0.5)
    assert not torch.allclose(call(), a_out)
    held_to_jax([(0, 0.5)])

    pipe.disable_lora()
    assert torch.equal(call(), base_out)
    for k, v in pipe.unet.state_dict().items():
        assert torch.equal(v, base_state[k]), k
    assert list(pipe._lora_base["unet"]) == [TO_Q]  # the one weight an adapter touches

    pipe.set_adapters("style_b")
    pipe.delete_adapters("style_b")
    assert pipe.get_active_adapters() == {}
    assert torch.equal(call(), base_out)
    pipe.delete_adapters("style_a")
    assert pipe._lora_base["unet"] == {} and pipe.unfuse_lora.__name__ == "disable_lora"


def test_hotswap_and_its_refusal():
    pipe = _sd_pipeline()
    pipe.load_lora_weights(_tiny_sd_lora(0), adapter_name="style", scale=0.6)
    weight = pipe.unet.get_submodule(TO_Q).weight
    pipe.hotswap_lora_weights(_tiny_sd_lora(1), adapter_name="style")
    reference = _sd_pipeline()
    reference.load_lora_weights(_tiny_sd_lora(1), adapter_name="other", scale=0.6)
    assert pipe.get_active_adapters() == {"style": 0.6}
    assert pipe.unet.get_submodule(TO_Q).weight is weight
    assert torch.equal(weight, reference.unet.get_submodule(TO_Q).weight)

    other_path = {k.replace("attn1.to_q", "attn1.to_k"): v for k, v in _tiny_sd_lora(2).items()}
    with pytest.raises(ValueError, match="module-path mismatch"):
        pipe.hotswap_lora_weights(other_path, adapter_name="style")
    with pytest.raises(ValueError, match="loaded first"):
        pipe.hotswap_lora_weights(_tiny_sd_lora(1), adapter_name="missing")
    with pytest.raises(ValueError, match="unknown adapter"):
        pipe.set_adapters("missing")


def test_sdxl_pipeline_text_encoders_and_prefixless_fallback(tmp_path):
    """An SDXL LoRA on the UNet and both text encoders (the kohya names of
    `lora_te1_` / `lora_te2_`, read from a safetensors file), each component
    held to JAX's `fuse_lora` of its own keys; a prefix-less checkpoint goes
    to the denoiser."""
    from diffusers_tpu.models.text_encoders.clip import CLIPTextModel as JaxCLIP
    from diffusers_tpu.models.text_encoders.clip import CLIPTextModelWithProjection as JaxCLIPProj
    from diffusers_tpu_torch.models.modeling_utils import save_safetensors

    torch.manual_seed(9)
    parts = dict(unet=UNet2DConditionModel(**SDXL_UNET), vae=AutoencoderKL(**VAE), text_encoder=CLIPTextModel(**CLIP),
                 text_encoder_2=CLIPTextModelWithProjection(**CLIP))
    pipe = StableDiffusionXLPipeline(tokenizer=CRCTokenizer(), tokenizer_2=CRCTokenizer(),
                                     scheduler=EulerDiscreteScheduler(**EULER), device="cpu", **parts)
    base = {name: convert_torch_state_dict(j(**cfg), {k: v.numpy() for k, v in parts[name].state_dict().items()})
            for name, j, cfg in (("unet", JaxUNet, SDXL_UNET), ("text_encoder", JaxCLIP, CLIP),
                                 ("text_encoder_2", JaxCLIPProj, CLIP))}
    rng = np.random.RandomState(10)
    sd = {**_pair(rng, "lora_te1_text_model_encoder_layers_1_mlp_fc1", 16, 32, alpha=2.0),
          **_pair(rng, "lora_te2_text_model_encoder_layers_0_self_attn_out_proj", 16, 16),
          **_pair(rng, "lora_unet_down_blocks_1_attentions_0_transformer_blocks_1_attn2_to_k", 32, 16)}
    path = tmp_path / "lora.safetensors"
    save_safetensors({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    pipe.load_lora_weights(str(path), adapter_name="kohya", scale=0.9)
    assert sorted(pipe._lora_base) == ["text_encoder", "text_encoder_2", "unet"]
    for name, j, cfg in (("unet", JaxUNet, SDXL_UNET), ("text_encoder", JaxCLIP, CLIP),
                         ("text_encoder_2", JaxCLIPProj, CLIP)):
        grouped = lora.group_lora_weights(dict(sd), component=name)  # JAX's own map misses the te1 path (fault 1)
        assert len(grouped) == 1
        _assert_weights(j(**cfg), jlora.fuse_lora(base[name], grouped, scale=0.9), parts[name])

    prefixless = {k.removeprefix("unet.").replace("mid_block", "down_blocks.1.attentions.0"): v
                  for k, v in _tiny_sd_lora(3).items()}
    pipe.load_lora_weights(prefixless, adapter_name="bare")
    assert set(pipe._lora_adapters["bare"]) == {"unet"}
    with pytest.raises(ValueError, match="no LoRA weights"):
        pipe.load_lora_weights({"something.else": np.zeros(2, np.float32)})

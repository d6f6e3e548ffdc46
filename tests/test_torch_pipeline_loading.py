"""The port's pipeline-level loader on the CPU: `save_pretrained` /
`from_pretrained` over `model_index.json`, against the JAX package's, with
real tokenizers; w8a8 quantization on load against JAX's `quantize_params`;
`from_pipe`, DDUF and the error paths.

The pipelines are the tiny SDXL, Flux, SD3 (with T5) and Wan pairs of
tests/test_torch_pipeline_cache.py, test_torch_pipeline_sd3.py and
test_torch_pipeline_wan.py (the port's seeded weights, carried into JAX with
`convert_torch_state_dict`), with tokenizers written in the test
(`chip_smoke.clip_tokenizer`: a CLIP vocab and merges; `chip_smoke.t5_tokenizer`:
a `tokenizers` Unigram model saved as `T5TokenizerFast`). Tolerance: bit-equal
weights and bit-equal outputs on the CPU (the loader copies bytes); the
pipelines' numerics are held to JAX by their own parity tests, so no JAX
pipeline runs here. w8a8: the selection and the int8 values and scales
bit-equal to JAX's `quantize_params`, a load through
`PipelineQuantizationConfig` bit-equal to the same model quantized in
memory.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from diffusers_tpu.models.modeling_utils import convert_torch_state_dict, flatten_to_torch_state_dict
from diffusers_tpu.models.transformers.transformer_flux import FluxTransformer2DModel as JaxFlux
from diffusers_tpu.quantizers.quantization_config import Int8DynamicActConfig as JaxInt8DynamicActConfig
from diffusers_tpu.quantizers.quantize import quantize_params
from diffusers_tpu_torch import (
    DiffusionPipeline,
    FluxPipeline,
    Fp8WeightOnlyConfig,
    Int4WeightOnlyConfig,
    Int8DynamicActConfig,
    Int8WeightOnlyConfig,
    PipelineQuantizationConfig,
    StableDiffusionXLPipeline,
)
from diffusers_tpu_torch.configuration_utils import ConfigMixin, register_to_config
from diffusers_tpu_torch.models.modeling_utils import ModelMixin
from diffusers_tpu_torch.models.transformers.transformer_flux import FluxTransformer2DModel
from diffusers_tpu_torch.ops.module import W8A8Linear
from diffusers_tpu_torch.pipelines.controlnet import StableDiffusionXLControlNetPipeline
from diffusers_tpu_torch.pipelines.stable_diffusion_xl import StableDiffusionXLImg2ImgPipeline
from diffusers_tpu_torch.quantizers import quantize_kernel_int8, quantize_linears, quantize_model, w8a8_linear_names
from diffusers_tpu_torch.utils.dduf import save_dduf
from test_torch_flux import W8A8
from test_torch_pipeline_cache import build_flux, build_sdxl
from test_torch_pipeline_sd3 import LATENTS as SD3_LATENTS, TXT_LEN as SD3_TXT_LEN, build as build_sd3
from test_torch_pipeline_wan import CALL as WAN_CALL, LATENTS as WAN_LATENTS, build as build_wan

torch.set_num_threads(1)

PROMPT = "the cat and the fox"
LATENTS = {"sdxl": np.random.RandomState(0).randn(1, 4, 8, 8).astype(np.float32),
           "flux": np.random.RandomState(0).randn(1, 16, 16).astype(np.float32)}


def _call(name, pipe):
    """Two denoise steps and the decode, from fixed latents."""
    if name == "sdxl":
        return pipe(PROMPT, latents=torch.from_numpy(LATENTS["sdxl"]), num_inference_steps=2, output_type="np").images
    if name == "flux":
        return pipe(PROMPT, latents=torch.from_numpy(LATENTS["flux"]), height=8, width=8, num_inference_steps=2,
                    max_sequence_length=8, output_type="np").images
    if name == "sd3":
        return pipe(PROMPT, latents=torch.from_numpy(SD3_LATENTS), num_inference_steps=2,
                    max_sequence_length=SD3_TXT_LEN, output_type="np").images
    return pipe(PROMPT, latents=torch.from_numpy(WAN_LATENTS), num_inference_steps=2, max_sequence_length=16,
                output_type="np", **WAN_CALL).frames


def _pair(name, tmp_path):
    """(JAX pipeline, port pipeline) with the same weights and real tokenizers."""
    if name == "sdxl":
        jpipe, tpipe = build_sdxl()[:2]
    elif name == "flux":
        jpipe, tpipe = build_flux()[:2]
    else:
        jpipe, tpipe = (build_sd3 if name == "sd3" else build_wan)()
    clip = chip_smoke.clip_tokenizer(tmp_path / "clip_tokenizer")
    t5 = chip_smoke.t5_tokenizer(tmp_path / "t5_tokenizer")
    tokenizers = {"sdxl": dict(tokenizer=clip, tokenizer_2=clip), "flux": dict(tokenizer=clip, tokenizer_2=t5),
                  "sd3": dict(tokenizer=clip, tokenizer_2=clip, tokenizer_3=t5), "wan": dict(tokenizer=t5)}[name]
    for pipe in (jpipe, tpipe):
        pipe.register_modules(**tokenizers)
    return jpipe, tpipe


def _models(pipe):
    return {k: v for k, v in pipe.components.items() if isinstance(v, torch.nn.Module)}


def _assert_same_state(a, b, label=""):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb), label
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), f"{label} {k}"


def _assert_jax_weights(jpipe, tpipe):
    """Each weight-bearing component of the JAX pipeline, bit-equal to the port's
    (a parameter its module lists in `reshape_on_load`, which JAX keeps flat,
    compared in the port's shape)."""
    for name, model in _models(tpipe).items():
        jm, params = getattr(jpipe, name)
        ref, state = flatten_to_torch_state_dict(jm, params), model.state_dict()
        assert sorted(ref) == sorted(state), name
        for k, v in state.items():
            want = np.asarray(ref[k])
            module_name, _, leaf = k.rpartition(".")
            if leaf in getattr(model.get_submodule(module_name), "reshape_on_load", ()):
                want = want.reshape(v.shape)
            np.testing.assert_array_equal(want, v.numpy(), err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", ["sdxl", "flux", "sd3", "wan"])
def test_port_round_trip(tmp_path, name):
    _, tpipe = _pair(name, tmp_path)
    before = _call(name, tpipe)
    tpipe.save_pretrained(tmp_path / "pipe")
    index = json.loads((tmp_path / "pipe" / "model_index.json").read_text())
    assert index["_class_name"] == type(tpipe).__name__ and index["_diffusers_version"]
    written = {k for k, v in index.items() if isinstance(v, list) and v[0] is not None}
    assert written == set(os.listdir(tmp_path / "pipe")) - {"model_index.json"}
    loaded = type(tpipe).from_pretrained(tmp_path / "pipe", device="cpu")
    assert set(_models(loaded)) == set(_models(tpipe))
    for key, model in _models(tpipe).items():
        _assert_same_state(model, getattr(loaded, key), key)
        assert not getattr(loaded, key).training
    assert json.loads(loaded.scheduler.to_json_string()) == json.loads(tpipe.scheduler.to_json_string())
    np.testing.assert_array_equal(_call(name, loaded), before)


@pytest.mark.parametrize("name", ["sdxl", "flux", "sd3", "wan"])
def test_directories_cross_between_packages(tmp_path, name):
    jpipe, tpipe = _pair(name, tmp_path)
    tpipe.save_pretrained(tmp_path / "port")
    _assert_jax_weights(type(jpipe).from_pretrained(str(tmp_path / "port")), tpipe)
    jpipe.save_pretrained(str(tmp_path / "jax"))
    loaded = type(tpipe).from_pretrained(tmp_path / "jax", device="cpu")
    for key, model in _models(tpipe).items():
        _assert_same_state(model, getattr(loaded, key), key)
    assert type(loaded.tokenizer).__name__ == type(tpipe.tokenizer).__name__


# ------------------------------------------------------------------ w8a8 on load
def _jax_w8a8_paths(tree, prefix=""):
    """{module path: (int8 kernel, scale)} of the leaves JAX marked w8a8."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and "kernel_scale_w8a8" in v:
            out[f"{prefix}{k}"] = (np.asarray(v["kernel"]), np.asarray(v["kernel_scale_w8a8"]))
        elif isinstance(v, dict):
            out.update(_jax_w8a8_paths(v, f"{prefix}{k}."))
    return out


def _jax_quantize_params(tree, config):
    """JAX's `quantize_params`, its ops evaluated one at a time. Under its
    `jax.jit`, XLA rewrites the scale's ``absmax / 127.0`` into a product
    with the rounded reciprocal (one f32 ulp off in about 6% of the
    channels, which moves an int8 value sitting on .5); the port keeps the
    source's division, as the eager `_quantize_kernel_int8` computes it
    (tests/test_torch_w8a8.py)."""
    with jax.disable_jit():
        return quantize_params(tree, config)


class _Gate(torch.nn.Module):
    """Linears at the edges of JAX's w8a8 gate (K >= 2560, or K >= 1280 and
    N >= 2560; at least `min_weight_size` elements)."""

    SHAPES = {"k2560": (2560, 2), "k2559": (2559, 2), "k1280_n2560": (1280, 2560), "k1280_n2559": (1280, 2559),
              "small": (2560, 1), "skip": (2560, 4)}

    def __init__(self):
        super().__init__()
        for name, (k, n) in self.SHAPES.items():
            setattr(self, name, torch.nn.Linear(k, n))


def test_w8a8_selection_matches_jax_at_the_gate():
    torch.manual_seed(0)
    model = _Gate()
    tree = {name: {"kernel": jax.numpy.asarray(m.weight.detach().numpy().T), "bias": jax.numpy.asarray(m.bias.detach().numpy())}
            for name, m in model.named_children()}
    config = dict(modules_to_not_convert=["skip"], min_weight_size=4096)
    jax_marked = _jax_w8a8_paths(_jax_quantize_params(tree, JaxInt8DynamicActConfig(**config)))
    names = w8a8_linear_names(model, Int8DynamicActConfig(**config))
    assert sorted(names) == sorted(jax_marked) == ["k1280_n2560", "k2560"]
    quantize_linears(model, names)
    for name, (kernel, scale) in jax_marked.items():
        q = getattr(model, name)
        assert isinstance(q, W8A8Linear)
        np.testing.assert_array_equal(q.weight.numpy(), kernel.T)
        np.testing.assert_array_equal(q.weight_scale.numpy(), scale)


FLUX_Q = dict(W8A8, num_attention_heads=8, num_single_layers=2)  # inner 512: proj_out's K = 512 + 2048 = 2560
FLUX_Q_CONFIG = Int8DynamicActConfig(modules_to_not_convert=["single_transformer_blocks.1"])


@pytest.fixture(scope="module")
def flux_w8a8_dir(tmp_path_factory):
    """A tiny Flux pipeline saved in float32, its transformer at FLUX_Q."""
    tmp = tmp_path_factory.mktemp("flux_w8a8")
    _, tpipe = build_flux()[:2]
    torch.manual_seed(5)
    tpipe.register_modules(transformer=FluxTransformer2DModel(**FLUX_Q).eval(),
                           tokenizer=chip_smoke.clip_tokenizer(tmp / "clip"),
                           tokenizer_2=chip_smoke.t5_tokenizer(tmp / "t5"))
    tpipe.save_pretrained(tmp / "pipe")
    return tmp / "pipe"


def test_flux_w8a8_on_load_matches_in_memory(flux_w8a8_dir):
    quant = PipelineQuantizationConfig(quant_mapping={"transformer": FLUX_Q_CONFIG})
    pipe = FluxPipeline.from_pretrained(flux_w8a8_dir, device="cpu", quantization_config=quant)
    float_model = FluxTransformer2DModel.from_pretrained(flux_w8a8_dir, subfolder="transformer", device="cpu")
    state = {k: v.numpy() for k, v in float_model.state_dict().items()}
    names = w8a8_linear_names(float_model, FLUX_Q_CONFIG)
    assert names == ["single_transformer_blocks.0.proj_out"]
    assert [n for n, m in pipe.transformer.named_modules() if isinstance(m, W8A8Linear)] == names
    assert not any(isinstance(m, W8A8Linear) for m in pipe.text_encoder_2.modules())  # only the mapped component
    # JAX's quantize_params on the same weights marks the same Linear with the same values
    jm = JaxFlux(**FLUX_Q)
    marked = _jax_w8a8_paths(_jax_quantize_params(convert_torch_state_dict(jm, state), JaxInt8DynamicActConfig(
        modules_to_not_convert=["single_transformer_blocks.1"])))
    assert sorted(marked) == names
    q = pipe.transformer.get_submodule(names[0])
    np.testing.assert_array_equal(q.weight.numpy(), marked[names[0]][0].T)
    np.testing.assert_array_equal(q.weight_scale.numpy(), marked[names[0]][1])
    # the same model quantized in memory by the same rule
    _assert_same_state(quantize_linears(float_model, names), pipe.transformer)
    before = _call("flux", pipe)
    pipe.transformer = float_model
    np.testing.assert_array_equal(_call("flux", pipe), before)


def test_w8a8_directory_reloads_with_its_config_only(flux_w8a8_dir, tmp_path):
    model = FluxTransformer2DModel.from_pretrained(flux_w8a8_dir, subfolder="transformer", device="cpu",
                                                   dtype=torch.bfloat16, quantization_config=FLUX_Q_CONFIG)
    q = model.get_submodule("single_transformer_blocks.0.proj_out")
    assert q.weight.dtype == torch.int8 and q.weight_scale.dtype == torch.float32 and q.bias.dtype == torch.bfloat16
    model.save_pretrained(tmp_path)
    again = FluxTransformer2DModel.from_pretrained(tmp_path, device="cpu", quantization_config={
        "quant_method": "int8_dynamic_activation", "modules_to_not_convert": ["single_transformer_blocks.1"]})
    _assert_same_state(model, again)
    # "torchao" is JAX's alias of the default w8a8 config: block 0's int8 weight loads as it is, block 1's
    # bf16 weight is quantized on arrival
    mixed = FluxTransformer2DModel.from_pretrained(tmp_path, device="cpu", quantization_config="torchao")
    _assert_same_state(q, mixed.get_submodule("single_transformer_blocks.0.proj_out"))
    weight, scale = quantize_kernel_int8(model.get_submodule("single_transformer_blocks.1.proj_out").weight)
    other = mixed.get_submodule("single_transformer_blocks.1.proj_out")
    assert torch.equal(other.weight, weight) and torch.equal(other.weight_scale, scale)
    with pytest.raises(ValueError, match="unexpected .*weight_scale"):
        FluxTransformer2DModel.from_pretrained(tmp_path, device="cpu")


class _WithConv(ModelMixin, ConfigMixin):
    @register_to_config
    def __init__(self, conv_in: int = 8):
        super().__init__()
        self.proj = torch.nn.Linear(2560, 2)
        self.conv = torch.nn.Conv2d(conv_in, 256, 3)


@pytest.mark.parametrize("config, item", [
    (Int8WeightOnlyConfig(), ("WeightOnlyLinear", "Conv2d")), (Fp8WeightOnlyConfig(), ("WeightOnlyLinear", "Conv2d")),
    (Int4WeightOnlyConfig(), ("Int4Linear", "Conv2d")), (Int8DynamicActConfig(impl="xla"), ("Int8PerTensorLinear", "Conv2d")),
    ("conv", ("W8A8Linear", "Int8Conv2d")),
], ids=["int8-weight-only", "fp8-weight-only", "int4-weight-only", "w8a8-xla", "w8a8-conv"])
def test_unported_quantization_configs_raise(tmp_path, config, item):
    """Each config that once raised here (ROADMAP A6.2) now loads: the layers
    JAX's rule selects become the port's quantized layers, the model equal to
    the same float model quantized in memory (`quantize_model`), bit for bit.
    (The name is kept from when these configs raised.)"""
    torch.manual_seed(0)
    model = _WithConv(conv_in=512 if config == "conv" else 8)  # fan_in 4608 x 256 out: JAX's int8 conv gate
    model.save_pretrained(tmp_path)
    config = Int8DynamicActConfig() if config == "conv" else config
    loaded = _WithConv.from_pretrained(tmp_path, device="cpu", quantization_config=config)
    assert (type(loaded.proj).__name__, type(loaded.conv).__name__) == item
    _assert_same_state(loaded, quantize_model(model, config))
    if item[0] == "WeightOnlyLinear":
        assert loaded.proj.weight.dtype == (torch.float8_e4m3fn if isinstance(config, Fp8WeightOnlyConfig)
                                            else torch.int8)
    assert len(w8a8_linear_names(_WithConv(), Int8DynamicActConfig())) == 1  # the 8-channel conv is left alone


# ------------------------------------------------------------------ from_pipe, DDUF, errors
def test_from_pipe_shares_components():
    _, tpipe = build_sdxl()[:2]
    img2img = StableDiffusionXLImg2ImgPipeline.from_pipe(tpipe)
    assert all(getattr(img2img, k) is v for k, v in tpipe.components.items())
    assert img2img.device == tpipe.device and img2img.config.force_zeros_for_empty_prompt
    controlnet = torch.nn.Linear(1, 1)  # any module: from_pipe passes it through
    cn = StableDiffusionXLControlNetPipeline.from_pipe(tpipe, controlnet=controlnet)
    assert cn.controlnet is controlnet and cn.unet is tpipe.unet
    with pytest.raises(ValueError, match="not accepted"):
        StableDiffusionXLPipeline.from_pipe(tpipe, controlnet=controlnet)


def test_dduf_round_trip(tmp_path):
    _, tpipe = _pair("sdxl", tmp_path)
    tpipe.save_pretrained(tmp_path / "pipe")
    archive = save_dduf(str(tmp_path / "pipe"), str(tmp_path / "sdxl.dduf"))
    loaded = StableDiffusionXLPipeline.from_pretrained(archive, device="cpu")
    for key, model in _models(tpipe).items():
        _assert_same_state(model, getattr(loaded, key), key)
    np.testing.assert_array_equal(_call("sdxl", loaded), _call("sdxl", tpipe))


def test_loader_error_paths(tmp_path, monkeypatch):
    _, tpipe = build_sdxl()[:2]  # stand-in tokenizers: written as listed, passed back when loading
    tpipe.save_pretrained(tmp_path / "pipe")
    tokenizers = dict(tokenizer=tpipe.tokenizer, tokenizer_2=tpipe.tokenizer_2)
    with pytest.raises(ValueError, match="CRCTokenizer.*not a class the port has.*UNet2DConditionModel"):
        StableDiffusionXLPipeline.from_pretrained(tmp_path / "pipe", device="cpu")
    # passed components are not loaded: without transformers the pipeline still loads
    monkeypatch.setitem(sys.modules, "transformers", None)
    loaded = StableDiffusionXLPipeline.from_pretrained(tmp_path / "pipe", device="cpu", **tokenizers)
    assert loaded.tokenizer is tpipe.tokenizer
    _assert_same_state(loaded.unet, tpipe.unet)
    with pytest.raises(EnvironmentError, match="hub"):
        StableDiffusionXLPipeline.from_pretrained("stabilityai/stable-diffusion-xl-base-1.0", device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        StableDiffusionXLPipeline.from_pretrained(tmp_path / "pipe", device="cpu", mesh=object())
    with pytest.raises(ValueError, match="trust_remote_code"):  # custom pipelines are ported (JAX's gate)
        DiffusionPipeline.from_pretrained(tmp_path / "pipe", device="cpu", custom_pipeline="pipeline.py")
    with pytest.raises(TypeError, match="torch_dtype"):
        StableDiffusionXLPipeline.from_pretrained(tmp_path / "pipe", device="cpu", torch_dtype=torch.float16)
    with pytest.raises(TypeError, match="CLIPVisionModelWithProjection"):
        StableDiffusionXLPipeline.from_pretrained(tmp_path / "pipe", device="cpu", image_encoder=object(), **tokenizers)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StableDiffusionXLPipeline.from_pretrained(tmp_path / "pipe", **tokenizers)

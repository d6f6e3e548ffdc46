"""The port's quantized layers beside w8a8 against the JAX package on the
CPU: the per-tensor int8 Linear (`Int8DynamicActConfig(impl="xla")`), the
int8 convolution that `Int8DynamicActConfig` takes where JAX's
`_conv_int8_eligible` holds, and the int8 / fp8 weight-only Linears.

* Quantized weights and scales bit-equal to JAX's host loader
  (`_host_maybe_quantize`, what JAX's `from_pretrained` runs) for every
  config, the conv's per-output-channel rule included.
* Each layer's forward against JAX's `Linear` / `Conv2d.__call__` given the
  same quantized params, run op by op (`jax.disable_jit()`: under jit XLA
  may turn ``/ 127`` into a product with the reciprocal, ROADMAP C3). The
  int8 routes are bit-equal in float32 and in bf16 (the same f32 quantization,
  exact int32 sums, the same epilogue); the weight-only Linears within one
  f32 ulp of the result's scale (the same dequantized weight, another
  summation order).
* The padded K / N rule of the int8 routes (`ops.int8`) bit-equal to the
  unpadded oracles, at strides, dilation and groups.
* A tiny SDXL-shaped UNet loaded with each config by the port's
  `from_pretrained` and by JAX's: the same layers quantized, bit-equal
  weights, outputs within the w8a8 bound ``0.02 * |ref|max``; a tiny SDXL
  pipeline through `PipelineQuantizationConfig`, bit-equal to the same
  pipeline quantized in memory.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from diffusers_tpu.models.modeling_utils import _host_maybe_quantize
from diffusers_tpu.models.unets.unet_2d_condition import UNet2DConditionModel as JaxUNet2DConditionModel
from diffusers_tpu.ops.module import Conv2d as JaxConv2d
from diffusers_tpu.ops.module import Linear as JaxLinear
from diffusers_tpu.quantizers import quantization_config as jqc
from diffusers_tpu_torch import Fp8WeightOnlyConfig, Int8DynamicActConfig, Int8WeightOnlyConfig
from diffusers_tpu_torch.models.modeling_utils import load_jax_params
from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
from diffusers_tpu_torch.ops.cuda.w8a8_matmul import quantize_rows, w8a8_matmul_2d
from diffusers_tpu_torch.ops.int8 import (
    gemm_operands,
    int8_conv2d,
    int8_conv2d_plain,
    int8_linear_per_tensor,
    int8_linear_per_tensor_plain,
)
from diffusers_tpu_torch.ops.module import Int8Conv2d, Int8PerTensorLinear, W8A8Linear, WeightOnlyLinear
from diffusers_tpu_torch.quantizers import (
    Int4WeightOnlyConfig,
    quantize_kernel_fp8,
    quantize_kernel_int8,
    quantize_model,
    quantized_module_names,
)

torch.set_num_threads(1)

W8A8_BOUND = 0.02
CONFIGS = {
    "w8a8": (Int8DynamicActConfig(), jqc.Int8DynamicActConfig()),
    "w8a8-xla": (Int8DynamicActConfig(impl="xla"), jqc.Int8DynamicActConfig(impl="xla")),
    "int8-weight-only": (Int8WeightOnlyConfig(), jqc.Int8WeightOnlyConfig()),
    "fp8-weight-only": (Fp8WeightOnlyConfig(), jqc.Fp8WeightOnlyConfig()),
}


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    quantize_rows.launches = w8a8_matmul_2d.launches = 0
    yield
    assert quantize_rows.launches == 0 and w8a8_matmul_2d.launches == 0  # CPU tensors: the plain versions


def _bits(a) -> np.ndarray:
    """An array's bytes as unsigned integers (fp8 and NaNs compare by bit)."""
    a = np.ascontiguousarray(np.asarray(a))
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _tbits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.uint8) if t.element_size() == 1 else t).numpy()


# ------------------------------------------------------------------ quantized weights


@pytest.mark.parametrize("case", ["w8a8", "w8a8-xla", "int8-weight-only", "fp8-weight-only", "conv"])
def test_quantized_weights_bit_equal_to_jax_host_loader(case):
    rng = np.random.RandomState(0)
    if case == "conv":
        weight = (rng.randn(256, 320, 3, 3) * 0.03).astype(np.float32)  # OIHW: fan-in 2880 x 256 out
        weight[3] = 0.0  # an all-zero channel: the 1e-8 floor
        ref = _host_maybe_quantize(weight.transpose(2, 3, 1, 0), jqc.Int8DynamicActConfig(), "conv")
        q, scale = quantize_kernel_int8(torch.from_numpy(weight))
        np.testing.assert_array_equal(q.numpy(), ref["kernel"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(scale.numpy(), ref["kernel_scale_w8a8"])
        return
    weight = (rng.randn(384, 2560) * np.exp(rng.randn(384, 1))).astype(np.float32)  # [out, in], rows of any scale
    weight[5] = 0.0
    ref = _host_maybe_quantize(weight.T.copy(), CONFIGS[case][1], "proj")
    scale_key = next(k for k in ref if k.startswith("kernel_scale"))
    assert scale_key == {"w8a8": "kernel_scale_w8a8", "w8a8-xla": "kernel_scale_i8x"}.get(case, "kernel_scale")
    fp8 = case == "fp8-weight-only"
    q, scale = (quantize_kernel_fp8 if fp8 else quantize_kernel_int8)(torch.from_numpy(weight))
    assert q.dtype == (torch.float8_e4m3fn if fp8 else torch.int8) and scale.dtype == torch.float32
    np.testing.assert_array_equal(_tbits(q), _bits(ref["kernel"].T))
    np.testing.assert_array_equal(scale.numpy(), ref[scale_key])


# ------------------------------------------------------------------ layer forwards against JAX


def _jax_linear_params(lin: nn.Module):
    params = {"kernel": jnp.asarray(lin.weight.T.contiguous().view(torch.uint8).numpy().view(
        {torch.int8: np.int8, torch.float8_e4m3fn: jnp.float8_e4m3fn}[lin.weight.dtype]))}
    key = {Int8PerTensorLinear: "kernel_scale_i8x", W8A8Linear: "kernel_scale_w8a8"}.get(type(lin), "kernel_scale")
    params[key] = jnp.asarray(lin.weight_scale.numpy())
    if lin.bias is not None:
        params["bias"] = jnp.asarray(lin.bias.detach().float().numpy())
    return params


@pytest.mark.parametrize("case", ["w8a8-xla", "int8-weight-only", "fp8-weight-only"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_forward_matches_jax(case, dtype):
    torch.manual_seed(1)
    float_model = nn.ModuleDict({"lin": nn.Linear(2560, 384)})
    lin = quantize_model(float_model, CONFIGS[case][0])["lin"]
    assert type(lin) is {"w8a8-xla": Int8PerTensorLinear}.get(case, WeightOnlyLinear)
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 7, 2560).astype(np.float32) * 3)
    tdtype, jdtype = getattr(torch, dtype), getattr(jnp, dtype)
    with torch.no_grad():
        out = lin.to(tdtype)(x.to(tdtype)).float().numpy()
    with jax.disable_jit():
        ref = np.asarray(JaxLinear(2560, 384)(_jax_linear_params(lin), jnp.asarray(x.numpy()).astype(jdtype)),
                         np.float32)
    if case == "w8a8-xla":
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out, int8_linear_per_tensor_plain(
            x.to(tdtype), lin.weight, lin.weight_scale, lin.bias).detach().float().numpy())
    else:  # the same dequantized weight, another summation order
        scale = np.abs(ref).max()
        tol = (1e-6 if dtype == "float32" else 2 ** -7) * scale
        assert np.abs(out - ref).max() <= tol, (np.abs(out - ref).max(), tol)


@pytest.mark.parametrize("geometry", [
    dict(cin=320, cout=256, k=3, stride=1, padding=1),  # K = 2880, padded to 2944; N 256
    dict(cin=300, cout=300, k=3, stride=2, padding=(1, 0)),  # K and N padded, a stride
    dict(cin=288, cout=260, k=3, stride=1, padding=2, dilation=2),
    dict(cin=2560, cout=256, k=1, stride=1, padding=0),  # 1x1, aligned: no copy of the weight
], ids=["sdxl-320", "strided", "dilated", "one-by-one"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_conv_matches_jax(geometry, dtype):
    g = dict(geometry)
    torch.manual_seed(3)
    conv = nn.Conv2d(g["cin"], g["cout"], g["k"], stride=g["stride"], padding=g["padding"],
                     dilation=g.get("dilation", 1))
    qconv = quantize_model(nn.ModuleDict({"conv": conv}), Int8DynamicActConfig())["conv"]
    assert isinstance(qconv, Int8Conv2d)
    x = torch.from_numpy(np.random.RandomState(4).randn(2, g["cin"], 9, 11).astype(np.float32))
    tdtype, jdtype = getattr(torch, dtype), getattr(jnp, dtype)
    with torch.no_grad():
        qconv = qconv.to(tdtype)
        out = qconv(x.to(tdtype))
        plain = int8_conv2d_plain(x.to(tdtype), qconv.weight, qconv.weight_scale, qconv.bias, qconv.stride,
                                  qconv.padding, qconv.dilation)
    jconv = JaxConv2d(g["cin"], g["cout"], g["k"], stride=g["stride"], padding=g["padding"],
                      dilation=g.get("dilation", 1))
    params = {"kernel": jnp.asarray(qconv.weight.numpy().transpose(2, 3, 1, 0)),
              "kernel_scale_w8a8": jnp.asarray(qconv.weight_scale.numpy()),
              "bias": jnp.asarray(qconv.bias.detach().float().numpy()).astype(jdtype)}
    with jax.disable_jit():
        ref = np.asarray(jconv(params, jnp.asarray(x.numpy().transpose(0, 2, 3, 1)).astype(jdtype)),
                         np.float32).transpose(0, 3, 1, 2)
    assert out.shape == plain.shape == ref.shape
    np.testing.assert_array_equal(out.float().numpy(), plain.float().numpy())
    np.testing.assert_array_equal(out.float().numpy(), ref)
    (qw, _, _), = gemm_operands(qconv.weight, qconv.weight_scale, qconv.bias)
    assert qw.shape[0] % 128 == 0 and qw.shape[1] % 128 == 0
    if geometry["cin"] == 2560:
        assert qw.data_ptr() == qconv.weight.data_ptr()  # an aligned weight is used in place


# ------------------------------------------------------------------ the padded K / N rule


@pytest.mark.parametrize("k, n", [(200, 72), (2560, 200), (130, 129), (256, 384)])
def test_padded_linear_equals_the_exact_unpadded_sum(k, n):
    rng = np.random.RandomState(k + n)
    weight, scale = quantize_kernel_int8(torch.from_numpy(rng.randn(n, k).astype(np.float32)))
    bias = torch.from_numpy(rng.randn(n).astype(np.float32))
    x = torch.from_numpy(rng.randn(3, 5, k).astype(np.float32))
    ops = gemm_operands(weight, scale, bias)
    assert ops[0][0].shape == (-(-n // 128) * 128, -(-k // 128) * 128)
    np.testing.assert_array_equal(int8_linear_per_tensor(x, ops, n).numpy(),
                                  int8_linear_per_tensor_plain(x, weight, scale, bias).numpy())


def test_grouped_int8_conv_takes_one_gemm_a_group():
    rng = np.random.RandomState(5)
    weight, scale = quantize_kernel_int8(torch.from_numpy(rng.randn(192, 48, 3, 3).astype(np.float32)))
    bias = torch.from_numpy(rng.randn(192).astype(np.float32))
    x = torch.from_numpy(rng.randn(2, 96, 6, 6).astype(np.float32))
    ops = gemm_operands(weight, scale, bias, groups=2)
    assert len(ops) == 2 and ops[0][0].shape == (128, 512)
    out = int8_conv2d(x, ops, 192, (3, 3), (1, 1), 1, (1, 1), groups=2)
    np.testing.assert_array_equal(out.numpy(), int8_conv2d_plain(x, weight, scale, bias, 1, 1, 1, groups=2).numpy())


# ------------------------------------------------------------------ a tiny SDXL UNet on load


# SDXL's layout at small widths where JAX's gates still take layers: a 2560-wide time embedding (its
# linear_2 and every resnet's time_emb_proj have K = 2560) and 320-channel 3x3 convs (fan-in 2880)
UNET_Q = dict(
    sample_size=8, in_channels=4, out_channels=4,
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"), up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
    block_out_channels=(32, 320), layers_per_block=1, attention_head_dim=(1, 5), cross_attention_dim=32,
    use_linear_projection=True, addition_embed_type="text_time", addition_time_embed_dim=8,
    projection_class_embeddings_input_dim=32 + 6 * 8, time_embedding_dim=2560,
)


@pytest.fixture(scope="module")
def unet_dir(tmp_path_factory):
    torch.manual_seed(6)
    path = tmp_path_factory.mktemp("unet_q")
    UNet2DConditionModel(**UNET_Q).save_pretrained(path)
    return path


def _jax_leaf(params, name):
    node = params
    for part in name.split("."):
        node = node[int(part) if part.isdigit() else part]
    return node


@pytest.mark.parametrize("case", ["w8a8", "w8a8-xla", "int8-weight-only", "fp8-weight-only"])
def test_tiny_sdxl_unet_on_load_matches_jax(unet_dir, case):
    config, jconfig = CONFIGS[case]
    model = UNet2DConditionModel.from_pretrained(unet_dir, device="cpu", quantization_config=config)
    jm, params = JaxUNet2DConditionModel.from_pretrained(str(unet_dir), quantization_config=jconfig)
    quantized = {n: m for n, m in model.named_modules() if type(m).__name__ in (
        "W8A8Linear", "Int8PerTensorLinear", "Int8Conv2d", "WeightOnlyLinear")}
    float_model = UNet2DConditionModel.from_pretrained(unet_dir, device="cpu")
    assert sorted(quantized) == sorted(quantized_module_names(float_model, config))
    kinds = {type(m).__name__ for m in quantized.values()}
    assert kinds == {"w8a8": {"W8A8Linear", "Int8Conv2d"}, "w8a8-xla": {"Int8PerTensorLinear", "Int8Conv2d"}}.get(
        case, {"WeightOnlyLinear"})
    assert sum(isinstance(m, Int8Conv2d) for m in quantized.values()) == (10 if case.startswith("w8a8") else 0)
    marked = [p for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]
              if str(p[-1].key).startswith("kernel_scale")]
    assert len(marked) == len(quantized)
    for name, layer in quantized.items():  # JAX marked the same layers with the same values
        leaf = _jax_leaf(params, name)
        scale_key = next(k for k in leaf if k.startswith("kernel_scale"))
        kernel = np.asarray(leaf["kernel"])
        kernel = kernel.transpose(3, 2, 0, 1) if kernel.ndim == 4 else kernel.T
        np.testing.assert_array_equal(_tbits(layer.weight), _bits(kernel), err_msg=name)
        np.testing.assert_array_equal(layer.weight_scale.numpy(), np.asarray(leaf[scale_key]), err_msg=name)
    rng = np.random.RandomState(7)
    sample = rng.randn(2, 4, 8, 8).astype(np.float32)
    ehs = rng.randn(2, 77, 32).astype(np.float32)
    cond = {"text_embeds": rng.randn(2, 32).astype(np.float32),
            "time_ids": np.tile(np.array([[64, 64, 0, 0, 64, 64]], np.float32), (2, 1))}
    t = np.array([981, 981])
    ref = np.asarray(jax.jit(lambda p, x, e, c: jm(p, x, jnp.asarray(t), encoder_hidden_states=e,
                                                   added_cond_kwargs=c).sample)(
        params, jnp.asarray(sample), jnp.asarray(ehs), {k: jnp.asarray(v) for k, v in cond.items()}))
    with torch.no_grad():
        out = model(torch.from_numpy(sample), torch.from_numpy(t), torch.from_numpy(ehs),
                    added_cond_kwargs={k: torch.from_numpy(v) for k, v in cond.items()}).sample.numpy()
        dense = float_model(torch.from_numpy(sample), torch.from_numpy(t), torch.from_numpy(ehs),
                            added_cond_kwargs={k: torch.from_numpy(v) for k, v in cond.items()}).sample.numpy()
    assert np.isfinite(out).all()
    assert np.abs(out - ref).max() <= W8A8_BOUND * np.abs(ref).max()
    assert np.abs(out - dense).max() <= 0.1 * np.abs(dense).max()  # quantized, yet the same model
    # the port's save of the quantized model reloads as it is, with its config
    return_path = unet_dir.parent / f"saved_{case}"
    model.save_pretrained(return_path)
    again = UNet2DConditionModel.from_pretrained(return_path, device="cpu", quantization_config=config)
    for (k, a), (k2, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert k == k2 and a.dtype == b.dtype and np.array_equal(_tbits(a) if a.element_size() == 1 else a.numpy(),
                                                                 _tbits(b) if b.element_size() == 1 else b.numpy())


def test_load_jax_params_takes_every_scale_key():
    """A JAX tree quantized by each config becomes the port's layers through
    `load_jax_params` (int4 included), with bit-equal state."""
    torch.manual_seed(8)
    layers = nn.ModuleDict({"lin": nn.Linear(2560, 256), "conv": nn.Conv2d(320, 256, 3, padding=1)})
    for config, kinds in ((Int8DynamicActConfig(impl="xla"), ("Int8PerTensorLinear", "Int8Conv2d")),
                          (Fp8WeightOnlyConfig(), ("WeightOnlyLinear", "Conv2d")),
                          (Int4WeightOnlyConfig(), ("Int4Linear", "Conv2d"))):
        import copy

        quantized = quantize_model(copy.deepcopy(layers), config)
        tree = {}
        for name, m in quantized.items():
            if isinstance(m, nn.Conv2d):
                tree[name] = {"kernel": m.weight.detach().numpy().transpose(2, 3, 1, 0),
                              "bias": m.bias.detach().numpy()}
            elif isinstance(m, Int8Conv2d):
                tree[name] = {"kernel": m.weight.numpy().transpose(2, 3, 1, 0),
                              "kernel_scale_w8a8": m.weight_scale.numpy(), "bias": m.bias.detach().numpy()}
            elif type(m).__name__ == "Int4Linear":
                tree[name] = {"kernel": m.weight.numpy().T, "kernel_scale_int4": m.weight_scale.numpy().T,
                              "bias": m.bias.detach().numpy()}
            else:
                tree[name] = {k: np.asarray(v) for k, v in _jax_linear_params(m).items()}
        loaded = load_jax_params(copy.deepcopy(layers), tree)
        assert tuple(type(loaded[n]).__name__ for n in ("lin", "conv")) == kinds
        for k, v in quantized.state_dict().items():
            w = loaded.state_dict()[k]
            assert v.dtype == w.dtype and np.array_equal(_tbits(v) if v.element_size() == 1 else v.numpy(),
                                                         _tbits(w) if w.element_size() == 1 else w.numpy()), k


@pytest.mark.parametrize("case", ["w8a8", "w8a8-xla", "int8-weight-only", "fp8-weight-only"])
def test_sdxl_pipeline_quantization_config_on_load(tmp_path, case):
    """`PipelineQuantizationConfig(quant_mapping={"unet": config})` loads an
    SDXL pipeline with its UNet quantized by JAX's rule and nothing else;
    two steps equal, bit for bit, the float pipeline whose UNet is
    quantized in memory (`quantize_model`)."""
    from diffusers_tpu_torch import PipelineQuantizationConfig, StableDiffusionXLPipeline
    from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
    from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel, CLIPTextModelWithProjection
    from diffusers_tpu_torch.schedulers import EulerDiscreteScheduler
    from test_torch_pipeline_sdxl import CLIP, EULER, VAE, CRCTokenizer

    config = CONFIGS[case][0]
    torch.manual_seed(9)
    tokenizers = dict(tokenizer=CRCTokenizer(), tokenizer_2=CRCTokenizer())
    pipe = StableDiffusionXLPipeline(
        vae=AutoencoderKL(**VAE), text_encoder=CLIPTextModel(**CLIP),
        text_encoder_2=CLIPTextModelWithProjection(**CLIP),
        unet=UNet2DConditionModel(**dict(UNET_Q, projection_class_embeddings_input_dim=16 + 6 * 8)),
        scheduler=EulerDiscreteScheduler(**EULER), device="cpu", **tokenizers)
    pipe.save_pretrained(tmp_path / "pipe")
    loaded = StableDiffusionXLPipeline.from_pretrained(
        tmp_path / "pipe", device="cpu", quantization_config=PipelineQuantizationConfig(quant_mapping={"unet": config}),
        **tokenizers)
    names = quantized_module_names(pipe.unet, config)
    assert names and [n for n, m in loaded.unet.named_modules() if type(m).__name__ in (
        "W8A8Linear", "Int8PerTensorLinear", "Int8Conv2d", "WeightOnlyLinear")] == names
    assert not any(type(m).__name__ == "WeightOnlyLinear" for m in loaded.text_encoder_2.modules())
    quantize_model(pipe.unet, config)
    kwargs = dict(latents=torch.from_numpy(np.random.RandomState(0).randn(1, 4, 8, 8).astype(np.float32)),
                  num_inference_steps=2, output_type="latent")
    np.testing.assert_array_equal(loaded("a red barn", **kwargs).images.numpy(),
                                  pipe("a red barn", **kwargs).images.numpy())

"""The port's group-wise int4 weight-only quantization against the JAX
package on the CPU: nibble packing bit-equal to JAX's eager
`_quantize_kernel_int4` (a dividing, a non-dividing and an odd input dim),
the unpack and the dequant equal, an `Int4Linear` and a tiny int4 T5
against JAX's int4 `Linear` branch, the `Int4WeightOnlyConfig` selection
equal to JAX's `quantize_params`, `from_pretrained(quantization_config=...)`
on a saved tiny T5, bench.py's rule on T5-XXL's shapes (built on the meta
device), and JAX's jitted scales beside the eager ones (ROADMAP C3).

Tolerances: packing, scales, unpack and dequant bit for bit; the Linear and
the T5 in float32 within `1e-5` (the same dequantized weight in both, so the
differences are summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from diffusers_tpu.models.text_encoders.t5 import T5EncoderModel as JaxT5EncoderModel
from diffusers_tpu.models.transformers.transformer_flux import FluxTransformer2DModel as JaxFlux
from diffusers_tpu.ops.module import Linear as JaxLinear
from diffusers_tpu.quantizers.quantization_config import Fp8WeightOnlyConfig as JaxFp8WeightOnlyConfig
from diffusers_tpu.quantizers.quantization_config import Int4WeightOnlyConfig as JaxInt4Config
from diffusers_tpu.quantizers.quantization_config import Int8DynamicActConfig as JaxInt8DynamicActConfig
from diffusers_tpu.quantizers.quantization_config import Int8WeightOnlyConfig as JaxInt8WeightOnlyConfig
from diffusers_tpu.quantizers.quantize import (
    _quantize_kernel_int4,
    dequantize_int4 as jax_dequantize_int4,
    quantize_params,
    unpack_int4_rows as jax_unpack,
)
from diffusers_tpu_torch import Int4WeightOnlyConfig
from diffusers_tpu_torch.models.modeling_utils import load_jax_params
from diffusers_tpu_torch.models.text_encoders.t5 import T5EncoderModel
from diffusers_tpu_torch.models.transformers.transformer_flux import FluxTransformer2DModel
from diffusers_tpu_torch.ops.module import Int4Linear
from diffusers_tpu_torch.quantizers import (
    dequantize_int4,
    int4_linear_names,
    quantize_int4,
    quantize_int4_linears,
    quantize_kernel_fp8,
    quantize_kernel_int4,
    quantize_kernel_int8,
    unpack_int4_rows,
)
from test_torch_models import carry_params, jax_tree

torch.set_num_threads(1)

ATOL = 1e-5
T5_TINY = dict(vocab_size=1000, d_model=128, d_kv=32, d_ff=256, num_layers=2, num_heads=4,
               feed_forward_proj="gated-gelu")
FLUX_TINY = dict(patch_size=1, in_channels=16, num_layers=1, num_single_layers=1, attention_head_dim=32,
                 num_attention_heads=2, joint_attention_dim=96, pooled_projection_dim=32, guidance_embeds=True,
                 axes_dims_rope=(8, 12, 12))
T5_XXL = dict(vocab_size=32128, d_model=4096, d_kv=64, d_ff=10240, num_layers=24, num_heads=64,
              feed_forward_proj="gated-gelu")


def _kernel(in_dim, out_dim, seed=0):
    return (np.random.RandomState(seed).randn(in_dim, out_dim) * 0.05).astype(np.float32)  # JAX's [in, out]


@pytest.mark.parametrize("in_dim", [256, 100, 77], ids=["two-groups", "one-group", "odd"])
def test_packing_bit_equal_to_jax_eager(in_dim):
    kernel = _kernel(in_dim, 96)
    q_ref, s_ref = _quantize_kernel_int4(jnp.asarray(kernel), 128)  # eager: op by op, a true division
    packed, scale = quantize_kernel_int4(torch.from_numpy(kernel.T.copy()), 128)
    assert packed.dtype == torch.int8 and packed.shape == (96, (in_dim + 1) // 2)
    assert scale.shape == (96, in_dim // 128 if in_dim % 128 == 0 else 1)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(q_ref).T)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(s_ref).T)
    np.testing.assert_array_equal(unpack_int4_rows(packed, in_dim, torch.float32).numpy(),
                                  np.asarray(jax_unpack(q_ref, in_dim, jnp.float32)).T)
    deq = dequantize_int4(packed, scale, torch.float32, in_dim)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jax_dequantize_int4(q_ref, s_ref, jnp.float32, in_dim)).T)
    assert float((deq - torch.from_numpy(kernel.T)).abs().max()) <= float(scale.max()) / 2 * (1 + 1e-6)


def test_every_nibble_round_trips():
    q = torch.arange(-8, 8, dtype=torch.int8).repeat(3, 2)  # every int4 value at both nibble positions
    from diffusers_tpu_torch.quantizers import pack_int4_rows

    assert torch.equal(unpack_int4_rows(pack_int4_rows(q), q.shape[1], torch.int16), q.to(torch.int16))


def test_jit_scales_beside_eager():
    """JAX's `quantize_params` quantizes the whole tree under one `jax.jit`,
    where XLA turns ``absmax / 7`` into a product with the reciprocal: its
    scales are the eager quantizer's within one f32 ulp (measured: 990 of
    2,048 differ, no nibble), and its nibbles within one step (ROADMAP C3).
    The port takes the eager rule: bit-equal to `quantize_params` with jit
    disabled. The int8 (per row, per tensor, weight-only, conv) and fp8
    scales take the same rule, held the same way."""
    kernel = _kernel(1024, 256, seed=3)
    tree = {"layer": {"kernel": jnp.asarray(kernel)}}
    jitted = quantize_params(tree, JaxInt4Config(min_weight_size=0))["layer"]
    packed, scale = quantize_kernel_int4(torch.from_numpy(kernel.T.copy()), 128)
    with jax.disable_jit():
        eager = quantize_params(tree, JaxInt4Config(min_weight_size=0))["layer"]
    np.testing.assert_array_equal(np.asarray(eager["kernel_scale_int4"]).T, scale.numpy())
    np.testing.assert_array_equal(np.asarray(eager["kernel"]).T, packed.numpy())
    s_jit = np.asarray(jitted["kernel_scale_int4"]).T
    ulps = np.abs(s_jit.view(np.int32).astype(np.int64) - scale.numpy().view(np.int32).astype(np.int64))
    assert ulps.max() <= 1, ulps.max()
    steps = np.abs(np.asarray(jax_unpack(jitted["kernel"], 1024, jnp.float32)).T
                   - unpack_int4_rows(packed, 1024, torch.float32).numpy())
    assert steps.max() <= 1
    # the same rule for the int8 per-row (w8a8, per-tensor and weight-only), fp8 and int8 conv scales
    conv = (np.random.RandomState(4).randn(3, 3, 320, 256) * 0.05).astype(np.float32)  # HWIO
    kernel = _kernel(2560, 256, seed=5)  # K 2560: w8a8's gate takes it
    tree = {"layer": {"kernel": jnp.asarray(kernel)}, "conv": {"kernel": jnp.asarray(conv)}}
    for config, key, port in ((JaxInt8DynamicActConfig(min_weight_size=0), "kernel_scale_w8a8", quantize_kernel_int8),
                              (JaxInt8DynamicActConfig(min_weight_size=0, impl="xla"), "kernel_scale_i8x",
                               quantize_kernel_int8),
                              (JaxInt8WeightOnlyConfig(min_weight_size=0), "kernel_scale", quantize_kernel_int8),
                              (JaxFp8WeightOnlyConfig(min_weight_size=0), "kernel_scale", quantize_kernel_fp8)):
        jitted = quantize_params(tree, config)
        with jax.disable_jit():
            eager = quantize_params(tree, config)
        leaves = [("layer", kernel.T, (1, 0))] + ([("conv", conv.transpose(3, 2, 0, 1), (3, 2, 0, 1))]
                                                  if "w8a8" in key or "i8x" in key else [])
        for name, weight, to_torch in leaves:
            q, scale = port(torch.from_numpy(weight.copy()))
            scale_key = "kernel_scale_w8a8" if name == "conv" else key
            np.testing.assert_array_equal(np.asarray(eager[name][scale_key]), scale.numpy())
            q_eager = np.asarray(eager[name]["kernel"]).transpose(to_torch)
            q_bytes = (q.view(torch.uint8) if q.dtype == torch.float8_e4m3fn else q).numpy()
            np.testing.assert_array_equal(np.ascontiguousarray(q_eager).view(q_bytes.dtype), q_bytes)
            s_jit = np.asarray(jitted[name][scale_key])
            ulps = np.abs(s_jit.view(np.int32).astype(np.int64) - scale.numpy().view(np.int32).astype(np.int64))
            assert ulps.max() <= 1, (name, key, ulps.max())


def test_int4_linear_matches_jax():
    kernel, bias = _kernel(256, 192, seed=1), np.random.RandomState(2).randn(192).astype(np.float32)
    q, s = _quantize_kernel_int4(jnp.asarray(kernel), 128)
    params = {"kernel": q, "kernel_scale_int4": s, "bias": jnp.asarray(bias)}
    x = np.random.RandomState(4).randn(3, 5, 256).astype(np.float32)
    ref = jax.jit(lambda p, x: JaxLinear(256, 192)(p, x))(params, jnp.asarray(x))
    lin = load_jax_params(nn.ModuleDict({"lin": nn.Linear(256, 192)}),
                          {"lin": jax.tree_util.tree_map(np.asarray, params)})["lin"]
    assert isinstance(lin, Int4Linear) and lin.weight_scale.shape == (192, 2)
    with torch.no_grad():
        out = lin(torch.from_numpy(x))
        plain = torch.from_numpy(x) @ dequantize_int4(lin.weight, lin.weight_scale, torch.float32, 256).T + lin.bias
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=ATOL, rtol=0)
    lin.to(torch.bfloat16)  # a dtype cast keeps the packed weight and the f32 scales
    assert lin.weight.dtype == torch.int8 and lin.weight_scale.dtype == torch.float32
    assert lin.bias.dtype == torch.bfloat16


def _jax_int4_paths(tree, prefix=""):
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            if "kernel_scale_int4" in v:
                out.append(f"{prefix}{k}")
            else:
                out.extend(_jax_int4_paths(v, f"{prefix}{k}."))
    return sorted(out)


@pytest.mark.parametrize("model", ["t5", "flux"])
def test_selection_equals_jax(model):
    """`Int4WeightOnlyConfig`'s selection (min_weight_size, modules_to_not_convert)
    marks the Linears JAX's `quantize_params` marks ``kernel_scale_int4``."""
    jcls, tcls, cfg = (JaxT5EncoderModel, T5EncoderModel, T5_TINY) if model == "t5" else (
        JaxFlux, FluxTransformer2DModel, FLUX_TINY)
    jm, tm = jcls(**cfg), tcls(**cfg)
    params = carry_params(jm, tcls(**cfg))  # a seeded port's weights in JAX (JAX's eager init is slow)
    for kw in (dict(min_weight_size=4096), dict(min_weight_size=8192, modules_to_not_convert=["layer.1", "ff"])):
        jq = quantize_params(params, JaxInt4Config(**kw))
        assert sorted(int4_linear_names(tm, Int4WeightOnlyConfig(**kw))) == _jax_int4_paths(jq)


def _tiny_t5_pair():
    jm, tm = JaxT5EncoderModel(**T5_TINY), T5EncoderModel(**T5_TINY)
    return jm, tm, jax_tree(jm, T5EncoderModel(**T5_TINY))


def test_int4_t5_matches_jax():
    """A tiny T5 with JAX's int4 tree (every Linear of >= 4096 elements,
    group 128: the 128-wide projections take one group of 128, the 256-wide
    `wo` two) carried into the port: its encode within 1e-5 of JAX's."""
    jm, tm, tree = _tiny_t5_pair()
    jq = jax.tree_util.tree_map(np.asarray, quantize_params(jax.tree_util.tree_map(jnp.asarray, tree),
                                                            JaxInt4Config()))
    load_jax_params(tm, jq)
    assert sum(isinstance(m, Int4Linear) for m in tm.modules()) == len(_jax_int4_paths(jq)) == 2 * 7
    ids = np.random.RandomState(1).randint(0, 1000, (2, 24))
    ref = jax.jit(lambda p, i: jm(p, i).last_hidden_state)(jax.tree_util.tree_map(jnp.asarray, jq), jnp.asarray(ids))
    with torch.no_grad():
        out = tm.eval()(torch.from_numpy(ids)).last_hidden_state
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_from_pretrained_int4(tmp_path):
    """`from_pretrained(quantization_config=Int4WeightOnlyConfig())` packs
    each selected float weight on arrival, bit-equal to quantizing the loaded
    float model; the port's own int4 save loads back as it is."""
    _, tm, tree = _tiny_t5_pair()
    load_jax_params(tm, tree)
    tm.save_pretrained(tmp_path / "float")
    config = Int4WeightOnlyConfig(modules_to_not_convert=["block.1.layer.1"])
    q = T5EncoderModel.from_pretrained(tmp_path / "float", device="cpu", quantization_config=config)
    want = quantize_int4_linears(T5EncoderModel.from_pretrained(tmp_path / "float", device="cpu"),
                                 int4_linear_names(tm, config), config.group_size)
    assert sum(isinstance(m, Int4Linear) for m in q.modules()) == 14 - 3  # block 1's feed-forward stays float
    assert q.state_dict().keys() == want.state_dict().keys()
    assert all(torch.equal(q.state_dict()[k], want.state_dict()[k]) for k in want.state_dict())
    q.save_pretrained(tmp_path / "int4")
    again = T5EncoderModel.from_pretrained(tmp_path / "int4", device="cpu", quantization_config={
        "quant_method": "int4_weight_only", "modules_to_not_convert": ["block.1.layer.1"]})
    assert all(torch.equal(again.state_dict()[k], want.state_dict()[k]) for k in want.state_dict())
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 1000, (1, 12)))
    with torch.no_grad():
        torch.testing.assert_close(again(ids).last_hidden_state, want(ids).last_hidden_state, rtol=0, atol=0)


def test_bench_rule_on_t5_xxl_shapes():
    """bench.py's T5-XXL (`build_t5_xxl_int4`): every 2-D Linear of >= 2^20
    elements int4, group 128 (every T5-XXL input dim divides it), built on the
    meta device. The selection is JAX's shapes' under that rule; the tower
    holds 4.76 B parameters, its packed weights and f32 scales 2.46 GB, and
    with the rest in bf16 (the 32128 x 4096 embedding, the norms) 2.72 GB:
    bench.py's "~2.7 GB incl. scales" (its resident bytes on the card are
    chip_smoke.py's to measure)."""
    jm = JaxT5EncoderModel(**T5_XXL)
    shapes = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0), dtype=jnp.bfloat16))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    jax_selected = sorted(".".join(str(getattr(k, "key", k)) for k in path[:-1]) for path, leaf in flat
                          if getattr(path[-1], "key", None) == "kernel" and len(leaf.shape) == 2
                          and leaf.shape[0] * leaf.shape[1] >= 2**20)
    with torch.device("meta"):
        tm = T5EncoderModel(**T5_XXL)
    n_params = sum(p.numel() for p in tm.parameters())
    quantize_int4(tm, min_weight_size=2**20, group_size=128)
    int4 = {n: m for n, m in tm.named_modules() if isinstance(m, Int4Linear)}
    assert sorted(int4) == jax_selected and len(int4) == 24 * 7
    assert all(m.weight_scale.shape[1] == m.in_features // 128 for m in int4.values())
    packed_bytes = sum(m.weight.numel() + 4 * m.weight_scale.numel() for m in int4.values())
    rest_bytes = 2 * sum(p.numel() for n, p in tm.named_parameters() if n.rpartition(".")[0] not in int4)
    assert abs(n_params / 1e9 - 4.76) < 0.005 and abs(packed_bytes / 1e9 - 2.46) < 0.005, (n_params, packed_bytes)
    assert abs((packed_bytes + rest_bytes) / 1e9 - 2.72) < 0.005, rest_bytes

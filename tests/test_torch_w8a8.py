"""The port's w8a8 matmul (K5's plain version, `quantize_rows`, the dequant
rule, the quantizer and `W8A8Linear`) against the JAX package on the CPU.

Inputs are seeded numpy arrays handed to both packages. The JAX side runs
`w8a8_matmul` with the Pallas kernel in interpret mode. Tolerance: exact
equality. Quantization is discontinuous (one flipped qx moves an output by
about x_scale * w_scale * |qw|), but here both sides quantize the same f32
values with the same f32 operations (absmax, a true division by 127, round
half to even, clip), and the int32 sums are exact, so nothing may differ; the
dequant rule for shapes that do not tile is a float matmul, held to `1e-5`
(summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.ops import module as jmod
from diffusers_tpu.ops.pallas.quantized_matmul import quantize_rows as jax_quantize_rows
from diffusers_tpu.ops.pallas.quantized_matmul import w8a8_matmul as jax_w8a8_matmul
from diffusers_tpu.quantizers.quantize import _quantize_kernel_int8
from diffusers_tpu_torch.models.modeling_utils import load_jax_params
from diffusers_tpu_torch.ops import module as tmod
from diffusers_tpu_torch.ops.cuda.w8a8_matmul import quantize_rows, w8a8_matmul, w8a8_matmul_2d
from diffusers_tpu_torch.quantizers import quantize_kernel_int8, quantize_w8a8

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    quantize_rows.launches = w8a8_matmul_2d.launches = 0
    yield
    # CPU tensors take the plain versions: no kernel may have launched
    assert quantize_rows.launches == 0 and w8a8_matmul_2d.launches == 0


def _weights(rng, k, n):
    """A float kernel [K, N] quantized by JAX's `_quantize_kernel_int8`:
    (int8 [K, N], f32 scale [N]) as numpy."""
    q, s = _quantize_kernel_int8(jnp.asarray(rng.randn(k, n).astype(np.float32) * 0.05))
    return np.array(q), np.array(s)


@pytest.mark.parametrize("lead", [(1,), (37,), (256,), (2, 19)], ids=["m1", "m37", "m256", "batched-2x19"])
@pytest.mark.parametrize("k,n", [(128, 256), (384, 128)])
@pytest.mark.parametrize("with_bias", [False, True], ids=["no-bias", "bias"])
def test_w8a8_plain_matches_pallas_interpret(lead, k, n, with_bias):
    rng = np.random.RandomState(k + n + len(lead))
    x = (rng.randn(*lead, k) * 2).astype(np.float32)
    qw, ws = _weights(rng, k, n)
    bias = rng.randn(n).astype(np.float32) if with_bias else None
    ref = jax_w8a8_matmul(jnp.asarray(x), jnp.asarray(qw), jnp.asarray(ws),
                          bias=None if bias is None else jnp.asarray(bias), interpret=True)
    out = w8a8_matmul(torch.from_numpy(x), torch.from_numpy(qw.T.copy()), torch.from_numpy(ws),
                      None if bias is None else torch.from_numpy(bias))
    assert out.shape == (*lead, n) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape,scale", [((64, 384), 3.0), ((5, 128), 1e-3), ((3, 256), 0.0)],
                         ids=["unit", "small", "all-zero"])
def test_quantize_rows_matches_jax(shape, scale):
    x = (np.random.RandomState(3).randn(*shape) * scale).astype(np.float32)
    jq, js = jax_quantize_rows(jnp.asarray(x))
    tq, ts = quantize_rows(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.shape == (shape[0], 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_round_half_to_even():
    """qx rounds ties to even (torch.round, like jnp.round): 0.5 -> 0, 1.5 -> 2, 2.5 -> 2."""
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5] + [0.0] * 121])
    q, s = quantize_rows(x)
    assert float(s) == 1.0
    assert q[0, :7].tolist() == [127, 0, 2, 2, 0, -2, -2]


@pytest.mark.parametrize("k,n", [(256, 100), (200, 128)], ids=["n-unaligned", "k-unaligned"])
def test_dequant_rule_for_shapes_that_do_not_tile(k, n):
    rng = np.random.RandomState(4)
    x = rng.randn(8, k).astype(np.float32)
    qw, ws = _weights(rng, k, n)
    bias = rng.randn(n).astype(np.float32)
    ref = jax_w8a8_matmul(jnp.asarray(x), jnp.asarray(qw), jnp.asarray(ws), bias=jnp.asarray(bias))
    out = w8a8_matmul(torch.from_numpy(x), torch.from_numpy(qw.T.copy()), torch.from_numpy(ws),
                      torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_weight_quantizer_matches_jax():
    w = np.random.RandomState(5).randn(384, 256).astype(np.float32) * 0.05  # JAX layout [in, out]
    w[:, 0] = 0.0  # a zero column: the 1e-8 floor
    jq, js = _quantize_kernel_int8(jnp.asarray(w))
    tq, ts = quantize_kernel_int8(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_w8a8_linear_through_the_weight_bridge_matches_jax():
    """A JAX Linear with a w8a8 leaf (int8 kernel + kernel_scale_w8a8) loaded
    into a port `Linear`: `load_jax_params` makes it a `W8A8Linear`."""
    rng = np.random.RandomState(6)
    jl = jmod.Linear(256, 384)
    params = jax.tree_util.tree_map(np.asarray, jl.init(jax.random.PRNGKey(0)))
    q, s = _quantize_kernel_int8(jnp.asarray(params["kernel"]))
    params = dict(params, kernel=np.asarray(q), kernel_scale_w8a8=np.asarray(s))
    holder = torch.nn.Module()
    holder.lin = tmod.Linear(256, 384)
    load_jax_params(holder, {"lin": params})
    assert isinstance(holder.lin, tmod.W8A8Linear) and holder.lin.weight.dtype == torch.int8
    x = rng.randn(3, 7, 256).astype(np.float32)
    ref = jl(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    with torch.no_grad():
        out = holder.lin(torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_quantize_w8a8_swaps_by_size_and_keeps_the_scale_f32():
    torch.manual_seed(0)
    model = torch.nn.Sequential(tmod.Linear(256, 4096), torch.nn.GELU(), tmod.Linear(4096, 64), tmod.Linear(64, 8))
    x = torch.randn(5, 256)
    with torch.no_grad():
        ref = model(x)
        quantize_w8a8(model, min_weight_size=2**18)  # 256 x 4096 and 4096 x 64 qualify; 64 x 8 does not
        assert [type(m).__name__ for m in model] == ["W8A8Linear", "GELU", "W8A8Linear", "Linear"]
        out = model(x)
        # w8a8 against float: ~1/127 relative per quantized operand
        assert float((out - ref).abs().max()) <= 0.05 * float(ref.abs().max())
        model.to(torch.bfloat16)
    assert model[0].weight.dtype == torch.int8 and model[0].weight_scale.dtype == torch.float32
    assert model[0].bias.dtype == torch.bfloat16

"""The port's FluxTransformer2DModel against the JAX one on the CPU.

Two tiny configs. `W8A8`: every Linear dim a multiple of 128 (2 heads x 64,
joint/pooled dim 128, MLP 512), guidance embeds on; every 2-D kernel whose K
and N are multiples of 128 is quantized by JAX's `_quantize_kernel_int8`, so
the JAX side runs the Pallas w8a8 kernel (interpret mode) and the port
`W8A8Linear` (K5's plain version on the CPU); `load_jax_params` carries the
one quantized tree into the port. `FLOAT`: the float tiny config of
tests/test_transformer_flux.py, no guidance embeds.

Tolerance. float32 on both sides. Without quantization the differences are
summation order (`1e-5`). With it, an upstream f32 difference of one ulp can
move a value across a rounding boundary of ``x / x_scale`` and flip one qx by
one; that moves the linear's output by ``x_scale * w_scale * |qw| <= x_scale
* max|w|``, about 3/127 * 0.09 = 2e-3 for unit-scale activations into a
128-wide layer (|w| <= 1/sqrt(128)). The w8a8 tolerance, `2e-3`, is that one
step; the port keeps JAX's f32 op order, and no flip occurs at this seed
(measured 6e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.models.transformers.transformer_flux import FluxTransformer2DModel as JaxFlux
from diffusers_tpu.quantizers.quantize import _quantize_kernel_int8
from diffusers_tpu_torch.models.modeling_utils import load_jax_params
from diffusers_tpu_torch.models.transformers.transformer_flux import FluxTransformer2DModel
from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention_full
from diffusers_tpu_torch.ops.cuda.w8a8_matmul import quantize_rows, w8a8_matmul_2d
from diffusers_tpu_torch.ops.module import W8A8Linear
from test_torch_models import carry_params

torch.set_num_threads(1)

W8A8 = dict(patch_size=1, in_channels=16, num_layers=1, num_single_layers=1, attention_head_dim=64,
            num_attention_heads=2, joint_attention_dim=128, pooled_projection_dim=128, guidance_embeds=True,
            axes_dims_rope=(16, 24, 24))
FLOAT = dict(patch_size=1, in_channels=4, num_layers=2, num_single_layers=2, attention_head_dim=16,
             num_attention_heads=2, joint_attention_dim=32, pooled_projection_dim=32, guidance_embeds=False,
             axes_dims_rope=(4, 6, 6))
W8A8_ATOL = 2e-3
FLOAT_ATOL = 1e-5


def quantize_tree_w8a8(tree):
    """JAX's w8a8 leaf for every 2-D kernel with K and N multiples of 128."""
    if not isinstance(tree, dict):
        return tree
    kernel = tree.get("kernel")
    if kernel is not None and not isinstance(kernel, dict) and kernel.ndim == 2 \
            and kernel.shape[0] % 128 == 0 and kernel.shape[1] % 128 == 0:
        q, s = _quantize_kernel_int8(jnp.asarray(kernel))
        return dict(tree, kernel=np.array(q), kernel_scale_w8a8=np.array(s))
    return {k: quantize_tree_w8a8(v) for k, v in tree.items()}


def flux_tree(jax_model, seed=0, w8a8=False):
    """The port's weights of `jax_model`'s config from `seed`, 1-D leaves
    jittered, as a JAX numpy tree (`test_torch_models.carry_params`: JAX's
    eager `init` takes seconds), optionally w8a8-quantized."""
    tree = jax.device_get(carry_params(jax_model, FluxTransformer2DModel.from_config(dict(jax_model.config)), seed))
    return quantize_tree_w8a8(tree) if w8a8 else tree


@pytest.mark.parametrize("name", ["w8a8", "float"])
def test_flux_transformer_matches_jax(name):
    cfg, w8a8, atol = {"w8a8": (W8A8, True, W8A8_ATOL), "float": (FLOAT, False, FLOAT_ATOL)}[name]
    jm, tm = JaxFlux(**cfg), FluxTransformer2DModel(**cfg)
    tree = flux_tree(jm, w8a8=w8a8)
    load_jax_params(tm, tree)
    n_w8a8 = sum(isinstance(m, W8A8Linear) for m in tm.modules())
    # 14 per dual block, 6 per single block, 8 outside: the context embedder, the six
    # time/guidance/text embedder linears (at full width the two 256-wide ones are
    # below 2^20 elements and stay float) and norm_out
    assert n_w8a8 == (14 + 6 + 8 if w8a8 else 0)

    rng = np.random.RandomState(1)
    b, img, txt = 1, 16, 8
    inputs = dict(
        hidden_states=rng.randn(b, img, cfg["in_channels"]).astype(np.float32),
        encoder_hidden_states=rng.randn(b, txt, cfg["joint_attention_dim"]).astype(np.float32),
        pooled_projections=rng.randn(b, cfg["pooled_projection_dim"]).astype(np.float32),
        timestep=np.array([0.7], np.float32),
    )
    if cfg["guidance_embeds"]:
        inputs["guidance"] = np.array([3.5], np.float32)
    ids = np.concatenate([np.zeros((txt, 3), np.float32), rng.randint(0, 4, (img, 3)).astype(np.float32)])
    cos, sin = jm.pos_embed({}, ids)  # host float64 tables
    ref = jax.jit(lambda p, kw, rope: jm(p, **kw, image_rotary_emb=rope).sample)(
        jax.tree_util.tree_map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in inputs.items()},
        (jnp.asarray(cos), jnp.asarray(sin)))

    flash_attention_full.launches = quantize_rows.launches = w8a8_matmul_2d.launches = 0
    with torch.no_grad():
        out = tm(**{k: torch.from_numpy(v) for k, v in inputs.items()},
                 img_ids=torch.from_numpy(ids[txt:]), txt_ids=torch.from_numpy(ids[:txt])).sample
    assert flash_attention_full.launches == quantize_rows.launches == w8a8_matmul_2d.launches == 0
    assert out.shape == (b, img, cfg["in_channels"]) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol)

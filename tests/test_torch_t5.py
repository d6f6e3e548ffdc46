"""The port's T5 encoder against the JAX package on the CPU.

A tiny T5 (the config of tests/test_pipeline_flux.py, 40 tokens so the
relative-position buckets reach the logarithmic range) is initialised in JAX,
its parameters carried into the port with `load_jax_params`, and both encode
the same seeded ids, with and without a padding mask. float32 on both sides:
the differences are summation order, held to `1e-5` on outputs of order 1
(RMSNorm ends the stack).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.models.text_encoders.t5 import T5EncoderModel as JaxT5EncoderModel
from diffusers_tpu.models.text_encoders.t5 import _relative_position_bucket as jax_bucket
from diffusers_tpu_torch.models.modeling_utils import load_jax_params
from diffusers_tpu_torch.models.text_encoders.t5 import T5EncoderModel, _relative_position_bucket
from test_torch_models import jax_tree
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

ATOL = 1e-5
T5_TINY = dict(vocab_size=1000, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4)


def test_relative_position_buckets_match_jax():
    rel = np.arange(-300, 301)[None, :] - np.arange(0, 3)[:, None]
    ref = jax_bucket(jnp.asarray(rel), bidirectional=True, num_buckets=32, max_distance=128)
    out = _relative_position_bucket(torch.from_numpy(rel), bidirectional=True, num_buckets=32, max_distance=128)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("ff", ["gated-gelu", "relu"])
@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "padding-mask"])
def test_t5_encoder_matches_jax(ff, masked):
    cfg = dict(T5_TINY, feed_forward_proj=ff)
    jm, tm = JaxT5EncoderModel(**cfg), T5EncoderModel(**cfg)
    tree = jax_tree(jm, T5EncoderModel(**cfg))  # a seeded port's weights as a JAX tree (JAX's eager init is slow)
    load_jax_params(tm, tree)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 1000, (2, 40))
    mask = np.ones((2, 40), np.int64)
    mask[1, 25:] = 0
    ref = jax.jit(lambda p, i, m: jm(p, i, attention_mask=m).last_hidden_state)(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(ids), jnp.asarray(mask) if masked else None)
    with torch.no_grad():
        out = tm(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask) if masked else None).last_hidden_state
    assert out.shape == (2, 40, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)

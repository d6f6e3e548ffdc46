"""The port's Qwen-Image ControlNet against the JAX package on the CPU:
`QwenImageControlNetModel` (with its residual projections and condition
embedder made non-zero) under a padded prompt, `QwenImageMultiControlNetModel`
summing two nets, the residuals added by the Qwen transformer's interval rule
against JAX's transformer given JAX's residuals, and `from_transformer`
(copied embedders and blocks, the zero residual paths of an untrained net).

Tiny widths: JAX's fixture (`tests/test_controlnet_qwenimage.py`: 2 blocks of
2 heads x 16, joint dim 24, in 16), the transformer of
tests/test_torch_qwenimage.py. f32 on both sides; tolerance 5e-4 (the
README's whole-model bound). JAX models run under `jax.jit`.
"""

import jax
import numpy as np
import torch

from diffusers_tpu.models.controlnets.controlnet_qwenimage import QwenImageControlNetModel as JaxQwenCN
from diffusers_tpu.models.controlnets.controlnet_qwenimage import QwenImageMultiControlNetModel as JaxQwenMultiCN
from diffusers_tpu.models.transformers.transformer_qwenimage import QwenImageTransformer2DModel as JaxQwenT
from diffusers_tpu_torch import QwenImageControlNetModel, QwenImageMultiControlNetModel, QwenImageTransformer2DModel
from test_torch_qwenimage import TINY, carry, seeded
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

ATOL = 5e-4
SHAPES = [(1, 4, 4)]


def controlnet(seed, num_layers=2):
    """A seeded ControlNet with random residual projections and condition
    embedder (zero at construction), and its JAX twin."""
    cfg = dict(TINY, num_layers=num_layers)
    tm = seeded(QwenImageControlNetModel, cfg, seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for lin in (*tm.controlnet_blocks, tm.controlnet_x_embedder):
            lin.weight.copy_(0.2 * torch.randn(lin.weight.shape, generator=gen))
            lin.bias.copy_(0.2 * torch.randn(lin.bias.shape, generator=gen))
    return (tm, *carry(JaxQwenCN, tm, cfg))


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    mask = np.ones((2, 7), np.int64)
    mask[0, 5:] = 0
    return dict(hidden_states=rng.randn(2, 16, 16).astype(np.float32),
                encoder_hidden_states=rng.randn(2, 7, 24).astype(np.float32), encoder_hidden_states_mask=mask,
                timestep=np.array([0.5, 0.9], np.float32)), rng.randn(2, 16, 16).astype(np.float32)


def _torch(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def test_controlnet_matches_jax():
    tm, jm, params = controlnet(seed=1)
    ins, cond = _inputs()
    ref = jax.jit(lambda p, c, kw: jm(p, kw.pop("hidden_states"), c, conditioning_scale=0.8, img_shapes=SHAPES,
                                      **kw).controlnet_block_samples)(params, cond, dict(ins))
    with torch.no_grad():
        out = tm(controlnet_cond=torch.from_numpy(cond), conditioning_scale=0.8, img_shapes=SHAPES,
                 **_torch(ins)).controlnet_block_samples
    assert len(out) == len(ref) == 2
    for o, r in zip(out, ref):
        assert o.shape == (2, 16, 32)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL, rtol=0)


def test_multi_controlnet_into_the_transformer_matches_jax():
    """Two nets summed by the multi model, then added over
    the transformer's depth by its interval rule, against JAX's multi model
    and transformer."""
    (t1, j1, p1), (t2, j2, p2) = controlnet(seed=2), controlnet(seed=3)
    transformer = seeded(QwenImageTransformer2DModel, TINY, seed=4)
    jt, tparams = carry(JaxQwenT, transformer, TINY)
    ins, cond = _inputs(seed=5)
    cond2 = np.random.RandomState(6).randn(2, 16, 16).astype(np.float32)
    jmulti = JaxQwenMultiCN([j1, j2])

    def jax_fn(params, cparams, conds, kw):
        samples = jmulti(cparams, kw["hidden_states"], conds, [0.7, 1.3], img_shapes=SHAPES,
                         encoder_hidden_states=kw["encoder_hidden_states"],
                         encoder_hidden_states_mask=kw["encoder_hidden_states_mask"],
                         timestep=kw["timestep"]).controlnet_block_samples
        out = jt(params, kw["hidden_states"], kw["encoder_hidden_states"], kw["encoder_hidden_states_mask"],
                 kw["timestep"], img_shapes=SHAPES, controlnet_block_samples=samples).sample
        return samples, out

    ref_samples, ref = jax.jit(jax_fn)(tparams, [p1, p2], [cond, cond2], ins)
    multi = QwenImageMultiControlNetModel([t1, t2])
    with torch.no_grad():
        t_ins = _torch(ins)
        samples = multi(t_ins["hidden_states"], [torch.from_numpy(cond), torch.from_numpy(cond2)], [0.7, 1.3],
                        img_shapes=SHAPES, **{k: v for k, v in t_ins.items() if k != "hidden_states"}
                        ).controlnet_block_samples
        out = transformer(t_ins["hidden_states"], t_ins["encoder_hidden_states"], t_ins["encoder_hidden_states_mask"],
                          t_ins["timestep"], img_shapes=SHAPES, controlnet_block_samples=samples).sample
    assert len(samples) == len(ref_samples) == 2
    for o, r in zip(samples, ref_samples):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_from_transformer_copies_and_adds_nothing():
    """`from_transformer`: the embedders and first blocks equal to the
    transformer's, the residual paths zero, so the transformer's output is
    unchanged by an untrained net."""
    transformer = seeded(QwenImageTransformer2DModel, TINY, seed=7)
    net = QwenImageControlNetModel.from_transformer(transformer, num_layers=1, attention_head_dim=16,
                                                    num_attention_heads=2, extra_condition_channels=4)
    state, ref = net.state_dict(), transformer.state_dict()
    copied = [k for k in state if not k.startswith(("controlnet_", "pos_embed"))]
    assert copied and all(torch.equal(state[k], ref[k]) for k in copied)
    assert net.config.extra_condition_channels == 4 and net.controlnet_x_embedder.in_features == 20
    assert all(not v.any() for k, v in state.items() if k.startswith("controlnet_"))
    ins, cond = _inputs(seed=8)
    t_ins = _torch(ins)
    with torch.no_grad():
        samples = net(controlnet_cond=torch.from_numpy(np.concatenate([cond, cond[..., :4]], -1)), img_shapes=SHAPES,
                      **t_ins).controlnet_block_samples
        base = transformer(t_ins["hidden_states"], t_ins["encoder_hidden_states"],
                           t_ins["encoder_hidden_states_mask"], t_ins["timestep"], img_shapes=SHAPES).sample
        out = transformer(t_ins["hidden_states"], t_ins["encoder_hidden_states"],
                          t_ins["encoder_hidden_states_mask"], t_ins["timestep"], img_shapes=SHAPES,
                          controlnet_block_samples=samples).sample
    assert torch.equal(out, base)

"""The port's `FluxControlNetModel` (plain, Union, XLabs hint block,
`from_transformer`), `FluxMultiControlNetModel` and the Flux transformer's
ControlNet residuals under both rules against the JAX package on the CPU,
at the tiny widths of tests/test_torch_flux_family.py (the ControlNet 2
dual and 2 single blocks, every weight random, its residual projections
too). float32 on both sides: `1e-5` (summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.models.controlnets.controlnet_flux import FluxMultiControlNetModel as JaxFluxMultiControlNet
from diffusers_tpu.models.transformers.transformer_flux import FluxTransformer2DModel as JaxFlux
from diffusers_tpu_torch import FluxControlNetModel as RootControlNet
from diffusers_tpu_torch.models.controlnets.controlnet_flux import FluxControlNetModel, FluxMultiControlNetModel
from diffusers_tpu_torch.models.transformers.transformer_flux import FluxTransformer2DModel
from diffusers_tpu_torch.pipelines.pipeline_utils import resolve_component_class
from test_torch_flux_family import CONTROLNET, MODULE_ATOL, TINY, _controlnet_pair, _pair
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)


@pytest.mark.parametrize("repeat", [False, True], ids=["interval", "repeat"])
def test_transformer_residuals_match_jax(repeat):
    """The residual injection: 2 dual blocks under 1 sample (ceil interval) or
    under 2 samples by i % 2; 2 single blocks under 1 sample."""
    cfg = dict(TINY, num_layers=2, num_single_layers=2)
    jm, params, tm = _pair(JaxFlux, FluxTransformer2DModel, cfg, seed=3)
    rng = np.random.RandomState(2)
    hidden, text = rng.randn(1, 16, 16).astype(np.float32), rng.randn(1, 8, 32).astype(np.float32)
    pooled, t, g = rng.randn(1, 32).astype(np.float32), np.array([0.6], np.float32), np.array([3.5], np.float32)
    dual = [rng.randn(1, 16, 32).astype(np.float32) for _ in range(2 if repeat else 1)]
    single = [rng.randn(1, 16, 32).astype(np.float32)]
    img_ids = np.stack(np.meshgrid(np.zeros(1), np.arange(4), np.arange(4), indexing="ij"), -1).reshape(-1, 3)
    txt_ids = np.zeros((8, 3), np.float32)
    img_ids = img_ids.astype(np.float32)

    @jax.jit
    def run(p, *xs):
        return jm(p, *xs[:4], img_ids=img_ids, txt_ids=txt_ids, guidance=xs[4], controlnet_block_samples=xs[5],
                  controlnet_single_block_samples=xs[6], controlnet_blocks_repeat=repeat).sample

    ref = np.asarray(run(params, hidden, text, pooled, t, g, [jnp.asarray(d) for d in dual],
                         [jnp.asarray(s) for s in single]))
    tt = lambda a: torch.from_numpy(a)  # noqa: E731
    with torch.no_grad():
        out = tm(tt(hidden), tt(text), tt(pooled), tt(t), img_ids=img_ids, txt_ids=txt_ids, guidance=tt(g),
                 controlnet_block_samples=[tt(d) for d in dual],
                 controlnet_single_block_samples=[tt(s) for s in single],
                 controlnet_blocks_repeat=repeat).sample
        plain = tm(tt(hidden), tt(text), tt(pooled), tt(t), img_ids=img_ids, txt_ids=txt_ids, guidance=tt(g)).sample
    np.testing.assert_allclose(out.numpy(), ref, atol=MODULE_ATOL, rtol=0)
    assert float((out - plain).abs().max()) > 1e-2  # the residuals act


def _controlnet_inputs(hint=False):
    rng = np.random.RandomState(3)
    # the hint block takes the image down 8x: a 32 x 32 image gives the 4 x 4 packed tokens
    cond = rng.rand(1, 3, 32, 32).astype(np.float32) * 2 - 1 if hint else rng.randn(1, 16, 16).astype(np.float32)
    return dict(hidden=rng.randn(1, 16, 16).astype(np.float32), cond=cond, text=rng.randn(1, 8, 32).astype(np.float32),
                pooled=rng.randn(1, 32).astype(np.float32), t=np.array([0.4], np.float32),
                g=np.array([3.5], np.float32))


def _run_controlnet(jm, params, tm, x, mode=None, scale=0.8):
    img_ids = np.stack(np.meshgrid(np.zeros(1), np.arange(4), np.arange(4), indexing="ij"), -1).reshape(-1, 3)
    img_ids, txt_ids = img_ids.astype(np.float32), np.zeros((8, 3), np.float32)
    jcond = x["cond"].transpose(0, 2, 3, 1) if x["cond"].ndim == 4 else x["cond"]  # JAX's hint block is NHWC

    @jax.jit
    def run(p, h, c, e, pooled, t, g, m):
        out = jm(p, h, c, controlnet_mode=m, conditioning_scale=scale, encoder_hidden_states=e,
                 pooled_projections=pooled, timestep=t, img_ids=img_ids, txt_ids=txt_ids, guidance=g)
        return out.controlnet_block_samples, out.controlnet_single_block_samples

    jmode = None if mode is None else jnp.full((1, 1), mode, jnp.int32)
    ref = run(params, x["hidden"], jcond, x["text"], x["pooled"], x["t"], x["g"], jmode)
    tt = torch.from_numpy
    with torch.no_grad():
        out = tm(tt(x["hidden"]), tt(x["cond"]), controlnet_mode=None if mode is None else torch.full((1, 1), mode),
                 conditioning_scale=scale, encoder_hidden_states=tt(x["text"]), pooled_projections=tt(x["pooled"]),
                 timestep=tt(x["t"]), img_ids=img_ids, txt_ids=txt_ids, guidance=tt(x["g"]))
    return ref, (out.controlnet_block_samples, out.controlnet_single_block_samples)


@pytest.mark.parametrize("kind", ["plain", "union", "hint"])
def test_controlnet_matches_jax(kind):
    overrides = {"union": dict(num_mode=10), "hint": dict(conditioning_embedding_channels=16)}.get(kind, {})
    jm, params, tm = _controlnet_pair(**overrides)
    ref, out = _run_controlnet(jm, params, tm, _controlnet_inputs(hint=kind == "hint"),
                               mode=3 if kind == "union" else None)
    assert len(out[0]) == 2 and len(out[1]) == 2
    for r, o in zip((*ref[0], *ref[1]), (*out[0], *out[1])):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=MODULE_ATOL, rtol=0)
    if kind == "union":
        with pytest.raises(ValueError, match="controlnet_mode"):
            x = _controlnet_inputs()
            tm(torch.from_numpy(x["hidden"]), torch.from_numpy(x["cond"]), encoder_hidden_states=torch.zeros(1, 8, 32),
               pooled_projections=torch.zeros(1, 32), timestep=torch.zeros(1), guidance=torch.zeros(1),
               img_ids=np.zeros((16, 3), np.float32), txt_ids=np.zeros((8, 3), np.float32))


def test_controlnet_construction_and_multi():
    """A fresh ControlNet adds nothing (zero residual projections and
    conditioning embedder, as JAX's `init_params`); `from_transformer` copies
    the embedders and leading blocks and zeroes `controlnet_x_embedder`; the
    multi model sums its nets' residuals as JAX's does."""
    fresh = FluxControlNetModel(**CONTROLNET)
    zeroed = (*fresh.controlnet_blocks, fresh.controlnet_x_embedder)
    assert all(float(lin.weight.detach().abs().max()) == 0 for lin in zeroed)
    _, _, transformer = _pair(JaxFlux, FluxTransformer2DModel, dict(TINY, num_layers=2, num_single_layers=2), 3)
    cn = FluxControlNetModel.from_transformer(transformer, num_layers=1, num_single_layers=2, attention_head_dim=16,
                                              num_attention_heads=2)
    assert cn.config.num_layers == 1 and cn.config.guidance_embeds and cn.config.in_channels == 16
    for name in ("time_text_embed", "context_embedder", "x_embedder", "transformer_blocks.0",
                 "single_transformer_blocks.1"):
        src, dst = transformer.get_submodule(name).state_dict(), cn.get_submodule(name).state_dict()
        assert src.keys() == dst.keys() and all(torch.equal(src[k], dst[k]) for k in src)
    assert float(cn.controlnet_x_embedder.weight.detach().abs().max()) == 0
    assert RootControlNet is FluxControlNetModel
    assert resolve_component_class("diffusers", "FluxControlNetModel")[0] is FluxControlNetModel

    (j1, p1, t1), (j2, p2, t2) = _controlnet_pair(seed=7), _controlnet_pair(seed=8, num_mode=10)
    x = _controlnet_inputs()
    multi = FluxMultiControlNetModel([t1, t2])
    img_ids = np.stack(np.meshgrid(np.zeros(1), np.arange(4), np.arange(4), indexing="ij"), -1).reshape(-1, 3)
    kwargs = dict(encoder_hidden_states=x["text"], pooled_projections=x["pooled"], timestep=x["t"],
                  img_ids=img_ids.astype(np.float32), txt_ids=np.zeros((8, 3), np.float32), guidance=x["g"])
    jout = jax.jit(lambda ps, h, c: JaxFluxMultiControlNet([j1, j2])(
        ps, h, [c, c], controlnet_mode=[None, jnp.full((1, 1), 2, jnp.int32)], conditioning_scale=[0.5, 1.5],
        **kwargs))(list((p1, p2)), x["hidden"], x["cond"])
    tt = torch.from_numpy
    with torch.no_grad():
        out = multi(tt(x["hidden"]), [tt(x["cond"])] * 2, controlnet_mode=[None, torch.full((1, 1), 2)],
                    conditioning_scale=[0.5, 1.5], **{k: tt(v) if isinstance(v, np.ndarray) and k not in (
                        "img_ids", "txt_ids") else v for k, v in kwargs.items()})
    for r, o in zip((*jout.controlnet_block_samples, *jout.controlnet_single_block_samples),
                    (*out.controlnet_block_samples, *out.controlnet_single_block_samples)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=MODULE_ATOL, rtol=0)

"""The port's SigLIP vision tower, `ReduxImageEncoder` and
`FluxPriorReduxPipeline` against the JAX package (and transformers) on the
CPU.

Tiny widths: a SigLIP of 2 layers, 32 wide, 2 heads of 16, 28 px images in
patches of 7 (16 tokens), with its attention-pooling head; a Redux encoder
32 -> 3 x 24 -> 24; the Flux text encoders of tests/test_torch_flux_family.py
at T5 width 24. The port's seeded weights are carried into JAX with
`convert_torch_state_dict`. Preprocessing (ROADMAP C3): both pipelines call
a transformers `SiglipImageProcessor` on the host, or take the array as
pixel values without one.

Tolerance: float32 on both sides, `1e-5` (summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.models.modeling_utils import convert_torch_state_dict
from diffusers_tpu.models.text_encoders.siglip import SiglipVisionModel as JaxSiglip
from diffusers_tpu.pipelines.flux.modeling_flux import ReduxImageEncoder as JaxRedux
from diffusers_tpu.pipelines.flux.pipeline_flux import FluxPipeline as JaxFluxPipeline
from diffusers_tpu.pipelines.flux.pipeline_flux_prior_redux import FluxPriorReduxPipeline as JaxReduxPipeline
from diffusers_tpu.pipelines.pipeline_utils import resolve_component_class as jax_resolve
from diffusers_tpu_torch import FluxPriorReduxPipeline as RootRedux, SiglipVisionModel as RootSiglip
from diffusers_tpu_torch.models.text_encoders.siglip import SiglipVisionModel
from diffusers_tpu_torch.pipelines.flux import FluxPriorReduxPipeline, ReduxImageEncoder
from test_torch_flux_family import CLIP, T5, _pair
from test_torch_pipeline_flux import CRCTokenizer
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)
from diffusers_tpu.models.text_encoders.clip import CLIPTextModel as JaxCLIPTextModel
from diffusers_tpu.models.text_encoders.t5 import T5EncoderModel as JaxT5EncoderModel
from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel
from diffusers_tpu_torch.models.text_encoders.t5 import T5EncoderModel

torch.set_num_threads(1)

ATOL = 1e-5
SIGLIP = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2, image_size=28,
              patch_size=7, vision_use_head=True)
REDUX = dict(redux_dim=32, txt_in_features=24)
T5_24 = dict(T5, d_model=24, d_kv=12)
PIXELS = np.random.RandomState(0).randn(2, 3, 28, 28).astype(np.float32)
PROMPT = "a bowl of oranges on a table"


def _siglip():
    return _pair(JaxSiglip, SiglipVisionModel, SIGLIP, seed=11)


def test_siglip_matches_jax():
    jm, params, tm = _siglip()
    ref = jax.jit(lambda p, x: tuple(jm(p, x, return_dict=False)))(params, jnp.asarray(PIXELS))
    with torch.no_grad():
        out = tm(torch.from_numpy(PIXELS))
    assert out.last_hidden_state.shape == (2, 16, 32) and out.pooler_output.shape == (2, 32)
    np.testing.assert_allclose(out.last_hidden_state.numpy(), np.asarray(ref[0]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out.pooler_output.numpy(), np.asarray(ref[1]), atol=ATOL, rtol=0)
    assert RootSiglip is SiglipVisionModel
    assert jax_resolve("transformers", "SiglipVisionModel")[0] is JaxSiglip


def test_siglip_reads_transformers_layout(tmp_path):
    """A transformers `SiglipVisionModel` saved by transformers itself loads
    through `from_pretrained` and agrees with transformers (the torch MHA
    pooling head's packed in_proj layout included)."""
    transformers = pytest.importorskip("transformers")
    config = transformers.SiglipVisionConfig(**SIGLIP)
    torch.manual_seed(0)
    ref_model = transformers.SiglipVisionModel(config).eval()
    ref_model.save_pretrained(tmp_path)
    tm = SiglipVisionModel.from_pretrained(tmp_path, device="cpu")
    with torch.no_grad():
        ref = ref_model(pixel_values=torch.from_numpy(PIXELS))
        out = tm(torch.from_numpy(PIXELS))
    torch.testing.assert_close(out.last_hidden_state, ref.last_hidden_state, atol=ATOL, rtol=0)
    torch.testing.assert_close(out.pooler_output, ref.pooler_output, atol=ATOL, rtol=0)


def test_redux_encoder_matches_jax():
    jm, params, tm = _pair(JaxRedux, ReduxImageEncoder, REDUX, seed=12)
    x = np.random.RandomState(1).randn(2, 16, 32).astype(np.float32)
    ref = jax.jit(lambda p, x: jm(p, x).image_embeds)(params, jnp.asarray(x))
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).image_embeds
    assert out.shape == (2, 16, 24)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def _pipelines(feature_extractor=None):
    (js, sp, ts), (jr, rp, tr) = _siglip(), _pair(JaxRedux, ReduxImageEncoder, REDUX, seed=12)
    jpipe = JaxReduxPipeline(image_encoder=(js, sp), image_embedder=(jr, rp), feature_extractor=feature_extractor)
    tpipe = FluxPriorReduxPipeline(image_encoder=ts, image_embedder=tr, feature_extractor=feature_extractor,
                                   device="cpu")
    return jpipe, tpipe


@pytest.mark.parametrize("scales", [(1.0, 1.0), (0.6, 0.8), ([0.3, 0.7], [1.0, 0.5])],
                         ids=["unit", "scaled", "mixed"])
def test_redux_pipeline_matches_jax(scales):
    """Without text encoders: 512 zero tokens, then the image tokens, scaled;
    a list of scales over 2 images sums them into one row."""
    jpipe, tpipe = _pipelines()
    ref = jpipe(PIXELS, prompt_embeds_scale=scales[0], pooled_prompt_embeds_scale=scales[1])
    out = tpipe(PIXELS, prompt_embeds_scale=scales[0], pooled_prompt_embeds_scale=scales[1])
    rows = 1 if isinstance(scales[0], list) else 2
    assert out.prompt_embeds.shape == (rows, 512 + 16, 24) and out.pooled_prompt_embeds.shape == (rows, 768)
    np.testing.assert_allclose(out.prompt_embeds.numpy(), np.asarray(ref.prompt_embeds), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out.pooled_prompt_embeds.numpy(), np.asarray(ref.pooled_prompt_embeds), atol=ATOL,
                               rtol=0)
    assert RootRedux is FluxPriorReduxPipeline


def test_redux_with_text_encoders_and_the_jax_fault():
    """With text encoders the T5 prompt embeds come first and the pooled
    embeds are CLIP's: the port against JAX's `FluxPipeline.encode_prompt` on
    the same encoders, composed with JAX's image tokens. JAX's own Redux
    pipeline raises on this path (ROADMAP C4: it calls `FluxPipeline.encode_prompt`,
    which needs `_get_clip_prompt_embeds`, a method the Redux pipeline lacks)."""
    jpipe, tpipe = _pipelines()
    (jc, cp, tc), (jt, t5p, tt) = _pair(JaxCLIPTextModel, CLIPTextModel, CLIP, 1), _pair(
        JaxT5EncoderModel, T5EncoderModel, T5_24, 2)
    texts = dict(text_encoder=tc, tokenizer=CRCTokenizer(), text_encoder_2=tt, tokenizer_2=CRCTokenizer())
    tpipe = FluxPriorReduxPipeline(image_encoder=tpipe.image_encoder, image_embedder=tpipe.image_embedder,
                                   device="cpu", **texts)
    out = tpipe(PIXELS[:1], prompt=PROMPT, prompt_embeds_scale=0.9, pooled_prompt_embeds_scale=1.1)
    jflux = JaxFluxPipeline(scheduler=None, vae=None, text_encoder=(jc, cp), tokenizer=CRCTokenizer(),
                            text_encoder_2=(jt, t5p), tokenizer_2=CRCTokenizer(), transformer=None)
    prompt_embeds, pooled, _ = jflux.encode_prompt(PROMPT, None, 512)
    image_tokens = jpipe(PIXELS[:1]).prompt_embeds[:, 512:]
    ref = np.concatenate([np.asarray(prompt_embeds), np.asarray(image_tokens)], axis=1) * 0.9
    assert out.prompt_embeds.shape == (1, 512 + 16, 24)
    np.testing.assert_allclose(out.prompt_embeds.numpy(), ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out.pooled_prompt_embeds.numpy(), np.asarray(pooled) * 1.1, atol=ATOL, rtol=0)
    jtexts = dict(text_encoder=(jc, cp), tokenizer=CRCTokenizer(), text_encoder_2=(jt, t5p),
                  tokenizer_2=CRCTokenizer())
    jpipe = JaxReduxPipeline(image_encoder=jpipe.image_encoder, image_embedder=jpipe.image_embedder, **jtexts)
    with pytest.raises(AttributeError, match="_get_clip_prompt_embeds"):
        jpipe(PIXELS[:1], prompt=PROMPT)


def test_redux_preprocessing_and_layout(tmp_path):
    """Preprocessing (ROADMAP C3): a transformers `SiglipImageProcessor` is
    called on the host by both packages, so a 40 x 36 uint8 image gives the
    same embeds; then a directory in black-forest-labs/FLUX.1-Redux-dev's
    layout (image_encoder: transformers' SiglipVisionModel,
    feature_extractor: SiglipImageProcessor, image_embedder:
    ReduxImageEncoder) loads through `from_pretrained` and answers as the
    in-memory pipeline. JAX's registry has no ReduxImageEncoder (ROADMAP C4)."""
    transformers = pytest.importorskip("transformers")
    processor = transformers.SiglipImageProcessor(size={"height": 28, "width": 28})
    jpipe, tpipe = _pipelines(feature_extractor=processor)
    image = (np.random.RandomState(3).rand(40, 36, 3) * 255).astype(np.uint8)
    ref = jpipe(image).prompt_embeds
    out = tpipe(image).prompt_embeds
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)

    tpipe.save_pretrained(tmp_path)
    loaded = FluxPriorReduxPipeline.from_pretrained(tmp_path, device="cpu")
    assert type(loaded.feature_extractor).__name__.startswith("SiglipImageProcessor")
    torch.testing.assert_close(loaded(image).prompt_embeds, out, rtol=0, atol=0)
    with pytest.raises(ValueError, match="ReduxImageEncoder"):
        jax_resolve("diffusers", "ReduxImageEncoder")

"""The port's Qwen-Image pipelines against the JAX package end to end on the
CPU: `QwenImagePipeline`, `QwenImageImg2ImgPipeline` and
`QwenImageInpaintPipeline`, each as a whole `__call__` under true CFG, on
the Qwen-Image VAE (one frame through the Wan-family 3-D VAE, with its
latent statistics) and on the 2-D `AutoencoderKL` branch JAX's own tests
use.

Tiny components: a 2-layer Qwen2.5-VL tower (24 wide) behind a
deterministic tokenizer stand-in (the chat template's 34-token prefix is
dropped, `max_sequence_length` 6), the transformer of
tests/test_torch_qwenimage.py, a Qwen-Image VAE (base 8, z 4) or a 4-level
AutoencoderKL, both 8x in space, on 32 x 32 images: 4 x 4 latents, 4 packed
tokens. The port's seeded weights are carried into JAX with
`convert_torch_state_dict`; both pipelines get the same numpy latents
(text-to-image), and the port's `randn_tensor` returns JAX's draws (the
encoder sample, then the noise) for img2img and inpaint. JAX's VAE and text
tower run under `jax.jit` (`JitVAE`, `JitEncoder`).

Tolerance: 5e-4 on the [0, 1] images (the README's whole-pipeline bound),
f32 on both sides.
"""

import functools
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusers_tpu.pipelines.qwenimage as jqwen
from diffusers_tpu.models.autoencoders.autoencoder_kl import AutoencoderKL as JaxAutoencoderKL
from diffusers_tpu.models.autoencoders.autoencoder_kl_qwenimage import AutoencoderKLQwenImage as JaxQwenVAE
from diffusers_tpu.models.autoencoders.vae import DiagonalGaussianDistribution
from diffusers_tpu.models.text_encoders.qwen2_vl import Qwen2_5_VLTextEncoder as JaxQwenTE
from diffusers_tpu.models.transformers.transformer_qwenimage import QwenImageTransformer2DModel as JaxQwenT
from diffusers_tpu.schedulers import FlowMatchEulerDiscreteScheduler as JaxFlowMatch
from diffusers_tpu.utils.jax_utils import randn_tensor as jax_randn
import diffusers_tpu_torch.pipelines.qwenimage as tqwen
from diffusers_tpu_torch import AutoencoderKLQwenImage, Qwen2_5_VLTextEncoder, QwenImageTransformer2DModel
from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
from diffusers_tpu_torch.ops.cuda.flash_attention import flash_attention_full
from diffusers_tpu_torch.schedulers import FlowMatchEulerDiscreteScheduler
from diffusers_tpu_torch.utils import torch_utils
from test_torch_qwenimage import TINY, carry, seeded

torch.set_num_threads(1)

ATOL = 5e-4
PROMPT = "a jade rabbit on a red lantern"
TXT_LEN = 6
STEPS = 3
KEY_SEED = 4
TE = dict(vocab_size=100, hidden_size=24, intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
          num_key_value_heads=2)
QWEN_VAE = dict(base_dim=8, z_dim=4, dim_mult=(1, 2, 2, 2), num_res_blocks=1, latents_mean=[0.1, -0.2, 0.0, 0.3],
                latents_std=[1.0, 0.5, 2.0, 1.5])
KL_VAE = dict(in_channels=3, out_channels=3, block_out_channels=(8, 8, 8, 8), down_block_types=("DownEncoderBlock2D",) * 4,
              up_block_types=("UpDecoderBlock2D",) * 4, latent_channels=4, layers_per_block=1, norm_num_groups=4,
              sample_size=16, scaling_factor=0.5)
FLOW = dict(use_dynamic_shifting=True)
IMAGE = np.random.RandomState(0).rand(32, 32, 3).astype(np.float32)
MASK = np.zeros((32, 32), np.float32)
MASK[4:20, 8:28] = 1.0
LATENTS = np.random.RandomState(1).randn(1, 4, 16).astype(np.float32)  # packed 4 x 4 x 4


class ChatTokenizer:
    """Deterministic tokenizer stand-in: ids from a CRC of the text, the
    prompt's length (after the 34-token template prefix) from its own
    length, padding to `max_length` with the attention mask."""

    def __call__(self, texts, max_length=40, padding=None, truncation=True, return_tensors="np"):
        class Out:
            pass

        ids, masks = [], []
        for text in texts:
            h = zlib.crc32(text.encode("utf-8"))
            n = min(max_length, 34 + 2 + len(text) % 4)
            ids.append([(h + 7 * i) % 97 + 1 for i in range(n)] + [0] * (max_length - n))
            masks.append([1] * n + [0] * (max_length - n))
        out = Out()
        out.input_ids, out.attention_mask = np.array(ids, np.int64), np.array(masks, np.int64)
        return out


class JitVAE:
    """A JAX VAE whose encode (the posterior's moments) and decode run under
    `jax.jit`; anything else is the module's own."""

    def __init__(self, module):
        self._module = module
        self._moments = jax.jit(lambda p, x: _posterior(module.encode(p, x)).parameters)
        self._decode = jax.jit(lambda p, z, *a, **k: module.decode(p, z, *a, **k).sample)

    def __getattr__(self, name):
        return getattr(self._module, name)

    def encode(self, params, x):
        dist = DiagonalGaussianDistribution(self._moments(params, x))
        dist.latent_dist = dist
        return dist

    def decode(self, params, z, *args, **kwargs):
        return types.SimpleNamespace(sample=self._decode(params, z, *args, **kwargs))


def _posterior(out):
    return getattr(out, "latent_dist", out)


class JitEncoder:
    """A JAX text tower called under `jax.jit`."""

    def __init__(self, module):
        self._fn = jax.jit(lambda p, ids, m: tuple(module(p, ids, attention_mask=m,
                                                          output_hidden_states=True).hidden_states))

    def __call__(self, params, ids, attention_mask=None, output_hidden_states=False):
        hidden = self._fn(params, ids, attention_mask)
        return types.SimpleNamespace(hidden_states=hidden, last_hidden_state=hidden[-1])


@functools.lru_cache(maxsize=None)
def build(name: str, vae_kind: str):
    """(JAX pipeline, port pipeline) of class `name` on the VAE kind."""
    te = seeded(Qwen2_5_VLTextEncoder, TE, seed=1)
    transformer = seeded(QwenImageTransformer2DModel, TINY, seed=2)
    vcls, jvcls, vcfg = ((AutoencoderKLQwenImage, JaxQwenVAE, QWEN_VAE) if vae_kind == "qwen"
                         else (AutoencoderKL, JaxAutoencoderKL, KL_VAE))
    vae = seeded(vcls, vcfg, seed=3)
    jte, jt, jv = carry(JaxQwenTE, te, TE), carry(JaxQwenT, transformer, TINY), carry(jvcls, vae, vcfg)
    jpipe = getattr(jqwen, name)(scheduler=JaxFlowMatch(**FLOW), vae=(JitVAE(jv[0]), jv[1]),
                                 text_encoder=(JitEncoder(jte[0]), jte[1]), tokenizer=ChatTokenizer(),
                                 transformer=jt)
    tpipe = getattr(tqwen, name)(scheduler=FlowMatchEulerDiscreteScheduler(**FLOW), vae=vae, text_encoder=te,
                                 tokenizer=ChatTokenizer(), transformer=transformer, device="cpu")
    return jpipe, tpipe


def _draws(monkeypatch, n, shapes):
    """The port's `randn_tensor` returns JAX's draws: keys 1.. of the split of
    PRNGKey(KEY_SEED) into `n`, in the port's order of use."""
    keys = jax.random.split(jax.random.PRNGKey(KEY_SEED), n)
    queue = [np.array(jax_randn(shape, key=keys[i + 1])) for i, shape in enumerate(shapes)]

    def randn_tensor(shape, generator=None, device=None):
        out = queue.pop(0)
        assert tuple(shape) == out.shape
        return torch.from_numpy(out).to(device)

    monkeypatch.setattr(torch_utils, "randn_tensor", randn_tensor)
    return queue


CASES = {
    "QwenImagePipeline-qwen": {},
    "QwenImagePipeline-kl": {},
    "QwenImageImg2ImgPipeline-qwen": dict(image=IMAGE, strength=0.7),
    "QwenImageImg2ImgPipeline-kl": dict(image=IMAGE, strength=0.7),
    "QwenImageInpaintPipeline-qwen": dict(image=IMAGE, mask_image=MASK, strength=0.9),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_matches_jax(case, monkeypatch):
    name, vae_kind = case.split("-")
    jpipe, tpipe = build(name, vae_kind)
    kwargs = dict(CASES[case], num_inference_steps=STEPS, true_cfg_scale=4.0, max_sequence_length=TXT_LEN,
                  output_type="np")
    if name == "QwenImagePipeline":
        kwargs_j, kwargs_t = (dict(kwargs, height=32, width=32, latents=jnp.asarray(LATENTS)),
                              dict(kwargs, height=32, width=32, latents=torch.from_numpy(LATENTS)))
        queue = []
    else:
        latent = (1, 4, 1, 4, 4) if vae_kind == "qwen" else (1, 4, 4, 4)
        queue = _draws(monkeypatch, 3, [latent, (1, 4, 16)])
        kwargs_j = kwargs_t = kwargs
    ref = np.asarray(jpipe(PROMPT, key=jax.random.PRNGKey(KEY_SEED), **kwargs_j).images)
    flash_attention_full.launches = 0
    out = tpipe(PROMPT, **kwargs_t).images
    assert flash_attention_full.launches == 0 and not queue
    assert out.shape == (1, 32, 32, 3) and out.dtype == np.float32 and np.isfinite(out).all()
    err = float(np.abs(out - ref).max())
    assert err <= ATOL, err


def test_prompt_encoding_drops_the_template_and_batches_cfg():
    """The embeds and mask after the 34-token prefix, `max_sequence_length`
    long; the negative prompt defaults to " "; CFG batches [negative,
    positive]."""
    _, tpipe = build("QwenImagePipeline", "qwen")
    embeds, mask, neg, neg_mask = tpipe.encode_prompt(PROMPT, max_sequence_length=TXT_LEN)
    assert embeds.shape == neg.shape == (1, TXT_LEN, 24) and mask.shape == (1, TXT_LEN)
    full = ChatTokenizer()([tpipe.prompt_template_encode.format(PROMPT)], max_length=TXT_LEN + 34)
    np.testing.assert_array_equal(mask.numpy(), full.attention_mask[:, 34:])
    assert not torch.equal(embeds, neg)
    neg_default = tpipe.encode_prompt(" ", do_cfg=False, max_sequence_length=TXT_LEN)[0]
    assert torch.equal(neg, neg_default)
    batched, batched_mask, batch_size, do_cfg = tpipe._prompt(PROMPT, None, 4.0, TXT_LEN)
    assert batch_size == 1 and do_cfg and torch.equal(batched[1:], embeds) and torch.equal(batched_mask[:1], neg_mask)


def test_inpaint_keeps_the_known_region():
    """After the last step the blend leaves the clean latents outside the mask."""
    _, tpipe = build("QwenImageInpaintPipeline", "qwen")
    gen = torch.Generator().manual_seed(0)
    out = tpipe(PROMPT, image=IMAGE, mask_image=MASK, strength=1.0, num_inference_steps=2, generator=gen,
                max_sequence_length=TXT_LEN, output_type="latent").images
    gen = torch.Generator().manual_seed(0)
    clean, lh, lw, _, _ = tpipe._prepare_image(IMAGE, None, None, 1, gen)
    from diffusers_tpu_torch.pipelines.inpaint_utils import as_mask_array, prepare_packed_mask

    mask = prepare_packed_mask(as_mask_array(MASK), 1, 4, lh, lw, tpipe._pack_latents)
    assert mask.min() == 0 and mask.max() == 1
    assert torch.equal(out[mask == 0], clean[mask == 0]) and not torch.equal(out[mask == 1], clean[mask == 1])


def test_save_and_from_pretrained_round_trip(tmp_path):
    """`save_pretrained` writes `model_index.json` with the registered
    classes (the tower in transformers' layout); `DiffusionPipeline.from_pretrained`
    picks the class and reads every component back bit-equal, and the image
    with it; `from_pipe` shares the components."""
    from diffusers_tpu_torch import DiffusionPipeline, QwenImageImg2ImgPipeline

    _, tpipe = build("QwenImagePipeline", "qwen")
    tpipe.save_pretrained(tmp_path / "qwen")
    assert (tmp_path / "qwen" / "text_encoder" / "model.safetensors").is_file()
    loaded = DiffusionPipeline.from_pretrained(tmp_path / "qwen", device="cpu", tokenizer=ChatTokenizer())
    assert type(loaded).__name__ == "QwenImagePipeline"
    for name in ("transformer", "text_encoder", "vae"):
        state = getattr(tpipe, name).state_dict()
        assert all(torch.equal(v, state[k]) for k, v in getattr(loaded, name).state_dict().items()), name
    kwargs = dict(height=32, width=32, num_inference_steps=2, max_sequence_length=TXT_LEN, output_type="np")
    a = tpipe(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).images
    b = loaded(PROMPT, latents=torch.from_numpy(LATENTS), **kwargs).images
    assert np.array_equal(a, b)
    img2img = QwenImageImg2ImgPipeline.from_pipe(tpipe)
    assert img2img.transformer is tpipe.transformer and img2img.vae is tpipe.vae

"""The port's text encoders read and write transformers' checkpoint layout
(`model.safetensors`, or shards with `model.safetensors.index.json`, and a
transformers `config.json`), on the CPU.

Each of CLIP, CLIP with projection, T5 (gated-gelu) and UMT5 is built tiny
in `transformers` from a seed (every weight jittered, so no LayerNorm or
bias is trivial) and saved with transformers' own `save_pretrained`, in one
file and in shards. Tolerances: the port's `from_pretrained` against the
transformers model's outputs within 1e-5 (f32, the same math in another
order); against the JAX package's `from_pretrained` of the same directory
within 5e-4, the whole-model bound of README "Numerical parity"; the port's
`save_pretrained` read back by the JAX package bit for bit (its parameters
through `flatten_to_torch_state_dict`). The JAX CLIP reads one
`model.safetensors` only (`diffusers_tpu/models/text_encoders/clip.py:246`),
so the sharded CLIP cases hold the port to transformers alone. A checkpoint
with transformers' legacy keys (CLIP's `position_ids` buffer; T5's
`encoder.embed_tokens.weight` alias and a full T5's decoder) in an `fp16`
variant must load too.
"""

import os

import numpy as np
import pytest
import torch
import transformers

from diffusers_tpu.models.modeling_utils import flatten_to_torch_state_dict
from diffusers_tpu.models.text_encoders.clip import CLIPTextModel as JaxCLIPTextModel
from diffusers_tpu.models.text_encoders.clip import CLIPTextModelWithProjection as JaxCLIPTextModelWithProjection
from diffusers_tpu.models.text_encoders.t5 import T5EncoderModel as JaxT5EncoderModel
from diffusers_tpu.models.text_encoders.t5 import UMT5EncoderModel as JaxUMT5EncoderModel
from diffusers_tpu_torch.models.modeling_utils import iter_safetensors, save_safetensors
from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel, CLIPTextModelWithProjection
from diffusers_tpu_torch.models.text_encoders.t5 import T5EncoderModel, UMT5EncoderModel
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

CLIP_CONFIG = dict(vocab_size=99, hidden_size=32, intermediate_size=37, num_hidden_layers=2, num_attention_heads=4,
                   max_position_embeddings=16, projection_dim=24, eos_token_id=2, hidden_act="quick_gelu")
T5_CONFIG = dict(vocab_size=99, d_model=32, d_kv=8, d_ff=40, num_layers=2, num_heads=4,
                 feed_forward_proj="gated-gelu")
# name: (transformers class, transformers config, port class, JAX class)
ENCODERS = {
    "clip": (transformers.CLIPTextModel, transformers.CLIPTextConfig(**CLIP_CONFIG), CLIPTextModel,
             JaxCLIPTextModel),
    "clip_projection": (transformers.CLIPTextModelWithProjection, transformers.CLIPTextConfig(**CLIP_CONFIG),
                        CLIPTextModelWithProjection, JaxCLIPTextModelWithProjection),
    "t5": (transformers.T5EncoderModel, transformers.T5Config(**T5_CONFIG), T5EncoderModel, JaxT5EncoderModel),
    "umt5": (transformers.UMT5EncoderModel, transformers.UMT5Config(**T5_CONFIG), UMT5EncoderModel,
             JaxUMT5EncoderModel),
}
IDS = np.array([[5, 9, 17, 98, 0, 0], [7, 3, 98, 0, 0, 0]])  # 98 the highest id: CLIP pools there
MASK = (IDS != 0).astype(np.int64)
ONE_FILE, SHARDS = "10GB", "20KB"


def _transformers_model(name, seed=0):
    tcls, config, _, _ = ENCODERS[name]
    torch.manual_seed(seed)
    model = tcls(config).eval()
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy(0.05 * rng.randn(*p.shape).astype(np.float32)))
    return model


def _outputs(name, model, ids):
    """The outputs the pipelines read: CLIP's last and penultimate hidden
    states and pooled (projected) embedding, T5's last hidden state under a
    padding mask."""
    if name.startswith("clip"):
        out = model(ids, output_hidden_states=True)
        pooled = out.text_embeds if name == "clip_projection" else out.pooler_output
        return [out.last_hidden_state, out.hidden_states[-2], pooled]
    return [model(ids, attention_mask=torch.from_numpy(MASK)).last_hidden_state]


def _jax_outputs(name, jm, params):
    if name.startswith("clip"):
        out = jm(params, IDS, output_hidden_states=True)
        pooled = out.text_embeds if name == "clip_projection" else out.pooler_output
        return [out.last_hidden_state, out.hidden_states[-2], pooled]
    return [jm(params, IDS, attention_mask=MASK).last_hidden_state]


@pytest.mark.parametrize("shard", [ONE_FILE, SHARDS], ids=["one-file", "sharded"])
@pytest.mark.parametrize("name", list(ENCODERS))
def test_transformers_checkpoint_round_trip(tmp_path, name, shard):
    _, _, port_cls, jax_cls = ENCODERS[name]
    reference = _transformers_model(name)
    reference.save_pretrained(tmp_path / "hf", max_shard_size=shard)
    assert os.path.isfile(tmp_path / "hf" / "model.safetensors.index.json") == (shard == SHARDS)

    model = port_cls.from_pretrained(tmp_path / "hf", device="cpu")
    ids = torch.from_numpy(IDS)
    with torch.no_grad():
        for got, want in zip(_outputs(name, model, ids), _outputs(name, reference, ids)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    assert model.config.architectures == reference.config.architectures  # transformers' keys stay in the config

    jax_reads_shards = not name.startswith("clip")
    if shard == ONE_FILE or jax_reads_shards:
        jm, params = jax_cls.from_pretrained(str(tmp_path / "hf"))
        with torch.no_grad():
            for got, want in zip(_outputs(name, model, ids), _jax_outputs(name, jm, params)):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=5e-4)

    # the port's save, read by the JAX package: bit-equal parameters
    model.save_pretrained(tmp_path / "port", max_shard_size=shard if jax_reads_shards else ONE_FILE)
    jm, params = jax_cls.from_pretrained(str(tmp_path / "port"))
    saved = flatten_to_torch_state_dict(jm, params)
    state = model.state_dict()
    assert sorted(saved) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(np.asarray(saved[k]), v.numpy(), err_msg=k)
    assert port_cls.from_pretrained(tmp_path / "port", device="cpu").config.architectures == \
        reference.config.architectures


@pytest.mark.parametrize("name", list(ENCODERS))
def test_legacy_keys_and_fp16_variant(tmp_path, name):
    _, _, port_cls, _ = ENCODERS[name]
    _transformers_model(name, seed=1).save_pretrained(tmp_path)
    state = {k: v.clone() for k, v in iter_safetensors(tmp_path / "model.safetensors")}
    os.remove(tmp_path / "model.safetensors")
    half = {k: v.half() for k, v in state.items()}
    if name.startswith("clip"):  # older transformers saved the position ids buffer
        half["text_model.embeddings.position_ids"] = torch.arange(16)[None]
    else:  # the alias of `shared`, and a full T5's decoder and head
        half["encoder.embed_tokens.weight"] = half["shared.weight"] + 1
        half["decoder.final_layer_norm.weight"] = torch.ones(32, dtype=torch.float16)
        half["lm_head.weight"] = torch.zeros(99, 32, dtype=torch.float16)
    save_safetensors(half, tmp_path / "model.fp16.safetensors")
    model = port_cls.from_pretrained(tmp_path, variant="fp16", device="cpu")
    got = model.state_dict()
    assert sorted(got) == sorted(state)
    for k, v in state.items():
        assert got[k].dtype == torch.float16 and torch.equal(got[k], v.half()), k
    upcast = port_cls.from_pretrained(tmp_path, variant="fp16", device="cpu", dtype=torch.float32)
    assert all(torch.equal(upcast.state_dict()[k], v.half().float()) for k, v in state.items())
    with pytest.raises(EnvironmentError, match="model.safetensors"):
        port_cls.from_pretrained(tmp_path, device="cpu")  # no file without the variant

"""The port's decoder-only text encoders against the JAX package on the CPU:
`LlamaModel` (grouped-query attention, causal plus right padding, the
Qwen2 ``attention_bias`` and Qwen3 ``qk_norm`` options, every hidden state)
and `Qwen2_5_VLTextEncoder` (Qwen-Image's prompt encoder), and
`from_pretrained` of transformers-layout checkpoints: a sharded
`Qwen2_5_VLForConditionalGeneration` directory with ``text_config``, the
trunk nested under ``model.language_model.``, a ``visual.`` tower and an
``lm_head``, read by both packages; a llava-style ``language_model.model.``
nesting with a vision tower; and the port's `save_pretrained` read back by
JAX bit-equal.

Tiny widths (32 wide, 4 query and 2 key/value heads of 8), f32 on both
sides: the tolerance is the README's whole-model bound, 5e-4 max-abs
(measured below 1e-6). JAX models run under `jax.jit`.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.models.modeling_utils import convert_torch_state_dict, flatten_to_torch_state_dict
from diffusers_tpu.models.text_encoders.llama import LlamaModel as JaxLlama
from diffusers_tpu.models.text_encoders.qwen2_vl import Qwen2_5_VLTextEncoder as JaxQwen
from diffusers_tpu_torch import LlamaModel, Qwen2_5_VLTextEncoder
from diffusers_tpu_torch.models.modeling_utils import save_safetensors

torch.set_num_threads(1)

ATOL = 5e-4
QWEN = dict(vocab_size=100, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, rope_theta=1000000.0)
LLAMA = dict(QWEN, rope_theta=500000.0, rms_norm_eps=1e-5)


def _seeded(cls, cfg, seed):
    """A port model with seeded weights, its 1-D ones jittered."""
    torch.manual_seed(seed)
    rng = np.random.RandomState(seed)
    model = cls(**cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim == 1:
                p.add_(torch.from_numpy((0.1 * rng.randn(*p.shape)).astype(np.float32)))
    return model


def _state(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _inputs(seed=0, b=2, s=9):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 100, (b, s)).astype(np.int64)
    mask = np.ones((b, s), np.int64)
    mask[0, 6:] = 0  # right padding
    return ids, mask


def _run_jax(jm, params, ids, mask):
    fn = jax.jit(lambda p, i, m: jm(p, i, attention_mask=m, output_hidden_states=True))
    out = fn(params, jnp.asarray(ids), jnp.asarray(mask))
    return np.asarray(out.last_hidden_state), [np.asarray(h) for h in out.hidden_states]


def _check(tm, jm, params, seed=0):
    ids, mask = _inputs(seed)
    ref_last, ref_hidden = _run_jax(jm, params, ids, mask)
    with torch.no_grad():
        out = tm(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask), output_hidden_states=True)
    assert len(out.hidden_states) == len(ref_hidden) == tm.config.num_hidden_layers + 1
    np.testing.assert_allclose(out.last_hidden_state.numpy(), ref_last, atol=ATOL, rtol=0)
    for h, r in zip(out.hidden_states, ref_hidden):
        np.testing.assert_allclose(h.numpy(), r, atol=ATOL, rtol=0)
    # hidden_states[-1] is the final norm's output, as in transformers
    assert torch.equal(out.hidden_states[-1], out.last_hidden_state)


@pytest.mark.parametrize("options", [{}, {"attention_bias": True}, {"qk_norm": True},
                                     {"num_key_value_heads": 4, "head_dim": 16}])
def test_llama_matches_jax(options):
    cfg = dict(LLAMA, **options)
    tm = _seeded(LlamaModel, cfg, seed=1)
    jm = JaxLlama(**cfg)
    _check(tm, jm, convert_torch_state_dict(jm, _state(tm)))


def test_qwen2_5_vl_matches_jax():
    tm = _seeded(Qwen2_5_VLTextEncoder, QWEN, seed=2)
    assert tm.layers[0].self_attn.q_proj.bias is not None and tm.layers[0].self_attn.o_proj.bias is None
    jm = JaxQwen(**QWEN)
    _check(tm, jm, convert_torch_state_dict(jm, _state(tm)), seed=3)


def test_padding_does_not_reach_the_kept_tokens():
    """Right padding and the causal mask: a prompt's kept positions are the
    same whatever follows them."""
    tm = _seeded(Qwen2_5_VLTextEncoder, QWEN, seed=4)
    ids, mask = _inputs(5)
    other = ids.copy()
    other[0, 6:] = (other[0, 6:] + 7) % 100
    with torch.no_grad():
        a = tm(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)).last_hidden_state
        b = tm(torch.from_numpy(other), attention_mask=torch.from_numpy(mask)).last_hidden_state
    assert torch.equal(a[0, :6], b[0, :6]) and not torch.equal(a[0, 6:], b[0, 6:])


def _write_checkpoint(directory, state, config, prefix, extra, shards=2):
    """transformers' layout: `config.json` and `shards` safetensors files with
    their index, every key under `prefix`, plus `extra` keys."""
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "config.json").write_text(json.dumps(config))
    tensors = {prefix + k: torch.from_numpy(v) for k, v in state.items()}
    tensors.update({k: torch.from_numpy(v) for k, v in extra.items()})
    names = sorted(tensors)
    weight_map = {}
    for i in range(shards):
        fname = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        part = {k: tensors[k] for k in names[i::shards]}
        save_safetensors(part, directory / fname)
        weight_map.update(dict.fromkeys(part, fname))
    (directory / "model.safetensors.index.json").write_text(json.dumps({"metadata": {}, "weight_map": weight_map}))


def test_qwen_from_pretrained_transformers_layout(tmp_path):
    """A sharded `Qwen2_5_VLForConditionalGeneration` checkpoint: the port and
    JAX read the same trunk; the ``visual.`` tower and the LM head are
    skipped; the port's save is read back by both packages bit-equal."""
    tm = _seeded(Qwen2_5_VLTextEncoder, QWEN, seed=6)
    state = _state(tm)
    rng = np.random.RandomState(0)
    extra = {"model.visual.blocks.0.attn.qkv.weight": rng.randn(24, 8).astype(np.float32),
             "lm_head.weight": rng.randn(100, 32).astype(np.float32)}
    config = {"model_type": "qwen2_5_vl", "architectures": ["Qwen2_5_VLForConditionalGeneration"],
              "text_config": dict(QWEN, model_type="qwen2_5_vl_text", rms_norm_eps=1e-6),
              "vision_config": {"depth": 1}}
    src = tmp_path / "text_encoder"
    _write_checkpoint(src, state, config, "model.language_model.", extra)

    loaded = Qwen2_5_VLTextEncoder.from_pretrained(src, device="cpu")
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, tm.state_dict()[k]), k
    jm, params = JaxQwen.from_pretrained(str(src))
    ref = flatten_to_torch_state_dict(jm, params)
    assert sorted(ref) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(np.asarray(ref[k]), state[k], err_msg=k)
    _check(loaded, jm, params, seed=7)

    out = tmp_path / "saved"
    loaded.save_pretrained(out)
    again = Qwen2_5_VLTextEncoder.from_pretrained(out, device="cpu")
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in loaded.state_dict().items())
    jm2, params2 = JaxQwen.from_pretrained(str(out))
    ref2 = flatten_to_torch_state_dict(jm2, params2)
    for k in state:
        np.testing.assert_array_equal(np.asarray(ref2[k]), state[k], err_msg=k)


def test_llama_from_pretrained_nested_and_options(tmp_path):
    """A llava-style wrapper (``text_config``, the trunk under
    ``language_model.model.``, a vision tower and projector skipped), and the
    model-type rules: ``qwen2*`` turns on the q/k/v biases, ``qwen3*`` the
    q/k norms, as in JAX."""
    for model_type, options in (("llama", {}), ("qwen2", {"attention_bias": True}), ("qwen3", {"qk_norm": True})):
        cfg = dict(LLAMA, **options)
        tm = _seeded(LlamaModel, cfg, seed=8)
        rng = np.random.RandomState(1)
        extra = {"vision_tower.vision_model.embeddings.patch_embedding.weight": rng.randn(4, 3).astype(np.float32),
                 "multi_modal_projector.linear_1.weight": rng.randn(4, 4).astype(np.float32)}
        config = {"model_type": "llava", "text_config": dict(LLAMA, model_type=model_type)}
        src = tmp_path / model_type
        _write_checkpoint(src, _state(tm), config, "language_model.model.", extra, shards=1)
        loaded = LlamaModel.from_pretrained(src, device="cpu")
        assert {k: bool(loaded.config[k]) for k in ("attention_bias", "qk_norm")} == {
            "attention_bias": "attention_bias" in options, "qk_norm": "qk_norm" in options}
        assert all(torch.equal(v, tm.state_dict()[k]) for k, v in loaded.state_dict().items())
        jm, params = JaxLlama.from_pretrained(str(src))
        _check(loaded, jm, params, seed=9)

"""The port's textual inversion (`diffusers_tpu_torch.loaders.textual_inversion`)
against the JAX package's on the CPU.

A real `transformers.CLIPTokenizer` (its vocabulary written by
`chip_smoke.clip_tokenizer`) for each side and a tiny CLIP text encoder whose
table holds exactly the tokenizer's ids, with the port's seeded weights
carried into JAX. Each of the three formats (diffusers ``{token: emb}``,
A1111's ``string_to_param``, ``emb_params``; one and two vectors; from a
dict or a safetensors file) is loaded on both sides: the same token ids, the
appended rows bit-equal to the file's, and the encoder's hidden states for
a prompt that uses the token equal to JAX's within 5e-4 (JAX jitted).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from diffusers_tpu.loaders import textual_inversion as jti
from diffusers_tpu.models.modeling_utils import convert_torch_state_dict
from diffusers_tpu.models.text_encoders.clip import CLIPTextModel as JaxCLIPTextModel
from diffusers_tpu_torch.loaders import textual_inversion as ti
from diffusers_tpu_torch.models.modeling_utils import save_safetensors
from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel

torch.set_num_threads(1)

MODEL_ATOL = 5e-4
TOKEN = "<cat-toy>"
PROMPT = f"a photo of {TOKEN} on the sand"


@pytest.fixture(scope="module")
def tokenizer_dir(tmp_path_factory):
    directory = tmp_path_factory.mktemp("clip_tokenizer")
    chip_smoke.clip_tokenizer(directory)
    return directory


def _encoder(vocab_size):
    torch.manual_seed(0)
    return CLIPTextModel(vocab_size=vocab_size, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=4, max_position_embeddings=77).eval()


def _embedding_source(fmt, emb, tmp_path):
    if fmt == "diffusers":
        return {TOKEN: emb}
    if fmt == "a1111":
        return {"string_to_param": {"*": emb}, "name": TOKEN}
    path = tmp_path / "embedding.safetensors"
    save_safetensors({"emb_params": torch.from_numpy(emb)}, path)
    return str(path)


@pytest.mark.parametrize("fmt,vectors", [("diffusers", 1), ("a1111", 2), ("emb_params", 2)])
def test_textual_inversion_matches_jax(fmt, vectors, tokenizer_dir, tmp_path):
    import transformers

    jtok = transformers.CLIPTokenizer.from_pretrained(str(tokenizer_dir))
    tok = transformers.CLIPTokenizer.from_pretrained(str(tokenizer_dir))
    encoder = _encoder(len(tok))
    jm = JaxCLIPTextModel(**{k: encoder.config[k] for k in ("vocab_size", "hidden_size", "intermediate_size",
                                                           "num_hidden_layers", "num_attention_heads",
                                                           "max_position_embeddings")})
    params = convert_torch_state_dict(jm, {k: v.numpy() for k, v in encoder.state_dict().items()})
    emb = np.random.RandomState(vectors).randn(vectors, 32).astype(np.float32)
    if fmt == "diffusers" and vectors == 1:
        emb = emb[0]  # a 1-D embedding, as single-vector files hold it
    table = encoder.text_model.embeddings.token_embedding

    jtok, jparams = jti.load_textual_inversion(_embedding_source(fmt, emb, tmp_path), TOKEN, jtok, params)
    out_tok, out_encoder = ti.load_textual_inversion(_embedding_source(fmt, emb, tmp_path), TOKEN, tok, encoder)
    assert out_tok is tok and out_encoder is encoder
    assert encoder.text_model.embeddings.token_embedding is table  # grown in place
    assert table.weight.shape == (len(tok), 32) and table.num_embeddings == encoder.config.vocab_size == len(tok)
    assert np.array_equal(table.weight[-vectors:].detach().numpy(), np.atleast_2d(emb))

    jprompt, prompt = jti.maybe_convert_prompt(PROMPT, jtok), ti.maybe_convert_prompt(PROMPT, tok)
    assert jprompt == prompt and prompt.count(TOKEN) == vectors
    ids = tok([prompt], padding="max_length", max_length=77, truncation=True, return_tensors="np").input_ids
    assert np.array_equal(ids, jtok([jprompt], padding="max_length", max_length=77, truncation=True,
                                    return_tensors="np").input_ids)
    assert ids.max() == len(tok) - 1 if vectors == 2 else len(tok) - 1 in ids

    ref = jax.jit(lambda p, i: jm(p, i)[0])(jparams, jnp.asarray(ids))
    with torch.no_grad():
        out = encoder(torch.from_numpy(ids))[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=MODEL_ATOL, rtol=0)


def test_table_grows_in_its_dtype_and_refuses_a_wrong_width(tokenizer_dir):
    import transformers

    tok = transformers.CLIPTokenizer.from_pretrained(str(tokenizer_dir))
    encoder = _encoder(len(tok)).to(torch.bfloat16)
    emb = torch.randn(2, 32)
    ti.load_textual_inversion({TOKEN: emb}, TOKEN, tok, encoder)
    weight = encoder.text_model.embeddings.token_embedding.weight
    assert weight.dtype == torch.bfloat16 and torch.equal(weight[-2:], emb.to(torch.bfloat16))
    with pytest.raises(ValueError, match="wide"):
        ti.load_textual_inversion({"<other>": torch.randn(16)}, "<other>", tok, encoder)
    with pytest.raises(ValueError, match="unrecognized"):
        ti.load_textual_inversion({"a": torch.randn(32), "b": torch.randn(32)}, "<x>", tok, encoder)


def test_ids_that_are_not_the_appended_rows_raise_where_jax_warns(tokenizer_dir):
    """A token the tokenizer has, or a tokenizer shorter than the table: JAX
    appends the rows at the table's end while the tokenizer's ids name other
    rows; the port refuses (ROADMAP C3)."""
    import transformers

    tok = transformers.CLIPTokenizer.from_pretrained(str(tokenizer_dir))
    jtok = transformers.CLIPTokenizer.from_pretrained(str(tokenizer_dir))
    encoder = _encoder(len(tok) + 10)
    jm = JaxCLIPTextModel(vocab_size=len(tok) + 10, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                          num_attention_heads=4, max_position_embeddings=77)
    params = convert_torch_state_dict(jm, {k: v.numpy() for k, v in encoder.state_dict().items()})
    emb = np.ones((1, 32), np.float32)
    jtok, jparams = jti.load_textual_inversion({TOKEN: emb}, TOKEN, jtok, params)
    table = np.asarray(jparams["text_model"]["embeddings"]["token_embedding"]["embedding"])
    token_id = jtok.convert_tokens_to_ids(TOKEN)
    assert table.shape[0] == len(tok) + 11 and not np.array_equal(table[token_id], emb[0])  # JAX reads another row
    with pytest.raises(ValueError, match="rows"):
        ti.load_textual_inversion({TOKEN: emb}, TOKEN, tok, encoder)
    assert TOKEN not in tok.get_vocab()  # nothing added
    encoder = _encoder(len(tok))
    ti.load_textual_inversion({TOKEN: emb}, TOKEN, tok, encoder)
    with pytest.raises(ValueError, match="already has"):
        ti.load_textual_inversion({TOKEN: emb}, TOKEN, tok, encoder)

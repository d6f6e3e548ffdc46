"""Textual inversion: learned token embeddings appended to a CLIP text
encoder's token table, their placeholder tokens added to the tokenizer.

Port of `diffusers_tpu/loaders/textual_inversion.py`. JAX returns a new
params tree; here the port's `CLIPTextModel` (or `CLIPTextModelWithProjection`)
grows in place: its ``text_model.embeddings.token_embedding`` gets a new
weight with the rows appended, on the table's device and in its dtype, and
its `vocab_size` follows. The new tokens' ids must be the appended rows: a
token the tokenizer already has, or a tokenizer whose length is not the
table's, raises (JAX appends the rows and warns, and the token then reads
another row).
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..utils import logging

logger = logging.get_logger(__name__)


def _read_embedding(state_dict: Dict):
    """The embedding of the diffusers ``{token: emb}``, A1111
    ``{"string_to_param": {"*": emb}}`` or ``{"emb_params": emb}`` formats."""
    if "string_to_param" in state_dict:
        return state_dict["string_to_param"]["*"]
    if "emb_params" in state_dict:
        return state_dict["emb_params"]
    if len(state_dict) == 1:
        return next(iter(state_dict.values()))
    raise ValueError(f"unrecognized textual inversion format with keys {list(state_dict)[:5]}")


@torch.no_grad()
def load_textual_inversion(path_or_state_dict: Union[str, Dict], token: str, tokenizer,
                           text_encoder: nn.Module) -> Tuple[object, nn.Module]:
    """Add `token` to `tokenizer` and its embedding rows to `text_encoder`'s
    token table (in place). A multi-vector embedding registers `token`,
    ``token_1``, ... as the reference does. `path_or_state_dict` is a
    safetensors file or a dict in one of the three formats. Returns
    ``(tokenizer, text_encoder)``."""
    if isinstance(path_or_state_dict, dict):
        sd = path_or_state_dict
    else:
        from ..models.modeling_utils import iter_safetensors

        sd = dict(iter_safetensors(path_or_state_dict))
    emb = _read_embedding(sd)
    emb = emb if isinstance(emb, torch.Tensor) else torch.from_numpy(np.asarray(emb))
    if emb.ndim == 1:
        emb = emb[None]
    n_vectors = emb.shape[0]
    tokens = [token] + [f"{token}_{i}" for i in range(1, n_vectors)]

    table = text_encoder.text_model.embeddings.token_embedding
    if emb.shape[1] != table.embedding_dim:
        raise ValueError(f"the embedding of {token!r} is {emb.shape[1]} wide; the text encoder's token table is "
                         f"{table.embedding_dim}")
    known = [t for t in tokens if t in tokenizer.get_vocab()]
    if known or len(tokenizer) != table.num_embeddings:
        # the new rows are appended, so the new ids must be the rows after the table's last
        raise ValueError(f"textual inversion {token!r}: the tokenizer already has {known}, or its {len(tokenizer)} "
                         f"ids are not the text encoder's {table.num_embeddings} rows")
    tokenizer.add_tokens(tokens)
    weight = table.weight
    grown = torch.cat([weight.detach(), emb.to(device=weight.device, dtype=weight.dtype)], dim=0)
    table.weight = nn.Parameter(grown, requires_grad=weight.requires_grad)
    table.num_embeddings = grown.shape[0]
    if hasattr(text_encoder, "register_to_config"):
        text_encoder.register_to_config(vocab_size=grown.shape[0])
    logger.info(f"loaded textual inversion {token} with {n_vectors} vectors")
    return tokenizer, text_encoder


def maybe_convert_prompt(prompt: str, tokenizer) -> str:
    """Expand each multi-vector placeholder token of `prompt` into its
    vectors' tokens (``tok`` -> ``tok tok_1 tok_2``)."""
    out = []
    for t in prompt.split():
        out.append(t)
        i = 1
        while f"{t}_{i}" in getattr(tokenizer, "added_tokens_encoder", {}):
            out.append(f"{t}_{i}")
            i += 1
    return " ".join(out)

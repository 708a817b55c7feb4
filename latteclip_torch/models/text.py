"""Text transformer tower (port of ``latteclip_tpu/models/text.py``:
``text_forward``, ``text_forward_embeds`` and ``text_forward_packed``).

Token embedding + learned positions, causal pre-LN stack, ``ln_final``,
pooling at the EOT token, then the projection. :func:`text_forward` runs the
padded context (77) and pools at the row's argmax id;
:func:`text_forward_embeds` takes the embeddings from the caller (the prompt
tuning of test-time adaptation splices learnable context vectors in);
:func:`text_forward_packed` runs rows packed by :mod:`latteclip_torch.data.packing`
through the segment-masked stack and pools at the given EOT coordinates.
Parameters sit at the top level of the CLIP module under OpenCLIP's names, so
this module holds functions only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from latteclip_torch.models import layers


def text_forward(
    model,
    tokens: torch.Tensor,
    *,
    dtype: torch.dtype = torch.bfloat16,
    quick_gelu: bool = False,
    attention: str = "kernel",
    ln_linear: str = "unfused",
    remat: bool = False,
) -> torch.Tensor:
    """Token ids [B, ctx] -> pooled features [B, embed_dim] (float32).

    ``model`` holds ``token_embedding``, ``positional_embedding``,
    ``transformer``, ``ln_final`` and ``text_projection``."""
    return text_forward_embeds(model, F.embedding(tokens, model.token_embedding.weight),
                               tokens.argmax(dim=-1), dtype=dtype, quick_gelu=quick_gelu,
                               attention=attention, ln_linear=ln_linear, remat=remat)


def text_forward_embeds(
    model,
    embeds: torch.Tensor,
    eot_pos: torch.Tensor,
    *,
    dtype: torch.dtype = torch.bfloat16,
    quick_gelu: bool = False,
    attention: str = "kernel",
    ln_linear: str = "unfused",
    remat: bool = False,
) -> torch.Tensor:
    """Token embeddings [B, ctx, D] and EOT positions [B] -> pooled features
    [B, embed_dim] (float32): :func:`text_forward` after its embedding
    lookup. The embeddings go to the compute dtype before the positions are
    added."""
    act = layers.activation(quick_gelu)
    ctx = embeds.shape[1]
    x = embeds.to(dtype) + model.positional_embedding[:ctx].to(dtype)
    x = model.transformer(x, causal=True, act=act, dtype=dtype, attention=attention,
                          ln_linear=ln_linear, remat=remat)
    x = model.ln_final(x)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot_pos]
    return layers.dense(pooled, model.text_projection.t(), None, dtype).float()


def text_forward_packed(
    model,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    seg_ids: torch.Tensor,
    eot_row: torch.Tensor,
    eot_col: torch.Tensor,
    *,
    dtype: torch.dtype = torch.bfloat16,
    quick_gelu: bool = False,
    attention: str = "kernel",
    ln_linear: str = "unfused",
    remat: bool = False,
) -> torch.Tensor:
    """Packed rows -> pooled features [N, embed_dim] (float32).

    ``tokens``, ``positions``, ``seg_ids``: [R, P] from the packer;
    ``eot_row``, ``eot_col``: [N], each sequence's EOT coordinates. The same
    function as :func:`text_forward` on the padded rows: a token sees only
    its own segment's earlier tokens."""
    act = layers.activation(quick_gelu)
    # F.embedding: its backward sums rows per id, where the backward of an
    # indexed read serialises over repeated ids (every row repeats positions)
    x = F.embedding(tokens, model.token_embedding.weight).to(dtype)     # [R, P, D]
    x = x + F.embedding(positions, model.positional_embedding).to(dtype)
    x = model.transformer(x, causal=True, act=act, dtype=dtype, seg_ids=seg_ids,
                          attention=attention, ln_linear=ln_linear, remat=remat)
    x = model.ln_final(x)
    pooled = x[eot_row, eot_col]                                        # [N, D]
    return layers.dense(pooled, model.text_projection.t(), None, dtype).float()

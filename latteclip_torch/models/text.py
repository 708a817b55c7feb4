"""Text transformer tower (port of ``latteclip_tpu/models/text.py``:
``text_forward``, ``text_forward_embeds`` and ``text_forward_packed``).

Token embedding + learned positions, the pre-LN stack (causal unless the
config sets ``no_causal_mask``), ``ln_final``, pooling, then the projection
(plus ``text_projection_b`` where the model has one). :func:`text_forward`
runs the padded context and pools as the config's ``pool_type`` says: at the
row's argmax id (the EOT token), or the first or the last column;
:func:`text_forward_embeds` takes the embeddings from the caller (the prompt
tuning of test-time adaptation splices learnable context vectors in);
:func:`text_forward_packed` runs rows packed by :mod:`latteclip_torch.data.packing`
through the segment-masked stack and pools at the given EOT coordinates,
whatever ``pool_type`` says, as JAX does. For a causal argmax tower that is
the padded result; for a non-causal tower (SigLIP, CLIPA) it is not: the
padded forward lets every token see the padding and pools where the config
says, and the port reproduces each of JAX's two answers.
Parameters sit at the top level of the CLIP module under OpenCLIP's names, so
this module holds functions only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from latteclip_torch.models import layers


def _project(model, pooled: torch.Tensor, dtype: torch.dtype, bias: bool = True) -> torch.Tensor:
    b = model.text_projection_b if bias else None
    return layers.dense(pooled, model.text_projection.t(), b, dtype).float()


def _forward_pooled(model, embeds, pool_idx, *, act, bias, dtype, attention, ln_linear,
                    remat) -> torch.Tensor:
    """The padded tower body: embeddings [B, ctx, D] (cast to the compute dtype
    before the positions are added) -> features [B, embed_dim] (float32),
    pooled at column ``pool_idx`` [B] of each row."""
    ctx = embeds.shape[1]
    x = embeds.to(dtype) + model.positional_embedding[:ctx].to(dtype)
    x = model.transformer(x, causal=not model.cfg.text.no_causal_mask, act=act, dtype=dtype,
                          attention=attention, ln_linear=ln_linear, remat=remat)
    x = model.ln_final(x)
    pooled = x[torch.arange(x.shape[0], device=x.device), pool_idx]
    return _project(model, pooled, dtype, bias=bias)


def text_forward(
    model,
    tokens: torch.Tensor,
    *,
    dtype: torch.dtype = torch.bfloat16,
    quick_gelu: bool = False,
    gelu_tanh: bool = False,
    attention: str = "kernel",
    ln_linear: str = "unfused",
    remat: bool = False,
) -> torch.Tensor:
    """Token ids [B, ctx] -> pooled features [B, embed_dim] (float32).

    ``model`` holds ``token_embedding``, ``positional_embedding``,
    ``transformer``, ``ln_final``, ``text_projection`` and the config."""
    pool_type = model.cfg.text.pool_type
    if pool_type == "argmax":
        pool_idx = tokens.argmax(dim=-1)
    elif pool_type in ("first", "last"):
        col = 0 if pool_type == "first" else tokens.shape[1] - 1
        pool_idx = torch.full((tokens.shape[0],), col, dtype=torch.long, device=tokens.device)
    else:
        raise ValueError(f"unsupported text pool_type: {pool_type}")
    return _forward_pooled(model, F.embedding(tokens, model.token_embedding.weight), pool_idx,
                           act=layers.activation(quick_gelu, gelu_tanh), bias=True, dtype=dtype,
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
    lookup, pooled at ``eot_pos``. As in JAX, the activation is QuickGELU or
    exact GELU (never tanh GELU) and the projection takes no bias."""
    return _forward_pooled(model, embeds, eot_pos, act=layers.activation(quick_gelu), bias=False,
                           dtype=dtype, attention=attention, ln_linear=ln_linear, remat=remat)


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
    gelu_tanh: bool = False,
    attention: str = "kernel",
    ln_linear: str = "unfused",
    remat: bool = False,
) -> torch.Tensor:
    """Packed rows -> pooled features [N, embed_dim] (float32).

    ``tokens``, ``positions``, ``seg_ids``: [R, P] from the packer;
    ``eot_row``, ``eot_col``: [N], each sequence's EOT coordinates. A token
    sees only its own segment's tokens (earlier ones only, for a causal
    tower); for a causal argmax tower this is :func:`text_forward` on the
    padded rows."""
    # F.embedding: its backward sums rows per id, where the backward of an
    # indexed read serialises over repeated ids (every row repeats positions)
    x = F.embedding(tokens, model.token_embedding.weight).to(dtype)     # [R, P, D]
    x = x + F.embedding(positions, model.positional_embedding).to(dtype)
    x = model.transformer(x, causal=not model.cfg.text.no_causal_mask,
                          act=layers.activation(quick_gelu, gelu_tanh), dtype=dtype,
                          seg_ids=seg_ids, attention=attention, ln_linear=ln_linear, remat=remat)
    x = model.ln_final(x)
    return _project(model, x[eot_row, eot_col], dtype)                  # [N, D] -> [N, E]

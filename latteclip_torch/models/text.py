"""Text transformer tower (port of ``latteclip_tpu/models/text.py::text_forward``).

Token embedding + learned positions, causal pre-LN stack over the padded
context (77), ``ln_final``, pooling at the EOT token (the row's argmax id),
then the projection. Parameters sit at the top level of the CLIP module under
OpenCLIP's names, so this module holds functions only.
"""
from __future__ import annotations

import torch

from latteclip_torch.models import layers


def text_forward(
    model,
    tokens: torch.Tensor,
    *,
    dtype: torch.dtype = torch.bfloat16,
    quick_gelu: bool = False,
    attention: str = "kernel",
) -> torch.Tensor:
    """Token ids [B, ctx] -> pooled features [B, embed_dim] (float32).

    ``model`` holds ``token_embedding``, ``positional_embedding``,
    ``transformer``, ``ln_final`` and ``text_projection``."""
    act = layers.activation(quick_gelu)
    ctx = tokens.shape[1]
    x = model.token_embedding.weight[tokens].to(dtype)
    x = x + model.positional_embedding[:ctx].to(dtype)
    x = model.transformer(x, causal=True, act=act, dtype=dtype, attention=attention)
    x = model.ln_final(x)
    pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
    return layers.dense(pooled, model.text_projection.t(), None, dtype).float()

"""HF architecture registry: each model type's config attribute names and
default pooler (the port's own copy of ``latteclip_tpu/models/hf_configs.py``,
itself the reference's ``src/open_clip/hf_configs.py``).

Every entry has a tower in :mod:`latteclip_torch.models.hf_text`: the BERT
family (bert, roberta, xlm-roberta) as post-LN masked encoders, and the
encoder side of the encoder-decoder families, as the reference takes it
(``AutoModel(...).encoder``): mt5 as the T5 encoder stack, m2m_100 (NLLB)
as the pre-LN encoder with sinusoidal positions.
"""

_ENCODER_NAMES = {
    "context_length": "max_position_embeddings",
    "vocab_size": "vocab_size",
    "width": "hidden_size",
    "heads": "num_attention_heads",
    "layers": "num_hidden_layers",
    "layer_attr": "layer",
    "token_embeddings_attr": "embeddings",
}

arch_dict = {
    "roberta": {"config_names": dict(_ENCODER_NAMES), "pooler": "mean_pooler"},
    "xlm-roberta": {"config_names": dict(_ENCODER_NAMES), "pooler": "mean_pooler"},
    "bert": {"config_names": dict(_ENCODER_NAMES), "pooler": "cls_pooler"},
    "mt5": {
        "config_names": {
            "context_length": "",
            "vocab_size": "vocab_size",
            "width": "d_model",
            "heads": "num_heads",
            "layers": "num_layers",
            "layer_attr": "block",
            "token_embeddings_attr": "embed_tokens",
        },
        "pooler": "mean_pooler",
    },
    "m2m_100": {
        "config_names": {
            "context_length": "max_position_embeddings",
            "vocab_size": "vocab_size",
            "width": "d_model",
            "heads": "encoder_attention_heads",
            "layers": "encoder_layers",
        },
        "pooler": "cls_pooler",
    },
}

# the model types hf_text implements
SUPPORTED_MODEL_TYPES = ("bert", "roberta", "xlm-roberta", "mt5", "m2m_100")

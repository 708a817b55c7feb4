"""latteclip_torch tokenizer: ids identical to latteclip_tpu's ClipTokenizer
(exact equality, no tolerance) on the golden corpus and the prompt templates."""
import json
import os

import numpy as np
import pytest
import torch

from latteclip_tpu.data.eval_dataset import DATASET_TEMPLATES as JAX_TEMPLATES
from latteclip_tpu.models.tokenizer import get_tokenizer as jax_get_tokenizer
from latteclip_torch.data.eval_dataset import DATASET_TEMPLATES, get_templates
from latteclip_torch.eval.imagenet_metadata import imagenet_classnames
from latteclip_torch.models.tokenizer import get_tokenizer

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_tokenizer.json")


@pytest.fixture(scope="module")
def toks():
    return get_tokenizer(), jax_get_tokenizer()


def test_vocab_layout(toks):
    ours, ref = toks
    assert (ours.vocab_size, ours.sot_token_id, ours.eot_token_id) == (49408, 49406, 49407)
    assert ours.encoder == ref.encoder


def test_golden_corpus_ids_match_jax(toks):
    ours, ref = toks
    with open(GOLDEN) as f:
        golden = json.load(f)
    texts = golden["texts"]
    got = ours(texts)
    assert got.dtype == np.int32 and got.shape == (len(texts), 77)
    np.testing.assert_array_equal(got, ref(texts))
    for row, ids in zip(got, golden["ids"]):
        assert row.tolist() == ids


def test_template_strings_match_jax(toks):
    ours, ref = toks
    assert sorted(DATASET_TEMPLATES) == sorted(JAX_TEMPLATES)
    names = imagenet_classnames()[::25] + ["person doing tai chi", "Boeing 747-400"]
    for key, templates in DATASET_TEMPLATES.items():
        texts = [t(c) for c in names for t in templates]
        assert texts == [t(c) for c in names for t in JAX_TEMPLATES[key]]
        np.testing.assert_array_equal(ours(texts), ref(texts))
    assert get_templates("no-such-dataset") is DATASET_TEMPLATES["default"]


def test_truncation_forces_eot(toks):
    ours, ref = toks
    out = ours("word " * 200, context_length=16)
    assert out[0, -1] == ours.eot_token_id
    np.testing.assert_array_equal(out, ref("word " * 200, context_length=16))

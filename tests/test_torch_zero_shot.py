"""latteclip_torch zero-shot slice against latteclip_tpu, end to end on a
tiny config with shared weights: template classifier, prototype classifier,
run_zero_shot_eval over uint8 batches, and a checkpoint written by the JAX
package and read by the port.

Compute is float32 on both sides, where the two packages differ only in
summation order (see tests/test_torch_model.py): classifier weights,
features and cosine logits agree to 1e-4 (logits are 100 * cosine, so 1e-2
on logits), and top-k counts must be identical.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from latteclip_tpu.core import checkpoint as jax_ckpt
from latteclip_tpu.core import config as jax_config
from latteclip_tpu.eval import zero_shot as jax_zs
from latteclip_tpu.models import clip as jax_clip
from latteclip_tpu.models.tokenizer import get_tokenizer as jax_get_tokenizer
from latteclip_torch import config as torch_config
from latteclip_torch.checkpoint import load_clip_pt, state_dict_from_jax_params
from latteclip_torch.data.eval_dataset import get_templates
from latteclip_torch.eval import zero_shot as zs
from latteclip_torch.models import clip as torch_clip
from latteclip_torch.models.tokenizer import get_tokenizer

torch.set_num_threads(1)

TOL = 1e-4
CLASSNAMES = ["tench", "goldfish", "great white shark", "kite (bird of prey)", "jay"]
TEMPLATES = get_templates("flower102") + get_templates("imagenet")   # two templates


@pytest.fixture(scope="module")
def shared():
    jcfg = dataclasses.replace(jax_config.get_model_config("ViT-tiny-test"), compute_dtype="float32")
    tcfg = dataclasses.replace(torch_config.get_model_config("ViT-tiny-test"), compute_dtype="float32")
    params = jax_clip.init_clip_params(jax.random.PRNGKey(0), jcfg)
    model = torch_clip.CLIP(tcfg)
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), tcfg), strict=True)
    return jcfg, tcfg, params, model


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i, valid in enumerate((4, 3)):   # the last batch is padded: 3 valid rows of 4
        images = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
        labels = rng.integers(0, len(CLASSNAMES), (4,))
        out.append((np.arange(4) + 4 * i, images, labels, valid))
    return out


def test_template_classifier_matches_jax(shared):
    jcfg, _, params, model = shared
    ref = np.asarray(jax_zs.build_zero_shot_classifier(
        params, jcfg, jax_get_tokenizer(), CLASSNAMES, TEMPLATES, chunk_classes=2))
    ours = zs.build_zero_shot_classifier(model, get_tokenizer(), CLASSNAMES, TEMPLATES,
                                         chunk_classes=2)
    assert ours.shape == ref.shape == (jcfg.embed_dim, len(CLASSNAMES))
    np.testing.assert_allclose(ours.numpy(), ref, atol=TOL, rtol=0)
    # the packed text tower gives the same classifier as JAX's packed build
    ref_packed = np.asarray(jax_zs.build_zero_shot_classifier(
        params, jcfg, jax_get_tokenizer(), CLASSNAMES, TEMPLATES, chunk_classes=2, packing=128))
    ours_packed = zs.build_zero_shot_classifier(model, get_tokenizer(), CLASSNAMES, TEMPLATES,
                                                chunk_classes=2, packing=128)
    np.testing.assert_allclose(ours_packed.numpy(), ref_packed, atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="packing"):
        zs.build_zero_shot_classifier(model, get_tokenizer(), CLASSNAMES, TEMPLATES, packing=64)


def test_prototype_classifier_and_eval_match_jax(shared):
    jcfg, _, params, model = shared
    bank = np.random.default_rng(7).standard_normal((len(CLASSNAMES), jcfg.embed_dim)).astype(np.float32)
    ref_clf = jax_zs.prototype_classifier(bank)
    clf = zs.prototype_classifier(torch.from_numpy(bank))
    np.testing.assert_allclose(clf.numpy(), np.asarray(ref_clf), atol=1e-6, rtol=0)

    batches = _batches()
    ref_step = jax_zs.make_eval_step(params, jcfg, ref_clf)
    step = zs.make_eval_step(model, clf)
    for _ids, images, _labels, _valid in batches:
        np.testing.assert_allclose(step(images).numpy(), np.asarray(ref_step(images)),
                                   atol=100 * TOL, rtol=0)
    ref = jax_zs.run_zero_shot_eval(params, jcfg, ref_clf, batches)
    ours = zs.run_zero_shot_eval(model, clf, batches)
    assert ours == ref and ours["n"] == 7


def test_checkpoint_written_by_jax_loads_in_the_port(shared, tmp_path):
    jcfg, tcfg, params, _ = shared
    bank = np.random.default_rng(8).standard_normal((len(CLASSNAMES), jcfg.embed_dim)).astype(np.float32)
    path = str(tmp_path / "epoch_3.pt")
    jax_ckpt.save_clip_pt(path, params, jcfg, epoch=3, name="tiny", memory_bank=bank,
                          classnames=CLASSNAMES)
    model, loaded_bank, names, meta = load_clip_pt(path, tcfg, device="cpu")
    assert names == CLASSNAMES and meta["epoch"] == 3 and meta["name"] == "tiny"
    np.testing.assert_array_equal(loaded_bank.numpy(), bank)
    images = np.random.default_rng(9).standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jax_clip.encode_image(params, jcfg, images, normalize=True))
    with torch.no_grad():
        ours = torch_clip.encode_image(model, torch.from_numpy(images), normalize=True).numpy()
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_clip_pt(path, tcfg)

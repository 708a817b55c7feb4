"""The port's Hugging Face export (latteclip_torch/hf_hub.py) against
latteclip_tpu/core/hf_hub.py on the same weights (tests/test_hf_hub.py's
tiny config):

* ``open_clip_config.json``, the tokenizer files and the push's
  ``README.md`` are byte-equal to JAX's;
* the ``.bin`` (``torch.save``) and ``.safetensors`` tensors equal JAX's key
  for key (JAX's safetensors writer turns a 0-d tensor into [1]: the
  safetensors files differ by that shape only), and both load back through the port's ``load_clip_pt`` into a
  model whose features equal the source model's bit for bit;
* where ``transformers`` imports, ``CLIPTokenizer`` on the exported files
  gives the port tokenizer's ids;
* the push builds the folder and stops only at the upload (``create_repo``
  and ``upload_folder`` replaced, as tests/test_hf_hub.py does: nothing
  reaches the network); the module's ``_main`` runs the same way;
* an int8 model is refused.
"""
import filecmp
import json
import os

import jax
import numpy as np
import pytest
import torch

from latteclip_tpu.core import hf_hub as jax_hub
from latteclip_tpu.core.checkpoint import params_to_pt_state_dict
from latteclip_tpu.core.config import config_from_dict as jax_config_from_dict
from latteclip_tpu.models.clip import init_clip_params
from latteclip_tpu.models.tokenizer import get_tokenizer as jax_tokenizer
from latteclip_torch import config as torch_config
from latteclip_torch import hf_hub
from latteclip_torch.checkpoint import load_clip_pt, load_safetensors, save_clip_pt
from latteclip_torch.config import config_from_dict
from latteclip_torch.models import clip as torch_clip
from latteclip_torch.models.quantize import replace_linear
from latteclip_torch.models.tokenizer import get_tokenizer

torch.set_num_threads(1)
RAW = {  # tests/test_hf_hub.py's _tiny_cfg
    "embed_dim": 16,
    "vision_cfg": {"image_size": 32, "layers": 2, "width": 64, "patch_size": 16},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 64, "heads": 4, "layers": 2},
}
TEXT_FILES = (hf_hub.HF_CONFIG_NAME, "vocab.json", "merges.txt", "special_tokens_map.json",
              "tokenizer_config.json")


def shared():
    jcfg, tcfg = jax_config_from_dict("tiny-hub", RAW), config_from_dict("tiny-hub", RAW)
    params = init_clip_params(jax.random.PRNGKey(0), jcfg)
    model = torch_clip.CLIP(tcfg)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                           params_to_pt_state_dict(params, jcfg).items()}, strict=True)
    return jcfg, params, tcfg, model


@pytest.fixture
def no_network(monkeypatch):
    """``create_repo``/``upload_folder`` that record instead of uploading."""
    huggingface_hub = pytest.importorskip("huggingface_hub")
    calls = []

    def create_repo(repo_id, **kw):
        calls.append(("create_repo", repo_id))

    def upload_folder(*, repo_id, folder_path, **kw):
        calls.append(("upload", sorted(os.listdir(folder_path))))
        return f"https://huggingface.co/{repo_id}"

    monkeypatch.setattr(huggingface_hub, "create_repo", create_repo)
    monkeypatch.setattr(huggingface_hub, "upload_folder", upload_folder)
    return calls


def test_folder_equals_jax(tmp_path, no_network):
    jcfg, params, tcfg, model = shared()
    kwargs = dict(model_config=hf_hub.raw_model_config("ViT-B-32"), safe_serialization="both",
                  image_interpolation="bicubic", image_resize_mode="shortest",
                  model_card={"description": "tiny", "details": {"Dataset": "DTD"}})
    assert jax_hub.push_to_hf_hub(params, jcfg, jax_tokenizer(), repo_id="org/tiny",
                                  local_dir=str(tmp_path / "jax"), **kwargs)
    assert hf_hub.push_to_hf_hub(model, get_tokenizer(), repo_id="org/tiny",
                                 local_dir=str(tmp_path / "torch"), **kwargs) \
        == "https://huggingface.co/org/tiny"
    assert no_network[-2:] == [("create_repo", "org/tiny"),
                               ("upload", sorted(os.listdir(tmp_path / "torch")))]
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
    for name in TEXT_FILES + ("README.md",):
        assert filecmp.cmp(tmp_path / "torch" / name, tmp_path / "jax" / name, shallow=False), name
    theirs = torch.load(tmp_path / "jax" / hf_hub.HF_WEIGHTS_NAME, weights_only=True)
    ours = torch.load(tmp_path / "torch" / hf_hub.HF_WEIGHTS_NAME, weights_only=True)
    safe = load_safetensors(str(tmp_path / "torch" / hf_hub.HF_SAFE_WEIGHTS_NAME))
    jax_safe = load_safetensors(str(tmp_path / "jax" / hf_hub.HF_SAFE_WEIGHTS_NAME))
    assert sorted(ours) == sorted(theirs) == sorted(safe) == sorted(jax_safe)
    for k in ours:
        for other in (theirs[k], safe[k]):
            assert torch.equal(ours[k], torch.as_tensor(other)), k
        # JAX's writer stores a 0-d tensor (logit_scale) as [1] (np.ascontiguousarray);
        # the port's keeps it 0-d, as the model and the .bin hold it
        assert torch.equal(ours[k].reshape(jax_safe[k].shape), jax_safe[k]), k


def test_weights_load_back(tmp_path):
    _, _, tcfg, model = shared()
    bank = torch.randn(3, 16)
    hf_hub.save_for_hf(model, get_tokenizer(), None, tmp_path, memory_bank=bank,
                       class_names=["a", "b", "c"])
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        want = torch_clip.encode_image(model, x)
        for name in (hf_hub.HF_WEIGHTS_NAME, hf_hub.HF_SAFE_WEIGHTS_NAME):
            loaded, got_bank, classnames, _ = load_clip_pt(str(tmp_path / name), tcfg, device="cpu")
            assert classnames == ["a", "b", "c"] and torch.equal(got_bank, bank)
            assert torch.equal(torch_clip.encode_image(loaded, x), want), name
    # the pickle is what a training checkpoint holds, less the training keys
    save_clip_pt(str(tmp_path / "ckpt.pt"), model, memory_bank=bank, classnames=["a", "b", "c"])
    ckpt = torch.load(tmp_path / "ckpt.pt", weights_only=True)["state_dict"]
    exported = torch.load(tmp_path / hf_hub.HF_WEIGHTS_NAME, weights_only=True)
    assert sorted(ckpt) == sorted(exported) and all(torch.equal(ckpt[k], exported[k]) for k in ckpt)


def test_tokenizer_export_matches_transformers(tmp_path):
    """tests/test_hf_hub.py::test_tokenizer_export_matches_transformers on
    the port's files."""
    transformers = pytest.importorskip("transformers")
    tok = get_tokenizer()
    hf_hub.save_tokenizer_for_hf(tok, tmp_path)
    hf_tok = transformers.CLIPTokenizer(vocab_file=str(tmp_path / "vocab.json"),
                                        merges_file=str(tmp_path / "merges.txt"))
    texts = ["a photo of a banded texture.", "The QUICK brown fox; jumps over 12 lazy dogs!!",
             "stripes " * 60, ""]
    ours = np.asarray(tok(texts))
    for i, t in enumerate(texts):
        ids = hf_tok(t, padding="max_length", truncation=True, max_length=77,
                     return_tensors="np")["input_ids"][0]
        end = int(np.argmax(ours[i] == tok.eot_token_id)) + 1
        np.testing.assert_array_equal(ours[i][:end], ids[:end], err_msg=repr(t))


def test_main_builds_the_folder(tmp_path, no_network, monkeypatch):
    _, _, _, model = shared()
    save_clip_pt(str(tmp_path / "w.pt"), model)
    # the tiny weights under the name ViT-B-32: its registry JSON goes in the folder
    monkeypatch.setattr(torch_config, "get_model_config", lambda name: config_from_dict(name, RAW))
    assert hf_hub._main(["--model", "ViT-B-32", "--pretrained", str(tmp_path / "w.pt"),
                         "--repo-id", "org/b32", "--local-dir", str(tmp_path / "out"),
                         "--device", "cpu"]) == 0
    assert no_network[-1][0] == "upload" and "README.md" in no_network[-1][1]
    assert json.load(open(tmp_path / "out" / hf_hub.HF_CONFIG_NAME))["model_cfg"]["embed_dim"] == 512


def test_int8_model_is_refused(tmp_path):
    _, _, _, model = shared()
    replace_linear(model)
    with pytest.raises(ValueError, match="int8 model is not saved"):
        hf_hub.save_for_hf(model, get_tokenizer(), None, tmp_path)
    with pytest.raises(ValueError, match="int8 model is not saved"):
        save_clip_pt(str(tmp_path / "q.pt"), model)

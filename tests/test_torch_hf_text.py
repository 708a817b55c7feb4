"""The HF-architecture text towers in latteclip_torch against latteclip_tpu,
in float32 on the CPU.

* the nine HF-tower JSONs (RoBERTa, XLM-R, mT5 and NLLB CLIPs) are
  byte-identical copies and parse to JAX's fields; ``hf_text_config`` gives
  JAX's config for every model type and refuses what JAX refuses, with its
  message;
* a two-layer trunk of each type (bert, roberta, xlm-roberta, mt5,
  m2m_100), under each pooler and projection, gives JAX's features to
  ``REL_TOL`` relative to the largest entry (the bound of
  tests/test_torch_vit_family.py: the same float32 arithmetic up to
  summation order), from JAX's seeded init plus N(0, 0.05^2) written by
  JAX's ``params_to_pt_state_dict``;
* the T5 relative-position buckets equal JAX's exactly, and the M2M100
  sinusoids too (both are the same float64 numpy formula);
* the HF-key import and export equal JAX's (prefixed live-model keys,
  decoder keys and aliases dropped, the pooler head kept only for a
  ``cls_pooler`` tower), and a reference-style checkpoint with keys JAX
  ignores loads through ``load_clip_pt``;
* ``HFTokenizerWrapper`` raises JAX's message where the files are absent
  (nothing is fetched: the port reads local files only, and the check runs
  with the hub client offline), and, where ``transformers`` and
  ``tokenizers`` import, gives JAX's ids for a tokenizer written to
  ``tmp_path``;
* ``latteclip_torch`` imports ``transformers`` inside functions only.
"""
import ast
import dataclasses
import filecmp
import os

import jax
import numpy as np
import pytest
import torch

from latteclip_tpu.core import checkpoint as jax_ckpt
from latteclip_tpu.core import config as jax_config
from latteclip_tpu.models import clip as jax_clip
from latteclip_tpu.models import hf_text as jax_hf
from latteclip_tpu.models import tokenizer as jax_tokenizer
from latteclip_torch import checkpoint as torch_ckpt
from latteclip_torch import config as torch_config
from latteclip_torch.models import clip as torch_clip
from latteclip_torch.models import hf_text as torch_hf
from latteclip_torch.models import tokenizer as torch_tokenizer
from test_torch_coca import assert_fields_equal

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TOL = 1e-4
HF_JSONS = ("coca_roberta-ViT-B-32", "roberta-ViT-B-32", "xlm-roberta-base-ViT-B-32",
            "xlm-roberta-large-ViT-H-14", "mt5-base-ViT-B-32", "mt5-xl-ViT-H-14",
            "nllb-clip-base", "nllb-clip-large", "nllb-clip-base-siglip", "nllb-clip-large-siglip")
VISION = {"image_size": 32, "layers": 1, "width": 64, "patch_size": 16}
TRUNKS = {
    "bert": dict(model_type="bert", vocab_size=60, width=32, layers=2, heads=2,
                 intermediate=64, max_positions=40, pad_id=0, ln_eps=1e-12),
    "roberta": dict(model_type="roberta", vocab_size=60, width=32, layers=2, heads=2,
                    intermediate=64, max_positions=40, pad_id=1),
    "xlm-roberta": dict(model_type="xlm-roberta", vocab_size=60, width=32, layers=2, heads=4,
                        intermediate=48, max_positions=40, pad_id=1),
    "mt5": dict(model_type="mt5", vocab_size=60, width=32, layers=2, heads=2, d_kv=8,
                intermediate=48, pad_id=0, ln_eps=1e-6, rel_buckets=8, rel_max_distance=16),
    "m2m_100": dict(model_type="m2m_100", vocab_size=60, width=32, layers=2, heads=2,
                    intermediate=64, max_positions=40, pad_id=1, scale_embedding=True),
}
POOLERS = ("mean_pooler", "max_pooler", "cls_pooler", "cls_last_hidden_state_pooler")


def raw_config(kind, pooler="mean_pooler", proj="mlp", ctx=12):
    text = {"hf_model_name": f"tiny/{kind}", **TRUNKS[kind], "context_length": ctx,
            "hf_pooler_type": pooler, "hf_proj_type": proj}
    return {"embed_dim": 16, "vision_cfg": VISION, "text_cfg": text}


def shared(raw, seed=0):
    jcfg = dataclasses.replace(jax_config.config_from_dict("hf", raw), compute_dtype="float32")
    tcfg = dataclasses.replace(torch_config.config_from_dict("hf", raw), compute_dtype="float32")
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32) + np.float32(0.05)
                          * rng.standard_normal(np.shape(a)).astype(np.float32),
                          jax_clip.init_clip_params(jax.random.PRNGKey(seed), jcfg))
    model = torch_clip.CLIP(tcfg)
    sd = jax_ckpt.params_to_pt_state_dict(params, jcfg)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, strict=True)
    return jcfg, params, tcfg, model


def token_rows(cfg, lengths, seed=2):
    rng = np.random.default_rng(seed)
    rows = np.full((len(lengths), cfg.context_length), cfg.pad_id, np.int32)
    for i, n in enumerate(lengths):
        rows[i, :n] = rng.integers(2, cfg.vocab_size, n)
    return rows


@pytest.mark.parametrize("name", HF_JSONS)
def test_hf_config_parses_as_jax(name):
    assert filecmp.cmp(os.path.join(REPO, "latteclip_tpu", "core", "model_configs", f"{name}.json"),
                       os.path.join(REPO, "latteclip_torch", "model_configs", f"{name}.json"),
                       shallow=False)
    j, t = jax_config.get_model_config(name), torch_config.get_model_config(name)
    assert type(t).__name__ == type(j).__name__ and type(t.text).__name__ == "HFTextConfig"
    assert_fields_equal(t, j)
    assert t.text.position_offset == j.text.position_offset


@pytest.mark.parametrize("text_raw", [
    {"hf_model_name": "roberta-base"},
    {"hf_model_name": "bert-base-uncased"},
    {"hf_model_name": "xlm-roberta-large", "proj": "linear", "hf_pooler_type": "cls_pooler"},
    {"hf_model_name": "google/mt5-xl", "hf_proj_type": "mlp"},
    {"hf_model_name": "facebook/nllb-200-distilled-600M"},
    {"hf_model_name": "somewhere/custom", "model_type": "m2m_100", "width": 64, "layers": 3},
], ids=["roberta", "bert", "xlm-roberta", "mt5", "m2m_100", "explicit"])
def test_hf_text_config_equals_jax(text_raw):
    assert dataclasses.asdict(torch_hf.hf_text_config(text_raw)) == \
        dataclasses.asdict(jax_hf.hf_text_config(text_raw))


@pytest.mark.parametrize("text_raw", [{"hf_model_name": "somewhere/unknown"},
                                      {"hf_model_name": "x", "model_type": "gpt2",
                                       "width": 8, "layers": 1}])
def test_hf_text_config_refusals_equal_jax(text_raw):
    with pytest.raises(ValueError) as ours:
        torch_hf.hf_text_config(text_raw)
    with pytest.raises(ValueError) as theirs:
        jax_hf.hf_text_config(text_raw)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("proj", ["linear", "mlp"])
@pytest.mark.parametrize("pooler", POOLERS)
@pytest.mark.parametrize("kind", list(TRUNKS))
def test_trunk_matches_jax(kind, pooler, proj):
    jcfg, params, tcfg, model = shared(raw_config(kind, pooler, proj))
    tokens = token_rows(tcfg.text, [1, 4, 9, 12])
    theirs = np.asarray(jax_clip.encode_text(params, jcfg, tokens))
    ours = torch_clip.encode_text(model, torch.from_numpy(tokens).long()).detach().numpy()
    assert ours.shape == theirs.shape == (4, 16)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=REL_TOL * np.abs(theirs).max())
    if kind in torch_hf.BERT_FAMILY:  # the token stream coca_roberta's decoder reads
        pooled, embs = jax_hf.hf_text_forward_tokens(params["text"], jcfg.text, tokens,
                                                     dtype=np.float32)
        p2, e2 = model.text.forward_tokens(torch.from_numpy(tokens).long(), dtype=torch.float32)
        np.testing.assert_allclose(e2.detach().numpy(), np.asarray(embs), rtol=0,
                                   atol=REL_TOL * np.abs(np.asarray(embs)).max())
        np.testing.assert_allclose(p2.detach().numpy(), np.asarray(pooled), rtol=0,
                                   atol=REL_TOL * np.abs(np.asarray(pooled)).max())


def test_remat_equals_no_remat():
    for kind in ("roberta", "mt5", "m2m_100"):
        _, _, tcfg, model = shared(raw_config(kind))
        tokens = torch.from_numpy(token_rows(tcfg.text, [3, 12])).long()
        grads = []
        for remat in (False, True):
            model.zero_grad()
            model.text(tokens, dtype=torch.float32, remat=remat).square().sum().backward()
            grads.append(torch.cat([p.grad.flatten() for p in model.text.parameters()]))
        torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_attention_backward_equals_autograd(dtype):
    """The recomputing backward of ``plain_attention`` against autograd
    through the same ops (JAX's ``xla_attention``, written out), a learned
    bias (T5's) included: equal in float32 to 1e-6, and in bfloat16 to one
    rounding of the result (2^-8 relative)."""
    from latteclip_torch.models import layers

    def reference(q, k, v, bias, scale):
        logits = torch.einsum("bqhd,bkhd->bhqk", (q * scale).to(dtype).float(),
                              k.to(dtype).float()) + bias.float()
        probs = torch.softmax(logits, dim=-1).to(dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.to(dtype).float()).to(dtype)

    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, n, 3, 16)).astype(np.float32)).to(dtype)
               for n in (5, 7, 7))
    bias = torch.from_numpy(rng.standard_normal((1, 3, 5, 7)).astype(np.float32))
    dout = torch.from_numpy(rng.standard_normal((2, 5, 3, 16)).astype(np.float32)).to(dtype)
    grads = []
    for fn in (lambda *a: layers.plain_attention(*a[:3], dtype=dtype, bias=a[3], scale=a[4]),
               reference):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
        out = fn(*leaves, 0.25)
        out.backward(dout)
        grads.append([out.detach()] + [t.grad for t in leaves])
    tol = 1e-6 if dtype == torch.float32 else 2 ** -8
    for a, b in zip(*grads):
        assert a.dtype == b.dtype
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=tol * scale)


@pytest.mark.parametrize("T", [1, 5, 12, 77, 200])
def test_t5_buckets_and_m2m_sinusoids_equal_jax(T):
    for buckets, dist in ((32, 128), (8, 16)):
        assert np.array_equal(torch_hf.t5_rel_buckets(T, buckets, dist),
                              jax_hf._t5_rel_buckets(T, buckets, dist))
    for dim, pad in ((32, 1), (33, 0), (1024, 1)):
        assert np.array_equal(torch_hf.sinusoid_table(T + 2, dim, pad),
                              jax_hf._sinusoid_table(T + 2, dim, pad))


@pytest.mark.parametrize("kind", list(TRUNKS))
def test_hf_keys_import_and_export_equal_jax(kind):
    pooler = "cls_pooler" if kind == "bert" else "mean_pooler"
    jcfg, params, tcfg, _ = shared(raw_config(kind, pooler))
    text = jax.tree.map(np.asarray, params["text"])
    ours, theirs = torch_hf.export_hf_state_dict(text, tcfg.text), \
        jax_hf.export_hf_state_dict(text, jcfg.text)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert np.array_equal(ours[k], theirs[k]), k
    # a live model's layout: prefixes, aliases and the decoder that JAX drops
    if kind in torch_hf.BERT_FAMILY:
        live = {("roberta." if kind != "bert" else "bert.") + k: v for k, v in theirs.items()}
        live["embeddings.position_ids"] = np.arange(40)[None]
    else:
        live = {"encoder." + k: v for k, v in theirs.items()}
        live.update({"shared.weight": theirs["embed_tokens.weight"],
                     "decoder.block.0.layer.0.SelfAttention.q.weight": np.zeros((16, 32)),
                     "lm_head.weight": np.zeros((60, 32))})
    a = torch_hf.import_hf_state_dict(live, tcfg.text)
    b = jax_hf.import_hf_state_dict(live, jcfg.text)
    fa, fb = (dict(jax.tree_util.tree_flatten_with_path(x)[0]) for x in (a, b))
    assert sorted(map(str, fa)) == sorted(map(str, fb))
    for path in fb:
        assert np.array_equal(np.asarray(fa[path]), np.asarray(fb[path])), path


@pytest.mark.parametrize("kind", ["roberta", "bert", "m2m_100"])
def test_load_clip_pt_reads_what_jax_reads(kind, tmp_path):
    """JAX's writer's file loads as is; a reference-style file with the keys
    JAX ignores (a pooler head under mean pooling, ``position_ids``) loads
    too, without them; a BERT ``cls_pooler`` file without the head loads
    into a tower without it, as JAX's tree has none."""
    jcfg, params, tcfg, model = shared(raw_config(kind, "cls_pooler" if kind == "bert"
                                                  else "mean_pooler"))
    path = str(tmp_path / "hf.pt")
    jax_ckpt.save_clip_pt(path, params, jcfg)
    loaded = torch_ckpt.load_clip_pt(path, tcfg, device="cpu")[0]
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    sd = torch.load(path, map_location="cpu", weights_only=True)["state_dict"]
    tokens = torch.from_numpy(token_rows(tcfg.text, [2, 12])).long()
    if kind == "roberta":
        sd["text.transformer.pooler.dense.weight"] = torch.zeros(32, 32)
        sd["text.transformer.pooler.dense.bias"] = torch.zeros(32)
        sd["text.transformer.embeddings.position_ids"] = torch.arange(40)[None]
    elif kind == "bert":
        del sd["text.transformer.pooler.dense.weight"], sd["text.transformer.pooler.dense.bias"]
    torch.save({"state_dict": sd}, path)
    loaded = torch_ckpt.load_clip_pt(path, tcfg, device="cpu")[0]
    jparams = jax_ckpt.load_clip_pt(path, jcfg)[0]
    assert ("pooler" in dict(loaded.text.transformer.named_children())) == \
        ("pooler_w" in jparams["text"])
    np.testing.assert_allclose(torch_clip.encode_text(loaded, tokens).detach().numpy(),
                               np.asarray(jax_clip.encode_text(jparams, jcfg, tokens.numpy())),
                               rtol=0, atol=1e-5)


@pytest.fixture
def offline_hub(monkeypatch):
    """The hub clients offline, whatever the environment says."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    try:
        import huggingface_hub.constants as hub_constants
        import transformers.utils.hub as tf_hub
    except ImportError:
        return
    monkeypatch.setattr(hub_constants, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(tf_hub, "_is_offline_mode", True, raising=False)


def test_tokenizer_without_files_raises_jax_message(tmp_path, offline_hub):
    missing = str(tmp_path / "no" / "tokenizer")
    raw = raw_config("roberta")
    raw["text_cfg"]["hf_tokenizer_name"] = missing
    jcfg, tcfg = jax_config.config_from_dict("hf", raw), torch_config.config_from_dict("hf", raw)
    with pytest.raises(RuntimeError) as ours:
        torch_tokenizer.get_tokenizer_for_config(tcfg)
    with pytest.raises(RuntimeError) as theirs:
        jax_tokenizer.get_tokenizer_for_config(jcfg)
    assert str(ours.value) == str(theirs.value)
    assert f"needs the HF tokenizer {missing!r}" in str(ours.value)


def test_tokenizer_ids_equal_jax(tmp_path, offline_hub):
    pytest.importorskip("tokenizers")
    pytest.importorskip("transformers")
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    words = ["a", "photo", "of", "the", "dog", "cat", "on", "grass", "."]
    vocab = {w: i for i, w in enumerate(["<s>", "<pad>", "</s>", "<unk>", *words])}
    tk = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tk, bos_token="<s>", eos_token="</s>",
                            pad_token="<pad>", unk_token="<unk>", sep_token="</s>"
                            ).save_pretrained(str(tmp_path / "tok"))
    texts = ["a photo of the dog .", "  cat  on\tgrass ", "zebra", "a " * 20]
    raw = raw_config("roberta")
    raw["text_cfg"]["hf_tokenizer_name"] = str(tmp_path / "tok")
    jcfg, tcfg = jax_config.config_from_dict("hf", raw), torch_config.config_from_dict("hf", raw)
    ours = torch_tokenizer.get_tokenizer_for_config(tcfg)(texts)
    theirs = jax_tokenizer.get_tokenizer_for_config(jcfg)(texts)
    assert ours.dtype == theirs.dtype == np.int32 and ours.shape == (4, 12)
    assert np.array_equal(ours, theirs)
    for strip in (False, True):
        a = torch_tokenizer.HFTokenizerWrapper(str(tmp_path / "tok"), 8, strip_sep_token=strip)
        b = jax_tokenizer.HFTokenizerWrapper(str(tmp_path / "tok"), 8, strip_sep_token=strip)
        assert np.array_equal(a(texts), b(texts))


def _import_time_imports(tree):
    """The modules an ast imports when it is executed: everything outside a
    function body (class bodies run at import)."""
    out = []
    for child in ast.iter_child_nodes(tree):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(child, ast.Import):
            out += [a.name for a in child.names]
        elif isinstance(child, ast.ImportFrom):
            out.append(child.module or "")
        out += _import_time_imports(child)
    return out


def test_port_imports_transformers_inside_functions_only():
    """No module of latteclip_torch imports transformers (or tokenizers) when
    it is imported; the HF tokenizer imports it when it is built."""
    found = []
    for dirpath, _, files in os.walk(os.path.join(REPO, "latteclip_torch")):
        for f in (f for f in files if f.endswith(".py")):
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                names = _import_time_imports(ast.parse(fh.read()))
            if any(n.split(".")[0] in ("transformers", "tokenizers") for n in names):
                found.append(path)
    assert not found
    with open(os.path.join(REPO, "latteclip_torch", "models", "tokenizer.py")) as fh:
        assert "from transformers import AutoTokenizer" in fh.read()

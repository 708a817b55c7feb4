"""The port's native ViT family against latteclip_tpu: every ``ViT-*`` config,
the tower options those configs set, and the pieces that come with them.

* every ``ViT-*.json`` of the JAX package, and every config of the towers of
  tests/test_torch_towers.py, parses in the port to JAX's fields (the port's
  copy byte-identical to JAX's file);
* five tiny configs (two layers, widths 128), one per family of options:
  LayerScale in both towers (ViT-M-16-alt-like), CLIPA-like (no ``ln_pre``,
  average pool then LayerNorm, text pooled at the last column with no causal
  mask), SigLIP-like (no class token, the MAP head, tanh GELU, a logit bias,
  the text projection's bias, text ``last`` pool with no causal mask),
  sin-cos positions and QuickGELU. Every parameter is drawn from a numpy
  seed (JAX's init plus N(0, 0.05^2) noise, so that no gamma, bias or
  LayerNorm sits at a value that would hide a misplaced one). Image features
  (pair-packed and not) and text features (padded and packed) are held to
  JAX's in float32 at 1e-4 relative to the largest feature: both packages
  run the same float32 arithmetic up to summation order (observed below
  1e-6); the state dict equals JAX's ``params_to_pt_state_dict`` and loads
  with ``strict=True``; ``decay_mask`` gives JAX's answer on every
  parameter;
* ``resize_vision_pos_embed`` against JAX's (``jax.image.resize``, bicubic)
  at 1e-5, with and without a class token, up and down, and on loading a
  ``.safetensors`` checkpoint at another image size;
* the SigLIP-like tower through the ``--method ours`` step, four float32
  SGD steps against JAX's step, captions padded and packed, at the bounds
  of tests/test_torch_train_step.py (losses 1e-5, parameters and bank 2e-5);
* the pretrained registry: the same table, the same file names, the same
  refusals, and ``build_model``'s per-tag overrides equal to JAX's for every
  (model, tag) pair of the ViT, RN, ConvNeXt and EVA configs;
* the dependency-free sentencepiece tokenizer on the toy model of
  tests/test_tokenizer.py, and ``get_tokenizer_for_config``'s refusals;
* patch dropout keeps the same tokens on both sides from the same scores.
"""
import dataclasses
import filecmp
import json
import os
import struct
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from latteclip_tpu.core import checkpoint as jax_ckpt
from latteclip_tpu.core import config as jax_config
from latteclip_tpu.core import pretrained as jax_pretrained
from latteclip_tpu.data.packing import pack_template_table as jax_pack_template_table
from latteclip_tpu.models import clip as jax_clip
from latteclip_tpu.models import tokenizer as jax_tokenizer
from latteclip_tpu.models import vit as jax_vit
from latteclip_tpu.train import main as jax_main
from latteclip_tpu.train import optim as jax_optim
from latteclip_tpu.train import params as jax_params
from latteclip_tpu.train import state as jax_state
from latteclip_tpu.train import step as jax_step
from latteclip_torch import checkpoint as torch_ckpt
from latteclip_torch import config as torch_config
from latteclip_torch import pretrained as torch_pretrained
from latteclip_torch.data.packing import pack_template_table
from latteclip_torch.models import clip as torch_clip
from latteclip_torch.models import tokenizer as torch_tokenizer
from latteclip_torch.models import vit as torch_vit
from latteclip_torch.train import main as torch_main
from latteclip_torch.train import optim as torch_optim
from latteclip_torch.train import params as torch_params
from latteclip_torch.train import state as torch_state
from latteclip_torch.train import step as torch_step

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONFIGS = os.path.join(REPO, "latteclip_tpu", "core", "model_configs")
# the native ViTs, and the timm-trunk and ResNet towers (tests/test_torch_towers.py)
VIT_NAMES = sorted(f[:-len(".json")] for f in os.listdir(JAX_CONFIGS)
                   if f.startswith(("ViT-", "RN", "convnext_", "EVA", "swin_", "vit_relpos_",
                                    "vit_medium_")) and f.endswith(".json"))
REL_TOL = 1e-4
VOCAB, CTX, EOT = 500, 16, 499


def _raw(vision=None, text=None, **top):
    return {"embed_dim": 64, "compute_dtype": "float32",
            "vision_cfg": {"image_size": 48, "patch_size": 16, "width": 128, "layers": 2,
                           **(vision or {})},
            "text_cfg": {"context_length": CTX, "vocab_size": VOCAB, "width": 128, "heads": 2,
                         "layers": 2, **(text or {})},
            **top}


TINY = {
    "layerscale": _raw({"ls_init_value": 0.5}, {"ls_init_value": 0.5}),
    "clipa": _raw({"no_ln_pre": True, "pool_type": "avg", "final_ln_after_pool": True},
                  {"pool_type": "last", "no_causal_mask": True}),
    "siglip": _raw({"pool_type": "map", "no_cls_token": True, "no_ln_pre": True, "ln_eps": 1e-6},
                   {"pool_type": "last", "no_causal_mask": True, "ln_eps": 1e-6},
                   embed_dim=128, gelu_tanh=True, init_logit_bias=-10.0,
                   init_logit_scale=2.302585092994046),
    "sincos": _raw({"pos_embed_type": "sin_cos_2d"}),
    "quickgelu": _raw(quick_gelu=True),
}


def _perturbed(params, seed):
    """JAX's init plus N(0, 0.05^2) on every leaf; the SigLIP-like tower's
    text projection gets the bias a SigLIP checkpoint carries."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(lambda a: np.asarray(a, np.float32)
                       + np.float32(0.05) * rng.standard_normal(np.shape(a)).astype(np.float32),
                       params)
    if "logit_bias" in out:
        out["text"]["text_projection_b"] = rng.standard_normal(
            out["text"]["text_projection"].shape[1]).astype(np.float32)
    return out


def _shared(name, seed=0, raw=None):
    """(JAX config, JAX params, port model) on the same weights."""
    raw = raw or TINY[name]
    jcfg, tcfg = jax_config.config_from_dict(name, raw), torch_config.config_from_dict(name, raw)
    params = _perturbed(jax_clip.init_clip_params(jax.random.PRNGKey(seed), jcfg), seed)
    sd = torch_ckpt.state_dict_from_jax_params(params, tcfg)
    model = torch_clip.CLIP(tcfg, text_projection_b="text_projection_b" in params["text"])
    model.load_state_dict(sd, strict=True)
    return jcfg, params, model


def _close(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=REL_TOL * np.abs(ref).max())


def _token_rows(rng, n):
    """Padded rows of VOCAB-sized ids whose EOT (the highest id) ends each
    sequence, so that argmax pooling and the packer find it."""
    rows = np.zeros((n, CTX), np.int32)
    for i, ln in enumerate(rng.integers(3, CTX + 1, n)):
        rows[i, :ln - 1] = rng.integers(1, EOT, ln - 1)
        rows[i, ln - 1] = EOT
    return rows


@pytest.mark.parametrize("name", VIT_NAMES)
def test_every_vit_config_parses_as_jax(name):
    assert filecmp.cmp(os.path.join(JAX_CONFIGS, f"{name}.json"),
                       os.path.join(REPO, "latteclip_torch", "model_configs", f"{name}.json"),
                       shallow=False)
    j, t = jax_config.get_model_config(name), torch_config.get_model_config(name)
    for sub in ("vision", "text"):
        jd, td = dataclasses.asdict(getattr(j, sub)), dataclasses.asdict(getattr(t, sub))
        assert {k: jd[k] for k in td} == td
        # the JAX fields the port lacks belong to refused towers: at their defaults,
        # save the refused HF tokenizer's strip_sep_token (CLIPA)
        defaults = {f.name: f.default for f in dataclasses.fields(getattr(j, sub))}
        only_jax = set(jd) - set(td) - {"strip_sep_token"}
        assert {k: jd[k] for k in only_jax} == {k: defaults[k] for k in only_jax}
        if jd.get("strip_sep_token"):
            assert td["hf_tokenizer_name"]
    top = [f.name for f in dataclasses.fields(t) if f.name not in ("vision", "text")]
    assert {k: getattr(t, k) for k in top} == {k: getattr(j, k) for k in top}
    assert type(t.vision).__name__ == type(j.vision).__name__
    for prop in ("seq_len", "heads", "grid", "embed_width", "depths", "dims"):
        if hasattr(type(t.vision), prop):
            assert getattr(t.vision, prop) == getattr(j.vision, prop), prop


@pytest.mark.parametrize("name", list(TINY))
def test_image_features_match_jax(name):
    jcfg, params, model = _shared(name)
    x = np.random.default_rng(1).standard_normal((4, 48, 48, 3)).astype(np.float32)
    ref = np.asarray(jax_clip.encode_image(params, jcfg, x))  # JAX pair-packs at L <= 64
    with torch.no_grad():
        for pack in (False, True):
            _close(torch_clip.encode_image(model, torch.from_numpy(x), pack_pairs=pack), ref)


@pytest.mark.parametrize("name", list(TINY))
def test_text_features_match_jax(name):
    jcfg, params, model = _shared(name)
    rows = _token_rows(np.random.default_rng(2), 6)
    packed = pack_template_table(rows, 32)
    for a, b in zip(packed, jax_pack_template_table(rows, 32)):
        np.testing.assert_array_equal(a, b)
    with torch.no_grad():
        _close(torch_clip.encode_text(model, torch.from_numpy(rows).long()),
               jax_clip.encode_text(params, jcfg, rows))
        _close(torch_clip.encode_text_packed(model, *(torch.from_numpy(a).long() for a in packed)),
               jax_clip.encode_text_packed(params, jcfg, *packed))


@pytest.mark.parametrize("name", list(TINY))
def test_state_dict_equals_jax_writer(name):
    jcfg, params, _ = _shared(name)
    tcfg = torch_config.config_from_dict(name, TINY[name])
    ours = torch_ckpt.state_dict_from_jax_params(params, tcfg)
    ref = jax_ckpt.params_to_pt_state_dict(params, jcfg)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].dtype == torch.float32 and tuple(ours[k].shape) == np.shape(v), k
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v, np.float32), err_msg=k)
    model = torch_clip.CLIP(tcfg, text_projection_b="text_projection_b" in params["text"])
    model.load_state_dict(ours, strict=True)
    back = torch_ckpt.jax_params_from_state_dict(model.state_dict(), tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(TINY))
def test_decay_mask_equals_jax(name):
    _, params, model = _shared(name)
    mask = torch_optim.decay_mask(model)
    as_arrays = {n: torch.full(p.shape, float(mask[n])) for n, p in model.named_parameters()}
    ours = torch_ckpt.jax_params_from_state_dict(as_arrays, model.cfg)
    ref = jax_optim.decay_mask(params)
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    paths = jax.tree_util.tree_flatten_with_path(ref)[0]
    for (path, want), got in zip(paths, jax.tree.leaves(ours)):
        assert np.all(got == float(want)), jax.tree_util.keystr(path)


def _write_safetensors(path, sd):
    """A float32 ``.safetensors`` file written by hand: a u64-LE header
    length, the JSON header, the raw buffers."""
    header, blobs, offset = {}, [], 0
    for k, v in sd.items():
        blob = np.ascontiguousarray(np.asarray(v, np.float32)).tobytes()
        header[k] = {"dtype": "F32", "shape": list(np.shape(v)),
                     "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    head = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(head)) + head + b"".join(blobs))


@pytest.mark.parametrize("name", ["siglip", "layerscale"])
def test_load_clip_pt_resizes_like_jax(name, tmp_path):
    """A checkpoint of the 48-px tower loaded at 64 px (a 4 x 4 grid) from a
    ``.safetensors`` file by both packages' ``load_clip_pt``: the same
    parameters (the positional embedding resized, with or without a class
    token), the MAP head, logit bias and text projection bias included."""
    jcfg, params, _ = _shared(name)
    path = tmp_path / "w.safetensors"
    _write_safetensors(path, jax_ckpt.params_to_pt_state_dict(params, jcfg))
    raw = dict(TINY[name], vision_cfg=dict(TINY[name]["vision_cfg"], image_size=64))
    jcfg64 = jax_config.config_from_dict(name, raw)
    theirs = jax_ckpt.load_clip_pt(str(path), jcfg64)[0]
    model = torch_ckpt.load_clip_pt(str(path), torch_config.config_from_dict(name, raw),
                                    device="cpu")[0]
    ref = jax_ckpt.params_to_pt_state_dict(jax.tree.map(np.asarray, theirs), jcfg64)
    ours = model.state_dict()
    assert sorted(ours) == sorted(ref)
    assert tuple(ours["visual.positional_embedding"].shape) == (jcfg64.vision.seq_len, 128)
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(v), rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("cls_token", [True, False])
@pytest.mark.parametrize("grids", [(7, 16), (16, 7)])
def test_resize_vision_pos_embed_matches_jax(cls_token, grids):
    old, new = grids
    n = 1 if cls_token else 0
    pos = np.random.default_rng(old).standard_normal((old * old + n, 32)).astype(np.float32)
    ref = jax_ckpt.resize_vision_pos_embed(pos, new * new + n, cls_token=cls_token)
    ours = torch_ckpt.resize_vision_pos_embed(torch.from_numpy(pos), new * new + n,
                                              cls_token=cls_token)
    assert tuple(ours.shape) == ref.shape == (new * new + n, 32)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)


def _caption_rows(rng, n, eot):
    lengths = rng.integers(8, 40, n)
    rows = np.zeros((n, 77), np.int32)
    for i, ln in enumerate(lengths):
        rows[i, :ln - 1] = rng.integers(1, 40000, ln - 1)
        rows[i, ln - 1] = eot
    return rows


@pytest.mark.parametrize("packed", [False, True])
def test_siglip_like_train_step_matches_jax(packed):
    """Four float32 SGD steps of the --method ours step (augment off) on the
    SigLIP-like towers at the CLIP vocabulary, as tests/test_torch_train_step.py
    runs ViT-tiny: losses to 1e-5, every parameter and the bank to 2e-5."""
    from latteclip_torch.data.packing import (PackRowBucketer, pack_caption_batch,
                                              pack_rows_needed, token_lengths)

    raw = dict(TINY["siglip"], text_cfg=dict(TINY["siglip"]["text_cfg"], context_length=77,
                                             vocab_size=49408))
    raw["vision_cfg"] = dict(raw["vision_cfg"], image_size=32)
    jcfg, params, model = _shared("siglip", raw=raw)
    classes, templates = [f"class {i}" for i in range(6)], [lambda c: f"a photo of a {c}."]
    tok = torch_tokenizer.get_tokenizer()
    rng, bucket = np.random.default_rng(0), PackRowBucketer(multiple=8)
    batches = []
    for _ in range(2):
        b = {"images": rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8),
             "per_image_tokens": _caption_rows(rng, 8, tok.eot_token_id),
             "per_group_tokens": _caption_rows(rng, 8, tok.eot_token_id),
             "zs_preds": rng.integers(0, len(classes), 8).astype(np.int32)}
        if packed:
            lengths = token_lengths(np.concatenate([b["per_image_tokens"], b["per_group_tokens"]]))
            b.update(pack_caption_batch(b["per_image_tokens"], b["per_group_tokens"], 128,
                                        bucket.rows_for(pack_rows_needed(lengths, 128))))
        batches.append(b)
    table = jax_state.build_template_table(jax_tokenizer.get_tokenizer(), classes, templates)
    bank = jax_state.init_memory_bank(params, jcfg, jax_tokenizer.get_tokenizer(), classes,
                                      templates)
    tx = optax.sgd(1e-2)
    jstate = jax_state.create_train_state(params, tx, bank)
    jfn = jax.jit(jax_step.make_train_step(
        jcfg, tx, jax_step.LatteHParams(augment=False, text_packing=packed), table,
        template_packed=jax_pack_template_table(table, 128) if packed else None))
    tbank = torch_state.init_memory_bank(model, tok, classes, templates)
    np.testing.assert_allclose(tbank.numpy(), np.asarray(bank), atol=2e-5, rtol=0)
    tstate = torch_state.create_train_state(model, torch.optim.SGD(model.parameters(), lr=1e-2),
                                            tbank)
    tfn = torch_step.make_train_step(
        model, torch_step.LatteHParams(augment=False, text_packing=packed), table,
        template_packed=pack_template_table(table, 128) if packed else None)
    jl, tl = [], []
    for i in range(4):
        jstate, jm = jfn(jstate, batches[i % 2], jax.random.PRNGKey(i))
        jl.append(float(jm["loss"]))
        tl.append(float(tfn(tstate, batches[i % 2])["loss"]))
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    ref = torch_ckpt.state_dict_from_jax_params(jax.tree.map(np.asarray, jstate.params), model.cfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), atol=2e-5, rtol=0,
                                   err_msg=name)
    np.testing.assert_allclose(tstate.memory_bank.numpy(), np.asarray(jstate.memory_bank),
                               atol=2e-5, rtol=0)


def test_pretrained_registry_equals_jax(tmp_path, monkeypatch):
    assert torch_pretrained.PRETRAINED == jax_pretrained.PRETRAINED
    assert torch_pretrained.list_pretrained() == jax_pretrained.list_pretrained()
    monkeypatch.setenv("LATTECLIP_CACHE_DIR", str(tmp_path))
    for model, tag in jax_pretrained.list_pretrained():
        for m in (model, model + "-quickgelu"):
            assert torch_pretrained.get_pretrained_cfg(m, tag) == \
                jax_pretrained.get_pretrained_cfg(m, tag)
        names = torch_pretrained._candidate_names(torch_pretrained.get_pretrained_cfg(model, tag))
        assert names == jax_pretrained._candidate_names(jax_pretrained.get_pretrained_cfg(model, tag))
        with pytest.raises(FileNotFoundError) as ours:
            torch_pretrained.resolve_pretrained(model, tag)
        with pytest.raises(FileNotFoundError) as theirs:
            jax_pretrained.resolve_pretrained(model, tag)
        assert str(ours.value) == str(theirs.value)
        (tmp_path / names[-1]).write_bytes(b"")
        assert torch_pretrained.resolve_pretrained(model, tag) == \
            jax_pretrained.resolve_pretrained(model, tag) == str(tmp_path / names[-1])
    for call in (torch_pretrained.resolve_pretrained, jax_pretrained.resolve_pretrained):
        with pytest.raises(ValueError, match="unknown pretrained tag 'nope' for 'ViT-L-14'"):
            call("ViT-L-14", "nope")


@pytest.mark.parametrize("model", sorted({m for m, _ in jax_pretrained.list_pretrained()
                                          if m.startswith(("ViT-", "RN", "convnext_", "EVA"))}))
def test_pretrained_tag_overrides_equal_jax(model, tmp_path, monkeypatch):
    """``build_model`` with a tag, the checkpoint loaders stubbed: the config's
    QuickGELU, mean, std and resize mode equal JAX's (after its
    ``_apply_reference_compat_overrides``) for every tag of the model and
    its -quickgelu variant."""
    monkeypatch.setenv("LATTECLIP_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax_main.ckpt, "load_clip_pt", lambda path, cfg: ({}, {}, {}))
    monkeypatch.setattr(torch_main.ckpt, "load_clip_pt", lambda path, cfg, device: (
        types.SimpleNamespace(cfg=cfg, visual=types.SimpleNamespace()), None, [], {}))
    for name in (model, model + "-quickgelu"):
        if not os.path.exists(os.path.join(JAX_CONFIGS, f"{name}.json")):
            continue
        for tag in jax_pretrained.list_pretrained_tags_by_model(model):
            for fname in jax_pretrained._candidate_names(jax_pretrained.get_pretrained_cfg(model, tag)):
                (tmp_path / fname).write_bytes(b"")
            argv = ["--model", name, "--pretrained", tag]
            jargs = jax_params.parse_args(argv)
            jcfg = jax_main._apply_reference_compat_overrides(jargs, jax_main.build_model(jargs)[0])
            tcfg = torch_main.build_model(torch_params.parse_args(argv), "cpu")[0]
            for key in ("quick_gelu", "image_mean", "image_std", "resize_mode"):
                assert getattr(tcfg, key) == getattr(jcfg, key), (name, tag, key)


def _sp_model_bytes(pieces):
    """A sentencepiece ModelProto written by hand (tests/test_tokenizer.py)."""
    import struct

    def varint(n):
        out = b""
        while True:
            b7, n = n & 0x7F, n >> 7
            out += bytes([b7 | (0x80 if n else 0)])
            if not n:
                return out

    blob = b""
    for piece, score, ptype in pieces:
        enc = piece.encode("utf-8")
        sub = (b"\x0a" + varint(len(enc)) + enc + b"\x15" + struct.pack("<f", score)
               + b"\x18" + varint(ptype))
        blob += b"\x0a" + varint(len(sub)) + sub
    return blob


def test_sentencepiece_tokenizer_matches_jax(tmp_path, monkeypatch):
    pieces = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2),
              ("▁", -10.0, 1), ("▁a", -1.0, 1), ("▁cat", -2.0, 1),
              ("▁ca", -3.0, 1), ("t", -0.5, 1), ("c", -4.0, 1), ("a", -4.0, 1)]
    pieces += [(f"<0x{b:02X}>", -20.0, 6) for b in range(256)]
    model = tmp_path / "toy.model"
    model.write_bytes(_sp_model_bytes(pieces))
    texts = ["A Cat!", "a cat " * 20, "zé cat_a", "", "Hello, World."]
    ours = torch_tokenizer.MiniSentencePiece.from_file(str(model))
    theirs = jax_tokenizer.MiniSentencePiece.from_file(str(model))
    assert ours.pieces == theirs.pieces and ours.unk_id == theirs.unk_id
    for text in texts:
        assert ours.encode(text) == theirs.encode(text)
        assert torch_tokenizer.canonicalize_text(text) == jax_tokenizer.canonicalize_text(text)
    np.testing.assert_array_equal(torch_tokenizer.SigLipTokenizer(str(model), 8)(texts),
                                  jax_tokenizer.SigLipTokenizer(str(model), 8)(texts))
    # the config dispatch: SigLIP's vocab from $LATTECLIP_SIGLIP_VOCAB, else refused
    name = "ViT-B-16-SigLIP"
    jcfg, tcfg = jax_config.get_model_config(name), torch_config.get_model_config(name)
    with pytest.raises(FileNotFoundError) as a:
        torch_tokenizer.get_tokenizer_for_config(tcfg)
    with pytest.raises(FileNotFoundError) as b:
        jax_tokenizer.get_tokenizer_for_config(jcfg)
    assert str(a.value) == str(b.value)
    monkeypatch.setenv("LATTECLIP_SIGLIP_VOCAB", str(model))
    np.testing.assert_array_equal(torch_tokenizer.get_tokenizer_for_config(tcfg)(texts),
                                  jax_tokenizer.get_tokenizer_for_config(jcfg)(texts))
    # CLIPA's HF vocabulary is not on disk: the same refusal
    name = "ViT-L-14-CLIPA"
    with pytest.raises(RuntimeError) as a:
        torch_tokenizer.get_tokenizer_for_config(torch_config.get_model_config(name))
    assert "needs the HF tokenizer 'bert-base-uncased'" in str(a.value)


@pytest.mark.parametrize("has_cls", [True, False])
def test_patch_dropout_keeps_jax_tokens(has_cls, monkeypatch):
    """JAX's scores replaced by the port's draw from the same generator seed:
    the same tokens kept, in the same order, and in the forward (train=True)
    the same features."""
    raw = _raw({"patch_dropout": 0.4, **({} if has_cls else {"no_cls_token": True,
                                                             "pool_type": "avg"})})
    jcfg, params, model = _shared("dropout", raw=raw)
    drawn = {}
    monkeypatch.setattr(jax.random, "normal", lambda rng, shape: jnp.asarray(drawn[shape]))

    def scores(shape, seed):
        drawn[shape] = torch.randn(shape, generator=torch.Generator().manual_seed(seed)).numpy()
        return torch.Generator().manual_seed(seed)

    x = np.random.default_rng(3).standard_normal((3, 10 + has_cls, 8)).astype(np.float32)
    gen = scores((3, 10), 5)
    ref = np.asarray(jax_vit.patch_dropout(jnp.asarray(x), 0.4, jax.random.PRNGKey(0), has_cls))
    ours = torch_vit.patch_dropout(torch.from_numpy(x), 0.4, gen, has_cls).numpy()
    assert ours.shape == ref.shape == (3, 6 + has_cls, 8)
    np.testing.assert_array_equal(ours, ref)
    img = np.random.default_rng(4).standard_normal((3, 48, 48, 3)).astype(np.float32)
    gen = scores((3, 9), 6)
    ref = jax_clip.encode_image(params, jcfg, img, train=True, rng=jax.random.PRNGKey(0))
    with torch.no_grad():
        _close(torch_clip.encode_image(model, torch.from_numpy(img), train=True, generator=gen),
               ref)

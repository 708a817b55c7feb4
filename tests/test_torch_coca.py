"""CoCa in latteclip_torch against latteclip_tpu, in float32 on the CPU.

Weights cross as everywhere in the port: JAX's seeded init plus N(0, 0.05^2)
on every leaf (so that no LayerNorm, bias or class token sits at a value
that hides a misplaced one), written by JAX's ``params_to_pt_state_dict``
and loaded with ``load_state_dict(strict=True)``.

* the five CoCa JSONs are byte-identical copies and parse to JAX's fields;
* the attentional pool (pooled feature and image tokens), the class-token
  text tower (rows of every length, the empty row whose class token sees
  only key 0, rows without pads), the decoder, the full forward and
  CoCaLoss match JAX's to ``REL_TOL`` (the features' bound of
  tests/test_torch_vit_family.py: both run the same float32 arithmetic up
  to summation order, a few ulp, which the two-layer towers and the decoder
  leave far below 1e-4 relative to the largest entry);
* ``generate`` (greedy) and ``generate_beamsearch`` give JAX's tokens
  exactly. Top-k sampling is held against the port itself only (seeded
  generator, top-1 equals greedy, every draw within the top k): JAX draws
  with ``jax.random.categorical`` on a threefry key, a stream torch cannot
  reproduce, so equal samples cannot be asked for;
* the state dict equals JAX's writer's, round-trips to JAX's tree and loads
  through ``load_clip_pt``;
* ``coca_roberta`` (the decoder over a two-layer RoBERTa trunk's tokens,
  the vision tower without the attentional pool) matches JAX in forward,
  loss and greedy generation, whose not-yet-generated positions hold the
  trunk's pad id.
"""
import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latteclip_tpu.core import checkpoint as jax_ckpt
from latteclip_tpu.core import config as jax_config
from latteclip_tpu.models import clip as jax_clip
from latteclip_tpu.models import coca as jax_coca
from latteclip_tpu.models import vit as jax_vit
from latteclip_torch import checkpoint as torch_ckpt
from latteclip_torch import config as torch_config
from latteclip_torch.models import clip as torch_clip
from latteclip_torch.models import coca as torch_coca
from latteclip_torch.models import vit as torch_vit

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TOL = 1e-4
COCA_JSONS = ("coca_ViT-B-32", "coca_ViT-L-14", "coca_base", "coca_tiny-test",
              "coca_roberta-ViT-B-32")
# tests/test_coca.py's tiny CoCa
COCA_SMALL = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 32, "layers": 2, "width": 64, "patch_size": 16,
                   "attentional_pool": True, "attn_pooler_queries": 8, "attn_pooler_heads": 4,
                   "output_tokens": True},
    "text_cfg": {"context_length": 12, "vocab_size": 96, "width": 32, "heads": 4, "layers": 2,
                 "embed_cls": True, "output_tokens": True},
    "multimodal_cfg": {"context_length": 12, "vocab_size": 96, "width": 32, "heads": 4,
                       "layers": 2},
}
# coca_roberta-ViT-B-32 cut to two layers of 32 wide everywhere
COCA_ROBERTA = {
    "embed_dim": 16,
    "vision_cfg": {"image_size": 32, "layers": 2, "width": 32, "head_width": 16,
                   "patch_size": 16, "output_tokens": True},
    "text_cfg": {"hf_model_name": "tiny/roberta", "hf_tokenizer_name": "tiny/roberta",
                 "model_type": "roberta", "vocab_size": 96, "width": 32, "layers": 2, "heads": 2,
                 "intermediate": 64, "max_positions": 40, "pad_id": 1, "context_length": 12,
                 "hf_proj_type": "linear", "output_tokens": True},
    "multimodal_cfg": {"context_length": 12, "width": 32, "heads": 4, "layers": 2,
                       "vocab_size": 96},
    "custom_text": True,
}


def perturbed(params, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + np.float32(0.05)
                        * rng.standard_normal(np.shape(a)).astype(np.float32), params)


def shared(raw, name="coca", seed=0):
    """(JAX config, JAX params, port config, port model) on the same weights."""
    jcfg = dataclasses.replace(jax_config.config_from_dict(name, raw), compute_dtype="float32")
    tcfg = dataclasses.replace(torch_config.config_from_dict(name, raw), compute_dtype="float32")
    params = perturbed(jax_coca.init_coca_params(jax.random.PRNGKey(seed), jcfg), seed)
    model = torch_clip.build_model(tcfg)
    sd = jax_ckpt.params_to_pt_state_dict(params, jcfg)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, strict=True)
    return jcfg, params, tcfg, model


def images(n, size, seed=1):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def token_rows(lengths, ctx, vocab, pad=0, seed=2):
    rng = np.random.default_rng(seed)
    rows = np.full((len(lengths), ctx), pad, np.int32)
    for i, n in enumerate(lengths):
        rows[i, :n] = rng.integers(2, vocab, n)
    return rows


def close(ours, theirs, msg=""):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape, msg
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=REL_TOL * np.abs(theirs).max(),
                               err_msg=msg)


@pytest.mark.parametrize("name", COCA_JSONS)
def test_coca_config_parses_as_jax(name):
    assert filecmp.cmp(os.path.join(REPO, "latteclip_tpu", "core", "model_configs", f"{name}.json"),
                       os.path.join(REPO, "latteclip_torch", "model_configs", f"{name}.json"),
                       shallow=False)
    j, t = jax_config.get_model_config(name), torch_config.get_model_config(name)
    assert type(t).__name__ == type(j).__name__ == "CoCaConfig"
    assert_fields_equal(t, j)


def assert_fields_equal(t, j):
    """The port's config fields equal JAX's. The port's TextConfig has no
    ``pad_id`` (no port code reads it; CoCa's pad id is the CoCaConfig's):
    JAX's must be at its default, 0."""
    td, jd = dataclasses.asdict(t), dataclasses.asdict(j)
    for sub in ("text", "multimodal"):
        if sub in td and "pad_id" not in td[sub]:
            assert jd[sub].pop("pad_id") == 0
    assert td == jd


def test_attentional_pool_matches_jax():
    jcfg, params, tcfg, model = shared(COCA_SMALL)
    x = images(3, 32)
    pooled, tokens = jax_vit.vit_forward(params["visual"], jcfg.vision, x, dtype=jnp.float32,
                                         output_tokens=True)
    ours, our_tokens = torch_vit.vit_forward(model.visual, torch.from_numpy(x),
                                             dtype=torch.float32, output_tokens=True)
    assert our_tokens.shape == (3, COCA_SMALL["vision_cfg"]["attn_pooler_queries"] - 1, 32)
    close(ours, pooled, "pooled")
    close(our_tokens, tokens, "tokens")
    close(torch_clip.encode_image(model, torch.from_numpy(x), normalize=True),
          jax_clip.encode_image(params, jcfg, x, normalize=True), "encode_image")


def test_text_tower_matches_jax():
    """Rows of 0 (every key but key 0 hidden from the class token), 1, 5 and
    11 tokens, and one without pads."""
    jcfg, params, tcfg, model = shared(COCA_SMALL)
    tokens = token_rows([0, 1, 5, 11, 12], 12, 96)
    latent, embs = jax_coca.coca_text_forward(params["text"], jcfg.text, tokens,
                                              dtype=jnp.float32)
    ours, our_embs = torch_coca.coca_text_forward(model.text, tcfg.text,
                                                  torch.from_numpy(tokens).long(),
                                                  dtype=torch.float32)
    close(ours, latent, "latent")
    close(our_embs, embs, "token embeddings")
    close(torch_clip.encode_text(model, torch.from_numpy(tokens).long(), normalize=True),
          jax_clip.encode_text(params, jcfg, tokens, normalize=True), "encode_text")


@pytest.mark.parametrize("raw", [COCA_SMALL, COCA_ROBERTA], ids=["coca", "coca_roberta"])
def test_decode_forward_and_loss_match_jax(raw):
    jcfg, params, tcfg, model = shared(raw)
    pad = 1 if "hf_model_name" in raw["text_cfg"] else 0
    x, tokens = images(3, 32), token_rows([3, 7, 12], 12, 96, pad=pad)
    out = jax_coca.coca_forward(params, jcfg, x, tokens)
    ours = torch_coca.coca_forward(model, torch.from_numpy(x), torch.from_numpy(tokens).long())
    for k in ("image_features", "text_features", "logits"):
        close(ours[k], out[k], k)
    assert torch.equal(ours["labels"], torch.from_numpy(np.asarray(out["labels"])).long())
    for weights in ((2.0, 1.0), (1.0, 0.0)):
        theirs = jax_coca.coca_loss(out, caption_loss_weight=weights[0],
                                    clip_loss_weight=weights[1], pad_id=jcfg.pad_id)
        mine = torch_coca.coca_loss(ours, caption_loss_weight=weights[0],
                                    clip_loss_weight=weights[1], pad_id=tcfg.pad_id)
        for k in theirs:
            np.testing.assert_allclose(float(mine[k].detach()), float(theirs[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    # the decoder alone, on the towers' own token embeddings
    _, image_embs = jax_vit.vit_forward(params["visual"], jcfg.vision, x, dtype=jnp.float32,
                                        output_tokens=True)
    _, token_embs = jax_coca.encode_text_tokens(params, jcfg, tokens, dtype=jnp.float32)
    logits = jax_coca.coca_decode(params["text_decoder"], jcfg.multimodal, token_embs, image_embs,
                                  dtype=jnp.float32)
    close(torch_coca.coca_decode(model.text_decoder, tcfg.multimodal,
                                 torch.from_numpy(np.array(token_embs)),
                                 torch.from_numpy(np.array(image_embs)), dtype=torch.float32),
          logits, "decode")


@pytest.mark.parametrize("raw", [COCA_SMALL, COCA_ROBERTA], ids=["coca", "coca_roberta"])
def test_generate_greedy_equals_jax(raw):
    jcfg, params, tcfg, model = shared(raw)
    x = images(3, 32, seed=5)
    ids = dict(sot_token_id=94, eot_token_id=95, seq_len=10)
    theirs = jax_coca.generate(params, jcfg, x, **ids)
    ours = torch_coca.generate(model, torch.from_numpy(x), **ids)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    if "hf_model_name" in raw["text_cfg"]:  # the fill of positions not yet generated
        assert (ours[:, 10:] == 1).all()


def test_top_k_generate_is_seeded_and_within_top_k():
    _, _, tcfg, model = shared(COCA_SMALL)
    x = torch.from_numpy(images(3, 32, seed=5))
    ids = dict(sot_token_id=94, eot_token_id=95, seq_len=10)
    a = torch_coca.generate(model, x, top_k=3, generator=torch.Generator().manual_seed(7), **ids)
    b = torch_coca.generate(model, x, top_k=3, generator=torch.Generator().manual_seed(7), **ids)
    assert np.array_equal(a, b)
    assert np.array_equal(torch_coca.generate(model, x, top_k=1, **ids),
                          torch_coca.generate(model, x, **ids))
    _, image_embs = torch_coca.encode_image_tokens(model, x)
    step = torch_coca._step_logits(model, image_embs)
    for pos in range(1, 10):
        live = ~np.isin(a[:, :pos], [95]).any(1)
        if not live.any():
            break
        top = step(torch.from_numpy(a).long())[:, pos - 1].topk(3, dim=-1).indices.numpy()
        assert all(a[i, pos] in top[i] for i in np.flatnonzero(live))


def test_beamsearch_equals_jax():
    jcfg, params, tcfg, model = shared(COCA_SMALL)
    x = images(2, 32, seed=6)
    ids = dict(sot_token_id=94, eot_token_id=95, seq_len=10, min_seq_len=3)
    theirs = jax_coca.generate_beamsearch(params, jcfg, x, **ids)
    ours = torch_coca.generate_beamsearch(model, torch.from_numpy(x), **ids)
    assert np.array_equal(ours, theirs)


@pytest.mark.parametrize("raw", [COCA_SMALL, COCA_ROBERTA], ids=["coca", "coca_roberta"])
def test_state_dict_equals_jax_writer_and_loads(raw, tmp_path):
    jcfg, params, tcfg, model = shared(raw)
    theirs = jax_ckpt.params_to_pt_state_dict(params, jcfg)
    ours = torch_ckpt.state_dict_from_jax_params(params, tcfg)
    assert sorted(model.state_dict()) == sorted(ours) == sorted(theirs)
    for k, v in ours.items():
        assert np.array_equal(v.numpy(), np.asarray(theirs[k])), k
    back = torch_ckpt.jax_params_from_state_dict(model.state_dict(), tcfg)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert sorted(map(str, flat_back)) == sorted(map(str, flat))
    for path, a in flat.items():
        assert np.array_equal(np.asarray(flat_back[path]), np.asarray(a)), path
    path = str(tmp_path / "coca.pt")
    bank = np.random.default_rng(3).standard_normal((2, 16 if "hf_model_name" in raw["text_cfg"]
                                                     else 32)).astype(np.float32)
    jax_ckpt.save_clip_pt(path, params, jcfg, memory_bank=bank, classnames=["a", "b"])
    loaded, got_bank, names, _ = torch_ckpt.load_clip_pt(path, tcfg, device="cpu")
    assert type(loaded).__name__ == "CoCa" and names == ["a", "b"]
    assert np.array_equal(got_bank.numpy(), bank)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, ours[k]), k

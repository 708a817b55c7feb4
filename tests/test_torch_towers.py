"""The port's timm-trunk and ResNet vision towers against latteclip_tpu.

Ten tiny towers, one per family and option the JAX package has: EVA02 in
its B form (fused qkv with q/v biases, rope, SwiGLU with a sub-LayerNorm,
inner attention LayerNorm), its L form (split q/k/v) and its E form
(post-norm, plain MLP, no rope, heads 32 wide); EVA01 (a timm Eva trunk on
the native ViT); ViT-medium with average pooling and no class token; the
ModifiedResNet; ConvNeXt with the linear and the mlp head; Swin (a shifted
and an unshifted stage); ViT-relpos. Their trunk tables are tiny entries
added to both packages' tables (two or three blocks, widths 16-128). Every
parameter is JAX's init plus N(0, 0.05^2) noise, then written and read back
by JAX's own checkpoint functions, so that the tree holds only what a
checkpoint carries (EVA's k bias is zero, the timm trunks' unused ``ln_pre``
at identity) and no LayerNorm, gamma or BatchNorm statistic sits at a value
that would hide a misplaced one.

* image features equal JAX's in float32 at 1e-4 relative to the largest
  feature: both packages run the same float32 arithmetic up to summation
  order (observed below 2e-6), and EVA02's rope takes timm's interleaved
  pairing on timm-layout weights where JAX permutes q/k channels into its
  rotate-half order, the same sum in another order;
* the port's state dict equals JAX's ``params_to_pt_state_dict`` key for key
  and bit for bit (EVA02's q/k channels in timm's order, BatchNorm's running
  statistics), loads with ``strict=True``, and ``jax_params_from_state_dict``
  gives JAX's tree back bit for bit;
* ``decay_mask`` gives JAX's answer on every parameter (Swin's and relpos's
  block matrices undecayed, as JAX's rule counts their list for a stack);
* every config of these families parses in the port to JAX's fields, its
  JSON byte-identical (with the ViT configs in tests/test_torch_vit_family.py);
* the optimizer's checkpoint keys equal JAX's ``flatten_opt_state``, the
  lists of ResNet's, Swin's and relpos's stages and blocks included;
* ``load_clip_pt`` resizes a timm trunk's ``pos_embed`` as JAX does, skips
  ``num_batches_tracked``, and loads a Swin checkpoint whose index buffers
  timm keeps.
"""
import dataclasses
import json
import struct

import jax
import numpy as np
import optax
import pytest
import torch

from latteclip_tpu.core import checkpoint as jax_ckpt
from latteclip_tpu.core import config as jax_config
from latteclip_tpu.models import clip as jax_clip
from latteclip_tpu.models import convnext as jax_convnext
from latteclip_tpu.models import swin as jax_swin
from latteclip_tpu.models import vit_relpos as jax_relpos
from latteclip_tpu.train import optim as jax_optim
from latteclip_torch import checkpoint as torch_ckpt
from latteclip_torch import config as torch_config
from latteclip_torch.models import clip as torch_clip
from latteclip_torch.train import optim as torch_optim

torch.set_num_threads(1)
REL_TOL = 1e-4

TINY_TRUNKS = {  # (JAX table, port table, name, entry)
    "eva02_b": ("EVA02_TRUNKS", "eva02_tiny_b", dict(
        patch_size=16, width=128, layers=2, head_width=64, swiglu_hidden=256,
        ref_feat_shape=16)),
    "eva02_l": ("EVA02_TRUNKS", "eva02_tiny_l", dict(
        patch_size=16, width=128, layers=2, head_width=64, swiglu_hidden=200,
        ref_feat_shape=16, qkv_fused=False)),
    "eva02_e": ("EVA02_TRUNKS", "eva02_tiny_e", dict(
        patch_size=16, width=128, layers=2, head_width=32, swiglu_hidden=256, swiglu=False,
        use_rope=False, inner_attn_norm=False, post_norm=True)),
    "eva01": ("EVA_TRUNKS", "eva_tiny_g", dict(
        width=128, layers=2, head_width=32, mlp_ratio=2.5, patch_size=16)),
    "vit_gap": ("TIMM_VIT_TRUNKS", "vit_tiny_gap", dict(
        width=128, layers=2, head_width=64, mlp_ratio=4.0, patch_size=16, no_cls_token=True,
        pool_type="avg", final_ln_after_pool=True, no_ln_pre=True, ln_eps=1e-6)),
    "convnext": ("CONVNEXT_TRUNKS", "convnext_tinytest", ((1, 2), (16, 32))),
    "swin": ("SWIN_TRUNKS", "swin_tinytest", dict(
        embed_dim=16, depths=(2, 2), heads=(2, 4), window=7, patch_size=4, mlp_ratio=4.0)),
    "relpos": ("RELPOS_TRUNKS", "vit_relpos_tinytest", dict(
        width=64, layers=2, heads=2, patch_size=16, mlp_ratio=4.0, rel_pos_hidden=16,
        init_values=1e-6)),
}
_JAX_TABLES = {"EVA02_TRUNKS": jax_config, "EVA_TRUNKS": jax_config,
               "TIMM_VIT_TRUNKS": jax_config, "CONVNEXT_TRUNKS": jax_convnext,
               "SWIN_TRUNKS": jax_swin, "RELPOS_TRUNKS": jax_relpos}
TEXT = {"context_length": 16, "vocab_size": 500, "width": 64, "heads": 1, "layers": 1}


def _raw(vision, size, **top):
    return {"embed_dim": 32, "compute_dtype": "float32",
            "vision_cfg": {"image_size": size, **vision}, "text_cfg": TEXT, **top}


TOWERS = {
    "eva02_b": _raw({"timm_model_name": "eva02_tiny_b"}, 48),
    "eva02_l": _raw({"timm_model_name": "eva02_tiny_l"}, 48),
    "eva02_e": _raw({"timm_model_name": "eva02_tiny_e"}, 48),
    "eva01": _raw({"timm_model_name": "eva_tiny_g"}, 48),
    "vit_gap": _raw({"timm_model_name": "vit_tiny_gap"}, 48),
    "resnet": _raw({"layers": [1, 2, 1, 1], "width": 8}, 64),
    "convnext": _raw({"timm_model_name": "convnext_tinytest", "timm_proj": "linear"}, 32),
    "convnext_mlp": _raw({"timm_model_name": "convnext_tinytest", "timm_proj": "mlp"}, 32),
    "swin": _raw({"timm_model_name": "swin_tinytest"}, 56),
    "relpos": _raw({"timm_model_name": "vit_relpos_tinytest"}, 48),
}
FAMILY_PREFIXES = ("RN", "convnext_", "EVA", "swin_", "vit_relpos_", "vit_medium_")


def register_tiny_trunks(monkeypatch):
    """Add the tiny trunk entries to both packages' tables."""
    for table, name, entry in TINY_TRUNKS.values():
        monkeypatch.setitem(getattr(_JAX_TABLES[table], table), name, entry)
        monkeypatch.setitem(getattr(torch_config, table), name, entry)


@pytest.fixture
def tiny_trunks(monkeypatch):
    register_tiny_trunks(monkeypatch)


def canonical_params(jcfg, seed=0):
    """JAX's init plus N(0, 0.05^2), through JAX's writer and reader."""
    params = jax_clip.init_clip_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32) + np.float32(0.05)
                          * rng.standard_normal(np.shape(a)).astype(np.float32), params)
    sd = jax_ckpt.params_to_pt_state_dict(params, jcfg)
    return jax.tree.map(np.asarray, jax_ckpt.pt_state_dict_to_params(sd, jcfg)[0])


def shared(name, raw=None, seed=0):
    """(JAX config, JAX params, port config, port model) on the same weights."""
    raw = raw or TOWERS[name]
    jcfg, tcfg = jax_config.config_from_dict(name, raw), torch_config.config_from_dict(name, raw)
    params = canonical_params(jcfg, seed)
    model = torch_clip.CLIP(tcfg)
    model.load_state_dict(torch_ckpt.state_dict_from_jax_params(params, tcfg), strict=True)
    return jcfg, params, tcfg, model


@pytest.mark.parametrize("name", list(TOWERS))
def test_image_features_match_jax(name, tiny_trunks):
    jcfg, params, _, model = shared(name)
    size = TOWERS[name]["vision_cfg"]["image_size"]
    x = np.random.default_rng(1).standard_normal((3, size, size, 3)).astype(np.float32)
    ref = np.asarray(jax_clip.encode_image(params, jcfg, x))
    with torch.no_grad():
        ours = torch_clip.encode_image(model, torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (3, 32)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=REL_TOL * np.abs(ref).max())


@pytest.mark.parametrize("name", list(TOWERS))
def test_state_dict_equals_jax_writer_and_round_trips(name, tiny_trunks):
    jcfg, params, tcfg, model = shared(name)
    ours = torch_ckpt.state_dict_from_jax_params(params, tcfg)
    ref = jax_ckpt.params_to_pt_state_dict(params, jcfg)
    assert sorted(ours) == sorted(ref) == sorted(model.state_dict())
    for k, v in ref.items():
        assert ours[k].dtype == torch.float32 and tuple(ours[k].shape) == np.shape(v), k
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v, np.float32), err_msg=k)
    back = torch_ckpt.jax_params_from_state_dict(model.state_dict(), tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(params)[0], jax.tree.leaves(back)):
        np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(path))


def test_resnet_statistics_are_buffers(tiny_trunks):
    *_, model = shared("resnet")
    buffers = {n for n, _ in model.named_buffers()}
    params = {n for n, _ in model.named_parameters()}
    stats = {k for k in model.state_dict() if k.endswith(("running_mean", "running_var"))}
    assert stats and stats <= buffers and not stats & params
    assert not any(k.endswith("num_batches_tracked") for k in model.state_dict())


@pytest.mark.parametrize("name", list(TOWERS))
def test_decay_mask_equals_jax(name, tiny_trunks):
    _, params, tcfg, model = shared(name)
    mask = torch_optim.decay_mask(model)
    as_arrays = {n: torch.full(b.shape, 0.0) for n, b in model.state_dict().items()}
    as_arrays.update({n: torch.full(p.shape, float(mask[n])) for n, p in model.named_parameters()})
    ours = torch_ckpt.jax_params_from_state_dict(as_arrays, tcfg)
    ref = jax_optim.decay_mask(params)
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                                 jax.tree.leaves(ours)):
        key = jax.tree_util.keystr(path)
        if "ln_pre" in key:  # a timm trunk has none; the reader fills identity values
            continue
        assert np.all(got == float(want)), key


def test_swin_and_relpos_blocks_are_not_decayed(tiny_trunks):
    """JAX's rule counts the list under ``blocks`` for a stack on a layer
    axis, so no matrix of a Swin or relpos block decays there; the port
    keeps that set (the merge and patch matrices do decay)."""
    for name, block in (("swin", "visual.trunk.layers.0.blocks.1.attn.qkv.weight"),
                        ("relpos", "visual.trunk.blocks.0.mlp.fc1.weight")):
        mask = torch_optim.decay_mask(shared(name)[3])
        assert not mask[block] and mask["visual.trunk.patch_embed.proj.weight"]
    assert torch_optim.decay_mask(shared("swin")[3])["visual.trunk.layers.1.downsample.reduction.weight"]
    assert torch_optim.decay_mask(shared("eva02_b")[3])["visual.trunk.blocks.0.attn.qkv.weight"]


TOWER_CONFIGS = sorted(n for n in torch_config.list_models() if n.startswith(FAMILY_PREFIXES))


def test_every_family_config_is_ported():
    jax_names = {n for n in jax_config.list_models() if n.startswith(FAMILY_PREFIXES)}
    assert set(TOWER_CONFIGS) == jax_names and len(jax_names) == 28


def _jax_visual_writer(v):
    """JAX's ``params_to_pt_state_dict`` branch for the vision tower ``v``."""
    if isinstance(v, jax_config.VisionConfig):
        return (jax_ckpt._eva_visual_to_sd if v.timm_trunk.startswith("eva")
                else jax_ckpt._timm_vit_visual_to_sd)
    return {jax_config.ResNetVisionConfig: jax_ckpt._resnet_visual_to_sd,
            jax_config.ConvNeXtVisionConfig: jax_ckpt._convnext_visual_to_sd,
            jax_config.Eva02VisionConfig: jax_ckpt._eva02_visual_to_sd,
            jax_config.SwinVisionConfig: jax_ckpt._swin_visual_to_sd,
            jax_config.RelPosVisionConfig: jax_ckpt._relpos_visual_to_sd}[type(v)]


@pytest.mark.parametrize("name", TOWER_CONFIGS)
def test_tower_config_builds_the_jax_shapes(name, monkeypatch):
    """A model of every family config at its full widths (on the meta
    device): the vision tower's keys and shapes are those JAX's writer
    gives its init. Towers of more than 2e8 parameters (EVA02-L/E, EVA01-g,
    the larger ConvNeXts and ResNets) are held at a depth of at most two
    blocks a stage, so that the writer's arrays stay small. JAX's ConvNeXt
    and ResNet inits draw more keys than they split past 16 ConvNeXt blocks
    or 38 bottlenecks (no ConvNeXt config, nor RN50x16 or RN50x64, can be
    seeded in JAX), so for those two families the JAX tree is its reader's
    on zeros of the port's shapes."""
    jcfg, tcfg = jax_config.get_model_config(name), torch_config.get_model_config(name)
    with torch.device("meta"):
        big = sum(p.numel() for p in torch_clip.CLIP(tcfg).visual.parameters()) > 2e8
    if big:
        v = jcfg.vision
        if isinstance(v, jax_config.ConvNeXtVisionConfig):
            cut = (tuple(min(d, 2) for d in v.depths), v.dims)
            monkeypatch.setitem(jax_convnext.CONVNEXT_TRUNKS, v.trunk, cut)
            monkeypatch.setitem(torch_config.CONVNEXT_TRUNKS, v.trunk, cut)
        else:
            layers = tuple(min(n, 2) for n in v.layers) if isinstance(v.layers, tuple) else 2
            jcfg = dataclasses.replace(jcfg, vision=dataclasses.replace(v, layers=layers))
            tcfg = dataclasses.replace(tcfg, vision=dataclasses.replace(tcfg.vision, layers=layers))
    with torch.device("meta"):
        model = torch_clip.CLIP(tcfg)
    ours = {k: tuple(v.shape) for k, v in model.state_dict().items() if k.startswith("visual.")}
    readers = {jax_config.ConvNeXtVisionConfig: jax_ckpt._convnext_visual_from_sd,
               jax_config.ResNetVisionConfig: jax_ckpt._resnet_visual_from_sd}
    if type(jcfg.vision) in readers:
        visual = readers[type(jcfg.vision)](
            {k: np.zeros(v, np.float32) for k, v in ours.items()}, jcfg.vision)
    else:
        shapes = jax.eval_shape(lambda: jax_clip.init_clip_params(jax.random.PRNGKey(0), jcfg))
        visual = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["visual"])
    theirs = {k: np.shape(v) for k, v in _jax_visual_writer(jcfg.vision)(visual, jcfg.vision).items()}
    assert ours == theirs


@pytest.mark.parametrize("name", ["resnet", "swin", "relpos", "eva02_l"])
def test_optimizer_keys_equal_jax(name, tiny_trunks):
    """``optimizer_state`` writes JAX's ``flatten_opt_state`` keys, the
    lists of stages and blocks indexed as ``keystr`` spells them, and reads
    its own back."""
    jcfg, params, tcfg, model = shared(name)
    tx = jax_optim.make_optimizer(optax.constant_schedule(1e-3))
    ref = jax_ckpt.flatten_opt_state(tx.init(jax.tree.map(np.asarray, params)))
    opt = torch_optim.make_optimizer(model, torch_optim.make_schedule("const", 1e-3, 0))
    ours = torch_ckpt.optimizer_state(model, opt)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert tuple(ours[k].shape) == np.shape(v), k
    ours = {k: v + 0.5 if k.endswith("]") else v for k, v in ours.items()}
    torch_ckpt.restore_optimizer_state(model, opt, ours)
    for p in model.parameters():
        assert torch.all(opt.state[p]["exp_avg"] == 0.5)


def _write_safetensors(path, sd):
    header, blobs, offset = {}, [], 0
    for k, v in sd.items():
        blob = np.ascontiguousarray(np.asarray(v, np.float32)).tobytes()
        header[k] = {"dtype": "F32", "shape": list(np.shape(v)),
                     "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    head = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(head)) + head + b"".join(blobs))


@pytest.mark.parametrize("name", ["eva02_b", "vit_gap", "resnet", "swin"])
def test_load_clip_pt_matches_jax(name, tiny_trunks, tmp_path):
    """Both packages' ``load_clip_pt`` on one ``.safetensors`` file give the
    same parameters: a timm trunk's ``pos_embed`` resized to 64 px, the
    ResNet's ``num_batches_tracked`` and Swin's index buffers (written as
    OpenCLIP and timm write them) skipped."""
    jcfg, params, _, _ = shared(name)
    sd = dict(jax_ckpt.params_to_pt_state_dict(params, jcfg))
    if name == "resnet":
        sd["visual.bn1.num_batches_tracked"] = np.zeros((), np.float32)
    if name == "swin":
        sd["visual.trunk.layers.0.blocks.0.attn.relative_position_index"] = np.zeros(
            (49, 49), np.float32)
    path = tmp_path / "w.safetensors"
    _write_safetensors(path, sd)
    raw = TOWERS[name]
    if name in ("eva02_b", "vit_gap"):
        raw = dict(raw, vision_cfg=dict(raw["vision_cfg"], image_size=64))
    jcfg2 = jax_config.config_from_dict(name, raw)
    theirs = jax_ckpt.params_to_pt_state_dict(
        jax.tree.map(np.asarray, jax_ckpt.load_clip_pt(str(path), jcfg2)[0]), jcfg2)
    model = torch_ckpt.load_clip_pt(str(path), torch_config.config_from_dict(name, raw),
                                    device="cpu")[0]
    ours = model.state_dict()
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(v), rtol=0, atol=1e-5, err_msg=k)


def test_config_fields_equal_jax_for_tiny_towers(tiny_trunks):
    for name, raw in TOWERS.items():
        j, t = jax_config.config_from_dict(name, raw), torch_config.config_from_dict(name, raw)
        assert type(t.vision).__name__ == type(j.vision).__name__
        jd, td = dataclasses.asdict(j.vision), dataclasses.asdict(t.vision)
        assert {k: jd[k] for k in td} == td


@pytest.mark.parametrize("name", ["eva02_b", "convnext", "swin", "relpos"])
def test_remat_equals_no_remat(name, tiny_trunks):
    """``remat`` recomputes each block in the backward: the same features
    and the same gradients as without it."""
    *_, model = shared(name)
    size = TOWERS[name]["vision_cfg"]["image_size"]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, size, size, 3))
                         .astype(np.float32))
    target = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 32)).astype(np.float32))
    out = {}
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        f = torch_clip.encode_image(model, x, remat=remat)
        (f * target).sum().backward()
        out[remat] = (f.detach(), [p.grad.clone() for p in model.visual.parameters()])
    np.testing.assert_array_equal(out[True][0].numpy(), out[False][0].numpy())
    for a, b in zip(out[True][1], out[False][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


class _Archive(torch.nn.Module):
    """A scriptable module holding a state dict under its own names."""

    def __init__(self, sd):
        super().__init__()
        for key, value in sd.items():
            node = self
            *path, leaf = key.split(".")
            for part in path:
                if not hasattr(node, part):
                    node.add_module(part, torch.nn.Module())
                node = getattr(node, part)
            node.register_buffer(leaf, value.clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def test_load_clip_pt_reads_a_torchscript_archive(tiny_trunks, tmp_path):
    """An OpenAI-style TorchScript archive (what the registry's ``openai``
    RN50 file is) loads in both packages to the same parameters."""
    jcfg, params, tcfg, model = shared("resnet")
    path = str(tmp_path / "rn.pt")
    torch.jit.save(torch.jit.script(_Archive(model.state_dict())), path)
    ours = torch_ckpt.load_clip_pt(path, tcfg, device="cpu")[0].state_dict()
    theirs = jax_ckpt.params_to_pt_state_dict(
        jax.tree.map(np.asarray, jax_ckpt.load_clip_pt(path, jcfg)[0]), jcfg)
    assert sorted(ours) == sorted(theirs) == sorted(model.state_dict())
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)

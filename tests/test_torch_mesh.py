"""The port's data and tensor parallelism (latteclip_torch.mesh) against the
JAX package's mesh and against the port's own one-process step, on the
CPU: the port's ranks are gloo processes spawned by
``latteclip_torch.tools.multihost_smoke.launch`` (their programs in
``test_torch_mesh_ranks.py``, which imports no JAX; each launch joins its
ranks with a timeout of 120 s and kills them on failure), the JAX side runs
on conftest's 8 virtual devices. Float32 in both packages, from JAX's
seeded parameters, bank and template table, augment off, AdamW at a
constant 1e-4, a global batch of 16:

* two ranks of 8 against one process on the 16, for the v2 step (captions
  padded and packed), v1 and FLYP (InfoNCE and the SigLIP loss): loss
  within 1e-5 relative, every gradient at cosine >= 0.99999 and within
  1e-4 relative, the bank within 1e-5; the ranks bit-equal to each other
  (loss, every gradient, parameter and bank row);
* the v2 step on two ranks against JAX's 8-device data mesh
  (``make_sharded_train_step``): JAX's own tolerances of
  tests/test_sharding.py:62-95 (loss 1e-3, bank 1e-4, logit scale 1e-5),
  and every parameter after the step within 2e-4 (two learning rates);
* four ranks as a 2 x 2 data x model mesh: the same one-process bounds
  for the v2 step (padded, packed, and padded with ``--grad-clip-norm``
  below the gradient's norm: the norm over shards) and FLYP, and the v2 step against JAX's
  (4, 2) mesh (tests/test_sharding.py:102-140: loss 5e-3, bank 1e-3,
  ``c_proj_w`` 2e-4), the port's MLP leaves and their moments half-width
  as JAX's shards;
* FLYP on CoCaLoss (coca_tiny-test) on two ranks against one process, at
  the one-process bounds above;
* ``tp_leaf_dims`` names the leaves ``train_state_shardings`` shards;
* ``siglip_ring_loss`` on four ranks against JAX's ``shard_map`` ring on
  four devices (tests/test_objectives.py:30-66): the value within 1e-5
  relative, and the gradients, divided by the data size (the port's
  collectives leave a rank W times its share, module docstring of
  latteclip_torch.mesh), within 1e-5;
* what JAX's multi-host packed path computes: host-local ``cap_eot_row``
  indexing the concatenated rows pools host 1's captions from host 0's
  rows, while the port packs and pools per rank (ROADMAP.md, section 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from latteclip_tpu.core import config as jax_config
from latteclip_tpu.core import mesh as jax_mesh
from latteclip_tpu.data import packing as jax_packing
from latteclip_tpu.models import clip as jax_clip
from latteclip_tpu.models.tokenizer import get_tokenizer as jax_get_tokenizer
from latteclip_tpu.train import objective as jax_objective
from latteclip_tpu.train import optim as jax_optim
from latteclip_tpu.train import state as jax_state
from latteclip_tpu.train import step as jax_step
from latteclip_torch import config as torch_config
from latteclip_torch import mesh as mesh_mod
from latteclip_torch.checkpoint import state_dict_from_jax_params
from latteclip_torch.models import clip as torch_clip
from latteclip_torch.models.tokenizer import get_tokenizer_for_config
from latteclip_torch.tools.multihost_smoke import launch
from latteclip_torch.train import objective
from latteclip_torch.train import state as torch_state

import test_torch_mesh_ranks as R

B = 16


def _jax_start():
    jcfg = dataclasses.replace(jax_config.config_from_dict("tiny", R.TINY),
                               compute_dtype="float32")
    params = jax_clip.init_clip_params(jax.random.PRNGKey(0), jcfg)
    tok = jax_get_tokenizer()
    bank = np.asarray(jax_state.init_memory_bank(params, jcfg, tok, R.CLASSES, R.TEMPLATES))
    table = jax_state.build_template_table(tok, R.CLASSES, R.TEMPLATES)
    return jcfg, params, bank, table


def _jax_mesh_step(jcfg, params, bank, table, batch, model_parallelism):
    opt = jax_optim.make_optimizer(jax_optim.make_schedule("const", R.LR, warmup=1))
    st = jax_state.create_train_state(params, opt, bank)
    fn = jax_step.make_train_step(jcfg, opt, jax_step.LatteHParams(augment=False), table)
    mesh = jax_mesh.make_mesh(model_parallelism=model_parallelism)
    sharded = jax_mesh.make_sharded_train_step(fn, mesh, st)
    placed = jax_mesh.shard_train_state(st, mesh)
    fc_shape = placed.params["text"]["blocks"]["c_fc_w"].addressable_shards[0].data.shape
    jbatch = {k: v for k, v in batch.items() if k != "gt_labels"}
    out, metrics = sharded(placed, jax_mesh.shard_batch(jbatch, mesh), jax.random.PRNGKey(0))
    return out, metrics, fc_shape


TRAINERS = ("ours_padded", "ours_packed", "v1", "flyp", "flyp_siglip")
TP_TRAINERS = ("ours_padded", "ours_packed", "flyp", "ours_clip")


@pytest.fixture(scope="module")
def start():
    """JAX's config and parameters (numpy: the mesh step donates what it is
    given) and the port's start spec from them."""
    jcfg, params, bank, table = _jax_start()
    params = jax.tree.map(np.array, params)
    tcfg = R.tiny_config()
    sd = {k: v.numpy() for k, v in state_dict_from_jax_params(params, tcfg).items()}
    return jcfg, params, {"cfg": tcfg, "sd": sd, "bank": bank, "table": table}


def _runs(start, trainers, world, tp):
    """{trainer: (ranks, one process)} and JAX's mesh step on the v2 padded
    step: (state, metrics, local c_fc shape)."""
    jcfg, params, base = start
    specs = [{**base, "trainer": t, "batch": R.global_batch(B)} for t in trainers]
    ranks = launch(R.step_rank, world, specs, tp)
    runs = {t: ([r[i] for r in ranks], R.one_process(spec)) for i, (t, spec) in
            enumerate(zip(trainers, specs))}
    jax_out = _jax_mesh_step(jcfg, jax.tree.map(jnp.array, params), base["bank"].copy(),
                             base["table"], specs[0]["batch"], tp)
    return runs, jax_out


@pytest.fixture(scope="module")
def dp_runs(start):
    return _runs(start, TRAINERS, 2, 1)


@pytest.fixture(scope="module")
def tp_runs(start):
    return _runs(start, TP_TRAINERS, 4, 2)


@pytest.mark.parametrize("trainer", TRAINERS)
def test_dp_step_equals_one_process_on_the_global_batch(dp_runs, trainer):
    ranks, ref = dp_runs[0][trainer]
    R.assert_matches_one_process(ranks[0], ref)
    assert [r["mesh"] for r in ranks] == [(0, 0, 2), (1, 0, 2)]


@pytest.mark.parametrize("trainer", TRAINERS)
def test_dp_ranks_are_bit_equal(dp_runs, trainer):
    ranks, ref = dp_runs[0][trainer]
    R.assert_ranks_bit_equal(ranks)
    if trainer.startswith("flyp"):   # FLYP carries the bank; v2 and v1 move it
        assert np.array_equal(ranks[0]["bank"], ref["bank"])


@pytest.mark.parametrize("trainer", TP_TRAINERS)
def test_dp_tp_mesh_equals_one_process(tp_runs, trainer):
    ranks, ref = tp_runs[0][trainer]
    assert [r["mesh"] for r in ranks] == [(0, 0, 2), (0, 1, 2), (1, 0, 2), (1, 1, 2)]
    R.assert_matches_one_process(ranks[0], ref)
    R.assert_ranks_bit_equal(ranks)
    if trainer == "ours_clip":   # the clip ran: the global norm is the bound
        norm = np.sqrt(sum(float(np.square(g.astype(np.float64)).sum())
                           for g in ranks[0]["grads"].values()))
        assert norm == pytest.approx(R.CLIP_NORM, rel=1e-4)


def test_tp_shards_half_the_mlp_leaves_and_their_moments(tp_runs):
    ranks, ref = tp_runs[0]["ours_padded"]
    r = ranks[0]
    blocks = [n for n in ref["params"] if n.endswith("mlp.c_fc.weight")]
    assert len(blocks) == 4   # two vision and two text blocks
    assert len(r["tp_dims"]) == 3 * len(blocks)
    for name, dim in r["tp_dims"].items():
        full = ref["params"][name].shape
        want = tuple(s // 2 if d == dim else s for d, s in enumerate(full))
        assert r["local_shapes"][name] == want == r["moment_shapes"][name], name
        assert dim == (1 if name.endswith("c_proj.weight") else 0)


def test_coca_flyp_dp_equals_one_process():
    """FLYP on CoCaLoss across two ranks: the contrastive loss on gathered
    features and the caption loss over the global batch's tokens."""
    cfg = dataclasses.replace(torch_config.get_model_config("coca_tiny-test"),
                              compute_dtype="float32")
    model = torch_clip.init_clip_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tok = get_tokenizer_for_config(cfg)
    spec = {"cfg": cfg, "sd": {k: v.numpy() for k, v in model.state_dict().items()},
            "bank": torch_state.init_memory_bank(model, tok, R.CLASSES, R.TEMPLATES).numpy(),
            "table": torch_state.build_template_table(tok, R.CLASSES, R.TEMPLATES),
            "trainer": "coca_flyp", "batch": R.global_batch(8, size=cfg.vision.image_size)}
    ranks = [r[0] for r in launch(R.step_rank, 2, [spec])]
    R.assert_matches_one_process(ranks[0], R.one_process(spec))
    R.assert_ranks_bit_equal(ranks)
    assert any(n.startswith("text_decoder.") and np.abs(g).max() > 0
               for n, g in ranks[0]["grads"].items())


def _port_params(jstate, cfg):
    return state_dict_from_jax_params(jax.tree.map(np.asarray, jstate.params), cfg)


def test_dp_step_matches_jax_data_mesh(dp_runs):
    ranks = dp_runs[0]["ours_padded"][0]
    jstate, jm, _ = dp_runs[1]
    R.assert_ranks_bit_equal(ranks)
    ours = ranks[0]
    assert abs(ours["loss"] - float(jm["loss"])) < 1e-3
    np.testing.assert_allclose(ours["bank"], np.asarray(jstate.memory_bank), atol=1e-4)
    ref = _port_params(jstate, R.tiny_config())
    np.testing.assert_allclose(ours["params"]["logit_scale"], ref["logit_scale"].numpy(),
                               atol=1e-5)
    for name, p in ref.items():
        np.testing.assert_allclose(ours["params"][name], p.numpy(), atol=2 * R.LR, rtol=0,
                                   err_msg=name)


def test_tp_step_matches_jax_data_model_mesh(tp_runs):
    ranks = tp_runs[0]["ours_padded"][0]
    jstate, jm, jax_fc_shape = tp_runs[1]
    R.assert_ranks_bit_equal(ranks)
    ours = ranks[0]
    assert abs(ours["loss"] - float(jm["loss"])) < 5e-3
    np.testing.assert_allclose(ours["bank"], np.asarray(jstate.memory_bank), atol=1e-3)
    ref = _port_params(jstate, R.tiny_config())
    for name, p in ref.items():
        if name.endswith("mlp.c_proj.weight"):
            np.testing.assert_allclose(ours["params"][name], p.numpy(), rtol=0, atol=2 * R.LR)
    # JAX's text c_fc_w [L, D, 4D] holds [L, D, 2D] a device; the port's
    # text c_fc.weight [4D, D] holds [2D, D] a rank, its moments alike
    name = "transformer.resblocks.0.mlp.c_fc.weight"
    assert ours["local_shapes"][name] == ours["moment_shapes"][name] == (jax_fc_shape[-1],
                                                                         jax_fc_shape[1])


def test_tp_leaf_dims_name_jax_sharded_leaves():
    jcfg, params, bank, _ = _jax_start()
    opt = jax_optim.make_optimizer(jax_optim.make_schedule("const", R.LR, warmup=1))
    shardings = jax_mesh.train_state_shardings(jax_state.create_train_state(params, opt, bank),
                                               jax_mesh.make_mesh(model_parallelism=2))
    jax_split = {}
    for tower, prefix in (("visual", "visual.transformer."), ("text", "transformer.")):
        for leaf, suffix in (("c_fc_w", "c_fc.weight"), ("c_fc_b", "c_fc.bias"),
                             ("c_proj_w", "c_proj.weight"), ("c_proj_b", "c_proj.bias")):
            spec = shardings.params[tower]["blocks"][leaf].spec
            for i in range(2):
                if spec != P():
                    jax_split[f"{prefix}resblocks.{i}.mlp.{suffix}"] = spec
    model = torch_clip.CLIP(R.tiny_config())
    dims = mesh_mod.tp_leaf_dims(model, 2)
    assert sorted(dims) == sorted(jax_split)
    for name, dim in dims.items():
        # torch keeps [out, in]: JAX's hidden axis is the port's dim 0 for
        # c_fc (weight and bias) and dim 1 for c_proj's weight
        assert dim == (1 if "c_proj" in name else 0)
    assert mesh_mod.tp_leaf_dims(model, 1) == {}
    assert mesh_mod.tp_leaf_dims(model, 3) == {}   # 256 hidden: 3 does not divide it


def _feats(n, d, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_siglip_ring_matches_jax_shard_map():
    world = 4
    img, txt = _feats(16, 8, 0), _feats(16, 8, 1)
    scale, bias = 5.0, -2.0
    ranks = launch(R.ring_rank, world, img, txt, scale, bias)
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    ring = shard_map(lambda i, t: jax_objective.siglip_ring_loss(i, t, jnp.float32(scale),
                                                                 jnp.float32(bias), "data"),
                     mesh=mesh, in_specs=(P("data"), P("data")), out_specs=P())
    loss = float(jax.jit(ring)(img, txt))
    g_img, g_txt = jax.jit(jax.grad(ring, argnums=(0, 1)))(img, txt)
    full = float(objective.siglip_full_loss(torch.tensor(img), torch.tensor(txt),
                                            torch.tensor(scale), torch.tensor(bias)))
    n = len(img) // world
    for r, (ours, gi, gt) in enumerate(ranks):
        assert ours == pytest.approx(loss, rel=1e-5)
        assert ours == pytest.approx(full, rel=1e-5)
        np.testing.assert_allclose(gi / world, np.asarray(g_img)[r * n:(r + 1) * n], atol=1e-5)
        np.testing.assert_allclose(gt / world, np.asarray(g_txt)[r * n:(r + 1) * n], atol=1e-5)


def test_jax_multihost_packed_path_pools_from_host_zero_rows():
    """Two hosts each pack their own captions; JAX's multi-host step sees the
    concatenated arrays with host-local ``cap_eot_row``. Its pooled
    features for host 1 are then read from host 0's rows (and
    ``caption_feats[:B]`` with the global B takes host 0's two streams),
    so they differ from host 1's own packed encode, which the port's
    per-rank pooling equals."""
    jcfg, params, _, _ = _jax_start()
    batch = R.global_batch(8)
    packs = []
    for h in range(2):
        img = batch["per_image_tokens"][h * 4:(h + 1) * 4]
        grp = batch["per_group_tokens"][h * 4:(h + 1) * 4]
        lengths = jax_packing.token_lengths(np.concatenate([img, grp]))
        rows = -(-jax_packing.pack_rows_needed(lengths, 128) // 8) * 8
        packs.append(jax_packing.pack_caption_batch(img, grp, 128, rows))
    keys = ("cap_tokens", "cap_positions", "cap_seg_ids", "cap_eot_row", "cap_eot_col")
    per_host = [np.asarray(jax_clip.encode_text_packed(params, jcfg, *(p[k] for k in keys),
                                                       normalize=True)) for p in packs]
    glob = np.asarray(jax_clip.encode_text_packed(
        params, jcfg, *(np.concatenate([p[k] for p in packs]) for k in keys), normalize=True))
    np.testing.assert_allclose(glob[:8], per_host[0], atol=1e-5)   # host 0's rows: right
    assert np.abs(glob[8:] - per_host[1]).max() > 1e-2              # host 1's: not its own
    padded = [np.asarray(jax_clip.encode_text(params, jcfg, np.concatenate(
        [batch["per_image_tokens"][h * 4:(h + 1) * 4], batch["per_group_tokens"][h * 4:(h + 1) * 4]]),
        normalize=True)) for h in range(2)]
    np.testing.assert_allclose(per_host[1], padded[1], atol=1e-5)
    # the step's caption_feats[:B] with the global B = 8: host 0's image
    # and group captions, where the global batch's image captions are
    # host 0's and host 1's image streams
    np.testing.assert_allclose(glob[:8][4:], per_host[0][4:], atol=1e-5)
    assert np.abs(glob[:8][4:] - padded[1][:4]).max() > 1e-2

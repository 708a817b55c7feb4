"""The rank programs of the port's data- and tensor-parallel tests, and the
tests that need no JAX. The ranks that
``latteclip_torch.tools.multihost_smoke.launch`` spawns import this file,
so it imports no JAX (about 3 s a rank instead of 7);
``test_torch_mesh.py`` runs them against the JAX package and the port's
one-process step, ``test_torch_cli.py`` runs the CLI on them.

Here: the gather's gradient scale (a loss on gathered features leaves each
rank W times its share of the weight gradient and the whole gradient of a
parameter used after the gather, and the mean over ranks gives the
one-process gradient), and ``initialize_distributed`` outside torchrun.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from latteclip_torch import config as torch_config
from latteclip_torch import mesh as mesh_mod
from latteclip_torch.data.packing import pack_caption_batch, pack_rows_needed, token_lengths
from latteclip_torch.data.packing import pack_template_table
from latteclip_torch.models import clip as torch_clip
from latteclip_torch.models.tokenizer import get_tokenizer
from latteclip_torch.tools.multihost_smoke import launch
from latteclip_torch.train import objective, optim, state, step

TINY = {   # tests/test_sharding.py's config
    "embed_dim": 32,
    "vision_cfg": {"image_size": 32, "layers": 2, "width": 64, "patch_size": 16},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 64, "heads": 4, "layers": 2},
}
CLASSES = ["banded", "dotted", "striped", "zigzagged"]
TEMPLATES = [lambda c: f"{c} texture."]
LR = 1e-4
CLIP_NORM = 1e-2   # below the tiny model's gradient norm: the clip scales every gradient


def tiny_config(fp32: bool = True):
    cfg = torch_config.config_from_dict("tiny", TINY)
    return dataclasses.replace(cfg, compute_dtype="float32") if fp32 else cfg


def global_batch(n: int = 8, seed: int = 0, size: int = 32) -> dict:
    """tests/test_sharding.py's ``_batch`` (images ``size`` pixels square),
    with EOT-terminated captions (the packer reads their lengths)."""
    rng = np.random.default_rng(seed)
    eot = get_tokenizer().eot_token_id
    batch = {"images": rng.integers(0, 255, size=(n, size, size, 3)).astype(np.uint8)}
    for key in ("per_image_tokens", "per_group_tokens"):
        rows = rng.integers(1, 40000, size=(n, 77)).astype(np.int32)
        lengths = rng.integers(8, 78, n)
        for i, ln in enumerate(lengths):
            rows[i, ln - 1], rows[i, ln:] = eot, 0
        batch[key] = rows
    batch["zs_preds"] = rng.integers(0, 4, size=(n,)).astype(np.int32)
    batch["gt_labels"] = rng.integers(0, 4, size=(n,)).astype(np.int32)
    return batch


def build(spec: dict, dev):
    """(state, step_fn) of ``spec["trainer"]`` from ``spec``'s start."""
    cfg = spec["cfg"]
    model = torch_clip.build_model(cfg)
    if spec["trainer"] == "flyp_siglip":
        torch_clip.add_logit_bias(model, step.DEFAULT_LOGIT_BIAS)
    missing = model.load_state_dict({k: torch.from_numpy(v) for k, v in spec["sd"].items()},
                                    strict=False).missing_keys
    assert missing in ([], ["logit_bias"]), missing
    model = model.to(dev)
    clip = CLIP_NORM if spec["trainer"] == "ours_clip" else None
    opt = optim.make_optimizer(model, optim.make_schedule("const", LR, warmup=1),
                               grad_clip_norm=clip)
    st = state.create_train_state(model, opt, torch.from_numpy(spec["bank"].copy()).to(dev))
    table, trainer = spec["table"], spec["trainer"]
    if trainer.startswith("ours"):   # ours_padded, ours_packed, ours_clip (padded, clipped)
        packed = trainer == "ours_packed"
        hp = step.LatteHParams(augment=False, text_packing=packed)
        fn = step.make_train_step(model, hp, table,
                                  template_packed=pack_template_table(table) if packed else None)
    elif trainer == "v1":
        fn = step.make_v1_step(model, step.LatteHParams(augment=False), table, gamma=0.5)
    elif trainer == "coca_flyp":   # CoCaLoss, the CLI's default weights
        fn = step.make_flyp_step(model, step.LatteHParams(augment=False), table,
                                 coca_weights=(2.0, 1.0))
    else:
        fn = step.make_flyp_step(model, step.LatteHParams(augment=False), table,
                                 use_siglip=trainer == "flyp_siglip")
    return st, fn


def local_batch(batch: dict, trainer: str, index: int, count: int) -> dict:
    """Data rank ``index`` of ``count``'s rows, captions packed for the
    packed v2 step (each rank packs its own)."""
    n = len(batch["zs_preds"]) // count
    out = {k: v[index * n:(index + 1) * n] for k, v in batch.items()}
    if trainer == "ours_packed":
        lengths = token_lengths(np.concatenate([out["per_image_tokens"], out["per_group_tokens"]]))
        rows = -(-pack_rows_needed(lengths, 128) // 8) * 8
        out.update(pack_caption_batch(out["per_image_tokens"], out["per_group_tokens"], 128, rows))
    return out


def one_step(st, fn, batch) -> dict:
    """One step -> loss, every full gradient and parameter after it, the
    bank (numpy), by parameter name."""
    metrics = fn(st, {k: torch.as_tensor(v) for k, v in batch.items()})
    named = list(st.model.named_parameters())
    grads = [p.grad for _, p in named]
    params = [p.data for _, p in named]
    if st.mesh is not None:
        from latteclip_torch.tools.multihost_smoke import full_tensors

        grads, params = full_tensors(st, grads), full_tensors(st, params)
    return {"loss": float(metrics["loss"]),
            "grads": {n: g.detach().float().numpy().copy() for (n, _), g in zip(named, grads)},
            "params": {n: p.float().numpy().copy() for (n, _), p in zip(named, params)},
            "bank": st.memory_bank.numpy().copy()}


def step_rank(rank: int, world: int, dev, specs: list, tp: int = 1) -> list:
    """A rank of the data-parallel (``tp`` = 1) or data x model mesh: one
    step of each spec on its data rank's rows, with the mesh's layout."""
    mesh = mesh_mod.make_mesh(tp)
    out = []
    for spec in specs:
        st, fn = build(spec, dev)
        mesh_mod.shard_train_state(st, mesh)
        res = one_step(st, fn, local_batch(spec["batch"], spec["trainer"], mesh.data_index,
                                           mesh.data_size))
        named = dict(st.model.named_parameters())
        res["local_shapes"] = {n: tuple(named[n].shape) for n in st.tp_dims}
        res["moment_shapes"] = {n: tuple(st.optimizer.state[named[n]]["exp_avg"].shape)
                                for n in st.tp_dims}
        res["tp_dims"] = dict(st.tp_dims)
        res["mesh"] = (mesh.data_index, mesh.model_index, mesh.data_size)
        out.append(res)
    return out


def one_process(spec: dict) -> dict:
    st, fn = build(spec, torch.device("cpu"))
    return one_step(st, fn, local_batch(spec["batch"], spec["trainer"], 0, 1))


def assert_matches_one_process(ours: dict, ref: dict) -> None:
    assert ours["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    for name, g in ref["grads"].items():
        mine = ours["grads"][name].ravel().astype(np.float64)
        theirs = g.ravel().astype(np.float64)
        norm = np.linalg.norm(theirs)
        if norm == 0:
            assert not mine.any(), name
            continue
        cos = mine @ theirs / (np.linalg.norm(mine) * norm)
        assert cos >= 0.99999, (name, cos)
        assert np.linalg.norm(mine - theirs) <= 1e-4 * norm, name
    np.testing.assert_allclose(ours["bank"], ref["bank"], atol=1e-5, rtol=0)


def assert_ranks_bit_equal(ranks: list) -> None:
    first = ranks[0]
    for other in ranks[1:]:
        assert other["loss"] == first["loss"]
        assert np.array_equal(other["bank"], first["bank"])
        for key in ("grads", "params"):
            for name, v in first[key].items():
                assert np.array_equal(other[key][name], v), (key, name)


def gather_rank(rank: int, world: int, dev, x: np.ndarray, w: np.ndarray) -> dict:
    """A linear map and a logit scale, InfoNCE on the gathered features:
    the gradients before and after the mean over ranks."""
    mesh = mesh_mod.make_mesh(1)
    n = len(x) // world
    weight = torch.nn.Parameter(torch.from_numpy(w))
    scale = torch.nn.Parameter(torch.tensor(2.0))
    feats = F.normalize(torch.from_numpy(x[rank * n:(rank + 1) * n]) @ weight, dim=-1)
    half = feats.shape[1] // 2
    gathered = mesh_mod.gather(feats, mesh)
    loss = objective.clip_loss(gathered[:, :half], gathered[:, half:], scale.exp())
    loss.backward()
    raw = [weight.grad.clone(), scale.grad.clone()]
    grads = [weight.grad, scale.grad]
    mesh.sync_gradients(grads, [False, False])
    return {"loss": float(loss), "raw": [g.numpy() for g in raw], "synced": [g.numpy() for g in grads]}


def test_gather_gradient_scale_gives_the_global_gradient():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 12)).astype(np.float32)
    w = rng.normal(size=(12, 16)).astype(np.float32)
    ranks = launch(gather_rank, 2, x, w)
    weight = torch.nn.Parameter(torch.from_numpy(w))
    scale = torch.nn.Parameter(torch.tensor(2.0))
    feats = F.normalize(torch.from_numpy(x) @ weight, dim=-1)
    loss = objective.clip_loss(feats[:, :8], feats[:, 8:], scale.exp())
    loss.backward()
    for r in ranks:
        assert r["loss"] == pytest.approx(float(loss.detach()), rel=1e-6)
        np.testing.assert_allclose(r["synced"][0], weight.grad.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["synced"][1], scale.grad.numpy(), rtol=1e-5)
    # before the mean: the logit scale's gradient is the whole one on each
    # rank, and the ranks' weight gradients sum to twice the whole one
    for r in ranks:
        np.testing.assert_allclose(r["raw"][1], scale.grad.numpy(), rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["raw"][0] + ranks[1]["raw"][0], 2 * weight.grad.numpy(),
                               rtol=1e-4, atol=1e-6)


def ring_rank(rank: int, world: int, dev, img, txt, scale: float, bias: float):
    """``siglip_ring_loss`` on this rank's rows: the loss and its gradients."""
    mesh = mesh_mod.make_mesh(1)
    n = len(img) // world
    i = torch.tensor(img[rank * n:(rank + 1) * n], requires_grad=True)
    t = torch.tensor(txt[rank * n:(rank + 1) * n], requires_grad=True)
    loss = objective.siglip_ring_loss(i, t, torch.tensor(scale), torch.tensor(bias), mesh)
    loss.backward()
    return float(loss.detach()), i.grad.numpy(), t.grad.numpy()


def cli_rank(rank: int, world: int, dev, argv: list) -> int:
    """``latteclip_torch.train.main.main(argv)`` on this rank."""
    from latteclip_torch.train import main as torch_main

    return torch_main.main(argv)


def test_initialize_distributed_without_torchrun_is_one_process(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    assert mesh_mod.initialize_distributed("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.make_mesh(1)
    assert os.environ.get("RANK") is None

"""The port's other trainers (the legacy v1 step, FLYP with its SigLIP and
distillation options) and their objectives against latteclip_tpu's, on a
tiny config in float32 from the same weights, batches and bank, augment off:

* ``distill_clip_loss``, ``siglip_full_loss`` and the sigmoid pair loss
  (``negative_only`` both ways): value and gradients within 1e-6;
* four steps of each trainer with plain SGD, as tests/test_torch_train_step.py
  holds the v2 step and for its reason (SGD keeps the comparison at gradient
  scale): losses within 1e-5, every parameter and the bank within 2e-5. v1
  from a zero bank (the first anchor is the template) and from the template
  bank; FLYP on the pseudo-labels and on the ground truth with one label of
  -1 (the last template's row, as JAX gathers it); FLYP with the SigLIP loss
  and an injected ``logit_bias``; FLYP with a teacher of its own seeded
  weights. v1's text tower stays bit-equal;
* four v1 steps with AdamW: the text tower bit-equal to its start, and the
  optimizer's checkpoint entry (the AdamW moments under the JAX keys and the
  counts) equal to JAX's ``flatten_opt_state``: the text moments exactly
  (zero gradients from zero moments stay 0 in both), the counts exactly and
  the image tower's moments within the bound derived at ``MOMENT_TOL``;
* on the kernel route (``kernel_route`` patched true, wrapper calls counted)
  one step of each trainer launches the table of PERF.md: K1 once a text
  layer for the templates (twice with a teacher), K2 and K4 once a vision
  layer (the pairs; K2 twice with a teacher), K3 once a text layer, and
  none under v1, whose anchor is detached.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from latteclip_tpu.core import checkpoint as jax_ckpt
from latteclip_tpu.core import config as jax_config
from latteclip_tpu.models import clip as jax_clip
from latteclip_tpu.models.tokenizer import get_tokenizer as jax_get_tokenizer
from latteclip_tpu.train import objective as jax_objective
from latteclip_tpu.train import optim as jax_optim
from latteclip_tpu.train import state as jax_state
from latteclip_tpu.train import step as jax_step
from latteclip_torch import config as torch_config
from latteclip_torch import kernels
from latteclip_torch.checkpoint import optimizer_state, state_dict_from_jax_params
from latteclip_torch.kernels import attention as A
from latteclip_torch.models import clip as torch_clip, vit
from latteclip_torch.models.tokenizer import get_tokenizer
from latteclip_torch.train import objective, optim, state, step

torch.set_num_threads(1)

TINY = {
    "embed_dim": 16,
    "vision_cfg": {"image_size": 32, "layers": 2, "width": 64, "patch_size": 16},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 64, "heads": 4, "layers": 2},
}
CLASSES = [f"class {i}" for i in range(6)]
TEMPLATES = [lambda c: f"a photo of a {c}."]
B, STEPS, GAMMA = 8, 4, 0.5
# the image tower's AdamW moments after four steps: both packages feed AdamW
# gradients that differ by float32 summation order (about 1e-6 relative,
# tests/test_torch_train_step.py), and an update of lr = 1e-4 per element
# can take either sign where a normalised gradient element is that close to
# 0, so later gradients differ by at most the effect of a 4e-4 weight
# change, which on this tiny tower moves a gradient element by well under
# 1e-4 of the tensor's largest: the moments are held to 1e-4 of each
# tensor's largest moment. Observed: 4.1e-6 (nu of the visual ln_pre scale).
MOMENT_TOL = 1e-4


def _configs():
    return tuple(dataclasses.replace(c.config_from_dict("tiny", TINY), compute_dtype="float32")
                 for c in (jax_config, torch_config))


def _batches(n):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        gt = rng.integers(0, len(CLASSES), B).astype(np.int32)
        gt[3] = -1   # a sample without ground truth
        out.append({"images": rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8),
                    "zs_preds": rng.integers(0, len(CLASSES), B).astype(np.int32),
                    "gt_labels": gt})
    return out


def _port_model(params, tcfg):
    model = torch_clip.CLIP(tcfg)
    if "logit_bias" in params:
        torch_clip.add_logit_bias(model, float(params["logit_bias"]))
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), tcfg))
    return model


TRAINERS = {
    "v1_zero_bank": dict(kind="v1", zero_bank=True),
    "v1": dict(kind="v1"),
    "flyp": dict(kind="flyp"),
    "flyp_gt": dict(kind="flyp", use_gt=True),
    "flyp_siglip": dict(kind="flyp", use_siglip=True),
    "flyp_teacher": dict(kind="flyp", teacher=True),
}


def _setup(case):
    """Both packages' steps, states and start weights for a ``TRAINERS`` case."""
    spec = TRAINERS[case]
    jcfg, tcfg = _configs()
    params = jax_clip.init_clip_params(jax.random.PRNGKey(0), jcfg)
    if spec.get("use_siglip"):
        params = dict(params, logit_bias=jnp.asarray(step.DEFAULT_LOGIT_BIAS, jnp.float32))
    jtok = jax_get_tokenizer()
    table = jax_state.build_template_table(jtok, CLASSES, TEMPLATES)
    bank = np.asarray(jax_state.init_memory_bank(params, jcfg, jtok, CLASSES, TEMPLATES))
    if spec.get("zero_bank"):
        bank = np.zeros_like(bank)
    teacher = None
    if spec.get("teacher"):
        teacher = (jcfg, jax_clip.init_clip_params(jax.random.PRNGKey(7), jcfg))
    model = _port_model(params, tcfg)
    ttable = state.build_template_table(get_tokenizer(), CLASSES, TEMPLATES)
    np.testing.assert_array_equal(ttable, table)
    hp_j, hp_t = jax_step.LatteHParams(augment=False), step.LatteHParams(augment=False)
    if spec["kind"] == "v1":
        def jmake(tx):
            return jax_step.make_v1_step(jcfg, tx, hp_j, table, gamma=GAMMA)
        tfn = step.make_v1_step(model, hp_t, ttable, gamma=GAMMA)
    else:
        kw = dict(use_gt=spec.get("use_gt", False), use_siglip=spec.get("use_siglip", False))

        def jmake(tx):
            return jax_step.make_flyp_step(jcfg, tx, hp_j, table, teacher=teacher, **kw)
        tteacher = _port_model(teacher[1], tcfg) if teacher else None
        tfn = step.make_flyp_step(model, hp_t, ttable, teacher=tteacher, **kw)
    return params, bank, model, jmake, tfn


def _run(case, jax_tx, make_torch_opt, batches):
    params, bank, model, jmake, tfn = _setup(case)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    jstate = jax_state.create_train_state(params, jax_tx, bank)
    jfn = jax.jit(jmake(jax_tx))
    tstate = state.create_train_state(model, make_torch_opt(model), torch.from_numpy(bank.copy()))
    jl, tl = [], []
    for i in range(STEPS):
        b = batches[i % len(batches)]
        jstate, jm = jfn(jstate, b, jax.random.PRNGKey(i))
        tm = tfn(tstate, b)
        jl.append({k: float(v) for k, v in jm.items()})
        tl.append({k: float(v) for k, v in tm.items()})
    return jstate, tstate, jl, tl, start, torch.from_numpy(bank.copy())


def _assert_text_unchanged(model, start):
    for name, p in model.named_parameters():
        if not name.startswith("visual.") and name != "logit_scale":
            assert torch.equal(p.detach(), start[name]), name


@pytest.mark.parametrize("case", list(TRAINERS))
def test_four_sgd_steps_match_jax(case):
    jstate, tstate, jl, tl, start, bank0 = _run(case, optax.sgd(1e-2),
                                         lambda m: torch.optim.SGD(m.parameters(), lr=1e-2),
                                         _batches(2))
    assert [sorted(m) for m in tl] == [sorted(m) for m in jl]
    for ours, theirs in zip(tl, jl):
        for k in theirs:
            assert ours[k] == pytest.approx(theirs[k], abs=1e-5), k
    assert tstate.step == STEPS
    ref = state_dict_from_jax_params(jax.tree.map(np.asarray, jstate.params), tstate.model.cfg)
    assert sorted(ref) == sorted(n for n, _ in tstate.model.named_parameters())
    for name, p in tstate.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), atol=2e-5, rtol=0,
                                   err_msg=f"param {name} diverged")
    np.testing.assert_allclose(tstate.memory_bank.numpy(), np.asarray(jstate.memory_bank),
                               atol=2e-5, rtol=0)
    moved = {n for n, p in tstate.model.named_parameters() if not torch.equal(p.detach(), start[n])}
    if TRAINERS[case]["kind"] == "v1":
        _assert_text_unchanged(tstate.model, start)
        assert not torch.equal(tstate.memory_bank, bank0)
    else:   # FLYP trains the text tower and carries the bank unchanged
        assert any(not n.startswith("visual.") for n in moved - {"logit_scale"})
        assert torch.equal(tstate.memory_bank, bank0)
    if case == "flyp_siglip":
        assert "logit_bias" in moved


def test_v1_adamw_keeps_text_and_moments_as_jax():
    sched = ("const", 1e-4, 0)
    jstate, tstate, jl, tl, start, _ = _run(
        "v1", jax_optim.make_optimizer(jax_optim.make_schedule(*sched)),
        lambda m: optim.make_optimizer(m, optim.make_schedule(*sched)), _batches(2))
    for ours, theirs in zip(tl, jl):
        assert ours["loss"] == pytest.approx(theirs["loss"], abs=1e-5)
    _assert_text_unchanged(tstate.model, start)
    ours = optimizer_state(tstate.model, tstate.optimizer)
    theirs = jax_ckpt.flatten_opt_state(jstate.opt_state)
    assert sorted(ours) == sorted(theirs)
    for key, ref in theirs.items():
        got = ours[key].numpy()
        if key.endswith("count"):
            assert int(got) == int(ref) == STEPS, key
        elif "['text']" in key:
            assert np.array_equal(got, ref) and not got.any(), key
        else:
            scale = float(np.abs(ref).max())
            assert scale > 0, key
            np.testing.assert_allclose(got, ref, atol=MOMENT_TOL * scale, rtol=0, err_msg=key)


def test_v1_bank_update_is_an_unrenormalised_mean():
    """The gamma mix of a class's samples, averaged and not renormalised;
    unseen classes keep their rows; the same as JAX's."""
    rng = np.random.default_rng(3)
    bank = rng.normal(size=(6, 16)).astype(np.float32)
    preds = np.array([0, 0, 2, 5, 2, 0], np.int32)
    anchored = rng.normal(size=(6, 16)).astype(np.float32)
    image = rng.normal(size=(6, 16)).astype(np.float32)
    ours = step.v1_update_memory_bank(torch.from_numpy(bank), torch.from_numpy(preds),
                                      torch.from_numpy(anchored), torch.from_numpy(image), GAMMA)
    theirs = np.asarray(jax_step.v1_update_memory_bank(bank, preds, anchored, image, GAMMA))
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-6, rtol=0)
    mix = anchored * (1 - GAMMA) + image * GAMMA
    np.testing.assert_allclose(ours[0].numpy(), mix[[0, 1, 5]].mean(0), atol=1e-6)
    assert torch.equal(ours[[1, 3, 4]], torch.from_numpy(bank[[1, 3, 4]]))


def _feats(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _grads(fn, args):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*ts)
    out.backward()
    return float(out.detach()), [t.grad.numpy() for t in ts]


OBJECTIVES = {
    "distill": (jax_objective.distill_clip_loss, objective.distill_clip_loss, 6),
    "siglip_full": (jax_objective.siglip_full_loss, objective.siglip_full_loss, 4),
    "sigmoid_pair": (lambda *a: jax_objective._sigmoid_pair_loss(*a, negative_only=False),
                     lambda *a: objective.sigmoid_pair_loss(*a, negative_only=False), 4),
    "sigmoid_pair_negative_only": (
        lambda *a: jax_objective._sigmoid_pair_loss(*a, negative_only=True),
        lambda *a: objective.sigmoid_pair_loss(*a, negative_only=True), 4),
}


@pytest.mark.parametrize("name", list(OBJECTIVES))
def test_objective_matches_jax(name):
    jfn, tfn, nargs = OBJECTIVES[name]
    rng = np.random.default_rng(11)
    if nargs == 6:   # student img, txt, scale; teacher img, txt, scale
        args = [_feats(rng, 12, 16), _feats(rng, 12, 16), np.float32(14.3),
                _feats(rng, 12, 16), _feats(rng, 12, 16), np.float32(20.0)]
    else:            # img [12], txt [10]: the pair loss takes a rectangle
        args = [_feats(rng, 12, 16), _feats(rng, 10 if "pair" in name else 12, 16),
                np.float32(10.0), np.float32(-3.0)]
    jval, jgrads = jax.value_and_grad(jfn, argnums=tuple(range(nargs)))(*args)
    tval, tgrads = _grads(tfn, args)
    assert tval == pytest.approx(float(jval), rel=1e-6, abs=1e-6)
    for got, ref in zip(tgrads, jgrads):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6, atol=1e-6)


LAUNCHES = {  # a step's wrapper calls a layer: K1, K2, K3, K4
    "v1": (1, 1, 0, 1),
    "flyp": (1, 1, 1, 1),
    "flyp_gt": (1, 1, 1, 1),
    "flyp_siglip": (1, 1, 1, 1),
    "flyp_teacher": (2, 2, 1, 1),
}


@pytest.mark.parametrize("case", list(LAUNCHES))
def test_kernel_route_launches(case, monkeypatch):
    """One step on the kernel route (patched true on the CPU): each wrapper
    runs as often as PERF.md's table says; v1 runs no backward on the text."""
    monkeypatch.setattr(kernels, "kernel_route", lambda *a, **k: True)
    monkeypatch.setattr(vit, "kernel_route", lambda *a, **k: True)
    calls = dict.fromkeys(("K1", "K2", "K3", "K4"), 0)
    for name, k in (("flash_attention_qkv", "K1"), ("flash_attention_qkv_segmented", "K2"),
                    ("flash_attention_qkv_bwd", "K3"),
                    ("flash_attention_qkv_segmented_bwd", "K4")):
        def wrapped(*args, _fn=getattr(A, name), _k=k, **kw):
            calls[_k] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(A, name, wrapped)
    _, bank, model, _, tfn = _setup(case)
    st = state.create_train_state(model, torch.optim.SGD(model.parameters(), lr=1e-2),
                                  torch.from_numpy(bank.copy()))
    tfn(st, _batches(1)[0])
    layers = model.cfg.text.layers
    assert model.cfg.vision.layers == layers
    assert tuple(calls[k] for k in ("K1", "K2", "K3", "K4")) == \
        tuple(n * layers for n in LAUNCHES[case])

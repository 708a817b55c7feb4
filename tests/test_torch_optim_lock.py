"""Tower locking, gradient clipping, accumulation and the optimizer's
checkpoint keys against ``latteclip_tpu.train.optim.make_optimizer``.

Both sides start from the same float32 weights (ViT-tiny-test) and take the
same gradients, drawn from a numpy seed in the JAX layout and converted to
the port's. AdamW then differs only in rounding: optax computes
``mu / (sqrt(nu) + eps)`` after the bias corrections, torch the same
quotient in another order, so each element of an update of size lr = 1e-3
differs by float32 rounding of that quotient; three updates stay within
1e-6 absolute (observed: under 2e-8). Where an update must not happen
(locked parameters) the port's parameters are held bit-equal to their
start, as optax's are.

* locking: full ``--lock-image``/``--lock-text`` and the unlocked groups
  1, 2, 3 and 4 of each tower (ViT-tiny-test has 2 blocks: groups are
  [embeddings, block 0, [block 1, ln_post], projection]);
* clipping with a locked tower: ``grad_clip_norm`` below the gradients'
  norm, so the factor depends on whether the locked tower's gradients count
  (JAX counts them; the other factor moves the parameters by more than the
  bound, which the test checks too);
* ``accum_steps = 2`` over four calls of the whole v2 train step (fp32,
  augment off): after each call the parameters, the schedule count, the
  step and the bank, against JAX's ``optax.MultiSteps`` step;
* the checkpoint's optimizer entry: the same keys as ``flatten_opt_state``
  for each flag set, the same values after the updates (moments 1e-6,
  counts equal), and each package's restore takes the other's entry.
"""
import dataclasses
import functools

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
from latteclip_tpu.train import optim as jax_optim
from latteclip_tpu.train import state as jax_state
from latteclip_tpu.train import step as jax_step
from latteclip_torch import checkpoint as ckpt
from latteclip_torch import config as torch_config
from latteclip_torch.models import clip as torch_clip
from latteclip_torch.train import optim, state, step

torch.set_num_threads(1)
LR = 1e-3
TOL = 1e-6


@functools.lru_cache(maxsize=None)
def _init_params():
    jcfg = jax_config.get_model_config("ViT-tiny-test")
    return jax.tree.map(np.asarray, jax_clip.init_clip_params(jax.random.PRNGKey(0), jcfg))


def _start():
    params = _init_params()
    tcfg = torch_config.get_model_config("ViT-tiny-test")
    model = torch_clip.CLIP(tcfg)
    model.load_state_dict(ckpt.state_dict_from_jax_params(params, tcfg))
    return params, model


def _grads(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: np.asarray(rng.standard_normal(p.shape) * scale, np.float32),
                        params)


def _both(flags, calls=3):
    """Run ``calls`` updates with the same gradients in both packages;
    returns (JAX params, port model, port start weights, JAX opt state,
    port optimizer, port accumulation)."""
    params, model = _start()
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    schedule_j = jax_optim.make_schedule("const", LR, 0)
    tx = jax_optim.make_optimizer(schedule_j, **flags)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    opt = optim.make_optimizer(model, optim.make_schedule("const", LR, 0), **flags)
    ts = state.create_train_state(model, opt, torch.zeros(2, 4))
    tcfg = model.cfg
    for i in range(calls):
        g = _grads(params, seed=i)
        updates, opt_state = update(g, opt_state, params)
        params = jax.tree.map(np.asarray, optax.apply_updates(params, updates))
        sd = ckpt.state_dict_from_jax_params(g, tcfg)
        for n, p in model.named_parameters():
            p.grad = sd[n].clone()
        step.apply_gradients(ts)
    return params, model, start, opt_state, opt, ts.accum


def _assert_params_close(params, model):
    sd = ckpt.state_dict_from_jax_params(params, model.cfg)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), sd[n].numpy(), rtol=0, atol=TOL,
                                   err_msg=n)


LOCK_CASES = {
    "lock_image": dict(lock_image=True),
    "lock_text": dict(lock_text=True),
    **{f"image_groups_{n}": dict(lock_image=True, lock_image_unlocked_groups=n)
       for n in (1, 2, 3, 4)},
    **{f"text_groups_{n}": dict(lock_text=True, lock_text_unlocked_groups=n)
       for n in (1, 2, 3, 4)},
}


def _frozen(name, flags):
    """The parameters the reference's groups freeze under ``flags`` at 2 blocks."""
    for tower, is_tower in (("image", lambda s: s.startswith("visual.")),
                            ("text", lambda s: not s.startswith("visual.") and s != "logit_scale")):
        if not flags.get(f"lock_{tower}") or not is_tower(name):
            continue
        n = flags.get(f"lock_{tower}_unlocked_groups", 0)
        if n == 0:
            return True
        if ".resblocks.0." in name:
            return n < 3
        if ".resblocks.1." in name:
            return n < 2
        if any(k in name for k in ("ln_post", "ln_final")):
            return n < 2
        if name in ("visual.proj", "text_projection"):
            return False
        return n < 4
    return False


@pytest.mark.parametrize("case", list(LOCK_CASES))
def test_locking_matches_jax(case):
    flags = LOCK_CASES[case]
    params, model, start, _, opt, _ = _both(flags)
    _assert_params_close(params, model)
    for n, p in model.named_parameters():
        if _frozen(n, flags):
            assert torch.equal(p.detach(), start[n]), n
            # moments still evolve, as optax's do under masked(set_to_zero())
            assert opt.state[p]["exp_avg"].abs().sum() > 0, n
        else:
            assert not torch.equal(p.detach(), start[n]), n


@pytest.mark.parametrize("lock", ["lock_image", "lock_text"])
def test_clipping_counts_locked_gradients(lock):
    flags = {lock: True, "grad_clip_norm": 0.5}
    params, model, start, _, _, _ = _both(flags, calls=1)
    _assert_params_close(params, model)
    # the factor without the locked tower's gradients moves the trainable
    # parameters by more than the bound: the comparison above can tell them apart
    g = _grads(_init_params(), seed=0)
    sd = ckpt.state_dict_from_jax_params(g, model.cfg)
    locked = {n for n in sd if _frozen(n, {lock: True})}
    total = float(np.sqrt(sum(float((v.double() ** 2).sum()) for v in sd.values())))
    free = float(np.sqrt(sum(float((sd[n].double() ** 2).sum()) for n in sd if n not in locked)))
    assert total > free > 0.5


ACCUM_FLAGS = {"plain": {}, "clip": dict(grad_clip_norm=1.0),
               "clip_locked": dict(grad_clip_norm=1.0, lock_image=True)}


@pytest.mark.parametrize("case", list(ACCUM_FLAGS))
@pytest.mark.parametrize("accum", [1, 2])
def test_optimizer_keys_and_values_match_flatten_opt_state(case, accum):
    flags = dict(ACCUM_FLAGS[case], accum_steps=accum)
    params, model, _, opt_state, opt, acc = _both(flags, calls=3)
    theirs = jax_ckpt.flatten_opt_state(opt_state)
    ours = ckpt.optimizer_state(model, opt, acc)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        mine = ours[k].numpy()
        assert mine.shape == np.shape(v), k
        if np.issubdtype(np.asarray(v).dtype, np.integer):
            assert int(mine) == int(v), k
        else:
            np.testing.assert_allclose(mine, v, rtol=0, atol=TOL, err_msg=k)
    # each package restores the other's entry
    tx = jax_optim.make_optimizer(jax_optim.make_schedule("const", LR, 0), **flags)
    restored = jax_ckpt.restore_opt_state(tx.init(params),
                                          {k: v.numpy() for k, v in ours.items()})
    assert sorted(jax_ckpt.flatten_opt_state(restored)) == sorted(theirs)
    _, fresh = _start()
    opt2 = optim.make_optimizer(fresh, optim.make_schedule("const", LR, 0), **flags)
    ts2 = state.create_train_state(fresh, opt2, torch.zeros(2, 4))
    ckpt.restore_optimizer_state(fresh, opt2, {k: torch.as_tensor(np.array(v))
                                               for k, v in theirs.items()}, ts2.accum)
    again = ckpt.optimizer_state(fresh, opt2, ts2.accum)
    for k in theirs:
        np.testing.assert_allclose(again[k].numpy(), np.asarray(theirs[k]), rtol=0, atol=0,
                                   err_msg=k)
    assert opt2.count == opt.count


CLASSES = [f"class {i}" for i in range(6)]
TEMPLATES = [lambda c: f"a photo of a {c}."]


def test_accumulation_matches_multisteps_over_four_calls():
    """accum_steps=2, four calls of the v2 step: two updates, four bank
    updates; the parameters (within 1e-5: the step's gradients differ by
    float32 summation order, 4.8e-7 on losses in tests/test_torch_train_step.py,
    and AdamW's two updates of lr = 1e-4 are sign-like where gradients are
    small), the schedule count, the step and the bank rows (2e-5) after
    each call."""
    jcfg = dataclasses.replace(jax_config.get_model_config("ViT-tiny-test"),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(torch_config.get_model_config("ViT-tiny-test"),
                               compute_dtype="float32")
    params = jax_clip.init_clip_params(jax.random.PRNGKey(0), jcfg)
    tok = jax_get_tokenizer()
    bank = jax_state.init_memory_bank(params, jcfg, tok, CLASSES, TEMPLATES)
    table = jax_state.build_template_table(tok, CLASSES, TEMPLATES)
    sched = jax_optim.make_schedule("const", 1e-4, 0)
    tx = jax_optim.make_optimizer(sched, accum_steps=2, grad_clip_norm=1.0)
    hp_j = jax_step.LatteHParams(augment=False)
    jfn = jax.jit(jax_step.make_train_step(jcfg, tx, hp_j, table))
    js = jax_state.create_train_state(params, tx, bank)

    model = torch_clip.CLIP(tcfg)
    model.load_state_dict(ckpt.state_dict_from_jax_params(jax.tree.map(np.asarray, params), tcfg))
    opt = optim.make_optimizer(model, optim.make_schedule("const", 1e-4, 0), accum_steps=2,
                               grad_clip_norm=1.0)
    ts = state.create_train_state(model, opt, torch.from_numpy(np.asarray(bank)))
    tfn = step.make_train_step(model, step.LatteHParams(augment=False), table)

    rng = np.random.default_rng(0)
    eot = tok.eot_token_id
    for call in range(4):
        rows = np.zeros((16, 77), np.int32)
        for r in range(16):
            ln = int(rng.integers(6, 30))
            rows[r, :ln - 1] = rng.integers(1, 40000, ln - 1)
            rows[r, ln - 1] = eot
        batch = {"images": rng.integers(0, 256, (8, 64, 64, 3), dtype=np.uint8),
                 "per_image_tokens": rows[:8], "per_group_tokens": rows[8:],
                 "zs_preds": rng.integers(0, len(CLASSES), 8).astype(np.int32)}
        js, _ = jfn(js, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(call))
        tfn(ts, batch)
        assert ts.step == int(js.step) == call + 1
        assert ts.accum.mini_step == int(js.opt_state.mini_step)
        assert ts.accum.gradient_step == int(js.opt_state.gradient_step) == (call + 1) // 2
        sched_count = jax_ckpt.flatten_opt_state(js.opt_state)[".inner_opt_state[1][0][2].count"]
        assert opt.count == int(sched_count)
        sd = ckpt.state_dict_from_jax_params(jax.tree.map(np.asarray, js.params), tcfg)
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), sd[n].numpy(), rtol=0, atol=1e-5,
                                       err_msg=f"call {call} {n}")
        np.testing.assert_allclose(ts.memory_bank.numpy(), np.asarray(js.memory_bank), rtol=0,
                                   atol=2e-5)

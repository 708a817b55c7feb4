"""Remat and the fused text forward of the port's train step.

* ``LatteHParams(remat=True)`` (and per tower) against remat off, one v2
  loss and backward at ViT-tiny-test in float32: the recompute runs the same
  float32 operations on the same inputs, so the loss and every gradient
  agree within 1e-6 (observed: bit-equal);
* on the kernel route (``kernel_route`` patched true, so the autograd
  Functions run; on the CPU their wrappers take the plain versions), with
  counting wrappers around the forward and backward wrappers: under remat
  the forward wrappers run once per attention site in the forward and not
  once more in the backward, the backward wrappers as often as without
  remat, and the loss and gradients agree with remat off within 1e-6;
* ``fuse_text_fwd=True`` (templates and both caption streams as one padded
  ``[C + 2B, 77]`` forward, rows zero-padded to a multiple of 8) against the
  two-forward step: the rows are independent, so loss and gradients agree
  within 1e-6; and against the JAX package's fused step from the same
  weights and batch, within 1e-5 on the loss (the summation-order bound of
  tests/test_torch_train_step.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latteclip_tpu.core import config as jax_config
from latteclip_tpu.models import clip as jax_clip
from latteclip_tpu.models.tokenizer import get_tokenizer as jax_get_tokenizer
from latteclip_tpu.train import state as jax_state
from latteclip_tpu.train import step as jax_step
from latteclip_torch import config as torch_config
from latteclip_torch import kernels
from latteclip_torch.checkpoint import state_dict_from_jax_params
from latteclip_torch.data import transforms as T
from latteclip_torch.data.packing import pack_caption_batch, pack_template_table
from latteclip_torch.kernels import attention as A
from latteclip_torch.models import clip as torch_clip
from latteclip_torch.models import vit
from latteclip_torch.models.tokenizer import get_tokenizer
from latteclip_torch.train import state, step

torch.set_num_threads(1)
CLASSES = [f"class {i}" for i in range(5)]
TEMPLATES = [lambda c: f"a photo of a {c}."]
B = 6


def _setup():
    jcfg = dataclasses.replace(jax_config.get_model_config("ViT-tiny-test"),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(torch_config.get_model_config("ViT-tiny-test"),
                               compute_dtype="float32")
    params = jax_clip.init_clip_params(jax.random.PRNGKey(1), jcfg)
    model = torch_clip.CLIP(tcfg)
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), tcfg))
    tok = get_tokenizer()
    table = state.build_template_table(tok, CLASSES, TEMPLATES)
    bank = state.init_memory_bank(model, tok, CLASSES, TEMPLATES)
    rng = np.random.default_rng(0)
    rows = np.zeros((2 * B, 77), np.int32)
    for r in range(2 * B):
        ln = int(rng.integers(5, 40))
        rows[r, :ln - 1] = rng.integers(1, 40000, ln - 1)
        rows[r, ln - 1] = tok.eot_token_id
    batch = {"images": rng.integers(0, 256, (B, 64, 64, 3), dtype=np.uint8),
             "per_image_tokens": rows[:B], "per_group_tokens": rows[B:],
             "zs_preds": rng.integers(0, len(CLASSES), B).astype(np.int32)}
    batch.update(pack_caption_batch(rows[:B], rows[B:], 128, 8))
    return jcfg, params, model, table, bank, batch


def _loss_and_grads(model, hp, table, bank, batch):
    model.zero_grad(set_to_none=True)
    images = T.normalize_images(torch.from_numpy(batch["images"]))
    packed = tuple(torch.from_numpy(a) for a in pack_template_table(table, 128))
    loss, _ = step.latteclip_loss_fn(model, hp, batch, images, bank, bank.clone(),
                                     torch.from_numpy(table), packed)
    loss.backward()
    return float(loss), {n: p.grad.clone() for n, p in model.named_parameters()}


def _assert_same(a, b, tol=1e-6):
    assert abs(a[0] - b[0]) <= tol
    for n in a[1]:
        np.testing.assert_allclose(a[1][n].numpy(), b[1][n].numpy(), rtol=0, atol=tol, err_msg=n)


REMAT = {"both": dict(remat=True), "text": dict(remat_text=True),
         "vision": dict(remat_vision=True), "both_but_text": dict(remat=True, remat_text=False)}


@pytest.mark.parametrize("packing", [False, True])
@pytest.mark.parametrize("case", list(REMAT))
def test_remat_equals_no_remat(case, packing):
    _, _, model, table, bank, batch = _setup()
    off = _loss_and_grads(model, step.LatteHParams(augment=False, text_packing=packing), table,
                          bank, batch)
    on = _loss_and_grads(model, step.LatteHParams(augment=False, text_packing=packing,
                                                  **REMAT[case]), table, bank, batch)
    _assert_same(on, off)


@pytest.fixture
def counted(monkeypatch):
    """The kernel route on the CPU, with calls of the forward and backward
    wrappers counted by phase."""
    monkeypatch.setattr(kernels, "kernel_route", lambda *a, **k: True)
    monkeypatch.setattr(vit, "kernel_route", lambda *a, **k: True)
    calls = {"fwd": 0, "bwd": 0}
    for name, kind in (("flash_attention_qkv", "fwd"), ("flash_attention_qkv_segmented", "fwd"),
                       ("flash_attention_qkv_bwd", "bwd"),
                       ("flash_attention_qkv_segmented_bwd", "bwd")):
        fn = getattr(A, name)

        def wrapped(*args, _fn=fn, _kind=kind, **kw):
            calls[_kind] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(A, name, wrapped)
    return calls


@pytest.mark.parametrize("packing", [False, True])
def test_remat_launches_no_attention_forward_in_backward(counted, packing):
    _, _, model, table, bank, batch = _setup()
    images = T.normalize_images(torch.from_numpy(batch["images"]))
    packed = tuple(torch.from_numpy(a) for a in pack_template_table(table, 128))
    results = {}
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        counted.update(fwd=0, bwd=0)
        hp = step.LatteHParams(augment=False, text_packing=packing, remat=remat)
        loss, _ = step.latteclip_loss_fn(model, hp, batch, images, bank, bank.clone(),
                                         torch.from_numpy(table), packed)
        after_forward = dict(counted)
        loss.backward()
        results[remat] = (float(loss), {n: p.grad.clone() for n, p in model.named_parameters()},
                          after_forward, dict(counted))
    sites = model.cfg.vision.layers + 2 * model.cfg.text.layers
    for remat in (False, True):
        after_forward, after_backward = results[remat][2], results[remat][3]
        assert after_forward == {"fwd": sites, "bwd": 0}
        assert after_backward == {"fwd": sites, "bwd": sites}
    _assert_same(results[True][:2], results[False][:2])


def test_fused_text_forward_equals_two_forwards():
    _, _, model, table, bank, batch = _setup()
    two = _loss_and_grads(model, step.LatteHParams(augment=False), table, bank, batch)
    one = _loss_and_grads(model, step.LatteHParams(augment=False, fuse_text_fwd=True), table,
                          bank, batch)
    _assert_same(one, two)


def test_fused_text_forward_matches_jax():
    jcfg, params, model, table, bank, batch = _setup()
    ours = _loss_and_grads(model, step.LatteHParams(augment=False, fuse_text_fwd=True), table,
                           bank, batch)
    hp = jax_step.LatteHParams(augment=False, fuse_text_fwd=True)
    jbatch = {k: jnp.asarray(batch[k]) for k in ("per_image_tokens", "per_group_tokens",
                                                 "zs_preds")}
    jbank = jnp.asarray(bank.numpy())
    images = jnp.asarray(T.normalize_images(torch.from_numpy(batch["images"])).numpy())
    loss, _ = jax_step.latteclip_loss_fn(params, jcfg, hp, jbatch, images, jbank, jbank,
                                         jnp.asarray(table))
    assert abs(ours[0] - float(loss)) <= 1e-5
    jtok = jax_get_tokenizer()
    np.testing.assert_array_equal(jax_state.build_template_table(jtok, CLASSES, TEMPLATES), table)

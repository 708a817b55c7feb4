"""The latteclip_torch v2 train step against latteclip_tpu's, end to end on a
tiny config from the same weights, batches and memory bank, with augment off:

* float32, 4 steps of plain SGD, captions padded (``text_packing`` off) and
  packed (on, templates packed too): losses, every parameter and the bank
  after the run. SGD keeps the comparison at gradient scale, as
  tests/test_packed_step.py argues: an adaptive optimizer turns f32
  reassociation noise in a gradient into an update of about lr per element.
  The two packages differ only in summation order (and the port's base-2
  softmax, the same function in f32), so the losses agree to 1e-5, the
  parameters to 2e-5 and the bank rows to 2e-5 (JAX pins packed against
  padded at 2e-5, tests/test_packed_step.py). Observed: 4.8e-7 on losses,
  1.2e-7 on parameters that the four steps move by up to 5.7e-3;
* one AdamW step in float32: the loss, then every parameter to 2e-4 (at most
  two elements per tensor may flip an update of size lr = 1e-4 through the
  noise above, and AdamW's first step is lr * sign-like);
* one bf16 step at a tiny config whose heads are 64 wide in both towers, the
  width the kernels take. Here the packages round at different points (see
  tests/test_torch_model.py), so the loss is held to 1e-2 relative, the
  gradient as one flattened vector to cosine >= 0.99 and the updated bank
  row by row to cosine >= 0.999, the bounds chip_smoke.py holds the kernel
  route to against the plain one on the card.
"""
import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from latteclip_tpu.core import config as jax_config
from latteclip_tpu.data.packing import pack_template_table as jax_pack_template_table
from latteclip_tpu.models import clip as jax_clip
from latteclip_tpu.models.tokenizer import get_tokenizer as jax_get_tokenizer
from latteclip_tpu.train import optim as jax_optim
from latteclip_tpu.train import state as jax_state
from latteclip_tpu.train import step as jax_step
from latteclip_torch import config as torch_config
from latteclip_torch.checkpoint import state_dict_from_jax_params
from latteclip_torch.data.packing import (
    PackRowBucketer,
    pack_caption_batch,
    pack_rows_needed,
    pack_template_table,
    token_lengths,
)
from latteclip_torch.models import clip as torch_clip
from latteclip_torch.models.tokenizer import get_tokenizer
from latteclip_torch.train import optim, state, step

torch.set_num_threads(1)

TINY = {
    "embed_dim": 16,
    "vision_cfg": {"image_size": 32, "layers": 2, "width": 64, "patch_size": 16},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 64, "heads": 4, "layers": 2},
}
TINY_HD64 = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 32, "layers": 2, "width": 128, "patch_size": 16},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 128, "heads": 2, "layers": 2},
}
CLASSES = [f"class {i}" for i in range(6)]
TEMPLATES = [lambda c: f"a photo of a {c}."]
PACK = 128
B = 8


def _configs(raw, dtype):
    return (dataclasses.replace(jax_config.config_from_dict("tiny", raw), compute_dtype=dtype),
            dataclasses.replace(torch_config.config_from_dict("tiny", raw), compute_dtype=dtype))


def _caption_rows(rng, n, eot):
    lengths = np.clip(np.round(rng.lognormal(np.log(30.0), 0.35, n)).astype(np.int64) + 2, 8, 77)
    rows = np.zeros((n, 77), np.int32)
    for i, ln in enumerate(lengths):
        rows[i, :ln - 1] = rng.integers(1, 40000, ln - 1)
        rows[i, ln - 1] = eot
    return rows


def _batches(n, size, packed):
    rng = np.random.default_rng(0)
    eot = get_tokenizer().eot_token_id
    bucket = PackRowBucketer(multiple=8)
    out = []
    for _ in range(n):
        b = {
            "images": rng.integers(0, 256, (B, size, size, 3), dtype=np.uint8),
            "per_image_tokens": _caption_rows(rng, B, eot),
            "per_group_tokens": _caption_rows(rng, B, eot),
            "zs_preds": rng.integers(0, len(CLASSES), B).astype(np.int32),
        }
        if packed:
            lengths = token_lengths(np.concatenate([b["per_image_tokens"], b["per_group_tokens"]]))
            rows = bucket.rows_for(pack_rows_needed(lengths, PACK))
            b.update(pack_caption_batch(b["per_image_tokens"], b["per_group_tokens"], PACK, rows))
        out.append(b)
    return out


def _port_model(params, tcfg):
    model = torch_clip.CLIP(tcfg)
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), tcfg))
    return model


def _run_both(raw, dtype, packed, steps, jax_tx, make_torch_opt, batches):
    """Run ``steps`` train steps in both packages; returns the JAX state, the
    port's state, both loss lists and the port's start weights."""
    jcfg, tcfg = _configs(raw, dtype)
    params = jax_clip.init_clip_params(jax.random.PRNGKey(0), jcfg)
    jtok = jax_get_tokenizer()
    bank = jax_state.init_memory_bank(params, jcfg, jtok, CLASSES, TEMPLATES)
    table = jax_state.build_template_table(jtok, CLASSES, TEMPLATES)
    hp_j = jax_step.LatteHParams(augment=False, text_packing=packed)
    jstate = jax_state.create_train_state(params, jax_tx, bank)
    jfn = jax.jit(jax_step.make_train_step(
        jcfg, jax_tx, hp_j, table,
        template_packed=jax_pack_template_table(table, PACK) if packed else None))

    model = _port_model(params, tcfg)
    tok = get_tokenizer()
    tbank = state.init_memory_bank(model, tok, CLASSES, TEMPLATES)
    ttable = state.build_template_table(tok, CLASSES, TEMPLATES)
    np.testing.assert_array_equal(ttable, table)
    tstate = state.create_train_state(model, make_torch_opt(model), tbank)
    tfn = step.make_train_step(model, step.LatteHParams(augment=False, text_packing=packed), ttable,
                               template_packed=pack_template_table(ttable, PACK) if packed else None)
    jl, tl = [], []
    for i in range(steps):
        b = batches[i % len(batches)]
        jstate, jm = jfn(jstate, b, jax.random.PRNGKey(i))
        jl.append(float(jm["loss"]))
        tl.append(float(tfn(tstate, b)["loss"]))
    return jstate, tstate, jl, tl, np.asarray(bank), tbank


@pytest.mark.parametrize("packed", [False, True])
def test_float32_sgd_trajectory_matches_jax(packed):
    batches = _batches(2, 32, packed)
    jstate, tstate, jl, tl, jbank0, tbank0 = _run_both(
        TINY, "float32", packed, 4, optax.sgd(1e-2),
        lambda m: torch.optim.SGD(m.parameters(), lr=1e-2), batches)
    np.testing.assert_allclose(tbank0.numpy(), jbank0, atol=2e-5, rtol=0)
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    assert tstate.step == 4
    ref = state_dict_from_jax_params(jax.tree.map(np.asarray, jstate.params), tstate.model.cfg)
    for name, p in tstate.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), atol=2e-5, rtol=0,
                                   err_msg=f"param {name} diverged")
    np.testing.assert_allclose(tstate.memory_bank.numpy(), np.asarray(jstate.memory_bank),
                               atol=2e-5, rtol=0)
    assert float(tstate.model.logit_scale.detach()) == pytest.approx(float(jstate.params["logit_scale"]), abs=1e-5)


def test_float32_adamw_step_matches_jax():
    batches = _batches(1, 32, packed=True)
    sched = ("const", 1e-4, 0)
    jstate, tstate, jl, tl, _, _ = _run_both(
        TINY, "float32", True, 1, jax_optim.make_optimizer(jax_optim.make_schedule(*sched)),
        lambda m: optim.make_optimizer(m, optim.make_schedule(*sched)), batches)
    assert tl[0] == pytest.approx(jl[0], abs=1e-5)
    ref = state_dict_from_jax_params(jax.tree.map(np.asarray, jstate.params), tstate.model.cfg)
    for name, p in tstate.model.named_parameters():
        diff = np.abs(p.detach().numpy() - ref[name].numpy())
        assert (diff > 1e-6).sum() <= 2 and diff.max() <= 2e-4, f"param {name}: max {diff.max():.3g}"
    np.testing.assert_allclose(tstate.memory_bank.numpy(), np.asarray(jstate.memory_bank),
                               atol=2e-5, rtol=0)


def test_bf16_step_at_head_width_64_matches_jax():
    batches = _batches(1, 32, packed=True)
    jcfg, tcfg = _configs(TINY_HD64, "bfloat16")
    params = jax_clip.init_clip_params(jax.random.PRNGKey(1), jcfg)
    jtok = jax_get_tokenizer()
    bank = np.asarray(jax_state.init_memory_bank(params, jcfg, jtok, CLASSES, TEMPLATES))
    table = jax_state.build_template_table(jtok, CLASSES, TEMPLATES)
    b = batches[0]
    packed_j = jax_pack_template_table(table, PACK)
    hp_j = jax_step.LatteHParams(augment=False, text_packing=True)

    def jax_loss(p):
        images = jax_step.T.normalize_images(b["images"])
        return jax_step.latteclip_loss_fn(p, jcfg, hp_j, b, images, bank, bank, table,
                                          tuple(np.asarray(a) for a in packed_j))

    (jloss, jaux), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    jbank = np.asarray(jax_step.update_memory_bank(bank, jaux["preds"], b["zs_preds"],
                                                   jaux["text_final"], jaux["text_final_zs"]))

    model = _port_model(params, tcfg)
    packed_t = tuple(torch.from_numpy(a) for a in pack_template_table(table, PACK))
    images = step.T.normalize_images(torch.from_numpy(b["images"]))
    tbank = torch.from_numpy(bank.copy())
    loss, aux = step.latteclip_loss_fn(model, step.LatteHParams(augment=False, text_packing=True),
                                       b, images, tbank, tbank, torch.from_numpy(table), packed_t)
    loss.backward()
    new_bank = step.update_memory_bank(tbank, aux["preds"], aux["zs_preds"], aux["text_final"],
                                       aux["text_final_zs"])

    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-2)
    ref = state_dict_from_jax_params(jax.tree.map(np.asarray, jgrads), tcfg)
    ours = torch.cat([p.grad.flatten() for _, p in model.named_parameters()])
    theirs = torch.cat([ref[n].flatten() for n, _ in model.named_parameters()])
    assert float(torch.nn.functional.cosine_similarity(ours, theirs, dim=0)) >= 0.99
    cos = torch.nn.functional.cosine_similarity(new_bank, torch.from_numpy(jbank.copy()), dim=1)
    assert float(cos.min()) >= 0.999


def test_state_keeps_prototypes_apart_from_the_bank():
    _, tcfg = _configs(TINY, "float32")
    model = torch_clip.init_clip_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    bank = torch.nn.functional.normalize(torch.randn(len(CLASSES), 16), dim=1)
    st = state.create_train_state(model, torch.optim.SGD(model.parameters(), lr=0.1), bank)
    assert st.prototypes.data_ptr() != st.memory_bank.data_ptr()
    st.memory_bank = st.memory_bank * 2
    assert torch.equal(st.prototypes, bank)
    st.start_epoch()
    assert torch.equal(st.prototypes, st.memory_bank)
    assert st.prototypes.data_ptr() != st.memory_bank.data_ptr()

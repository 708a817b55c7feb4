"""coca_ViT-L-14's training step on the plain route against latteclip_tpu,
at full widths and cut depth, float32 (the question ROADMAP.md, section 3,
kept open after PR 15: is the kernel route's 0.99478 gradient cosine on the
card the port's math or bf16 rounding?)."""
import json
import os

import jax
import numpy as np
import optax
import torch

from latteclip_tpu.train import state as jax_state
from latteclip_tpu.train import step as jax_step
from latteclip_torch import checkpoint as torch_ckpt
from latteclip_torch.train import state as torch_state
from latteclip_torch.train import step as torch_step

from test_torch_coca_train import HP, LOSS_REL_TOL, assert_params_agree, bank_of, inputs, shared


# coca_ViT-L-14 at full widths (vision 1024 at 224 / 14: rows of 257 tokens;
# the 256-query attentional pool; text 768) cut to 2 layers a tower
COCA_L14_CUT = {**json.load(open(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "latteclip_torch",
    "model_configs", "coca_ViT-L-14.json")))}
COCA_L14_CUT = {**COCA_L14_CUT,
                "vision_cfg": {**COCA_L14_CUT["vision_cfg"], "layers": 2},
                "text_cfg": {**COCA_L14_CUT["text_cfg"], "layers": 2},
                "multimodal_cfg": {**COCA_L14_CUT["multimodal_cfg"], "layers": 1}}


def test_coca_l14_plain_step_matches_jax():
    """The plain route of coca_ViT-L-14's v2 step, float32 at full widths and
    cut depth, against JAX: the loss at 1e-5 relative, the updated weights at
    PARAM_TOL and each tensor's update in JAX's direction (cosine >= 1 -
    1e-6). The kernel route's 0.99478 gradient cosine on the card (ROADMAP.md,
    section 3) is then bf16 rounding, not the port's plain math."""
    jcfg, params, tcfg, model = shared(COCA_L14_CUT, "coca_l14_cut")
    assert tcfg.vision.seq_len == 257 and tcfg.vision.attn_pooler_queries == 256
    start = {k: v.clone() for k, v in model.state_dict().items()}
    table, batches = inputs(tcfg, classes=3, batch=2)
    bank = bank_of(params, jcfg, table)
    hp, zero = dict(HP), ("text_decoder",)
    tx = optax.sgd(1e-2)
    jstate = jax_state.create_train_state(params, tx, bank)
    jstate, jm = jax_step.make_train_step(jcfg, tx, jax_step.LatteHParams(**hp), table,
                                          zero_update_subtrees=zero)(
        jstate, batches[0], jax.random.PRNGKey(0))
    tstate = torch_state.create_train_state(model, torch.optim.SGD(model.parameters(), lr=1e-2),
                                            torch.from_numpy(bank.copy()))
    tm = torch_step.make_train_step(model, torch_step.LatteHParams(**hp), table,
                                    zero_update_subtrees=zero)(tstate, batches[0])
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_REL_TOL, atol=0)
    assert_params_agree(jstate, tstate, tcfg)
    ref = torch_ckpt.state_dict_from_jax_params(jax.tree.map(np.asarray, jstate.params), tcfg)
    for k, v in tstate.model.state_dict().items():
        da, db = (v - start[k]).double().flatten(), (ref[k] - start[k]).double().flatten()
        if db.norm() > 0:
            assert 1 - float(da @ db / (da.norm() * db.norm())) <= 1e-6, k

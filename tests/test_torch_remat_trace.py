"""What remat adds to the port's tracing (``latteclip_torch/obs/trace.py``),
on packed v2 steps of ViT-tiny-test on the CPU:

* ``layers.remat_counts``: with remat on, ``blocks`` and ``recomputed``
  each move by the rematerialised blocks a step (every vision block and
  every text block of the template and caption forwards) times the steps;
* ``attention.replay_counts``: on the kernel route (``kernel_route`` patched
  true, so the autograd Functions run on their plain wrappers), ``recorded``
  and ``replayed`` move by the same count; the plain route recomputes the
  attention and moves neither;
* under a profiler, one ``recompute`` span per rematerialised block and
  step, with no stream time on the CPU;
* with remat off, no counter moves and no ``recompute`` span is recorded.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from latteclip_torch import kernels
from latteclip_torch.config import get_model_config
from latteclip_torch.data import packing
from latteclip_torch.models import clip as clip_mod
from latteclip_torch.models import vit
from latteclip_torch.models.tokenizer import get_tokenizer
from latteclip_torch.obs import trace
from latteclip_torch.train import state as St
from latteclip_torch.train import step as S

B, PACK, CLASSES, STEPS = 4, 128, 5, 2
REMAT = ("layers.remat_counts.blocks", "layers.remat_counts.recomputed")
REPLAY = ("attention.replay_counts.recorded", "attention.replay_counts.replayed")


def _steps(remat: bool, traced: bool = False):
    """``STEPS`` packed v2 steps -> (rematerialised blocks a step, the
    change of the counters, the window's spans or None)."""
    cfg = get_model_config("ViT-tiny-test")
    model = clip_mod.init_clip_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tok = get_tokenizer()
    classes = [f"class {i}" for i in range(CLASSES)]
    templates = [lambda c: f"a photo of a {c}."]
    table = St.build_template_table(tok, classes, templates)
    bank = St.init_memory_bank(model, tok, classes, templates)
    state = St.create_train_state(model, torch.optim.SGD(model.parameters(), lr=1e-3), bank)
    step = S.make_train_step(model, S.LatteHParams(text_packing=True, remat=remat), table,
                             template_packed=packing.pack_template_table(table, PACK))
    rng = np.random.default_rng(0)
    captions = tok([f"caption {i} of a few words" for i in range(B)])
    size = cfg.vision.image_size
    batches = []
    for _ in range(STEPS):
        b = {"images": rng.integers(0, 256, (B, size, size, 3), dtype=np.uint8),
             "zs_preds": rng.integers(0, CLASSES, B).astype(np.int32)}
        b.update(packing.pack_caption_batch(captions, captions, PACK, 8))
        batches.append(b)

    def run():
        for i, b in enumerate(batches):
            step(state, b, torch.Generator().manual_seed(i))

    before = trace.counters()
    spans = None
    if traced:
        with profile(activities=[ProfilerActivity.CPU]):
            run()
        spans = trace.recorded()
    else:
        run()
    after = trace.counters()
    change = {k: after[k] - before.get(k, 0) for k in REMAT + REPLAY}
    return cfg.vision.layers + 2 * cfg.text.layers, change, spans


@pytest.fixture
def kernel_route(monkeypatch):
    """The kernel route on the CPU: the attention Functions, and so
    ``AttentionResiduals``, run on their plain wrappers."""
    monkeypatch.setattr(kernels, "kernel_route", lambda *a, **k: True)
    monkeypatch.setattr(vit, "kernel_route", lambda *a, **k: True)


def test_remat_counts_every_block_and_its_recompute():
    blocks, change, _ = _steps(remat=True)
    assert change[REMAT[0]] == change[REMAT[1]] == blocks * STEPS
    # the plain route recomputes the attention: nothing recorded or replayed
    assert change[REPLAY[0]] == change[REPLAY[1]] == 0


def test_the_recompute_replays_every_attention_on_the_kernel_route(kernel_route):
    blocks, change, _ = _steps(remat=True)
    assert change[REMAT[0]] == change[REMAT[1]] == blocks * STEPS
    assert change[REPLAY[0]] == change[REPLAY[1]] == blocks * STEPS


@pytest.mark.parametrize("remat", [True, False])
def test_one_recompute_span_per_rematerialised_block(remat):
    blocks, change, spans = _steps(remat=remat, traced=True)
    recompute = [s for s in spans if s["name"] == "recompute"]
    assert len([s for s in spans if s["name"] == "train_step"]) == STEPS
    if remat:
        assert len(recompute) == blocks * STEPS
        # on the CPU autograd runs the backward on the calling thread
        assert all(spans[s["parent"]]["name"] == "backward" for s in recompute)
        assert all(s["stream_ms"] is None and s["host_ms"] >= 0 for s in recompute)
    else:
        assert recompute == [] and set(change.values()) == {0}


def test_remat_off_moves_no_counter_on_the_kernel_route(kernel_route):
    _, change, _ = _steps(remat=False)
    assert set(change.values()) == {0}

"""FLOP and byte counts, the bound, the roofline and mfu arithmetic, on
hand-worked shapes."""
import numpy as np
import pytest

from benchmark import flops, readers, run
from benchmark.reference import Dims


def dims(model):
    return Dims(run.load_json(run.HERE, "configs", model + ".json"))


def test_one_segmented_causal_call():
    # one packed row of 8 tokens: segments of 3 and 5 tokens, causal
    seg = np.array([[1, 1, 1, 2, 2, 2, 2, 2]])
    rows, L, pairs, segmented = flops.packed_call(seg)
    assert (rows, L, pairs, segmented) == (1, 8, 6 + 15, True)
    f, b = flops.attention_call(1, 8, 64, 1, 21, True, backward=False)
    act = 8 * 64 * 2
    assert f == 4 * 21 * 64 and b == 3 * act + act + 8 * 4 + 8 * 4
    fb, bb = flops.attention_call(1, 8, 64, 1, 21, True, backward=True)
    assert fb == 2.5 * f and bb == 3 * act + act + act + 8 * 4 + 8 * 4 + 3 * act


def test_one_whole_row_call_and_its_bound():
    # two rows of 4 tokens, two heads of 32, no mask: 16 pairs a row
    f, b = flops.attention_call(2, 4, 64, 2, 32, False, backward=False)
    assert f == 4 * 32 * 64
    assert b == 4 * (2 * 4 * 64 * 2) + 2 * 4 * 2 * 4
    assert flops.bound_s(989e12, 0) == pytest.approx(1.0)
    assert flops.bound_s(1.0, 3.35e12) == pytest.approx(1.0)
    assert flops.padded_call(np.zeros((10, 77), np.int32)) == (10, 77, 10 * 77 * 78 // 2, False)


def test_b32_and_b16_step_flops():
    lengths = np.full(1024, 32)
    tpl = np.full(47, 10)
    for model, L in (("ViT-B-32", 50), ("ViT-B-16", 197)):
        d = dims(model)
        p = d.patch
        vision = 512 * (12 * (24 * 768 ** 2 * L + 4 * L * L * 768)
                        + 2 * 3 * p * p * 768 * (L - 1) + 2 * 768 * 512)

        def text(n, count):
            return count * (12 * (24 * 512 ** 2 * n + 4 * n * (n + 1) // 2 * 512) + 2 * 512 * 512)

        want = 3 * (vision + text(32, 1024) + text(10, 47) + 4 * 512 * 512 * 512) + 10 * 512 * 47 * 512
        assert flops.train_step(d, 512, lengths, tpl, 47) == want
    # about 21 TF (B/32) and 61 TF (B/16) a step at the mix's median caption
    assert flops.train_step(dims("ViT-B-32"), 512, lengths, tpl, 47) == pytest.approx(21.4e12, rel=0.02)
    assert flops.train_step(dims("ViT-B-16"), 512, lengths, tpl, 47) == pytest.approx(61.0e12, rel=0.02)
    assert flops.eval_request(dims("ViT-B-16"), 256, 1000) == \
        flops.vision_forward(dims("ViT-B-16"), 256) + 2 * 256 * 512 * 1000


def test_roofline_mfu_and_idle_arithmetic():
    rec = {"kind": "train", "window": {"seconds": 2.0, "flops": 989e12, "steps": 4, "images": 2048},
           "host": {"data_wait_s": [0.001, 0.003], "dispatch_s": [0.05]},
           "trace": {"busy_s": 0.8, "window_s": 1.0, "by_kind_s": {"attention": 0.2, "other": 0.3}},
           "traced": 3, "attention_bound_s": 0.05}
    assert readers.mfu(rec, "train") == pytest.approx(50.0)
    assert readers.roofline(rec, "train") == pytest.approx(25.0)
    assert readers.idle(rec, "train") == pytest.approx(20.0)
    assert readers.host_mean_ms(rec, "train", "data_wait_s") == pytest.approx(2.0)
    assert run.reader("elementwise_ms.train.b32")(rec) == pytest.approx(100.0)
    # another kind's records, or a trace with no device time, give nothing
    assert readers.mfu(rec, "eval") is None and run.reader("attn_roofline.eval")(rec) is None
    rec["trace"] = {"busy_s": 0.0, "window_s": 1.0, "by_kind_s": {}}
    assert readers.roofline(rec, "train") is None and readers.idle(rec, "train") is None

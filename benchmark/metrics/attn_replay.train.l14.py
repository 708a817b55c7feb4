"""Attention outputs replayed by the recompute over blocks run under remat
since the traced window began, % (kernels/attention.py::AttentionResiduals,
models/layers.py::_BlockRemat): 100 where no recompute launches an attention
forward."""
from benchmark.program import fill


def read(rec):
    return fill(rec, "train", "attention.replay_counts.replayed", "layers.remat_counts.blocks")

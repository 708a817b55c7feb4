"""The window's model FLOPs a second as % of the bf16 dense peak (flops.py: model FLOPs,
no recomputation counted)."""
from benchmark.readers import mfu


def read(rec):
    return mfu(rec, "train")

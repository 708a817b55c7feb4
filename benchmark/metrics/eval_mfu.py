"""The window's model FLOPs a second as % of the bf16 dense peak (flops.py)."""
from benchmark.readers import mfu


def read(rec):
    return mfu(rec, "eval")

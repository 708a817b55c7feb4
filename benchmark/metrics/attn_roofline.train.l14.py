"""The attention calls' bound over their kernels' device time in the traced steps, %."""
from benchmark.readers import roofline


def read(rec):
    return roofline(rec, "train")

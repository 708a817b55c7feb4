"""The attention calls' bound over their kernels' device time in the traced requests, %."""
from benchmark.readers import roofline


def read(rec):
    return roofline(rec, "eval")

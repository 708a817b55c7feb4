"""Host ms a step in the ``input_wait`` span of the prefetch queue (data/pipeline.py)."""
from benchmark.program import host_ms


def read(rec):
    return host_ms(rec, "train", "input_wait")

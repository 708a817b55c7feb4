"""Host ms a step blocked in ``wait`` spans until the device catches up (train/step.py)."""
from benchmark.program import host_ms


def read(rec):
    return host_ms(rec, "train", "wait")

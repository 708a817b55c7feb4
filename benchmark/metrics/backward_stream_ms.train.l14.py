"""Device ms a step from entry to exit event of the step's ``backward`` span (train/step.py)."""
from benchmark.program import stream_ms


def read(rec):
    return stream_ms(rec, "train", "backward")

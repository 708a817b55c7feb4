"""Device ms a step from entry to exit event of the ``recompute`` spans: the second
forward of each rematerialised block (models/layers.py::_BlockRemat.backward)."""
from benchmark.program import stream_ms


def read(rec):
    return stream_ms(rec, "train", "recompute")

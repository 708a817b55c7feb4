"""1 - busy / span of the traced steps, %."""
from benchmark.readers import idle


def read(rec):
    return idle(rec, "train")

"""1 - busy / span of the traced requests, %."""
from benchmark.readers import idle


def read(rec):
    return idle(rec, "eval")

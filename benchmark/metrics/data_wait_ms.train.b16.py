"""Host ms a step waiting on next() of the prefetch iterator (data/packing.py, data/pipeline.py)."""
from benchmark.readers import host_mean_ms


def read(rec):
    return host_mean_ms(rec, "train", "data_wait_s")

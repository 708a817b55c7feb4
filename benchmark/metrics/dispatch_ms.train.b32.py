"""Host ms a step in the call of the train step, which returns before the device ends."""
from benchmark.readers import host_mean_ms


def read(rec):
    return host_mean_ms(rec, "train", "dispatch_s")

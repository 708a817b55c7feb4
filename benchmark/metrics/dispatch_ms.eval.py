"""Host ms a request in the call of the eval step, which returns before the device ends."""
from benchmark.readers import host_mean_ms


def read(rec):
    return host_mean_ms(rec, "eval", "dispatch_s")

"""Device ms a traced step in kernels that are neither GEMM, attention, copies nor collectives."""
from benchmark.readers import device_s


def read(rec):
    s = device_s(rec, "train", "other")
    return None if s is None else s * 1e3 / rec["traced"]

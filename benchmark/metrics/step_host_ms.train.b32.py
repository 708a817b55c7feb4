"""Host ms a step in ``train_step`` less its ``wait`` spans: the host's own work (train/step.py)."""
from benchmark.program import step_host_ms


def read(rec):
    return step_host_ms(rec, "train")

"""Host ms a request in the ``eval_step`` span (eval/zero_shot.py::make_eval_step)."""
from benchmark.program import host_ms


def read(rec):
    return host_ms(rec, "eval", "eval_step")

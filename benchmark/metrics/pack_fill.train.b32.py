"""Real caption tokens over packed slots since the traced window began, % (data/packing.py)."""
from benchmark.program import fill


def read(rec):
    return fill(rec, "train", "packing.pack_counts.pack_tokens", "packing.pack_counts.pack_slots")

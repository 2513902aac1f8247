"""Median of the window's decode steps, each timed on the host around the
engine's decode call to its synchronise (the engine's `p50_ms` arithmetic,
over every step of the window)."""
from portbench.harness.common import percentile

UNIT = "ms"
LAYER = "serve engine"
MOVES = "output_tok_s"


def read(rec):
    return percentile(rec.get("decode_step_ms", []), 50)

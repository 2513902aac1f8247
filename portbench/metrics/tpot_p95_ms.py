"""95th percentile of every gap between two consecutive output tokens of a
request in the window, each taken when the token came out on the host
(after a synchronise). Host clock."""
from portbench.harness.common import percentile

UNIT = "ms"
LAYER = None
MOVES = None


def read(rec):
    return percentile(rec.get("gaps_ms", []), 95)

"""Share of the traced serve window in which no device operation ran:
1 - busy / window, busy the union of every kernel's and copy's interval in
the profiler's trace. Nothing where no device operation was traced.
Profiler."""
UNIT = "%"
LAYER = "device"
MOVES = "output_tok_s"


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0 or "output_tokens" not in rec:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
